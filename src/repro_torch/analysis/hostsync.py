"""Host-transfer guard (port of ``repro/analysis/hostsync.py``).

A device-to-host read stalls the host until the device has run all the
work queued before it, so the serving tick and the training chunk each
make exactly one, on purpose: ``fetch``, the sanctioned read that stands
in for ``jax.device_get``. ``guard_host_transfers`` finds every other
one.

  * Python level (any device): it intercepts the implicit pulls on a
    tensor, ``item``, ``tolist``, ``numpy``, ``__array__``, ``__bool__``,
    ``__float__``, ``__int__`` and ``__index__``, and the numpy entry
    points (``np.asarray`` & co.) when handed a tensor. Every tensor
    counts as a device tensor, CPU tensors too, as the reference treats
    CPU jax arrays, so the guard means something in the CPU tests.
  * On the card it also runs under ``torch.cuda.set_sync_debug_mode
    ("warn")`` and turns each "synchronizing CUDA operation" warning into
    an event: that catches syncs inside PyTorch ops (a pageable copy, a
    ``nonzero``) that no Python hook sees.

Each event names the first frame outside this module, ``torch`` and
``numpy`` (the repo's file:line). A pull whose innermost frame is
``torch``'s own Python code (``__array__`` calling ``numpy``, a tensor's
``__format__``) is ``internal``, as the reference treats jax's; a card
sync never is. Pulls inside ``fetch`` are sanctioned, and ``fetch``
itself records one event per call, so ``syncs(events)`` reads the number
of intended reads beside the list of unintended ones.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import traceback
import warnings
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["TransferEvent", "fetch", "guard_host_transfers", "syncs"]

_HOOKS = ("item", "tolist", "numpy", "__array__", "__bool__", "__float__",
          "__int__", "__index__")
# numpy entry points that read a tensor through __array__
_NP_FUNCS = ("asarray", "array", "asanyarray", "ascontiguousarray", "stack",
             "concatenate")
_SYNC_WARNING = r".*synchronizing CUDA operation"

_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_NUMPY_DIR = os.path.dirname(np.__file__) + os.sep

_state = threading.local()
# the fetch recorders of the active guards (innermost last)
_active: List[Callable[[], None]] = []


@dataclasses.dataclass(frozen=True)
class TransferEvent:
    method: str          # the pull: a hooked method, "np.<fn>", "fetch" or "cuda_sync"
    origin: str          # "path/file.py:lineno (func)" of the first repo frame
    sanctioned: bool     # inside fetch
    internal: bool       # innermost frame is torch's own Python code


def _sanctioned() -> bool:
    return getattr(_state, "sanctioned", 0) > 0


def _host(leaf: Any) -> Any:
    if not torch.is_tensor(leaf):
        return leaf
    t = leaf.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        return t                        # numpy has no such dtype
    return t.numpy()


def _tree_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_host(v) for v in tree)
    return _host(tree)


def fetch(tree: Any) -> Any:
    """The sanctioned device-to-host read: ``tree`` (dicts, lists, tuples)
    with every tensor leaf copied to host numpy (bfloat16 and float8
    leaves, which numpy lacks, to host tensors); other leaves as they
    are. One call is one intended sync of the caller's loop."""
    _state.sanctioned = getattr(_state, "sanctioned", 0) + 1
    try:
        for note in list(_active):
            note()
        return _tree_host(tree)
    finally:
        _state.sanctioned -= 1


def _caller_origin() -> Tuple[str, bool]:
    """(origin, internal): origin is the first stack frame outside this
    module, torch and numpy; internal is True when the innermost frame
    outside this module is torch's own code."""
    internal = None
    origin = "<unknown>"
    for frame in reversed(traceback.extract_stack()):
        f = frame.filename
        if f == __file__ or f.endswith(("analysis/hostsync.py", "warnings.py")):
            continue
        if internal is None:
            internal = f.startswith(_TORCH_DIR)
        if f.startswith((_TORCH_DIR, _NUMPY_DIR)):
            continue
        origin = f"{f}:{frame.lineno} ({frame.name})"
        break
    return origin, bool(internal)


def _holds_tensor(obj: Any, depth: int = 2) -> bool:
    if torch.is_tensor(obj):
        return True
    if depth and isinstance(obj, (list, tuple)):
        return any(_holds_tensor(o, depth - 1) for o in obj)
    return False


@contextlib.contextmanager
def guard_host_transfers(*, mode: str = "record",
                         events: Optional[List[TransferEvent]] = None):
    """Intercept implicit tensor pulls (and, on a card, CUDA syncs).

    ``mode="record"``: append a ``TransferEvent`` per pull to ``events``
    and let it proceed. ``mode="raise"``: raise RuntimeError at the first
    pull that is neither sanctioned nor internal. Yields the event list.
    The patches are process-wide while active; recording is per guard."""
    if mode not in ("record", "raise"):
        raise ValueError(f"mode {mode!r}: record or raise")
    evs: List[TransferEvent] = events if events is not None else []

    def hit(method: str, card: bool = False) -> None:
        sanctioned = _sanctioned()
        origin, internal = _caller_origin()
        ev = TransferEvent(method=method, origin=origin, sanctioned=sanctioned,
                           internal=internal and not card)
        evs.append(ev)
        if mode == "raise" and not (ev.sanctioned or ev.internal):
            raise RuntimeError(
                f"implicit device->host transfer via {method} at {origin}; "
                "use analysis.hostsync.fetch for intended syncs")

    def note_fetch() -> None:
        origin, _ = _caller_origin()
        evs.append(TransferEvent("fetch", origin, True, False))

    with contextlib.ExitStack() as undo:         # restores in reverse order
        for name in _HOOKS:
            own = vars(torch.Tensor).get(name)
            orig = getattr(torch.Tensor, name)

            def wrapper(self, *a, _orig=orig, _name=name, **kw):
                hit(_name)
                return _orig(self, *a, **kw)

            setattr(torch.Tensor, name, wrapper)
            undo.callback(_restore, torch.Tensor, name, own)
        for fname in _NP_FUNCS:
            nf = getattr(np, fname)

            def np_wrapper(*a, _orig=nf, _name=fname, **kw):
                if any(_holds_tensor(x) for x in a):
                    hit(f"np.{_name}")
                return _orig(*a, **kw)

            setattr(np, fname, np_wrapper)
            undo.callback(setattr, np, fname, nf)
        undo.enter_context(warnings.catch_warnings())
        if torch.cuda.is_available():
            shown = warnings.showwarning

            def showwarning(message, category, filename, lineno, file=None, line=None):
                if "synchronizing CUDA operation" in str(message):
                    hit("cuda_sync", card=True)
                else:
                    shown(message, category, filename, lineno, file, line)

            warnings.filterwarnings("always", message=_SYNC_WARNING)
            warnings.showwarning = showwarning
            undo.callback(torch.cuda.set_sync_debug_mode, torch.cuda.get_sync_debug_mode())
            torch.cuda.set_sync_debug_mode("warn")
        _active.append(note_fetch)
        undo.callback(_active.remove, note_fetch)
        yield evs


def _restore(cls, name: str, own: Any) -> None:
    """Put back ``cls.name``: its own attribute, or none (inherited)."""
    if own is None:
        delattr(cls, name)
    else:
        setattr(cls, name, own)


def syncs(events: List[TransferEvent]) -> Tuple[int, List[TransferEvent]]:
    """(calls of ``fetch``, the pulls that were neither sanctioned nor
    internal) among ``events``."""
    return (sum(e.method == "fetch" for e in events),
            [e for e in events if not (e.sanctioned or e.internal)])
