"""The benchmark's own wrappers around the program's kernel entry points,
put in place in the traced run only: each call of B1 (forward, dx, dW),
B2, B3 and B4 notes its sizes, and the routing tables it reads are kept
(small device copies, no host read), so that after the traced window
``bounds()`` gives every call's least time (``roofline.work``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from bench.lib import roofline

_DT = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


class KernelCalls:
    """Within ``with calls:`` every wrapped call is noted; the wrappers go
    back on exit."""

    def __init__(self):
        self.calls: List[Tuple[str, Dict]] = []
        self._undo: List[Callable[[], None]] = []

    def _wrap(self, module, attr: str, note: Callable):
        orig = getattr(module, attr)

        def wrapper(*args, **kw):
            self.calls.append(note(*args, **kw))
            return orig(*args, **kw)

        for k, v in vars(orig).items():          # launch counters etc.
            setattr(wrapper, k, v)
        setattr(module, attr, wrapper)
        self._undo.append(lambda: setattr(module, attr, orig))

    def __enter__(self) -> "KernelCalls":
        from repro_torch.kernels import grouped_ffn, moe_dispatch, moe_megakernel

        def gmm(x, w):
            e, c, d = x.shape
            return "grouped_matmul", dict(e=e, c=c, d=d, f=w.shape[2],
                                          itemsize=x.element_size(), dtype=_DT[x.dtype])

        def gmm_dx(dy, w):
            e, c, f = dy.shape
            return "grouped_matmul_dx", dict(e=e, c=c, d=w.shape[1], f=f,
                                             itemsize=dy.element_size(),
                                             dtype=_DT[dy.dtype])

        def gmm_dw(x, dy):
            e, c, d = x.shape
            return "grouped_matmul_dw", dict(e=e, c=c, d=d, f=dy.shape[2],
                                             itemsize=x.element_size(),
                                             dtype=_DT[x.dtype])

        def dispatch(x, slot_token, slot_valid):
            return "dispatch", dict(
                row_bytes=x.element_size() * x.shape[1], slots=slot_token.numel(),
                n_tokens=x.shape[0], dtype=_DT[x.dtype],
                tables=(slot_token.detach().clone(), slot_valid.detach().clone()))

        def combine(buf, token_slot, weights, keep):
            t, k = token_slot.shape
            return "combine", dict(row_bytes=buf.element_size() * buf.shape[1],
                                   t=t, k=k, d=buf.shape[1], n_rows=buf.shape[0],
                                   tables=(token_slot.detach().clone(),))

        def fused(x, w_in, w_gate, w_out, topk_w, keep, slot_token, slot_valid,
                  token_slot, act="silu"):
            e, d, f = w_in.shape
            t, k = token_slot.shape
            return "fused_moe", dict(
                d=d, f=f, e=e, mats=3 if w_gate is not None else 2,
                w_itemsize=w_in.element_size(), x_bytes=x.numel() * x.element_size(),
                slots=slot_token.numel(), t=t, k=k, dtype=_DT[w_in.dtype],
                tables=(topk_w.detach().clone(), keep.detach().clone(),
                        token_slot.detach().clone(), slot_valid.detach().clone()))

        self._wrap(grouped_ffn, "grouped_matmul", gmm)
        self._wrap(grouped_ffn, "grouped_matmul_dx", gmm_dx)
        self._wrap(grouped_ffn, "grouped_matmul_dw", gmm_dw)
        self._wrap(moe_dispatch, "dispatch", dispatch)
        self._wrap(moe_dispatch, "combine", combine)
        self._wrap(moe_megakernel, "fused_moe", fused)
        return self

    def __exit__(self, *exc) -> bool:
        for undo in reversed(self._undo):
            undo()
        self._undo = []
        return False

    def bounds(self) -> Dict[str, List[float]]:
        """wrapper -> the least seconds of each of its calls, in order."""
        out: Dict[str, List[float]] = {}
        for name, a in self.calls:
            a = dict(a)
            tables = a.pop("tables", None)
            if name == "dispatch":
                st, sv = tables
                a["rows"] = int(torch.unique(st.long().clamp(0, a["n_tokens"] - 1)[sv]).numel())
            elif name == "combine":
                (ts,) = tables
                a["rows"] = int(torch.unique(ts.long().clamp(0, a["n_rows"] - 1)).numel())
            elif name == "fused_moe":
                topk_w, keep, ts, sv = tables
                c = a["slots"] // a["e"]
                used = (topk_w > 0) & keep
                experts = (ts.long() // max(c, 1))[used]
                a["live"] = int(torch.unique(experts).numel())
                a["kept"] = int(sv.sum())
            out.setdefault(name, []).append(roofline.bound_s(*roofline.work(name, a)))
        return out
