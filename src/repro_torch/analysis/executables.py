"""Named-executable registry for the lint gate (port of
``repro/analysis/executables.py``).

Every program the reference's registry names registers here, at the
reference's own shapes and configs, as an ``ExecutableSpec``: the sharded
MoE layer under all eight substrates and on its Gate-Drop local branch,
the train chunk (routed, dropped, frame off, overlapped), the slot-pool
and paged decode steps with and without ``local_routing``, the fused
kernel's forward and VJP, the unfused kernel pipeline, the two
flash-decode kernels, the bf16 loss and three host-sync scenarios; plus
the per-pass EXPECTATIONS the lint passes check it against (zero
all-to-alls vs. the cost model, launch budgets, shared-memory budgets,
dtype policy, host-sync scenarios). Names are the reference's but two:
``pallas_fused/*`` is ``cuda_fused/*`` and ``pallas_pipeline/fwd`` is
``cuda_pipeline/fwd`` (``REFERENCE_NAMES``).

Where the reference lowers a jitted function and walks its jaxpr and
compiled HLO, ``Artifacts`` runs the executable ONCE, eagerly, and keeps
what that run did:

  * ``wire``: ``comm.COUNTER``'s all-to-alls (calls, bytes, wire bytes,
    forward and backward), reset before the run;
  * ``ops``: every aten op the run dispatched, with its dtypes, shapes,
    the first frame outside torch (``origin``) and the ops that made its
    tensor inputs (a ``TorchDispatchMode``; the jaxpr's counterpart);
  * ``launches``: the kernel wrappers' calls (``kernels.call_counts``, on
    either device) and, on a card, their kernels' launches in a
    ``torch.profiler`` trace (``analysis/launches.py::port_counts``);
  * ``kernels`` (card only): what the card reports for each launched
    kernel: registers per thread and shared memory per block for the
    launch (the profiler's kernel records), and for the variant the
    wrapper took (``variant_info`` of ``grouped_ffn``, ``moe_dispatch``,
    ``moe_megakernel``, ``flash_decode``: registers, shared memory,
    spills; the tiled B1 and B4 as launched, 16-byte or element loads,
    B4's shared memory for 128 experts of the call's C slots; the rows
    kept the largest).

A train chunk is a ``lax.scan`` in the reference, whose HLO holds the
step's body once (K = 2 steps checked against one ``step_cost``); here
the K steps run, so its expectation is K x ``step_cost``. The train
config keeps the reference's ``remat=False``: a recomputed forward
(remat) would count as forward (``comm/substrate.py``).

Specs that need the reference's 8-device mesh declare ``n_ranks=8``:
they run on every rank of one gloo group of 8 processes
(``analysis/lint.py``), each rank holding its share of the rows and its
block of experts. Executables are built lazily: importing this module costs nothing
but host math (the cost-model expectations); tensors are made only when
an executable runs.

Suppressions: pass ``ignore=(...)`` or write a trailing
``# lint: ignore[pass-id]`` comment on the ``register_executable`` call
line; the registrar reads it from source.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import re
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.passes import SMEM_BUDGET
from repro_torch.comm.cost import layer_cost, step_cost
from repro_torch.configs.base import (COMM_SUBSTRATES, CommConfig,
                                      GatingDropoutConfig, ModelConfig,
                                      MoEConfig)

__all__ = ["Artifacts", "ExecutableSpec", "OpRecord", "REFERENCE_NAMES",
           "available_executables", "get_executable", "record_ops",
           "register_executable"]

_IGNORE_COMMENT = re.compile(r"#\s*lint:\s*ignore\[([\w\-,\s]+)\]")
ARTIFACTS = ("wire", "ops", "launches", "kernels")
PROFILE_MARGIN_S = 0.1

# the port's name -> the reference's, where they differ
REFERENCE_NAMES = {"cuda_fused/fwd": "pallas_fused/fwd",
                   "cuda_fused/vjp": "pallas_fused/vjp",
                   "cuda_pipeline/fwd": "pallas_pipeline/fwd"}


@dataclasses.dataclass(frozen=True)
class ExecutableSpec:
    name: str
    # build(device, ctx) -> (fn, args); ctx is this rank's ParallelContext
    # where n_ranks > 1, else None
    build: Callable[[torch.device, Any], Tuple[Callable, tuple]]
    expect: Dict[str, Dict[str, Any]]
    ignore: Tuple[str, ...] = ()
    scenario: Optional[Callable[[torch.device], Dict[str, Any]]] = None
    n_ranks: int = 1                              # ranks of the gloo group


# --------------------------------------------------------------------------
# the aten op record (the jaxpr's counterpart)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpRecord:
    name: str                          # "aten.bmm"
    in_dtypes: Tuple[str, ...]         # of the tensor arguments, in order
    in_shapes: Tuple[Tuple[int, ...], ...]
    out_dtype: str                     # of the first tensor output ("" if none)
    out_shape: Tuple[int, ...]
    origin: str                        # "path/file.py:line (function)"
    sources: Tuple[int, ...]           # per tensor argument: index of the op
                                       # that made it, -1 if none recorded


_SKIP_DIRS = tuple(os.path.dirname(m.__file__) + os.sep
                   for m in (torch, np, os))
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))) + os.sep


def _origin() -> str:
    """The innermost frame outside torch, numpy and the standard library:
    the repo line (or test line) that issued the op, under ``src/`` as
    ``repro_torch/...``."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_SKIP_DIRS) and fn != __file__:
            return f"{fn.removeprefix(_SRC)}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "<unknown>"


class _OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self._made = WeakIdKeyDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in tree_leaves((args, kwargs or {})) if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        first = outs[0] if outs else None
        i = len(self.ops)
        self.ops.append(OpRecord(
            name=str(func.overloadpacket),
            in_dtypes=tuple(str(t.dtype) for t in ins),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            out_dtype=str(first.dtype) if first is not None else "",
            out_shape=tuple(first.shape) if first is not None else (),
            origin=_origin(),
            sources=tuple(self._made.get(t, -1) for t in ins)))
        for o in outs:
            self._made[o] = i
        return out


def record_ops(fn: Callable, *args) -> Tuple[Any, List[OpRecord]]:
    """(fn(*args), the aten ops it dispatched, in order)."""
    with _OpRecorder() as rec:
        out = fn(*args)
    return out, rec.ops


# --------------------------------------------------------------------------
# artifacts of one run
# --------------------------------------------------------------------------

def _kernel_resources(trace: str) -> List[Dict[str, Any]]:
    """One row per launched port kernel: the profiler's numbers for the
    launch, and the largest the card reports for its wrapper's launched
    variants (``variant_info``)."""
    from repro_torch.analysis.launches import launched_kernels
    from repro_torch.kernels import build
    variants: Dict[str, List[Dict[str, int]]] = {}
    for key in sorted(build.launched_variants, key=repr):
        variants.setdefault(key[0], []).append(_variant_info(key))
    rows = []
    for name, k in sorted(launched_kernels(trace).items()):
        infos = variants.get(k["wrapper"], [])
        smem = [v["smem_bytes"] for v in infos] + [k["smem_bytes"] or 0]
        regs = [v["registers"] for v in infos] + [k["registers"] or 0]
        rows.append({"kernel": name, "wrapper": k["wrapper"], "launches": k["launches"],
                     "launch_smem_bytes": k["smem_bytes"],
                     "launch_registers": k["registers"],
                     "smem_bytes": max(smem), "registers": max(regs),
                     "spill_bytes": max([v["spill_bytes"] for v in infos], default=None)})
    return rows


def _variant_info(key: Tuple) -> Dict[str, int]:
    from repro_torch.kernels import (flash_decode, grouped_ffn, moe_dispatch,
                                     moe_megakernel)
    wrapper, *a = key
    if wrapper.startswith("grouped_matmul"):
        return grouped_ffn.variant_info(*a)
    if wrapper == "fused_moe":
        return moe_megakernel.variant_info(*a)
    if wrapper == "dispatch":
        word, per, stream = a
        return moe_dispatch.variant_info("dispatch", word=word, per_thread=per, stream=stream)
    if wrapper == "combine":
        return moe_dispatch.variant_info("combine", a[0], k=a[1], vec=a[2], cols=a[3])
    paged, qdt, kvdt, hd, rep, per, *ps = a
    return flash_decode.variant_info(paged, qdt, kvdt, hd, rep, per, *ps)


class Artifacts:
    """What one eager run of an executable did (module docstring), for
    the artifact kinds in ``needs``; the run happens at the first access
    and is cached. ``device``: where the run goes; ``ctx``: this rank's
    context for a multi-rank spec."""

    def __init__(self, spec: ExecutableSpec, device, ctx=None,
                 needs: Sequence[str] = ARTIFACTS):
        self._spec = spec
        self.device = torch.device(device)
        self._ctx = ctx
        self._needs = set(needs)
        self._done: Optional[Dict[str, Any]] = None

    def _get(self, kind: str):
        if kind not in self._needs:
            raise KeyError(f"{self._spec.name}: artifact {kind!r} was not recorded")
        if self._done is None:
            self._done = self._run()
        return self._done[kind]

    @property
    def wire(self) -> Dict[str, float]:
        return self._get("wire")

    @property
    def ops(self) -> List[OpRecord]:
        return self._get("ops")

    @property
    def launches(self) -> Dict[str, Optional[Dict[str, int]]]:
        return self._get("launches")

    @property
    def kernels(self) -> Optional[List[Dict[str, Any]]]:
        return self._get("kernels")

    def resources(self) -> Dict[str, Any]:
        """The wire, launches and kernels artifacts, where this run
        recorded them (empty before the run)."""
        if self._done is None:
            return {}
        return {k: self._done[k] for k in ("wire", "launches", "kernels") if k in self._needs}

    def _settle(self, profile: bool) -> None:
        if profile:
            torch.cuda.synchronize(self.device)
            time.sleep(PROFILE_MARGIN_S)

    def _run(self) -> Dict[str, Any]:
        from repro_torch.analysis.launches import kernel_counts, port_counts
        from repro_torch.comm import COUNTER
        from repro_torch.kernels import call_counts, reset_launch_counts
        fn, args = self._spec.build(self.device, self._ctx)
        card = self.device.type == "cuda"
        profile = card and bool({"launches", "kernels"} & self._needs)
        COUNTER.reset()
        reset_launch_counts()
        ops: List[OpRecord] = []
        with tempfile.TemporaryDirectory() as tmp:
            trace = os.path.join(tmp, "trace.json")
            window = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                         torch.profiler.ProfilerActivity.CUDA])
                      if profile else contextlib.nullcontext())
            with window:
                # the profiler keeps only kernel records timed inside its
                # window, the card's clock mapped onto the host's: a margin
                # on each side keeps the run's first and last launches in
                self._settle(profile)
                if "ops" in self._needs:
                    _, ops = record_ops(fn, *args)
                else:
                    fn(*args)
                if card:
                    torch.cuda.synchronize(self.device)
                self._settle(profile)
            if profile:
                window.export_chrome_trace(trace)
            out = {
                "wire": {"calls": COUNTER.total_calls(),
                         "bytes": sum(COUNTER.bytes.values()),
                         "wire_bytes": sum(COUNTER.wire_bytes.values()),
                         "by_phase": {"calls": dict(COUNTER.calls),
                                      "bytes": dict(COUNTER.bytes),
                                      "wire_bytes": dict(COUNTER.wire_bytes)}},
                "ops": ops,
                "launches": {"calls": call_counts(),
                             "kernels": port_counts(kernel_counts(trace)) if profile
                             else None},
                "kernels": _kernel_resources(trace) if profile else None,
            }
        return out


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, ExecutableSpec] = {}


def register_executable(spec: ExecutableSpec) -> ExecutableSpec:
    """Register a spec; merges ``# lint: ignore[pass-id, ...]`` comments
    written anywhere on the (possibly multi-line) registration call into
    ``spec.ignore``: scans the caller's source from the call line until
    its parentheses close."""
    frame = inspect.stack()[1]
    extra = []
    try:
        lines, _ = inspect.findsource(frame.frame)
        depth = 0
        for ln in lines[frame.lineno - 1:frame.lineno + 31]:
            m = _IGNORE_COMMENT.search(ln)
            if m:
                extra += [p.strip() for p in m.group(1).split(",")
                          if p.strip()]
            depth += ln.count("(") - ln.count(")")
            if depth <= 0:
                break
    except (OSError, TypeError):          # exec'd / REPL code: no source
        pass
    if extra:
        spec = dataclasses.replace(spec, ignore=spec.ignore + tuple(extra))
    _REGISTRY[spec.name] = spec
    return spec


def available_executables() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_executable(name: str) -> ExecutableSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown executable {name!r}; available: "
                       f"{', '.join(available_executables())}") from None


# --------------------------------------------------------------------------
# shared configs (host math only), the reference's
# --------------------------------------------------------------------------

N_RANKS = 8             # the reference's CPU mesh: 8 devices on one axis


def _moe_cfg(substrate: str = "dense", *, backend: str = "sharded",
             dtype: str = "float32", top_k: int = 2, gated: bool = True,
             d_model: int = 32, d_ff: int = 64, n_experts: int = 8,
             n_chunks: int = 4) -> ModelConfig:
    return ModelConfig(
        d_model=d_model, d_ff=d_ff, vocab=64, dtype=dtype,
        gated_mlp=gated,
        moe=MoEConfig(n_experts=n_experts, top_k=top_k, d_ff_expert=d_ff,
                      jitter_eps=0.0,
                      comm=CommConfig(substrate=substrate, n_chunks=n_chunks),
                      backend=backend,
                      gating_dropout=GatingDropoutConfig(mode="gate_drop", rate=0.3)))


def _train_cfg(substrate: str = "hierarchical_compressed", *,
               n_chunks: int = 4) -> ModelConfig:
    # the reference's scan_layers=False has no counterpart: every layer
    # runs (and is counted) in turn
    return ModelConfig(
        d_model=32, d_ff=64, vocab=64, n_layers=2, n_heads=2, n_kv_heads=2,
        remat=False, dtype="float32", param_dtype="float32",
        moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=64, jitter_eps=0.0,
                      comm=CommConfig(substrate=substrate, n_chunks=n_chunks),
                      backend="sharded",
                      gating_dropout=GatingDropoutConfig(mode="gate_drop", rate=0.3)))


def _decode_cfg() -> ModelConfig:
    return ModelConfig(
        d_model=64, d_ff=128, vocab=100, n_layers=1, n_heads=2,
        n_kv_heads=2, remat=False, dtype="float32", param_dtype="float32",
        moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=128, backend="sharded",
                      gating_dropout=GatingDropoutConfig(mode="gate_drop", rate=0.3)))


def _small_cfg() -> ModelConfig:
    """The host-sync scenarios' one-layer model."""
    return dataclasses.replace(_moe_cfg(backend="oracle"), n_layers=1, n_heads=2,
                               n_kv_heads=2, remat=False)


def _cost(c: Dict[str, float], times: int = 1) -> Dict[str, Dict[str, float]]:
    return {"cost": {k: c[k] * times for k in ("calls", "bytes", "wire_bytes")}}


def _layer_cost_expect(cfg, *, tokens_per_shard: int, ep: int):
    return _cost(layer_cost(cfg, tokens_per_shard=tokens_per_shard, ep=ep))


def _chunk_cost_expect(cfg, *, tokens_per_shard: int, ep: int, steps: int):
    """K training steps' wire: K x ``step_cost`` (the reference's scan
    holds the step's body once, so its HLO is checked against one)."""
    return _cost(step_cost(cfg, tokens_per_shard=tokens_per_shard, ep=ep,
                           backward=True), steps)


# --------------------------------------------------------------------------
# the executables (device-touching, lazy)
# --------------------------------------------------------------------------

CHUNK_STEPS = 2         # the reference's K


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _randn(device, seed: int, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=_gen(device, seed), device=device)


def _no_grad(fn: Callable) -> Callable:
    def run(*a):
        with torch.no_grad():
            return fn(*a)
    return run


def _build_moe_layer(substrate: str, decision: bool):
    def build(device, ctx):
        from repro_torch.bridge import shard_experts
        from repro_torch.core.moe import init_moe_params, moe_sharded
        cfg = _moe_cfg(substrate)
        p = shard_experts(init_moe_params(_gen(device, 0), cfg), ctx)
        x = _randn(device, 1, N_RANKS, 16, 32)[ctx.rank:ctx.rank + 1]

        def fn(p_, x_):
            return moe_sharded(p_, x_, cfg, ctx, generator=None, decision=decision)
        return _no_grad(fn), (p, x)
    return build


def _build_train_chunk(decision: bool, substrate: str = "hierarchical_compressed",
                       frame: bool = True):
    def build(device, ctx):
        from repro_torch.bridge import shard_experts
        from repro_torch.configs.base import TrainConfig
        from repro_torch.models import init_model
        from repro_torch.training.steps import init_train_state, make_train_step
        cfg = _train_cfg(substrate)
        tc = TrainConfig(lr=1e-3, warmup_steps=4, seed=0, metrics_frame=frame)
        state = init_train_state(shard_experts(init_model(_gen(device, 0), cfg), ctx), tc)
        K, B, L = CHUNK_STEPS, N_RANKS, 16
        toks = torch.randint(3, cfg.vocab, (K, B, L), generator=_gen(device, 1),
                             device=device)
        batches = [{"tokens": toks[i], "labels": torch.roll(toks[i], -1, dims=1),
                    "loss_mask": torch.ones((B, L), device=device)} for i in range(K)]
        step = make_train_step(cfg, tc, ctx)

        def fn(state_, batches_):
            for b in batches_:
                state_, _ = step(state_, b, decision)
            return state_
        return fn, (state, batches)
    return build


def _decode_inputs(device, ctx):
    from repro_torch.bridge import shard_experts
    from repro_torch.models import init_model
    cfg = _decode_cfg()
    params = shard_experts(init_model(_gen(device, 0), cfg), ctx)
    # the reference's 8 slots over 8 devices: one a rank
    tok = torch.zeros((1,), dtype=torch.int32, device=device)
    pos = torch.full((1,), 4, dtype=torch.int32, device=device)
    alive = torch.ones((1,), dtype=torch.bool, device=device)
    return cfg, params, tok, pos, alive


def _build_decode_pool(local_routing: bool):
    def build(device, ctx):
        from repro_torch.serve.engine import decode_pool_step, init_slot_pool
        cfg, params, tok, pos, alive = _decode_inputs(device, ctx)
        pool = init_slot_pool(cfg, 1, 32, device=device)

        def fn(p_, c_, t_, i_, a_):
            return decode_pool_step(p_, c_, t_, i_, a_, cfg, ctx=ctx,
                                    local_routing=local_routing)
        return _no_grad(fn), (params, pool, tok, pos, alive)
    return build


def _build_decode_paged(local_routing: bool):
    def build(device, ctx):
        from repro_torch.serve.paged import (PagedLayout, decode_paged_step,
                                             paged_pool_like)
        cfg, params, tok, pos, alive = _decode_inputs(device, ctx)
        max_seq = 32
        layout = PagedLayout(page_size=8, n_pages=24, seq_len=max_seq)
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32, device=device)}
        pool = paged_pool_like(batch, cfg, max_seq=max_seq, n_slots=1, layout=layout)
        tables = torch.arange(layout.n_blocks, dtype=torch.int32, device=device)[None]

        def fn(p_, c_, bt_, t_, i_, a_):
            return decode_paged_step(p_, c_, bt_, t_, i_, a_, cfg, ctx=ctx,
                                     local_routing=local_routing)
        return _no_grad(fn), (params, pool, tables, tok, pos, alive)
    return build


def _moe_backend_fn(backend: str, cfg: ModelConfig):
    from repro_torch.core.backend import get_backend
    be = get_backend(backend)

    def fwd(p_, x_):
        y, _aux = be(p_, x_, cfg, ctx=None, generator=None, decision=False,
                     is_training=True)
        return y
    return fwd


def _build_cuda_fused(mode: str):
    def build(device, ctx):
        from repro_torch.core.moe import init_moe_params
        from repro_torch.tree import flatten_with_paths
        cfg = _moe_cfg(backend="cuda_fused")
        p = init_moe_params(_gen(device, 0), cfg)
        x = _randn(device, 1, 4, 16, 32)
        fwd = _moe_backend_fn("cuda_fused", cfg)
        if mode == "fwd":
            return _no_grad(fwd), (p, x)

        def vjp(p_, x_):
            leaves = [t.requires_grad_() for t in flatten_with_paths(p_).values()]
            x_ = x_.requires_grad_()
            return torch.autograd.grad((fwd(p_, x_) ** 2).sum(), leaves + [x_])
        return vjp, (p, x)
    return build


def _build_cuda_pipeline():
    def build(device, ctx):
        from repro_torch.core.moe import init_moe_params
        # ungated expert MLP: dispatch + 2 grouped matmuls + combine = 4
        # kernel calls (the gate matmul would make it 5)
        cfg = _moe_cfg(backend="cuda", gated=False)
        p = init_moe_params(_gen(device, 0), cfg)
        x = _randn(device, 1, 4, 16, 32)
        return _no_grad(_moe_backend_fn("cuda", cfg)), (p, x)
    return build


def _build_flash_decode():
    def build(device, ctx):
        from repro_torch.kernels.flash_decode import flash_decode
        B, H, KV, hd, S = 8, 4, 2, 16, 64
        q = _randn(device, 0, B, H, hd)
        k = _randn(device, 1, B, S, KV, hd)
        v = _randn(device, 2, B, S, KV, hd)
        idx = torch.full((B,), 17, dtype=torch.int32, device=device)
        return _no_grad(flash_decode), (q, k, v, idx)
    return build


def _build_flash_decode_paged():
    def build(device, ctx):
        from repro_torch.kernels.flash_decode import flash_decode_paged
        B, H, KV, hd, ps, npg, nb = 8, 4, 2, 16, 16, 24, 4
        q = _randn(device, 0, B, H, hd)
        k = _randn(device, 1, npg + 1, ps, KV, hd)
        v = _randn(device, 2, npg + 1, ps, KV, hd)
        bt = torch.arange(nb, dtype=torch.int32, device=device).repeat(B, 1)
        idx = torch.full((B,), 17, dtype=torch.int32, device=device)
        return _no_grad(flash_decode_paged), (q, k, v, bt, idx)
    return build


def _build_bf16_loss():
    def build(device, ctx):
        from repro_torch.models import init_model
        from repro_torch.training.steps import total_loss
        cfg = dataclasses.replace(_moe_cfg(backend="oracle"), dtype="bfloat16",
                                  param_dtype="bfloat16", n_layers=2, n_heads=2,
                                  n_kv_heads=2, remat=False)
        params = init_model(_gen(device, 0), cfg)
        toks = torch.randint(3, cfg.vocab, (2, 16), generator=_gen(device, 1),
                             device=device)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
                 "loss_mask": torch.ones((2, 16), device=device)}

        def fn(p_, b_):
            return total_loss(p_, b_, cfg, generator=None, decision=False)
        return _no_grad(fn), (params, batch)
    return build


# --------------------------------------------------------------------------
# host-sync scenarios (execute steady-state chunks and ticks under the guard)
# --------------------------------------------------------------------------

def _trainer_scenario(device) -> Dict[str, Any]:
    from repro_torch.analysis.hostsync import guard_host_transfers
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import LMTaskConfig, SyntheticLM, stack_batches
    from repro_torch.obs.trace import Tracer
    from repro_torch.training.loop import Trainer
    cfg = _small_cfg()
    # metrics_frame stays ON and the tracer is ENABLED: the guard must
    # stay green with the full observability layer live
    tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=8)
    task = SyntheticLM(LMTaskConfig(vocab=cfg.vocab, seq_len=16))
    trainer = Trainer(cfg, tc, lambda i: task.sample_batch(i, 2), device=device,
                      chunk=2, prefetch=False, log=None, tracer=Tracer(enabled=True))
    chunk = lambda lo, hi: trainer._run_chunk(   # noqa: E731
        (lo, hi), stack_batches(trainer.batch_fn, lo, hi))
    chunk(0, 2)                                  # warmup outside the guard
    evs: List = []
    with guard_host_transfers(events=evs):
        chunk(2, 4)
        chunk(4, 6)
    return {"events": evs}


def _ticks(sched) -> Dict[str, Any]:
    from repro_torch.analysis.hostsync import guard_host_transfers
    from repro_torch.serve.scheduler import Request
    for rid in range(3):
        sched.submit(Request(rid=rid, tokens=np.arange(3 + rid, dtype=np.int32) + 3))
    sched.step(0.0)                              # warmup: prefill + decode
    sched.step(0.0)                              # warmup: steady decode
    evs: List = []
    with guard_host_transfers(events=evs):
        for _ in range(3):                       # steady-state ticks
            sched.step(0.0)
    return {"events": evs}


def _scheduler_scenario(device, paged: bool = False) -> Dict[str, Any]:
    from repro_torch.configs.base import PagedKVConfig
    from repro_torch.models import init_model
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.engine import GenerateConfig
    from repro_torch.serve.scheduler import ContinuousScheduler, PagedScheduler
    cfg = _small_cfg()
    params = init_model(_gen(device, 0), cfg)
    gen = GenerateConfig(max_new=24, eos_id=-1)
    # tracer + registry live: span records and histogram observes are
    # pure host work, so the guarded ticks must stay one-sync; ample
    # pages keep the paged tick on its one-sync path (a preemption's
    # swap-out is the documented second sync)
    kw = dict(n_slots=4, prefill_buckets=(8,), registry=MetricsRegistry(),
              tracer=Tracer(enabled=True))
    if paged:
        sched = PagedScheduler(params, cfg, gen,
                               paged=PagedKVConfig(page_size=8, n_slots_equiv=8), **kw)
    else:
        sched = ContinuousScheduler(params, cfg, gen, **kw)
    return _ticks(sched)


def _scenario_only(name: str):
    def build(device, ctx):
        raise RuntimeError(f"{name} is scenario-only")
    return build


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

_SMEM = {"budget_bytes": SMEM_BUDGET}
_DTYPE = {"min_elems": 4096}

# all eight substrates: the overlapped rows assert that the a2a call count
# is n_eff x the base substrate's at EXACTLY equal total bytes/wire
for _sub in COMM_SUBSTRATES:
    register_executable(ExecutableSpec(
        name=f"moe_layer/{_sub}",
        build=_build_moe_layer(_sub, decision=False),
        expect={"no-collectives": _layer_cost_expect(
            _moe_cfg(_sub), tokens_per_shard=16, ep=N_RANKS)},
        n_ranks=N_RANKS))

register_executable(ExecutableSpec(
    name="moe_layer/local",
    build=_build_moe_layer("dense", decision=True),
    expect={"no-collectives": {"zero": True}},
    n_ranks=N_RANKS))

register_executable(ExecutableSpec(
    name="train_chunk/routed",
    build=_build_train_chunk(decision=False),
    expect={"no-collectives": _chunk_cost_expect(
        _train_cfg(), tokens_per_shard=16, ep=N_RANKS, steps=CHUNK_STEPS)},
    n_ranks=N_RANKS))

register_executable(ExecutableSpec(
    name="train_chunk/dropped",
    build=_build_train_chunk(decision=True),
    expect={"no-collectives": {"zero": True}},
    n_ranks=N_RANKS))

# MetricsFrame non-interference: switching the telemetry frame OFF must
# leave the chunk's collectives exactly at the cost model
register_executable(ExecutableSpec(
    name="train_chunk/frame_off",
    build=_build_train_chunk(decision=False, frame=False),
    expect={"no-collectives": _chunk_cost_expect(
        _train_cfg(), tokens_per_shard=16, ep=N_RANKS, steps=CHUNK_STEPS)},
    n_ranks=N_RANKS))

register_executable(ExecutableSpec(
    name="train_chunk/overlapped",
    build=_build_train_chunk(decision=False, substrate="overlapped"),
    expect={"no-collectives": _chunk_cost_expect(
        _train_cfg("overlapped"), tokens_per_shard=16, ep=N_RANKS, steps=CHUNK_STEPS)},
    n_ranks=N_RANKS))

register_executable(ExecutableSpec(
    name="train_chunk/overlapped_dropped",
    build=_build_train_chunk(decision=True, substrate="overlapped"),
    expect={"no-collectives": {"zero": True}},
    n_ranks=N_RANKS))

register_executable(ExecutableSpec(
    name="decode_pool/routed",
    build=_build_decode_pool(local_routing=False),
    expect={"no-collectives": {"nonzero": True}},
    n_ranks=N_RANKS))

register_executable(ExecutableSpec(
    name="decode_pool/local",
    build=_build_decode_pool(local_routing=True),
    expect={"no-collectives": {"zero": True}},
    n_ranks=N_RANKS))

register_executable(ExecutableSpec(
    name="decode_paged/routed",
    build=_build_decode_paged(local_routing=False),
    expect={"no-collectives": {"nonzero": True}},
    n_ranks=N_RANKS))

register_executable(ExecutableSpec(
    name="decode_paged/local",
    build=_build_decode_paged(local_routing=True),
    expect={"no-collectives": {"zero": True}},
    n_ranks=N_RANKS))

register_executable(ExecutableSpec(
    name="cuda_fused/fwd",
    build=_build_cuda_fused("fwd"),
    expect={"launch-count": {"max": 1}, "smem-budget": _SMEM,
            "dtype-flow": _DTYPE, "no-collectives": {"zero": True}}))

# the backward is autograd through the plain slot formulation (the
# reference's _fused_bwd, outside any kernel): still one kernel call
register_executable(ExecutableSpec(
    name="cuda_fused/vjp",
    build=_build_cuda_fused("vjp"),
    expect={"launch-count": {"max": 1}, "smem-budget": _SMEM}))

register_executable(ExecutableSpec(
    name="cuda_pipeline/fwd",
    build=_build_cuda_pipeline(),
    expect={"launch-count": {"max": 4}, "smem-budget": _SMEM,
            "no-collectives": {"zero": True}}))

register_executable(ExecutableSpec(
    name="flash_decode/step",
    build=_build_flash_decode(),
    expect={"launch-count": {"max": 1}, "smem-budget": _SMEM,
            "dtype-flow": _DTYPE}))

register_executable(ExecutableSpec(
    name="flash_decode/paged",
    build=_build_flash_decode_paged(),
    expect={"launch-count": {"max": 1}, "smem-budget": _SMEM,
            "dtype-flow": _DTYPE}))

register_executable(ExecutableSpec(
    name="model_loss/bf16",
    build=_build_bf16_loss(),
    expect={"dtype-flow": _DTYPE, "no-collectives": {"zero": True}}))

register_executable(ExecutableSpec(
    name="trainer/ticks",
    build=_scenario_only("trainer/ticks"),
    expect={"host-sync": {}},
    scenario=_trainer_scenario))

register_executable(ExecutableSpec(
    name="scheduler/ticks",
    build=_scenario_only("scheduler/ticks"),
    expect={"host-sync": {}},
    scenario=_scheduler_scenario))

register_executable(ExecutableSpec(
    name="paged_scheduler/ticks",
    build=_scenario_only("paged_scheduler/ticks"),
    expect={"host-sync": {}},
    scenario=lambda device: _scheduler_scenario(device, paged=True)))
