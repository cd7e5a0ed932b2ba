#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device   -- the card's name and power limit (nvidia-smi);
  2. build    -- compile every kernel of src/repro_torch/kernels/csrc;
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the inputs captured from the main path's first prefill
                 and first decode step, plus ragged cases (B1's variant,
                 streaming or tiled, asserted per case); times against
                 the bytes/FLOP bound, the plain version and one library
                 call, in turns (B1 against torch.bmm, B2 against
                 index_select, B3 against embedding_bag); B3 at top-1 the
                 same bits on a second run, with PDL off and after
                 CUDA-graph replays, and timed with its programmatic
                 dependent launch (PDL) off (its time: 20 B3 in a graph
                 with PDL would overlap each other) and on, in turns, as
                 are the pair B1 (down projection) -> B3 in one graph
                 (the main path's order) and an empty kernel (the launch
                 floor);
  4. slice    -- zcode-m3-base at full width and depth (bf16 activations,
                 f32 params, random weights from a seed) generates for 8
                 requests through the kernel backend with flash decode; the
                 kernels' launch counts over one call are asserted, and the
                 call is timed over several rounds (median and spread);
                 then the same through the fused backend (cuda_fused, B4
                 and B5): launches asserted (every B4 streaming), timed,
                 B4 checked and timed at the prefill and decode sites in
                 turns with the cuda pipeline, and the f32 tokens of both
                 backends gated equal up to near-ties;
  5. e2e      -- the same model in f32 activations, kernel path against
                 the plain path (oracle MoE, plain decode attention):
                 prefill logits and teacher-forced decode logits are gated;
                 the agreement of greedy and of seeded sampled tokens is
                 reported;
  6. train    -- the serving tensors freed, zcode-m3-base at full width and
                 depth trains with Gate-Drop 0.3 on the reference's
                 synthetic MT batches (16 x 64 target + 16 x 64 source
                 tokens per step): K f32 steps of cuda_fused, cuda and the
                 plain oracle path from one seeded init, gated against each
                 other (loss, grad norm, balance per step, parameters
                 after K); B4, B1's forward and backward kernels, B2 and
                 B3 against their plain versions at the inputs captured
                 from the first step, plus ragged cases (each kernel's
                 variant asserted), and timed (dx at both products of the
                 expert FFN; B4 in turns with the cuda pipeline, also with
                 every expert routed; B3 and the pair B1 -> B3 as in
                 phase 3); B4's streaming kernel bitwise after CUDA
                 graph replays, with NaN in the unrouted experts' weights,
                 and all dropped; then both
                 kernel backends in the model's own dtype (bf16
                 activations): launch counts per step asserted (routed,
                 Gate-Drop and Gate-Expert-Drop steps; every B1 forward,
                 dx and dw launch streaming), step time, tokens/s, peak
                 memory, a CUDA-event split into forward, backward and
                 Adam, and the device's busy time from a torch.profiler
                 trace;
  ep. expert parallelism -- after phase 6, its states freed: a one-rank
                 NCCL group (launch/mesh.py::make_group) on the same seeded
                 full-width zcode-m3-base: 3 Gate-Drop steps per run
                 (routed, routed, dropped). f32: on the dense,
                 hierarchical and overlapped wires the grouped cuda steps
                 are bitwise the ungrouped ones; on the compressed wires
                 (int8, fp8) they match the plain oracle on the same wire
                 within phase 6's tolerance. bf16: grouped dense bitwise
                 the ungrouped; per wire the launches of a routed, a
                 Gate-Drop and a Gate-Expert-Drop step equal phase 6's
                 cuda counts; cuda_fused under the group launches B2/B1/B3
                 and no B4; no collective and comm_* = 0 throughout; the
                 grouped and ungrouped steps timed in turns; the
                 compressed wire's device time per layer; greedy_bleu at
                 full width through Trainer(eval_every=1), BLEU and the
                 eval's wall time, its scored tokens gated equal to
                 generate's;
  8. full cache -- B5 and B6 at zcode-m3-base's full 1,024-position cache
                 (every row at position 1,023; B6 through a permuted page
                 arena): against the plain version, B6 bitwise against B5,
                 both bitwise on a second run and after CUDA-graph
                 replays, and timed cold (each call in the timed graph
                 finds its cache out of L2) in turns with SDPA (B5) and
                 index_select + SDPA (B6); then the decode step at depth
                 1,023 as one CUDA graph (run inside the serving phases,
                 on their weights).

  python3 chip_smoke.py --only full_cache

runs phases 1, 2 and 8 alone (the decode step at depth 1,023 on its own
seeded weights) and prints their numbers as one JSON line: the quick way
to compare two trees' B5 and B6 at these sites in one call; ``--only ep``
runs phases 1, 2 and ep alone.

Prints the kernel table as one JSON line before the last line and, as the
last line, {"ok": true, "device": {...}}. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s per input type;
# the kernels run on the CUDA cores, f32 math, so f32 inputs meet the
# non-tensor-core f32 peak
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": (1e-4, 1e-4),      # (atol, rtol): f32 sums in another order
       "bfloat16": (1e-2, 1.6e-2)}   # about two bf16 ulps of rounding
E2E_LOGIT_ATOL = 1e-3                # f32 logits, kernel vs plain path
# f32 training, kernel path vs plain path, per step: loss, grad norm and
# balance within 1e-3 relative. Step 0 differs only by the kernels' f32
# sums (~1e-6); later steps carry the parameters' Adam drift
# (adam_drift_bound), which moves these metrics far less than 1e-3.
TRAIN_METRIC_RTOL = 1e-3

BATCH, PROMPT, MAX_NEW = 8, 32, 32
SEED = 0
N_FORCED = 8          # phase 5: teacher-forced decode steps gated
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LANGS = 16, 64, 8
TRAIN_LR, TRAIN_WARMUP = 1e-3, 100      # the train CLI's defaults
PARITY_STEPS = 4                        # f32 steps per backend in the parity run
WARMUP_STEPS, TIMED_STEPS = 2, 5
OUT = REPO / "build" / "traces"          # profiler traces (gitignored)
REPLACES = {
    "grouped_matmul_dx": ("src/repro_torch/kernels/csrc/grouped_ffn.cu",
                          "src/repro/kernels/grouped_ffn.py:67"),
    "grouped_matmul_dw": ("src/repro_torch/kernels/csrc/grouped_ffn.cu",
                          "src/repro/kernels/grouped_ffn.py:67"),
    "fused_moe": ("src/repro_torch/kernels/csrc/moe_megakernel.cu",
                  "src/repro/kernels/moe_megakernel.py:132"),
    "dispatch": ("src/repro_torch/kernels/csrc/moe_dispatch.cu",
                 "src/repro/kernels/moe_dispatch.py:57"),
    "combine": ("src/repro_torch/kernels/csrc/moe_dispatch.cu",
                "src/repro/kernels/moe_dispatch.py:139"),
    "grouped_matmul": ("src/repro_torch/kernels/csrc/grouped_ffn.cu",
                       "src/repro/kernels/grouped_ffn.py:44"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:64"),
    "flash_decode_paged": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                           "src/repro/kernels/flash_decode.py:124"),
}
# phase 7: the serving trace (closed loop, all queued at t = 0)
TRACE_N, TRACE_PROMPT, TRACE_BUDGET, TRACE_PREFIX = 32, 64, 32, 32
SCHED_SLOTS, SCHED_ADMIT, SCHED_BUCKETS = 8, 4, (8, 16, 32, 64)
PAGE_SIZE, PAGES_SMALL = 16, 20        # the small arena must preempt
TIMED_REPLAYS = 3
NEAR_TIE = 1e-4                         # top-two logit gap of a tolerated divergence
# phase 8: zcode-m3-base's full cache (its max_seq), every row at the last
# position; N_COLD caches of 16.8 MB each rotate in a timed graph, more than
# the card's 50 MB L2, so each call finds its cache cold as a decode step does
FULL_SEQ, N_COLD = 1024, 8
# per-row positions of the boundary check: tile (64) and split edges
FULL_BOUNDARY = (0, 63, 64, 127, 128, 511, 512, 1023)
# a cache of more than 8 splits (4 rows of 4,160 positions: 17 splits of
# 256 on 132 SMs), so that the merge runs over several batches of 8 splits
LONG_ROWS, LONG_SEQ = 4, 4160


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def device_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph (no host overhead between launches), replayed after a warm-up,
    timed with CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def host_ms(fn, calls: int = 50) -> float:
    """Host-clock ms per eager call of ``fn`` over ``calls`` calls queued
    back to back and one device sync: the host's dispatch cost where the
    device work per call is shorter."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def in_turns(*fns):
    """Device ms of each of ``fns`` timed in turns (a, b, .., b, a), each
    the mean of its two readings."""
    ms = [device_ms(f) for f in (*fns, *fns[::-1])]
    return tuple((ms[i] + ms[-1 - i]) / 2 for i in range(len(fns)))


def rotating(fns):
    """One callable that calls ``fns`` in turn, one per call: timed in a
    graph over inputs that together exceed L2, each call finds its own
    inputs cold."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dt(t) -> str:
    return str(t.dtype).replace("torch.", "")


def work(name: str, args):
    """(bytes, flops, dtype) the function needs for these inputs: each
    input byte read once (only the rows the data selects), each output
    byte written once."""
    if name == "grouped_matmul":
        x, w = args
        e, c, d = x.shape
        f = w.shape[2]
        es = x.element_size()
        return (e * c * d + e * d * f + e * c * f) * es, 2.0 * e * c * d * f, _dt(x)
    if name == "grouped_matmul_dx":
        dy, w = args
        e, c, f = dy.shape
        d = w.shape[1]
        return (e * c * f + e * d * f + e * c * d) * dy.element_size(), \
            2.0 * e * c * d * f, _dt(dy)
    if name == "grouped_matmul_dw":
        x, dy = args
        e, c, d = x.shape
        f = dy.shape[2]
        return (e * c * d + e * c * f + e * d * f) * x.element_size(), \
            2.0 * e * c * d * f, _dt(x)
    if name == "fused_moe":
        from repro_torch.kernels import moe_megakernel
        x, w_in, w_gate, w_out, topk_w, keep, st, sv, ts = args
        e, d, f = w_in.shape
        # only experts holding a slot of non-zero weight need their weights
        # (the kernel's own test, moe_megakernel.live_experts; with softmax
        # top-k the experts holding a kept slot), only kept slots need
        # FLOPs (this run's routing)
        live = int(moe_megakernel.live_experts(topk_w, keep, ts, e, st.shape[0]).sum())
        n_slots = int(sv.sum())
        n_mats = 3 if w_gate is not None else 2
        t, k = ts.shape
        nbytes = (live * n_mats * d * f * w_in.element_size() + 2 * x.numel() * x.element_size()
                  + st.numel() * 5 + t * k * 9)
        return nbytes, 2.0 * n_mats * n_slots * d * f, _dt(w_in)
    if name == "dispatch":
        x, st, sv = args
        es = x.element_size() * x.shape[1]
        rows = torch.unique(st.long().clamp(0, x.shape[0] - 1)[sv]).numel()
        return rows * es + st.numel() * (es + 4 + 1), 0.0, _dt(x)
    if name == "combine":
        buf, ts, w, keep = args
        es = buf.element_size() * buf.shape[1]
        rows = torch.unique(ts.long().clamp(0, buf.shape[0] - 1)).numel()
        t, k = ts.shape
        return rows * es + t * es + t * k * 9, 2.0 * t * k * buf.shape[1], "float32"
    if name == "flash_decode":
        q, k, v, idx = args
        b, h, hd = q.shape
        s, kv = k.shape[1], k.shape[2]
        live = int((torch.as_tensor(idx).reshape(-1).expand(b).clamp(max=s - 1)
                    + 1).sum())
        nbytes = 2 * q.numel() * q.element_size() + 2 * live * kv * hd * k.element_size() + 4 * b
        return nbytes, 4.0 * live * (h // kv) * kv * hd, "float32"
    if name == "flash_decode_paged":
        q, k, v, bt, idx = args
        b, h, hd = q.shape
        ps, kv = k.shape[1], k.shape[2]
        # row b reads positions 0 .. min(index, nb * ps - 1): their K/V rows
        # and the table entries of the blocks that hold them
        last = idx.long().reshape(-1).expand(b).clamp(max=bt.shape[1] * ps - 1)
        live = int((last + 1).sum())
        pages = int((last // ps + 1).sum())
        nbytes = (2 * q.numel() * q.element_size() + 2 * live * kv * hd * k.element_size()
                  + 4 * pages + 4 * b)
        return nbytes, 4.0 * live * h * hd, "float32"
    raise KeyError(name)


# ---------------------------------------------------------------------------
# phase 3: kernels against plain versions
# ---------------------------------------------------------------------------

class _Counted:
    """A wrapper that reads and resets the launch count of the function it
    stands in for, so that counts taken during a capture are the kernel's."""

    def __init__(self, fn, orig):
        self._fn, self._orig = fn, orig

    def __call__(self, *args, **kw):
        return self._fn(*args, **kw)

    @property
    def launches(self):
        return self._orig.launches

    @launches.setter
    def launches(self, n):
        self._orig.launches = n

    @property
    def launches_streaming(self):
        return self._orig.launches_streaming

    @launches_streaming.setter
    def launches_streaming(self, n):
        self._orig.launches_streaming = n


class Capture:
    """Records the inputs (args, kwargs) of each kernel wrapper's first
    call per distinct input shape (of every call with ``all_calls``) while
    the main path runs; restores the wrappers on exit. ``names`` picks the
    wrappers (default: the serving path's)."""

    SERVE = ("dispatch", "combine", "grouped_matmul", "flash_decode")

    def __init__(self, all_calls: bool = False, names=SERVE):
        self.all_calls = all_calls
        from repro_torch.kernels import (flash_decode, grouped_ffn, moe_dispatch,
                                         moe_megakernel)
        mods = {"dispatch": moe_dispatch, "combine": moe_dispatch,
                "grouped_matmul": grouped_ffn, "grouped_matmul_dx": grouped_ffn,
                "grouped_matmul_dw": grouped_ffn, "fused_moe": moe_megakernel,
                "flash_decode": flash_decode, "flash_decode_paged": flash_decode}
        self.sites = [(mods[n], n) for n in names]
        self.calls = {name: [] for name in names}

    def __enter__(self):
        self.saved = []
        for mod, name in self.sites:
            orig = getattr(mod, name)
            seen = set()

            def rec(*args, _orig=orig, _name=name, _seen=seen, **kw):
                key = tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a)
                            else a for a in (*args, *kw.values()))
                if self.all_calls or key not in _seen:
                    _seen.add(key)
                    self.calls[_name].append((tuple(
                        a.detach().clone() if torch.is_tensor(a) else a
                        for a in args), dict(kw)))
                return _orig(*args, **kw)

            self.saved.append((mod, name, orig))
            setattr(mod, name, _Counted(rec, orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)
        return False


class CallCount(torch.overrides.TorchFunctionMode):
    """Counts the PyTorch functions and tensor methods called from Python
    (each one a host dispatch), not the calls they make in turn."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def check(name: str, out, ref, exact: bool = False) -> float:
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {tuple(out.shape)} {out.dtype} vs plain "
                             f"{tuple(ref.shape)} {ref.dtype}")
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (out.float() - ref.float()).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if exact:
        if not torch.equal(out, ref):
            raise AssertionError(f"{name}: not bitwise equal (max err {max_err})")
        return max_err
    atol, rtol = TOL[_dt(out)]
    if not bool((err <= atol + rtol * ref.float().abs()).all()):
        raise AssertionError(f"{name}: max abs err {max_err} beyond atol {atol} "
                             f"+ rtol {rtol} * |plain|")
    return max_err


def _fused_plain(x, w_in, w_gate, w_out, topk_w, keep, slot_token, slot_valid,
                 token_slot, act="silu"):
    """``fused_moe``'s plain version (the slot formulation on inputs upcast
    to f32, as the kernel computes) with the wrapper's signature: the
    weights folded and the tables clipped as the wrapper does."""
    from repro_torch.kernels import ref
    ts = token_slot.clamp(0, slot_token.shape[0] - 1)
    return ref.fused_moe_f32_ref(x.to(w_in.dtype), w_in, w_gate, w_out,
                                 (topk_w * keep).float(), slot_token, slot_valid, ts,
                                 act).to(x.dtype)


def plain_of(name):
    from repro_torch.kernels import ref
    return {"dispatch": ref.dispatch_ref, "combine": ref.combine_ref,
            "grouped_matmul": ref.grouped_matmul_ref,
            "grouped_matmul_dx": ref.grouped_matmul_dx_ref,
            "grouped_matmul_dw": ref.grouped_matmul_dw_ref,
            "fused_moe": _fused_plain,
            "flash_decode": ref.flash_decode_ref,
            "flash_decode_paged": ref.flash_decode_paged_ref}[name]


def kernel_of(name):
    from repro_torch.kernels import wrappers
    return wrappers()[name]


B1_STREAMED = ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw")
STREAMED = B1_STREAMED + ("fused_moe",)       # kernels with a streaming variant
# B1 shapes (E, C, d, f) at full width around C = 16, the streaming limit
B1_FULL_WIDTH = [(4, c, d, f) for c in (4, 8, 9, 16) for d, f in ((512, 2048), (2048, 512))]


def b1_variant(name, args) -> str:
    """The B1 kernel ``grouped_ffn.variant`` picks for these inputs (the
    output, a fresh allocation, is aligned)."""
    from repro_torch.kernels import grouped_ffn
    a, b = args                  # (x, w), (dy, w) or (x, dy); a's rows are C
    # dx: dy (E, C, f), w (E, d, f); forward and dw: (E, C, d), (E, ., f)
    d = b.shape[1] if name == "grouped_matmul_dx" else a.shape[2]
    return grouped_ffn.variant(a.shape[1], d, b.shape[2], a.element_size(), a.data_ptr(),
                               b.data_ptr())


def b4_variant(args) -> str:
    """The B4 kernel ``moe_megakernel.variant`` picks for these inputs, x in
    the weights' dtype as the wrapper passes it."""
    from repro_torch.kernels import moe_megakernel
    x, w_in, w_gate, w_out, _, _, st, _, _ = args
    e, d, f = w_in.shape
    xw = x.to(w_in.dtype).contiguous()
    return moe_megakernel.variant(st.shape[0] // e, d, f, w_in.element_size(), *(
        t.data_ptr() for t in (xw, w_in, w_gate, w_out) if t is not None))


def run_kernel(name, args, kw=None):
    """Runs kernel ``name`` once. Returns (out, variant): for B1's forward,
    dx and dw and for B4 the variant it took by its launch counters,
    asserted equal to what ``grouped_ffn.variant`` or
    ``moe_megakernel.variant`` predicts; None for the other kernels."""
    fn = kernel_of(name)
    if name not in STREAMED:
        return fn(*args, **(kw or {})), None
    before = fn.launches_streaming
    out = fn(*args, **(kw or {}))
    took = "streaming" if fn.launches_streaming > before else "tiled"
    want = b4_variant(args) if name == "fused_moe" else b1_variant(name, args)
    if took != want:
        raise AssertionError(f"{name}: took {took}, variant says {want}")
    return out, took


def b1_case(args, took) -> str:
    return f"{_dt(args[0])} {tuple(args[0].shape)}x{tuple(args[1].shape)} {took}"


def ragged_cases(dev):
    """(name, args, exact) cases off the main path's shapes."""
    g = torch.Generator(device=dev).manual_seed(1234)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        # dispatch: vector, 4-byte and 2-byte row paths; capacity 1; all dropped
        for t, s, d in ((64, 96, 512), (50, 40, 100), (9, 4, 37)):
            x = rn(t, d, dtype=dt)
            st = ri(-1, t + 2, s)                     # clipped out-of-range ids
            sv = torch.rand(s, generator=g, device=dev) < 0.7
            cases.append(("dispatch", (x, st, sv), True))
        x = rn(16, 64, dtype=dt)
        cases.append(("dispatch", (x, ri(0, 16, 8), torch.zeros(8, dtype=torch.bool,
                                                                  device=dev)), True))
        # combine: k=1 (the top-1 instance), 2, 5 and 40 (steps of 4 rows),
        # vector and scalar paths (d = 100; a view off a 16-byte boundary),
        # all dropped
        for t, k, s, d, off in ((32, 1, 64, 512, 0), (32, 2, 48, 512, 0), (7, 2, 5, 100, 0),
                                (9, 1, 16, 512, 1), (10, 5, 40, 512, 0), (3, 40, 50, 96, 0)):
            buf = rn(off + s * d, dtype=dt)[off:].view(s, d)
            keep = torch.rand(t, k, generator=g, device=dev) < 0.8
            cases.append(("combine", (buf, ri(0, s, t, k),
                                      torch.rand(t, k, generator=g, device=dev),
                                      keep), False))
        cases.append(("combine", (rn(6, 64, dtype=dt), ri(0, 6, 4, 2),
                                  torch.rand(4, 2, generator=g, device=dev),
                                  torch.zeros(4, 2, dtype=torch.bool, device=dev)),
                      False))
        # grouped matmul: C = 1, C < 16, C > 16, non-divisible d and f
        # (tiled); C = 4, 8, 9, 16 at full width, a ragged last stage of d
        # and a ragged column slab (streaming)
        for e, c, d, f in ((4, 1, 512, 2048), (3, 5, 100, 70), (2, 17, 64, 64),
                           (2, 100, 130, 200), *B1_FULL_WIDTH, (3, 5, 96, 64),
                           (2, 2, 40, 136)):
            cases.append(("grouped_matmul", (rn(e, c, d, dtype=dt),
                                             rn(e, d, f, dtype=dt) * d ** -0.5),
                          False))
    # flash decode: q/kv dtype pairs, GQA, head dims (33: 66-byte bf16 rows
    # take 2-byte copies), index 0, mixed indices, one split and several,
    # rows at tile and split edges of the full cache
    for qdt, kvdt in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                      (torch.bfloat16, torch.bfloat16)):
        for b, h, kv, s, hd in ((4, 8, 8, 64, 64), (3, 8, 2, 300, 128),
                                (2, 8, 1, 1000, 40), (3, 8, 4, 500, 33),
                                (8, 8, 8, FULL_SEQ, 64)):
            idx = ri(0, s, b)
            idx[0] = 0
            if s == FULL_SEQ:
                idx = torch.tensor(FULL_BOUNDARY, dtype=torch.int32, device=dev)
            cases.append(("flash_decode", (rn(b, h, hd, dtype=qdt),
                                           rn(b, s, kv, hd, dtype=kvdt),
                                           rn(b, s, kv, hd, dtype=kvdt), idx), False))
    return cases


def library_of(name, args):
    """One PyTorch call computing the kernel's function on ``args``: its
    yardstick (``library_ms``); the port never calls it."""
    if name == "grouped_matmul":
        return lambda: torch.bmm(*args)
    if name == "grouped_matmul_dx":
        dy, w = args
        wt = w.transpose(1, 2)
        return lambda: torch.bmm(dy, wt)
    if name == "grouped_matmul_dw":
        x, dy = args
        xt = x.transpose(1, 2)
        return lambda: torch.bmm(xt, dy)
    if name == "dispatch":
        x, st, _ = args
        idx = st.long().clamp(0, x.shape[0] - 1)
        return lambda: torch.index_select(x, 0, idx)
    if name == "combine":
        buf, ts, w, keep = args
        psw = (w * keep).to(buf.dtype)
        return lambda: F.embedding_bag(ts, buf, per_sample_weights=psw, mode="sum")
    if name == "flash_decode":
        q, k, v, idx = args
        s = k.shape[1]
        q4 = q.to(k.dtype)[:, :, None, :]
        k4, v4 = k.transpose(1, 2), v.transpose(1, 2)
        pos = torch.arange(s, device=k.device)[None, :]
        mask = (pos <= torch.as_tensor(idx).reshape(-1, 1))[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    if name == "flash_decode_paged":       # two calls: no one call reads pages
        q, k, v, bt, idx = args
        b, nb, ps = q.shape[0], bt.shape[1], k.shape[1]
        flat = bt.long().reshape(-1)
        q4 = q.to(k.dtype)[:, :, None, :]
        pos = torch.arange(nb * ps, device=k.device)[None, :]
        mask = (pos <= idx.long()[:, None])[:, None, None, :]

        def library():
            gk = k.index_select(0, flat).reshape(b, nb * ps, *k.shape[2:]).transpose(1, 2)
            gv = v.index_select(0, flat).reshape(b, nb * ps, *v.shape[2:]).transpose(1, 2)
            return F.scaled_dot_product_attention(q4, gk, gv, attn_mask=mask)

        return library
    raise KeyError(name)


def kernel_phase(calls, dev):
    """Checks every kernel at the captured main-path inputs and the ragged
    cases, then times it at the prefill and decode sites (B3 by
    ``combine_site``), the pair B1 -> B3 at decode and the launch floor.
    Returns ({name: max abs err over the main-path inputs}, {(name, site):
    times})."""
    out = {}
    for name in ("dispatch", "combine", "grouped_matmul", "flash_decode"):
        if not calls[name]:
            raise AssertionError(f"{name}: never called on the main path")
        max_err, variants = 0.0, []
        for args, _ in calls[name]:
            res, took = run_kernel(name, args)
            variants += [took] if took else []
            torch.cuda.synchronize()
            max_err = max(max_err, check(name, res, plain_of(name)(*args),
                                         exact=name == "dispatch"))
        out[name] = max_err
        shapes = [" x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a))
                  for args, _ in calls[name]]
        log(f"kernel {name}: {len(calls[name])} main-path input shapes "
            f"{shapes}, max abs err {max_err:.3e} (exact={name == 'dispatch'}, "
            f"tol {TOL})" + (f", variants {variants}" if variants else ""))
        if variants and set(variants) != {"streaming"}:
            raise AssertionError(f"{name}: a main-path input took the tiled kernel")
    n_rag, b1_rag = 0, []
    for name, args, exact in ragged_cases(dev):
        res, took = run_kernel(name, args)
        b1_rag += [b1_case(args, took)] if took else []
        torch.cuda.synchronize()
        check(f"{name} ragged", res, plain_of(name)(*args), exact=exact)
        n_rag += 1
    log(f"kernels: {n_rag} ragged cases agree with their plain versions "
        "(k=2, capacity 1, all dropped, non-divisible d/f, index 0, mixed "
        "per-row indices, f32 and bf16)")
    log(f"kernel grouped_matmul ragged cases and their variants: {b1_rag}")

    timing = {}
    for name in out:
        # the first captured call is the prefill site, the last the decode
        # site (flash decode runs at decode only)
        sites = [("decode", calls[name][-1][0])]
        if len(calls[name]) > 1:
            sites.insert(0, ("prefill", calls[name][0][0]))
        for site, args in sites:
            if name == "combine":
                timing[(name, site)] = combine_site(site, args)
                continue
            nbytes, flops, wdt = work(name, args)
            b_ms, b_by = bound(nbytes, flops, wdt)
            k_ms, l_ms = in_turns(lambda: kernel_of(name)(*args), library_of(name, args))
            p_ms = device_ms(lambda: plain_of(name)(*args))
            shape = " x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a))
            note = ""
            if name == "grouped_matmul":
                note = (f" (torch.bmm, timed in turns with the kernel; {b1_variant(name, args)} "
                        f"variant, {b_ms / k_ms * 100:.1f}% of the bound)")
            elif name == "dispatch":
                note = (f" (index_select, timed in turns with the kernel: kernel / library "
                        f"{k_ms / l_ms:.3f})")
            elif name == "flash_decode":
                note = f" (SDPA, timed in turns with the kernel; n_split {n_split_of(args)})"
            log(f"time {name}@{site} [{shape}]: kernel {k_ms:.6f} ms, bound "
                f"{b_ms:.6f} ms ({b_by}), plain {p_ms:.6f} ms, library "
                f"{l_ms:.6f} ms" + note)
            timing[(name, site)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                        bound_by=b_by, library_ms=l_ms,
                                        shape=shape)
            if name == "flash_decode":
                timing[(name, site)]["n_split"] = n_split_of(args)
    timing[("flash_decode", "floor")] = b5_floor(calls["flash_decode"][-1][0])
    decode = calls["combine"][-1][0]
    timing[("combine", "pair")] = pdl_pair("decode", calls["grouped_matmul"][-1][0], decode)
    timing[("launch_floor", "decode")] = launch_floor(-(-decode[1].shape[0] // 4))
    return out, timing


def combine_no_pdl(buf, ts, w, keep):
    """B3's kernel launched without PDL (``repro_moe_combine`` with pdl 0,
    which the wrapper never passes), into a new tensor; not counted."""
    from repro_torch.kernels import build
    fn = build.function("repro_moe_combine", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p])
    out = torch.empty((ts.shape[0], buf.shape[1]), dtype=buf.dtype, device=buf.device)
    build.check(fn(buf.data_ptr(), ts.data_ptr(), w.data_ptr(), keep.data_ptr(), out.data_ptr(),
                   ts.shape[0], buf.shape[0], ts.shape[1], buf.shape[1],
                   build.DTYPE_CODES[buf.dtype], 0, torch.cuda.current_stream().cuda_stream),
                "combine without PDL")
    return out


def combine_site(site, args):
    """B3 at one site: against its plain version; at top-1 the same bits
    on a second run, with PDL off and after CUDA-graph replays; then timed
    in turns: the kernel with PDL off (``ms``: each call in the timed
    graph follows another B3, and with PDL it would overlap that B3, which
    the main path never runs), the kernel as the wrapper launches it (PDL
    on: ``pdl_self_overlap_ms``) and ``embedding_bag``."""
    kernel = kernel_of("combine")
    out = kernel(*args)
    torch.cuda.synchronize()
    plain = plain_of("combine")(*args)
    err = check(f"combine@{site}", out, plain)
    top1 = args[1].shape[1] == 1
    if top1:
        check(f"combine@{site} second run", kernel(*args), out, exact=True)
        check(f"combine@{site} PDL off", combine_no_pdl(*args), out, exact=True)
        check(f"combine@{site} after CUDA-graph replays",
              graph_replayed(lambda: kernel(*args)), out, exact=True)
    fns = {"ms": lambda: combine_no_pdl(*args), "pdl_self_overlap_ms": lambda: kernel(*args),
           "library_ms": library_of("combine", args)}
    t = dict(zip(fns, in_turns(*fns.values())))
    b_ms, b_by = bound(*work("combine", args))
    t.update(plain_ms=device_ms(lambda: plain_of("combine")(*args)), bound_ms=b_ms,
             bound_by=b_by, max_abs_err=err, bitwise_plain=torch.equal(out, plain),
             shape=" x ".join(str(tuple(a.shape)) for a in args))
    log(f"time combine@{site} [{t['shape']}]: kernel {t['ms']:.6f} ms with PDL off (PDL on "
        f"{t['pdl_self_overlap_ms']:.6f}, overlapping the B3 before it in the graph), bound "
        f"{b_ms:.6f} ms ({b_by}; {b_ms / t['ms'] * 100:.2f}% of it), plain "
        f"{t['plain_ms']:.6f} ms, library {t['library_ms']:.6f} ms (embedding_bag; all timed "
        f"in turns); max abs err {err:.3e}" + (
            "; top-1: bitwise on a second run, PDL off and after 3 graph replays; bitwise "
            f"the plain version: {t['bitwise_plain']}" if top1 else ""))
    return t


def pdl_pair(site, b1_args, combine_args):
    """B1's down projection -> B3 as the main path runs them (the cast of
    B1's f32 output to B3's dtype between them at a bf16 site), 20 pairs
    in one graph, B3 with PDL on and off, in turns."""
    from repro_torch.kernels import grouped_ffn, moe_dispatch
    x, w = b1_args
    buf, ts, wt, keep = combine_args
    b3 = {True: moe_dispatch.combine, False: combine_no_pdl}
    if x.shape[0] * x.shape[1] * w.shape[2] != buf.numel():
        raise AssertionError(f"pair@{site}: B1 out {x.shape[:2]}x{w.shape[2]} vs B3 buf "
                             f"{tuple(buf.shape)}")

    def pair(pdl):
        def run():
            y = grouped_ffn.grouped_matmul(x, w).to(buf.dtype).reshape(buf.shape)
            return b3[pdl](y, ts, wt, keep)
        return run

    out = pair(True)()
    y = grouped_ffn.grouped_matmul(x, w).to(buf.dtype).reshape(buf.shape)
    check(f"B1 -> combine@{site}", out, plain_of("combine")(y, ts, wt, keep))
    check(f"B1 -> combine@{site} PDL off", pair(False)(), out, exact=True)
    on, off = in_turns(pair(True), pair(False))
    cast = " -> cast" if buf.dtype != x.dtype else ""
    log(f"time B1 -> combine@{site} [B1 {tuple(x.shape)} x {tuple(w.shape)} {_dt(x)}{cast} -> "
        f"B3 {tuple(buf.shape)} {_dt(buf)}]: 20 pairs in one graph, per pair: B3 with PDL "
        f"{on:.6f} ms, without {off:.6f} ms (in turns)")
    return dict(pdl_ms=on, no_pdl_ms=off, cast=bool(cast),
                shape=f"B1 {tuple(x.shape)} x {tuple(w.shape)} -> B3 {tuple(buf.shape)}")


def launch_floor(blocks: int):
    """An empty kernel of ``blocks`` x 128 threads (``repro_launch_floor``:
    B3's launch path, no work), 20 launches in one graph, with PDL and
    without, in turns: the floor of a launch-bound kernel."""
    from repro_torch.kernels import build
    fn = build.function("repro_launch_floor", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

    def launcher(pdl: int):
        return lambda: build.check(
            fn(blocks, pdl, torch.cuda.current_stream().cuda_stream), "launch floor")

    on, off = in_turns(launcher(1), launcher(0))
    log(f"time launch floor [{blocks} x 128 threads, empty]: {on:.6f} ms with PDL, {off:.6f} "
        "ms without (20 launches in one graph, in turns)")
    return dict(pdl_ms=on, no_pdl_ms=off, blocks=blocks)


def b5_floor(args):
    """B5's launch floor: the main path's decode inputs with every row at
    position 0 (one live position per row), timed in turns with SDPA."""
    q, k, v, _ = args
    fargs = (q, k, v, torch.zeros(q.shape[0], dtype=torch.int32, device=q.device))
    nbytes, flops, wdt = work("flash_decode", fargs)
    b_ms, b_by = bound(nbytes, flops, wdt)
    k_ms, l_ms = in_turns(lambda: kernel_of("flash_decode")(*fargs),
                          library_of("flash_decode", fargs))
    t = dict(ms=k_ms, plain_ms=device_ms(lambda: plain_of("flash_decode")(*fargs)),
             bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
             shape=" x ".join(str(tuple(a.shape)) for a in fargs), index="0 on every row")
    log(f"time flash_decode@floor [{t['shape']}, every index 0]: kernel {k_ms:.6f} ms, bound "
        f"{b_ms:.6f} ms ({b_by}), plain {t['plain_ms']:.6f} ms, library {l_ms:.6f} ms (SDPA, "
        "in turns): the launch floor of the main-path time")
    return t


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def _pool(cfg, fresh, dev):
    """The engine's slot pool holding the per-request caches ``fresh``."""
    from repro_torch.serve.engine import (_alloc_pool_like, _cache_batch_axes,
                                          _scatter_slots)
    axes = _cache_batch_axes(cfg)
    return _scatter_slots(_alloc_pool_like(fresh, axes, BATCH), fresh, axes,
                          torch.arange(BATCH, device=dev))


def slice_phase(params, batch, cfg, gen, dev):
    """One counted ``generate`` (launch counts asserted, peak memory), then
    timed rounds (the serving CLI's), then one decode step replayed as a CUDA graph.
    Returns the launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import TIMED_ROUNDS, spread, time_generate
    from repro_torch.serve import generate

    generate(params, batch, cfg, gen)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = generate(params, batch, cfg, gen)
    torch.cuda.synchronize()
    counts = launch_counts()
    streamed = streamed_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = res.steps
    n_moe_dec = sum(cfg.moe.is_moe_layer(i) for i in range(cfg.n_layers))
    n_moe_enc = sum(cfg.moe.is_moe_layer(i) for i in range(cfg.encdec.n_encoder_layers))
    # the training kernels (B1's backward, B4) never run while serving
    expect = {**{name: 0 for name in counts},
              "flash_decode": cfg.n_layers * steps,
              "dispatch": n_moe_enc + n_moe_dec + n_moe_dec * steps,
              "combine": n_moe_enc + n_moe_dec + n_moe_dec * steps,
              "grouped_matmul": 2 * (n_moe_enc + n_moe_dec + n_moe_dec * steps)}
    log(f"slice: launches {counts}, expected {expect}")
    served = {k: expect[k] for k in Capture.SERVE}
    if counts != expect or served != {"flash_decode": 186, "dispatch": 102,
                                      "combine": 102, "grouped_matmul": 204}:
        raise AssertionError(f"launch counts {counts} != {expect}")
    check_streamed("slice", counts, streamed)
    toks = res.tokens
    if toks.shape != (BATCH, MAX_NEW) or not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    log(f"slice: first row tokens {toks[0].tolist()} "
        f"({len(set(toks.flatten().tolist()))} distinct tokens in the batch)")
    log(f"slice: peak memory {peak / 2**30:.2f} GiB")

    med, rounds, _ = time_generate(params, batch, cfg, gen)
    log(f"slice: median of {TIMED_ROUNDS} rounds [min, max] (8 x 32 prompt tokens, 32 "
        f"source tokens, {steps} decode steps): prefill {med['prefill_ms']:.2f} ms "
        f"{spread(rounds['prefill_ms'])}, decode {med['decode_ms_per_step']:.2f} "
        f"ms/step {spread(rounds['decode_ms_per_step'])}, total "
        f"{med['total_ms']:.2f} ms {spread(rounds['total_ms'])}, "
        f"{med['tok_s']:.0f} tokens/s {spread(rounds['tok_s'])}")

    decode_graph("slice", params, batch, cfg, med["decode_ms_per_step"], dev)
    return counts, res.tokens


def decode_graph(label, params, batch, cfg, decode_ms, dev):
    """One decode step replayed as one CUDA graph (its device time without
    the host's per-op dispatch) against the eager median, and the PyTorch
    calls from Python in one eager step."""
    from repro_torch.models import prefill
    from repro_torch.serve.engine import decode_pool_step
    lg, fresh = prefill(params, batch, cfg, max_seq=PROMPT + MAX_NEW)
    pool = _pool(cfg, fresh, dev)
    tok = lg[:, 0].argmax(-1)
    pos = torch.full((BATCH,), PROMPT, device=dev)
    alive = torch.ones(BATCH, dtype=torch.bool, device=dev)
    graph_ms = device_ms(lambda: decode_pool_step(params, pool, tok, pos, alive, cfg,
                                                  flash_decode=True),
                         reps=1, replays=20)
    log(f"{label}: decode step as one CUDA graph {graph_ms:.2f} ms on the device "
        f"vs median {decode_ms:.2f} ms eager: the device is idle "
        f"{max(0.0, 1 - graph_ms / decode_ms) * 100:.0f}% of an eager step")
    with CallCount() as calls:
        decode_pool_step(params, pool, tok, pos, alive, cfg, flash_decode=True)
    log(f"{label}: {calls.n} PyTorch calls from Python per eager decode step")


def fused_slice_phase(params, batch, cfg, gen, dev, cuda_tokens):
    """Phase 4 on the ``cuda_fused`` backend: one counted bf16 ``generate``
    (B4 once per MoE layer call, every launch streaming, B5 as on ``cuda``;
    tokens against the ``cuda`` backend's, reported), the serving CLI's
    timed rounds of both backends in turns, the decode step as one CUDA
    graph, B4 at the captured prefill and decode sites against its
    plain version and timed in turns with the ``cuda`` pipeline, and the
    f32 tokens of both backends, gated equal up to near-ties. Returns
    ({site: B4 timing}, B4 launches per generate)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import TIMED_ROUNDS, time_generate
    from repro_torch.serve import generate

    fused = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, backend="cuda_fused"))
    generate(params, batch, fused, gen)                 # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    res = generate(params, batch, fused, gen)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_moe_dec = sum(cfg.moe.is_moe_layer(i) for i in range(cfg.n_layers))
    n_moe_enc = sum(cfg.moe.is_moe_layer(i) for i in range(cfg.encdec.n_encoder_layers))
    expect = {**{name: 0 for name in counts}, "flash_decode": cfg.n_layers * res.steps,
              "fused_moe": n_moe_enc + n_moe_dec + n_moe_dec * res.steps}
    log(f"slice cuda_fused: launches {counts}, expected {expect}")
    if counts != expect or (expect["fused_moe"], expect["flash_decode"]) != (102, 186):
        raise AssertionError(f"cuda_fused launch counts {counts} != {expect}")
    check_streamed("slice cuda_fused", counts, streamed_counts())
    agree = float((res.tokens == cuda_tokens).float().mean())
    log(f"slice cuda_fused bf16: tokens agree with the cuda backend's on {agree * 100:.1f}% "
        f"of {res.tokens.numel()} (reported: bf16 activations round the two backends' "
        f"MoE outputs at different places; the f32 gate follows); first row "
        f"{res.tokens[0].tolist()}")
    # the two backends' serving times in turns (cuda, fused, fused, cuda):
    # host speed drifts within a call
    runs = {"cuda": [], "cuda_fused": []}
    for name in ("cuda", "cuda_fused", "cuda_fused", "cuda"):
        med, _, _ = time_generate(params, batch, fused if name == "cuda_fused" else cfg, gen)
        runs[name].append(med)
    for name, meds in runs.items():
        log(f"slice {name}, timed in turns: medians of {TIMED_ROUNDS} rounds, two readings: "
            f"prefill {[round(m['prefill_ms'], 2) for m in meds]} ms, decode "
            f"{[round(m['decode_ms_per_step'], 2) for m in meds]} ms/step, "
            f"{[round(m['tok_s']) for m in meds]} tokens/s")
    decode_graph("slice cuda_fused", params, batch, fused,
                 sum(m["decode_ms_per_step"] for m in runs["cuda_fused"]) / 2, dev)

    with Capture(names=("fused_moe",)) as cap:
        generate(params, batch, fused, dataclasses.replace(gen, max_new=2))
    torch.cuda.synchronize()
    calls = cap.calls["fused_moe"]
    timing = {site: b4_site(site, *calls[i]) for site, i in (("prefill", 0), ("decode", -1))}
    del cap, calls

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    fused32 = dataclasses.replace(fused, dtype="float32")
    a = generate(params, batch, cfg32, gen).tokens
    b = generate(params, batch, fused32, gen).tokens
    gaps = near_tie_gaps(params, batch, cfg32, a, b, dev)
    log(f"slice f32: cuda_fused tokens equal the cuda backend's on "
        f"{float((a == b).float().mean()) * 100:.1f}% of {a.numel()}; divergences (row, "
        f"first token, top-two logit gap of the cuda path): {gaps}")
    if any(gap >= NEAR_TIE for _, _, gap in gaps):
        raise AssertionError(f"cuda_fused vs cuda: a divergence is not a near-tie: {gaps}")
    return timing, counts["fused_moe"]


def near_tie_gaps(params, batch, cfg, a, b, dev):
    """For each row where the token lists ``a`` (``cfg``'s path) and ``b``
    differ: (row, first differing token, top-two gap of ``cfg``'s logits
    there), the whole batch teacher-forced with ``a`` (its rows share
    expert capacity, as in ``generate``)."""
    from repro_torch.models import prefill
    from repro_torch.serve.engine import decode_pool_step
    first = {r: int((a[r] != b[r]).nonzero()[0, 0]) for r in range(a.shape[0])
             if not torch.equal(a[r], b[r])}
    if not first:
        return []
    lg, caches = prefill(params, batch, cfg, max_seq=PROMPT + MAX_NEW)
    logits, pool = lg[:, 0], _pool(cfg, caches, dev)
    alive = torch.ones(a.shape[0], dtype=torch.bool, device=dev)
    gaps = []
    for i in range(max(first.values()) + 1):
        if i > 0:
            pos = torch.full((a.shape[0],), PROMPT + i - 1, device=dev)
            logits, pool = decode_pool_step(params, pool, a[:, i - 1], pos, alive, cfg,
                                            flash_decode=True)
        for r, t in first.items():
            if t == i:
                top = logits[r].float().topk(2).values
                gaps.append((r, t, float(top[0] - top[1])))
    return gaps


def e2e_phase(params, batch, cfg, gen, dev):
    """Kernel path (cuda MoE backend, flash decode) against the plain path
    (oracle MoE, plain decode attention) in f32 activations. Gates the
    prefill logits and N_FORCED decode steps' logits, both paths fed the
    same random tokens (random weights collapse greedy decoding onto few
    tokens, so greedy outputs alone would drive decode with one input).
    Reports the share of tokens that agree, greedy and sampled at
    temperature 1 with one seed (the same Gumbel noise on both paths)."""
    from repro_torch.models import prefill
    from repro_torch.serve import generate
    from repro_torch.serve.engine import decode_pool_step

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    plain32 = dataclasses.replace(cfg32, moe=dataclasses.replace(cfg32.moe,
                                                                 backend="oracle"))
    lk, ck = prefill(params, batch, cfg32, max_seq=PROMPT + MAX_NEW)
    lp, cp = prefill(params, batch, plain32, max_seq=PROMPT + MAX_NEW)
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("non-finite f32 prefill logits")
    d_pre = float((lk - lp).abs().max())
    log(f"e2e f32: prefill logits {tuple(lk.shape)} (max |logit| "
        f"{float(lp.abs().max()):.3f}) kernel vs plain path max abs diff "
        f"{d_pre:.3e} (tol {E2E_LOGIT_ATOL})")
    if d_pre > E2E_LOGIT_ATOL:
        raise AssertionError(f"prefill logits differ by {d_pre}")

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    forced = torch.randint(3, cfg.vocab, (BATCH, N_FORCED), generator=g, device=dev)
    pk, pp = _pool(cfg32, ck, dev), _pool(plain32, cp, dev)
    alive = torch.ones(BATCH, dtype=torch.bool, device=dev)
    d_dec = 0.0
    for i in range(N_FORCED):
        pos = torch.full((BATCH,), PROMPT + i, device=dev)
        a, pk = decode_pool_step(params, pk, forced[:, i], pos, alive, cfg32,
                                 flash_decode=True)
        b, pp = decode_pool_step(params, pp, forced[:, i], pos, alive, plain32,
                                 flash_decode=False)
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"non-finite f32 decode logits at step {i}")
        d_dec = max(d_dec, float((a - b).abs().max()))
    log(f"e2e f32: {N_FORCED} teacher-forced decode steps (random tokens), logits "
        f"kernel vs plain path max abs diff {d_dec:.3e} (tol {E2E_LOGIT_ATOL})")
    if d_dec > E2E_LOGIT_ATOL:
        raise AssertionError(f"decode logits differ by {d_dec}")

    for mode, gc in (("greedy", gen), ("sampled", dataclasses.replace(gen, temperature=1.0))):
        rk = generate(params, batch, cfg32, gc, seed=SEED)
        rp = generate(params, batch, plain32, dataclasses.replace(gc, flash_decode=False),
                      seed=SEED)
        agree = float((rk.tokens == rp.tokens).float().mean())
        per_row = sum(len(set(r)) for r in rk.tokens.tolist()) / BATCH
        log(f"e2e f32: {mode} tokens agree on {agree * 100:.1f}% of "
            f"{rk.tokens.numel()} (reported, not gated: near-tie expert flips may "
            f"split the runs); {len(set(rk.tokens.flatten().tolist()))} distinct "
            f"tokens, {per_row:.1f} per row of {MAX_NEW}")


def sensitivity(params, batch, cfg, dev):
    """Weights of rank >= 2 scaled by 3 in place (the CPU tests' init),
    f32 prefill. Reports, not gated: each kernel against its plain version
    at every call's inputs (max abs err over max |plain|), the kernel path
    against the plain path, and the plain path against itself with the
    embedding table perturbed by 1e-6 of each entry's magnitude."""
    from repro_torch.models import prefill

    for t in _leaves(params):
        if t.ndim >= 2:
            t.mul_(3.0)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    plain32 = dataclasses.replace(cfg32, moe=dataclasses.replace(cfg32.moe,
                                                                 backend="oracle"))
    with Capture(all_calls=True) as cap:
        lk, _ = prefill(params, batch, cfg32, max_seq=PROMPT + MAX_NEW)
    for name, calls in cap.calls.items():
        rel = 0.0
        for args, _ in calls:
            out, ref = kernel_of(name)(*args).float(), plain_of(name)(*args).float()
            rel = max(rel, float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30)))
        if calls:
            log(f"x3 weights: kernel {name} over {len(calls)} prefill calls, max abs "
                f"err / max |plain| {rel:.3e}")
    del cap
    lp, _ = prefill(params, batch, plain32, max_seq=PROMPT + MAX_NEW)
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    emb = params["embed"]
    emb.add_(torch.randn(emb.shape, generator=g, device=dev) * 1e-6 * emb.abs())
    lq, _ = prefill(params, batch, plain32, max_seq=PROMPT + MAX_NEW)
    log(f"x3 weights: f32 prefill logits (max |logit| {float(lp.abs().max()):.3f}) "
        f"kernel vs plain path max abs diff {float((lk - lp).abs().max()):.3e}; "
        f"plain vs plain with the embedding perturbed 1e-6 relative "
        f"{float((lq - lp).abs().max()):.3e}")


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

def train_cfg(full, backend: str, dtype: str, mode: str = "gate_drop"):
    """zcode-m3-base with Gate-Drop 0.3 (the paper's setting) on ``backend``,
    activations in ``dtype``; remat on, as the config has it."""
    gd = dataclasses.replace(full.moe.gating_dropout, mode=mode, rate=0.3)
    return dataclasses.replace(full, dtype=dtype, moe=dataclasses.replace(
        full.moe, backend=backend, gating_dropout=gd))


def train_tc(steps: int):
    from repro_torch.configs import TrainConfig
    return TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, seed=SEED, steps=steps)


def train_batches(dev, n: int):
    """The first ``n`` steps' batches of the reference's synthetic
    multilingual MT task, on the card."""
    from repro_torch.data import MTTaskConfig, MultilingualMT
    from repro_torch.training.loop import to_device
    fn = MultilingualMT(MTTaskConfig(vocab=64_000, n_langs=TRAIN_LANGS,
                                     max_len=TRAIN_SEQ)).train_batches(TRAIN_BATCH)
    return [to_device(fn(i), dev) for i in range(n)]


def adam_drift_bound(tc, steps: int) -> float:
    """How far two runs' parameters may drift apart in ``steps`` Adam steps
    whatever their gradients: each step moves a parameter by lr_t *
    |m_hat / (sqrt(v_hat) + eps)|, and by Cauchy-Schwarz over the moment
    sums that ratio is at most R_t = sqrt(sum_i a_i^2 / b_i), with a_i,
    b_i the bias-corrected weights of step i in m_hat and v_hat (R_1 = 1).
    Two runs that see gradients of opposite sign (an entry at rounding
    level, or a token routed elsewhere) part by at most 2 * sum lr_t R_t."""
    import math
    from repro_torch.optim.adam import schedule
    total = 0.0
    for t in range(1, steps + 1):
        a = [(1 - tc.b1) * tc.b1 ** (t - i) / (1 - tc.b1 ** t) for i in range(1, t + 1)]
        b = [(1 - tc.b2) * tc.b2 ** (t - i) / (1 - tc.b2 ** t) for i in range(1, t + 1)]
        total += schedule(t, tc) * math.sqrt(sum(x * x / y for x, y in zip(a, b)))
    return 2.0 * total


def train_parity(full, dev):
    """PARITY_STEPS f32 steps of the plain oracle path, cuda_fused and cuda
    from one seeded init, on the same batches and drop bits. Gates each
    kernel path against the plain path and returns the kernel inputs
    captured at the first step of each kernel path."""
    from repro_torch.core.gating_dropout import drop_decisions_host
    from repro_torch.models import init_model
    from repro_torch.launch.serve import generator
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.tree import flatten_with_paths

    tc = train_tc(PARITY_STEPS)
    batches = train_batches(dev, PARITY_STEPS)
    bits = drop_decisions_host(train_cfg(full, "oracle", "float32").moe.gating_dropout,
                               SEED, 0, PARITY_STEPS)
    log(f"train parity: drop bits of steps 0..{PARITY_STEPS - 1}: {bits.astype(int).tolist()}")
    if bits.all() or not bits.any():
        raise AssertionError("the parity steps must include a routed and a dropped step")
    param_tol = adam_drift_bound(tc, PARITY_STEPS)
    captured, ref = {}, None
    for backend, names in (("oracle", ()), ("cuda_fused", ("fused_moe",)),
                           ("cuda", ("grouped_matmul", "grouped_matmul_dx",
                                     "grouped_matmul_dw", "dispatch", "combine"))):
        cfg = train_cfg(full, backend, "float32")
        state = init_train_state(init_model(generator(dev, SEED, 0), cfg), tc)
        step = make_train_step(cfg, tc)
        rows = []
        t0 = time.perf_counter()
        for i in range(PARITY_STEPS):
            cap = Capture(names=names)
            with cap if i == 0 else contextlib.nullcontext():
                state, m = step(state, batches[i])
            if i == 0:
                captured.update(cap.calls)
            rows.append({k: float(m[k]) for k in ("loss", "grad_norm", "balance",
                                                  "gate_dropped")})
        torch.cuda.synchronize()
        params = {k: v.detach() for k, v in flatten_with_paths(state["params"]).items()}
        del state, step
        torch.cuda.empty_cache()
        log(f"train parity {backend} f32: {PARITY_STEPS} steps in "
            f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
                f"loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f} balance "
                f"{r['balance']:.6f} dropped {int(r['gate_dropped'])}" for r in rows))
        if not all(math.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"{backend}: non-finite training metrics")
        if ref is None:
            ref = (rows, params)
            continue
        worst = {k: 0.0 for k in ("loss", "grad_norm", "balance")}
        for r, q in zip(rows, ref[0]):
            if r["gate_dropped"] != q["gate_dropped"]:
                raise AssertionError(f"{backend}: drop bits differ")
            for k in worst:
                worst[k] = max(worst[k], abs(r[k] - q[k]) / max(abs(q[k]), 1e-6))
        diffs = torch.stack([(params[k] - ref[1][k]).abs().max() for k in params])
        pmax = float(diffs.max())
        log(f"train parity {backend} vs plain: max relative diff per step "
            f"{', '.join(f'{k} {v:.3e}' for k, v in worst.items())} (tol "
            f"{TRAIN_METRIC_RTOL}); parameters max abs diff {pmax:.3e}, median over "
            f"leaves {float(diffs.median()):.3e} (tol {param_tol:.3e} = Adam's drift "
            f"bound over {PARITY_STEPS} steps)")
        if max(worst.values()) > TRAIN_METRIC_RTOL or pmax > param_tol:
            raise AssertionError(f"{backend}: training differs from the plain path")
        del params
    del ref
    torch.cuda.empty_cache()
    return captured


def fused_ragged_cases(dev):
    """(args, kwargs) of B4 calls off the main path: k=2, capacity 1, all
    dropped, one token, d and f not multiples of the tile, d > 512 (two
    columns per thread), 16-row tiles, gelu and silu (gated)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import router as R
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(4321)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for e, k, cap, t, d, f, gated, act, drop_all in (
                (4, 2, 8, 37, 24, 40, True, "silu", False),
                (4, 1, 1, 16, 100, 70, False, "gelu", False),
                (2, 1, 1, 1, 8, 8, True, "gelu", False),
                (4, 2, 8, 24, 16, 16, True, "silu", True),
                (8, 1, 20, 64, 1000, 600, True, "silu", False),
                (8, 2, 12, 40, 512, 2048, False, "gelu", False)):
            x = torch.randn(t, d, generator=g, device=dev)
            wr = torch.randn(d, e, generator=g, device=dev)
            w_in = torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5
            w_gate = torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5 if gated else None
            w_out = torch.randn(e, f, d, generator=g, device=dev) * f ** -0.5
            rr = R.route(wr, x, MoEConfig(n_experts=e, top_k=k, jitter_eps=0.0),
                         is_training=False)
            info = R.dispatch_info(rr, e, cap)
            if drop_all:
                info = info._replace(keep=torch.zeros_like(info.keep))
            tb = ops.routing_tables(info, e, cap)
            args = (x.to(dt), w_in.to(dt), None if w_gate is None else w_gate.to(dt),
                    w_out.to(dt), info.topk_w, info.keep, tb.slot_token, tb.slot_valid,
                    tb.token_slot)
            cases.append((args, {"act": act}, drop_all))
    return cases


def bwd_ragged_cases(dev):
    g = torch.Generator(device=dev).manual_seed(4322)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for e, c, d, f in ((4, 1, 100, 70), (3, 17, 130, 200), (2, 100, 64, 64)):
            x = torch.randn(e, c, d, generator=g, device=dev).to(dt)
            w = (torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5).to(dt)
            dy = torch.randn(e, c, f, generator=g, device=dev).to(dt)
            cases += [("grouped_matmul_dx", (dy, w)), ("grouped_matmul_dw", (x, dy))]
        # streaming at full width around C = 16, a ragged slab of d and a
        # ragged last chunk of f
        for e, c, d, f in (*B1_FULL_WIDTH, (3, 5, 96, 64), (2, 2, 40, 136)):
            x = torch.randn(e, c, d, generator=g, device=dev).to(dt)
            w = (torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5).to(dt)
            dy = torch.randn(e, c, f, generator=g, device=dev).to(dt)
            cases += [("grouped_matmul_dx", (dy, w)), ("grouped_matmul_dw", (x, dy))]
    return cases


def tiled_dx(dy, w):
    """dx on the tiled kernel, whatever ``grouped_ffn.variant`` says (its
    launch is not counted)."""
    from repro_torch.kernels import grouped_ffn
    e, c, f = dy.shape
    d = w.shape[1]
    return grouped_ffn._launch("repro_grouped_matmul_dx", dy, w, (e, c, d), e, c, d, f)[0]


def train_sites(captured):
    """(name, site, (args, kw)) of the training-site timings: B1's forward
    at its d = 2048 product (the decode site's layout), dx at both
    products (w_out (E, d_ff, d): "train", w_in (E, d, d_ff): "train_up"),
    dW, B4, B2 and B3 at their one shape."""
    dx = {("train" if args[1].shape[1] > args[1].shape[2] else "train_up"): (args, kw)
          for args, kw in captured["grouped_matmul_dx"]}
    if sorted(dx) != ["train", "train_up"]:
        raise AssertionError(f"grouped_matmul_dx: training sites {sorted(dx)}")
    return [("fused_moe", "train", captured["fused_moe"][0]),
            ("grouped_matmul", "train", captured["grouped_matmul"][-1]),
            ("grouped_matmul_dx", "train", dx["train"]),
            ("grouped_matmul_dx", "train_up", dx["train_up"]),
            ("grouped_matmul_dw", "train", captured["grouped_matmul_dw"][0]),
            ("dispatch", "train", captured["dispatch"][0]),
            ("combine", "train", captured["combine"][0])]


def b4_pipeline(args, kw):
    """The port's unfused cuda pipeline (B2 -> B1 x 2 -> B3) on B4's inputs:
    B4's yardstick, since no single PyTorch call computes gather + FFN +
    scatter."""
    from repro_torch.kernels import moe_dispatch, ops
    x, w_in, w_gate, w_out, topk_w, keep, st, sv, ts = args
    e, cap = w_in.shape[0], st.shape[0] // w_in.shape[0]

    def pipeline():
        buf = moe_dispatch.dispatch(x, st, sv).reshape(e, cap, -1)
        out = ops.expert_ffn_op(buf.to(w_in.dtype), w_in, w_gate, w_out, kw["act"])
        return moe_dispatch.combine(out.to(x.dtype).reshape(e * cap, -1), ts, topk_w, keep)
    return pipeline


def b4_site(site, args, kw):
    """B4 at one site: against its plain version and the cuda pipeline, the
    same bits on a second run at top-1, then timed in turns with the
    pipeline (kernel, pipeline, pipeline, kernel). Returns its timing."""
    from repro_torch.kernels import moe_megakernel
    out, took = run_kernel("fused_moe", args, kw)
    torch.cuda.synchronize()
    err = check(f"fused_moe@{site}", out, plain_of("fused_moe")(*args, **kw))
    pipeline = b4_pipeline(args, kw)
    check(f"cuda pipeline vs fused_moe@{site}", pipeline(), out)
    if args[4].shape[1] == 1:
        check(f"fused_moe@{site} second run", kernel_of("fused_moe")(*args, **kw), out,
              exact=True)
    x, w_in, _, _, topk_w, keep, st, _, ts = args
    live = int(moe_megakernel.live_experts(topk_w, keep, ts, w_in.shape[0], st.shape[0]).sum())
    b_ms, b_by = bound(*work("fused_moe", args))
    k_ms, pipe_ms = in_turns(lambda: kernel_of("fused_moe")(*args, **kw), pipeline)
    p_ms = device_ms(lambda: plain_of("fused_moe")(*args, **kw))
    # serving sites: the host's dispatch cost per call, beside the device's
    host = {name: host_ms(fn) for name, fn in (
        ("kernel", lambda: kernel_of("fused_moe")(*args, **kw)), ("pipeline", pipeline))
        } if site in ("prefill", "decode") else None
    shape = " x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a))
    log(f"time fused_moe@{site} [{shape}, C={st.shape[0] // w_in.shape[0]}, {live} live "
        f"experts, {took}]: kernel {k_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}; "
        f"{b_ms / k_ms * 100:.1f}% of it), plain {p_ms:.6f} ms, library null (no single "
        f"PyTorch call computes gather + FFN + scatter), cuda pipeline (B2 -> B1 x2 -> B3, "
        f"timed in turns with the kernel) {pipe_ms:.6f} ms; max abs err {err:.3e}" + (
            f"; host ms per eager call: kernel {host['kernel']:.4f}, pipeline "
            f"{host['pipeline']:.4f}" if host else ""))
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                pipeline_ms=pipe_ms, shape=shape, live_experts=live, variant=took,
                max_abs_err=err, host_ms=host)


def balanced_args(args):
    """B4's training-site inputs routed so that every expert holds C kept
    slots of one token each (the bound with every expert read)."""
    x, w_in, w_gate, w_out = args[:4]
    s = args[6].shape[0]                  # E * C slots, as many as the site's tokens
    g = torch.Generator(device=x.device).manual_seed(SEED + 31)
    slots = torch.arange(s, dtype=torch.int32, device=x.device)
    return (x[:s], w_in, w_gate, w_out,
            torch.rand(s, 1, generator=g, device=x.device) * 0.9 + 0.1,
            torch.ones(s, 1, dtype=torch.bool, device=x.device), slots,
            torch.ones(s, dtype=torch.bool, device=x.device), slots[:, None].clone())


def graph_replayed(fn):
    """``fn()``'s output after three replays of a CUDA graph that captured
    one call (after an eager warm-up on a side stream)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = fn()
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    return y


def b4_checks(args, kw):
    """B4's streaming kernel at the training site: the same bits after
    CUDA-graph replays (its per-expert counts zeroed with the output);
    the unrouted experts' weights set to NaN leave the output finite and
    bitwise equal, and equal to the plain version on zeroed weights (they
    are never read); all slots dropped gives exact zeros."""
    from repro_torch.kernels import moe_megakernel
    x, w_in, w_gate, w_out, topk_w, keep, st, sv, ts = args
    fused = kernel_of("fused_moe")
    out, took = run_kernel("fused_moe", args, kw)
    check("fused_moe after CUDA-graph replays", graph_replayed(lambda: fused(*args, **kw)), out,
          exact=True)
    live = moe_megakernel.live_experts(topk_w, keep, ts, w_in.shape[0], st.shape[0])
    poisoned, zeroed = [], []
    for w in (w_in, w_gate, w_out):
        if w is None:
            poisoned.append(None)
            zeroed.append(None)
            continue
        poisoned.append(w.clone())
        poisoned[-1][~live] = float("nan")
        zeroed.append(w.clone())
        zeroed[-1][~live] = 0.0
    pargs = (x, poisoned[0], poisoned[1], poisoned[2], *args[4:])
    zargs = (x, zeroed[0], zeroed[1], zeroed[2], *args[4:])
    pout, _ = run_kernel("fused_moe", pargs, kw)
    torch.cuda.synchronize()
    check("fused_moe with NaN unrouted weights vs plain on zeroed ones", pout,
          plain_of("fused_moe")(*zargs, **kw))
    check("fused_moe with NaN unrouted weights vs clean weights", pout, out, exact=True)
    del poisoned, zeroed, pargs, zargs
    dropped = kernel_of("fused_moe")(*args[:5], torch.zeros_like(keep), *args[6:], **kw)
    torch.cuda.synchronize()
    if float(dropped.abs().max()) != 0.0:
        raise AssertionError("fused_moe: all dropped at the training site but output not zero")
    log(f"kernel fused_moe@train ({took}): bitwise equal after 3 CUDA-graph replays; "
        f"{int((~live).sum())} unrouted experts' weights set to NaN leave the output finite, "
        f"bitwise equal and equal to the plain version on zeroed weights; all dropped "
        f"gives exact zeros")


def train_kernel_phase(captured, dev):
    """B4, B1's kernels, B2 and B3 against their plain versions at the
    inputs captured from the first training step and in ragged cases, B4's
    streaming checks (``b4_checks``), then timed at the training sites
    (``train_sites``; B3 by ``combine_site``), B4 at the balanced site and
    the pair B1 -> B3. Returns ({name: max abs err}, {(name, site):
    times})."""
    errs = {}
    for name in ("fused_moe", "grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw",
                 "dispatch", "combine"):
        if not captured.get(name):
            raise AssertionError(f"{name}: never called on the training path")
        err, variants = 0.0, []
        for args, kw in captured[name]:
            out, took = run_kernel(name, args, kw)
            variants += [took] if took else []
            torch.cuda.synchronize()
            err = max(err, check(name, out, plain_of(name)(*args, **kw),
                                 exact=name == "dispatch"))
        errs[name] = err
        shapes = [" x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a))
                  for args, _ in captured[name]]
        tol = "bitwise" if name == "dispatch" else f"tol {TOL['float32']}"
        log(f"kernel {name}: training-site inputs {shapes}, max abs err {err:.3e} "
            f"({tol})" + (f", variants {variants}" if variants else ""))
        if variants and set(variants) != {"streaming"}:
            raise AssertionError(f"{name}: a training-site input took the tiled kernel")
    n, b4_rag = 0, []
    for args, kw, drop_all in fused_ragged_cases(dev):
        out, took = run_kernel("fused_moe", args, kw)
        torch.cuda.synchronize()
        check("fused_moe ragged", out, plain_of("fused_moe")(*args, **kw))
        if drop_all and float(out.abs().max()) != 0.0:
            raise AssertionError("fused_moe: all dropped but output not zero")
        x, w_in = args[:2]
        b4_rag.append(f"{_dt(w_in)} E={w_in.shape[0]} k={args[4].shape[1]} "
                      f"C={args[6].shape[0] // w_in.shape[0]} T={x.shape[0]} "
                      f"d={w_in.shape[1]} f={w_in.shape[2]} {took}")
        n += 1
    log(f"kernel fused_moe ragged cases and their variants: {b4_rag}")
    b1_rag = []
    for name, args in bwd_ragged_cases(dev):
        out, took = run_kernel(name, args)
        b1_rag += [f"{name[15:]} {b1_case(args, took)}"]
        check(f"{name} ragged", out, plain_of(name)(*args))
        n += 1
    torch.cuda.synchronize()
    log(f"kernel grouped_matmul_dx/_dw ragged cases and their variants: {b1_rag}")
    log(f"train kernels: {n} ragged cases agree with their plain versions (B4: k=2, "
        "capacity 1, all dropped, T=1, ragged d and f, d > 512, C=12 and C=20, gelu and "
        "gated silu; B1 dx/dw: C=1, C=17, C=100, ragged d and f; C=4, 8, 9, 16 at "
        "full width, a ragged slab of d, a ragged last chunk of f; f32 and bf16)")

    args, kw = captured["fused_moe"][0]
    b4_checks(args, kw)
    timing = {("fused_moe", "balanced"): b4_site("balanced", balanced_args(args), kw)}
    for name, site, (args, kw) in train_sites(captured):
        if name == "fused_moe":
            timing[(name, site)] = b4_site(site, args, kw)
            continue
        if name == "combine":
            timing[(name, site)] = combine_site(site, args)
            continue
        b_ms, b_by = bound(*work(name, args))
        extra = {}
        k_ms, l_ms = in_turns(lambda: kernel_of(name)(*args), library_of(name, args))
        p_ms = device_ms(lambda: plain_of(name)(*args))
        if name == "dispatch":
            lib = (f"{l_ms:.6f} ms (index_select, timed in turns with the kernel: "
                   f"kernel / library {k_ms / l_ms:.3f})")
        else:
            view = {"grouped_matmul": "", "grouped_matmul_dx": " on the w^T view",
                    "grouped_matmul_dw": " on the x^T view"}[name]
            lib = (f"{l_ms:.6f} ms (torch.bmm{view}, timed in turns with the kernel); "
                   f"{b1_variant(name, args)} variant, {b_ms / k_ms * 100:.1f}% of the "
                   "bound")
        if name == "grouped_matmul_dx":
            # the tiled kernel, which dx ran before the streaming one
            check("grouped_matmul_dx tiled", tiled_dx(*args), plain_of(name)(*args))
            extra["tiled_ms"] = device_ms(lambda: tiled_dx(*args))
        shape = " x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a))
        log(f"time {name}@{site} [{shape}]: kernel {k_ms:.6f} ms, bound {b_ms:.6f} ms "
            f"({b_by}), plain {p_ms:.6f} ms, library {lib}" +
            (f", tiled kernel {extra['tiled_ms']:.6f} ms" if "tiled_ms" in extra else ""))
        timing[(name, site)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                    library_ms=l_ms, shape=shape, **extra)
    timing[("combine", "pair")] = pdl_pair("train", captured["grouped_matmul"][-1][0],
                                           captured["combine"][0][0])
    return errs, timing


def expected_train_launches(cfg, backend: str, dropped_experts: bool = False):
    """Launches per training step: each MoE layer's forward runs twice with
    remat (the forward and its recomputation in the backward)."""
    from repro_torch.training.steps import n_moe_layers
    fwd = n_moe_layers(cfg) * (2 if cfg.remat else 1)
    n = n_moe_layers(cfg)
    zero = {k: 0 for k in ("dispatch", "combine", "grouped_matmul", "grouped_matmul_dx",
                           "grouped_matmul_dw", "fused_moe", "flash_decode",
                           "flash_decode_paged")}
    if dropped_experts:
        return zero
    if backend == "cuda_fused":
        return {**zero, "fused_moe": fwd}
    return {**zero, "dispatch": fwd, "combine": fwd, "grouped_matmul": 2 * fwd,
            "grouped_matmul_dx": 2 * n, "grouped_matmul_dw": 2 * n}


def busy_ms(trace_path: Path):
    """Device busy time (union of kernel, memcpy and memset intervals) and
    the top kernels by device time from a torch.profiler Chrome trace."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans, by_name = [], {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + float(ev["dur"])
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return busy / 1e3, len(spans), [(n[:60], v / 1e3) for n, v in top]


def train_slice(full, dev, backend: str):
    """The slice in the model's own dtype (bf16 activations, f32 params):
    warm-up, TIMED_STEPS timed steps (their drop bits drawn from (seed,
    step): step 2 is a Gate-Drop step), launch counts asserted on a routed,
    a Gate-Drop and a Gate-Expert-Drop step, a CUDA-event split of one step
    and a profiled step. Returns the counts of the routed step."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import generator, spread
    from repro_torch.models import init_model
    from repro_torch.optim.adam import adam_update
    from repro_torch.training import init_train_state, make_train_step, total_loss
    from repro_torch.training.steps import step_generator
    from repro_torch.tree import flatten_with_paths, unflatten_paths

    n_steps = WARMUP_STEPS + TIMED_STEPS + 5
    cfg = train_cfg(full, backend, "bfloat16")
    tc = train_tc(n_steps)
    batches = train_batches(dev, n_steps)
    tokens = sum(int(batches[0][k].numel()) for k in ("tokens", "enc_tokens"))
    state = init_train_state(init_model(generator(dev, SEED, 0), cfg), tc)
    step = make_train_step(cfg, tc)
    it = iter(batches)
    for _ in range(WARMUP_STEPS):
        state, m = step(state, next(it))
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ms, bits = [], []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, next(it))
        loss = float(m["loss"])              # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        bits.append(int(m["gate_dropped"]))
        if not math.isfinite(loss):
            raise AssertionError(f"{backend}: non-finite loss")
    peak = torch.cuda.max_memory_allocated()
    med = sorted(ms)[len(ms) // 2]
    log(f"train {backend} bf16: {TIMED_STEPS} steps (drop bits {bits}), ms/step median "
        f"{med:.2f} {spread(ms)}, {tokens / med * 1e3:.0f} tokens/s ({tokens} encoder + "
        f"decoder tokens per step), peak memory {peak / 2**30:.2f} GiB, last loss {loss:.4f}")

    counts = {}
    for label, run_cfg, dec in (("routed", cfg, False), ("Gate-Drop", cfg, True),
                                ("Gate-Expert-Drop", train_cfg(full, backend, "bfloat16",
                                                               "gate_expert_drop"), True)):
        run = step if run_cfg is cfg else make_train_step(run_cfg, tc)
        reset_launch_counts()
        state, m = run(state, next(it), dec)
        torch.cuda.synchronize()
        got = launch_counts()
        want = expected_train_launches(cfg, backend, label == "Gate-Expert-Drop")
        log(f"train {backend}: launches on a {label} step {got}")
        if got != want:
            raise AssertionError(f"{backend} {label} step launches {got} != {want}")
        check_streamed(f"train {backend} {label} step", got, streamed_counts())
        counts[label] = got
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"{backend}: non-finite loss")

    # one routed step split by CUDA events: forward (loss), backward
    # (gradients), Adam -- make_train_step's body, with events between
    batch = next(it)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    params = state["params"]
    flat = flatten_with_paths(params)
    leaves = list(flat.values())
    torch.cuda.synchronize()
    ev[0].record()
    loss_t, _ = total_loss(params, batch, cfg, decision=False,
                           generator=step_generator(dev, tc.seed, state["step"]))
    ev[1].record()
    grads = torch.autograd.grad(loss_t, leaves, allow_unused=True)
    ev[2].record()
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    _, state["opt"], _ = adam_update(unflatten_paths(dict(zip(flat, grads))), state["opt"],
                                     params, tc)
    ev[3].record()
    torch.cuda.synchronize()
    del grads, loss_t
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    log(f"train {backend} bf16: one routed step by CUDA events: forward {split[0]:.2f} ms, "
        f"backward {split[1]:.2f} ms, Adam {split[2]:.2f} ms")

    # the device's busy time over one profiled routed step
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    profile = {"split_ms": split}
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = step(state, next(it), False)
        torch.cuda.synchronize()
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"train_{backend}_trace.json"
    prof.export_chrome_trace(str(path))
    busy, n_kernels, top = busy_ms(path)
    if n_kernels == 0:
        log(f"train {backend}: torch.profiler traced no device activity; the CUDA-event "
            "split above stands alone")
    else:
        log(f"train {backend} bf16: profiled routed step: {n_kernels} device activities, "
            f"device busy {busy:.2f} ms = {busy / med * 100:.1f}% of the median step "
            f"{med:.2f} ms (idle {max(0.0, 1 - busy / med) * 100:.1f}%); top kernels by "
            "device ms: " + "; ".join(f"{n} {v:.2f}" for n, v in top))
        profile.update(busy_ms=busy, idle=max(0.0, 1 - busy / med))
    del state, step, m
    torch.cuda.empty_cache()
    return counts["routed"], dict(ms=med, all_ms=ms, tokens_s=tokens / med * 1e3,
                                  peak_gib=peak / 2**30, **profile)


# ---------------------------------------------------------------------------
# phase ep: the expert-parallel path under a one-rank group
# ---------------------------------------------------------------------------

EP_STEPS = 3            # steps per run: the drop bits of seed 0 are 0, 0, 1
EP_KEYS = ("loss", "xent", "acc", "grad_norm", "balance", "dropped_frac", "gate_dropped",
           "comm_a2a_calls", "comm_bytes", "comm_wire_bytes", "comm_exposed_bytes",
           "comm_hidden_bytes")
EP_EXACT = ("dense", "hierarchical", "overlapped")      # bitwise the ungrouped step
EP_COMPRESSED = ("compressed", "compressed_fp8")       # within phase 6's tolerance
EP_TIMED_ROUNDS = 5


def ep_cfg(full, backend: str, dtype: str, substrate: str = "dense",
           mode: str = "gate_drop"):
    """``train_cfg`` on the comm ``substrate`` ("compressed_fp8": the
    compressed substrate with an fp8 wire)."""
    cfg = train_cfg(full, backend, dtype, mode)
    comm = dataclasses.replace(cfg.moe.comm, substrate=substrate.removesuffix("_fp8"),
                               quant="fp8" if substrate.endswith("_fp8") else "int8")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, comm=comm))


def fingerprint(params) -> torch.Tensor:
    """Per leaf, the int64 sum of its 32-bit words: equal for bitwise-equal
    leaves, and an order-free reduction, so it is the same on every run."""
    from repro_torch.tree import flatten_with_paths
    return torch.stack([p.detach().contiguous().view(torch.int32).sum(dtype=torch.int64)
                        for p in flatten_with_paths(params).values()]).cpu()


def ep_run(full, dev, cfg, ctx, keep_params: bool = False):
    """EP_STEPS steps from the seeded init on ``cfg``, under ``ctx`` (None:
    ungrouped). Returns (per-step metrics, fingerprint, params or None,
    the transport's collective calls)."""
    from repro_torch.comm import COUNTER
    from repro_torch.launch.serve import generator
    from repro_torch.models import init_model
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.tree import flatten_with_paths
    tc = train_tc(EP_STEPS)
    batches = train_batches(dev, EP_STEPS)
    state = init_train_state(init_model(generator(dev, SEED, 0), cfg), tc)
    step = make_train_step(cfg, tc, ctx)
    COUNTER.reset()
    rows = []
    for batch in batches:
        state, m = step(state, batch)
        rows.append({k: float(m[k]) for k in EP_KEYS})
    torch.cuda.synchronize()
    fp = fingerprint(state["params"])
    params = ({k: v.detach() for k, v in flatten_with_paths(state["params"]).items()}
              if keep_params else None)
    calls = COUNTER.total_calls()
    del state, step, batches
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"ep: non-finite training metrics {rows}")
    return rows, fp, params, calls


def ep_f32(full, dev, ctx):
    """f32: the dense, hierarchical and overlapped wires under the group,
    bitwise the ungrouped cuda steps; the compressed wires (int8, fp8)
    under the group against the plain oracle under the same substrate,
    within phase 6's tolerance. No collective, and comm_* reads 0."""
    ref, ref_fp, _, _ = ep_run(full, dev, ep_cfg(full, "cuda", "float32"), None)
    log(f"ep f32 ungrouped cuda: " + "; ".join(
        f"loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f} dropped {int(r['gate_dropped'])}"
        for r in ref))
    if [r["gate_dropped"] for r in ref] != [0.0, 0.0, 1.0]:
        raise AssertionError("ep: the steps must be routed, routed, Gate-Drop")
    out = {}
    for sub in EP_EXACT:
        rows, fp, _, calls = ep_run(full, dev, ep_cfg(full, "cuda", "float32", sub), ctx)
        bitwise = rows == ref and torch.equal(fp, ref_fp)
        log(f"ep f32 grouped cuda {sub}: {EP_STEPS} steps bitwise the ungrouped ones: "
            f"{bitwise}; collectives {calls}; comm_a2a_calls per step "
            f"{[r['comm_a2a_calls'] for r in rows]}")
        if not bitwise:
            diff = {k: [(a[k], b[k]) for a, b in zip(rows, ref) if a[k] != b[k]] for k in EP_KEYS}
            raise AssertionError(f"ep {sub}: grouped steps differ from the ungrouped: "
                                 f"{ {k: v for k, v in diff.items() if v} }, leaves differing "
                                 f"{int((fp != ref_fp).sum())}")
        if calls or any(r[k] for r in rows for k in EP_KEYS if k.startswith("comm_")):
            raise AssertionError(f"ep {sub}: collectives or wire bytes at ep = 1")
        out[sub] = {"bitwise": bitwise, "collectives": calls}
    tc = train_tc(EP_STEPS)
    param_tol = adam_drift_bound(tc, EP_STEPS)
    for sub in EP_COMPRESSED:
        want, _, want_p, _ = ep_run(full, dev, ep_cfg(full, "oracle", "float32", sub), None,
                                    keep_params=True)
        rows, _, got_p, calls = ep_run(full, dev, ep_cfg(full, "cuda", "float32", sub), ctx,
                                       keep_params=True)
        worst = {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for a, b in zip(rows, want))
                 for k in ("loss", "grad_norm", "balance")}
        diffs = torch.stack([(got_p[k] - want_p[k]).abs().max() for k in got_p])
        pmax = float(diffs.max())
        del got_p, want_p
        torch.cuda.empty_cache()
        log(f"ep f32 grouped cuda {sub} vs the plain oracle on {sub}: max relative diff "
            f"per step {', '.join(f'{k} {v:.3e}' for k, v in worst.items())} (tol "
            f"{TRAIN_METRIC_RTOL}); parameters max abs diff {pmax:.3e} (tol "
            f"{param_tol:.3e}); collectives {calls}")
        if max(worst.values()) > TRAIN_METRIC_RTOL or pmax > param_tol or calls:
            raise AssertionError(f"ep {sub}: the grouped compressed steps differ from the "
                                 "plain oracle, or issued collectives")
        out[sub] = {"max_rel_diff": worst, "param_max_abs_diff": pmax, "collectives": calls}
    return out


def ep_bf16(full, dev, ctx):
    """bf16 (the model's dtype): per substrate, the launches of a routed, a
    Gate-Drop and a Gate-Expert-Drop step under the group equal phase 6's
    cuda counts (every B1 launch streaming), no collective; cuda_fused
    under the group launches B2/B1/B3 and no B4; the grouped dense steps
    bitwise the ungrouped; grouped and ungrouped steps timed in turns."""
    from repro_torch.comm import COUNTER
    from repro_torch.core.backend import fused_runs_pipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import generator, spread
    from repro_torch.models import init_model
    from repro_torch.training import init_train_state, make_train_step
    ref, ref_fp, _, _ = ep_run(full, dev, ep_cfg(full, "cuda", "bfloat16"), None)
    rows, fp, _, _ = ep_run(full, dev, ep_cfg(full, "cuda", "bfloat16"), ctx)
    bitwise = rows == ref and torch.equal(fp, ref_fp)
    log(f"ep bf16 grouped cuda dense: {EP_STEPS} steps bitwise the ungrouped ones: {bitwise}")
    if not bitwise:
        raise AssertionError("ep bf16: grouped dense steps differ from the ungrouped ones")

    n_steps = 3 * (len(EP_EXACT) + len(EP_COMPRESSED)) + 1 + 4 * EP_TIMED_ROUNDS + 2
    cfg = ep_cfg(full, "cuda", "bfloat16")
    tc = train_tc(n_steps)
    batches = iter(train_batches(dev, n_steps))
    state = init_train_state(init_model(generator(dev, SEED, 0), cfg), tc)
    counts = {}
    for sub in EP_EXACT + EP_COMPRESSED:
        for label, mode, dec in (("routed", "gate_drop", False), ("Gate-Drop", "gate_drop", True),
                                 ("Gate-Expert-Drop", "gate_expert_drop", True)):
            run_cfg = ep_cfg(full, "cuda", "bfloat16", sub, mode)
            step = make_train_step(run_cfg, tc, ctx)
            reset_launch_counts()
            COUNTER.reset()
            state, m = step(state, next(batches), dec)
            torch.cuda.synchronize()
            got = launch_counts()
            want = expected_train_launches(cfg, "cuda", label == "Gate-Expert-Drop")
            if got != want or COUNTER.total_calls() or float(m["comm_a2a_calls"]):
                raise AssertionError(f"ep {sub} {label}: launches {got} != {want}, or "
                                     f"{COUNTER.total_calls()} collectives")
            check_streamed(f"ep {sub} {label} step", got, streamed_counts())
            if not math.isfinite(float(m["loss"])):
                raise AssertionError(f"ep {sub} {label}: non-finite loss")
            counts[f"{sub}/{label}"] = got
        log(f"ep bf16 {sub}: launches per routed, Gate-Drop and Gate-Expert-Drop step equal "
            f"phase 6's cuda counts {counts[sub + '/routed']}, "
            f"{counts[sub + '/Gate-Expert-Drop']}; no collective")
    fused = ep_cfg(full, "cuda_fused", "bfloat16")
    if not fused_runs_pipeline(fused.moe, ctx):
        raise AssertionError("ep: cuda_fused under the group must run the pipeline")
    reset_launch_counts()
    state, m = make_train_step(fused, tc, ctx)(state, next(batches), False)
    torch.cuda.synchronize()
    got = launch_counts()
    want = expected_train_launches(cfg, "cuda")
    log(f"ep bf16 cuda_fused under the group: launches on a routed step {got}")
    if got != want or got["fused_moe"]:
        raise AssertionError(f"ep: cuda_fused under the group launched {got}, not {want}")
    counts["cuda_fused/routed"] = got

    # the grouped step against the ungrouped one, in turns (u, g, g, u)
    steps = {"ungrouped": make_train_step(cfg, tc), "grouped": make_train_step(cfg, tc, ctx)}
    for name in ("ungrouped", "grouped"):      # one warm step each
        state, m = steps[name](state, next(batches), False)
    ms = {"ungrouped": [], "grouped": []}
    for _ in range(EP_TIMED_ROUNDS):
        for name in ("ungrouped", "grouped", "grouped", "ungrouped"):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = steps[name](state, batch, False)
            float(m["loss"])                     # waits for the step
            ms[name].append((time.perf_counter() - t0) * 1e3)
    timing = {name: sorted(v)[len(v) // 2] for name, v in ms.items()}
    log(f"ep bf16 routed step in turns ({2 * EP_TIMED_ROUNDS} each), ms median [min, max]: "
        f"ungrouped {timing['ungrouped']:.2f} {spread(ms['ungrouped'])}, grouped "
        f"{timing['grouped']:.2f} {spread(ms['grouped'])}")
    del state, steps, batches, m
    torch.cuda.empty_cache()
    return {"bitwise_bf16": bitwise, "launches": counts, "step_ms": timing, "step_ms_all": ms}


def ep_roundtrip(full, dev, ctx):
    """Device time of the compressed wire per MoE layer at ep = 1 (the
    dispatch and the combine wires, each a quantize -> dequantize), at
    the bf16 training site's (E, C, d) buffer, in a CUDA graph."""
    from repro_torch.comm import make_transport
    from repro_torch.core import router as R
    E, d = full.moe.n_experts, full.d_model
    tokens = TRAIN_BATCH * TRAIN_SEQ
    cap = min(R.capacity(tokens, E, full.moe.top_k, full.moe.capacity_factor), tokens)
    buf = torch.randn(E, cap, d, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5)).to(torch.bfloat16)
    out = {}
    with torch.no_grad():
        for sub in EP_COMPRESSED:
            moe = ep_cfg(full, "cuda", "bfloat16", sub).moe
            tr = make_transport(moe.comm, ctx.comm_env(moe.comm))
            y = tr.combine(tr.dispatch(buf))
            err = float((y.float() - buf.float()).abs().max())
            t = device_ms(lambda: tr.combine(tr.dispatch(buf)))
            # the least a round trip must move: read the buffer, write it back
            nbytes = 2 * 2 * buf.numel() * buf.element_size()
            out[sub] = {"ms_per_layer": t, "shape": [E, cap, d], "max_abs_err": err,
                        "bytes_per_layer": nbytes,
                        "bound_ms": nbytes / PEAK_BYTES_S * 1e3}
            log(f"ep compressed wire {sub} at (E, C, d) = ({E}, {cap}, {d}) bf16: "
                f"{t:.4f} ms per layer (the dispatch and the combine wire, each a "
                f"quantize -> dequantize; bytes bound {out[sub]['bound_ms']:.4f} ms), "
                f"max abs error {err:.3e}")
    return out


def ep_eval(full, dev, ctx):
    """greedy_bleu at full width through Trainer(eval_every=1) under the
    group (bf16, the cuda backend): BLEU, the eval's wall time, and the
    scored tokens gated equal to generate's for the same batch."""
    from repro_torch.data import MTTaskConfig, MultilingualMT
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import greedy_bleu
    from repro_torch.serve import GenerateConfig, generate
    from repro_torch.training import Trainer
    cfg = ep_cfg(full, "cuda", "bfloat16")
    task = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=TRAIN_LANGS, max_len=TRAIN_SEQ))
    evals = []

    def eval_fn(state, step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bleu, tokens = greedy_bleu(state["params"], cfg, task, ctx=ctx, device=dev,
                                   return_tokens=True)
        wall = time.perf_counter() - t0
        b = task.sample_batch(10_000, 32)
        res = generate(state["params"],
                       {"enc_tokens": torch.from_numpy(b["enc_tokens"]).to(dev),
                        "tokens": torch.from_numpy(b["tokens"][:, :1]).to(dev)},
                       cfg, GenerateConfig(max_new=36), ctx=ctx)
        same = torch.equal(tokens, res.tokens)
        evals.append({"step": step, "bleu": bleu, "eval_s": wall, "tokens_equal": same,
                      "decode_steps": res.steps})
        if not same or not 0.0 <= bleu <= 100.0:
            raise AssertionError(f"ep eval at step {step}: tokens equal {same}, bleu {bleu}")
        return {"bleu": bleu, "eval_s": wall}

    trainer = Trainer(cfg, train_tc(2), task.train_batches(TRAIN_BATCH), device=dev, ctx=ctx,
                      chunk=2, eval_every=1, eval_fn=eval_fn, log_every=1, log=None)
    reset_launch_counts()
    _, history = trainer.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    del trainer
    torch.cuda.empty_cache()
    for e in evals:
        log(f"ep eval (Trainer eval_every=1, greedy_bleu n=32 max_new=36 at full width, "
            f"bf16, under the group) after step {e['step']}: BLEU {e['bleu']:.6g}, eval wall "
            f"{e['eval_s']:.2f} s ({e['decode_steps']} decode steps), scored tokens equal "
            f"generate's: {e['tokens_equal']}")
    log(f"ep eval: launches over the 2-step run and its evals {counts}; records "
        f"{[{k: r[k] for k in ('step', 'loss', 'bleu')} for r in history]}")
    if not all(counts[k] for k in ("dispatch", "combine", "grouped_matmul")):
        raise AssertionError(f"ep eval: the kernels were not launched: {counts}")
    return {"evals": evals, "launches": counts}


def ep_phase(full, dev):
    """Phase ep: the expert-parallel code path at ep = 1 under a one-rank
    NCCL group (launch/mesh.py::make_group), on phase 6's seeded
    full-width zcode-m3-base: f32 and bf16 training on five wires, the
    compressed wire's time per layer, the BLEU eval through the Trainer."""
    from repro_torch.launch.mesh import close_group, make_group
    OUT.mkdir(parents=True, exist_ok=True)
    rdv = OUT / "ep_rendezvous"
    rdv.unlink(missing_ok=True)
    ctx = make_group(1, dev, init_method=f"file://{rdv}", rank=0, world_size=1)
    try:
        if not (ctx.active and ctx.ep == 1):
            raise AssertionError("ep: the one-rank group is not active")
        t0 = time.perf_counter()
        out = {"f32": ep_f32(full, dev, ctx)}
        out["bf16"] = ep_bf16(full, dev, ctx)
        out["compressed_wire"] = ep_roundtrip(full, dev, ctx)
        out["eval"] = ep_eval(full, dev, ctx)
        log(f"ep phase: {time.perf_counter() - t0:.1f} s")
    finally:
        close_group()
        rdv.unlink(missing_ok=True)
    return out


# ---------------------------------------------------------------------------
# phase 7: the serving schedulers and B6
# ---------------------------------------------------------------------------

def sched_trace(vocab: int):
    """TRACE_N requests queued at t = 0, drawn from seed SEED + 7: budgets
    uniform over [2, TRACE_BUDGET], SRC_TOKENS source tokens each. Odd
    requests: prompts uniform over [2, TRACE_PROMPT] tokens. Even requests
    (half) share one TRACE_PREFIX-token prompt prefix (two full pages at
    PAGE_SIZE 16) and one source sentence, with a tail uniform over [1,
    TRACE_PROMPT - TRACE_PREFIX] tokens: a page is shared only under an
    equal source (every decoder layer after the first reads it)."""
    import numpy as np
    from repro_torch.launch.serve import SRC_TOKENS
    from repro_torch.serve import Request
    rs = np.random.RandomState(SEED + 7)
    prefix = rs.randint(3, vocab, TRACE_PREFIX)
    shared_src = rs.randint(3, vocab, SRC_TOKENS)
    reqs = []
    for i in range(TRACE_N):
        budget = int(rs.randint(2, TRACE_BUDGET + 1))
        if i % 2 == 0:
            tail = rs.randint(3, vocab, int(rs.randint(1, TRACE_PROMPT - TRACE_PREFIX + 1)))
            toks, src = np.concatenate([prefix, tail]), shared_src
        else:
            toks = rs.randint(3, vocab, int(rs.randint(2, TRACE_PROMPT + 1)))
            src = rs.randint(3, vocab, SRC_TOKENS)
        reqs.append(Request(rid=i, tokens=toks.astype(np.int64),
                            extras={"enc_tokens": src.astype(np.int64)},
                            max_new=budget, arrival=0.0))
    return reqs


def run_scheduler(params, cfg, gen, reqs, paged=None, n_pages=0, tracer=None):
    """Serve ``reqs`` through a fresh scheduler (the slot pool, or the page
    arena when ``paged``), with the launch counts reset just before and
    read just after. Returns ({rid: tokens}, scheduler, launch counts,
    wall seconds)."""
    import dataclasses as dc
    from repro_torch.configs import PagedKVConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import ContinuousScheduler, PagedScheduler
    kw = dict(n_slots=SCHED_SLOTS, prefill_buckets=SCHED_BUCKETS, admit_width=SCHED_ADMIT,
              registry=MetricsRegistry(), tracer=tracer)
    if paged:
        sched = PagedScheduler(params, cfg, gen, paged=PagedKVConfig(
            page_size=PAGE_SIZE, n_slots_equiv=SCHED_SLOTS, n_pages=n_pages), **kw)
    else:
        sched = ContinuousScheduler(params, cfg, gen, **kw)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sched.run([dc.replace(r) for r in reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {r.rid: r.tokens for r in res}, sched, launch_counts(), wall


def streamed_counts():
    """Launches that took the streaming kernel: B1's forward, dx, dw, B4."""
    from repro_torch.kernels import moe_megakernel, streaming_counts
    return {**streaming_counts(), "fused_moe": moe_megakernel.fused_moe.launches_streaming}


def check_streamed(label, counts, streamed):
    """Every launch of B1's forward, dx and dw and of B4 in a main-path run
    took the streaming kernel."""
    log(f"{label}: B1 and B4 launches on the streaming kernel {streamed} of "
        f"{ {k: counts[k] for k in STREAMED} }")
    if any(streamed[k] != counts[k] for k in STREAMED):
        raise AssertionError(f"{label}: launches {counts} not all streaming: {streamed}")


def expected_sched_launches(cfg, stats, paged: bool):
    """Launches of a scheduler run: per admission group the encoder's and
    decoder's MoE layers, per decode tick the decoder's MoE layers and one
    flash decode per decoder layer (B6 on the page arena, B5 on the slot
    pool)."""
    n_dec = sum(cfg.moe.is_moe_layer(i) for i in range(cfg.n_layers))
    n_enc = sum(cfg.moe.is_moe_layer(i) for i in range(cfg.encdec.n_encoder_layers))
    moe = (n_enc + n_dec) * stats["prefill_calls"] + n_dec * stats["decode_steps"]
    attn = cfg.n_layers * stats["decode_steps"]
    return {"dispatch": moe, "combine": moe, "grouped_matmul": 2 * moe,
            "grouped_matmul_dx": 0, "grouped_matmul_dw": 0, "fused_moe": 0,
            "flash_decode": 0 if paged else attn, "flash_decode_paged": attn if paged else 0}


def check_launches(label, cfg, sched, counts, paged: bool):
    """Launch counts of a scheduler run; at the config's capacity (not the
    f32 parity runs' capacity E, where an admission's C is its token count,
    up to 256 rows) every B1 forward launch must be streaming."""
    want = expected_sched_launches(cfg, sched.stats, paged)
    log(f"sched {label}: launches {counts} over {sched.stats['prefill_calls']} admissions "
        f"and {sched.stats['decode_steps']} decode ticks")
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} != {want}")
    if cfg.moe.eval_capacity_factor < cfg.moe.n_experts:
        check_streamed(f"sched {label}", counts, streamed_counts())
    else:
        log(f"sched {label}: B1 launches on the streaming kernel {streamed_counts()} "
            f"(capacity {cfg.moe.eval_capacity_factor}: admissions of more than 16 tokens "
            "take the tiled kernel)")


def oneshot_check(params, cfg, gen, reqs, want, max_seq, dev):
    """Each request's tokens against one-shot B=1 ``generate`` at the
    pool's cache length. A divergence must be a near-tie: the top-two gap
    of the one-shot logits at the first differing token, read by feeding
    the common prefix, is under NEAR_TIE. Returns (#equal, gaps)."""
    import dataclasses as dc
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import generate
    n_equal, gaps = 0, []
    for r in reqs:
        batch = {"tokens": torch.as_tensor(r.tokens[None], device=dev),
                 "enc_tokens": torch.as_tensor(r.extras["enc_tokens"][None], device=dev)}
        one = generate(params, batch, cfg, dc.replace(gen, max_new=r.max_new,
                                                       max_seq=max_seq))
        got = one.tokens[0].cpu().numpy()
        if (got == want[r.rid]).all():
            n_equal += 1
            continue
        t = int((got != want[r.rid]).argmax())
        with torch.no_grad():
            lg, caches = prefill(params, batch, cfg, max_seq=max_seq)
            for i in range(t):
                lg, caches = decode_step(params, caches,
                                         torch.as_tensor([[int(got[i])]], device=dev),
                                         len(r.tokens) + i, cfg, flash_decode=True)
        top = lg[0, -1].float().topk(2).values
        gaps.append((r.rid, t, float(top[0] - top[1])))
    return n_equal, gaps


def paged_ragged_cases(dev):
    """(args, gathered contiguous k, v) of B6 off the main path: page sizes
    1, 8, 16, 17; query heads per kv head 1, 2, 8; head dims 32, 64, 128;
    index 0 and the last slot of the last page; rows 0 and 1 sharing a
    physical page; tables pointing at the scratch page (filled with large
    values) past each row's index; nb = 1 and B = 1; several splits (pages
    of 1 over the full cache, pages of 17 across a split's edge); f32, bf16
    cache, bf16."""
    g = torch.Generator().manual_seed(4323)
    cases = []
    for qdt, kvdt in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                      (torch.bfloat16, torch.bfloat16)):
        for b, h, kv, hd, ps, nb in ((8, 8, 8, 64, 16, 6), (3, 8, 4, 32, 1, 40),
                                     (4, 8, 1, 128, 8, 5), (2, 16, 2, 64, 17, 3),
                                     (1, 8, 8, 64, 16, 1), (5, 8, 8, 64, 16, 6),
                                     (4, 8, 8, 64, 1, FULL_SEQ), (4, 8, 2, 64, 17, 16)):
            n_pages = b * nb + 3
            tables = torch.randperm(n_pages, generator=g)[:b * nb].reshape(b, nb).to(torch.int32)
            if b > 1:
                tables[1, 0] = tables[0, 0]
            index = torch.randint(0, nb * ps, (b,), generator=g)
            index[0] = 0
            index[-1] = nb * ps - 1
            for r in range(b):
                tables[r, int(index[r]) // ps + 1:] = n_pages
            ka = torch.randn(n_pages + 1, ps, kv, hd, generator=g)
            va = torch.randn(n_pages + 1, ps, kv, hd, generator=g)
            ka[n_pages], va[n_pages] = 1e4, -1e4
            q = torch.randn(b, h, hd, generator=g)
            args = (q.to(dev, qdt), ka.to(dev, kvdt), va.to(dev, kvdt),
                    tables.to(dev), index.to(dev))
            cases.append((args, *gathered(args)))
    return cases


def gathered(args):
    """The contiguous (B, nb * ps, KV, hd) cache the block tables address."""
    q, k, v, bt, _ = args
    b, nb, ps = q.shape[0], bt.shape[1], k.shape[1]
    flat = bt.long().reshape(-1)
    return (k.index_select(0, flat).reshape(b, nb * ps, *k.shape[2:]).contiguous(),
            v.index_select(0, flat).reshape(b, nb * ps, *v.shape[2:]).contiguous())


def b6_checks(main_calls, dev):
    """B6 against its plain version at the main path's captured inputs
    and the ragged cases, and bitwise against B5 on the gathered cache.
    Returns the max abs err over the main path's inputs."""
    from repro_torch.kernels import flash_decode as FD
    err = 0.0
    for args in main_calls:
        out = FD.flash_decode_paged(*args)
        torch.cuda.synchronize()
        err = max(err, check("flash_decode_paged", out, plain_of("flash_decode_paged")(*args)))
        check("flash_decode_paged vs B5", out, FD.flash_decode(args[0], *gathered(args),
                                                               args[4]), exact=True)
    shapes = [" x ".join(str(tuple(a.shape)) for a in args) for args in main_calls]
    log(f"kernel flash_decode_paged: main-path inputs {shapes} ({[str(a[1].dtype) for a in main_calls]} "
        f"arena), max abs err {err:.3e}, bitwise equal to flash_decode on the gathered cache")
    cases = paged_ragged_cases(dev)
    for args, gk, gv in cases:
        out = FD.flash_decode_paged(*args)
        torch.cuda.synchronize()
        check("flash_decode_paged ragged", out, plain_of("flash_decode_paged")(*args))
        check("flash_decode_paged ragged vs B5", out, FD.flash_decode(args[0], gk, gv, args[4]),
              exact=True)
    log(f"kernel flash_decode_paged: {len(cases)} ragged cases agree with the plain version "
        "and equal flash_decode bitwise (page sizes 1/8/16/17, rep 1/2/8, head dims "
        "32/64/128, index 0 and the last slot, a shared page, scratch past the index, "
        "nb = 1, B = 1, several splits; f32, bf16 cache, bf16)")
    return err


def b6_timing(args):
    """B6 at the main path's decode inputs: device ms against the bytes of
    the live positions over HBM's rate, the plain version, and the library's
    index_select of the pages + SDPA (two calls, in turns with the
    kernel)."""
    from repro_torch.kernels import flash_decode as FD
    idx = args[4]
    nbytes, flops, wdt = work("flash_decode_paged", args)
    b_ms, b_by = bound(nbytes, flops, wdt)
    k_ms, l_ms = in_turns(lambda: FD.flash_decode_paged(*args),
                          library_of("flash_decode_paged", args))
    t = dict(ms=k_ms, plain_ms=device_ms(lambda: plain_of("flash_decode_paged")(*args)),
             bound_ms=b_ms, bound_by=b_by, library_ms=l_ms, n_split=n_split_of(args),
             shape=" x ".join(str(tuple(a.shape)) for a in args))
    log(f"time flash_decode_paged@decode [{t['shape']}, {int((idx.long() + 1).sum())} "
        f"live positions, {nbytes} bytes, n_split {t['n_split']}]: kernel {t['ms']:.6f} ms, "
        f"bound {b_ms:.6f} ms ({b_by}), plain {t['plain_ms']:.6f} ms, library (index_select "
        f"+ SDPA, two calls, timed in turns with the kernel) {t['library_ms']:.6f} ms")
    return t


def sched_parity(params, cfg, reqs, dev):
    """f32 at non-binding capacity: slot pool with B5, page arena with B6,
    a small arena that preempts; tokens equal across all three, and against
    one-shot B=1 up to near-ties. Returns the B6 inputs captured at the
    first paged decode tick."""
    from repro_torch.serve import GenerateConfig
    cfg32 = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, eval_capacity_factor=float(cfg.moe.n_experts)))
    gen = GenerateConfig(max_new=TRACE_BUDGET, eos_id=-1, flash_decode=True)
    slot, ss, c_slot, w_slot = run_scheduler(params, cfg32, gen, reqs)
    check_launches("slot pool f32", cfg32, ss, c_slot, paged=False)
    with Capture(names=("flash_decode_paged",)) as cap:
        paged, ps, c_paged, w_paged = run_scheduler(params, cfg32, gen, reqs, paged=True)
    check_launches("paged f32", cfg32, ps, c_paged, paged=True)
    small, sm, c_small, _ = run_scheduler(params, cfg32, gen, reqs, paged=True,
                                          n_pages=PAGES_SMALL)
    check_launches(f"paged f32 {PAGES_SMALL} pages", cfg32, sm, c_small, paged=True)
    log(f"sched f32: slot pool {ss.stats} in {w_slot:.2f} s; paged {ps.stats} in "
        f"{w_paged:.2f} s; {PAGES_SMALL}-page arena {sm.stats}")
    bad = [r.rid for r in reqs if not ((paged[r.rid] == slot[r.rid]).all()
                                       and (small[r.rid] == slot[r.rid]).all())]
    if bad:
        raise AssertionError(f"paged and slot-pool tokens differ for requests {bad}")
    if not (sm.stats["preemptions"] > 0 and sm.stats["swap_ins"] == sm.stats["preemptions"]):
        raise AssertionError(f"the {PAGES_SMALL}-page arena did not preempt and swap in: "
                             f"{sm.stats}")
    if ps.stats["prefix_hits"] == 0 or ps.stats["finished"] != TRACE_N:
        raise AssertionError(f"paged run: {ps.stats}")
    log(f"sched f32: per-request tokens of the {TRACE_N} requests equal across the slot pool "
        f"(B5), the page arena (B6) and the {PAGES_SMALL}-page arena "
        f"({sm.stats['preemptions']} preemptions, {sm.stats['swap_ins']} swap-ins)")
    n_equal, gaps = oneshot_check(params, cfg32, gen, reqs, slot, ss.max_seq, dev)
    log(f"sched f32: one-shot B=1 generate at max_seq {ss.max_seq}: {n_equal} of {TRACE_N} "
        f"requests equal; divergences (rid, first token, top-two logit gap): {gaps}")
    if any(gap >= NEAR_TIE for _, _, gap in gaps):
        raise AssertionError(f"a divergence from one-shot is not a near-tie: {gaps}")
    return [a for a, _ in cap.calls["flash_decode_paged"][:1]]


def tick_calls(params, cfg, gen, reqs, paged: bool) -> float:
    """A replay whose decode ticks run under ``CallCount``: the PyTorch
    calls from Python per decode tick (the host's dispatch work)."""
    from repro_torch.serve import ContinuousScheduler
    cc = CallCount()
    orig = ContinuousScheduler._decode_tick        # the paged scheduler's too

    def counted(self):
        with cc:
            orig(self)

    ContinuousScheduler._decode_tick = counted
    try:
        _, sched, _, _ = run_scheduler(params, cfg, gen, reqs, paged=paged)
    finally:
        ContinuousScheduler._decode_tick = orig
    return cc.n / sched.stats["decode_steps"]


def sched_timing(params, cfg, reqs, dev):
    """bf16 at the config's capacity: one warm-up replay per scheduler (its
    decode ticks' PyTorch calls counted), then TIMED_REPLAYS timed replays
    of each, taken in turns (slot, paged, paged, slot, ...) so that drift of
    the host's speed within the call falls on both; each replay on a fresh
    scheduler. Returns (B6 inputs captured at the first paged tick, B6
    launches of the first timed paged replay)."""
    import statistics
    from repro_torch.launch.serve import spread
    from repro_torch.obs import Tracer
    from repro_torch.serve import GenerateConfig, paged_kv_bytes
    gen = GenerateConfig(max_new=TRACE_BUDGET, eos_id=-1, flash_decode=True)
    label = {False: "slot pool (B5)", True: "paged (B6)"}
    calls = {paged: tick_calls(params, cfg, gen, reqs, paged) for paged in (False, True)}
    torch.cuda.reset_peak_memory_stats()
    rows, last = {False: [], True: []}, {}
    captured, launches = [], None
    for i in range(TIMED_REPLAYS):
        for paged in ((False, True) if i % 2 == 0 else (True, False)):
            first_paged = paged and not rows[True]
            tracer = Tracer(enabled=True)
            cap = Capture(names=("flash_decode_paged",))
            with cap if first_paged else contextlib.nullcontext():
                out, sched, counts, wall = run_scheduler(params, cfg, gen, reqs, paged=paged,
                                                         tracer=tracer)
            check_launches(f"{label[paged]} bf16 replay {i}", cfg, sched, counts, paged)
            if first_paged:
                captured = [a for a, _ in cap.calls["flash_decode_paged"][:1]]
                launches = counts["flash_decode_paged"]
            ttft = sched.metrics.histogram("serve/ttft_s").percentiles((50, 90))
            lat = sched.metrics.histogram("serve/per_token_latency_s").percentiles((50, 90))
            rows[paged].append(dict(
                tok_s=sum(len(t) for t in out.values()) / wall, wall_s=wall,
                ttft_p50_ms=ttft[50] * 1e3, ttft_p90_ms=ttft[90] * 1e3,
                tpot_p50_ms=lat[50] * 1e3, tpot_p90_ms=lat[90] * 1e3,
                decode_tick_ms=statistics.median(tracer.durations("sched.decode")) * 1e3,
                prefill_ms=statistics.median(tracer.durations("sched.prefill")) * 1e3))
            last[paged] = sched
    peak = torch.cuda.max_memory_allocated()
    for paged in (False, True):
        sched, st = last[paged], last[paged].stats
        med = {k: statistics.median(r[k] for r in rows[paged]) for k in rows[paged][0]}
        log(f"sched {label[paged]} bf16, capacity {cfg.moe.eval_capacity_factor}, median "
            f"[min, max] of {TIMED_REPLAYS} replays of {TRACE_N} requests (in turns): "
            + ", ".join(f"{k} {med[k]:.2f} {spread([r[k] for r in rows[paged]])}" for k in med)
            + f"; {calls[paged]:.0f} PyTorch calls from Python per decode tick; self-attention "
            f"KV {paged_kv_bytes(sched.pool, cfg) / 2**20:.2f} MiB; {st['decode_steps']} ticks, "
            f"{st['prefill_calls']} admissions"
            + (f", prefix hit rate {st['prefix_hits'] / max(st['prefix_lookups'], 1):.3f}, "
               f"{st['cow_copies']} COW copies, {st['preemptions']} preemptions, peak "
               f"{st['peak_pages_in_use']} of {sched.layout.n_pages} pages" if paged else ""))
    log(f"sched bf16: peak memory over the timed replays {peak / 2**30:.2f} GiB")
    return captured, launches


def beam_phase(params, batch, cfg, dev):
    """One beam-4 ``generate`` for the phase-4 prompts, timed (host clock
    around a warm call), with B5's launches asserted."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import GenerateConfig, generate
    gen = GenerateConfig(max_new=MAX_NEW, eos_id=-1, beam_width=4, flash_decode=True)
    generate(params, batch, cfg, gen)                                       # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = generate(params, batch, cfg, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    if (counts["flash_decode"] != cfg.n_layers * res.steps or counts["flash_decode_paged"]
            or res.tokens.shape != (BATCH, MAX_NEW) or not torch.isfinite(res.scores).all()):
        raise AssertionError(f"beam: launches {counts}, {res.steps} steps, tokens "
                             f"{tuple(res.tokens.shape)}, scores {res.scores.tolist()}")
    log(f"beam 4 bf16: {BATCH} x {PROMPT} prompts, {res.steps} decode steps in {ms:.2f} ms "
        f"({BATCH * MAX_NEW / ms * 1e3:.0f} tokens/s of best hypotheses); flash_decode "
        f"launches {counts['flash_decode']} = {cfg.n_layers} layers x {res.steps} steps; "
        f"first row {res.tokens[0].tolist()}, scores {[round(x, 3) for x in res.scores.tolist()]}")


def sched_phase(params, batch, cfg, dev):
    """Phase 7. Returns (B6 max abs err, B6 timing, B6 launches)."""
    reqs = sched_trace(cfg.vocab)
    lens = [len(r.tokens) for r in reqs]
    log(f"sched trace: {TRACE_N} requests at t = 0, prompts {min(lens)}-{max(lens)} tokens, "
        f"budgets {min(r.max_new for r in reqs)}-{max(r.max_new for r in reqs)}, "
        f"{TRACE_N // 2} sharing a {TRACE_PREFIX}-token prefix and a source")
    main_f32 = sched_parity(params, cfg, reqs, dev)
    main_bf16, launches = sched_timing(params, cfg, reqs, dev)
    err = b6_checks(main_f32 + main_bf16, dev)
    timing = b6_timing(main_bf16[0])
    beam_phase(params, batch, cfg, dev)
    return err, timing, launches


# ---------------------------------------------------------------------------
# phase 8: B5 and B6 at the full cache
# ---------------------------------------------------------------------------

def n_split_of(args):
    """Blocks per (row, kv head) over the cache that the wrapper's split
    plan gives these B5 (4 args) or B6 (5 args) inputs."""
    from repro_torch.kernels import flash_decode as FD
    return FD.plan_of(args[0], args[1], args[3] if len(args) == 5 else None)[0]


def full_cache_cases(cfg, dev):
    """N_COLD B5 inputs (q, k, v, index) and N_COLD B6 inputs (q, arena k,
    arena v, tables, index) at zcode-m3-base's widths and full cache: q (8,
    8, 64) f32 against k/v (8, 1024, 8, 64) bf16, every row at position
    1,023; B6's arena (8 * 64 + 1, 16, 8, 64) bf16 addressed by tables
    holding a seeded permutation of the pages (a server's arena after it
    has run a while). Each input has a cache of its own."""
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    b, h, kv, hd = BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    nb = FULL_SEQ // PAGE_SIZE
    idx = torch.full((b,), FULL_SEQ - 1, dtype=torch.int32, device=dev)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    b5, b6 = [], []
    for _ in range(N_COLD):
        q = rn(b, h, hd)
        b5.append((q, rn(b, FULL_SEQ, kv, hd).bfloat16(), rn(b, FULL_SEQ, kv, hd).bfloat16(), idx))
        tables = torch.randperm(b * nb, generator=g, device=dev).reshape(b, nb).to(torch.int32)
        b6.append((q, rn(b * nb + 1, PAGE_SIZE, kv, hd).bfloat16(),
                   rn(b * nb + 1, PAGE_SIZE, kv, hd).bfloat16(), tables, idx))
    return b5, b6


def full_cache_checks(b5, b6, dev):
    """B5 and B6 against their plain versions at the full cache (every row
    at 1,023, and rows at tile and split edges), B6 bitwise against B5 on
    the gathered cache, and both bitwise on a second run and after three
    CUDA-graph replays. Returns {name: max abs err at the full cache}."""
    from repro_torch.kernels import flash_decode as FD
    edges = torch.tensor(FULL_BOUNDARY, dtype=torch.int32, device=dev)
    errs = {}
    long5, long6 = long_cache_case(*b5[0][0].shape[1:], b5[0][1].shape[2], dev)
    n_long = n_split_of(long5)
    if n_long <= 8:
        raise AssertionError(f"the long cache takes {n_long} splits, not more than 8")
    for args5, args6 in ((b5[0], b6[0]), ((*b5[0][:3], edges), (*b6[0][:4], edges)),
                         (long5, long6)):
        out5 = FD.flash_decode(*args5)
        out6 = FD.flash_decode_paged(*args6)
        torch.cuda.synchronize()
        e5 = check("flash_decode@full cache", out5, plain_of("flash_decode")(*args5))
        e6 = check("flash_decode_paged@full cache", out6, plain_of("flash_decode_paged")(*args6))
        check("flash_decode_paged@full cache vs B5", out6,
              FD.flash_decode(args6[0], *gathered(args6), args6[4]), exact=True)
        errs["flash_decode"] = max(errs.get("flash_decode", 0.0), e5)
        errs["flash_decode_paged"] = max(errs.get("flash_decode_paged", 0.0), e6)
    for name, args in (("flash_decode", b5[0]), ("flash_decode_paged", b6[0]),
                       ("flash_decode", long5), ("flash_decode_paged", long6)):
        fn = kernel_of(name)
        first = fn(*args)
        check(f"{name}@full cache, second run", fn(*args), first, exact=True)
        check(f"{name}@full cache after CUDA-graph replays", graph_replayed(lambda: fn(*args)),
              first, exact=True)
    log(f"kernel flash_decode / flash_decode_paged @full cache: max abs err "
        f"{errs['flash_decode']:.3e} / {errs['flash_decode_paged']:.3e} (rows at 1,023 and at "
        f"positions {FULL_BOUNDARY}; {LONG_ROWS} rows of {LONG_SEQ} positions, {n_long} "
        f"splits, at {[int(i) for i in long5[3]]}); B6 bitwise equal to B5 on the gathered "
        "cache; both bitwise equal on a second run and after 3 CUDA-graph replays")
    return errs


def long_cache_case(h, hd, kv, dev):
    """B5 inputs (q, k, v, index) and B6 inputs (q, arena k, arena v,
    tables, index) of LONG_ROWS rows of LONG_SEQ positions at zcode's
    widths, f32 q against a bf16 cache, B6 through a seeded permutation of
    pages; rows at 0, the last position of the merge's first batch of 8
    splits, the next position and the last."""
    from repro_torch.kernels import flash_decode as FD
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    b, nb = LONG_ROWS, LONG_SEQ // PAGE_SIZE
    q = torch.randn(b, h, hd, generator=g, device=dev)
    k, v = (torch.randn(b * nb + 1, PAGE_SIZE, kv, hd, generator=g, device=dev).bfloat16()
            for _ in range(2))
    tables = torch.randperm(b * nb, generator=g, device=dev).reshape(b, nb).to(torch.int32)
    per = FD.plan_of(q, k, tables)[1]
    idx = torch.tensor([0, 8 * per - 1, 8 * per, LONG_SEQ - 1], dtype=torch.int32, device=dev)
    b6 = (q, k, v, tables, idx)
    return (q, *gathered(b6), idx), b6


def full_cache_phase(cfg, dev):
    """Phase 8's kernel sites: checks (``full_cache_checks``), then each
    kernel timed cold, rotating over N_COLD caches in the timed graph, in
    turns with its library yardstick. Returns {name: timing}."""
    b5, b6 = full_cache_cases(cfg, dev)
    errs = full_cache_checks(b5, b6, dev)
    out = {}
    for name, cases in (("flash_decode", b5), ("flash_decode_paged", b6)):
        nbytes, flops, wdt = work(name, cases[0])
        b_ms, b_by = bound(nbytes, flops, wdt)
        k_ms, l_ms = in_turns(rotating([lambda a=a: kernel_of(name)(*a) for a in cases]),
                              rotating([library_of(name, a) for a in cases]))
        p_ms = device_ms(rotating([lambda a=a: plain_of(name)(*a) for a in cases]))
        t = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                 max_abs_err=errs[name], n_split=n_split_of(cases[0]), cold_caches=N_COLD,
                 shape=" x ".join(str(tuple(a.shape)) for a in cases[0]))
        lib = "SDPA" if name == "flash_decode" else "index_select + SDPA, two calls"
        log(f"time {name}@full cache, cold [{t['shape']}, every index {FULL_SEQ - 1}, "
            f"{nbytes} bytes, n_split {t['n_split']}, {N_COLD} caches rotated]: kernel "
            f"{k_ms:.6f} ms ({b_ms / k_ms * 100:.1f}% of the bound), bound {b_ms:.6f} ms "
            f"({b_by}), plain {p_ms:.6f} ms, library ({lib}, in turns) {l_ms:.6f} ms")
        out[name] = t
    del b5, b6
    torch.cuda.empty_cache()
    return out


def deep_decode_graph(params, batch, cfg, dev):
    """The decode step at depth FULL_SEQ - 1 as one CUDA graph (device ms):
    a slot pool of max_seq FULL_SEQ whose self-attention K/V hold seeded
    random values and every row at position FULL_SEQ - 1, so each decoder
    layer's B5 reads its whole cache, cold behind the step's MoE weights."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import prefill
    from repro_torch.serve.engine import decode_pool_step
    from repro_torch.tree import flatten_with_paths
    lg, fresh = prefill(params, batch, cfg, max_seq=FULL_SEQ)
    pool = _pool(cfg, fresh, dev)
    del fresh
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    kv_bytes = 0
    for path, t in flatten_with_paths(pool).items():
        if "/attn/" in f"/{path}":                        # self-attention K/V
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
            kv_bytes += t.numel() * t.element_size()
    tok = lg[:, 0].argmax(-1)
    pos = torch.full((BATCH,), FULL_SEQ - 1, device=dev)
    alive = torch.ones(BATCH, dtype=torch.bool, device=dev)

    def step():
        return decode_pool_step(params, pool, tok, pos, alive, cfg, flash_decode=True)

    reset_launch_counts()
    step()
    torch.cuda.synchronize()
    launches = launch_counts()["flash_decode"]
    if launches != cfg.n_layers:
        raise AssertionError(f"decode step at depth {FULL_SEQ - 1}: {launches} flash_decode "
                             f"launches, expected {cfg.n_layers}")
    ms = device_ms(step, reps=1, replays=20)
    log(f"decode step at depth {FULL_SEQ - 1} as one CUDA graph: {ms:.4f} ms on the device "
        f"({BATCH} rows, self-attention K/V {kv_bytes / 2**20:.1f} MiB, {launches} B5 "
        "launches at the full cache's shapes)")
    del pool
    return dict(ms=ms, self_attn_kv_bytes=kv_bytes, flash_decode_launches=launches)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def kernel_table(errs, timing, counts, t_errs, t_timing, t_counts, paged, b4_serve, fc):
    """One entry per kernel for the JSON line: serving kernels at their
    decode site with their launches per ``generate``, training kernels at
    the training site with their launches per step (B4 on ``cuda_fused``,
    B1's backward on ``cuda``; dx at its down-projection site, with the
    up-projection site beside it), B6 at the paged scheduler's decode site
    with its launches over one bf16 replay of the trace; every entry also
    lists its launches per training step on both kernel backends, and the
    kernels timed at the training site besides (B1's forward, B2) carry
    that timing too (B3, timed with PDL off, also its prefill site, its
    time with PDL on overlapping the B3 before it, the pair B1 -> B3 at
    decode and at the training site and the launch floor); B4 carries its balanced site and, with its launches
    per ``cuda_fused`` generate, its serving sites; B5 and B6 their
    full-cache sites (phase 8), B5 its launch floor and the decode step at
    depth 1,023 as one CUDA graph."""
    kernels = []
    for name in ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw", "dispatch",
                 "combine", "fused_moe", "flash_decode"):
        src, rep = REPLACES[name]
        if (name, "decode") in timing:
            t, site, launches, err = timing[(name, "decode")], "decode", counts[name], errs[name]
        else:
            t, site = t_timing[(name, "train")], "train"
            launches = t_counts["cuda_fused" if name == "fused_moe" else "cuda"][name]
            err = t_errs[name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": launches, "max_abs_err": err, "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "site": site, "shape": t["shape"],
                 "train_launches": {b: c[name] for b, c in t_counts.items()}}
        if site == "decode":
            entry["prefill_ms"] = timing.get((name, "prefill"), {}).get("ms")
        if name.startswith("grouped_matmul"):
            entry["variant"] = "streaming" if name in B1_STREAMED else "tiled"
        if name in ("grouped_matmul", "dispatch", "combine"):
            entry["prefill"] = timing[(name, "prefill")]
            entry["train_site"] = {**t_timing[(name, "train")], "max_abs_err": t_errs[name]}
        if name == "combine":
            entry.update(pdl_self_overlap_ms=t["pdl_self_overlap_ms"],
                         bitwise_plain=t["bitwise_plain"])
            entry.update(pair_decode=timing[(name, "pair")], pair_train=t_timing[(name, "pair")],
                         launch_floor=timing[("launch_floor", "decode")])
        if name == "grouped_matmul_dx":
            entry["tiled_ms"] = t["tiled_ms"]
            entry["train_up_site"] = t_timing[(name, "train_up")]
        if name == "flash_decode":
            entry.update(n_split=t["n_split"], floor_site=timing[(name, "floor")],
                         full_cache_site=fc[name], decode_step_graph=fc["decode_step_graph"])
        if name == "fused_moe":
            b4_sites, b4_launches = b4_serve
            entry.update(variant=t["variant"], live_experts=t["live_experts"],
                         pipeline_ms=t["pipeline_ms"],
                         balanced_site=t_timing[(name, "balanced")],
                         serve_launches=b4_launches,
                         decode_site=b4_sites["decode"], prefill_site=b4_sites["prefill"])
        kernels.append(entry)
    err, t, launches = paged
    src, rep = REPLACES["flash_decode_paged"]
    kernels.append({"name": "flash_decode_paged", "route": "cuda", "source": src,
                    "replaces": rep, "launches": launches, "max_abs_err": err,
                    "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                    "library": "index_select of the pages + scaled_dot_product_attention "
                               "(two calls)",
                    "site": "paged decode", "shape": t["shape"], "n_split": t["n_split"],
                    "full_cache_site": fc["flash_decode_paged"],
                    "train_launches": {b: c["flash_decode_paged"] for b, c in t_counts.items()}})
    return kernels


def serve_phases(full, dev):
    """Phases 3-5, 7 and 8 on the serving path; every tensor they made is
    freed on return. Returns (errs, timing, counts, phase 7's B6 result,
    phase 4's B4 result on cuda_fused, phase 8's result)."""
    from repro_torch.launch.serve import generator, synth_batch
    from repro_torch.models import init_model
    from repro_torch.serve import GenerateConfig, generate

    cfg = dataclasses.replace(full, moe=dataclasses.replace(full.moe, backend="cuda"))
    t0 = time.perf_counter()
    params = init_model(generator(dev, SEED, 0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"model: {cfg.arch_id} {n_params / 1e9:.3f} B params on the card "
        f"(analytic {cfg.n_params() / 1e9:.3f} B), init {time.perf_counter() - t0:.1f} s")
    batch = synth_batch(cfg, generator(dev, SEED, 1), BATCH, PROMPT)
    gen = GenerateConfig(max_new=MAX_NEW, eos_id=-1, flash_decode=True)

    # 3. kernels against plain versions, at the main path's inputs
    with Capture() as cap:
        generate(params, batch, cfg, dataclasses.replace(gen, max_new=2))
    torch.cuda.synchronize()
    errs, timing = kernel_phase(cap.calls, dev)
    del cap
    # 8. B5 and B6 at the full cache
    fc = full_cache_phase(cfg, dev)

    # 4. the slice, on the cuda backend, then on cuda_fused
    counts, tokens = slice_phase(params, batch, cfg, gen, dev)
    fc["decode_step_graph"] = deep_decode_graph(params, batch, cfg, dev)
    b4_serve = fused_slice_phase(params, batch, cfg, gen, dev, tokens)

    # 5. kernel path against plain path, f32 activations
    e2e_phase(params, batch, cfg, gen, dev)
    # 7. the schedulers and B6, on the seeded weights
    t0 = time.perf_counter()
    paged = sched_phase(params, batch, cfg, dev)
    log(f"scheduler phase: {time.perf_counter() - t0:.1f} s")
    sensitivity(params, batch, cfg, dev)          # scales params in place
    return errs, timing, counts, paged, b4_serve, fc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("full_cache", "ep"),
                    help="run phases 1, 2 and this phase alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    lib = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib.relative_to(REPO)}")
    full = get_config("zcode-m3-base")
    if args.only == "full_cache":
        return full_cache_only(full, dev)
    if args.only == "ep":
        print(json.dumps({"ep": ep_phase(full, dev)}), flush=True)
        return 0
    ptxas_report(lib.parent / "nvcc.log")

    # 3-5, 7 and 8. serving
    t0 = time.perf_counter()
    errs, timing, counts, paged, b4_serve, fc = serve_phases(full, dev)
    torch.cuda.empty_cache()
    log(f"serving phases: {time.perf_counter() - t0:.1f} s; device memory now allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # 6. training
    t0 = time.perf_counter()
    captured = train_parity(full, dev)
    t_errs, t_timing = train_kernel_phase(captured, dev)
    del captured
    torch.cuda.empty_cache()
    t_counts, t_slice = {}, {}
    for backend in ("cuda_fused", "cuda"):
        t_counts[backend], t_slice[backend] = train_slice(full, dev, backend)
    log(f"training phase: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"train": {b: {k: v for k, v in t.items()}
                                for b, t in t_slice.items()}}), flush=True)

    # ep. the expert-parallel path under a one-rank group
    print(json.dumps({"ep": ep_phase(full, dev)}), flush=True)

    kernels = kernel_table(errs, timing, counts, t_errs, t_timing, t_counts, paged, b4_serve,
                           fc)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def full_cache_only(full, dev) -> int:
    """``--only full_cache``: phase 8 on its own seeded weights; prints its
    numbers as one JSON line."""
    from repro_torch.launch.serve import generator, synth_batch
    from repro_torch.models import init_model
    cfg = dataclasses.replace(full, moe=dataclasses.replace(full.moe, backend="cuda"))
    fc = full_cache_phase(cfg, dev)
    params = init_model(generator(dev, SEED, 0), cfg)
    batch = synth_batch(cfg, generator(dev, SEED, 1), BATCH, PROMPT)
    fc["decode_step_graph"] = deep_decode_graph(params, batch, cfg, dev)
    print(json.dumps({"full_cache": fc}), flush=True)
    return 0


def ptxas_report(path: Path):
    """Each kernel's registers and spills from the build's ptxas report,
    and what the card reports for B1's, B5's, B6's and B4's variants."""
    import re
    import shutil
    from repro_torch.kernels import flash_decode, grouped_ffn, moe_megakernel
    entry = "?"
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            if shutil.which("c++filt"):
                entry = subprocess.run(["c++filt", entry], capture_output=True,
                                       text=True).stdout.strip()
        elif "registers" in line or "spill" in line:
            log(f"  ptxas: {entry}: {line.split(':', 1)[-1].strip()}")
    for kind in ("stream_fwd", "stream_dx", "stream_dw", "tiled_fwd", "tiled_dx"):
        for dt in (torch.float32, torch.bfloat16):
            infos = {c: grouped_ffn.variant_info(kind, dt, c) for c in (1, 4, 8, 16)}
            log(f"B1 {kind} {_dt(torch.empty(0, dtype=dt))} (C rounded up to 1/4/8/16): "
                + "; ".join(f"C={c}: {i['registers']} registers, {i['smem_bytes']} B shared, "
                            f"{i['spill_bytes']} B spilled, {i['blocks_per_sm']} blocks/SM"
                            for c, i in infos.items()))
    for paged in (False, True):
        for qdt, kvdt in ((torch.float32, torch.bfloat16), (torch.float32, torch.float32),
                          (torch.bfloat16, torch.bfloat16)):
            infos = {(hd, rep): flash_decode.variant_info(paged, qdt, kvdt, hd, rep)
                     for hd, rep in ((64, 1), (128, 1), (64, 8), (128, 8))}
            log(f"{'B6' if paged else 'B5'} q {_dt(torch.empty(0, dtype=qdt))}, cache "
                f"{_dt(torch.empty(0, dtype=kvdt))} (128 positions per split, pages of 16): "
                + "; ".join(f"hd={hd} rep={rep}: {i['registers']} registers, "
                            f"{i['smem_bytes']} B shared, {i['spill_bytes']} B spilled, "
                            f"{i['blocks_per_sm']} blocks/SM"
                            for (hd, rep), i in infos.items()))
    for kind in ("stream", "tiled"):
        for dt in (torch.float32, torch.bfloat16):
            infos = {c: moe_megakernel.variant_info(kind, dt, c) for c in (1, 4, 8, 16)}
            log(f"B4 {kind} {_dt(torch.empty(0, dtype=dt))} (C rounded up to 1/4/8/16; "
                "ungated; 128 experts): "
                + "; ".join(f"C={c}: {i['registers']} registers, {i['smem_bytes']} B shared, "
                            f"{i['spill_bytes']} B spilled, {i['blocks_per_sm']} blocks/SM"
                            for c, i in infos.items()))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
