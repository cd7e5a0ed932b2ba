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
  tp. the model axis -- after phase ep, on phase 6's seeded full-width
                 zcode-m3-base in f32: (a) for m = 2 and 4, each model
                 shard's expert FFN through B1's forward, dx and dW on its
                 d_ff / m slice of w_in (columns) and w_out (rows) at the
                 training site ((128, 8, 512)) and the decode site ((128,
                 1, 512)): the shards' summed output and dx and their
                 joined dW against the unsharded B1 and the plain version,
                 every launch on the streaming kernel, each sliced product
                 timed in turns with torch.bmm beside its bound; (b)
                 --mesh 1,2 on the one card: two ranks of this script
                 (--tp-rank, started by the phase) under gloo, which takes
                 the card's tensors (NCCL refuses two ranks on one device;
                 at d = 1 the tensor-parallel layout issues all-reduces
                 only), each with the full-width model's d_ff / 2 slice of
                 every expert: a routed and a Gate-Drop step on cuda within
                 phase 6's f32 bound of a one-rank run of the same steps,
                 each rank's B1 launches per step at the d_ff / 2 shapes,
                 and a short greedy generate whose tokens equal the
                 one-rank run's;
  obs. observability -- after phase tp, on the seeded full-width
                 zcode-m3-base (bf16 activations): phase 7's trace through
                 the slot pool, the arena and the 20-page arena with the
                 span tracer and the metrics registry on and every tick
                 under the host-sync guard (analysis/hostsync.py, with the
                 card's sync debug mode): the exported Chrome trace's span
                 counts equal the schedulers' stats, each steady decode
                 tick shows its one sanctioned fetch and no other sync,
                 and torch.profiler's launch counts over a few ticks
                 (analysis/launches.py) equal the wrappers'; the
                 static-batching baseline (static_batch_serve) and the
                 continuous scheduler, one run each (wall time, tokens/s;
                 a number, not a claim); a replay with the tracer on, then
                 off, and a span's ns per call; then the Trainer
                 (4 Gate-Drop 0.3 steps on cuda, tracer and frame on):
                 its span vocabulary, load_imbalance in every record, and
                 one more chunk in a profiler window under the guard: its
                 one fetch and no other sync, the profiler's launches equal
                 the wrappers' and expected_train_launches;
  8. full cache -- B5 and B6 at zcode-m3-base's full 1,024-position cache
                 (every row at position 1,023; B6 through a permuted page
                 arena): against the plain version, B6 bitwise against B5,
                 both bitwise on a second run and after CUDA-graph
                 replays, and timed cold (each call in the timed graph
                 finds its cache out of L2) in turns with SDPA (B5) and
                 index_select + SDPA (B6); then the decode step at depth
                 1,023 as one CUDA graph (run inside the serving phases,
                 on their weights).

  swa. sliding windows and long prompts -- after phase dec, each model
                 freed before the next (seeded weights, f32 parameters, bf16
                 activations unless f32 is named): starcoder2-3b at full
                 width and depth generates for 2 x 4,608-token prompts (past
                 its 4,096-token window and 2 x 1,024 keys: the rings evict
                 at prefill, which takes the blocked flash attention) with
                 no kernel launch, timed, its decode step as a CUDA graph;
                 f32: prefill logits against the quadratic path with the
                 window's mask, 8 teacher-forced ring decode steps against
                 model_apply; the slot-pool scheduler with buckets to 8,192
                 (exact-length prefill) on prompts of 64-4,800 tokens, its
                 tokens against one-shot generate, and the paged scheduler's
                 refusal; h2o-danube-3-4b (4 layers) through the same
                 gates; yi-6b at a 3,616-position cache (992 B5 per
                 generate, B5 and B6 at that depth against plain and
                 library, slot pool and arena tokens equal); dbrx-132b (2
                 layers) at a 2,304-token prompt: B1-B4 at the prefill's
                 inputs against plain and library, both backends' f32
                 logits against the plain path;
  mla. DeepSeek-V3 -- after phase swa, every earlier model freed:
                 deepseek-v3-671b at full width (d 7,168, 128 MLA heads,
                 vocab 129,280, 256 experts top-8 plus one shared) cut to 2
                 layers (0 dense, 1 MoE; seeded weights, f32 parameters,
                 bf16 activations unless f32 is named) generates for 8
                 requests on cuda and cuda_fused with the B1-B4 launches
                 per generate asserted (no flash decode: MLA's absorbed
                 decode is plain), timed in turns, the decode step as one
                 CUDA graph; B1-B4 at the decode step's and a 2 x
                 1,024-token prefill's inputs (k = 8) against their plain
                 versions and timed; the plain absorbed MLA decode of one
                 layer timed beside its byte bound; f32: both backends'
                 prefill logits and 8 teacher-forced decode steps against
                 the plain path;
                 the slot pool and the page arena on 8 requests, their
                 tokens against one-shot generate; reduced
                 deepseek-v3-671b's --task lm steps with its MTP head on
                 oracle, cuda_fused and cuda, gated as phase dec's; the
                 phase's wall time and peak device memory;
  ssm. Mamba-2 and Hymba -- after phase mla, every earlier model freed
                 (seeded weights, f32 parameters, bf16 activations unless f32
                 is named): mamba2-1.3b at full width and depth (48 layers, d
                 2,048, 64 SSD heads of 64, state 128, chunk 128) generates for
                 8 requests with no kernel launch, timed, its decode step as
                 one CUDA graph; a 2 x 4,096-token prefill timed with its peak
                 memory; f32: prefill and 8 teacher-forced decode steps
                 against model_apply; the slot pool (exact-length prefill) on
                 prompts of mixed lengths against one-shot generate, and the
                 arena's refusal; a forward and backward pass at 4 layers on
                 2 x 1,024 tokens, the loss and every gradient finite.
                 hymba-1.5b at full width and depth (32 layers, d 1,600, 25/5
                 heads of 64 beside 50 SSD heads, 128 meta tokens, window
                 1,024 but at layers 0, 15 and 31): the same generate with
                 flash decode (3 B5 per step, its index past the meta
                 tokens), B5 at its decode site; a 2 x 2,048-token prompt
                 (2,176 positions) prefilled, timed, then f32 blocked against
                 quadratic attention and teacher-forced decode against
                 model_apply; the slot pool, the arena (the meta pages shared:
                 prefix hits) and a 20-page arena that preempts, tokens against
                 one-shot; B6 at the arena's decode site; reduced
                 mamba2-1.3b's and hymba-1.5b's --task lm steps on the card
                 against the CPU's;
  vlm. the non-token frontends -- after phase ssm, every earlier model
                 freed (seeded weights, f32 parameters, bf16 activations
                 unless f32 is named): llama-3.2-vision-90b at full width
                 (d 8,192, 64/8 heads of 128, vocab 128,256) cut to 10
                 layers (layers 0 and 5 tanh-gated cross-attention onto
                 1,601 image embeddings of width 1,280 through img_proj,
                 the gates set to seeded nonzero values) and whisper-small
                 at full size (12 + 12 layers, d 768, its encoder on 1,500
                 audio frames) each generate for 8 requests with flash
                 decode (B5 once per self-attention layer a step: 8 and
                 12), timed, the decode step as one CUDA graph and by op;
                 B5 at each decode site (rep 8 over 64 heads, rep 1 over
                 12) against plain and SDPA; one layer's plain
                 cross-attention read at decode timed against its byte
                 bound; f32: prefill and 8 teacher-forced decode steps
                 against the plain path; the slot pool, the arena and a
                 10-page arena that preempts (3 slots) on 8 requests that carry
                 their own f32 images or frames, tokens against one-shot,
                 B6 at the arena's decode site; reduced whisper-small's
                 --task mt steps on the card against the CPU's;
  dryrun. the meta-device dry run -- after phase vlm: each of the
                 reference's ten archs once, its train_4k pair (every
                 applicable (arch x input shape) pair, all 34, under
                 --only dryrun), at full width and the reference's
                 production shapes on
                 torch.device("meta") (launch/dryrun.py::run_all: each
                 shallow variant's step one task over a spawned process a
                 host core, none of which touches a device), artifacts for (data 16, model 16)
                 and (pod 2, data 16, model 16): each pair's seconds, FLOPs
                 per step and bytes per device printed, 34 of 34 ok on both
                 meshes asserted, torch.cuda.memory_allocated() unchanged
                 across the run; then the dry run's one-device argument
                 bytes of zcode-m3-base's phase-6 train state asserted equal
                 to the byte sum of the state phase 6 built on the card,
                 printed beside that build's memory_allocated delta (with
                 --only dryrun the phase builds the state itself);
  lint.   the lint gate -- after phase dryrun: python -m
                 repro_torch.launch.lint --gate --device cuda --json-out
                 build/lint/report.json as a subprocess (the 8-rank
                 executables as 8 gloo processes on the card): exit 0 and
                 every applicable (executable, pass) cell of the 27 ok
                 asserted, launch-count (the profiler's kernel launches
                 equal to the wrappers' calls) and smem-budget (227 KiB a
                 block) included; each launched kernel's shared bytes,
                 registers and spills and the seconds printed as one JSON
                 line;

  python3 chip_smoke.py --only full_cache

runs phases 1, 2 and 8 alone (the decode step at depth 1,023 on its own
seeded weights) and prints their numbers as one JSON line: the quick way
to compare two trees' B5 and B6 at these sites in one call; ``--only
sites`` runs phases 1 and 2 (with the build's register and spill report)
and B2, B3, B5 and B6 at the shapes of the kernel table's rows on seeded
inputs, against plain and library in turns (``sites_phase``);
``--only ep``, ``--only tp``, ``--only obs``, ``--only dec``, ``--only
swa``, ``--only mla``, ``--only ssm``, ``--only vlm``, ``--only dryrun``
and ``--only lint`` run phases 1, 2 and that phase alone.

Prints each phase's seconds as one JSON line ({"phase_seconds": ...}), the
kernel table as one JSON line before the last line and, as the last line,
{"ok": true, "device": {...}}. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import os
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
DRYRUN_PAIRS, DRYRUN_ARCHS = 34, 10      # the reference's applicable pairs, its archs
LINT_EXECUTABLES = 27                    # the lint gate's registry, the reference's
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
TIMED_REPLAYS = 1                       # phase 7's timed replays of each scheduler
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


def in_turns(*fns, depth=()):
    """Device ms of each of ``fns`` timed in turns (a, b, .., b, a), each
    the mean of its two readings; ``depth``, if given, is device_ms's
    (reps, replays)."""
    ms = [device_ms(f, *depth) for f in (*fns, *fns[::-1])]
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

    def __init__(self, all_calls: bool = False, names=SERVE, share_over: int = 0):
        self.all_calls = all_calls
        # tensors of more than ``share_over`` bytes (0: none) are kept by
        # reference, not cloned: phase dec's expert weights (4.2 GB each),
        # which serving never writes
        self.share_over = share_over
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
                        (a.detach() if self.share_over and
                         a.numel() * a.element_size() > self.share_over
                         else a.detach().clone()) if torch.is_tensor(a) else a
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
# B1 shapes (E, C, d, f) that cut the tiled kernel's 128-row, 128-column and
# 32-deep tiles ragged: C = 17, 100, 128, 300; d and f off the tiles, some
# with rows of whole 16-byte words (16-byte copies), some not (element loads)
B1_TILED_RAGGED = [(2, 17, 1030, 130), (3, 100, 136, 260), (2, 128, 200, 300),
                   (2, 300, 260, 72)]


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
        # and a ragged column slab (streaming); the tiled kernel's row, column
        # and k tiles cut ragged at C = 17, 100, 128, 300 (16-byte rows and
        # not), and a view off a 16-byte boundary (element loads)
        for e, c, d, f in ((4, 1, 512, 2048), (3, 5, 100, 70), (2, 17, 64, 64),
                           (2, 100, 130, 200), *B1_FULL_WIDTH, (3, 5, 96, 64),
                           (2, 2, 40, 136), *B1_TILED_RAGGED):
            cases.append(("grouped_matmul", (rn(e, c, d, dtype=dt),
                                             rn(e, d, f, dtype=dt) * d ** -0.5),
                          False))
        x = rn(1 + 2 * 100 * 72, dtype=dt)[1:].view(2, 100, 72)
        cases.append(("grouped_matmul", (x, rn(2, 72, 136, dtype=dt) * 72 ** -0.5), False))
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
        gqa = {"enable_gqa": True} if q.shape[1] != k.shape[2] else {}
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, **gqa)
    if name == "flash_decode_paged":       # two calls: no one call reads pages
        q, k, v, bt, idx = args
        b, nb, ps = q.shape[0], bt.shape[1], k.shape[1]
        flat = bt.long().reshape(-1)
        q4 = q.to(k.dtype)[:, :, None, :]
        pos = torch.arange(nb * ps, device=k.device)[None, :]
        mask = (pos <= idx.long()[:, None])[:, None, None, :]
        gqa = {"enable_gqa": True} if q.shape[1] != k.shape[2] else {}

        def library():
            gk = k.index_select(0, flat).reshape(b, nb * ps, *k.shape[2:]).transpose(1, 2)
            gv = v.index_select(0, flat).reshape(b, nb * ps, *v.shape[2:]).transpose(1, 2)
            return F.scaled_dot_product_attention(q4, gk, gv, attn_mask=mask, **gqa)

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
            timing[(name, site)] = (combine_site(site, args) if name == "combine"
                                    else time_site(name, site, args))
    timing[("flash_decode", "floor")] = b5_floor(calls["flash_decode"][-1][0])
    decode = calls["combine"][-1][0]
    timing[("combine", "pair")] = pdl_pair("decode", calls["grouped_matmul"][-1][0], decode)
    timing[("launch_floor", "decode")] = launch_floor(-(-decode[1].shape[0] // 4))
    return out, timing


LIBRARY_NAMES = {"grouped_matmul": "torch.bmm", "grouped_matmul_dx": "torch.bmm on the w^T view",
                 "grouped_matmul_dw": "torch.bmm on the x^T view", "dispatch": "index_select",
                 "flash_decode": "SDPA"}


def time_site(name, site, args, label="", depth=()):
    """B1's forward, B2 or B5 at one site: timed in turns with its library
    call, the plain version alone, and the bound from these inputs
    (``depth`` as in ``in_turns``)."""
    nbytes, flops, wdt = work(name, args)
    b_ms, b_by = bound(nbytes, flops, wdt)
    k_ms, l_ms = in_turns(lambda: kernel_of(name)(*args), library_of(name, args),
                          depth=depth)
    p_ms = device_ms(lambda: plain_of(name)(*args), *depth)
    shape = " x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a))
    t = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
             shape=shape)
    note = ""
    if name in B1_STREAMED:
        t["variant"] = b1_variant(name, args)
        note = f"; {t['variant']} variant"
    elif name == "dispatch":
        from repro_torch.kernels import moe_dispatch
        x, st, _ = args
        per, stream = moe_dispatch.dispatch_plan(st.shape[0], x.shape[1] * x.element_size())
        t.update(per_thread=per, stream=stream)
        note = (f"; {per} words a thread, {'evict-first' if stream else 'plain'} stores; kernel / "
                f"library {k_ms / l_ms:.3f}")
    elif name == "flash_decode":
        t["n_split"] = n_split_of(args)
        note = f"; n_split {t['n_split']}"
    log(f"time {label}{name}@{site} [{shape}]: kernel {k_ms:.6f} ms, bound {b_ms:.6f} ms "
        f"({b_by}; {b_ms / k_ms * 100:.1f}% of it), plain {p_ms:.6f} ms, library "
        f"{l_ms:.6f} ms ({LIBRARY_NAMES[name]}, timed in turns with the kernel{note})")
    return t


def combine_no_pdl(buf, ts, w, keep, cols=None):
    """B3's kernel launched without PDL (which the wrapper never asks
    for), on the grid its plan picks or, given ``cols``, on that one, into
    a new tensor; not counted."""
    from repro_torch.kernels import moe_dispatch
    out = torch.empty((ts.shape[0], buf.shape[1]), dtype=buf.dtype, device=buf.device)
    moe_dispatch.launch_combine(buf, ts, w, keep, out, pdl=False, cols=cols)
    return out


def combine_site(site, args):
    """B3 at one site: against its plain version, bitwise its other grid
    (both sum in the order of k); at top-1 the same bits on a second run,
    with PDL off and after CUDA-graph replays; then timed in turns: the
    kernel with PDL off (``ms``: each call in the timed graph follows
    another B3, and with PDL it would overlap that B3, which the main path
    never runs), the kernel as the wrapper launches it (PDL on:
    ``pdl_self_overlap_ms``), the grid the plan did not pick (PDL off:
    ``other_grid_ms``) and ``embedding_bag``."""
    from repro_torch.kernels import moe_dispatch
    kernel = kernel_of("combine")
    cols = moe_dispatch.plan_of(args[0], args[1])
    out = kernel(*args)
    torch.cuda.synchronize()
    plain = plain_of("combine")(*args)
    err = check(f"combine@{site}", out, plain)
    check(f"combine@{site} other grid", combine_no_pdl(*args, cols=not cols), out, exact=True)
    top1 = args[1].shape[1] == 1
    if top1:
        check(f"combine@{site} second run", kernel(*args), out, exact=True)
        check(f"combine@{site} PDL off", combine_no_pdl(*args), out, exact=True)
        check(f"combine@{site} after CUDA-graph replays",
              graph_replayed(lambda: kernel(*args)), out, exact=True)
    fns = {"ms": lambda: combine_no_pdl(*args), "pdl_self_overlap_ms": lambda: kernel(*args),
           "other_grid_ms": lambda: combine_no_pdl(*args, cols=not cols),
           "library_ms": library_of("combine", args)}
    t = dict(zip(fns, in_turns(*fns.values())))
    b_ms, b_by = bound(*work("combine", args))
    t.update(plain_ms=device_ms(lambda: plain_of("combine")(*args)), bound_ms=b_ms,
             bound_by=b_by, max_abs_err=err, bitwise_plain=torch.equal(out, plain),
             grid="cols" if cols else "rows",
             shape=" x ".join(str(tuple(a.shape)) for a in args))
    log(f"time combine@{site} [{t['shape']}]: kernel ({t['grid']} grid) {t['ms']:.6f} ms with "
        f"PDL off (PDL on {t['pdl_self_overlap_ms']:.6f}, overlapping the B3 before it in the "
        f"graph; the {'rows' if cols else 'cols'} grid {t['other_grid_ms']:.6f}), bound "
        f"{b_ms:.6f} ms ({b_by}; {b_ms / t['ms'] * 100:.2f}% of it), plain "
        f"{t['plain_ms']:.6f} ms, library {t['library_ms']:.6f} ms (embedding_bag; all timed "
        f"in turns); max abs err {err:.3e}; bitwise the other grid" + (
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

def _pool(cfg, fresh, dev, rows=BATCH):
    """The engine's slot pool holding the per-request caches ``fresh``."""
    from repro_torch.serve.engine import (_alloc_pool_like, _cache_batch_axes,
                                          _scatter_slots)
    axes = _cache_batch_axes(cfg)
    return _scatter_slots(_alloc_pool_like(fresh, axes, rows), fresh, axes,
                          torch.arange(rows, device=dev))


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
    rows, plen = batch["tokens"].shape
    lg, fresh = prefill(params, batch, cfg, max_seq=plen + MAX_NEW)
    pool = _pool(cfg, fresh, dev, rows)
    del fresh
    tok = lg[:, 0].argmax(-1)
    pos = torch.full((rows,), plen, device=dev)
    alive = torch.ones(rows, dtype=torch.bool, device=dev)
    graph_ms = device_ms(lambda: decode_pool_step(params, pool, tok, pos, alive, cfg,
                                                  flash_decode=True),
                         reps=1, replays=20)
    log(f"{label}: decode step as one CUDA graph {graph_ms:.2f} ms on the device "
        f"vs median {decode_ms:.2f} ms eager: the device is idle "
        f"{max(0.0, 1 - graph_ms / decode_ms) * 100:.0f}% of an eager step")
    with CallCount() as calls:
        decode_pool_step(params, pool, tok, pos, alive, cfg, flash_decode=True)
    log(f"{label}: {calls.n} PyTorch calls from Python per eager decode step")
    return graph_ms


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


def e2e_phase(params, batch, cfg, gen, dev, label="e2e"):
    """Kernel path (cuda MoE backend, flash decode) against the plain path
    (oracle MoE, plain decode attention) in f32 activations (a dense
    model: flash decode against plain decode attention). Gates the
    prefill logits and N_FORCED decode steps' logits, both paths fed the
    same random tokens (random weights collapse greedy decoding onto few
    tokens, so greedy outputs alone would drive decode with one input).
    Reports the share of tokens that agree, greedy and sampled at
    temperature 1 with one seed (the same Gumbel noise on both paths)."""
    from repro_torch.models import prefill
    from repro_torch.serve import generate
    from repro_torch.serve.engine import decode_pool_step

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    plain32 = cfg32 if cfg32.moe is None else dataclasses.replace(
        cfg32, moe=dataclasses.replace(cfg32.moe, backend="oracle"))
    lk, ck = prefill(params, batch, cfg32, max_seq=PROMPT + MAX_NEW)
    lp, cp = prefill(params, batch, plain32, max_seq=PROMPT + MAX_NEW)
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("non-finite f32 prefill logits")
    d_pre = float((lk - lp).abs().max())
    log(f"{label} f32: prefill logits {tuple(lk.shape)} (max |logit| "
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
    log(f"{label} f32: {N_FORCED} teacher-forced decode steps (random tokens), logits "
        f"kernel vs plain path max abs diff {d_dec:.3e} (tol {E2E_LOGIT_ATOL})")
    if d_dec > E2E_LOGIT_ATOL:
        raise AssertionError(f"decode logits differ by {d_dec}")

    for mode, gc in (("greedy", gen), ("sampled", dataclasses.replace(gen, temperature=1.0))):
        rk = generate(params, batch, cfg32, gc, seed=SEED)
        rp = generate(params, batch, plain32, dataclasses.replace(gc, flash_decode=False),
                      seed=SEED)
        agree = float((rk.tokens == rp.tokens).float().mean())
        per_row = sum(len(set(r)) for r in rk.tokens.tolist()) / BATCH
        log(f"{label} f32: {mode} tokens agree on {agree * 100:.1f}% of "
            f"{rk.tokens.numel()} (reported, not gated: near-tie expert flips may "
            f"split the runs); {len(set(rk.tokens.flatten().tolist()))} distinct "
            f"tokens, {per_row:.1f} per row of {MAX_NEW}")
    return d_pre, d_dec


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


# B4 calls on the tiled kernel off the main path (E, k, capacity, T, d, f,
# gated, act): top-1 and top-4, gated and not, gelu and silu, one to five
# 64-row units of slots, d past 1,024 and d, f off the 256-column tiles;
# with 8 tokens over 16 experts most experts are unrouted
B4_TILED_RAGGED = ((4, 1, 40, 100, 1100, 300, True, "silu"),
                   (8, 4, 300, 256, 1030, 520, False, "gelu"),
                   (4, 1, 130, 200, 520, 136, False, "silu"),
                   (6, 4, 64, 60, 1100, 260, True, "gelu"),
                   (16, 1, 20, 8, 1100, 200, True, "silu"))


def fused_ragged_cases(dev):
    """(args, kwargs) of B4 calls off the main path: k=2, capacity 1, all
    dropped, one token, d and f not multiples of the tile, d > 512, C = 12
    and 20, gelu and silu (gated); then ``B4_TILED_RAGGED``."""
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
                (8, 2, 12, 40, 512, 2048, False, "gelu", False),
                *(case + (False,) for case in B4_TILED_RAGGED)):
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
        for e, c, d, f in ((4, 1, 100, 70), (3, 17, 130, 200), (2, 100, 64, 64),
                           *B1_TILED_RAGGED):
            x = torch.randn(e, c, d, generator=g, device=dev).to(dt)
            w = (torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5).to(dt)
            dy = torch.randn(e, c, f, generator=g, device=dev).to(dt)
            cases += [("grouped_matmul_dx", (dy, w)), ("grouped_matmul_dw", (x, dy))]
        # views off a 16-byte boundary: the tiled kernel's element loads
        base = torch.randn(1 + 2 * 100 * 72, generator=g, device=dev).to(dt)
        dy = base[1:].view(2, 100, 72)
        w = (torch.randn(2, 40, 72, generator=g, device=dev) * 40 ** -0.5).to(dt)
        x = torch.randn(2, 100, 40, generator=g, device=dev).to(dt)
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


def b4_site(site, args, kw, depth=()):
    """B4 at one site: against its plain version and the cuda pipeline, the
    same bits on a second run at top-1, then timed in turns with the
    pipeline (kernel, pipeline, pipeline, kernel; ``depth`` as in
    ``in_turns``). Returns its timing."""
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
    k_ms, pipe_ms = in_turns(lambda: kernel_of("fused_moe")(*args, **kw), pipeline,
                             depth=depth)
    p_ms = device_ms(lambda: plain_of("fused_moe")(*args, **kw), *depth)
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


def b4_tiled_checks(args, kw, out) -> str:
    """B4's tiled kernel on one ragged case, beyond its plain version: at
    top-1 the same bits on a second run and after CUDA-graph replays (each
    output element takes one add onto zero); where experts are unrouted,
    NaN in their weights leaves the output finite and equal (bitwise at
    top-1): they are never read. Returns what was checked, for the log."""
    from repro_torch.kernels import moe_megakernel
    fused = kernel_of("fused_moe")
    x, w_in, w_gate, w_out, topk_w, keep, st, sv, ts = args
    note = ""
    if topk_w.shape[1] == 1:
        check("fused_moe tiled second run", fused(*args, **kw), out, exact=True)
        check("fused_moe tiled after CUDA-graph replays",
              graph_replayed(lambda: fused(*args, **kw)), out, exact=True)
        note += ", bitwise on a second run and after 3 graph replays"
    live = moe_megakernel.live_experts(topk_w, keep, ts, w_in.shape[0], st.shape[0])
    if not bool(live.all()):
        poisoned = []
        for w in (w_in, w_gate, w_out):
            poisoned.append(None if w is None else w.clone())
            if w is not None:
                poisoned[-1][~live] = float("nan")
        pout = fused(x, *poisoned, *args[4:], **kw)
        torch.cuda.synchronize()
        # top-k > 1: a token's k rows meet in either order
        top1 = topk_w.shape[1] == 1
        check("fused_moe tiled with NaN unrouted weights", pout, out, exact=top1)
        note += (f", NaN in {int((~live).sum())} unrouted experts' weights changes "
                 f"{'no bit' if top1 else 'nothing beyond the order of adds'}")
    return note


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
        note = b4_tiled_checks(args, kw, out) if took == "tiled" else ""
        b4_rag.append(f"{_dt(w_in)} E={w_in.shape[0]} k={args[4].shape[1]} "
                      f"C={args[6].shape[0] // w_in.shape[0]} T={x.shape[0]} "
                      f"d={w_in.shape[1]} f={w_in.shape[2]} {kw['act']}"
                      f"{' gated' if args[2] is not None else ''} {took}{note}")
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
        "gated silu; tiled at C=20-300, k=1 and 4, d > 1,024, gated and not; B1 dx/dw: "
        "C=1, C=17, C=100, C=128, C=300, ragged d and f, views off 16 bytes; C=4, 8, 9, 16 "
        "at full width, a ragged slab of d, a ragged last chunk of f; f32 and bf16)")

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
    state, state_info = built_state(cfg, tc, dev)
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
                                  peak_gib=peak / 2**30, **state_info, **profile)


def built_state(cfg, tc, dev):
    """Phase 6's train state of ``cfg`` on the card, and what it holds: the
    byte sum of its tensors (the host step counters as int32, as the dry
    run counts them) and the memory_allocated delta of building it."""
    from repro_torch.launch.serve import generator
    from repro_torch.models import init_model
    from repro_torch.parallel.sharding import tree_bytes
    from repro_torch.training import init_train_state
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    state = init_train_state(init_model(generator(dev, SEED, 0), cfg), tc)
    torch.cuda.synchronize()
    return state, dict(state_bytes=tree_bytes(state),
                       state_alloc_delta=torch.cuda.memory_allocated() - before)


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
    ctx = make_group((1, 1), dev, init_method=f"file://{rdv}", rank=0, world_size=1)
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
# phase tp: the model axis (tensor parallelism inside the experts)
# ---------------------------------------------------------------------------

TP_WAYS = (2, 4)            # model-axis widths of the sliced B1 checks
TP_DECISIONS = (False, True)  # phase tp's two steps: routed, then Gate-Drop
TP_GEN_ROWS, TP_GEN_PROMPT, TP_GEN_NEW = 4, 16, 8
TP_RANK_TIMEOUT = 400


def tp_ffn(x, w_in, w_out, act, plain=False):
    """The expert FFN (up, activation, down) on B1's entry points, or its
    plain version (einsums) with ``plain``; differentiable."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref
    if not plain:
        return K.expert_ffn_op(x, w_in, None, w_out, act)
    h = ref.activation(act)(torch.einsum("ecd,edf->ecf", x, w_in))
    return torch.einsum("ecf,efd->ecd", h, w_out)


def tp_ffn_grads(x, w_in, w_out, dy, act, plain=False):
    """(y, dx, dw_in, dw_out) of ``tp_ffn`` against the cotangent ``dy``."""
    leaves = [t.detach().requires_grad_(True) for t in (x, w_in, w_out)]
    y = tp_ffn(*leaves, act, plain=plain)
    grads = torch.autograd.grad(y, leaves, dy)
    return (y.detach(), *grads)


def tp_sliced_site(site, c, full, dev):
    """One site's sliced B1 check: for each model width m, every model
    shard's FFN on its d_ff / m slice of w_in (columns) and w_out (rows)
    through B1's forward, dx and dw; the shards' output and dx summed and
    their dW slices joined, held against the unsharded B1 and the plain
    version. Returns {m: the shards' (args) per entry point}."""
    from repro_torch.kernels import (grouped_ffn, launch_counts, reset_launch_counts)
    E, d, f = full.moe.n_experts, full.d_model, full.moe.d_ff(full.d_ff)
    g = torch.Generator(device=dev).manual_seed(40 + c)
    x = torch.randn(E, c, d, device=dev, generator=g)
    w_in = torch.randn(E, d, f, device=dev, generator=g) * d ** -0.5
    w_out = torch.randn(E, f, d, device=dev, generator=g) * f ** -0.5
    dy = torch.randn(E, c, d, device=dev, generator=g)
    whole = tp_ffn_grads(x, w_in, w_out, dy, full.act)
    plain = tp_ffn_grads(x, w_in, w_out, dy, full.act, plain=True)
    out = {}
    for m in TP_WAYS:
        n = f // m
        reset_launch_counts()
        shards = [tp_ffn_grads(x, w_in[..., k * n:(k + 1) * n].contiguous(),
                               w_out[:, k * n:(k + 1) * n].contiguous(), dy, full.act)
                  for k in range(m)]
        torch.cuda.synchronize()
        counts, streamed = launch_counts(), streamed_counts()
        got = (sum(sh[0] for sh in shards), sum(sh[1] for sh in shards),
               torch.cat([sh[2] for sh in shards], dim=-1),
               torch.cat([sh[3] for sh in shards], dim=-2))
        errs = {}
        for label, a, w, p in zip(("y", "dx", "dw_in", "dw_out"), got, whole, plain):
            errs[label] = (check(f"tp sliced {label}@{site} m={m} vs unsharded B1", a, w),
                           check(f"tp sliced {label}@{site} m={m} vs plain", a, p))
        want = {"grouped_matmul": 2 * m, "grouped_matmul_dx": 2 * m,
                "grouped_matmul_dw": 2 * m}
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"tp sliced @{site} m={m}: launches {counts} != {want}")
        variants = {k: "streaming" if streamed[k] == counts[k] else
                    f"{streamed[k]} of {counts[k]} streaming" for k in want}
        pred = grouped_ffn.variant(c, d, n, 4, *(t.data_ptr() for t in (x, w_in, dy)))
        log(f"tp sliced B1 @{site} m={m} (x ({E}, {c}, {d}), w_in slice ({E}, {d}, {n}), "
            f"w_out slice ({E}, {n}, {d}); f32): shards' sum vs unsharded B1 and plain, "
            f"max abs err " + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in errs.items())
            + f" (tol {TOL['float32']}); launches {counts}; variants {variants} "
            f"(grouped_ffn.variant predicts {pred})")
        if set(variants.values()) != {"streaming"}:
            raise AssertionError(f"tp sliced @{site} m={m}: a launch took the tiled kernel")
        dh = torch.randn(E, c, n, device=dev, generator=g)
        out[m] = {"errs": errs, "launches": counts, "variants": variants,
                  "fwd": (x, w_in[..., :n].contiguous()),
                  "dx_up": (dh, w_in[..., :n].contiguous()),
                  "dx_down": (dy, w_out[:, :n].contiguous()),
                  "dw_up": (x, dh)}
    return out


def tp_time(name, site, args):
    """B1's ``name`` entry point at one sliced site, in turns with its
    torch.bmm, the plain version alone, and the bound from these inputs."""
    b_ms, b_by = bound(*work(name, args))
    k_ms, l_ms = in_turns(lambda: kernel_of(name)(*args), library_of(name, args))
    p_ms = device_ms(lambda: plain_of(name)(*args))
    shape = " x ".join(str(tuple(a.shape)) for a in args)
    log(f"time tp {name}@{site} [{shape}]: kernel {k_ms:.6f} ms, bound {b_ms:.6f} ms "
        f"({b_by}; {b_ms / k_ms * 100:.1f}% of it), plain {p_ms:.6f} ms, library "
        f"{l_ms:.6f} ms (torch.bmm, timed in turns with the kernel); "
        f"{b1_variant(name, args)} variant")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                shape=shape, variant=b1_variant(name, args))


def tp_sliced(full, dev):
    """Phase tp (a): B1 on the model axis's d_ff slices at the training site
    ((E, C, d) = (128, 8, 512)) and the decode site ((128, 1, 512)),
    checked and timed."""
    from repro_torch.core import router as R
    tokens, E, k = TRAIN_BATCH * TRAIN_SEQ, full.moe.n_experts, full.moe.top_k
    sites = {"train": min(R.capacity(tokens, E, k, full.moe.capacity_factor), tokens),
             "decode": min(R.capacity(BATCH, E, k, full.moe.eval_capacity_factor), BATCH)}
    out, timing = {}, {}
    for site, c in sites.items():
        res = tp_sliced_site(site, c, full, dev)
        for m, r in res.items():
            entries = ([("grouped_matmul", "fwd")] if site == "decode" else
                       [("grouped_matmul", "fwd"), ("grouped_matmul_dx", "dx_up"),
                        ("grouped_matmul_dx", "dx_down"), ("grouped_matmul_dw", "dw_up")])
            for name, key in entries:
                label = f"{site}{'' if key == 'fwd' else '_' + key.split('_')[1]}/m={m}"
                timing[f"{name}@{label}"] = tp_time(name, label, r[key])
            out[f"{site}/m={m}"] = {k: r[k] for k in ("errs", "launches", "variants")}
        del res
    torch.cuda.empty_cache()
    return out, timing


def tp_steps(full, dev, ctx):
    """The seeded full-width zcode-m3-base (f32, cuda backend): its two
    phase-tp steps (routed, Gate-Drop) and a short greedy generate, under
    ``ctx`` (None: one rank, ungrouped). Returns (per-step metrics and
    launches, the weight shapes B1 saw, the generated tokens)."""
    from repro_torch.bridge import shard_experts
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import generator, synth_batch
    from repro_torch.models import init_model
    from repro_torch.serve import GenerateConfig, generate
    from repro_torch.training import init_train_state, make_train_step
    cfg = train_cfg(full, "cuda", "float32")
    tc = train_tc(len(TP_DECISIONS))
    batches = train_batches(dev, len(TP_DECISIONS))
    params = shard_experts(init_model(generator(dev, SEED, 0), cfg), ctx)
    torch.cuda.empty_cache()
    state = init_train_state(params, tc)
    step = make_train_step(cfg, tc, ctx)
    rows = []
    cap = Capture(names=("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw"),
                  share_over=1 << 16)
    with cap:
        for batch, dec in zip(batches, TP_DECISIONS):
            reset_launch_counts()
            state, m = step(state, batch, dec)
            torch.cuda.synchronize()
            rows.append({**{k: float(m[k]) for k in ("loss", "grad_norm", "balance",
                                                     "gate_dropped", "comm_a2a_calls")},
                         "launches": launch_counts(), "streamed": streamed_counts()})
    shapes = {name: sorted({str(tuple(a.shape)) for args, _ in calls for a in args
                            if torch.is_tensor(a)}) for name, calls in cap.calls.items()}
    del cap
    gen = synth_batch(cfg, generator(dev, SEED, 1), TP_GEN_ROWS, TP_GEN_PROMPT)
    res = generate(state["params"], gen, cfg, GenerateConfig(max_new=TP_GEN_NEW, eos_id=-1),
                   ctx=ctx)
    tokens = res.tokens.cpu().tolist()
    del state, step, params, batches
    torch.cuda.empty_cache()
    return rows, shapes, tokens


def tp_rank_main(rank: int, d: str) -> int:
    """One rank of phase tp (b): --mesh 1,2 on the one card under gloo
    (NCCL refuses two ranks on one device), its rows and block of experts
    (every expert's d_ff / 2 slice); writes ``d/rank<rank>.json``."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import close_group, make_group
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["LOCAL_RANK"] = "0"
    dev = torch.device("cuda")
    ctx = make_group((1, 2), dev, init_method=f"file://{d}/rendezvous", rank=rank,
                     world_size=2, backend="gloo")
    try:
        t0 = time.perf_counter()
        rows, shapes, tokens = tp_steps(get_config("zcode-m3-base"), dev, ctx)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(f"{d}/rank{rank}.json", "w") as f:
            json.dump({"rows": rows, "shapes": shapes, "tokens": tokens, "peak_gib": peak,
                       "seconds": time.perf_counter() - t0}, f)
    finally:
        close_group()
    return 0


def tp_two_ranks(full, dev):
    """Phase tp (b): the one-rank run of the two steps and the generate,
    its states freed, then the same under --mesh 1,2 in two processes on
    this card (gloo): losses, grad norms and balance within phase 6's f32
    bound of the one-rank run's, each rank's B1 launches per step at the
    d_ff / 2 shapes, the generated tokens equal."""
    import shutil
    ref_rows, ref_shapes, ref_tokens = tp_steps(full, dev, None)
    log(f"tp one-rank run done; device memory now allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    d = OUT / "tp_ranks"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-rank",
                               str(r), "--tp-dir", str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TP_RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"tp rank {r} failed (rc {p.returncode}):\n{text[-6000:]}")
    ranks = [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]
    want_launch = expected_train_launches(train_cfg(full, "cuda", "float32"), "cuda")
    f_half = str(full.moe.d_ff(full.d_ff) // 2)
    for r, rk in enumerate(ranks):
        for i, (got, ref) in enumerate(zip(rk["rows"], ref_rows)):
            worst = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6)
                     for k in ("loss", "grad_norm", "balance")}
            log(f"tp rank {r} step {i} ({'Gate-Drop' if got['gate_dropped'] else 'routed'}): "
                f"loss {got['loss']:.6f} (one rank {ref['loss']:.6f}), relative diff "
                + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                + f" (tol {TRAIN_METRIC_RTOL}); B1 launches {got['launches']}, streaming "
                f"{got['streamed']}; a2a calls {got['comm_a2a_calls']}")
            if (max(worst.values()) > TRAIN_METRIC_RTOL
                    or got["gate_dropped"] != ref["gate_dropped"]):
                raise AssertionError(f"tp rank {r} step {i}: differs from the one-rank run")
            if got["launches"] != want_launch or any(
                    got["streamed"][k] != got["launches"][k] for k in got["streamed"]):
                raise AssertionError(f"tp rank {r} step {i}: launches {got['launches']} "
                                     f"!= {want_launch}, or not all streaming")
        for name, shapes in rk["shapes"].items():
            if not shapes or any("2048" in s for s in shapes) or not any(
                    f_half in s for s in shapes):
                raise AssertionError(f"tp rank {r}: {name} saw shapes {shapes}, not the "
                                     f"d_ff / 2 = {f_half} slices")
        log(f"tp rank {r}: B1 input shapes {rk['shapes']}; peak device memory "
            f"{rk['peak_gib']:.2f} GiB; {rk['seconds']:.1f} s in the rank")
        if rk["tokens"] != ref_tokens:
            raise AssertionError(f"tp rank {r}: generated tokens {rk['tokens']} != the "
                                 f"one-rank run's {ref_tokens}")
    log(f"tp --mesh 1,2 on one card under gloo: 2 ranks, {len(TP_DECISIONS)} steps and a "
        f"greedy generate ({TP_GEN_ROWS} x {TP_GEN_PROMPT} prompt, {TP_GEN_NEW} new) each, "
        f"tokens equal the one-rank run's; {wall:.1f} s for both processes (start "
        "included); the one-rank B1 shapes were " + str(ref_shapes))
    shutil.rmtree(d, ignore_errors=True)
    return {"one_rank": ref_rows, "ranks": [{k: rk[k] for k in ("rows", "peak_gib", "seconds")}
                                            for rk in ranks],
            "tokens_equal": True, "wall_s": wall}


def tp_phase(full, dev):
    """Phase tp: the model axis on phase 6's seeded full-width
    zcode-m3-base (f32): B1 on its d_ff slices (m = 2, 4) checked and timed,
    then --mesh 1,2 on the one card."""
    t0 = time.perf_counter()
    sliced, timing = tp_sliced(full, dev)
    out = {"sliced": sliced, "timing": timing, "mesh_1x2": tp_two_ranks(full, dev)}
    out["seconds"] = time.perf_counter() - t0
    log(f"tp phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase obs: the observability layer over the main path
# ---------------------------------------------------------------------------

OBS_STEPS, OBS_CHUNK = 4, 2     # Trainer steps (two chunks), then one guarded chunk
OBS_BATCH = 8                   # static batching's batch size
OBS_WINDOW = 3                  # scheduler ticks in a profiler window
SPAN_CALLS = 200_000            # calls behind a span's ns per call
# pulls a steady tick or chunk may show beside its fetch: origin substring
# -> the reason (a PyTorch op with no sync-free form); none so far
SYNC_ALLOW: dict = {}


def obs_syncs(events):
    """(fetches, the card's syncs inside them, unsanctioned pulls) of one
    guarded tick or chunk, the allow list's entries set apart."""
    from repro_torch.analysis.hostsync import syncs
    fetches, bad = syncs(events)
    card = sum(e.method == "cuda_sync" and e.sanctioned for e in events)
    return fetches, card, [e for e in bad if not any(k in e.origin for k in SYNC_ALLOW)]


def sync_control():
    """The guard's positive control: ``nonzero`` reads its output's size
    back inside the op, which no Python hook sees; the card's sync debug
    mode must report it, attributed to this file."""
    from repro_torch.analysis.hostsync import guard_host_transfers, syncs
    x = torch.arange(8, device="cuda")
    events = []
    with guard_host_transfers(events=events):
        torch.nonzero(x > 3)
    _, bad = syncs(events)
    log(f"obs sync control: nonzero under the guard -> {bad}")
    if [e.method for e in bad] != ["cuda_sync"] or "chip_smoke.py" not in bad[0].origin:
        raise AssertionError(f"obs: the sync debug mode did not report nonzero: {events}")


def profiled_counts(label, win_path):
    """Launches per wrapper read from a profiler window's trace, held
    against the wrappers' counters over the same window."""
    from repro_torch.analysis.launches import kernel_counts, port_counts
    from repro_torch.kernels import launch_counts
    prof, wrap = port_counts(kernel_counts(win_path)), launch_counts()
    log(f"obs {label}: torch.profiler launches {prof}; the wrappers' counters {wrap}")
    if prof != wrap:
        raise AssertionError(f"obs {label}: profiler launches {prof} != wrappers' {wrap}")
    return prof


def obs_trainer(full, dev):
    """(a) The Trainer, tracer on, frame on: OBS_STEPS Gate-Drop 0.3 bf16
    steps on ``cuda`` in chunks of OBS_CHUNK, then one more chunk under the
    host-sync guard (and the sync debug mode) in a profiler window."""
    from repro_torch.analysis.hostsync import guard_host_transfers
    from repro_torch.data import MTTaskConfig, MultilingualMT, stack_batches
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.obs import Tracer
    from repro_torch.training import Trainer
    cfg = train_cfg(full, "cuda", "bfloat16")
    task = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=TRAIN_LANGS, max_len=TRAIN_SEQ))
    tracer = Tracer()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, train_tc(OBS_STEPS), task.train_batches(TRAIN_BATCH), device=dev,
                      chunk=OBS_CHUNK, log_every=1, log=None, tracer=tracer)
    _, history = trainer.run()
    doc = json.loads(json.dumps(tracer.export(str(OUT / "obs_train_trace.json"))))
    names = {ev["name"] for ev in doc["traceEvents"] if ev["ph"] != "M"}
    threads = {ev["args"]["name"] for ev in doc["traceEvents"] if ev["name"] == "thread_name"}
    want = {"train_chunk", "chunk.execute", "chunk.fetch", "prefetch.produce", "prefetch.wait"}
    if names != want or "prefetcher" not in threads:
        raise AssertionError(f"obs trainer: spans {names} on threads {threads}")
    if len(history) != OBS_STEPS or any(
            not {"router_entropy", "load_imbalance", "gate_dropped"} <= set(r)
            or not math.isfinite(r["loss"]) for r in history):
        raise AssertionError(f"obs trainer: records {history}")
    span = (OBS_STEPS, OBS_STEPS + OBS_CHUNK)
    stacked = stack_batches(trainer.batch_fn, *span)
    torch.cuda.synchronize()
    reset_launch_counts()
    events = []
    with tracer.profile_window(str(OUT / "obs_train_profile")) as win:
        with guard_host_transfers(events=events):
            trainer._run_chunk(span, stacked)
    fetches, card, bad = obs_syncs(events)
    counts = profiled_counts(f"training chunk of {OBS_CHUNK} steps", win.path)
    per_step = expected_train_launches(cfg, "cuda")
    if counts != {k: v * OBS_CHUNK for k, v in per_step.items()}:
        raise AssertionError(f"obs trainer: chunk launches {counts}, per step {per_step}")
    log(f"obs trainer: {OBS_STEPS} steps in {history[-1]['time_s']:.2f} s; records carry "
        f"load_imbalance {[round(r['load_imbalance'], 3) for r in history]}, gate_dropped "
        f"{[r['gate_dropped'] for r in history]}; spans {sorted(names)}; the guarded chunk: "
        f"{fetches} sanctioned fetch holding {card} card sync, {len(events)} events, "
        f"unsanctioned {bad}")
    if fetches != 1 or card != 1 or bad:
        raise AssertionError(f"obs trainer: a steady chunk must show its one fetch and no "
                             f"other sync: {fetches} fetches, {bad}")
    out = dict(setup_and_run_s=time.perf_counter() - t0, chunk_fetches=fetches,
               chunk_card_syncs=card, chunk_unsanctioned=len(bad), chunk_events=len(events), chunk_launches=counts,
               load_imbalance=[r["load_imbalance"] for r in history])
    del trainer
    torch.cuda.empty_cache()
    return out


def guard_each_tick(sched):
    """Run every tick of ``sched`` under the host-sync guard (record mode);
    returns the list the ticks fill with (steady, fetches, the card's
    syncs inside them, unsanctioned pulls). A steady tick decodes and
    neither admits, preempts nor swaps in."""
    from repro_torch.analysis.hostsync import guard_host_transfers
    ticks, step = [], sched.step

    def guarded(now):
        before = dict(sched.stats)
        events = []
        with guard_host_transfers(events=events):
            out = step(now)
        moved = any(sched.stats.get(k, 0) != before.get(k, 0)
                    for k in ("prefill_calls", "preemptions", "swap_ins"))
        steady = not moved and sched.stats["decode_steps"] == before["decode_steps"] + 1
        ticks.append((steady, *obs_syncs(events)))
        return out

    sched.step = guarded
    return ticks


def span_counts(doc):
    """Event counts by name of an exported trace, and the COW pairs its
    flushes carried."""
    evs = [ev for ev in doc["traceEvents"] if ev["ph"] != "M"]
    n = {}
    for ev in evs:
        n[ev["name"]] = n.get(ev["name"], 0) + 1
    return n, sum(ev["args"]["pairs"] for ev in evs if ev["name"] == "sched.cow_flush")


def obs_schedulers(params, cfg, gen, reqs):
    """(b) Phase 7's trace through the slot pool, the arena and the
    20-page arena with the tracer and the registry on, each tick guarded:
    the exported trace's counts against the scheduler's stats, the
    registry's exports, syncs per tick; then OBS_WINDOW ticks of each in a
    profiler window (launches against the wrappers')."""
    from repro_torch.launch.serve import write_metrics
    from repro_torch.obs import Tracer
    out = {}
    for tag, paged, n_pages in (("slot_pool", False, 0), ("arena", True, 0),
                                (f"arena_{PAGES_SMALL}", True, PAGES_SMALL)):
        tracer = Tracer()
        sched = new_scheduler(params, cfg, gen, paged, n_pages, tracer)
        ticks = guard_each_tick(sched)
        toks, sched, counts, wall = run_scheduler(params, cfg, gen, reqs, sched=sched)
        st, reg = sched.stats, sched.metrics
        reg.gauge("serve/wall_s").set(wall)
        reg.gauge("serve/tok_s").set(sum(len(t) for t in toks.values()) / wall)
        reg.gauge("serve/req_s").set(len(toks) / wall)
        for k, v in st.items():
            reg.gauge(f"serve/stats/{k}").set(float(v))
        write_metrics(reg, str(OUT / f"obs_{tag}.prom"))
        write_metrics(reg, str(OUT / f"obs_{tag}.json"))
        snap = json.loads((OUT / f"obs_{tag}.json").read_text())
        tracer.export(str(OUT / f"obs_{tag}_trace.json"))
        n, pairs = span_counts(json.loads((OUT / f"obs_{tag}_trace.json").read_text()))
        checks = {"sched.decode": st["decode_steps"], "sched.admit": None}
        if paged:
            checks.update({"prefix_cache.hit": st["prefix_hits"],
                           "sched.preempt.swap_out": st["preemptions"],
                           "sched.swap_in": st["swap_ins"]})
            hits_misses = n.get("prefix_cache.hit", 0) + n.get("prefix_cache.miss", 0)
            if hits_misses != st["prefix_lookups"] or pairs != st["cow_copies"]:
                raise AssertionError(f"obs {tag}: {n}, COW pairs {pairs} against {st}")
        else:
            checks["sched.prefill"] = st["prefill_calls"]
        bad = {k: (n.get(k, 0), v) for k, v in checks.items()
               if v is not None and n.get(k, 0) != v}
        if bad or snap["serve/stats/finished"]["value"] != TRACE_N or not n.get("sched.admit"):
            raise AssertionError(f"obs {tag}: span counts against stats (got, want) {bad}; {n}")
        steady = [t for t in ticks if t[0]]
        other = [t for t in ticks if not t[0]]
        wrong = [t for t in steady if t[1] != 1 or t[2] != 1 or t[3]]
        log(f"obs {tag}: {TRACE_N} requests in {wall:.2f} s; span counts {n} equal the stats "
            f"{st} (COW pairs {pairs}); registry {len(snap)} metrics exported; {len(steady)} "
            f"steady ticks with 1 sanctioned fetch (1 card sync) and no other sync each; "
            f"{len(other)} other ticks (admission / preemption / swap-in) with fetches "
            f"{sorted({t[1] for t in other})}, card syncs {sorted({t[2] for t in other})} "
            f"and unsanctioned {[t[3] for t in other if t[3]]}")
        if wrong or not steady:
            raise AssertionError(f"obs {tag}: steady ticks with other syncs {wrong[:3]}")
        out[tag] = dict(wall_s=wall, spans=n, steady_ticks=len(steady),
                        other_ticks=len(other), other_fetches=sorted({t[1] for t in other}),
                        other_card_syncs=sorted({t[2] for t in other}),
                        unsanctioned_other=sum(len(t[3]) for t in other), stats=dict(st))
    for tag, paged in (("slot_pool", False), ("arena", True)):
        out[tag]["window_launches"] = tick_window(params, cfg, gen, reqs, paged, tag)
    return out


def tick_window(params, cfg, gen, reqs, paged, tag):
    """OBS_WINDOW ticks of a fresh scheduler, after its first admissions,
    in a profiler window: the launches against the wrappers' counters."""
    import dataclasses as dc
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.obs import Tracer
    tracer = Tracer()
    sched = new_scheduler(params, cfg, gen, paged, 0, tracer)
    for r in reqs:
        sched.submit(dc.replace(r))
    for _ in range(3):
        sched.step(sched._now())
    torch.cuda.synchronize()
    reset_launch_counts()
    with tracer.profile_window(str(OUT / f"obs_{tag}_profile")) as win:
        for _ in range(OBS_WINDOW):
            sched.step(sched._now())
    return profiled_counts(f"{tag}, {OBS_WINDOW} ticks", win.path)


def obs_static(params, cfg, gen, reqs):
    """(c) Table 8's comparison point: ``static_batch_serve`` (FIFO
    same-length batches of OBS_BATCH through ``generate``) and the
    ContinuousScheduler on the same trace, one after the other. A number,
    not a claim."""
    from repro_torch.serve import static_batch_serve
    rows = {"static": [], "continuous": []}
    for kind in ("static", "continuous"):
        if kind == "static":
            torch.cuda.synchronize()
            toks, wall = static_batch_serve(params, cfg, gen, reqs, batch_size=OBS_BATCH,
                                            max_seq=SCHED_BUCKETS[-1] + gen.max_new)
        else:
            toks, _, _, wall = run_scheduler(params, cfg, gen, reqs)
        n_tok = sum(len(t) for t in toks.values())
        rows[kind].append(dict(wall_s=wall, tok_s=n_tok / wall, tokens=toks))
    equal = sum(bool((rows["static"][0]["tokens"][r.rid] == rows["continuous"][0]["tokens"]
                      [r.rid]).all()) for r in reqs)
    out = {k: dict(wall_s=[r["wall_s"] for r in v], tok_s=[r["tok_s"] for r in v])
           for k, v in rows.items()}
    lengths = sorted({len(r.tokens) for r in reqs})
    log(f"obs static batching (batch {OBS_BATCH}; {len(lengths)} distinct prompt lengths) vs "
        f"the continuous scheduler, one after the other: wall s static {out['static']['wall_s']} "
        f"continuous {out['continuous']['wall_s']}; tokens/s static {out['static']['tok_s']} "
        f"continuous {out['continuous']['tok_s']}; {equal} of {TRACE_N} requests get the "
        "scheduler's tokens (capacity depends on the batch's makeup: reported, not gated)")
    out["equal_requests"] = equal
    return out


def obs_tracer_cost(params, cfg, gen, reqs):
    """(d) A slot-pool replay with the tracer on, then off, and a span's
    cost in ns per call, off and on."""
    from repro_torch.obs import Tracer
    walls = {True: [], False: []}
    for on in (True, False):
        _, _, _, wall = run_scheduler(params, cfg, gen, reqs, tracer=Tracer(enabled=on))
        walls[on].append(wall)
    ns = {}
    for on in (False, True):
        tr = Tracer(enabled=on)
        t0 = time.perf_counter()
        for _ in range(SPAN_CALLS):
            with tr.span("sched.decode", alive=8):
                pass
        ns[on] = (time.perf_counter() - t0) / SPAN_CALLS * 1e9
    log(f"obs tracer cost: slot-pool replay wall s with the tracer on {walls[True]}, then "
        f"off {walls[False]}; a span {ns[False]:.1f} ns per call off, {ns[True]:.1f} "
        "ns on")
    return dict(replay_on_s=walls[True], replay_off_s=walls[False], span_off_ns=ns[False],
                span_on_ns=ns[True])


def obs_phase(full, dev):
    """Phase obs: the tracer, the registry, the host-sync guard and the
    profiler's launch counts over the main path at full width, then the
    static-batching baseline and the tracer's cost."""
    from repro_torch.launch.serve import generator
    from repro_torch.models import init_model
    from repro_torch.serve import GenerateConfig
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    sync_control()
    cfg = dataclasses.replace(full, moe=dataclasses.replace(full.moe, backend="cuda"))
    params = init_model(generator(dev, SEED, 0), cfg)
    reqs = sched_trace(cfg.vocab)
    gen = GenerateConfig(max_new=TRACE_BUDGET, eos_id=-1, flash_decode=True)
    out = {"schedulers": obs_schedulers(params, cfg, gen, reqs)}
    out["static_vs_continuous"] = obs_static(params, cfg, gen, reqs)
    out["tracer_cost"] = obs_tracer_cost(params, cfg, gen, reqs)
    del params
    torch.cuda.empty_cache()
    out["trainer"] = obs_trainer(full, dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"obs phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 7: the serving schedulers and B6
# ---------------------------------------------------------------------------

def sched_trace(vocab: int, sources: bool = True):
    """TRACE_N requests queued at t = 0, drawn from seed SEED + 7: budgets
    uniform over [2, TRACE_BUDGET], SRC_TOKENS source tokens each (drawn
    and left out with ``sources=False``: the decoder-only archs). Odd
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
                            extras={"enc_tokens": src.astype(np.int64)} if sources else {},
                            max_new=budget, arrival=0.0))
    return reqs


def new_scheduler(params, cfg, gen, paged=None, n_pages=0, tracer=None):
    """A fresh scheduler of phase 7's shape: the slot pool, or the page
    arena when ``paged`` (``n_pages`` pages, 0 for the default 48)."""
    from repro_torch.configs import PagedKVConfig
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import ContinuousScheduler, PagedScheduler
    kw = dict(n_slots=SCHED_SLOTS, prefill_buckets=SCHED_BUCKETS, admit_width=SCHED_ADMIT,
              registry=MetricsRegistry(), tracer=tracer)
    if paged:
        return PagedScheduler(params, cfg, gen, paged=PagedKVConfig(
            page_size=PAGE_SIZE, n_slots_equiv=SCHED_SLOTS, n_pages=n_pages), **kw)
    return ContinuousScheduler(params, cfg, gen, **kw)


def run_scheduler(params, cfg, gen, reqs, paged=None, n_pages=0, tracer=None, sched=None):
    """Serve ``reqs`` through ``sched`` or a fresh ``new_scheduler``, with
    the launch counts reset just before and read just after. Returns
    ({rid: tokens}, scheduler, launch counts, wall seconds)."""
    import dataclasses as dc
    from repro_torch.kernels import launch_counts, reset_launch_counts
    if sched is None:
        sched = new_scheduler(params, cfg, gen, paged, n_pages, tracer)
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
    """Each request's tokens ``want`` ({rid: tokens}) against one-shot B=1
    ``generate`` at the pool's cache length (``against_oneshot``).
    Returns (#equal, gaps)."""
    return against_oneshot(params, cfg, gen, reqs, {"": want}, max_seq, dev)[""]


def against_oneshot(params, cfg, gen, reqs, runs, max_seq, dev):
    """Each request's tokens of every run in ``runs`` ({label: {rid:
    tokens}}) against one-shot B=1 ``generate`` at the pool's cache
    length. A divergence must be a near-tie: the top-two gap of the
    one-shot logits at the first differing token, read by feeding the
    common prefix, is under NEAR_TIE. Returns {label: (#equal, gaps)}."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import generate
    out = {label: [0, []] for label in runs}
    for r in reqs:
        batch = {"tokens": torch.as_tensor(r.tokens[None], device=dev),
                 **{k: torch.as_tensor(v[None], device=dev) for k, v in r.extras.items()}}
        one = generate(params, batch, cfg, dataclasses.replace(
            gen, max_new=r.max_new, max_seq=max_seq)).tokens[0].cpu().numpy()
        for label, toks in runs.items():
            if (one == toks[r.rid]).all():
                out[label][0] += 1
                continue
            t = int((one != toks[r.rid]).argmax())
            with torch.no_grad():
                lg, caches = prefill(params, batch, cfg, max_seq=max_seq)
                for i in range(t):
                    lg, caches = decode_step(params, caches,
                                             torch.as_tensor([[int(one[i])]], device=dev),
                                             len(r.tokens) + i, cfg, flash_decode=True)
            top = lg[0, -1].float().topk(2).values
            out[label][1].append((r.rid, t, float(top[0] - top[1])))
    return {k: tuple(v) for k, v in out.items()}


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
                admit_ms=statistics.median(tracer.durations("sched.admit")) * 1e3))
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

# ---------------------------------------------------------------------------
# phase dec: the decoder-only family with full attention
# ---------------------------------------------------------------------------

DBRX_LAYERS = 2          # dbrx-132b's depth cut: at 40 layers (131.6 B) it fits no H100
EAGER_ROUNDS = 1         # timed generate rounds of the models that decode at 20-170 ms a
                         # step eagerly (yi-6b, starcoder2, mamba2, hymba, llama-3.2-vision,
                         # whisper); the serving CLI's 5 elsewhere
LM_STEPS = 3             # reduced --task lm steps (phases dec, mla); seed 0's drop
LM_BATCH, LM_SEQ = 16, 64  # bits are 0, 0, 1
HEAVY_DEPTH = (2, 5)     # device_ms depth at dbrx's prefill sites (tens of ms a call)
SHARE_OVER = 1 << 30     # captured tensors kept by reference past 1 GiB (expert weights)


def dec_cfg(arch: str, backend=None, dtype=None):
    """The arch at full width (dbrx-132b at DBRX_LAYERS layers), its MoE
    on ``backend``, activations in ``dtype`` (default the config's)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == "dbrx-132b":
        cfg = dataclasses.replace(cfg, n_layers=DBRX_LAYERS)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if backend and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, backend=backend))
    return cfg


def dec_model(cfg, dev, rows=BATCH, prompt=PROMPT):
    """Seeded weights on the card and a batch of ``rows`` x ``prompt``
    tokens (default 8 x 32)."""
    from repro_torch.launch.serve import generator, synth_batch
    from repro_torch.models import init_model
    t0 = time.perf_counter()
    params = init_model(generator(dev, SEED, 0), cfg)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    heads = (f"{cfg.n_heads} MLA heads (ranks {cfg.mla.q_lora_rank}/{cfg.mla.kv_lora_rank}, "
             f"head dims {cfg.mla.qk_nope_head_dim}/{cfg.mla.qk_rope_head_dim}/"
             f"{cfg.mla.v_head_dim})" if cfg.mla is not None else
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}")
    if cfg.ssm is not None:
        s = cfg.ssm
        ssd = (f"{s.n_heads(cfg.d_model)} SSD heads of {s.head_dim}, state {s.d_state}, "
               f"chunk {s.chunk}")
        heads = ssd if cfg.family == "ssm" else (
            f"{heads} beside {ssd}, {cfg.n_meta} meta tokens, window {cfg.sliding_window} "
            f"but at layers {cfg.hybrid.global_attn_layers}")
    log(f"dec model: {cfg.arch_id} at {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{heads}: {n / 1e9:.3f} B params "
        f"(analytic {cfg.n_params() / 1e9:.3f} B), {n * 4 / 1e9:.1f} GB in f32, init "
        f"{time.perf_counter() - t0:.1f} s")
    return params, synth_batch(cfg, generator(dev, SEED, 1), rows, prompt)


def dec_generate(label, params, batch, cfg, gen, expect):
    """One counted ``generate`` after a warm-up: the launch counts equal
    ``expect(steps)`` (every other wrapper 0), the tokens are in range.
    Returns (counts, streaming counts, result)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import generate
    generate(params, batch, cfg, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = generate(params, batch, cfg, gen)
    torch.cuda.synchronize()
    counts, streamed = launch_counts(), streamed_counts()
    want = {**{k: 0 for k in counts}, **expect(res.steps)}
    log(f"dec {label}: launches {counts}, expected {want}; streaming {streamed}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != want:
        raise AssertionError(f"dec {label}: launches {counts} != {want}")
    toks = res.tokens
    if toks.shape != (batch["tokens"].shape[0], gen.max_new) or \
            not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"dec {label}: bad tokens {tuple(toks.shape)}")
    log(f"dec {label}: first row {toks[0].tolist()} ({len(set(toks.flatten().tolist()))} "
        "distinct tokens in the batch)")
    return counts, streamed, res


def dec_timed(label, params, batch, cfg, gen, n_rounds=None):
    """The serving CLI's timed rounds (median and spread): its
    TIMED_ROUNDS, or ``n_rounds``."""
    from repro_torch.launch.serve import TIMED_ROUNDS, spread, time_generate
    n_rounds = n_rounds or TIMED_ROUNDS
    med, rounds, _ = time_generate(params, batch, cfg, gen, n_rounds=n_rounds)
    rows, plen = batch["tokens"].shape
    log(f"dec {label}: median of {n_rounds} rounds [min, max] ({rows} x {plen} prompt "
        f"tokens, {gen.max_new - 1} decode steps): prefill {med['prefill_ms']:.2f} ms "
        f"{spread(rounds['prefill_ms'])}, decode {med['decode_ms_per_step']:.2f} ms/step "
        f"{spread(rounds['decode_ms_per_step'])}, total {med['total_ms']:.2f} ms "
        f"{spread(rounds['total_ms'])}, {med['tok_s']:.0f} tokens/s {spread(rounds['tok_s'])}")
    return dict(median=med, rounds=rounds)


def dec_site(label, name, site, args, depth=()):
    """A kernel at one captured site: against its plain version (B2
    bitwise; B1 also bitwise on a second run), then ``time_site``."""
    out, _ = run_kernel(name, args)
    torch.cuda.synchronize()
    err = check(f"{label} {name}@{site}", out, plain_of(name)(*args), exact=name == "dispatch")
    if name in B1_STREAMED:
        check(f"{label} {name}@{site} second run", kernel_of(name)(*args), out, exact=True)
    return dict(time_site(name, site, args, f"{label} ", depth), max_abs_err=err)


def tiled_bwd_sites(label, args, depth=()):
    """B1's dx and dW on the tiled kernel at a full-width prefill site: the
    forward's captured (x, w) and a seeded dy of its output's shape, each
    against its plain version and bitwise on a second run, then timed in
    turns with torch.bmm on the w^T and x^T views (``dec_site``)."""
    x, w = args
    g = torch.Generator(device=x.device).manual_seed(SEED + 41)
    dy = torch.randn(x.shape[0], x.shape[1], w.shape[2], generator=g,
                     device=x.device).to(x.dtype)
    out = {}
    for name, a in (("grouped_matmul_dx", (dy, w)), ("grouped_matmul_dw", (x, dy))):
        if b1_variant(name, a) != "tiled":
            raise AssertionError(f"{label} {name}: {b1_variant(name, a)}, not tiled")
        out[name] = dec_site(label, name, "prefill", a, depth)
    return out


def dec_schedulers(params, cfg, dev):
    """yi-6b's trace through the slot pool (B5) and the page arena (B6)
    once each, f32 activations: per-request tokens equal; launches per run
    one B5 or B6 per layer per decode tick; B6 at its captured first
    decode tick against its plain version, bitwise B5 on the gathered
    cache, and timed. Returns (B6 timing, launches, max abs err, stats)."""
    from repro_torch.serve import GenerateConfig
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = GenerateConfig(max_new=TRACE_BUDGET, eos_id=-1, flash_decode=True)
    reqs = sched_trace(cfg.vocab, sources=False)
    slot, ss, c_slot, w_slot = run_scheduler(params, cfg32, gen, reqs)
    with Capture(names=("flash_decode_paged",)) as cap:
        paged, ps, c_paged, w_paged = run_scheduler(params, cfg32, gen, reqs, paged=True)
    for label, st, c, key in (("slot pool", ss.stats, c_slot, "flash_decode"),
                              ("paged", ps.stats, c_paged, "flash_decode_paged")):
        want = {k: 0 for k in c}
        want[key] = cfg.n_layers * st["decode_steps"]
        log(f"dec yi-6b {label} f32: {st}; launches {c}, expected {want}")
        if c != want or st["finished"] != TRACE_N:
            raise AssertionError(f"dec yi-6b {label}: launches {c} != {want} or {st}")
    bad = [r.rid for r in reqs if not (paged[r.rid] == slot[r.rid]).all()]
    if bad:
        raise AssertionError(f"dec yi-6b: paged and slot-pool tokens differ for {bad}")
    if ps.stats["prefix_hits"] == 0:
        raise AssertionError(f"dec yi-6b: no prefix hit on a shared-prefix trace {ps.stats}")
    log(f"dec yi-6b f32: the {TRACE_N} requests' tokens equal across the slot pool (B5, "
        f"{w_slot:.2f} s) and the page arena (B6, {w_paged:.2f} s); prefix hits "
        f"{ps.stats['prefix_hits']} on the prompt alone")
    args = cap.calls["flash_decode_paged"][0][0]
    del cap
    err = b6_checks([args], dev)
    return b6_timing(args), c_paged["flash_decode_paged"], err, dict(ps.stats)


def dec_yi(dev):
    """yi-6b at full width and depth: counted and timed generate through
    B5, B5 at the decode site, the f32 gate, the schedulers."""
    from repro_torch.serve import GenerateConfig, generate
    cfg = dec_cfg("yi-6b")
    params, batch = dec_model(cfg, dev)
    gen = GenerateConfig(max_new=MAX_NEW, eos_id=-1, flash_decode=True)
    counts, _, _ = dec_generate("yi-6b", params, batch, cfg, gen,
                                lambda steps: {"flash_decode": cfg.n_layers * steps})
    timed = dec_timed("yi-6b", params, batch, cfg, gen, EAGER_ROUNDS)
    with Capture(names=("flash_decode",)) as cap:
        generate(params, batch, cfg, dataclasses.replace(gen, max_new=2))
    torch.cuda.synchronize()
    sites = {"decode": dec_site("yi-6b", "flash_decode", "decode",
                                cap.calls["flash_decode"][-1][0])}
    del cap
    graph = decode_graph("dec yi-6b", params, batch, cfg, timed["median"]["decode_ms_per_step"],
                         dev)
    gemm = dense_gemm("yi-6b", params)
    e2e = e2e_phase(params, batch, cfg, gen, dev, label="dec yi-6b e2e")
    b6, b6_launches, b6_err, stats = dec_schedulers(params, cfg, dev)
    del params, batch
    torch.cuda.empty_cache()
    return dict(launches=counts["flash_decode"], sites=sites, serve=timed,
                e2e_logit_diff=dict(prefill=e2e[0], decode=e2e[1]),
                decode_graph_ms=graph, ffn_gemm=gemm,
                paged=dict(site=b6, launches=b6_launches, max_abs_err=b6_err, stats=stats))


def dense_gemm(label, params):
    """One decode-step GEMM of the first dense FFN, (8, d) x (d, d_ff) in
    f32 as the model runs it (activations cast to the f32 weights, no
    TF32), against the bytes of its weight: where a dense decode step's
    device time goes."""
    w = params["decoder"][0]["p0"]["ffn"]["w_in"][0]
    x = torch.randn(BATCH, w.shape[0], device=w.device)
    ms = device_ms(lambda: x @ w)
    b_ms, b_by = bound(w.numel() * 4 + x.numel() * 4 + BATCH * w.shape[1] * 4,
                       2.0 * BATCH * w.numel(), "float32")
    log(f"time {label} FFN GEMM at decode [(8, {w.shape[0]}) x {tuple(w.shape)} f32, cuBLAS]: "
        f"{ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}; {b_ms / ms * 100:.1f}% of it)")
    return dict(ms=ms, bound_ms=b_ms, bound_by=b_by, shape=f"(8, {w.shape[0]}) x {tuple(w.shape)}")


def dbrx_expect(backend: str, cfg):
    """Launches of one dbrx ``generate`` of ``steps`` decode steps: each
    MoE layer once at prefill and once per step (B2, three B1 (gated) and
    B3 on ``cuda``; B4 on ``cuda_fused``), B5 per layer per step."""
    n_moe = sum(cfg.moe.is_moe_layer(i) for i in range(cfg.n_layers))

    def expect(steps):
        calls = n_moe * (1 + steps)
        out = {"flash_decode": cfg.n_layers * steps}
        if backend == "cuda":
            out.update(dispatch=calls, combine=calls, grouped_matmul=3 * calls)
        else:
            out.update(fused_moe=calls)
        return out
    return expect, n_moe


def dec_dbrx(dev):
    """dbrx-132b at full width, DBRX_LAYERS layers: counted and timed
    generates through cuda and cuda_fused with B5 (B1 and B4 streaming at
    decode, tiled at prefill), every kernel at its captured prefill and
    decode sites, the f32 gates (kernel vs plain logits; the tokens of the
    two backends equal up to near-ties)."""
    from repro_torch.serve import GenerateConfig, generate
    cfg = dec_cfg("dbrx-132b", "cuda")
    fused = dec_cfg("dbrx-132b", "cuda_fused")
    params, batch = dec_model(cfg, dev)
    gen = GenerateConfig(max_new=MAX_NEW, eos_id=-1, flash_decode=True)
    out = {"layers": cfg.n_layers, "serve": {}, "sites": {}, "launches": {}}
    for backend, c in (("cuda", cfg), ("cuda_fused", fused)):
        expect, n_moe = dbrx_expect(backend, c)
        counts, streamed, res = dec_generate(f"dbrx-132b {backend}", params, batch, c, gen,
                                             expect)
        steps = res.steps
        name = "grouped_matmul" if backend == "cuda" else "fused_moe"
        per_call = 3 if backend == "cuda" else 1
        # decode calls take the streaming kernel (C = 4), prefill calls the tiled one (C = 128)
        want_streamed = per_call * n_moe * steps
        if streamed[name] != want_streamed:
            raise AssertionError(f"dbrx {backend}: {streamed[name]} of {counts[name]} {name} "
                                 f"streaming, expected {want_streamed} (the prefill's "
                                 f"{per_call * n_moe} tiled)")
        out["launches"][backend] = {k: v for k, v in counts.items() if v}
        out["launches"][backend]["streaming"] = streamed[name]
    runs = {"cuda": [], "cuda_fused": []}
    for backend in ("cuda", "cuda_fused", "cuda_fused", "cuda"):
        runs[backend].append(dec_timed(f"dbrx-132b {backend} (in turns)", params, batch,
                                       fused if backend == "cuda_fused" else cfg, gen))
    out["serve"] = runs
    out["decode_graph_ms"] = {
        name: decode_graph(f"dec dbrx-132b {name}", params, batch, c,
                           sum(r["median"]["decode_ms_per_step"] for r in runs[name]) / 2, dev)
        for name, c in (("cuda", cfg), ("cuda_fused", fused))}

    # every kernel at its prefill and decode sites
    with Capture(names=("dispatch", "combine", "grouped_matmul", "flash_decode"),
                 share_over=SHARE_OVER) as cap:
        generate(params, batch, cfg, dataclasses.replace(gen, max_new=2))
    torch.cuda.synchronize()
    calls = cap.calls
    del cap
    for name in ("dispatch", "grouped_matmul", "combine", "flash_decode"):
        sites = [("decode", calls[name][-1][0])]
        if name != "flash_decode":
            sites.insert(0, ("prefill", calls[name][0][0]))
        for site, args in sites:
            if name == "grouped_matmul":
                want = "tiled" if site == "prefill" else "streaming"
                if b1_variant(name, args) != want:
                    raise AssertionError(f"dbrx B1@{site}: {b1_variant(name, args)}, not {want}")
            if name == "combine":
                t = combine_site(f"dbrx {site}", args)
            else:
                t = dec_site("dbrx-132b", name, site, args,
                             HEAVY_DEPTH if site == "prefill" else ())
            out["sites"][(name, site)] = t
            if name == "grouped_matmul" and site == "prefill":
                for bname, bt in tiled_bwd_sites("dbrx-132b", args, HEAVY_DEPTH).items():
                    out["sites"][(bname, "prefill")] = bt
    del calls
    with Capture(names=("fused_moe",), share_over=SHARE_OVER) as cap:
        generate(params, batch, fused, dataclasses.replace(gen, max_new=2))
    torch.cuda.synchronize()
    calls = cap.calls["fused_moe"]
    del cap
    for site, i, want in (("prefill", 0, "tiled"), ("decode", -1, "streaming")):
        t = b4_site(f"dbrx {site}", *calls[i], depth=HEAVY_DEPTH if site == "prefill" else ())
        if t["variant"] != want:
            raise AssertionError(f"dbrx B4@{site}: {t['variant']}, not {want}")
        out["sites"][("fused_moe", site)] = t
    del calls
    torch.cuda.empty_cache()

    # f32: the kernel path against the plain path, and the two backends' tokens
    e2e = e2e_phase(params, batch, cfg, gen, dev, label="dec dbrx-132b e2e")
    out["e2e_logit_diff"] = dict(prefill=e2e[0], decode=e2e[1])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    a = generate(params, batch, cfg32, gen).tokens
    b = generate(params, batch, dataclasses.replace(fused, dtype="float32"), gen).tokens
    gaps = near_tie_gaps(params, batch, cfg32, a, b, dev)
    log(f"dec dbrx-132b f32: cuda_fused tokens equal the cuda backend's on "
        f"{float((a == b).float().mean()) * 100:.1f}% of {a.numel()} (B4 adds a token's "
        f"top-4 rows with atomics); divergences (row, first token, top-two logit gap): {gaps}")
    if any(gap >= NEAR_TIE for _, _, gap in gaps):
        raise AssertionError(f"dbrx cuda_fused vs cuda: a divergence is not a near-tie: {gaps}")
    out["fused_vs_cuda_gaps"] = gaps
    del params, batch
    torch.cuda.empty_cache()
    return out


def lm_steps(label, base, n_steps, batch_rows, seq, keys, dev):
    """``base`` (a reduced config), --task lm: ``n_steps`` Gate-Drop 0.3
    steps (f32) on the plain oracle path, cuda_fused and cuda from one
    seed, gated as phase 6 gates them: the metrics ``keys`` within
    TRAIN_METRIC_RTOL of the plain path's, the parameters within
    ``adam_drift_bound``; the kernel backends' launches per step."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.gating_dropout import drop_decisions_host
    from repro_torch.data import LMTaskConfig, SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import generator
    from repro_torch.models import init_model
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.loop import to_device
    from repro_torch.tree import flatten_with_paths

    task = SyntheticLM(LMTaskConfig(vocab=base.vocab, seq_len=seq))
    batches = [to_device(task.sample_batch(i, batch_rows), dev) for i in range(n_steps)]
    tc = TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, seed=SEED, steps=n_steps)
    bits = drop_decisions_host(base.moe.gating_dropout, SEED, 0, n_steps)
    if bits.all() or not bits.any():
        raise AssertionError(f"{label}: the steps must include a routed and a dropped step "
                             f"{bits}")
    param_tol = adam_drift_bound(tc, n_steps)
    ref, out = None, {"bits": bits.astype(int).tolist()}
    for backend in ("oracle", "cuda_fused", "cuda"):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, backend=backend))
        state = init_train_state(init_model(generator(dev, SEED, 0), cfg), tc)
        step = make_train_step(cfg, tc)
        rows, launches = [], []
        for i in range(n_steps):
            reset_launch_counts()
            state, m = step(state, batches[i])
            torch.cuda.synchronize()
            launches.append({k: v for k, v in launch_counts().items() if v})
            rows.append({k: float(m[k]) for k in keys + ("gate_dropped",)})
        params = {k: v.detach() for k, v in flatten_with_paths(state["params"]).items()}
        log(f"{label} {backend} f32 ({base.arch_id} reduced, {batch_rows} x {seq} tokens): "
            + "; ".join(", ".join(f"{k} {r[k]:.6f}" for k in keys)
                        + f" dropped {int(r['gate_dropped'])}" for r in rows)
            + f"; launches per step {launches}")
        if not all(math.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"{label} {backend}: non-finite metrics")
        if backend == "cuda_fused" and not all(la.get("fused_moe") for la in launches):
            raise AssertionError(f"{label} cuda_fused: a step without B4 {launches}")
        if backend == "cuda" and not all(la.get("grouped_matmul") and la.get("dispatch")
                                         and la.get("grouped_matmul_dw") for la in launches):
            raise AssertionError(f"{label} cuda: a step without the pipeline {launches}")
        out[backend] = dict(rows=rows, launches=launches)
        if ref is None:
            ref = (rows, params)
            continue
        worst = max(abs(r[k] - q[k]) / max(abs(q[k]), 1e-6)
                    for r, q in zip(rows, ref[0]) for k in keys)
        pmax = max(float((params[k] - ref[1][k]).abs().max()) for k in params)
        log(f"{label} {backend} vs plain: max relative diff {worst:.3e} (tol "
            f"{TRAIN_METRIC_RTOL}), parameters max abs diff {pmax:.3e} (tol {param_tol:.3e})")
        if worst > TRAIN_METRIC_RTOL or pmax > param_tol or \
                [r["gate_dropped"] for r in rows] != [q["gate_dropped"] for q in ref[0]]:
            raise AssertionError(f"{label} {backend}: differs from the plain path")
        out[backend].update(max_rel_diff=worst, param_max_abs_diff=pmax)
    return out


def dec_train(dev):
    """Reduced dbrx-132b, --task lm: LM_STEPS Gate-Drop 0.3 steps through
    ``lm_steps``."""
    from repro_torch.configs import get_config, reduced
    return lm_steps("dec lm", reduced(get_config("dbrx-132b")), LM_STEPS, LM_BATCH, LM_SEQ,
                    ("loss", "grad_norm", "balance"), dev)


def dec_phase(dev, b4_info):
    """Phase dec: yi-6b (full width and depth), then dbrx-132b (full
    width, DBRX_LAYERS layers), then reduced dbrx-132b's --task lm steps;
    each model's tensors freed before the next. ``b4_info`` is
    ``b4_report``'s; its tiled variants at C = 128 go in the record."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    yi = dec_yi(dev)
    log(f"dec yi-6b: {time.perf_counter() - t0:.1f} s; device memory now allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t1 = time.perf_counter()
    dbrx = dec_dbrx(dev)
    log(f"dec dbrx-132b: {time.perf_counter() - t1:.1f} s")
    lm = dec_train(dev)
    log(f"dec phase: {time.perf_counter() - t0:.1f} s")
    return {"yi-6b": yi, "dbrx-132b": dbrx, "lm": lm,
            "b4_tiled": {k: v[128] for k, v in b4_info.items() if k.startswith("tiled")}}


def dec_json(dec):
    """Phase dec's results with its site keys as strings."""
    out = json.loads(json.dumps({k: v for k, v in dec.items() if k != "dbrx-132b"}))
    dbrx = dict(dec["dbrx-132b"])
    dbrx["sites"] = {f"{n}@{s}": t for (n, s), t in dbrx["sites"].items()}
    out["dbrx-132b"] = dbrx
    return out


def dec_rows(dec):
    """Per kernel, its phase-dec sites for the kernel table."""
    yi, dbrx = dec["yi-6b"], dec["dbrx-132b"]
    rows = {name: {} for name in REPLACES}
    rows["flash_decode"]["yi-6b decode"] = dict(yi["sites"]["decode"],
                                                launches=yi["launches"])
    rows["flash_decode_paged"]["yi-6b paged decode"] = dict(
        yi["paged"]["site"], launches=yi["paged"]["launches"],
        max_abs_err=yi["paged"]["max_abs_err"])
    for (name, site), t in dbrx["sites"].items():
        backend = "cuda_fused" if name == "fused_moe" else "cuda"
        # dx and dW: none per generate (timed at the prefill forward's shapes)
        rows[name][f"dbrx-132b {site}"] = dict(
            {k: v for k, v in t.items() if k != "host_ms"},
            launches=dbrx["launches"][backend].get(name, 0))
    return {k: v for k, v in rows.items() if v}


# ---------------------------------------------------------------------------
# phase swa: sliding-window attention and long prompts
# ---------------------------------------------------------------------------

SWA_ROWS, SWA_PROMPT = 2, 4608    # past the 4,096-token window and 2 x 1,024 keys
DANUBE_LAYERS = 4                 # h2o-danube-3-4b's depth cut (24 layers, 15.8 GB, fit;
                                  # the cut keeps the phase short)
SWA_EXACT_LENS = (64, 1500, 4200, 4800)     # phase swa (b): one admission group each
SWA_EXACT_BUCKETS = (64, 1024, 8192)        # the largest past the window: exact prefill
SWA_EXACT_NEW = 8
YI_LONG_PROMPT = 3584             # yi-6b: a 3,616-position cache within max_seq 4,096
YI_PAGED_NEW = 16
DBRX_LONG_PROMPT = 2304           # dbrx-132b: past 2 x 1,024 keys, C = 1,152 at top-4
SWA_HEAVY_DEPTH = (1, 3)          # device_ms depth at dbrx's long prefill (~0.1-0.3 s a call)
SWA_BANDED_LEN = 12288            # 3 x starcoder2's window: past the banded_swa switch (2 x window)


@contextlib.contextmanager
def quadratic_attention():
    """Prefill and training attention through the quadratic path at every
    length, the window's mask included: the blocked path's yardstick."""
    from repro_torch.models import attention as A
    real = A.flash_attention

    def quadratic(q, k, v, *, causal, window=0, q_offset=0, chunk=1024):
        return A.full_attention(q, k, v, causal=causal, window=window,
                                qpos=q_offset + torch.arange(q.shape[1], device=q.device))

    A.flash_attention = quadratic
    try:
        yield
    finally:
        A.flash_attention = real


@torch.no_grad()
def blocked_gate(label, params, batch, cfg, max_seq):
    """f32 prefill logits through the blocked flash attention against the
    quadratic path with the window's mask. Returns (max abs diff, the
    blocked prefill's caches, its logits)."""
    from repro_torch.models import prefill
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    lb, caches = prefill(params, batch, cfg32, max_seq=max_seq)
    with quadratic_attention():
        lq, _ = prefill(params, batch, cfg32, max_seq=max_seq)
    if not (torch.isfinite(lb).all() and torch.isfinite(lq).all()):
        raise AssertionError(f"{label}: non-finite f32 prefill logits")
    d = float((lb - lq).abs().max())
    log(f"{label} f32: prefill logits {tuple(lb.shape)} (max |logit| {float(lq.abs().max()):.3f}), "
        f"blocked flash vs quadratic attention max abs diff {d:.3e} (tol {E2E_LOGIT_ATOL})")
    if d > E2E_LOGIT_ATOL:
        raise AssertionError(f"{label}: blocked prefill logits differ by {d}")
    return d, caches, lb


@torch.no_grad()
def ring_gate(label, params, batch, cfg, dev):
    """f32: the blocked prefill against the quadratic one (an arch that
    attends; mamba2-1.3b does not), then N_FORCED teacher-forced decode
    steps through the decode caches (a slot pool, per-row positions: the
    rings, an SSM's state) against ``model_apply``'s logits at the same
    positions over the prompt and the forced tokens, and the prefill's
    logits against ``model_apply``'s at the prompt's last position."""
    from repro_torch.models import model_apply, prefill
    from repro_torch.models.model import head_matrix
    from repro_torch.serve.engine import decode_pool_step
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rows, plen = batch["tokens"].shape
    if cfg.family == "ssm":
        d_pre = None
        lb, caches = prefill(params, batch, cfg32, max_seq=plen + N_FORCED)
    else:
        d_pre, caches, lb = blocked_gate(label, params, batch, cfg, plen + N_FORCED)
    pool = _pool(cfg32, caches, dev, rows)
    del caches
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    forced = torch.randint(3, cfg.vocab, (rows, N_FORCED), generator=g, device=dev)
    alive = torch.ones(rows, dtype=torch.bool, device=dev)
    got = []
    for i in range(N_FORCED):
        pos = torch.full((rows,), plen + i, device=dev)
        lg, pool = decode_pool_step(params, pool, forced[:, i], pos, alive, cfg32,
                                    flash_decode=True)
        got.append(lg)
    del pool
    hid, _ = model_apply(params, {"tokens": torch.cat([batch["tokens"], forced], 1)}, cfg32,
                         is_training=False, return_hidden=True)
    want = torch.matmul(hid[:, plen - 1:].to(cfg.torch_param_dtype),
                        head_matrix(params, cfg)).float()
    got = torch.stack(got, 1)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite f32 decode logits")
    d_last = float((lb[:, 0] - want[:, 0]).abs().max())
    d_dec = float((got - want[:, 1:]).abs().max())
    log(f"{label} f32: prefill logits at position {plen - 1} against model_apply max abs diff "
        f"{d_last:.3e}; {N_FORCED} teacher-forced decode steps (positions {plen}-"
        f"{plen + N_FORCED - 1}, window {cfg.sliding_window}, meta tokens {cfg.n_meta}) "
        f"against model_apply over {plen + N_FORCED} tokens: logits max abs diff {d_dec:.3e} "
        f"(tol {E2E_LOGIT_ATOL})")
    if max(d_last, d_dec) > E2E_LOGIT_ATOL:
        raise AssertionError(f"{label}: prefill or decode logits differ by {d_last}, {d_dec}")
    return dict(prefill=d_pre, prefill_vs_apply=d_last, decode=d_dec)


def ring_read(cfg, rows, dev):
    """One layer's plain ring read at a decode step (the port's and the
    reference's: the ring's K/V expanded to the query heads in f32, then
    quadratic attention under the ``pos`` mask) with every slot live,
    timed in turns with SDPA on the same ring and mask, beside the bytes
    of the ring's K/V read once."""
    from repro_torch.models import attention as A
    w, kv, hd, h = cfg.sliding_window, cfg.n_kv_heads, cfg.head_dim_, cfg.n_heads
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    q = torch.randn((rows, 1, h, hd), generator=g, device=dev)
    ck, cv = (torch.randn((rows, w, kv, hd), generator=g, device=dev).to(cfg.torch_dtype)
              for _ in range(2))
    valid = torch.ones((rows, w), dtype=torch.bool, device=dev)
    q4 = q.to(ck.dtype).transpose(1, 2)
    k4, v4 = ck.transpose(1, 2), cv.transpose(1, 2)
    mask = valid[:, None, None, :]
    plain_ms, sdpa_ms = in_turns(
        lambda: A.full_attention(q, ck, cv, causal=False, kv_valid=valid),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True))
    b_ms, b_by = bound(2 * ck.numel() * ck.element_size(), 4.0 * rows * w * h * hd, "float32")
    log(f"time ring read [q {tuple(q.shape)} f32, ring {tuple(ck.shape)} {_dt(ck)}], one layer: "
        f"plain {plain_ms:.6f} ms, SDPA {sdpa_ms:.6f} ms (in turns), bound {b_ms:.6f} ms "
        f"({b_by}); x {cfg.n_layers} layers: plain {plain_ms * cfg.n_layers:.2f} ms per step")
    return dict(ms=plain_ms, sdpa_ms=sdpa_ms, bound_ms=b_ms, bound_by=b_by)


def banded_vs_blocked(cfg, dev):
    """One layer's causal windowed attention at SWA_BANDED_LEN tokens (f32,
    one row, the arch's heads), past the ``banded_swa`` switch at 2 x
    window: the default blocked flash attention (key blocks outside a
    chunk's window skipped) against ``banded_flash_attention`` (the
    ``banded_swa`` branch's chunks), held against each other and timed in
    turns, beside the bound of the window's work."""
    from repro_torch.models import attention as A
    from repro_torch.models.flash import banded_flash_attention
    w, n, h, kv, hd = (cfg.sliding_window, SWA_BANDED_LEN, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim_)
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    q = torch.randn((1, n, h, hd), generator=g, device=dev)
    k, v = (torch.randn((1, n, kv, hd), generator=g, device=dev) for _ in range(2))
    blocked = lambda: A.flash_attention(q, k, v, causal=True, window=w)  # noqa: E731
    banded = lambda: banded_flash_attention(q, k, v, w, q_chunk=1024, kv_chunk=512)  # noqa: E731
    with torch.no_grad():
        err = check(f"banded vs blocked flash attention@{n} tokens", banded(), blocked())
        blocked_ms, banded_ms = in_turns(blocked, banded, depth=SWA_HEAVY_DEPTH)
    seen = sum(min(i + 1, w) for i in range(n))           # (query, key) pairs in the window
    b_ms, b_by = bound(4 * (q.numel() + 2 * k.numel() + q.numel()), 4.0 * seen * h * hd,
                       "float32")
    log(f"time windowed attention [q {tuple(q.shape)}, k/v {tuple(k.shape)} f32, window {w}]: "
        f"blocked {blocked_ms:.3f} ms, banded {banded_ms:.3f} ms (in turns), bound "
        f"{b_ms:.3f} ms ({b_by}); max abs diff {err:.3e}")
    return dict(tokens=n, blocked_ms=blocked_ms, banded_ms=banded_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err)


def swa_exact(params, cfg, dev):
    """Phase swa (b): the slot-pool scheduler on starcoder2-3b with buckets
    up to 8,192 (exact-length prefill), prompts of SWA_EXACT_LENS, f32:
    every admission group holds one prompt length, unpadded; no kernel
    launches; each request's tokens equal its one-shot ``generate``
    bitwise (no near-tie allowance); the paged scheduler refuses the
    arch."""
    import numpy as np
    from repro_torch.configs import PagedKVConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (ContinuousScheduler, GenerateConfig, PagedScheduler,
                                   Request)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = GenerateConfig(max_new=SWA_EXACT_NEW, eos_id=-1, flash_decode=True)
    rs = np.random.RandomState(SEED + 5)
    reqs = [Request(rid=i, tokens=rs.randint(3, cfg.vocab, n).astype(np.int64),
                    max_new=SWA_EXACT_NEW) for i, n in enumerate(SWA_EXACT_LENS)]
    sched = ContinuousScheduler(params, cfg32, gen, n_slots=len(reqs),
                                prefill_buckets=SWA_EXACT_BUCKETS)
    if not sched.exact_prefill:
        raise AssertionError("swa exact: the scheduler did not take exact-length prefill")
    groups = []
    real = sched._prefill_group
    sched._prefill_group = lambda group, bucket, now: groups.append(
        (bucket, [len(r.tokens) for r in group])) or real(group, bucket, now)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = {r.rid: r.tokens for r in res}
    log(f"swa exact: {sched.stats}; admission groups (bucket, prompt lengths) {groups}; "
        f"launches {counts}; {wall:.2f} s")
    if any(counts.values()) or sched.stats["finished"] != len(reqs):
        raise AssertionError(f"swa exact: launches {counts} or stats {sched.stats}")
    if sorted(b for b, _ in groups) != sorted(SWA_EXACT_LENS) or \
            any(lens != [b] * len(lens) for b, lens in groups):
        raise AssertionError(f"swa exact: groups not of one exact length {groups}")
    n_equal, gaps = oneshot_check(params, cfg32, gen, reqs, want, sched.max_seq, dev)
    log(f"swa exact f32: {n_equal} of {len(reqs)} requests' tokens equal their one-shot "
        f"generate; divergences (rid, first token, top-two gap) {gaps}")
    if n_equal != len(reqs):
        raise AssertionError(f"swa exact: tokens differ from one-shot generate: {gaps}")
    try:
        PagedScheduler(params, cfg32, gen, paged=PagedKVConfig(page_size=PAGE_SIZE),
                       n_slots=2, prefill_buckets=SWA_EXACT_BUCKETS)
    except ValueError as e:
        if "nothing to page" not in str(e):
            raise
        log(f"swa exact: PagedScheduler refuses the arch: {e}")
    else:
        raise AssertionError("swa exact: PagedScheduler accepted an all-window arch")
    return dict(stats=dict(sched.stats), groups=groups, wall_s=wall, n_equal=n_equal,
                gaps=gaps)


def swa_windowed(arch, dev, layers=None, timed=True, exact=False):
    """Phase swa (a)-(c): ``arch`` at full width (``layers`` deep, default
    all), SWA_ROWS x SWA_PROMPT tokens, 32 new, flash decode on: a counted
    ``generate`` launching no kernel; its timed rounds and the decode
    step as a CUDA graph; the f32 gates; with ``exact``, phase (b)."""
    from repro_torch.serve import GenerateConfig
    t0 = time.perf_counter()
    cfg = dec_cfg(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params, batch = dec_model(cfg, dev, SWA_ROWS, SWA_PROMPT)
    gen = GenerateConfig(max_new=MAX_NEW, eos_id=-1, flash_decode=True)
    counts, _, _ = dec_generate(arch, params, batch, cfg, gen, lambda steps: {})
    out = {"layers": cfg.n_layers, "launches": counts}
    if timed:
        out["serve"] = dec_timed(arch, params, batch, cfg, gen, EAGER_ROUNDS)
        out["decode_graph_ms"] = decode_graph(f"swa {arch}", params, batch, cfg,
                                              out["serve"]["median"]["decode_ms_per_step"],
                                              dev)
        out["ring_read"] = ring_read(cfg, SWA_ROWS, dev)
        out["banded"] = banded_vs_blocked(cfg, dev)
    out["logit_diff"] = ring_gate(f"swa {arch}", params, batch, cfg, dev)
    if exact:
        out["exact"] = swa_exact(params, cfg, dev)
    del params, batch
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"swa {arch}: {out['wall_s']:.1f} s")
    return out


def b5_depths(args):
    """B5 at a captured decode query over the first L positions of its
    cache, every row at position L - 1, for L up to the whole cache: the
    split plan's n_split, device ms and the byte bound per depth (does
    the merge's cost grow with n_split?)."""
    q, k, v, idx = args
    out = []
    for n in (256, 1024, 2048, k.shape[1]):
        a = (q, k[:, :n].contiguous(), v[:, :n].contiguous(), torch.full_like(idx, n - 1))
        err = check(f"flash_decode@{n} positions", kernel_of("flash_decode")(*a),
                    plain_of("flash_decode")(*a))
        ms = device_ms(lambda: kernel_of("flash_decode")(*a))
        b_ms, _ = bound(*work("flash_decode", a))
        out.append(dict(positions=n, n_split=n_split_of(a), ms=ms, bound_ms=b_ms,
                        max_abs_err=err))
        log(f"time flash_decode at {n} positions [{tuple(q.shape)} x {tuple(a[1].shape)}, "
            f"n_split {out[-1]['n_split']}]: {ms:.6f} ms, bound {b_ms:.6f} ms (bytes; "
            f"{b_ms / ms * 100:.1f}% of it), {(ms - b_ms) * 1e3:.2f} us above it")
    return out


def swa_yi(dev):
    """Phase swa (d): yi-6b at full width and depth, SWA_ROWS x
    YI_LONG_PROMPT tokens (a cache of 3,616 positions): the blocked f32
    prefill against the quadratic one; B5's launches per generate, B5 at
    the captured long-cache decode inputs (its n_split) in turns with
    SDPA; the slot pool and the page arena on the same requests (f32,
    pages of 16): equal tokens, B6 against its plain version, bitwise B5,
    timed in turns with index_select + SDPA."""
    import numpy as np
    from repro_torch.configs import PagedKVConfig
    from repro_torch.serve import (ContinuousScheduler, GenerateConfig, PagedScheduler,
                                   Request, generate)
    t0 = time.perf_counter()
    cfg = dec_cfg("yi-6b")
    params, batch = dec_model(cfg, dev, SWA_ROWS, YI_LONG_PROMPT)
    max_seq = YI_LONG_PROMPT + MAX_NEW
    gen = GenerateConfig(max_new=MAX_NEW, eos_id=-1, flash_decode=True)
    counts, _, _ = dec_generate("yi-6b long", params, batch, cfg, gen,
                                lambda steps: {"flash_decode": cfg.n_layers * steps})
    if counts["flash_decode"] != cfg.n_layers * (MAX_NEW - 1):
        raise AssertionError(f"swa yi-6b: {counts['flash_decode']} B5 launches")
    d_pre, caches, _ = blocked_gate("swa yi-6b", params, batch, cfg, max_seq)
    del caches
    with Capture(names=("flash_decode",)) as cap:
        generate(params, batch, cfg, dataclasses.replace(gen, max_new=2))
    torch.cuda.synchronize()
    b5_args = cap.calls["flash_decode"][-1][0]
    del cap
    site = dec_site("yi-6b long", "flash_decode", "long decode", b5_args)
    depths = b5_depths(b5_args)
    del b5_args

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    pgen = GenerateConfig(max_new=YI_PAGED_NEW, eos_id=-1, flash_decode=True)
    prompts = batch["tokens"].cpu().numpy()
    reqs = lambda: [Request(rid=i, tokens=prompts[i], max_new=YI_PAGED_NEW)  # noqa: E731
                    for i in range(SWA_ROWS)]
    kw = dict(n_slots=SWA_ROWS, prefill_buckets=(YI_LONG_PROMPT,), max_seq=max_seq)
    slot, ss, c_slot, w_slot = run_scheduler(
        params, cfg32, pgen, reqs(), sched=ContinuousScheduler(params, cfg32, pgen, **kw))
    with Capture(names=("flash_decode_paged",)) as cap:
        paged, ps, c_paged, w_paged = run_scheduler(
            params, cfg32, pgen, reqs(), sched=PagedScheduler(
                params, cfg32, pgen, paged=PagedKVConfig(page_size=PAGE_SIZE,
                                                         n_slots_equiv=SWA_ROWS), **kw))
    for label, st, c, key in (("slot pool", ss.stats, c_slot, "flash_decode"),
                              ("paged", ps.stats, c_paged, "flash_decode_paged")):
        want = {k: 0 for k in c}
        want[key] = cfg.n_layers * st["decode_steps"]
        log(f"swa yi-6b {label} f32 ({SWA_ROWS} x {YI_LONG_PROMPT} tokens, {YI_PAGED_NEW} "
            f"new): {st}; launches {c}, expected {want}")
        if c != want or st["finished"] != SWA_ROWS:
            raise AssertionError(f"swa yi-6b {label}: launches {c} != {want} or {st}")
    bad = [i for i in range(SWA_ROWS) if not np.array_equal(paged[i], slot[i])]
    if bad:
        raise AssertionError(f"swa yi-6b: paged and slot-pool tokens differ for {bad}")
    log(f"swa yi-6b f32: tokens equal across the slot pool (B5, {w_slot:.2f} s) and the "
        f"page arena (B6, {w_paged:.2f} s)")
    args = cap.calls["flash_decode_paged"][-1][0]
    del cap
    err = b6_checks([args], dev)
    b6 = dict(b6_timing(args), max_abs_err=err, launches=c_paged["flash_decode_paged"],
              stats=dict(ps.stats))
    del params, batch
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"swa yi-6b: {wall:.1f} s")
    return dict(launches=counts["flash_decode"], prefill_logit_diff=d_pre,
                b5=dict(site, launches=counts["flash_decode"]), b5_depths=depths, b6=b6,
                wall_s=wall)


def swa_dbrx(dev):
    """Phase swa (e): dbrx-132b at full width, DBRX_LAYERS layers, one
    request of DBRX_LONG_PROMPT tokens (the blocked prefill): counted
    ``generate`` calls on cuda and cuda_fused (prefill tiled, the decode
    step streaming); B2, B1 (tiled), B3 and B4 (tiled) at the captured
    prefill inputs against their plain versions, timed beside their bound,
    plain version and library call or the cuda pipeline; the f32 prefill
    logits of both backends against the plain path."""
    from repro_torch.models import prefill
    from repro_torch.serve import GenerateConfig, generate
    t0 = time.perf_counter()
    cfg = dec_cfg("dbrx-132b", "cuda")
    fused = dec_cfg("dbrx-132b", "cuda_fused")
    params, batch = dec_model(cfg, dev, 1, DBRX_LONG_PROMPT)
    gen = GenerateConfig(max_new=2, eos_id=-1, flash_decode=True)
    out = {"layers": cfg.n_layers, "launches": {}, "sites": {}}
    for backend, c in (("cuda", cfg), ("cuda_fused", fused)):
        expect, n_moe = dbrx_expect(backend, c)
        counts, streamed, res = dec_generate(f"dbrx-132b long {backend}", params, batch, c, gen,
                                             expect)
        name = "grouped_matmul" if backend == "cuda" else "fused_moe"
        per_call = 3 if backend == "cuda" else 1
        if streamed[name] != per_call * n_moe * res.steps:
            raise AssertionError(f"swa dbrx {backend}: {streamed[name]} of {counts[name]} "
                                 f"{name} streaming; the prefill's must be tiled")
        out["launches"][backend] = {k: v for k, v in counts.items() if v}
    with Capture(names=("dispatch", "combine", "grouped_matmul"),
                 share_over=SHARE_OVER) as cap:
        prefill(params, batch, cfg, max_seq=DBRX_LONG_PROMPT + 2)
    torch.cuda.synchronize()
    calls = cap.calls
    del cap
    for name in ("dispatch", "grouped_matmul", "combine"):
        args = calls[name][0][0]
        if name == "grouped_matmul" and b1_variant(name, args) != "tiled":
            raise AssertionError(f"swa dbrx B1@long prefill: {b1_variant(name, args)}")
        t = (combine_site("dbrx long prefill", args) if name == "combine" else
             dec_site("dbrx-132b", name, "long prefill", args, SWA_HEAVY_DEPTH))
        out["sites"][name] = t
    del calls
    with Capture(names=("fused_moe",), share_over=SHARE_OVER) as cap:
        prefill(params, batch, fused, max_seq=DBRX_LONG_PROMPT + 2)
    torch.cuda.synchronize()
    args, kw = cap.calls["fused_moe"][0]
    del cap
    t = b4_site("dbrx long prefill", args, kw, depth=SWA_HEAVY_DEPTH)
    if t["variant"] != "tiled":
        raise AssertionError(f"swa dbrx B4@long prefill: {t['variant']}")
    out["sites"]["fused_moe"] = t
    del args, kw
    torch.cuda.empty_cache()
    with torch.no_grad():
        c32 = lambda c, b: dataclasses.replace(  # noqa: E731
            c, dtype="float32", moe=dataclasses.replace(c.moe, backend=b))
        lp, _ = prefill(params, batch, c32(cfg, "oracle"), max_seq=DBRX_LONG_PROMPT + 2)
        diffs = {}
        for backend, c in (("cuda", cfg), ("cuda_fused", fused)):
            lk, _ = prefill(params, batch, c32(c, backend), max_seq=DBRX_LONG_PROMPT + 2)
            if not torch.isfinite(lk).all():
                raise AssertionError(f"swa dbrx {backend}: non-finite f32 prefill logits")
            diffs[backend] = float((lk - lp).abs().max())
    log(f"swa dbrx-132b f32: prefill logits ({DBRX_LONG_PROMPT} tokens, blocked attention) "
        f"kernel vs plain path max abs diff {diffs} (tol {E2E_LOGIT_ATOL})")
    if max(diffs.values()) > E2E_LOGIT_ATOL:
        raise AssertionError(f"swa dbrx: prefill logits differ by {diffs}")
    out["logit_diff"] = diffs
    del params, batch
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"swa dbrx-132b: {out['wall_s']:.1f} s")
    return out


def swa_phase(dev):
    """Phase swa: starcoder2-3b (full width and depth; with (b) the
    exact-length scheduler), h2o-danube-3-4b (DANUBE_LAYERS layers),
    yi-6b's long cache, dbrx-132b's long prefill; each model freed before
    the next."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"starcoder2-3b": swa_windowed("starcoder2-3b", dev, exact=True),
           "h2o-danube-3-4b": swa_windowed("h2o-danube-3-4b", dev, DANUBE_LAYERS, timed=False),
           "yi-6b": swa_yi(dev), "dbrx-132b": swa_dbrx(dev)}
    out["wall_s"] = time.perf_counter() - t0
    log(f"swa phase: {out['wall_s']:.1f} s")
    return out


def swa_rows(swa):
    """Per kernel, its phase-swa sites for the kernel table."""
    yi, dbrx = swa["yi-6b"], swa["dbrx-132b"]
    rows = {"flash_decode": {"yi-6b long decode": yi["b5"]},
            "flash_decode_paged": {"yi-6b long paged decode": {
                k: v for k, v in yi["b6"].items() if k != "stats"}}}
    for name, t in dbrx["sites"].items():
        backend = "cuda_fused" if name == "fused_moe" else "cuda"
        rows[name] = {"dbrx-132b long prefill": dict(
            {k: v for k, v in t.items() if k != "host_ms"},
            launches=dbrx["launches"][backend][name])}
    return rows


# ---------------------------------------------------------------------------
# phase mla: DeepSeek-V3 (multi-head latent attention, 256 experts top-8)
# ---------------------------------------------------------------------------

DS_LAYERS = 2            # deepseek-v3-671b's depth cut: layer 0 dense, layer 1 MoE
                         # (61 layers, 671 B parameters, fit no H100)
DS_LONG_ROWS, DS_LONG_PROMPT = 2, 1024    # the long prefill: C = 128 at top-8, tiled
DS_SCHED_N = 8                            # the scheduler trace's first requests


def mla_cfg(backend=None, dtype=None):
    """deepseek-v3-671b at full width and DS_LAYERS layers (the serving
    CLI's ``--layers`` cut, which keeps the last layer MoE), its MoE on
    ``backend``, activations in ``dtype`` (default the config's)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cut_depth
    cfg = cut_depth(get_config("deepseek-v3-671b"), DS_LAYERS)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if backend:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, backend=backend))
    return cfg


def mla_expect(backend: str, cfg, rows: int, prompt: int):
    """(launches of one ``generate`` of ``steps`` decode steps, their
    streaming count): each MoE layer once at prefill and once per step (B2,
    three B1 and B3 on ``cuda``; B4 on ``cuda_fused``); no flash decode,
    which MLA layers never reach. A call streams where its capacity is at
    most 16 slots per expert."""
    from repro_torch.core.router import capacity
    n_moe = sum(cfg.moe.is_moe_layer(i) for i in range(cfg.n_layers))
    per_call = 3 if backend == "cuda" else 1
    m = cfg.moe

    def c_of(t):
        return min(capacity(t, m.n_experts, m.top_k, m.eval_capacity_factor), t)

    def expect(steps):
        calls = n_moe * (1 + steps)
        if backend == "cuda":
            return {"dispatch": calls, "combine": calls, "grouped_matmul": 3 * calls}
        return {"fused_moe": calls}

    def streamed(steps):
        return per_call * n_moe * (steps * (c_of(rows) <= 16)
                                   + (c_of(rows * prompt) <= 16))
    return expect, streamed


def mla_sites(params, cfg, fused, batch, long_batch, gen):
    """B1-B4 at the decode step's and the long prefill's captured inputs
    (256 experts, top-8): each against its plain version, then timed
    beside its bound, plain version and library call (B4 beside the cuda
    pipeline), in turns. The decode site is a generate's last call (B1:
    the down projection), the long prefill's its first (B1: the up
    projection). Returns the sites' timings and the launches of one long
    prefill per backend."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import prefill
    from repro_torch.serve import generate

    def captured(names, c):
        with Capture(names=names, share_over=SHARE_OVER) as cap:
            generate(params, batch, c, dataclasses.replace(gen, max_new=2))
        reset_launch_counts()
        with Capture(names=names, share_over=SHARE_OVER) as cap_long:
            prefill(params, long_batch, c, max_seq=DS_LONG_PROMPT + 2)
        torch.cuda.synchronize()
        launches[c.moe.backend] = {k: v for k, v in launch_counts().items() if v}
        return {n: (cap.calls[n][-1], cap_long.calls[n][0]) for n in names}

    out, launches = {}, {}
    calls = captured(("dispatch", "combine", "grouped_matmul"), cfg)
    for name in ("dispatch", "grouped_matmul", "combine"):
        for site, (args, _) in zip(("decode", "long prefill"), calls[name]):
            if name == "grouped_matmul":
                want = "tiled" if site == "long prefill" else "streaming"
                if b1_variant(name, args) != want:
                    raise AssertionError(f"mla B1@{site}: {b1_variant(name, args)}, not {want}")
            if name == "combine":
                if args[1].shape[1] != cfg.moe.top_k:
                    raise AssertionError(f"mla B3@{site}: k {args[1].shape[1]}")
                t = combine_site(f"deepseek {site}", args)
            else:
                t = dec_site("deepseek-v3-671b", name, site, args,
                             HEAVY_DEPTH if name == "grouped_matmul" else ())
            out[(name, site)] = t
    del calls
    calls = captured(("fused_moe",), fused)["fused_moe"]
    for site, (args, kw), want in zip(("decode", "long prefill"), calls,
                                      ("streaming", "tiled")):
        t = b4_site(f"deepseek {site}", args, kw, depth=HEAVY_DEPTH)
        if t["variant"] != want:
            raise AssertionError(f"mla B4@{site}: {t['variant']}, not {want}")
        out[("fused_moe", site)] = t
    del calls
    torch.cuda.empty_cache()
    n_moe = sum(cfg.moe.is_moe_layer(i) for i in range(cfg.n_layers))
    want = {"cuda": {"dispatch": n_moe, "combine": n_moe, "grouped_matmul": 3 * n_moe},
            "cuda_fused": {"fused_moe": n_moe}}
    log(f"mla long prefill ({DS_LONG_ROWS} x {DS_LONG_PROMPT} tokens): launches {launches}, "
        f"expected {want}")
    if launches != want:
        raise AssertionError(f"mla long prefill: launches {launches} != {want}")
    return out, launches


def mla_decode_site(params, batch, cfg, dev):
    """The plain absorbed MLA decode of the MoE layer (``models/mla.py``;
    jnp in the reference, so no kernel) at the decode step's shapes: 8
    rows at position PROMPT of a prefilled PROMPT + MAX_NEW cache, timed
    beside its bound (its five weights and the latents read once, the new
    latent row and the output written once)."""
    from repro_torch.models import mla as M
    from repro_torch.models import prefill
    _, fresh = prefill(params, batch, cfg, max_seq=PROMPT + MAX_NEW)
    cache = {k: v[0] for k, v in _pool(cfg, fresh, dev)[1]["p0"]["attn"].items()}
    del fresh
    p = {k: v[0] for k, v in params["decoder"][1]["p0"]["attn"].items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    x = torch.randn((BATCH, 1, cfg.d_model), generator=g, device=dev).to(cfg.torch_dtype)
    pos = torch.full((BATCH,), PROMPT, device=dev)
    ms = device_ms(lambda: M.mla_decode(p, x, cache, cfg, pos))
    m = cfg.mla
    row = (m.kv_lora_rank + m.qk_rope_head_dim) * cache["c_kv"].element_size()
    nbytes = (sum(t.numel() * t.element_size() for t in p.values())
              + BATCH * (PROMPT + 1) * row + BATCH * row + 2 * x.numel() * x.element_size())
    b_ms, b_by = bound(nbytes, 0.0, "float32")
    with CallCount() as calls:
        M.mla_decode(p, x, cache, cfg, pos)
    log(f"time mla_decode@decode [plain absorbed MLA decode, one layer, {BATCH} rows at "
        f"position {PROMPT}, latents {tuple(cache['c_kv'].shape)} + "
        f"{tuple(cache['k_rope'].shape)} {_dt(cache['c_kv'])}]: {ms:.6f} ms, bound "
        f"{b_ms:.6f} ms ({b_by}: {nbytes / 1e9:.3f} GB; {b_ms / ms * 100:.1f}% of it); "
        f"{calls.n} PyTorch calls")
    return dict(ms=ms, bound_ms=b_ms, bound_by=b_by, torch_calls=calls.n)


def mla_schedulers(params, cfg, dev):
    """The first DS_SCHED_N requests of phase 7's trace (prompts alone)
    through the slot pool and the page arena, f32 activations at
    non-binding capacity: per-request tokens equal across the two, and
    against one-shot B=1 ``generate`` up to near-ties; launches per run
    per MoE layer one pipeline per admission and per decode tick, no
    flash decode. Returns the stats."""
    from repro_torch.serve import GenerateConfig
    cfg32 = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, eval_capacity_factor=float(cfg.moe.n_experts)))
    gen = GenerateConfig(max_new=TRACE_BUDGET, eos_id=-1, flash_decode=True)
    reqs = sched_trace(cfg.vocab, sources=False)[:DS_SCHED_N]
    n_moe = sum(cfg.moe.is_moe_layer(i) for i in range(cfg.n_layers))
    slot, ss, c_slot, w_slot = run_scheduler(params, cfg32, gen, reqs)
    paged, ps, c_paged, w_paged = run_scheduler(params, cfg32, gen, reqs, paged=True)
    for label, st, c in (("slot pool", ss.stats, c_slot), ("paged", ps.stats, c_paged)):
        calls = n_moe * (st["prefill_calls"] + st["decode_steps"])
        want = {**{k: 0 for k in c}, "dispatch": calls, "combine": calls,
                "grouped_matmul": 3 * calls}
        log(f"mla {label} f32: {st}; launches {c}, expected {want}")
        if c != want or st["finished"] != DS_SCHED_N:
            raise AssertionError(f"mla {label}: launches {c} != {want} or {st}")
    bad = [r.rid for r in reqs if not (paged[r.rid] == slot[r.rid]).all()]
    if bad:
        raise AssertionError(f"mla: paged and slot-pool tokens differ for {bad}")
    if ps.stats["prefix_hits"] == 0:
        raise AssertionError(f"mla: no prefix hit on a shared-prefix trace {ps.stats}")
    n_equal, gaps = oneshot_check(params, cfg32, gen, reqs, slot, ss.max_seq, dev)
    log(f"mla f32: the {DS_SCHED_N} requests' tokens equal across the slot pool "
        f"({w_slot:.2f} s) and the page arena ({w_paged:.2f} s, prefix hits "
        f"{ps.stats['prefix_hits']}); one-shot B=1 generate: {n_equal} of {DS_SCHED_N} "
        f"equal; divergences (rid, first token, top-two logit gap): {gaps}")
    if any(gap >= NEAR_TIE for _, _, gap in gaps):
        raise AssertionError(f"mla: a divergence from one-shot is not a near-tie: {gaps}")
    return dict(slot=dict(ss.stats), paged=dict(ps.stats), oneshot_equal=n_equal, gaps=gaps)


def mla_serve(dev):
    """deepseek-v3-671b at full width, DS_LAYERS layers: counted and timed
    generates on cuda and cuda_fused (no flash decode on MLA layers), the
    absorbed decode step as one CUDA graph, B1-B4 at their decode and long
    prefill sites, the f32 gates of both backends against the plain path
    (and their tokens equal up to near-ties), the two schedulers."""
    from repro_torch.launch.serve import generator, synth_batch
    from repro_torch.serve import GenerateConfig, generate
    cfg = mla_cfg("cuda")
    fused = mla_cfg("cuda_fused")
    params, batch = dec_model(cfg, dev)
    long_batch = synth_batch(cfg, generator(dev, SEED, 2), DS_LONG_ROWS, DS_LONG_PROMPT)
    gen = GenerateConfig(max_new=MAX_NEW, eos_id=-1, flash_decode=True)
    out = {"layers": cfg.n_layers, "launches": {}, "peak_gib": {}}
    for backend, c in (("cuda", cfg), ("cuda_fused", fused)):
        expect, want_streamed = mla_expect(backend, c, BATCH, PROMPT)
        counts, streamed, res = dec_generate(f"deepseek-v3-671b {backend}", params, batch, c,
                                             gen, expect)
        out["peak_gib"][backend] = torch.cuda.max_memory_allocated() / 2**30
        name = "grouped_matmul" if backend == "cuda" else "fused_moe"
        if streamed[name] != want_streamed(res.steps):
            raise AssertionError(f"mla {backend}: {streamed[name]} of {counts[name]} {name} "
                                 f"streaming, expected {want_streamed(res.steps)}")
        out["launches"][backend] = {k: v for k, v in counts.items() if v}
        out["launches"][backend]["streaming"] = streamed[name]
    runs = {"cuda": [], "cuda_fused": []}
    for backend in ("cuda", "cuda_fused", "cuda_fused", "cuda"):
        runs[backend].append(dec_timed(f"deepseek-v3-671b {backend} (in turns)", params,
                                       batch, fused if backend == "cuda_fused" else cfg, gen))
    out["serve"] = runs
    out["decode_graph_ms"] = {
        name: decode_graph(f"mla deepseek-v3-671b {name}", params, batch, c,
                           sum(r["median"]["decode_ms_per_step"] for r in runs[name]) / 2, dev)
        for name, c in (("cuda", cfg), ("cuda_fused", fused))}
    out["sites"], out["long_prefill_launches"] = mla_sites(params, cfg, fused, batch,
                                                           long_batch, gen)
    out["mla_decode"] = mla_decode_site(params, batch, cfg, dev)
    # f32: both kernel backends against the plain path, and their tokens
    out["e2e_logit_diff"] = {}
    for name, c in (("cuda", cfg), ("cuda_fused", fused)):
        e2e = e2e_phase(params, batch, c, gen, dev, label=f"mla deepseek-v3-671b {name} e2e")
        out["e2e_logit_diff"][name] = dict(prefill=e2e[0], decode=e2e[1])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    a = generate(params, batch, cfg32, gen).tokens
    b = generate(params, batch, dataclasses.replace(fused, dtype="float32"), gen).tokens
    gaps = near_tie_gaps(params, batch, cfg32, a, b, dev)
    log(f"mla deepseek-v3-671b f32: cuda_fused tokens equal the cuda backend's on "
        f"{float((a == b).float().mean()) * 100:.1f}% of {a.numel()} (B4 adds a token's "
        f"top-8 rows with atomics); divergences (row, first token, top-two logit gap): {gaps}")
    if any(gap >= NEAR_TIE for _, _, gap in gaps):
        raise AssertionError(f"mla cuda_fused vs cuda: a divergence is not a near-tie: {gaps}")
    out["fused_vs_cuda_gaps"] = gaps
    out["sched"] = mla_schedulers(params, cfg, dev)
    # the peak since the counted cuda_fused generate reset it, the weights
    # allocated throughout
    out["peak_gib"]["phase"] = max(torch.cuda.max_memory_allocated() / 2**30,
                                   *out["peak_gib"].values())
    del params, batch, long_batch
    torch.cuda.empty_cache()
    return out


def mla_train(dev):
    """Reduced deepseek-v3-671b, --task lm with its MTP head: LM_STEPS
    Gate-Drop 0.3 steps through ``lm_steps``, ``mtp_xent`` gated with the
    loss, grad norm and balance."""
    from repro_torch.configs import get_config, reduced
    base = reduced(get_config("deepseek-v3-671b"))
    if not base.mtp:
        raise AssertionError("mla lm: reduced deepseek-v3-671b lost its MTP head")
    return lm_steps("mla lm", base, LM_STEPS, LM_BATCH, LM_SEQ,
                    ("loss", "grad_norm", "balance", "mtp_xent"), dev)


def mla_phase(dev):
    """Phase mla: deepseek-v3-671b at full width (DS_LAYERS layers), then
    reduced deepseek-v3-671b's --task lm steps with MTP."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"deepseek-v3-671b": mla_serve(dev)}
    log(f"mla deepseek-v3-671b: {time.perf_counter() - t0:.1f} s")
    out["lm"] = mla_train(dev)
    out["wall_s"] = time.perf_counter() - t0
    log(f"mla phase: {out['wall_s']:.1f} s; peak device memory "
        f"{out['deepseek-v3-671b']['peak_gib']['phase']:.2f} GiB")
    return out


def mla_json(mla):
    """Phase mla's results with its site keys as strings."""
    ds = dict(mla["deepseek-v3-671b"])
    ds["sites"] = {f"{n}@{s}": t for (n, s), t in ds["sites"].items()}
    return dict(mla, **{"deepseek-v3-671b": ds})


def mla_rows(mla):
    """Per kernel, its phase-mla sites for the kernel table, with the
    launches of one generate (decode) or one long prefill."""
    ds = mla["deepseek-v3-671b"]
    rows = {}
    for (name, site), t in ds["sites"].items():
        backend = "cuda_fused" if name == "fused_moe" else "cuda"
        counts = ds["long_prefill_launches" if site == "long prefill" else "launches"]
        rows.setdefault(name, {})[f"deepseek-v3-671b {site}"] = dict(
            {k: v for k, v in t.items() if k != "host_ms"}, launches=counts[backend][name])
    return rows


# ---------------------------------------------------------------------------
# phase ssm: Mamba-2 SSD (mamba2-1.3b) and the Hymba hybrid (hymba-1.5b)
# ---------------------------------------------------------------------------

SSM_LONG_ROWS = 2
MAMBA_LONG_PROMPT = 4096          # 32 chunks of 128
HYMBA_LONG_PROMPT = 2048          # + 128 meta tokens: past the 1,024 window and 2 x 1,024 keys
MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_ROWS, MAMBA_TRAIN_SEQ = 4, 2, 1024
SSM_SCHED_N = 6                   # the scheduler trace's first requests (2-64 tokens)
SSM_LONG_REPS = 1


@torch.no_grad()
def ssm_long_prefill(label, params, cfg, dev, prompt):
    """One prefill of SSM_LONG_ROWS x ``prompt`` tokens in the model's dtype,
    host-clock ms over SSM_LONG_REPS calls after a warm-up (each ending in
    a sync), tokens/s, and the peak device memory above the weights."""
    import statistics
    from repro_torch.launch.serve import generator, spread, synth_batch
    from repro_torch.models import prefill
    batch = synth_batch(cfg, generator(dev, SEED, 2), SSM_LONG_ROWS, prompt)
    lg, _ = prefill(params, batch, cfg, max_seq=prompt + 1)
    if not torch.isfinite(lg).all():
        raise AssertionError(f"{label}: non-finite long prefill logits")
    del lg
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rounds = []
    for _ in range(SSM_LONG_REPS):
        t0 = time.perf_counter()
        prefill(params, batch, cfg, max_seq=prompt + 1)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(rounds)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"{label}: prefill of {SSM_LONG_ROWS} x {prompt} tokens ({cfg.n_meta} meta tokens) "
        f"{ms:.2f} ms {spread(rounds)} (median of {SSM_LONG_REPS}), "
        f"{SSM_LONG_ROWS * prompt / ms * 1e3:.0f} tokens/s; peak {peak:.2f} GiB above the weights")
    return dict(ms=ms, rounds=rounds, tok_s=SSM_LONG_ROWS * prompt / ms * 1e3, peak_gib=peak)


def ssm_schedulers(label, params, cfg, dev):
    """The first SSM_SCHED_N requests of phase 7's trace (prompts alone, of
    mixed lengths) in f32 through the slot pool, whose exact-length
    prefill admits groups of one length, and, where a cache pages
    (hymba-1.5b), through the page arena and a PAGES_SMALL-page arena that
    preempts: every run's tokens against one-shot ``generate`` (near-ties
    allowed), the arena's prefix hits (the meta pages) and the small
    arena's preemptions; launches per run: B5 (B6 on the arenas) on every
    global layer per decode tick, nothing else. mamba2-1.3b: no launch, and
    the arena refuses it. Returns the stats and, paged, B6 at the arena's
    first decode tick against its plain version, bitwise B5, and timed."""
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.serve import GenerateConfig
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = GenerateConfig(max_new=TRACE_BUDGET, eos_id=-1, flash_decode=True)
    reqs = sched_trace(cfg.vocab, sources=False)[:SSM_SCHED_N]
    n_global = len(cfg.hybrid.global_attn_layers) if cfg.hybrid is not None else 0
    groups = []
    sched = new_scheduler(params, cfg32, gen)
    real = sched._prefill_group
    sched._prefill_group = lambda group, bucket, now: groups.append(
        (bucket, [len(r.tokens) for r in group])) or real(group, bucket, now)
    runs, out = {}, {"groups": groups}
    runs["slot pool"], ss, c, w = run_scheduler(params, cfg32, gen, reqs, sched=sched)
    if not sched.exact_prefill or any(lens != [b] * len(lens) for b, lens in groups):
        raise AssertionError(f"{label}: admission groups not of one exact length {groups}")
    todo = [("slot pool", ss, c, w, "flash_decode")]
    if n_global:
        with Capture(names=("flash_decode_paged",)) as cap:
            runs["arena"], ps, c, w = run_scheduler(params, cfg32, gen, reqs, paged=True)
        todo.append(("arena", ps, c, w, "flash_decode_paged"))
        b6_args = cap.calls["flash_decode_paged"][0][0]
        del cap
        runs["small arena"], sm, c, w = run_scheduler(params, cfg32, gen, reqs, paged=True,
                                                      n_pages=PAGES_SMALL)
        todo.append(("small arena", sm, c, w, "flash_decode_paged"))
        if ps.stats["prefix_hits"] == 0 or sm.stats["preemptions"] == 0:
            raise AssertionError(f"{label}: arena {ps.stats}, small arena {sm.stats}")
    else:
        try:
            new_scheduler(params, cfg32, gen, paged=True)
        except ValueError as e:
            if "nothing to page" not in str(e):
                raise
            log(f"ssm {label}: PagedScheduler refuses the arch: {e}")
        else:
            raise AssertionError(f"{label}: PagedScheduler accepted an arch with nothing to page")
    for name, sch, counts, wall, key in todo:
        want = {k: 0 for k in counts}
        want[key] = n_global * sch.stats["decode_steps"]
        log(f"ssm {label} {name} f32: {sch.stats}; launches {counts}, expected {want}; "
            f"{wall:.2f} s")
        if counts != want or sch.stats["finished"] != SSM_SCHED_N:
            raise AssertionError(f"{label} {name}: launches {counts} != {want} or {sch.stats}")
        out[name] = dict(sch.stats, wall_s=wall)
    log(f"ssm {label}: slot-pool admission groups (length, prompt lengths) {groups}")
    checked = against_oneshot(params, cfg32, gen, reqs, runs, ss.max_seq, dev)
    for name, (n_equal, gaps) in checked.items():
        log(f"ssm {label} f32: {name}: {n_equal} of {SSM_SCHED_N} requests' tokens equal "
            f"one-shot B=1 generate; divergences (rid, first token, top-two logit gap) {gaps}")
        if any(gap >= NEAR_TIE for _, _, gap in gaps):
            raise AssertionError(f"{label} {name}: a divergence from one-shot is not a near-tie")
        out[name].update(oneshot_equal=n_equal, gaps=gaps)
    if n_global:
        out_b6 = FD.flash_decode_paged(*b6_args)
        torch.cuda.synchronize()
        err = check(f"{label} flash_decode_paged@decode", out_b6,
                    plain_of("flash_decode_paged")(*b6_args))
        check(f"{label} flash_decode_paged vs B5", out_b6,
              FD.flash_decode(b6_args[0], *gathered(b6_args), b6_args[4]), exact=True)
        out["b6"] = dict(b6_timing(b6_args), max_abs_err=err,
                         launches=out["arena"]["decode_steps"] * n_global)
    return out


def decode_profile(label, params, batch, cfg, dev, top=8):
    """One eager decode step's device time by PyTorch op (torch.profiler
    over 3 steps after a warm-up, per step): the device total and the ops
    that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import prefill
    from repro_torch.serve.engine import decode_pool_step
    rows, plen = batch["tokens"].shape
    lg, fresh = prefill(params, batch, cfg, max_seq=plen + MAX_NEW)
    pool = _pool(cfg, fresh, dev, rows)
    del fresh
    tok = lg[:, 0].argmax(-1)
    pos = torch.full((rows,), plen, device=dev)
    alive = torch.ones(rows, dtype=torch.bool, device=dev)

    def step():
        decode_pool_step(params, pool, tok, pos, alive, cfg, flash_decode=True)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    # the ops' own device time (the kernels each launched); the kernels'
    # events, which carry the same time again, are left out
    ops = [(e.key, getattr(e, "self_device_time_total", 0.0) / 3e3, e.count // 3)
           for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    ops = sorted((o for o in ops if o[1] > 0), key=lambda o: -o[1])
    total = sum(o[1] for o in ops)
    log(f"{label}: one eager decode step, device time by op (torch.profiler, per step): total "
        f"{total:.3f} ms; " + ", ".join(f"{k} {ms:.3f} ms ({n} calls)" for k, ms, n in ops[:top]))
    return dict(total_ms=total, top=[dict(op=k, ms=ms, calls=n) for k, ms, n in ops[:top]])


def mamba_train(dev):
    """mamba2-1.3b at full width, MAMBA_TRAIN_LAYERS layers: forward and
    backward of the LM loss on MAMBA_TRAIN_ROWS x MAMBA_TRAIN_SEQ tokens
    (bf16 activations, remat), a warm-up pass then a timed one: the loss
    and every gradient finite (the masked exponent of the chunks' upper
    triangle overflows f32 at chunk 128); wall time and peak memory."""
    from repro_torch.data import LMTaskConfig, SyntheticLM
    from repro_torch.launch.serve import cut_depth, generator
    from repro_torch.models import init_model
    from repro_torch.training.loop import to_device
    from repro_torch.training.steps import total_loss
    from repro_torch.tree import flatten_with_paths
    cfg = cut_depth(dec_cfg("mamba2-1.3b"), MAMBA_TRAIN_LAYERS)
    params = init_model(generator(dev, SEED, 0), cfg)
    leaves = list(_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    task = SyntheticLM(LMTaskConfig(vocab=cfg.vocab, seq_len=MAMBA_TRAIN_SEQ))
    batch = to_device(task.sample_batch(0, MAMBA_TRAIN_ROWS), dev)
    for i in range(2):
        for p in leaves:
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = total_loss(params, batch, cfg, generator=None, decision=False)
        loss.backward()
        loss = loss.detach()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the FFN-free layers' ln2 feeds nothing (as in the reference): no gradient
    grads = {k: p.grad for k, p in flatten_with_paths(params).items()}
    unused = sorted(k for k, g in grads.items() if g is None)
    bad = sorted(k for k, g in grads.items() if g is not None and not torch.isfinite(g).all())
    norm = float(torch.sqrt(sum(g.float().square().sum() for g in grads.values()
                                if g is not None)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"ssm mamba2-1.3b train ({cfg.n_layers} layers, {MAMBA_TRAIN_ROWS} x {MAMBA_TRAIN_SEQ} "
        f"tokens, remat): loss {float(loss):.4f}, grad norm {norm:.4f}, "
        f"{len(grads) - len(unused)} gradients, non-finite {bad}, without a gradient path "
        f"{unused}; forward + backward {wall:.1f} ms; peak {peak:.2f} GiB")
    if bad or any("ln2" not in k for k in unused) or not math.isfinite(float(loss)) \
            or not math.isfinite(norm):
        raise AssertionError(f"ssm mamba2-1.3b train: non-finite loss or gradients {bad}, "
                             f"missing {unused}")
    del params, leaves, grads
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, loss=float(loss), grad_norm=norm, ms=wall, peak_gib=peak)


def ssm_mamba(dev):
    """mamba2-1.3b at full width and depth: a counted generate (no
    kernel launch), timed, its decode step as a CUDA graph; the long
    prefill timed; the f32 gates; the slot pool and the arena's refusal;
    then the 4-layer forward and backward."""
    from repro_torch.serve import GenerateConfig
    cfg = dec_cfg("mamba2-1.3b")
    params, batch = dec_model(cfg, dev)
    gen = GenerateConfig(max_new=MAX_NEW, eos_id=-1, flash_decode=True)
    counts, _, _ = dec_generate("mamba2-1.3b", params, batch, cfg, gen, lambda steps: {})
    out = {"layers": cfg.n_layers, "launches": {k: v for k, v in counts.items() if v},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    out["serve"] = dec_timed("mamba2-1.3b", params, batch, cfg, gen, EAGER_ROUNDS)
    out["decode_graph_ms"] = decode_graph("ssm mamba2-1.3b", params, batch, cfg,
                                          out["serve"]["median"]["decode_ms_per_step"], dev)
    out["decode_profile"] = decode_profile("ssm mamba2-1.3b", params, batch, cfg, dev)
    out["long_prefill"] = ssm_long_prefill("ssm mamba2-1.3b", params, cfg, dev,
                                           MAMBA_LONG_PROMPT)
    out["logit_diff"] = ring_gate("ssm mamba2-1.3b", params, batch, cfg, dev)
    out["sched"] = ssm_schedulers("mamba2-1.3b", params, cfg, dev)
    del params, batch
    torch.cuda.empty_cache()
    out["train"] = mamba_train(dev)
    return out


def ssm_hymba(dev):
    """hymba-1.5b at full width and depth: a counted generate with flash
    decode (B5 on the three global layers only, at indices past the 128
    meta positions), timed, its decode step as a CUDA graph; B5 at the
    decode site; the long prompt's prefill timed, then its f32 gates
    (blocked against quadratic attention, teacher-forced decode against
    model_apply); the slot pool, the arena and the small arena with B6."""
    from repro_torch.launch.serve import generator, synth_batch
    from repro_torch.serve import GenerateConfig, generate
    cfg = dec_cfg("hymba-1.5b")
    params, batch = dec_model(cfg, dev)
    n_global = len(cfg.hybrid.global_attn_layers)
    gen = GenerateConfig(max_new=MAX_NEW, eos_id=-1, flash_decode=True)
    counts, _, _ = dec_generate("hymba-1.5b", params, batch, cfg, gen,
                                lambda steps: {"flash_decode": n_global * steps})
    out = {"layers": cfg.n_layers, "launches": {k: v for k, v in counts.items() if v},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if counts["flash_decode"] != n_global * (MAX_NEW - 1):
        raise AssertionError(f"ssm hymba-1.5b: {counts['flash_decode']} B5 launches, not "
                             f"{n_global} (the global layers) a step")
    out["serve"] = dec_timed("hymba-1.5b", params, batch, cfg, gen, EAGER_ROUNDS)
    with Capture(names=("flash_decode",)) as cap:
        generate(params, batch, cfg, dataclasses.replace(gen, max_new=2))
    torch.cuda.synchronize()
    b5_args = cap.calls["flash_decode"][-1][0]
    del cap
    if int(torch.as_tensor(b5_args[3]).min()) < cfg.n_meta:
        raise AssertionError("ssm hymba-1.5b: B5's index does not count the meta tokens")
    out["b5"] = dict(dec_site("hymba-1.5b", "flash_decode", "decode", b5_args),
                     launches=counts["flash_decode"])
    out["decode_graph_ms"] = decode_graph("ssm hymba-1.5b", params, batch, cfg,
                                          out["serve"]["median"]["decode_ms_per_step"], dev)
    out["decode_profile"] = decode_profile("ssm hymba-1.5b", params, batch, cfg, dev)
    out["long_prefill"] = ssm_long_prefill("ssm hymba-1.5b", params, cfg, dev,
                                           HYMBA_LONG_PROMPT)
    long_batch = synth_batch(cfg, generator(dev, SEED, 2), SSM_LONG_ROWS, HYMBA_LONG_PROMPT)
    out["logit_diff"] = ring_gate("ssm hymba-1.5b", params, long_batch, cfg, dev)
    out["sched"] = ssm_schedulers("hymba-1.5b", params, cfg, dev)
    del params, batch, long_batch
    torch.cuda.empty_cache()
    return out


def ssm_lm(dev, n_steps=LM_STEPS):
    """Reduced mamba2-1.3b and hymba-1.5b, --task lm: ``n_steps`` f32 steps
    on the card and on the CPU from one init (drawn on the CPU), the loss
    and grad norm of each step within TRAIN_METRIC_RTOL of the CPU's, the
    parameters within ``adam_drift_bound``."""
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.data import LMTaskConfig, SyntheticLM
    from repro_torch.models import init_model
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.loop import to_device
    from repro_torch.tree import flatten_with_paths, tree_map
    tc = TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, seed=SEED, steps=n_steps)
    param_tol = adam_drift_bound(tc, n_steps)
    out = {}
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        base = reduced(get_config(arch))
        task = SyntheticLM(LMTaskConfig(vocab=base.vocab, seq_len=LM_SEQ))
        init = init_model(torch.Generator().manual_seed(SEED), base)
        res = {}
        for where, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
            state = init_train_state(tree_map(lambda t: t.detach().to(device).clone(), init),
                                     tc)
            step = make_train_step(base, tc)
            rows = []
            for i in range(n_steps):
                state, m = step(state, to_device(task.sample_batch(i, LM_BATCH), device))
                rows.append({k: float(m[k]) for k in ("loss", "grad_norm")})
            res[where] = (rows, {k: v.detach().cpu()
                                 for k, v in flatten_with_paths(state["params"]).items()})
        worst = max(abs(r[k] - q[k]) / max(abs(q[k]), 1e-6)
                    for r, q in zip(res["cuda"][0], res["cpu"][0]) for k in r)
        pmax = max(float((res["cuda"][1][k] - v).abs().max()) for k, v in res["cpu"][1].items())
        finite = all(math.isfinite(v) for r in res["cuda"][0] for v in r.values())
        log(f"ssm lm {arch} reduced f32 ({LM_BATCH} x {LM_SEQ} tokens): card "
            + "; ".join(f"loss {r['loss']:.6f} grad norm {r['grad_norm']:.6f}"
                        for r in res["cuda"][0])
            + f"; against the CPU's steps max relative diff {worst:.3e} (tol "
            f"{TRAIN_METRIC_RTOL}), parameters max abs diff {pmax:.3e} (tol {param_tol:.3e})")
        if not finite or worst > TRAIN_METRIC_RTOL or pmax > param_tol:
            raise AssertionError(f"ssm lm {arch}: the card's steps differ from the CPU's")
        out[arch] = dict(rows=res["cuda"][0], max_rel_diff=worst, param_max_abs_diff=pmax)
    return out


def ssm_phase(dev):
    """Phase ssm: mamba2-1.3b, then hymba-1.5b (each at full width and
    depth, freed before the next), then both reduced archs' --task lm."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"mamba2-1.3b": ssm_mamba(dev)}
    log(f"ssm mamba2-1.3b: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    out["hymba-1.5b"] = ssm_hymba(dev)
    log(f"ssm hymba-1.5b: {time.perf_counter() - t1:.1f} s")
    out["lm"] = ssm_lm(dev)
    out["wall_s"] = time.perf_counter() - t0
    log(f"ssm phase: {out['wall_s']:.1f} s")
    return out


def ssm_rows(ssm):
    """B5 and B6 at hymba-1.5b's decode sites for the kernel table, with
    the launches of the phase's generate (B5) and arena run (B6)."""
    hy = ssm["hymba-1.5b"]
    return {"flash_decode": {"hymba-1.5b decode": hy["b5"]},
            "flash_decode_paged": {"hymba-1.5b paged decode": hy["sched"]["b6"]}}


# ---------------------------------------------------------------------------
# phase vlm: the non-token frontends (llama-3.2-vision-90b, whisper-small)
# ---------------------------------------------------------------------------

VLM_LAYERS = 10                   # llama-3.2-vision-90b's depth cut: layers 0 and 5 gated
# the scheduler trace's first 8 requests on 3 slots: the later ones are
# admitted as others retire; in the small arena of 10 pages an even
# request finds an earlier even one's pages (one prompt prefix, one
# source) and a growing request preempts another, on both archs' traces
VLM_SCHED_N, VLM_SLOTS, VLM_PAGES_SMALL = 8, 3, 10
VLM_MT_STEPS, VLM_MT_ROWS, VLM_MT_SEQ = 3, 8, 32   # reduced whisper-small, --task mt


def vlm_cfg(arch: str, dtype=None):
    """The arch at full width (llama-3.2-vision-90b cut to VLM_LAYERS
    layers), activations in ``dtype`` (default the config's)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cut_depth
    cfg = get_config(arch)
    if cfg.vlm is not None:
        cfg = cut_depth(cfg, VLM_LAYERS)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def seed_gates(params, dev):
    """Every tanh gate set to a seeded value in [0.3, 1), in place: at the
    reference's zero init a gated layer adds exactly nothing, and nothing
    about it would be checked. Returns the values."""
    from repro_torch.tree import flatten_with_paths
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    out = {}
    for k, t in flatten_with_paths(params).items():
        if k.rsplit("/", 1)[-1] in ("gate_attn", "gate_ffn"):
            t.copy_(0.3 + 0.7 * torch.rand(t.shape, generator=g, device=dev))
            out[k] = [round(v, 4) for v in t.tolist()]
    return out


def n_self_attention(cfg) -> int:
    """Decoder layers with self-attention: each reads B5 (B6 paged) once a
    decode step; a VLM's gated layers have none."""
    from repro_torch.models import transformer as T
    return sum(seg.repeats for seg in T.layer_plan(cfg) for p in seg.pattern
               if p.mixer != "none")


def vlm_trace(cfg):
    """The first VLM_SCHED_N requests of phase 7's trace (prompts alone),
    each carrying f32 N(0, 1) conditioning inputs drawn from seed SEED + 13:
    the even requests (which share a 32-token prompt prefix) one image or
    one clip of frames, the odd ones each their own, so that a page is
    shared only under an equal source. Values are no whole numbers: a cast
    to int64 on admission would change every token that reads them."""
    import numpy as np
    rs = np.random.RandomState(SEED + 13)
    if cfg.vlm is not None:
        key, shape = "img_embeds", (cfg.vlm.n_image_tokens, cfg.vlm.d_image)
    else:
        key, shape = "frames", (cfg.encdec.encoder_seq, cfg.d_model)
    shared = rs.standard_normal(shape).astype(np.float32)
    reqs = sched_trace(cfg.vocab, sources=False)[:VLM_SCHED_N]
    for r in reqs:
        r.extras = {key: shared if r.rid % 2 == 0
                    else rs.standard_normal(shape).astype(np.float32)}
    return reqs


def vlm_scheduler(params, cfg, gen, paged=False, n_pages=0):
    """A fresh scheduler of phase 7's shape at VLM_SLOTS slots: the slot
    pool, or the page arena when ``paged`` (``n_pages`` pages, 0 for the
    default: VLM_SLOTS full-length requests' worth)."""
    from repro_torch.configs import PagedKVConfig
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import ContinuousScheduler, PagedScheduler
    kw = dict(n_slots=VLM_SLOTS, prefill_buckets=SCHED_BUCKETS, admit_width=VLM_SLOTS,
              registry=MetricsRegistry())
    if paged:
        return PagedScheduler(params, cfg, gen, paged=PagedKVConfig(
            page_size=PAGE_SIZE, n_slots_equiv=VLM_SLOTS, n_pages=n_pages), **kw)
    return ContinuousScheduler(params, cfg, gen, **kw)


def vlm_schedulers(label, params, cfg, dev):
    """``vlm_trace`` in f32 through the slot pool, the page arena and a
    VLM_PAGES_SMALL-page arena: every run's tokens against one-shot
    ``generate`` (near-ties allowed), the small arena's prefix hits (the
    even requests: one prompt prefix, one source) and preemptions;
    launches per run: B5 (B6 on the arenas) on every
    self-attention layer per decode tick, nothing else. Returns the stats
    and B6 at the arena's first decode tick against its plain version,
    bitwise B5, and timed."""
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.serve import GenerateConfig
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = GenerateConfig(max_new=TRACE_BUDGET, eos_id=-1, flash_decode=True)
    reqs = vlm_trace(cfg)
    n_self = n_self_attention(cfg)
    runs, out, todo = {}, {}, []
    runs["slot pool"], ss, c, w = run_scheduler(params, cfg32, gen, reqs,
                                                sched=vlm_scheduler(params, cfg32, gen))
    todo.append(("slot pool", ss, c, w, "flash_decode"))
    with Capture(names=("flash_decode_paged",)) as cap:
        runs["arena"], ps, c, w = run_scheduler(
            params, cfg32, gen, reqs, sched=vlm_scheduler(params, cfg32, gen, paged=True))
    todo.append(("arena", ps, c, w, "flash_decode_paged"))
    b6_args = cap.calls["flash_decode_paged"][0][0]
    del cap
    runs["small arena"], sm, c, w = run_scheduler(
        params, cfg32, gen, reqs,
        sched=vlm_scheduler(params, cfg32, gen, paged=True, n_pages=VLM_PAGES_SMALL))
    todo.append(("small arena", sm, c, w, "flash_decode_paged"))
    if sm.stats["prefix_hits"] == 0 or sm.stats["preemptions"] == 0:
        raise AssertionError(f"{label}: no prefix hit or no preemption in the small arena "
                             f"{sm.stats}")
    for name, sch, counts, wall, key in todo:
        want = {k: 0 for k in counts}
        want[key] = n_self * sch.stats["decode_steps"]
        log(f"vlm {label} {name} f32: {sch.stats}; launches {counts}, expected {want}; "
            f"{wall:.2f} s")
        if counts != want or sch.stats["finished"] != VLM_SCHED_N:
            raise AssertionError(f"{label} {name}: launches {counts} != {want} or {sch.stats}")
        out[name] = dict(sch.stats, wall_s=wall)
    checked = against_oneshot(params, cfg32, gen, reqs, runs, ss.max_seq, dev)
    for name, (n_equal, gaps) in checked.items():
        log(f"vlm {label} f32: {name}: {n_equal} of {VLM_SCHED_N} requests' tokens (each "
            f"with its own f32 source) equal one-shot B=1 generate; divergences (rid, first "
            f"token, top-two logit gap) {gaps}")
        if any(gap >= NEAR_TIE for _, _, gap in gaps):
            raise AssertionError(f"{label} {name}: a divergence from one-shot is not a near-tie")
        out[name].update(oneshot_equal=n_equal, gaps=gaps)
    out_b6 = FD.flash_decode_paged(*b6_args)
    torch.cuda.synchronize()
    err = check(f"{label} flash_decode_paged@decode", out_b6,
                plain_of("flash_decode_paged")(*b6_args))
    check(f"{label} flash_decode_paged vs B5", out_b6,
          FD.flash_decode(b6_args[0], *gathered(b6_args), b6_args[4]), exact=True)
    out["b6"] = dict(b6_timing(b6_args), max_abs_err=err,
                     launches=out["arena"]["decode_steps"] * n_self)
    return out


def cross_read(label, params, batch, cfg, dev):
    """One layer's plain cross-attention at a decode step (8 rows, one
    query each, against the cached K/V of the whole source: 1,601 image
    positions or 1,500 frames) in the model's dtype: device ms against the
    bytes it must move (the cached K/V, the query and output projections'
    weights, once each) over HBM's rate."""
    from repro_torch.models import attention as A
    from repro_torch.tree import tree_map
    seg = params["decoder"][0]["p0"]
    p = tree_map(lambda t: t[0], seg["cross"])
    rows = batch["tokens"].shape[0]
    src = next(batch[k] for k in ("img_embeds", "frames") if k in batch)
    n_src = src.shape[1]
    g = torch.Generator(device=dev).manual_seed(SEED + 37)
    shape = (rows, n_src, cfg.n_heads, cfg.head_dim_)
    ck = torch.randn(shape, generator=g, device=dev).to(cfg.torch_dtype)
    cv = torch.randn(shape, generator=g, device=dev).to(cfg.torch_dtype)
    h = torch.randn((rows, 1, cfg.d_model), generator=g, device=dev).to(cfg.torch_dtype)
    ms = device_ms(lambda: A.cross_attention_kv(p, h, ck, cv))
    nbytes = (2 * ck.numel() * ck.element_size()
              + sum(p[w].numel() * p[w].element_size() for w in ("wq", "wo")))
    b_ms = nbytes / PEAK_BYTES_S * 1e3
    log(f"vlm {label}: plain cross-attention read of one layer at decode ({rows} rows x "
        f"{n_src} source positions x {cfg.n_heads} heads of {cfg.head_dim_}, "
        f"{_dt(ck)} cache): {ms:.6f} ms on the device, bound {b_ms:.6f} ms (bytes: "
        f"{nbytes} of K/V and wq, wo)")
    return dict(ms=ms, bound_ms=b_ms, nbytes=nbytes, rows=rows, n_src=n_src)


def vlm_arch(arch, dev):
    """One arch at full width (llama-3.2-vision-90b at VLM_LAYERS layers,
    its gates seeded): a counted generate with flash decode (B5 once per
    self-attention layer a step, nothing else), timed, the decode step as
    one CUDA graph and by op; B5 at its decode site; one layer's plain
    cross-attention read; the f32 gates; the schedulers with B6."""
    from repro_torch.serve import GenerateConfig, generate
    t0 = time.perf_counter()
    cfg = vlm_cfg(arch)
    params, batch = dec_model(cfg, dev)
    out = {"layers": cfg.n_layers}
    if cfg.vlm is not None:
        out["gates"] = seed_gates(params, dev)
        log(f"vlm {arch}: gates seeded {out['gates']}")
    n_self = n_self_attention(cfg)
    src = {k: tuple(v.shape) for k, v in batch.items() if k != "tokens"}
    log(f"vlm {arch}: {n_self} self-attention layers of {cfg.n_layers}; conditioning "
        f"inputs {src}")
    gen = GenerateConfig(max_new=MAX_NEW, eos_id=-1, flash_decode=True)
    counts, _, _ = dec_generate(arch, params, batch, cfg, gen,
                                lambda steps: {"flash_decode": n_self * steps})
    out.update(launches={k: v for k, v in counts.items() if v},
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    out["serve"] = dec_timed(arch, params, batch, cfg, gen, EAGER_ROUNDS)
    out["decode_graph_ms"] = decode_graph(f"vlm {arch}", params, batch, cfg,
                                          out["serve"]["median"]["decode_ms_per_step"], dev)
    out["decode_profile"] = decode_profile(f"vlm {arch}", params, batch, cfg, dev)
    with Capture(names=("flash_decode",)) as cap:
        generate(params, batch, cfg, dataclasses.replace(gen, max_new=2))
    torch.cuda.synchronize()
    b5_args = cap.calls["flash_decode"][-1][0]
    del cap
    out["b5"] = dict(dec_site(arch, "flash_decode", "decode", b5_args),
                     launches=counts["flash_decode"])
    out["cross_read"] = cross_read(arch, params, batch, cfg, dev)
    d_pre, d_dec = e2e_phase(params, batch, cfg, gen, dev, label=f"vlm {arch} e2e")
    out["e2e_logit_diff"] = dict(prefill=d_pre, decode=d_dec)
    out["sched"] = vlm_schedulers(arch, params, cfg, dev)
    del params, batch
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"vlm {arch}: {out['wall_s']:.1f} s")
    return out


def vlm_mt(dev, n_steps=VLM_MT_STEPS):
    """Reduced whisper-small, --task mt (the encoder on source tokens, as
    the reference's ``--task mt`` runs it): ``n_steps`` f32 steps on the
    card and on the CPU from one init (drawn on the CPU), the loss and grad
    norm of each step within TRAIN_METRIC_RTOL of the CPU's, the
    parameters within ``adam_drift_bound``."""
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.data import MTTaskConfig, MultilingualMT
    from repro_torch.models import init_model
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.loop import to_device
    from repro_torch.tree import flatten_with_paths, tree_map
    tc = TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, seed=SEED, steps=n_steps)
    param_tol = adam_drift_bound(tc, n_steps)
    base = reduced(get_config("whisper-small"))
    batches = MultilingualMT(MTTaskConfig(vocab=base.vocab, n_langs=TRAIN_LANGS,
                                          max_len=VLM_MT_SEQ)).train_batches(VLM_MT_ROWS)
    init = init_model(torch.Generator().manual_seed(SEED), base)
    res = {}
    for where, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
        state = init_train_state(tree_map(lambda t: t.detach().to(device).clone(), init), tc)
        step = make_train_step(base, tc)
        rows = []
        for i in range(n_steps):
            state, m = step(state, to_device(batches(i), device))
            rows.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        res[where] = (rows, {k: v.detach().cpu()
                             for k, v in flatten_with_paths(state["params"]).items()})
    worst = max(abs(r[k] - q[k]) / max(abs(q[k]), 1e-6)
                for r, q in zip(res["cuda"][0], res["cpu"][0]) for k in r)
    pmax = max(float((res["cuda"][1][k] - v).abs().max()) for k, v in res["cpu"][1].items())
    finite = all(math.isfinite(v) for r in res["cuda"][0] for v in r.values())
    log(f"vlm mt whisper-small reduced f32 ({VLM_MT_ROWS} x {VLM_MT_SEQ} target + source "
        "tokens): card " + "; ".join(f"loss {r['loss']:.6f} grad norm {r['grad_norm']:.6f}"
                                    for r in res["cuda"][0])
        + f"; against the CPU's steps max relative diff {worst:.3e} (tol "
        f"{TRAIN_METRIC_RTOL}), parameters max abs diff {pmax:.3e} (tol {param_tol:.3e})")
    if not finite or worst > TRAIN_METRIC_RTOL or pmax > param_tol:
        raise AssertionError("vlm mt whisper-small: the card's steps differ from the CPU's")
    return dict(rows=res["cuda"][0], max_rel_diff=worst, param_max_abs_diff=pmax)


def vlm_phase(dev):
    """Phase vlm: llama-3.2-vision-90b (full width, VLM_LAYERS layers), then
    whisper-small (full size), each freed before the next, then reduced
    whisper-small's --task mt steps."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"llama-3.2-vision-90b": vlm_arch("llama-3.2-vision-90b", dev),
           "whisper-small": vlm_arch("whisper-small", dev),
           "mt": vlm_mt(dev)}
    out["wall_s"] = time.perf_counter() - t0
    log(f"vlm phase: {out['wall_s']:.1f} s")
    return out


def vlm_rows(vlm):
    """B5 at both archs' decode sites and B6 at their arenas' for the
    kernel table, with the launches of the phase's generate (B5) and arena
    run (B6)."""
    rows = {"flash_decode": {}, "flash_decode_paged": {}}
    for arch in ("llama-3.2-vision-90b", "whisper-small"):
        rows["flash_decode"][f"{arch} decode"] = vlm[arch]["b5"]
        rows["flash_decode_paged"][f"{arch} paged decode"] = vlm[arch]["sched"]["b6"]
    return rows


def dryrun_phase(full, dev, state_info=None, sweep=True):
    """Phase dryrun: every applicable pair (``sweep``; else each arch's
    train_4k pair, one per arch) on both production meshes on the meta
    device, memory_allocated unchanged across it; then zcode-m3-base's
    phase-6 state bytes, the dry run's one-device count against the state
    on the card (``state_info`` from phase 6, else built here)."""
    from repro_torch.configs import INPUT_SHAPES, applicable_pairs, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import MeshShape, production_mesh
    t0 = time.perf_counter()
    meshes = [production_mesh(), production_mesh(multi_pod=True)]
    pairs = list(applicable_pairs())
    if not sweep:
        pairs = [(a, "train_4k") for a in sorted({a for a, _ in pairs})]
    want = DRYRUN_PAIRS if sweep else DRYRUN_ARCHS
    jobs = [(get_config(a), INPUT_SHAPES[s]) for a, s in pairs]
    workers = os.cpu_count() or 1           # run_all's default: one process a core
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    results, failures = D.run_all(jobs, meshes, out_dir=OUT.parent / "dryrun")
    torch.cuda.synchronize()
    delta = torch.cuda.memory_allocated() - before
    run_s = time.perf_counter() - t0
    for line in failures:
        log(f"dryrun {line}: FAIL")
    rows = {}
    for (cfg, shape), got in zip(jobs, results):
        if got is None:
            continue
        row = {"seconds": got[0]["seconds"], "flops_step": got[0]["flops_step"]}
        for res, mesh in zip(got, meshes):
            mem = res["memory"]
            row[mesh.name] = {"argument_bytes_per_device": mem["argument_bytes_per_device"],
                              "a2a_bytes": res["collectives"]["all-to-all"]["bytes"]}
            if "saved_activation_bytes_per_device" in mem:
                row[mesh.name]["saved_bytes_per_device"] = \
                    mem["saved_activation_bytes_per_device"]
        rows[f"{cfg.arch_id} x {shape.name}"] = row
        log(f"dryrun {cfg.arch_id} x {shape.name}: {row['seconds']:.2f} s of steps, "
            f"{row['flops_step']:.4g} FLOPs/step; per device "
            + "; ".join(f"{m.name} arg {row[m.name]['argument_bytes_per_device'] / 2**30:.3f} GiB"
                        + (f", saved <= {row[m.name]['saved_bytes_per_device'] / 2**30:.3f} GiB"
                           if "saved_bytes_per_device" in row[m.name] else "")
                        for m in meshes))
    ok = {m.name: sum(1 for got in results if got is not None) for m in meshes}
    log(f"dryrun: {ok} of {len(jobs)} pairs ok on each mesh in {run_s:.1f} s on {workers} "
        f"processes; memory_allocated delta over the run {delta} B")
    if failures or len(jobs) != want or any(n != want for n in ok.values()):
        raise AssertionError(f"dryrun: {len(failures)} failed of {len(jobs)} (want {want})")
    if delta != 0:
        raise AssertionError(f"dryrun: memory_allocated moved by {delta} B")

    # zcode-m3-base's phase-6 state: the dry run's count on one device
    cfg = train_cfg(full, "cuda_fused", "bfloat16")
    tc = train_tc(WARMUP_STEPS + TIMED_STEPS + 5)
    one = MeshShape(("data", "model"), (1, 1))
    meta_state = D.step_arguments(cfg, INPUT_SHAPES["train_4k"])["state"]
    dry_bytes = D.argument_bytes(cfg, one, {"state": meta_state})
    if tc.moment_dtype != D.train_config(cfg).moment_dtype:
        raise AssertionError("phase 6's optimizer keeps moments the dry run does not")
    source = "phase 6"
    if state_info is None:
        state, state_info = built_state(cfg, tc, dev)
        del state
        torch.cuda.empty_cache()
        source = "built here"
    log(f"dryrun: zcode-m3-base train state: dry run (1 x 1 mesh) {dry_bytes} B, the card's "
        f"state ({source}) {state_info['state_bytes']} B, memory_allocated delta of its build "
        f"{state_info['state_alloc_delta']} B")
    if dry_bytes != state_info["state_bytes"]:
        raise AssertionError(f"dryrun: state bytes {dry_bytes} != {state_info['state_bytes']}")
    wall = time.perf_counter() - t0
    log(f"dryrun phase: {wall:.1f} s")
    return {"pairs": rows, "ok": ok, "workers": workers, "run_s": run_s,
            "memory_allocated_delta": delta, "zcode_state_bytes": dry_bytes,
            "zcode_state": dict(state_info, source=source), "wall_s": wall}


def lint_phase():
    """Phase lint: the lint gate on the card, ``python -m
    repro_torch.launch.lint --gate --device cuda --json-out
    build/lint/report.json`` as a subprocess (its 8 gloo ranks share the
    card); exit 0 asserted, every applicable (executable, pass) cell of
    the 27 ok, launch-count (the profiler's kernel launches equal to the
    wrappers' calls) and smem-budget (each launched kernel within 227 KiB
    of shared memory per block) included, and a kernel report for every
    executable that launches one. Returns the cells, each launched
    kernel's shared bytes, registers and spills, and the seconds."""
    t0 = time.perf_counter()
    out = REPO / "build" / "lint" / "report.json"
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                               if p]))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.lint", "--gate", "--device",
                        "cuda", "--json-out", str(out)], capture_output=True, text=True,
                       env=env, cwd=REPO, timeout=900)
    wall = time.perf_counter() - t0
    for line in r.stdout.strip().splitlines()[-12:]:
        log(f"lint: {line}")
    if r.returncode != 0:
        raise AssertionError(f"lint: the gate exited {r.returncode}:\n{r.stdout[-4000:]}\n"
                             f"{r.stderr[-4000:]}")
    doc = json.loads(out.read_text())
    cells = doc["cells"]
    bad = {f"{n} :: {p}": c for n, row in cells.items() for p, c in row.items() if c != "ok"}
    n_cells = sum(len(row) for row in cells.values())
    log(f"lint: {len(cells)} executables, {n_cells} cells, not ok: {bad or 'none'}")
    if not doc["ok"] or bad or len(cells) != LINT_EXECUTABLES:
        raise AssertionError(f"lint: cells not ok {bad}, {len(cells)} executables")
    kernels = {}
    for name, row in cells.items():
        if "smem-budget" not in row:
            continue
        res = doc["resources"].get(name, {})
        launched = res.get("launches", {}).get("kernels")
        if not res.get("kernels") or not launched or not any(launched.values()):
            raise AssertionError(f"lint {name}: no kernel launch or report from the card: {res}")
        kernels[name] = [{k: v[k] for k in ("kernel", "wrapper", "launches", "smem_bytes",
                                            "launch_smem_bytes", "registers", "spill_bytes")}
                         for v in res["kernels"]]
        for v in kernels[name]:
            log(f"lint {name}: {v['kernel']} ({v['wrapper']}) x{v['launches']}: "
                f"{v['smem_bytes']} B shared per block ({v['launch_smem_bytes']} B at the "
                f"launch), {v['registers']} registers, {v['spill_bytes']} B spilled")
    log(f"lint phase: {wall:.1f} s")
    return {"cells": cells, "kernels": kernels, "verdict": doc["verdict"], "wall_s": wall}


def kernel_table(errs, timing, counts, t_errs, t_timing, t_counts, paged, b4_serve, fc,
                 dec_sites=None, swa_sites=None, mla_sites=None, ssm_sites=None,
                 vlm_sites=None):
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
    depth 1,023 as one CUDA graph; each kernel its phase-dec sites
    (``dec_sites``: yi-6b's decode, dbrx-132b's prefill and decode, with
    the launches of that phase's generate or scheduler run) and its
    phase-swa sites (``swa_sites``: B5 and B6 at yi-6b's long cache, B1-B4
    at dbrx-132b's long prefill) and its phase-mla sites (``mla_sites``:
    B1-B4 at deepseek-v3-671b's decode and long prefill, with the launches
    of that phase's generate) and its phase-ssm sites (``ssm_sites``: B5
    and B6 at hymba-1.5b's decode, rep 5, past its 128 meta positions,
    with the launches of that phase's generate or arena run) and its
    phase-vlm sites (``vlm_sites``: B5 and B6 at llama-3.2-vision-90b's
    decode, rep 8 over 64 heads, and at whisper-small's, rep 1 over 12,
    with the launches of that phase's generate or arena run)."""
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
    for entry in kernels:
        if dec_sites and entry["name"] in dec_sites:
            entry["dec_sites"] = dec_sites[entry["name"]]
        if swa_sites and entry["name"] in swa_sites:
            entry["swa_sites"] = swa_sites[entry["name"]]
        if mla_sites and entry["name"] in mla_sites:
            entry["mla_sites"] = mla_sites[entry["name"]]
        if ssm_sites and entry["name"] in ssm_sites:
            entry["ssm_sites"] = ssm_sites[entry["name"]]
        if vlm_sites and entry["name"] in vlm_sites:
            entry["vlm_sites"] = vlm_sites[entry["name"]]
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
    ap.add_argument("--only", choices=("full_cache", "sites", "ep", "tp", "obs", "dec", "swa",
                                       "mla", "ssm", "vlm", "dryrun", "lint"),
                    help="run phases 1, 2 and this phase alone")
    ap.add_argument("--tp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.tp_rank is not None:          # one rank of phase tp, started by it
        return tp_rank_main(args.tp_rank, args.tp_dir)
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
    if args.only == "sites":
        ptxas_report(lib.parent / "nvcc.log")
        print(json.dumps({"sites": sites_phase(dev)}), flush=True)
        return 0
    if args.only == "ep":
        print(json.dumps({"ep": ep_phase(full, dev)}), flush=True)
        return 0
    if args.only == "tp":
        print(json.dumps({"tp": tp_phase(full, dev)}), flush=True)
        return 0
    if args.only == "obs":
        print(json.dumps({"obs": obs_phase(full, dev)}), flush=True)
        return 0
    if args.only == "dec":
        dec = dec_phase(dev, b4_report())
        print(json.dumps({"dec": dec_json(dec), "dec_sites": dec_rows(dec)}), flush=True)
        return 0
    if args.only == "swa":
        swa = swa_phase(dev)
        print(json.dumps({"swa": swa, "swa_sites": swa_rows(swa)}), flush=True)
        return 0
    if args.only == "mla":
        mla = mla_phase(dev)
        print(json.dumps({"mla": mla_json(mla), "mla_sites": mla_rows(mla)}), flush=True)
        return 0
    if args.only == "ssm":
        ssm = ssm_phase(dev)
        print(json.dumps({"ssm": ssm, "ssm_sites": ssm_rows(ssm)}), flush=True)
        return 0
    if args.only == "vlm":
        vlm = vlm_phase(dev)
        print(json.dumps({"vlm": vlm, "vlm_sites": vlm_rows(vlm)}), flush=True)
        return 0
    if args.only == "dryrun":
        print(json.dumps({"dryrun": dryrun_phase(full, dev)}), flush=True)
        return 0
    if args.only == "lint":
        print(json.dumps({"lint": lint_phase()}), flush=True)
        return 0
    b4_info = ptxas_report(lib.parent / "nvcc.log")
    seconds = {"device and build": time.perf_counter() - t_start}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    # 3-5, 7 and 8. serving
    errs, timing, counts, paged, b4_serve, fc = phase("serving (3-5, 7, 8)", serve_phases,
                                                      full, dev)
    torch.cuda.empty_cache()
    log(f"device memory now allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # 6. training
    def training():
        captured = train_parity(full, dev)
        t_errs, t_timing = train_kernel_phase(captured, dev)
        del captured
        torch.cuda.empty_cache()
        t_counts, t_slice = {}, {}
        for backend in ("cuda_fused", "cuda"):
            t_counts[backend], t_slice[backend] = train_slice(full, dev, backend)
        return t_errs, t_timing, t_counts, t_slice

    t_errs, t_timing, t_counts, t_slice = phase("training (6)", training)
    print(json.dumps({"train": {b: {k: v for k, v in t.items()}
                                for b, t in t_slice.items()}}), flush=True)

    # ep. the expert-parallel path under a one-rank group
    print(json.dumps({"ep": phase("ep", ep_phase, full, dev)}), flush=True)
    # tp. the model axis: B1 on d_ff slices, --mesh 1,2 on the one card
    print(json.dumps({"tp": phase("tp", tp_phase, full, dev)}), flush=True)
    # obs. the observability layer over the trainer and both schedulers
    print(json.dumps({"obs": phase("obs", obs_phase, full, dev)}), flush=True)
    # dec. the decoder-only family: yi-6b, dbrx-132b (2 layers), --task lm
    dec = phase("dec", dec_phase, dev, b4_info)
    print(json.dumps({"dec": dec_json(dec)}), flush=True)
    # swa. sliding-window archs, exact-length prefill, the long-prompt sites
    swa = phase("swa", swa_phase, dev)
    print(json.dumps({"swa": swa}), flush=True)
    # mla. deepseek-v3-671b (2 layers): MLA, 256 experts top-8, MTP training
    mla = phase("mla", mla_phase, dev)
    print(json.dumps({"mla": mla_json(mla)}), flush=True)
    # ssm. mamba2-1.3b and hymba-1.5b at full width and depth, --task lm
    ssm = phase("ssm", ssm_phase, dev)
    print(json.dumps({"ssm": ssm}), flush=True)
    # vlm. llama-3.2-vision-90b (10 layers) and whisper-small: image and audio sources
    vlm = phase("vlm", vlm_phase, dev)
    print(json.dumps({"vlm": vlm}), flush=True)
    # dryrun. each arch's train_4k pair on the meta device, both meshes
    # (--only dryrun: all 34 applicable pairs)
    state_info = {k: t_slice["cuda_fused"][k] for k in ("state_bytes", "state_alloc_delta")}
    print(json.dumps({"dryrun": phase("dryrun", dryrun_phase, full, dev, state_info, False)}),
          flush=True)
    # lint. the lint gate over the port's 27 executables, on the card
    print(json.dumps({"lint": phase("lint", lint_phase)}), flush=True)
    seconds["total"] = time.perf_counter() - t_start
    print(json.dumps({"phase_seconds": seconds}), flush=True)

    kernels = kernel_table(errs, timing, counts, t_errs, t_timing, t_counts, paged, b4_serve,
                           fc, dec_rows(dec), swa_rows(swa), mla_rows(mla), ssm_rows(ssm),
                           vlm_rows(vlm))
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


# --only sites: B2, B3, B5 and B6 at the kernel table's shapes on seeded inputs.
# B5: (label, rows, query heads, kv heads, head dim, positions, cache
# dtype), every row at position - 2; starcoder2-3b's grouping (rep 12: two
# head groups) reaches B5 on no shipped path (its layers read a ring)
B5_SITES = (("zcode-m3-base", 8, 8, 8, 64, 34, torch.bfloat16),
            ("whisper-small", 8, 12, 12, 64, 34, torch.bfloat16),
            ("yi-6b", 8, 32, 4, 128, 34, torch.bfloat16),
            ("dbrx-132b", 8, 48, 8, 128, 34, torch.bfloat16),
            ("llama-3.2-vision-90b", 8, 64, 8, 128, 34, torch.bfloat16),
            ("hymba-1.5b", 8, 25, 5, 64, 162, torch.bfloat16),
            ("yi-6b long", 2, 32, 4, 128, 3586, torch.bfloat16),
            ("starcoder2-3b rep 12", 8, 24, 2, 128, 34, torch.bfloat16),
            ("starcoder2-3b rep 12, f32 cache", 8, 24, 2, 128, 34, torch.float32))
# B6: (label, rows, query heads, kv heads, head dim, pages a row, arena
# dtype), pages of 16 in a seeded permutation, row i at (i + 1) / rows of
# its pages
B6_SITES = (("zcode-m3-base", 9, 8, 8, 64, 6, torch.bfloat16),
            ("whisper-small", 4, 12, 12, 64, 6, torch.float32),
            ("llama-3.2-vision-90b", 4, 64, 8, 128, 6, torch.float32),
            ("yi-6b", 9, 32, 4, 128, 6, torch.float32),
            ("hymba-1.5b", 9, 25, 5, 64, 14, torch.float32),
            ("yi-6b long", 3, 32, 4, 128, 226, torch.float32))
# B3: (label, tokens, k, experts, slots an expert, d, dtype); each token's k
# slots on distinct experts, a tenth dropped
B3_SITES = (("zcode-m3-base decode", 8, 1, 128, 1, 512, torch.bfloat16),
            ("zcode-m3-base prefill", 256, 1, 128, 4, 512, torch.bfloat16),
            ("zcode-m3-base training", 1024, 1, 128, 8, 512, torch.float32),
            ("dbrx-132b decode", 8, 4, 16, 4, 6144, torch.bfloat16),
            ("dbrx-132b prefill", 256, 4, 16, 128, 6144, torch.bfloat16),
            ("dbrx-132b long prefill", 2304, 4, 16, 1152, 6144, torch.bfloat16),
            ("deepseek-v3-671b decode", 8, 8, 256, 1, 7168, torch.bfloat16),
            ("deepseek-v3-671b long prefill", 2048, 8, 256, 128, 7168, torch.bfloat16))
# B2 at B3's sites: the same routing (k distinct experts a token, C slots an
# expert), its slot tables as the router fills them (a slot past an
# expert's capacity dropped, an unfilled one invalid)
B2_SITES = B3_SITES
DISPATCH_PLANS = ((1, False), (2, False), (1, True), (2, True))   # the kernel's instances


def routed_tables(t: int, k: int, e: int, c: int, g) -> tuple:
    """(slot_token, slot_valid) of t tokens routed to k distinct experts
    each (seeded), filled in token order into e experts of c slots."""
    dev = g.device
    experts = torch.rand(t, e, generator=g, device=dev).argsort(dim=1)[:, :k].reshape(-1)
    pos = F.one_hot(experts, e).cumsum(0).gather(1, experts[:, None])[:, 0] - 1
    kept = pos < c
    slot = (experts * c + pos)[kept]
    st = torch.zeros(e * c, dtype=torch.int32, device=dev)
    sv = torch.zeros(e * c, dtype=torch.bool, device=dev)
    st[slot] = (torch.arange(t * k, device=dev) // k)[kept].to(torch.int32)
    sv[slot] = True
    return st, sv


def dispatch_site(label, args):
    """B2 at one site: bitwise its plain version on the plan
    ``dispatch_plan`` picks (words a thread, evict-first stores) and on
    each other instance, then ``time_site`` (in turns with
    ``index_select``) and the other instances timed in turns with the
    plan's."""
    from repro_torch.kernels import moe_dispatch
    x, st, sv = args
    out = kernel_of("dispatch")(*args)
    torch.cuda.synchronize()
    check(f"dispatch@{label}", out, plain_of("dispatch")(*args), exact=True)
    t = time_site("dispatch", label, args)

    def forced(plan):
        def run():
            y = torch.empty((st.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
            moe_dispatch.launch_dispatch(x, st, sv, y, plan=plan)
            return y
        return run

    plan = (t["per_thread"], t["stream"])
    others = [p for p in DISPATCH_PLANS if p != plan]
    for p in others:
        check(f"dispatch@{label} plan {p}", forced(p)(), out, exact=True)
    ms = in_turns(forced(plan), *(forced(p) for p in others))
    name = lambda p: f"{p[0]} {'evict-first' if p[1] else 'plain'}"  # noqa: E731
    t["plan_ms"] = {name(p): m for p, m in zip([plan, *others], ms)}
    t["valid_slots"] = int(sv.sum())
    log(f"  dispatch@{label}: {t['valid_slots']} of {st.shape[0]} slots valid; (words a thread, "
        f"stores) -> ms in turns {t['plan_ms']}")
    return t


def sites_phase(dev):
    """``--only sites``: B5, B6, B3 and B2 at the shapes of the kernel
    table's rows (B5_SITES, B6_SITES, B3_SITES, B2_SITES) on seeded inputs,
    each checked against its plain version and timed in turns with its
    library call (``time_site``, ``b6_timing``, ``combine_site``: B3 also
    on the grid its plan did not pick; ``dispatch_site``: B2 also on the
    instances its plan did not pick). The quick way to compare two
    trees' B2, B3, B5 and B6 in one call; the table's own rows come from
    the main path's inputs in the whole run."""
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    out = {"flash_decode": {}, "flash_decode_paged": {}, "combine": {}, "dispatch": {}}
    for label, b, h, kv, hd, s, dt in B5_SITES:
        q = torch.randn(b, h, hd, generator=g, device=dev)
        k, v = (torch.randn(b, s, kv, hd, generator=g, device=dev).to(dt) for _ in range(2))
        args = (q, k, v, torch.full((b,), s - 2, dtype=torch.int32, device=dev))
        check(f"flash_decode@{label}", kernel_of("flash_decode")(*args),
              plain_of("flash_decode")(*args))
        out["flash_decode"][label] = time_site("flash_decode", label, args)
    for label, b, h, kv, hd, nb, dt in B6_SITES:
        q = torch.randn(b, h, hd, generator=g, device=dev)
        k, v = (torch.randn(b * nb + 1, PAGE_SIZE, kv, hd, generator=g, device=dev).to(dt)
                for _ in range(2))
        tables = torch.randperm(b * nb, generator=g, device=dev).reshape(b, nb).to(torch.int32)
        idx = torch.tensor([(i + 1) * nb * PAGE_SIZE // b - 1 for i in range(b)],
                           dtype=torch.int32, device=dev)
        args = (q, k, v, tables, idx)
        out6 = kernel_of("flash_decode_paged")(*args)
        check(f"flash_decode_paged@{label}", out6, plain_of("flash_decode_paged")(*args))
        check(f"flash_decode_paged@{label} vs B5", out6,
              kernel_of("flash_decode")(q, *gathered(args), idx), exact=True)
        log(f"B6 site {label}:")
        out["flash_decode_paged"][label] = b6_timing(args)
    for label, t, k, e, c, d, dt in B3_SITES:
        buf = torch.randn(e * c, d, generator=g, device=dev).to(dt)
        experts = torch.rand(t, e, generator=g, device=dev).argsort(dim=1)[:, :k]
        ts = (experts * c + torch.randint(0, c, (t, k), generator=g, device=dev))
        w = torch.rand(t, k, generator=g, device=dev)
        keep = torch.rand(t, k, generator=g, device=dev) < 0.9
        out["combine"][label] = combine_site(label, (buf, ts.to(torch.int32), w, keep))
    for label, t, k, e, c, d, dt in B2_SITES:
        x = torch.randn(t, d, generator=g, device=dev).to(dt)
        out["dispatch"][label] = dispatch_site(label, (x, *routed_tables(t, k, e, c, g)))
    return out


def ptxas_report(path: Path):
    """Each kernel's registers and spills from the build's ptxas report,
    and what the card reports for B1's, B5's, B6's and B4's variants.
    Returns ``b4_report``'s."""
    import re
    import shutil
    from repro_torch.kernels import flash_decode, grouped_ffn, moe_dispatch
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
    for kind in ("stream_fwd", "stream_dx", "stream_dw"):
        for dt in (torch.float32, torch.bfloat16):
            infos = {c: grouped_ffn.variant_info(kind, dt, c) for c in (1, 4, 8, 16)}
            log(f"B1 {kind} {_dt(torch.empty(0, dtype=dt))} (C rounded up to 1/4/8/16): "
                + "; ".join(f"C={c}: {i['registers']} registers, {i['smem_bytes']} B shared, "
                            f"{i['spill_bytes']} B spilled, {i['blocks_per_sm']} blocks/SM"
                            for c, i in infos.items()))
    for kind in ("tiled_fwd", "tiled_dx", "tiled_dw"):
        for dt in (torch.float32, torch.bfloat16):
            infos = {vec: grouped_ffn.variant_info(kind, dt, 128, vec) for vec in (True, False)}
            plan = grouped_ffn.tiled_plan(kind[6:], 1, 128, 128, 128, dt.itemsize)["smem_bytes"]
            if any(i["smem_bytes"] != plan for i in infos.values()):
                raise AssertionError(f"B1 {kind}: shared memory {infos}, tiled_plan {plan}")
            log(f"B1 {kind} {_dt(torch.empty(0, dtype=dt))} (any C; tiled_plan {plan} B): "
                + "; ".join(f"{'16-byte' if vec else 'element'} loads: {i['registers']} "
                            f"registers, {i['smem_bytes']} B shared, {i['spill_bytes']} B "
                            f"spilled, {i['blocks_per_sm']} blocks/SM"
                            for vec, i in infos.items()))
    for paged in (False, True):
        for qdt, kvdt in ((torch.float32, torch.bfloat16), (torch.float32, torch.float32),
                          (torch.bfloat16, torch.bfloat16)):
            infos = {(hd, rep): flash_decode.variant_info(paged, qdt, kvdt, hd, rep)
                     for hd, rep in ((64, 1), (128, 1), (64, 5), (128, 8), (128, 12))}
            log(f"{'B6' if paged else 'B5'} q {_dt(torch.empty(0, dtype=qdt))}, cache "
                f"{_dt(torch.empty(0, dtype=kvdt))} (128 positions per split, pages of 16): "
                + "; ".join(f"hd={hd} rep={rep}: {i['registers']} registers, "
                            f"{i['smem_bytes']} B shared, {i['spill_bytes']} B spilled, "
                            f"{i['blocks_per_sm']} blocks/SM"
                            for (hd, rep), i in infos.items()))
    infos = {(word, n, cs): moe_dispatch.variant_info("dispatch", word=word, per_thread=n,
                                                      stream=cs)
             for word in (16, 4) for n, cs in DISPATCH_PLANS}
    log("B2 (words of 16 or 4 bytes, 1-2 a thread, plain or evict-first stores): " + "; ".join(
        f"{word} B x {n}{' cs' if cs else ''}: {i['registers']} registers, {i['spill_bytes']} B "
        f"spilled, {i['blocks_per_sm']} blocks/SM" for (word, n, cs), i in infos.items()))
    for dt in (torch.float32, torch.bfloat16):
        infos = {(grid, k): moe_dispatch.variant_info("combine", dt, k=k, cols=grid == "cols")
                 for grid in ("rows", "cols") for k in (1, 8)}
        log(f"B3 {_dt(torch.empty(0, dtype=dt))} (16-byte words): "
            + "; ".join(f"{grid} k={'1' if k == 1 else 'K'}: {i['registers']} registers, "
                        f"{i['spill_bytes']} B spilled, {i['blocks_per_sm']} blocks/SM"
                        for (grid, k), i in infos.items()))
    return b4_report()


def b4_report():
    """What the card reports for B4's variants, logged; returns them by
    "kind dtype", then by C."""
    from repro_torch.kernels import moe_megakernel
    out = {}
    for kind, what, cs in (("stream", "ungated; 128 experts; C rounded up to 1/4/8/16",
                            (1, 4, 8, 16)),
                           ("tiled", "ungated; 128 experts of C slots", (128, 1152)),
                           ("tiled_gated", "gated; 128 experts of C slots", (128, 1152))):
        for dt in (torch.float32, torch.bfloat16):
            infos = {c: moe_megakernel.variant_info(kind, dt, c) for c in cs}
            for c, i in infos.items():
                if kind == "stream":
                    continue
                plan = moe_megakernel.tiled_plan(128, c, 512, 512, dt.itemsize,
                                                 kind == "tiled_gated")["smem_bytes"]
                if i["smem_bytes"] != plan:
                    raise AssertionError(f"B4 {kind} C={c}: shared memory {i['smem_bytes']}, "
                                         f"tiled_plan {plan}")
            out[f"{kind} {_dt(torch.empty(0, dtype=dt))}"] = infos
            log(f"B4 {kind} {_dt(torch.empty(0, dtype=dt))} ({what}): "
                + "; ".join(f"C={c}: {i['registers']} registers, {i['smem_bytes']} B shared, "
                            f"{i['spill_bytes']} B spilled, {i['blocks_per_sm']} blocks/SM"
                            for c, i in infos.items()))
    return out


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
