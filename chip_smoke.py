#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device   -- the card's name and power limit (nvidia-smi);
  2. build    -- compile every kernel of src/repro_torch/kernels/csrc;
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the inputs captured from the main path's first prefill
                 and first decode step, plus ragged cases; times against
                 the bytes/FLOP bound, the plain version and one library
                 call;
  4. slice    -- zcode-m3-base at full width and depth (bf16 activations,
                 f32 params, random weights from a seed) generates for 8
                 requests through the kernel backend with flash decode; the
                 kernels' launch counts over one call are asserted, and the
                 call is timed over several rounds (median and spread);
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
                 after K); B4 and B1's backward kernels against their plain
                 versions at the inputs captured from the first step, plus
                 ragged cases, and timed; then both kernel backends in the
                 model's own dtype (bf16 activations): launch counts per
                 step asserted (routed, Gate-Drop and Gate-Expert-Drop
                 steps), step time, tokens/s, peak memory, a CUDA-event
                 split into forward, backward and Adam, and the device's
                 busy time from a torch.profiler trace.

Prints the kernel table as one JSON line before the last line and, as the
last line, {"ok": true, "device": {...}}. Needs one CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
}


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
        x, w_in, w_gate, w_out, topk_w, keep, st, sv, ts = args
        e, d, f = w_in.shape
        cap = st.shape[0] // e
        # only experts holding a kept slot need their weights, only kept
        # slots need FLOPs (this run's routing)
        valid = sv.reshape(e, cap)
        live = int(valid.any(1).sum())
        n_slots = int(valid.sum())
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
    raise KeyError(name)


# ---------------------------------------------------------------------------
# phase 3: kernels against plain versions
# ---------------------------------------------------------------------------

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
                "flash_decode": flash_decode}
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

            rec.launches = 0      # the original bumps `<name>.launches`
            self.saved.append((mod, name, orig))
            setattr(mod, name, rec)
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
            "flash_decode": ref.flash_decode_ref}[name]


def kernel_of(name):
    from repro_torch.kernels import wrappers
    return wrappers()[name]


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
        # combine: k=1 and k=2, vector and scalar paths, all dropped
        for t, k, s, d in ((32, 1, 64, 512), (32, 2, 48, 512), (7, 2, 5, 100)):
            buf = rn(s, d, dtype=dt)
            keep = torch.rand(t, k, generator=g, device=dev) < 0.8
            cases.append(("combine", (buf, ri(0, s, t, k),
                                      torch.rand(t, k, generator=g, device=dev),
                                      keep), False))
        cases.append(("combine", (rn(6, 64, dtype=dt), ri(0, 6, 4, 2),
                                  torch.rand(4, 2, generator=g, device=dev),
                                  torch.zeros(4, 2, dtype=torch.bool, device=dev)),
                      False))
        # grouped matmul: C = 1, C < 16, C > 16, non-divisible d and f
        for e, c, d, f in ((4, 1, 512, 2048), (3, 5, 100, 70), (2, 17, 64, 64),
                           (2, 100, 130, 200)):
            cases.append(("grouped_matmul", (rn(e, c, d, dtype=dt),
                                             rn(e, d, f, dtype=dt) * d ** -0.5),
                          False))
    # flash decode: q/kv dtype pairs, GQA, head dims, index 0, mixed indices
    for qdt, kvdt in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                      (torch.bfloat16, torch.bfloat16)):
        for b, h, kv, s, hd in ((4, 8, 8, 64, 64), (3, 8, 2, 300, 128),
                                (2, 8, 1, 1000, 40)):
            idx = ri(0, s, b)
            idx[0] = 0
            cases.append(("flash_decode", (rn(b, h, hd, dtype=qdt),
                                           rn(b, s, kv, hd, dtype=kvdt),
                                           rn(b, s, kv, hd, dtype=kvdt), idx), False))
    return cases


def kernel_phase(calls, dev):
    """Checks every kernel at the captured main-path inputs and the ragged
    cases, then times it at the prefill and decode sites. Returns
    ({name: max abs err over the main-path inputs}, {(name, site): times})."""
    out = {}
    for name in ("dispatch", "combine", "grouped_matmul", "flash_decode"):
        if not calls[name]:
            raise AssertionError(f"{name}: never called on the main path")
        max_err = 0.0
        for args, _ in calls[name]:
            res = kernel_of(name)(*args)
            torch.cuda.synchronize()
            max_err = max(max_err, check(name, res, plain_of(name)(*args),
                                         exact=name == "dispatch"))
        out[name] = max_err
        shapes = [" x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a))
                  for args, _ in calls[name]]
        log(f"kernel {name}: {len(calls[name])} main-path input shapes "
            f"{shapes}, max abs err {max_err:.3e} (exact={name == 'dispatch'}, "
            f"tol {TOL})")
    n_rag = 0
    for name, args, exact in ragged_cases(dev):
        res = kernel_of(name)(*args)
        torch.cuda.synchronize()
        check(f"{name} ragged", res, plain_of(name)(*args), exact=exact)
        n_rag += 1
    log(f"kernels: {n_rag} ragged cases agree with their plain versions "
        "(k=2, capacity 1, all dropped, non-divisible d/f, index 0, mixed "
        "per-row indices, f32 and bf16)")

    def library(name, args):
        if name == "grouped_matmul":
            return lambda: torch.bmm(*args)
        if name == "dispatch":
            x, st, _ = args
            idx = st.long().clamp(0, x.shape[0] - 1)
            return lambda: torch.index_select(x, 0, idx)
        if name == "combine":
            buf, ts, w, keep = args
            psw = (w * keep).to(buf.dtype)
            return lambda: F.embedding_bag(ts, buf, per_sample_weights=psw,
                                           mode="sum")
        if name == "flash_decode":
            q, k, v, idx = args
            b, s = k.shape[0], k.shape[1]
            q4 = q.to(k.dtype)[:, :, None, :]
            k4, v4 = k.transpose(1, 2), v.transpose(1, 2)
            pos = torch.arange(s, device=dev)[None, :]
            mask = (pos <= torch.as_tensor(idx).reshape(-1, 1))[:, None, None, :]
            return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
        raise KeyError(name)

    timing = {}
    for name in out:
        # the first captured call is the prefill site, the last the decode
        # site (flash decode runs at decode only)
        sites = [("decode", calls[name][-1][0])]
        if len(calls[name]) > 1:
            sites.insert(0, ("prefill", calls[name][0][0]))
        for site, args in sites:
            nbytes, flops, wdt = work(name, args)
            b_ms, b_by = bound(nbytes, flops, wdt)
            k_ms = device_ms(lambda: kernel_of(name)(*args))
            p_ms = device_ms(lambda: plain_of(name)(*args))
            l_ms = device_ms(library(name, args))
            shape = " x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a))
            log(f"time {name}@{site} [{shape}]: kernel {k_ms:.6f} ms, bound "
                f"{b_ms:.6f} ms ({b_by}), plain {p_ms:.6f} ms, library "
                f"{l_ms:.6f} ms")
            timing[(name, site)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                        bound_by=b_by, library_ms=l_ms,
                                        shape=shape)
    return out, timing


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
    from repro_torch.models import prefill
    from repro_torch.serve import generate
    from repro_torch.serve.engine import decode_pool_step

    generate(params, batch, cfg, gen)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = generate(params, batch, cfg, gen)
    torch.cuda.synchronize()
    counts = launch_counts()
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

    # the same decode step replayed as one CUDA graph: its device time
    # without the host's per-op dispatch
    lg, fresh = prefill(params, batch, cfg, max_seq=PROMPT + MAX_NEW)
    pool = _pool(cfg, fresh, dev)
    tok = lg[:, 0].argmax(-1)
    pos = torch.full((BATCH,), PROMPT, device=dev)
    alive = torch.ones(BATCH, dtype=torch.bool, device=dev)
    graph_ms = device_ms(lambda: decode_pool_step(params, pool, tok, pos, alive, cfg,
                                                  flash_decode=True),
                         reps=1, replays=20)
    decode_ms = med["decode_ms_per_step"]
    log(f"slice: decode step as one CUDA graph {graph_ms:.2f} ms on the device "
        f"vs median {decode_ms:.2f} ms eager: the device is idle "
        f"{max(0.0, 1 - graph_ms / decode_ms) * 100:.0f}% of an eager step")
    with CallCount() as calls:
        decode_pool_step(params, pool, tok, pos, alive, cfg, flash_decode=True)
    log(f"slice: {calls.n} PyTorch calls from Python per eager decode step")
    return counts


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
                           ("cuda", ("grouped_matmul_dx", "grouped_matmul_dw"))):
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
    return cases


def train_kernel_phase(captured, dev):
    """B4 and B1's backward kernels against their plain versions at the
    inputs captured from the first training step and in ragged cases, then
    timed at the training site. Returns ({name: max abs err}, {name: times})."""
    from repro_torch.kernels import moe_dispatch, ops
    errs = {}
    for name in ("fused_moe", "grouped_matmul_dx", "grouped_matmul_dw"):
        if not captured.get(name):
            raise AssertionError(f"{name}: never called on the training path")
        err = 0.0
        for args, kw in captured[name]:
            out = kernel_of(name)(*args, **kw)
            torch.cuda.synchronize()
            err = max(err, check(name, out, plain_of(name)(*args, **kw)))
        errs[name] = err
        shapes = [" x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a))
                  for args, _ in captured[name]]
        log(f"kernel {name}: training-site inputs {shapes}, max abs err {err:.3e} "
            f"(tol {TOL['float32']})")
    n = 0
    for args, kw, drop_all in fused_ragged_cases(dev):
        out = kernel_of("fused_moe")(*args, **kw)
        torch.cuda.synchronize()
        check("fused_moe ragged", out, plain_of("fused_moe")(*args, **kw))
        if drop_all and float(out.abs().max()) != 0.0:
            raise AssertionError("fused_moe: all dropped but output not zero")
        n += 1
    for name, args in bwd_ragged_cases(dev):
        check(f"{name} ragged", kernel_of(name)(*args), plain_of(name)(*args))
        n += 1
    torch.cuda.synchronize()
    log(f"train kernels: {n} ragged cases agree with their plain versions (B4: k=2, "
        "capacity 1, all dropped, T=1, ragged d and f, d > 512, 16-row tiles, gelu and "
        "gated silu; B1 dx/dw: C=1, C=17, C=100, ragged d and f; f32 and bf16)")

    timing = {}
    for name in errs:
        args, kw = captured[name][0]
        nbytes, flops, wdt = work(name, args)
        b_ms, b_by = bound(nbytes, flops, wdt)
        k_ms = device_ms(lambda: kernel_of(name)(*args, **kw))
        p_ms = device_ms(lambda: plain_of(name)(*args, **kw))
        extra = {}
        if name == "fused_moe":
            # no single PyTorch call computes gather + FFN + scatter; beside
            # it, the port's own unfused cuda pipeline on the same inputs
            x, w_in, w_gate, w_out, topk_w, keep, st, sv, ts = args
            e, cap = w_in.shape[0], st.shape[0] // w_in.shape[0]

            def pipeline():
                buf = moe_dispatch.dispatch(x, st, sv).reshape(e, cap, -1)
                out = ops.expert_ffn_op(buf.to(w_in.dtype), w_in, w_gate, w_out, kw["act"])
                return moe_dispatch.combine(out.to(x.dtype).reshape(e * cap, -1), ts,
                                            topk_w, keep)
            check("cuda pipeline vs fused_moe", pipeline(), kernel_of(name)(*args, **kw))
            l_ms = None
            extra["pipeline_ms"] = device_ms(pipeline)
            lib = "null (no single PyTorch call computes gather + FFN + scatter)"
        else:
            a, b = args
            lhs, rhs = ((a, b.transpose(1, 2)) if name == "grouped_matmul_dx"
                        else (a.transpose(1, 2), b))
            l_ms = device_ms(lambda: torch.bmm(lhs, rhs))
            lib = f"{l_ms:.6f} ms (torch.bmm on the transposed view)"
        shape = " x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a))
        log(f"time {name}@train [{shape}]: kernel {k_ms:.6f} ms, bound {b_ms:.6f} ms "
            f"({b_by}), plain {p_ms:.6f} ms, library {lib}" +
            (f", cuda pipeline (B2 -> B1 x2 -> B3) {extra['pipeline_ms']:.6f} ms"
             if extra else ""))
        timing[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=l_ms, shape=shape, **extra)
    return errs, timing


def expected_train_launches(cfg, backend: str, dropped_experts: bool = False):
    """Launches per training step: each MoE layer's forward runs twice with
    remat (the forward and its recomputation in the backward)."""
    from repro_torch.training.steps import n_moe_layers
    fwd = n_moe_layers(cfg) * (2 if cfg.remat else 1)
    n = n_moe_layers(cfg)
    zero = {k: 0 for k in ("dispatch", "combine", "grouped_matmul", "grouped_matmul_dx",
                           "grouped_matmul_dw", "fused_moe", "flash_decode")}
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
# main
# ---------------------------------------------------------------------------

def kernel_table(errs, timing, counts, t_errs, t_timing, t_counts):
    """One entry per kernel for the JSON line: serving kernels at their
    decode site with their launches per ``generate``, training kernels at
    the training site with their launches per step (B4 on ``cuda_fused``,
    B1's backward on ``cuda``); every entry also lists its launches per
    training step on both kernel backends."""
    kernels = []
    for name in ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw", "dispatch",
                 "combine", "fused_moe", "flash_decode"):
        src, rep = REPLACES[name]
        if (name, "decode") in timing:
            t, site, launches, err = timing[(name, "decode")], "decode", counts[name], errs[name]
        else:
            t, site = t_timing[name], "train"
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
        if "pipeline_ms" in t:
            entry["pipeline_ms"] = t["pipeline_ms"]
        kernels.append(entry)
    return kernels


def serve_phases(full, dev):
    """Phases 3-5 on the serving path; every tensor they made is freed on
    return. Returns (errs, timing, counts)."""
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

    # 4. the slice
    counts = slice_phase(params, batch, cfg, gen, dev)

    # 5. kernel path against plain path, f32 activations
    e2e_phase(params, batch, cfg, gen, dev)
    sensitivity(params, batch, cfg, dev)          # scales params in place
    return errs, timing, counts


def main() -> int:
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
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # 3-5. serving
    full = get_config("zcode-m3-base")
    t0 = time.perf_counter()
    errs, timing, counts = serve_phases(full, dev)
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

    kernels = kernel_table(errs, timing, counts, t_errs, t_timing, t_counts)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


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
