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
                 reported.

Prints the kernel table as one JSON line before the last line and, as the
last line, {"ok": true, "device": {...}}. Needs one CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
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

BATCH, PROMPT, MAX_NEW = 8, 32, 32
SEED = 0
N_FORCED = 8          # phase 5: teacher-forced decode steps gated
REPLACES = {
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
    """Records the inputs of each kernel wrapper's first call per distinct
    input shape (of every call with ``all_calls``) while the main path
    runs; restores the wrappers on exit."""

    def __init__(self, all_calls: bool = False):
        self.all_calls = all_calls
        from repro_torch.kernels import flash_decode, grouped_ffn, moe_dispatch
        self.sites = [(moe_dispatch, "dispatch"), (moe_dispatch, "combine"),
                      (grouped_ffn, "grouped_matmul"),
                      (flash_decode, "flash_decode")]
        self.calls = {name: [] for _, name in self.sites}

    def __enter__(self):
        self.saved = []
        for mod, name in self.sites:
            orig = getattr(mod, name)
            seen = set()

            def rec(*args, _orig=orig, _name=name, _seen=seen):
                key = tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a)
                            else a for a in args)
                if self.all_calls or key not in _seen:
                    _seen.add(key)
                    self.calls[_name].append(tuple(
                        a.clone() if torch.is_tensor(a) else a for a in args))
                return _orig(*args)

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


def plain_of(name):
    from repro_torch.kernels import ref
    return {"dispatch": ref.dispatch_ref, "combine": ref.combine_ref,
            "grouped_matmul": ref.grouped_matmul_ref,
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
        for args in calls[name]:
            res = kernel_of(name)(*args)
            torch.cuda.synchronize()
            max_err = max(max_err, check(name, res, plain_of(name)(*args),
                                         exact=name == "dispatch"))
        out[name] = max_err
        shapes = [" x ".join(str(tuple(a.shape)) for a in args if torch.is_tensor(a))
                  for args in calls[name]]
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
        sites = [("decode", calls[name][-1])]
        if len(calls[name]) > 1:
            sites.insert(0, ("prefill", calls[name][0]))
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
    expect = {"flash_decode": cfg.n_layers * steps,
              "dispatch": n_moe_enc + n_moe_dec + n_moe_dec * steps,
              "combine": n_moe_enc + n_moe_dec + n_moe_dec * steps,
              "grouped_matmul": 2 * (n_moe_enc + n_moe_dec + n_moe_dec * steps)}
    log(f"slice: launches {counts}, expected {expect}")
    if counts != expect or expect != {"flash_decode": 186, "dispatch": 102,
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
        for args in calls:
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
# main
# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import init_model
    from repro_torch.serve import GenerateConfig, generate
    from repro_torch.launch.serve import generator, synth_batch

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

    # model and main-path inputs
    full = get_config("zcode-m3-base")
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

    # 4. the slice
    counts = slice_phase(params, batch, cfg, gen, dev)

    # 5. kernel path against plain path, f32 activations
    e2e_phase(params, batch, cfg, gen, dev)
    sensitivity(params, batch, cfg, dev)          # scales params in place

    kernels = []
    for name in ("grouped_matmul", "dispatch", "combine", "flash_decode"):
        src, rep = REPLACES[name]
        t = timing[(name, "decode")]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": counts[name],
                        "max_abs_err": errs[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "site": "decode", "shape": t["shape"],
                        "prefill_ms": timing.get((name, "prefill"), {}).get("ms")})
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
