"""Driver ``serve_open``: the program's slot-pool scheduler
(``repro_torch.serve.scheduler.ContinuousScheduler``) under an open loop of
independent users (``traffic.OpenLoop``): each request is sent when it is
due, whatever the system's state; greedy decoding with EOS off.

Set-up makes the weights, builds the scheduler, runs one admission group of
every width and bucket the mix can form (two tokens each), then starts the
stream; the window opens at the due time of the last request of the first
whole blocks of the mix that span ``prime_s`` seconds, once the pool holds
requests of every age. A request is submitted at the first scheduler tick
at or after its due time and is stamped with its due time, so that its
time to first token counts the wait of a late send. The window's requests
are those due in the ``--seconds`` after it opens: whole blocks, the same
sizes and gaps for every seed where ``--seconds`` spans whole blocks. After it closes the stream goes on sending
until every one of them has finished (at most ``drain_s`` seconds; one
that has not counts as failed), and the tails are taken over all of them.
The clock is the scheduler's own: ``first_token_at`` is stamped after the
fetch of the first token, ``finished_at`` at the tick that retires the
request.

With ``--trace 1`` the window runs with the program's span tracer on, each
tick's model FLOPs are counted (what the requests' generated tokens grew
by) with its seconds, and after the drain ``profile_ticks`` more ticks run
under ``torch.profiler`` with the kernel entry points wrapped
(``lib.hooks``).

The check: a sample of the window's requests drawn from the seed, the
longest among them, is run once through the reference (prompt and served
tokens); the numbers are the mean and the widest gap by which a served
token's logit lies below the reference's best at its position.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from bench.lib import common, flops, hooks, modelcfg, traffic, weights
from bench.lib.trace import Profile
from bench.reference import model as ref_model

WARMUP_RID = 1 << 40


def run(job) -> Dict:
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.engine import GenerateConfig
    from repro_torch.serve.scheduler import ContinuousScheduler, Request

    cj, cell, tj = job.files["config"], job.files["cell"], job.files["traffic"]
    system = cell["system"]
    device = job.device
    cfg = modelcfg.model_config(cj, system)
    layout = modelcfg.layout(cfg)
    wseed = common.seed_stream(job.seed, 0)
    wtype = getattr(torch, cj["param_dtype"])
    job.log("program imported")
    flat = weights.make(layout, wseed, device, cj["n_layers"], dtype=wtype)
    common.sync(device)
    job.log(f"weights made: {sum(weights.numel(s) for _, s in layout)} parameters")
    gen = GenerateConfig(max_new=tj["output"]["max"], temperature=0.0, eos_id=-1,
                         flash_decode=system["flash_decode"])
    tracer = Tracer(enabled=False)
    sched = ContinuousScheduler(modelcfg.tree(flat), cfg, gen, n_slots=system["slots"],
                                prefill_buckets=system["buckets"],
                                admit_width=system["admit_width"],
                                max_seq=system["cache_len"], tracer=tracer)
    mix = traffic.OpenLoop(tj, cj["vocab"], common.seed_stream(job.seed, 1))

    # warm-up: one admission group of each width and bucket
    rid = WARMUP_RID
    rng = np.random.default_rng(0)
    for bucket in system["buckets"]:
        w = system["admit_width"]
        while w >= 1:
            for _ in range(w):
                sched.submit(Request(rid, rng.integers(3, cj["vocab"], size=bucket),
                                     max_new=2, arrival=sched._now()))
                rid += 1
            while sched.stats["finished"] < sched.stats["admitted"] or sched._queue:
                sched.step(sched._now())
            sched.step(sched._now())
            w //= 2
    job.log(f"warm-up: {sched.stats['prefill_calls']} prefill groups")

    # the open loop: requests j = 0, 1, ... due at t_start + mix.due(j)
    prompt: Dict[int, np.ndarray] = {}
    nxt = [0]
    late: List[float] = []
    count = {"flops": 0.0, "busy_s": 0.0, "on": False}

    def tick(done: List) -> None:
        now = sched._now()
        while t_start + mix.due(nxt[0]) <= now:
            j = nxt[0]
            tokens, budget = mix.request(j)
            prompt[j] = tokens
            late.append(now - (t_start + mix.due(j)))
            sched.submit(Request(j, tokens, max_new=budget, arrival=t_start + mix.due(j)))
            nxt[0] += 1
        if not sched._queue and not sched._active[:sched.n_slots].any():
            time.sleep(max(0.0, min(t_start + mix.due(nxt[0]) - sched._now(), 0.01)))
            return
        if not count["on"]:
            done.extend(sched.step(sched._now()))
            return
        before = {r: len(b) for r, b in sched._buffers.items()}
        t0 = time.perf_counter()
        done.extend(sched.step(sched._now()))
        count["busy_s"] += time.perf_counter() - t0
        for r, b in sched._buffers.items():
            g0 = before.get(r, 0)
            if len(b) > g0:
                count["flops"] += (flops.serve_request(cj, len(prompt[r]), len(b))
                                   - (flops.serve_request(cj, len(prompt[r]), g0) if g0 else 0.0))

    # the window opens at the due time of the last request of the first
    # whole blocks that span prime_s, so that it holds whole blocks: the
    # same sizes and gaps for every seed
    k = 1
    while mix.due(k * mix.block - 1) < cell["prime_s"]:
        k += 1
    j_open = k * mix.block
    t_open_s = mix.due(j_open - 1)
    t_start = sched._now()
    before: List = []
    while sched._now() - t_start < t_open_s:
        tick(before)
    job.log(f"priming: {nxt[0]} requests sent in {t_open_s:.3f} s, {len(before)} finished")

    tracer.enabled = bool(job.trace)
    count["on"] = bool(job.trace)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_setup = job.clock.now()
    t_open = sched._now()
    done: List = []
    while True:                     # one tick at least, where priming ran late
        tick(done)
        if sched._now() - t_start >= t_open_s + job.seconds:
            break
    t_close = sched._now()
    window = t_close - t_open
    j_close = j_open
    while mix.due(j_close) <= t_open_s + job.seconds:
        j_close += 1
    spans = [e for e in tracer.events if e[0] == "X"]
    tracer.enabled = False
    count["on"] = False
    backlog = len(sched._queue)
    job.log(f"window: {window:.3f} s, requests {j_open}-{j_close - 1} due in it, "
            f"{len(done)} finished, {backlog} queued at its close; "
            f"sends late by {1e3 * max(late):.1f} ms at most")

    # the drain: the stream goes on until the window's requests have finished
    want = set(range(j_open, j_close))
    mine = {r.rid: r for r in done + before if r.rid in want}
    t_drain = sched._now()
    while len(mine) < len(want) and sched._now() - t_drain < cell["drain_s"]:
        out: List = []
        tick(out)
        mine.update((r.rid, r) for r in out if r.rid in want)
    job.log(f"drain: {len(mine)} of {len(want)} finished in {sched._now() - t_drain:.1f} s")

    prof = kc = None
    if job.trace:
        after: List = []
        with Profile(device) as prof, hooks.KernelCalls() as kc:
            for _ in range(cell["profile_ticks"]):
                tick(after)
    peak = common.memory_peak(device)

    fin = sorted(mine.values(), key=lambda r: r.rid)
    ttft = [(r.first_token_at - r.arrival) * 1e3 for r in fin]
    tpot = [(r.finished_at - r.first_token_at) / (r.length - 1) * 1e3
            for r in fin if r.length >= 2]
    records = {"window_s": window, "requests": len(fin), "spans": spans,
               "model_flops": count["flops"], "busy_s": count["busy_s"],
               "profile": prof.summary if prof else None,
               "bounds": kc.bounds() if kc else None}

    # the check, on weights drawn again once the program's state is freed
    sample = _sample(fin, job.seed, cell["check_requests"])
    served = [(prompt[r.rid], np.asarray(r.tokens[:r.length])) for r in sample]
    del sched, flat
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = weights.make(layout, wseed, device, cj["n_layers"], dtype=wtype)
    job.log("reference starts")
    gaps = [served_gaps(ref, cj, p, g) for p, g in served]
    numbers = _gap_numbers([g for g, _ in gaps])
    job.log(f"reference done: {sum(len(g) for _, g in served)} served tokens checked")
    out = {"records": records, "numbers": numbers, "attempted": len(want),
           "failed": len(want) - len(fin), "memory_peak_bytes": peak,
           "profile": prof.summary if prof else None,
           "e2e": {"setup_s": t_setup}}
    for q in cell["percentiles"]:
        out["e2e"][f"ttft_p{q}_ms"] = common.percentile(ttft, q) if ttft else None
        out["e2e"][f"tpot_p{q}_ms"] = common.percentile(tpot, q) if tpot else None
    if job.control:
        out["control"] = _gap_numbers([served_gaps(ref, cj, p, g, control=job.control)[1]
                                       for p, g in served])
    del ref
    return out


def _gap_numbers(gaps) -> Dict[str, float]:
    """The widest gap over every checked token, and their mean."""
    allg = np.concatenate(gaps)
    return {"logit_gap": float(allg.max()), "mean_gap": float(allg.mean())}


def _sample(done: List, seed: int, n: int) -> List:
    """The longest finished request and n - 1 others drawn from the seed."""
    by_len = sorted(done, key=lambda r: (-r.length, r.rid))
    rest = by_len[1:]
    rng = np.random.default_rng([int(seed), 4])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [by_len[0]] + [rest[i] for i in sorted(pick)]


@torch.no_grad()
def served_gaps(flat, cj, prompt_tokens: np.ndarray, generated: np.ndarray, control=None):
    """For each served token of one request, the gap between the
    reference's best logit at its position and its logit of the token
    served there; with ``control`` (a lower precision of the weights and
    activations), the gaps of the tokens the control puts first instead,
    beside them. The reference runs once over the prompt and the served
    tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = flat["embed"].device
    seq = torch.from_numpy(np.concatenate([prompt_tokens, generated[:-1]])).to(dev)
    lo = len(prompt_tokens) - 1
    ref = ref_model.decoder_logits(flat, cj, seq)[lo:]
    best = ref.max(-1).values

    def gap(tok):
        return (best - ref.gather(1, tok[:, None])[:, 0]).cpu().numpy()

    own = None
    if control is not None:
        own = gap(ref_model.decoder_logits(flat, cj, seq, r=ref_model.rounder(control),
                                           w=ref_model.weight_rounder(control))[lo:].argmax(-1))
    return gap(torch.from_numpy(generated).to(dev)), own
