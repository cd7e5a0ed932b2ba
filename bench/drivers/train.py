"""Driver ``train``: the program's trainer (``repro_torch.training.Trainer``)
on the benchmark's weights and batches.

Set-up builds one ``Trainer`` and drives it through ``Trainer.run`` (its
prefetcher, its chunks, one metrics fetch a chunk) over the first steps,
which run every length bucket of the mix once, and times the steps past
the third. The window is one more ``Trainer.run`` of the same object over
as many steps as that time says fill ``--seconds``, and ends in its last
chunk's fetch, a device sync. The first three steps are the ones the
reference follows: their losses, the first gradient as Adam took it (its
first moment over 1 - b1 after step 1) and each leaf's change after step
3 (against the initial weights, drawn again from the seed) are read in
set-up, before later steps overwrite them.

With ``--trace 1`` the window runs with the program's span tracer on, and
``profile_steps`` more steps run under ``torch.profiler`` with the kernel
entry points wrapped (``lib.hooks``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict

import torch

from bench.lib import common, flops, group, hooks, modelcfg, traffic, weights
from bench.lib.trace import Profile
from bench.reference import model as ref_model
from bench.reference import train as ref_train


def _norms(tensors) -> list:
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).tolist()


def run(job) -> Dict:
    """A run on one chip, or over the cell's ``ranks`` (one process a chip,
    expert parallelism over all of them), rank 0's result with the peak of
    the fullest chip and device times averaged over the chips."""
    n = job.files["cell"]["system"].get("ranks", 1)
    if n == 1:
        return _run(job, job.device, None)
    outs = group.run(job, __file__, n, timeout_s=job.seconds + 900)
    out = outs[0]
    out["memory_peak_bytes"] = max(o["memory_peak_bytes"] for o in outs)
    if out["profile"]:
        for key in ("busy_s", "window_s", "a2a_s"):
            out["profile"][key] = sum(o["profile"][key] for o in outs) / n
        out["records"]["profile"] = out["profile"]
    return out


def run_rank(job, rank: int, n: int, init: str) -> Dict:
    """One rank of a group run (``lib.group``): its chip, the group, the
    run; only rank 0 runs the reference."""
    from repro_torch.launch.mesh import close_group, make_group
    device = torch.device("cuda", rank) if job.device.type == "cuda" else job.device
    ctx = make_group((n, 1), device, init_method=init, rank=rank, world_size=n)
    try:
        return _run(job, device, ctx)
    finally:
        close_group()


def _leaf_norms(tensors, keys, ctx) -> list:
    """Each leaf's norm; an expert leaf's over every rank's block."""
    sq = torch.stack([torch.linalg.vector_norm(t.float()) ** 2 for t in tensors])
    if ctx is not None and ctx.world > 1:
        from repro_torch.core.moe import is_expert_leaf
        expert = torch.tensor([is_expert_leaf(k) for k in keys], device=sq.device)
        total = ctx.all_reduce(torch.where(expert, sq, 0.0))
        sq = torch.where(expert, total, sq)
    return sq.sqrt().tolist()


def _run(job, device, ctx) -> Dict:
    from repro_torch.bridge import shard_experts
    from repro_torch.comm import COUNTER
    from repro_torch.obs.trace import Tracer
    from repro_torch.training import Trainer

    cj, cell, tj = job.files["config"], job.files["cell"], job.files["traffic"]
    system = cell["system"]
    lead = ctx is None or ctx.rank == 0
    cfg = modelcfg.model_config(cj, system)
    tc0 = modelcfg.train_config(cj, job.seed)
    layout = modelcfg.layout(cfg)
    keys = [k for k, _ in layout]
    n_total = modelcfg.n_layers_total(cj)
    wseed = common.seed_stream(job.seed, 0)
    job.log("program imported")
    flat = weights.make(layout, wseed, device, n_total)
    mine = modelcfg.flat_of(shard_experts(modelcfg.tree(flat), ctx))
    common.sync(device)
    job.log(f"weights made: {sum(weights.numel(s) for _, s in layout)} parameters")
    batch_fn = traffic.MTBatches(tj, cj["vocab"], common.seed_stream(job.seed, 1))
    n_setup = max(cell["setup_steps"], len(batch_fn.buckets))
    tracer = Tracer(enabled=False)
    trainer = Trainer(cfg, tc0, batch_fn, device=device, params=modelcfg.tree(mine),
                      ctx=ctx, chunk=system["chunk"], log=None, log_every=1, tracer=tracer)

    def steps(lo: int, hi: int) -> None:
        trainer.start_step = lo
        trainer.tc = dataclasses.replace(tc0, steps=hi)
        trainer.run()

    # set-up: the reference's three steps, then every bucket's shape
    steps(0, 1)
    job.log("step 0 done")
    grad_prog = [g / (1 - tc0.b1) for g in _leaf_norms(_flat_m(trainer), keys, ctx)]
    steps(1, 3)
    init = modelcfg.flat_of(shard_experts(modelcfg.tree(
        weights.make(layout, wseed, device, n_total)), ctx))
    change_prog = _leaf_norms([mine[k] - init[k] for k in keys], keys, ctx)
    del init
    job.log("steps 1-2 done, the change read")
    common.sync(device)
    t_est = time.perf_counter()
    steps(3, n_setup)
    t_est = (time.perf_counter() - t_est) / (n_setup - 3)
    losses_prog = [h["loss"] for h in trainer.history[:3]]
    trainer.log_every = 0

    # the window: one Trainer.run over the steps that fill --seconds at the
    # set-up's pace (rank 0's count on every rank)
    n = torch.tensor([float(max(1, round(job.seconds / t_est)))], device=device)
    if ctx is not None and ctx.world > 1:
        torch.distributed.broadcast(n, 0)
    n_steps, s0 = int(n.item()), n_setup
    job.log(f"steps 3-{n_setup - 1} done, {t_est:.3f} s a step: {n_steps} steps in the window")
    tracer.enabled = bool(job.trace)
    common.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    COUNTER.reset()
    t_setup = job.clock.now()
    t0 = time.perf_counter()
    steps(s0, s0 + n_steps)
    common.sync(device)
    window = time.perf_counter() - t0
    s = s0 + n_steps
    wire = sum(COUNTER.wire_bytes.values())
    job.log(f"window: {n_steps} steps in {window:.3f} s")
    spans = [e for e in tracer.events if e[0] == "X"]
    tracer.enabled = False
    failed = sum(not math.isfinite(h["loss"]) for h in trainer.history[3:])

    prof = kc = None
    if job.trace:
        with Profile(device) as prof, hooks.KernelCalls() as kc:
            steps(s, s + cell["profile_steps"])
    peak = common.memory_peak(device)
    bounds = kc.bounds() if kc else None
    del trainer, flat, mine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not lead:
        return {"memory_peak_bytes": peak, "profile": prof.summary if prof else None}

    tokens = model_flops = 0
    for i in range(s0, s0 + n_steps):
        src, tgt = traffic.MTBatches.lengths_of(batch_fn(i))
        tokens += int(src.sum() + tgt.sum())
        model_flops += flops.train_batch(cj, src, tgt)
    records = {"window_s": window, "steps": n_steps, "tokens": tokens,
               "model_flops": model_flops, "spans": spans, "wire_bytes": wire,
               "profile_steps": cell["profile_steps"],
               "profile": prof.summary if prof else None, "bounds": bounds}

    # the reference on the same weights, once the program's state is freed
    job.log("reference starts")
    shards = ctx.world if ctx is not None else 1
    ref = reference(layout, wseed, device, n_total, cj, batch_fn, job.seed, shards=shards)
    job.log(f"reference done: losses {ref['losses']} dropped {ref['dropped']}, "
            f"program {losses_prog}")
    prog = {"losses": losses_prog, "grad_norms": dict(zip(keys, grad_prog)),
            "change_norms": dict(zip(keys, change_prog))}
    _log_gaps(job, prog, ref)
    return {"e2e": {"train_tok_s": common.rate(tokens, window),
                    "setup_s": t_setup},
            "records": records, "numbers": gap_numbers(prog, ref),
            "attempted": n_steps, "failed": failed, "memory_peak_bytes": peak,
            "profile": prof.summary if prof else None}


def reference(layout, wseed, device, n_total, cj, batch_fn, seed, *, r=None,
              half: bool = False, shards: int = 1, isolated: bool = False) -> Dict:
    """The reference's three steps from the initial weights: each step's
    loss, the first clipped gradient's norm per leaf and each leaf's change
    after the third. ``r`` and ``half`` (the first half of every batch's
    rows) put a lower precision or a fault in it."""
    flat = weights.make(layout, wseed, device, n_total)
    batches = []
    for i in range(3):
        b = batch_fn(i)
        rows = len(b["tokens"]) // 2 if half else None
        batches.append({k: torch.from_numpy(v[:rows]).to(device) for k, v in b.items()})
    out = ref_train.run(flat, cj, batches, seed=seed, r=r, shards=shards, isolated=isolated)
    init = weights.make(layout, wseed, device, n_total)
    out["change_norms"] = {k: float(torch.linalg.vector_norm(flat[k] - init[k]))
                           for k, _ in layout}
    return out


def _log_gaps(job, prog: Dict, ref: Dict) -> None:
    """The three leaves of the largest gaps by the compared measure."""
    keep = {"grad_norms": None, "change_norms": ref_train.moved_leaves(ref["grad_norms"])}
    for kind in ("grad_norms", "change_norms"):
        gaps = ref_train.leaf_gaps(prog[kind], ref[kind], keep[kind])
        worst = sorted(gaps, key=lambda k: -gaps[k])[:3]
        job.log(f"{kind} largest gaps: " + ", ".join(
            f"{k} {gaps[k]:.4g} ({prog[kind][k]:.6g} vs {ref[kind][k]:.6g})" for k in worst))


def gap_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each step's loss against the reference's (the worst of the three,
    relative), the first gradient's norms by their median leaf and by their
    worst, and the three steps' change's norms by their worst leaf, over the
    leaves the reference's gradient moves (``moved_leaves``). The first
    gradient's worst leaf is a reading, not compared: an MoE layer's small
    leaf (its gradient scaled by a top-1 gate of ~1/128) swings from seed to
    seed with the tokens that rounding sends to another expert."""
    g = ref["grad_norms"]
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
        "grad_gap_median": ref_train.median_leaf_gap(prog["grad_norms"], g),
        "grad_gap": ref_train.leaf_gap(prog["grad_norms"], g),
        "change_gap": ref_train.leaf_gap(prog["change_norms"], ref["change_norms"],
                                         keep=ref_train.moved_leaves(g)),
    }


def control(job, kind=None, fault=None) -> Dict[str, float]:
    """The reference put in the program's place, computed in the lower
    precision ``kind`` or with ``fault`` ("half_batch": half of every batch
    left out, the mean taken over the rest; "no_exchange": the exchange
    between chips left out), read as the program is."""
    cj, cell, tj = job.files["config"], job.files["cell"], job.files["traffic"]
    layout = modelcfg.layout(modelcfg.model_config(cj, cell["system"]))
    n_total = modelcfg.n_layers_total(cj)
    wseed = common.seed_stream(job.seed, 0)
    batch_fn = traffic.MTBatches(tj, cj["vocab"], common.seed_stream(job.seed, 1))
    shards = cell["system"].get("ranks", 1)
    args = (layout, wseed, job.device, n_total, cj, batch_fn, job.seed)
    ref = reference(*args, shards=shards)
    if fault == "no_exchange":
        placed = reference(*args, shards=shards, isolated=True)
    else:
        placed = reference(*args, r=ref_model.rounder(kind), shards=shards,
                           half=fault == "half_batch")
    _log_gaps(job, placed, ref)
    return gap_numbers(placed, ref)


def _flat_m(trainer):
    from repro_torch.tree import flatten_with_paths
    return list(flatten_with_paths(trainer.state["opt"]["m"]).values())
