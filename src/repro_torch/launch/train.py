"""Training CLI (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch zcode-m3-base \
      --steps 20 --batch 16 --seq 64 --task mt --gd-mode gate_drop \
      --gd-rate 0.3 --backend cuda_fused --eval-every 10

Runs on the GPU unless ``--device cpu`` is given, and fails without one.
Parameters are drawn from ``--seed``; the batches are the reference's
synthetic multilingual MT task (``--task mt``: the encoder-decoders,
whisper-small's encoder on the source tokens as in the reference) or,
for the decoder-only archs, its synthetic LM task (``--task lm``), bit
for bit (no task carries images: the VLM does not train here); every step
takes the Gating Dropout consensus bit of (seed, step). ``--eval-every N`` scores
greedy-decoded corpus BLEU (``greedy_bleu``) every N steps and at the
last (``--task mt``). ``--ckpt-dir`` saves the train state at the end in
the reference's layout, and ``--resume`` continues from it at the
absolute step.

Expert parallelism: one process per rank, as ``torchrun`` starts them;
``--mesh d`` runs the MoE layers over the d ranks (each holds E/d experts
and a block of every batch's rows), the dispatch and combine all-to-alls
being the ``--comm`` substrate's. ``--mesh d,m`` adds a model axis: d * m
ranks, the m ranks of a data index running the same rows. By default
each expert's d_ff is sliced over the model axis and the FFN's partial
outputs summed over it (tensor parallelism, expert parallelism over the
data axis); ``--ep-on-model`` spreads whole experts over all d * m ranks
and splits each MoE layer's tokens along the sequence over the model
axis (it cannot decode one position a step, so no ``--eval-every``):

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --mesh 2,2 --reduced --task mt --gd-mode gate_drop \
      --gd-rate 0.3 --eval-every 4 --log-every 1

``--device cpu`` takes gloo, ``cuda`` NCCL with one card per rank. Rank 0
prints the records and writes ``--json-out``, ``--trace-out`` and
``--metrics-out``. ``--ckpt-dir`` under ``--mesh`` gathers the expert
shards into one checkpoint of the reference's layout, which rank 0
writes, and ``--resume`` slices it per rank: a run may resume at another
mesh, or layout, than the one that saved it.

Observability: ``--trace-out PATH`` turns on the span tracer (the
Trainer's ``train_chunk`` / ``chunk.execute`` / ``chunk.fetch`` /
``eval`` and the prefetcher's ``prefetch.*`` on its own thread) and writes
its Chrome trace (open it at https://ui.perfetto.dev); ``--metrics-out
PATH`` writes ``train/loss`` and ``train/tok_s`` histograms and the
``train/final_loss``, ``train/wall_s`` and ``train/router/*``
(``obs.frame.router_health``) gauges (``.prom``/``.txt``: Prometheus
text, else JSON); ``--profile LOGDIR`` wraps the run in a
``torch.profiler`` window (CPU and CUDA activities) whose Chrome trace
lands under LOGDIR, the tracer's spans named on its timeline;
``--no-metrics-frame`` drops the router-health metrics from the steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import COMM_SUBSTRATES, MOE_BACKENDS, TrainConfig
from repro_torch.data import (LMTaskConfig, MTTaskConfig, MultilingualMT,
                              SyntheticLM)
from repro_torch.launch.mesh import close_group, make_group, parse_mesh
from repro_torch.launch.serve import resolve_device, write_metrics
from repro_torch.metrics import corpus_bleu, strip_special
from repro_torch.obs import MetricsRegistry, Tracer, router_health, set_tracer
from repro_torch.serve import GenerateConfig, generate
from repro_torch.training import Trainer


def build_batch_fn(cfg, args):
    """(task, per-step numpy batches of it); pure host work: it runs on
    the prefetch thread."""
    if cfg.vlm is not None:
        raise ValueError(f"--task {args.task} has no images for {cfg.arch_id}: "
                         "its cross-attention layers need img_embeds")
    if args.task == "mt":
        task = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=args.langs,
                                           max_len=args.seq))
        return task, task.train_batches(args.batch)
    if cfg.encdec is not None:
        raise ValueError(f"--task lm has no source sentences for the "
                         f"encoder-decoder {cfg.arch_id}; use --task mt")
    task = SyntheticLM(LMTaskConfig(vocab=cfg.vocab, seq_len=args.seq))
    return task, lambda step: task.sample_batch(step, args.batch)


def greedy_bleu(params, cfg, task, *, n=32, max_new=36, seed=10_000,
                ctx=None, lang=None, device, return_tokens: bool = False):
    """Greedy decode a validation batch -> corpus BLEU (MT task only).

    Decodes through the engine (``serve.engine.generate``, EOS 2, greedy,
    the BOS prompt ``tokens[:, :1]``): the first generated token comes
    from the prefill logits and the first decode step runs at index
    ``prompt_len``; feeding index 0 after the prefill would overwrite the
    BOS cache slot and corrupt every reported BLEU. ``lang`` restricts
    the validation batch to one language. Under a (data, model) ``ctx``
    each data index decodes its block of the rows (its model ranks
    alike) and every rank gathers all the tokens over the data group and
    scores them. ``return_tokens`` returns (bleu, the scored tokens)."""
    kw = {} if lang is None else {"lang": lang}
    b = task.sample_batch(seed, n, **kw)
    rows = slice(None)
    if ctx is not None and ctx.dp > 1:
        if n % ctx.dp:
            raise ValueError(f"{n} eval rows do not split over the data axis of "
                             f"{ctx.dp}")
        per = n // ctx.dp
        rows = slice(ctx.data * per, (ctx.data + 1) * per)
    batch = {"enc_tokens": torch.from_numpy(b["enc_tokens"][rows]).to(device),
             "tokens": torch.from_numpy(b["tokens"][rows, :1]).to(device)}
    res = generate(params, batch, cfg, GenerateConfig(max_new=max_new), ctx=ctx)
    tokens = res.tokens
    if rows != slice(None):
        tokens = ctx.data_all_gather(tokens, 0)
    hyps = [strip_special(h) for h in tokens.cpu().numpy()]
    refs = [strip_special(r) for r in b["labels"]]
    bleu = corpus_bleu(hyps, refs)
    return (bleu, tokens) if return_tokens else bleu


def train_metrics(history) -> MetricsRegistry:
    """The run's registry: per-record loss and tokens/s histograms, the
    final loss and wall time, and the router health of the records."""
    reg = MetricsRegistry()
    loss_h = reg.histogram("train/loss", "recorded per-step loss")
    tok_h = reg.histogram("train/tok_s", "tokens/s at record points")
    for rec in history:
        loss_h.observe(rec["loss"])
        tok_h.observe(rec["tok_s"])
    if history:
        reg.gauge("train/final_loss").set(history[-1]["loss"])
        reg.gauge("train/wall_s").set(history[-1]["time_s"])
    rh = router_health(history)
    if rh["records"]:
        for k, v in rh.items():
            reg.gauge(f"train/router/{k}").set(float(v))
    return reg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zcode-m3-base")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--langs", type=int, default=8)
    ap.add_argument("--task", default="mt", choices=["mt", "lm"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--schedule", default="inverse_sqrt",
                    choices=["inverse_sqrt", "cosine", "constant"])
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches per step "
                         "(--batch must divide evenly)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=8,
                    help="steps per metrics fetch from the device")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="make each chunk's batches inline instead of on the "
                         "background prefetch thread")
    ap.add_argument("--gd-mode", default=None,
                    choices=[None, "off", "gate_drop", "gate_expert_drop"])
    ap.add_argument("--gd-rate", type=float, default=None)
    ap.add_argument("--router", default=None,
                    choices=[None, "softmax", "sigmoid", "hash"])
    ap.add_argument("--backend", default=None, choices=[None, *MOE_BACKENDS],
                    help="MoE execution backend (cuda = the kernel pipeline, "
                         "cuda_fused = the one-launch fused kernel, sharded = "
                         "plain maths with real all-to-alls)")
    ap.add_argument("--comm", default=None, choices=[None, *COMM_SUBSTRATES],
                    help="communication substrate of the expert dispatch")
    ap.add_argument("--comm-quant", default=None, choices=[None, "int8", "fp8"],
                    help="wire dtype of the compressed substrates")
    ap.add_argument("--comm-chunks", type=int, default=None,
                    help="overlapped substrates: capacity micro-chunks (the "
                         "count run is the largest divisor of the capacity "
                         "<= this)")
    ap.add_argument("--ep-inner", type=int, default=None,
                    help="hierarchical substrates: intra-tier group size "
                         "(divides ep; default the largest divisor <= sqrt)")
    ap.add_argument("--mesh", default=None,
                    help="d or d,m: expert parallelism over d data ranks, "
                         "each with m model ranks (one process each, started "
                         "by torchrun)")
    ap.add_argument("--ep-on-model", action="store_true",
                    help="on a model axis: whole experts over data x model, "
                         "tokens split along the sequence over model "
                         "(default: each expert's d_ff sliced over model)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir "
                         "(params + opt + step) and continue training")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="greedy-decode BLEU every N steps and at the last "
                         "(--task mt)")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-metrics-frame", action="store_true",
                    help="drop the router-health MetricsFrame outputs of the "
                         "steps (telemetry only: the loss and the update are "
                         "the same either way)")
    ap.add_argument("--trace-out", default=None,
                    help="turn on the span tracer and write a Chrome-trace "
                         "(Perfetto) JSON of the run here")
    ap.add_argument("--metrics-out", default=None,
                    help="write a metrics-registry summary of the run "
                         "(.prom/.txt = Prometheus text, else JSON)")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="wrap the run in a torch.profiler window whose "
                         "Chrome trace is written under LOGDIR")
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    mesh = parse_mesh(args.mesh) if args.mesh else None

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.moe is not None:
        gd = cfg.moe.gating_dropout
        gd = dataclasses.replace(
            gd, mode=args.gd_mode or gd.mode,
            rate=args.gd_rate if args.gd_rate is not None else gd.rate)
        comm = cfg.moe.comm
        comm = dataclasses.replace(
            comm, substrate=args.comm or comm.substrate,
            quant=args.comm_quant or comm.quant,
            n_chunks=(args.comm_chunks if args.comm_chunks is not None
                      else comm.n_chunks),
            ep_inner=args.ep_inner if args.ep_inner is not None else comm.ep_inner)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, gating_dropout=gd, comm=comm,
            router_type=args.router or cfg.moe.router_type,
            backend=args.backend or cfg.moe.backend,
            ep_on_model=args.ep_on_model))
    if args.ep_on_model and args.eval_every and mesh is not None and mesh[1] > 1:
        ap.error("--ep-on-model cannot decode one position a step: no --eval-every")

    ctx = (make_group(mesh, device, ep_on_model=args.ep_on_model)
           if mesh is not None else None)
    lead = ctx is None or ctx.rank == 0
    tracer = set_tracer(Tracer(enabled=bool(args.trace_out or args.profile)))
    try:
        tc = TrainConfig(lr=args.lr, warmup_steps=args.warmup, steps=args.steps,
                         seed=args.seed, schedule=args.schedule,
                         microbatches=args.microbatches,
                         metrics_frame=not args.no_metrics_frame)
        task, batch_fn = build_batch_fn(cfg, args)
        eval_fn = None
        if args.eval_every and args.task == "mt":
            eval_fn = lambda state, step: {  # noqa: E731
                "bleu": greedy_bleu(state["params"], cfg, task, ctx=ctx,
                                    device=device)}
        trainer = Trainer(cfg, tc, batch_fn, device=device, ctx=ctx,
                          chunk=args.chunk, ckpt_dir=args.ckpt_dir,
                          eval_every=args.eval_every, eval_fn=eval_fn,
                          log_every=args.log_every,
                          prefetch=not args.no_prefetch,
                          log=print if lead else None)
        if args.resume:
            step = trainer.restore()
            if lead:
                print(f"resumed {args.ckpt_dir} @ step {step}")
        with tracer.profile_window(args.profile if lead else None):
            _, history = trainer.run()
        if args.ckpt_dir and lead:
            print(f"checkpoint -> {args.ckpt_dir}")
        if args.json_out and lead:
            gd = cfg.moe.gating_dropout if cfg.moe is not None else None
            with open(args.json_out, "w") as f:
                json.dump({"arch": cfg.arch_id, "device": str(device),
                           "backend": cfg.moe.backend if cfg.moe else None,
                           "comm": cfg.moe.comm.substrate if cfg.moe else None,
                           "ep": ctx.ep if ctx is not None else 1,
                           "tp": ctx.tp if ctx is not None else 1,
                           "ep_on_model": bool(ctx is not None and ctx.ep_on_model),
                           "history": history,
                           "gd": dataclasses.asdict(gd) if gd else None}, f)
        if args.trace_out and lead:
            tracer.export(args.trace_out)
        if args.metrics_out and lead:
            write_metrics(train_metrics(history), args.metrics_out)
    finally:
        if ctx is not None:
            close_group()


if __name__ == "__main__":
    main()
