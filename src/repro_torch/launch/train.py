"""Training CLI (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch zcode-m3-base \
      --steps 20 --batch 16 --seq 64 --task mt --gd-mode gate_drop \
      --gd-rate 0.3 --backend cuda_fused --eval-every 10

Runs on the GPU unless ``--device cpu`` is given, and fails without one.
Parameters are drawn from ``--seed``; the batches are the reference's
synthetic multilingual MT task, bit for bit; every step takes the
Gating Dropout consensus bit of (seed, step). ``--eval-every N`` scores
greedy-decoded corpus BLEU (``greedy_bleu``) every N steps and at the
last. ``--ckpt-dir`` saves the train state at the end in the reference's
layout, and ``--resume`` continues from it at the absolute step.

Expert parallelism: one process per rank, as ``torchrun`` starts them;
``--mesh N`` runs the MoE layers over the N ranks (each holds E/N experts
and a block of every batch's rows), the dispatch and combine all-to-alls
being the ``--comm`` substrate's:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --device cpu --mesh 2 --reduced --task mt --gd-mode gate_drop \
      --gd-rate 0.3 --eval-every 4 --log-every 1

``--device cpu`` takes gloo, ``cuda`` NCCL with one card per rank. Rank 0
prints the records and writes ``--json-out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import COMM_SUBSTRATES, MOE_BACKENDS, TrainConfig
from repro_torch.data import (LMTaskConfig, MTTaskConfig, MultilingualMT,
                              SyntheticLM)
from repro_torch.launch.mesh import close_group, make_group, parse_mesh
from repro_torch.launch.serve import resolve_device
from repro_torch.metrics import corpus_bleu, strip_special
from repro_torch.serve import GenerateConfig, generate
from repro_torch.training import Trainer


def build_batch_fn(cfg, args):
    """(task, per-step numpy batches of it); pure host work: it runs on
    the prefetch thread."""
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
    the validation batch to one language. Under an expert-parallel
    ``ctx`` each rank decodes its block of the rows and every rank
    gathers all the tokens and scores them. ``return_tokens`` returns
    (bleu, the scored tokens)."""
    kw = {} if lang is None else {"lang": lang}
    b = task.sample_batch(seed, n, **kw)
    rows = slice(None)
    if ctx is not None and ctx.ep > 1:
        if n % ctx.ep:
            raise ValueError(f"{n} eval rows do not split over ep={ctx.ep}")
        per = n // ctx.ep
        rows = slice(ctx.rank * per, (ctx.rank + 1) * per)
    batch = {"enc_tokens": torch.from_numpy(b["enc_tokens"][rows]).to(device),
             "tokens": torch.from_numpy(b["tokens"][rows, :1]).to(device)}
    res = generate(params, batch, cfg, GenerateConfig(max_new=max_new), ctx=ctx)
    tokens = res.tokens
    if rows != slice(None):
        parts = [torch.empty_like(tokens) for _ in range(ctx.ep)]
        dist.all_gather(parts, tokens.contiguous(), group=ctx.group)
        tokens = torch.cat(parts)
    hyps = [strip_special(h) for h in tokens.cpu().numpy()]
    refs = [strip_special(r) for r in b["labels"]]
    bleu = corpus_bleu(hyps, refs)
    return (bleu, tokens) if return_tokens else bleu


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
                    help="N: expert parallelism over N ranks (one process "
                         "each, started by torchrun)")
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
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    ep = parse_mesh(args.mesh) if args.mesh else 0
    if ep > 1 and args.ckpt_dir:
        ap.error("--ckpt-dir with --mesh N > 1: the gathered checkpoint of an "
                 "expert-parallel run is not ported (ROADMAP.md)")

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
            backend=args.backend or cfg.moe.backend))

    ctx = make_group(ep, device) if ep else None
    lead = ctx is None or ctx.rank == 0
    try:
        tc = TrainConfig(lr=args.lr, warmup_steps=args.warmup, steps=args.steps,
                         seed=args.seed, schedule=args.schedule,
                         microbatches=args.microbatches)
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
            print(f"resumed {args.ckpt_dir} @ step {trainer.restore()}")
        _, history = trainer.run()
        if args.ckpt_dir:
            print(f"checkpoint -> {args.ckpt_dir}")
        if args.json_out and lead:
            gd = cfg.moe.gating_dropout if cfg.moe is not None else None
            with open(args.json_out, "w") as f:
                json.dump({"arch": cfg.arch_id, "device": str(device),
                           "backend": cfg.moe.backend if cfg.moe else None,
                           "comm": cfg.moe.comm.substrate if cfg.moe else None,
                           "ep": ctx.ep if ctx is not None else 1,
                           "history": history,
                           "gd": dataclasses.asdict(gd) if gd else None}, f)
    finally:
        if ctx is not None:
            close_group()


if __name__ == "__main__":
    main()
