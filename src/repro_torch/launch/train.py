"""Training CLI (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch zcode-m3-base \
      --steps 20 --batch 16 --seq 64 --task mt --gd-mode gate_drop \
      --gd-rate 0.3 --backend cuda_fused

Runs on the GPU unless ``--device cpu`` is given, and fails without one.
Parameters are drawn from ``--seed``; the batches are the reference's
synthetic multilingual MT task, bit for bit; every step takes the
Gating Dropout consensus bit of (seed, step). ``--ckpt-dir`` saves the
train state at the end in the reference's layout, and ``--resume``
continues from it at the absolute step. BLEU evaluation (the reference's
``--eval-every``) comes with a later slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MOE_BACKENDS, TrainConfig
from repro_torch.data import (LMTaskConfig, MTTaskConfig, MultilingualMT,
                              SyntheticLM)
from repro_torch.launch.serve import resolve_device
from repro_torch.training import Trainer


def build_batch_fn(cfg, args):
    """Per-step numpy batches of the task (pure host work: it runs on the
    prefetch thread)."""
    if args.task == "mt":
        task = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=args.langs,
                                           max_len=args.seq))
        return task.train_batches(args.batch)
    if cfg.encdec is not None:
        raise ValueError(f"--task lm has no source sentences for the "
                         f"encoder-decoder {cfg.arch_id}; use --task mt")
    task = SyntheticLM(LMTaskConfig(vocab=cfg.vocab, seq_len=args.seq))
    return lambda step: task.sample_batch(step, args.batch)


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
    ap.add_argument("--gd-mode", default=None,
                    choices=[None, "off", "gate_drop", "gate_expert_drop"])
    ap.add_argument("--gd-rate", type=float, default=None)
    ap.add_argument("--router", default=None,
                    choices=[None, "softmax", "sigmoid", "hash"])
    ap.add_argument("--backend", default=None, choices=[None, *MOE_BACKENDS],
                    help="MoE execution backend (cuda = the kernel pipeline, "
                         "cuda_fused = the one-launch fused kernel)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir "
                         "(params + opt + step) and continue training")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.moe is not None:
        gd = cfg.moe.gating_dropout
        gd = dataclasses.replace(
            gd, mode=args.gd_mode or gd.mode,
            rate=args.gd_rate if args.gd_rate is not None else gd.rate)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, gating_dropout=gd,
            router_type=args.router or cfg.moe.router_type,
            backend=args.backend or cfg.moe.backend))

    tc = TrainConfig(lr=args.lr, warmup_steps=args.warmup, steps=args.steps,
                     seed=args.seed, schedule=args.schedule,
                     microbatches=args.microbatches)
    trainer = Trainer(cfg, tc, build_batch_fn(cfg, args), device=device,
                      chunk=args.chunk, ckpt_dir=args.ckpt_dir,
                      log_every=args.log_every)
    if args.resume:
        print(f"resumed {args.ckpt_dir} @ step {trainer.restore()}")
    _, history = trainer.run()
    if args.ckpt_dir:
        print(f"checkpoint -> {args.ckpt_dir}")
    if args.json_out:
        gd = cfg.moe.gating_dropout if cfg.moe is not None else None
        with open(args.json_out, "w") as f:
            json.dump({"arch": cfg.arch_id, "device": str(device),
                       "backend": cfg.moe.backend if cfg.moe else None,
                       "history": history,
                       "gd": dataclasses.asdict(gd) if gd else None}, f)


if __name__ == "__main__":
    main()
