"""Serving CLI, one-shot batched decode (port of the one-shot mode of
``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zcode-m3-base \
      --batch 8 --prompt-len 32 --max-new 32 --eos -1 \
      --backend cuda --flash-decode

Runs on the GPU unless ``--device cpu`` is given, and fails without one.
Parameters, prompts and sampling draw from distinct streams of ``--seed``.
The first ``generate`` call builds the kernels and warms the allocator;
``TIMED_ROUNDS`` rounds after it are timed by ``time_generate``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import init_model
from repro_torch.serve import GenerateConfig, generate

SRC_TOKENS = 32   # source sentence length of the synthetic MT batch
TIMED_ROUNDS = 5  # host-clock rounds behind each reported median


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) requires a card; ``cpu`` is explicit."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"device {name!r}: cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    return torch.device("cuda")


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """Stream ``stream`` (0 params, 1 prompts, 2 sampling) of ``seed``."""
    return torch.Generator(device=device).manual_seed(3 * seed + stream)


def synth_batch(cfg, gen: torch.Generator, batch: int, prompt_len: int):
    """Prompt tokens (and source tokens for the text encoder-decoder) drawn
    uniformly from [3, vocab) — ids 0-2 are pad, BOS and EOS."""
    dev = gen.device
    out = {"tokens": torch.randint(3, cfg.vocab, (batch, prompt_len),
                                   generator=gen, device=dev)}
    if cfg.encdec is not None:
        out["enc_tokens"] = torch.randint(3, cfg.vocab, (batch, SRC_TOKENS),
                                          generator=gen, device=dev)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_generate(params, batch, cfg, gen: GenerateConfig, *, seed: int = 0):
    """Host-clock timing of warm ``generate`` calls, each ending in a device
    sync, over TIMED_ROUNDS rounds. Every round times a prefill-only call (``max_new=1``: prefill
    and the first token) and a full call; decode ms/step is (full -
    prefill-only) / decode steps, and tokens/s is generated tokens over the
    full call. Returns ({metric: median}, {metric: [per round]}, last
    result)."""
    device = batch["tokens"].device
    first = dataclasses.replace(gen, max_new=1)
    rounds = {"prefill_ms": [], "total_ms": [], "decode_ms_per_step": [],
              "tok_s": []}
    for _ in range(TIMED_ROUNDS):
        t0 = time.perf_counter()
        generate(params, batch, cfg, first, seed=seed)
        _sync(device)
        t_pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = generate(params, batch, cfg, gen, seed=seed)
        _sync(device)
        t_all = time.perf_counter() - t0
        rounds["prefill_ms"].append(t_pre * 1e3)
        rounds["total_ms"].append(t_all * 1e3)
        rounds["decode_ms_per_step"].append(
            (t_all - t_pre) / max(res.steps, 1) * 1e3)
        rounds["tok_s"].append(int(res.lengths.sum()) / t_all)
    return ({k: statistics.median(v) for k, v in rounds.items()}, rounds, res)


def spread(values) -> str:
    return f"[{min(values):.2f}, {max(values):.2f}]"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zcode-m3-base")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eos", type=int, default=GenerateConfig.eos_id,
                    help="EOS token id for early exit (-1 = generate max-new "
                         "tokens unconditionally)")
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sampling pool size (0 = full vocab)")
    ap.add_argument("--backend", default=None, choices=[None, "oracle", "cuda"],
                    help="MoE execution backend (cuda = the kernel pipeline)")
    ap.add_argument("--flash-decode", action="store_true",
                    help="decode attention through the flash-decode kernel")
    ap.add_argument("--local-routing", action="store_true",
                    help="Gate-Drop local routing at decode")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json-out", default=None, help="write metrics JSON here")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.moe is not None and args.backend:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, backend=args.backend))
    params = init_model(generator(device, args.seed, 0), cfg)
    batch = synth_batch(cfg, generator(device, args.seed, 1), args.batch,
                        args.prompt_len)
    gen = GenerateConfig(max_new=args.max_new, temperature=args.temperature,
                         top_k=args.top_k, eos_id=args.eos,
                         local_routing=args.local_routing,
                         flash_decode=args.flash_decode)
    sample_seed = 3 * args.seed + 2

    t0 = time.perf_counter()
    generate(params, batch, cfg, gen, seed=sample_seed)
    _sync(device)
    t_first = time.perf_counter() - t0
    med, rounds, res = time_generate(params, batch, cfg, gen, seed=sample_seed)
    n_tok = int(res.lengths.sum())
    print(f"arch={cfg.arch_id} device={device} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new}")
    print(f"first (build + warm-up): {t_first:.2f} s; median of {TIMED_ROUNDS}: "
          f"prefill {med['prefill_ms']:.2f} ms {spread(rounds['prefill_ms'])}, "
          f"decode {med['decode_ms_per_step']:.2f} ms/step "
          f"{spread(rounds['decode_ms_per_step'])} over {res.steps} steps, "
          f"total {med['total_ms']:.2f} ms {spread(rounds['total_ms'])}, "
          f"{med['tok_s']:.0f} tok/s")
    print("sample:", res.tokens[0][:16].tolist())
    if args.json_out:
        rec = {"mode": "oneshot", "arch": cfg.arch_id, "device": str(device),
               "n_tokens": n_tok, "wall_s": med["total_ms"] / 1e3,
               "tok_s": med["tok_s"], "first_s": t_first, "steps": res.steps,
               "median": med, "rounds": rounds, "tokens": res.tokens.tolist()}
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
