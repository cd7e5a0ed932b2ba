"""Serving CLI: one-shot batched decode (greedy, sampled or beam search)
or a continuous-batching loop over a slot pool or a paged KV cache (port
of ``repro/launch/serve.py``).

One-shot:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zcode-m3-base \
      --batch 8 --prompt-len 32 --max-new 32 --eos -1 \
      --backend cuda --flash-decode
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zcode-m3-base \
      --backend cuda --flash-decode --beam 4          # beam search
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zcode-m3-base \
      --backend cuda_fused --flash-decode --eos -1    # the fused MoE kernel

The first ``generate`` call builds the kernels and warms the allocator;
``TIMED_ROUNDS`` rounds after it are timed by ``time_generate``.

Continuous batching (``serve/scheduler.py``): ``--trace N`` synthesizes N
requests with Poisson arrivals (``--rate`` requests/s), prompt lengths
uniform over [2, largest bucket] and token budgets uniform over [2,
--max-new], serves them through the ``ContinuousScheduler`` (or, with
``--paged``, the ``PagedScheduler``) twice, and reports the second
replay's throughput, TTFT and per-token latency percentiles, the
scheduler's counters and, paged, the page arena's:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zcode-m3-base \
      --trace 32 --slots 8 --paged --backend cuda --flash-decode --eos -1

Decoder-only archs (yi-6b, codeqwen1.5-7b, dbrx-132b, deepseek-v3-671b,
mamba2-1.3b, hymba-1.5b) take prompts alone; ``--layers N`` cuts the depth of one too large for
the card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
      --layers 2 --backend cuda_fused --flash-decode --eos -1
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v3-671b --layers 2 --backend cuda_fused --eos -1

llama-3.2-vision-90b (a tanh-gated cross-attention layer every fifth
layer onto 1,601 image embeddings, ``--layers 10`` on one card) and
whisper-small (its encoder on 1,500 audio frames) serve on synthetic
conditioning inputs, drawn per request under ``--trace``; ``--flash-decode``
reaches B5 (B6 under ``--paged``) on their self-attention layers, and their
cross-attention read stays plain, as in the reference:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-90b --layers 10 --flash-decode --eos -1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --trace 32 --paged --flash-decode --eos -1

deepseek-v3-671b's layers attend through multi-head latent attention,
whose absorbed decode is plain PyTorch, as in the reference:
``--flash-decode`` reaches no flash-decode kernel on them.

mamba2-1.3b (every layer an SSM) and hymba-1.5b (attention and SSM heads
side by side, 128 meta tokens) prefill every prompt of the slot pool at
its exact length. ``--flash-decode`` reaches no kernel on mamba2-1.3b and,
on hymba-1.5b, B5 (B6 under ``--paged``) on its three global-attention
layers alone: its windowed layers keep the plain ring read and its SSM
heads their plain recurrence, as in the reference. ``--paged`` refuses
mamba2-1.3b (no cache to page):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --flash-decode --eos -1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --trace 32 --paged --flash-decode --eos -1

Runs on the GPU unless ``--device cpu`` is given, and fails without one.
Parameters, prompts and sampling draw from distinct streams of ``--seed``.

``--trace-out PATH`` turns on the span tracer and writes its Chrome trace
(open it at https://ui.perfetto.dev): the reported replay's scheduler
spans (``sched.*``, ``prefix_cache.*``) or, one-shot, ``generate.first``
and ``generate.steady``. ``--metrics-out PATH`` writes the metrics
registry (``.prom``/``.txt``: Prometheus text, else JSON): the scheduler's
histograms and series with ``serve/wall_s``, ``serve/tok_s``,
``serve/req_s`` and ``serve/stats/*``, or, one-shot, ``serve/first_s``,
``serve/wall_s`` and ``serve/tok_s``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import numpy as np
import torch

from repro_torch.configs import (COMM_SUBSTRATES, ModelConfig, PagedKVConfig,
                                 get_config, reduced)
from repro_torch.models import init_model
from repro_torch.obs import (MetricsRegistry, Tracer, get_tracer, monotonic,
                             set_tracer)
from repro_torch.obs.registry import Histogram
from repro_torch.serve import (ContinuousScheduler, GenerateConfig,
                               PagedScheduler, Request, generate,
                               paged_kv_bytes)

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


def cut_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` at ``n_layers`` layers. A cut to no more layers than the
    arch's leading dense ones (deepseek-v3-671b's 3) keeps the last layer
    an MoE layer, so that the cut model still runs both kinds; a hybrid
    keeps its global-attention layers that fall below the cut; a VLM
    keeps layer 0 gated, and every ``cross_attn_period``-th layer after it
    (llama-3.2-vision-90b at 10 layers: layers 0 and 5)."""
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(f"--layers {n_layers}: 1 to {cfg.n_layers}")
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if cfg.hybrid is not None:
        cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
            cfg.hybrid, global_attn_layers=tuple(
                i for i in cfg.hybrid.global_attn_layers if i < n_layers)))
    if cfg.moe is not None and cfg.moe.first_dense_layers >= n_layers:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=n_layers - 1))
    return cfg


def arch_config(args):
    """``--arch``'s config, ``--reduced`` to smoke-test size, its depth cut
    to ``--layers`` where given."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    return cfg


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """Stream ``stream`` (0 params, 1 prompts, 2 sampling) of ``seed``."""
    return torch.Generator(device=device).manual_seed(3 * seed + stream)


def synth_batch(cfg, gen: torch.Generator, batch: int, prompt_len: int):
    """Prompt tokens drawn uniformly from [3, vocab) — ids 0-2 are pad, BOS
    and EOS — and the family's conditioning inputs: SRC_TOKENS source
    tokens for the text encoder-decoder, f32 N(0, 1) audio frames
    (encoder_seq, d_model) for a stub frontend, f32 N(0, 1) image
    embeddings (n_image_tokens, d_image) for the VLM."""
    dev = gen.device
    out = {"tokens": torch.randint(3, cfg.vocab, (batch, prompt_len),
                                   generator=gen, device=dev)}
    if cfg.vlm is not None:
        out["img_embeds"] = torch.randn(
            (batch, cfg.vlm.n_image_tokens, cfg.vlm.d_image), generator=gen,
            device=dev)
    if cfg.encdec is not None and cfg.encdec.frontend == "stub":
        out["frames"] = torch.randn(
            (batch, cfg.encdec.encoder_seq, cfg.d_model), generator=gen,
            device=dev)
    elif cfg.encdec is not None:
        out["enc_tokens"] = torch.randint(3, cfg.vocab, (batch, SRC_TOKENS),
                                          generator=gen, device=dev)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_generate(params, batch, cfg, gen: GenerateConfig, *, seed: int = 0,
                  n_rounds: int = TIMED_ROUNDS):
    """Host-clock timing of warm ``generate`` calls, each ending in a device
    sync, over ``n_rounds`` rounds. Every round times a prefill-only call (``max_new=1``: prefill
    and the first token) and a full call; decode ms/step is (full -
    prefill-only) / decode steps, and tokens/s is generated tokens over the
    full call. Returns ({metric: median}, {metric: [per round]}, last
    result)."""
    device = batch["tokens"].device
    first = dataclasses.replace(gen, max_new=1)
    rounds = {"prefill_ms": [], "total_ms": [], "decode_ms_per_step": [],
              "tok_s": []}
    for _ in range(n_rounds):
        t0 = monotonic()
        generate(params, batch, cfg, first, seed=seed)
        _sync(device)
        t_pre = monotonic() - t0
        t0 = monotonic()
        res = generate(params, batch, cfg, gen, seed=seed)
        _sync(device)
        t_all = monotonic() - t0
        rounds["prefill_ms"].append(t_pre * 1e3)
        rounds["total_ms"].append(t_all * 1e3)
        rounds["decode_ms_per_step"].append(
            (t_all - t_pre) / max(res.steps, 1) * 1e3)
        rounds["tok_s"].append(int(res.lengths.sum()) / t_all)
    return ({k: statistics.median(v) for k, v in rounds.items()}, rounds, res)


def spread(values) -> str:
    return f"[{min(values):.2f}, {max(values):.2f}]"


def synth_trace(cfg, seed: int, n: int, rate: float, buckets, max_new: int):
    """Synthetic request trace drawn from ``np.random.RandomState(seed)``:
    Poisson arrivals (exponential gaps at ``rate`` requests/s, the first at
    t = 0), prompt lengths uniform over [2, max bucket], token budgets
    uniform over [2, max_new], tokens uniform over [3, vocab) and each
    request's own conditioning inputs, as ``synth_batch`` draws them:
    SRC_TOKENS source tokens, f32 N(0, 1) audio frames or f32 N(0, 1)
    image embeddings."""
    rs = np.random.RandomState(seed)
    gaps = rs.exponential(1.0 / rate, size=n)
    arrivals = np.cumsum(gaps) - gaps[0]
    reqs = []
    for i in range(n):
        plen = int(rs.randint(2, buckets[-1] + 1))
        budget = int(rs.randint(2, max_new + 1))
        toks = rs.randint(3, cfg.vocab, size=plen).astype(np.int64)
        extras = {}
        if cfg.vlm is not None:
            extras["img_embeds"] = rs.standard_normal(
                (cfg.vlm.n_image_tokens, cfg.vlm.d_image)).astype(np.float32)
        if cfg.encdec is not None and cfg.encdec.frontend == "stub":
            extras["frames"] = rs.standard_normal(
                (cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)
        elif cfg.encdec is not None:
            extras["enc_tokens"] = rs.randint(3, cfg.vocab,
                                              size=SRC_TOKENS).astype(np.int64)
        reqs.append(Request(rid=i, tokens=toks, extras=extras, max_new=budget,
                            arrival=float(arrivals[i])))
    return reqs


def _pcts(xs) -> dict:
    h = Histogram("_pcts")
    for x in xs:
        h.observe(x)
    return h.percentiles((50, 90, 99))


def trace_comm_section(cfg, gen, sched, ep: int) -> dict:
    """Price every device call of a trace (the scheduler's ``tick_log``)
    with the substrate bytes model (comm/cost.py): the wire bytes per tick
    a deployment at expert-parallel width ``ep`` would move, as totals
    and percentiles. Decode ticks under ``--local-routing`` move nothing
    (the Gate-Drop local path has no all-to-all)."""
    from repro_torch.comm import layer_cost
    from repro_torch.training.steps import n_moe_layers
    nl = n_moe_layers(cfg)
    per_tick, exposed_tick = [], []
    for kind, toks in sched.tick_log:
        if kind == "decode" and gen.local_routing:
            per_tick.append(0.0)
            exposed_tick.append(0.0)
            continue
        c = layer_cost(cfg, tokens_per_shard=max(toks // ep, 1), ep=ep,
                       is_training=False)
        per_tick.append(c["wire_bytes"] * nl)
        exposed_tick.append(c["exposed_wire_bytes"] * nl)
    return {
        "substrate": cfg.moe.comm.substrate,
        "quant": cfg.moe.comm.quant,
        "n_chunks": cfg.moe.comm.n_chunks,
        "ep_model": ep,
        "n_ticks": len(per_tick),
        "wire_bytes_total": float(sum(per_tick)),
        # the wire an overlapped substrate cannot hide behind the expert
        # FFN of the same tick (= the total for the others)
        "exposed_bytes_total": float(sum(exposed_tick)),
        "wire_bytes_per_tick": _pcts(per_tick) if per_tick else {},
    }


def trace_cache_section(sched: PagedScheduler) -> dict:
    """Page-arena occupancy of a --paged trace: what the arena held
    against what it pins."""
    lay = sched.layout
    return {
        "page_size": lay.page_size,
        "n_pages": lay.n_pages,
        "n_blocks": lay.n_blocks,
        "peak_pages_in_use": sched.stats["peak_pages_in_use"],
        "peak_kv_bytes": int(sched.stats["peak_pages_in_use"] * sched.page_bytes),
        "arena_kv_bytes": (int(paged_kv_bytes(sched.pool, sched.cfg))
                           if sched.pool is not None else 0),
        "prefix_hit_rate": (sched.stats["prefix_hits"]
                            / max(sched.stats["prefix_lookups"], 1)),
        "prefix_hits": sched.stats["prefix_hits"],
        "cow_copies": sched.stats["cow_copies"],
        "preemptions": sched.stats["preemptions"],
        "swap_ins": sched.stats["swap_ins"],
        "mean_alive_slots": (float(np.mean(sched.alive_log))
                             if sched.alive_log else 0.0),
    }


def write_metrics(reg: MetricsRegistry, path: str) -> None:
    """``.prom``/``.txt``: Prometheus text exposition, else JSON."""
    if path.endswith((".prom", ".txt")):
        reg.to_prometheus(path)
    else:
        reg.to_json(path)


def run_trace(args, cfg, params, gen, device) -> dict:
    """Serve ``--trace`` requests through a scheduler, twice: the first
    replay builds the kernels and warms the allocator, the second, on a
    fresh scheduler, is reported (and alone kept on the tracer). One JSON
    record; the registry gains the run's gauges."""
    buckets = tuple(int(b) for b in args.buckets.split(","))
    reqs = synth_trace(cfg, 3 * args.seed + 1, args.trace, args.rate, buckets,
                       gen.max_new)
    for _ in range(2):
        get_tracer().clear()
        reg = MetricsRegistry()
        kw = dict(n_slots=args.slots, prefill_buckets=buckets,
                  admit_width=args.admit_width, seed=3 * args.seed + 2,
                  registry=reg)
        if args.paged:
            paged = PagedKVConfig(page_size=args.page_size, n_pages=args.pages,
                                  prefix_caching=not args.no_prefix_cache)
            sched = PagedScheduler(params, cfg, gen, paged=paged, **kw)
        else:
            sched = ContinuousScheduler(params, cfg, gen, **kw)
        t0 = monotonic()
        results = sched.run([dataclasses.replace(r) for r in reqs])
        _sync(device)
        wall = monotonic() - t0
    n_tok = int(sum(r.length for r in results))
    rec = {
        "mode": "paged" if args.paged else "continuous",
        "arch": cfg.arch_id,
        "device": str(device),
        "n_requests": len(results),
        "n_tokens": n_tok,
        "wall_s": wall,
        "tok_s": n_tok / wall,
        "req_s": len(results) / wall,
        "ttft_s": reg.histogram("serve/ttft_s").percentiles((50, 90, 99)),
        "per_token_latency_s": reg.histogram(
            "serve/per_token_latency_s").percentiles((50, 90, 99)),
        "scheduler": dict(sched.stats),
        "slots": args.slots,
        "buckets": list(buckets),
        "local_routing": gen.local_routing,
        "tokens": {r.rid: r.tokens.tolist() for r in results},
    }
    if args.paged:
        rec["cache"] = trace_cache_section(sched)
    if cfg.moe is not None:
        rec["comm"] = trace_comm_section(cfg, gen, sched, args.comm_ep)
    # throughput and the scheduler's counters beside its histograms: one
    # --metrics-out file carries the whole serving picture
    reg.gauge("serve/wall_s").set(wall)
    reg.gauge("serve/tok_s").set(rec["tok_s"])
    reg.gauge("serve/req_s").set(rec["req_s"])
    for k, v in sched.stats.items():
        reg.gauge(f"serve/stats/{k}").set(float(v))
    if args.metrics_out:
        write_metrics(reg, args.metrics_out)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zcode-m3-base")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (a model too large for "
                         "the card at full depth, e.g. dbrx-132b); a cut to "
                         "no more than the arch's leading dense layers keeps "
                         "the last layer MoE")
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
    ap.add_argument("--beam", type=int, default=1,
                    help=">1 = beam search (overrides sampling)")
    ap.add_argument("--backend", default=None,
                    choices=[None, "auto", "oracle", "cuda", "cuda_fused"],
                    help="MoE execution backend (cuda = the kernel pipeline, "
                         "cuda_fused = the one-launch fused kernel)")
    ap.add_argument("--comm", default=None, choices=[None, *COMM_SUBSTRATES],
                    help="communication substrate of the expert dispatch")
    ap.add_argument("--comm-quant", default=None, choices=[None, "int8", "fp8"],
                    help="wire dtype of the compressed substrates")
    ap.add_argument("--comm-chunks", type=int, default=None,
                    help="overlapped substrates: capacity micro-chunks")
    ap.add_argument("--comm-ep", type=int, default=1,
                    help="expert-parallel width the --trace comm accounting "
                         "prices the wire at (default 1 = this process)")
    ap.add_argument("--flash-decode", action="store_true",
                    help="decode attention through the flash-decode kernel "
                         "(GQA layers with a full cache: B5, or B6 under "
                         "--paged; MLA layers keep their plain absorbed "
                         "decode, sliding-window layers their plain ring "
                         "read and SSM heads their plain recurrence, as in "
                         "the reference: on hymba-1.5b only its global "
                         "layers 0, 15 and 31 reach a kernel, on "
                         "mamba2-1.3b none)")
    ap.add_argument("--local-routing", action="store_true",
                    help="Gate-Drop local routing at decode")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # continuous batching
    ap.add_argument("--trace", type=int, default=0,
                    help="N>0: serve N synthetic Poisson-arrival requests "
                         "through the continuous-batching scheduler")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="trace arrival rate, requests/s")
    ap.add_argument("--slots", type=int, default=8, help="decode slots")
    ap.add_argument("--admit-width", type=int, default=None,
                    help="admission group width (default min(4, slots))")
    ap.add_argument("--buckets", default="8,16,32,64",
                    help="prefill length buckets, comma-separated")
    ap.add_argument("--paged", action="store_true",
                    help="serve --trace through the paged-KV scheduler")
    ap.add_argument("--page-size", type=int, default=PagedKVConfig.page_size,
                    help="KV page size in tokens (--paged)")
    ap.add_argument("--pages", type=int, default=PagedKVConfig.n_pages,
                    help="physical page count (0 = n_slots_equiv full-length "
                         "requests' worth, --paged)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix page caching (--paged)")
    ap.add_argument("--json-out", default=None, help="write metrics JSON here")
    ap.add_argument("--trace-out", default=None,
                    help="turn on the span tracer and write a Chrome-trace "
                         "(Perfetto) JSON of the run here")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry here (.prom/.txt = "
                         "Prometheus text, else JSON)")
    args = ap.parse_args(argv)
    tracer = set_tracer(Tracer(enabled=bool(args.trace_out)))

    device = resolve_device(args.device)
    cfg = arch_config(args)
    if cfg.moe is not None:
        comm = cfg.moe.comm
        comm = dataclasses.replace(
            comm, substrate=args.comm or comm.substrate,
            quant=args.comm_quant or comm.quant,
            n_chunks=(args.comm_chunks if args.comm_chunks is not None
                      else comm.n_chunks))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, backend=args.backend or cfg.moe.backend, comm=comm))
    params = init_model(generator(device, args.seed, 0), cfg)
    batch = synth_batch(cfg, generator(device, args.seed, 1), args.batch,
                        args.prompt_len)
    gen = GenerateConfig(max_new=args.max_new, temperature=args.temperature,
                         top_k=args.top_k, beam_width=args.beam, eos_id=args.eos,
                         local_routing=args.local_routing,
                         flash_decode=args.flash_decode)
    sample_seed = 3 * args.seed + 2

    if args.trace > 0:
        rec = run_trace(args, cfg, params, gen, device)
        print(f"arch={rec['arch']} n_layers={cfg.n_layers} device={device} "
              f"{rec['mode']}: served "
              f"{rec['n_requests']} requests, {rec['n_tokens']} tokens in "
              f"{rec['wall_s']:.2f} s ({rec['tok_s']:.0f} tok/s)")
        print("TTFT p50/p90/p99: "
              + "/".join(f"{rec['ttft_s'][p] * 1e3:.1f}" for p in (50, 90, 99))
              + " ms; per-token latency p50/p90/p99: "
              + "/".join(f"{rec['per_token_latency_s'][p] * 1e3:.2f}"
                         for p in (50, 90, 99)) + " ms")
        print("scheduler:", rec["scheduler"])
        if "cache" in rec:
            k = rec["cache"]
            print(f"cache[paged {k['page_size']}tok]: peak "
                  f"{k['peak_pages_in_use']}/{k['n_pages']} pages "
                  f"({k['peak_kv_bytes'] / 2**20:.2f} MiB KV), prefix hit rate "
                  f"{k['prefix_hit_rate']:.2f}, {k['cow_copies']} COW, "
                  f"{k['preemptions']} preemptions")
        if "comm" in rec:
            c = rec["comm"]
            print(f"comm[{c['substrate']}@ep={c['ep_model']}]: "
                  f"{c['wire_bytes_total'] / 2**20:.3f} MiB on the wire over "
                  f"{c['n_ticks']} ticks ({c['exposed_bytes_total'] / 2**20:.3f} "
                  "MiB exposed)")
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(rec, f, indent=1)
        if args.trace_out:
            tracer.export(args.trace_out)
        return

    t0 = monotonic()
    with tracer.span("generate.first"):
        generate(params, batch, cfg, gen, seed=sample_seed)
        _sync(device)
    t_first = monotonic() - t0
    with tracer.span("generate.steady", rounds=TIMED_ROUNDS):
        med, rounds, res = time_generate(params, batch, cfg, gen, seed=sample_seed)
    n_tok = int(res.lengths.sum())
    print(f"arch={cfg.arch_id} n_layers={cfg.n_layers} device={device} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new} beam={args.beam}")
    print(f"first (build + warm-up): {t_first:.2f} s; median of {TIMED_ROUNDS}: "
          f"prefill {med['prefill_ms']:.2f} ms {spread(rounds['prefill_ms'])}, "
          f"decode {med['decode_ms_per_step']:.2f} ms/step "
          f"{spread(rounds['decode_ms_per_step'])} over {res.steps} steps, "
          f"total {med['total_ms']:.2f} ms {spread(rounds['total_ms'])}, "
          f"{med['tok_s']:.0f} tok/s")
    print("sample:", res.tokens[0][:16].tolist())
    if args.json_out:
        rec = {"mode": "oneshot", "arch": cfg.arch_id, "device": str(device),
               "beam": args.beam, "scores": res.scores.tolist(),
               "n_tokens": n_tok, "wall_s": med["total_ms"] / 1e3,
               "tok_s": med["tok_s"], "first_s": t_first, "steps": res.steps,
               "median": med, "rounds": rounds, "tokens": res.tokens.tolist()}
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
    if args.trace_out:
        tracer.export(args.trace_out)
    if args.metrics_out:
        reg = MetricsRegistry()
        reg.gauge("serve/first_s").set(t_first)
        reg.gauge("serve/wall_s").set(med["total_ms"] / 1e3)
        reg.gauge("serve/tok_s").set(med["tok_s"])
        write_metrics(reg, args.metrics_out)


if __name__ == "__main__":
    main()
