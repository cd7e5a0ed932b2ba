"""Decoding engine (port of ``repro/serve/engine.py``): greedy and sampled
generation over slot-addressed stepwise primitives.

The contract of the reference (DESIGN.md §7):
  * prefill writes cache positions [0, P) for a P-token prompt and returns
    the logits of position P-1, the distribution of the FIRST generated
    token; the first ``decode_step`` therefore runs at position P.
  * per-sequence EOS: once a row emits ``eos_id`` it produces only
    ``pad_id`` and stops counting toward ``lengths``; the loop ends when
    every row is done.

The reference's ``lax.while_loop`` is a Python loop here, one decode step
per iteration; the EOS exit test is the only host sync, and it is skipped
when EOS is off. Sampling draws Gumbel noise from a ``torch.Generator``
seeded per (seed, step): its bits differ from JAX's, so only greedy
decoding is held to the reference token for token. Beam search and the
continuous and paged schedulers come with later slices.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_step, init_cache, prefill
from repro_torch.tree import tree_map

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """Decoding options.

    temperature <= 0 means greedy argmax; ``top_k`` restricts sampling to
    the k highest logits (0 = full vocab). ``eos_id < 0`` disables EOS.
    ``local_routing`` reuses Gating Dropout's local routing path at decode
    time. ``flash_decode`` reads decode attention through the flash-decode
    kernel. ``max_seq`` overrides the cache length (0 = prompt_len +
    max_new).
    """
    max_new: int = 32
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = 2
    pad_id: int = 0
    local_routing: bool = False
    flash_decode: bool = False
    max_seq: int = 0

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")


class GenerateResult(NamedTuple):
    tokens: torch.Tensor     # (B, max_new) int64; pad_id after EOS
    lengths: torch.Tensor    # (B,) generated tokens incl. the EOS itself
    scores: torch.Tensor     # (B,) f32 sum log p of emitted tokens
    steps: int               # decode-loop iterations actually run


# ---------------------------------------------------------------------------
# slot pool
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _cache_batch_axes(cfg: ModelConfig):
    """Per-leaf batch-axis index of the decode cache (-1 = none), found by
    building the cache at two batch sizes on the meta device (shapes only)."""
    a = init_cache(cfg, 2, 16, device="meta")
    b = init_cache(cfg, 5, 16, device="meta")

    def axis(x, y):
        diff = [i for i, (m, n) in enumerate(zip(x.shape, y.shape)) if m != n]
        if len(diff) > 1:
            raise ValueError(f"ambiguous batch axis {x.shape} vs {y.shape}")
        return diff[0] if diff else -1

    return tree_map(axis, a, b)


def _alloc_pool_like(fresh, axes, n_slots: int):
    """Zero slot pool whose leaves mirror a per-request cache tree with the
    batch axis resized to ``n_slots`` (unbatched leaves gain the slot axis
    after the repeats axis)."""
    def alloc(fr, ax):
        if ax >= 0:
            shape = fr.shape[:ax] + (n_slots,) + fr.shape[ax + 1:]
        else:
            shape = fr.shape[:1] + (n_slots,) + fr.shape[1:]
        return torch.zeros(shape, dtype=fr.dtype, device=fr.device)

    return tree_map(alloc, fresh, axes)


def _scatter_slots(pool, fresh, axes, slots: torch.Tensor):
    """Write per-request cache rows ``fresh`` into pool rows ``slots``, in
    place; returns the pool."""
    n = slots.shape[0]

    def put(pl, fr, ax):
        pool_ax = ax if ax >= 0 else 1
        if ax >= 0:
            rows = fr.movedim(ax, 0)
        else:
            rows = fr.unsqueeze(0).expand((n,) + fr.shape)
        pl.movedim(pool_ax, 0)[slots] = rows.to(pl.dtype)
        return pl

    return tree_map(put, pool, fresh, axes)


def decode_pool_step(params, pool, tok: torch.Tensor, pos: torch.Tensor,
                     alive: torch.Tensor, cfg: ModelConfig, *,
                     local_routing: bool = False, flash_decode: bool = False):
    """One batched ``decode_step`` over all pool slots at per-slot
    positions; dead slots step too but take no expert capacity. Returns
    (logits (S, V), pool)."""
    lg, pool = decode_step(params, pool, tok[:, None], pos, cfg,
                           local_routing=local_routing, token_valid=alive,
                           flash_decode=flash_decode)
    return lg[:, 0], pool


# ---------------------------------------------------------------------------
# token selection
# ---------------------------------------------------------------------------

def _select_rows(gen: GenerateConfig, logits: torch.Tensor, seed: int,
                 step: int):
    """(N, V) f32 logits -> (token (N,), log p of token (N,))."""
    logp = torch.log_softmax(logits, dim=-1)
    if gen.temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
    else:
        scaled = logits / gen.temperature
        if gen.top_k > 0:
            kth = torch.topk(scaled, gen.top_k, dim=-1).values[..., -1:]
            scaled = scaled.masked_fill(scaled < kth, NEG)
        g = torch.Generator(device=logits.device)
        g.manual_seed((seed * 1_000_003 + step) & 0x7FFF_FFFF_FFFF_FFFF)
        u = torch.rand(scaled.shape, generator=g, device=logits.device)
        tok = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return tok, logp.gather(1, tok[:, None])[:, 0]


def _advance(gen: GenerateConfig, nxt, lp, done, length, score):
    """Finished rows emit pad, stop counting, and set done on EOS."""
    nxt = torch.where(done, gen.pad_id, nxt)
    score = score + torch.where(done, 0.0, lp)
    length = length + (~done).long()
    if gen.eos_id >= 0:
        done = done | (nxt == gen.eos_id)
    return nxt, done, length, score


# ---------------------------------------------------------------------------
# greedy / sampling loop
# ---------------------------------------------------------------------------

def _check_cache_budget(max_seq: int, prompt_len: int, max_new: int):
    if max_seq < prompt_len + max_new:
        raise ValueError(
            f"prompt_len ({prompt_len}) + max_new ({max_new}) exceeds the "
            f"cache length max_seq={max_seq}")


def _generate_sample(params, batch, seed: int, cfg: ModelConfig,
                     gen: GenerateConfig) -> GenerateResult:
    b, prompt_len = batch["tokens"].shape
    dev = batch["tokens"].device
    max_seq = gen.max_seq or (prompt_len + gen.max_new)
    _check_cache_budget(max_seq, prompt_len, gen.max_new)
    lengths = torch.full((b,), prompt_len, dtype=torch.long, device=dev)
    logits, fresh = prefill(params, batch, cfg, max_seq=max_seq,
                            last_index=lengths - 1)
    axes = _cache_batch_axes(cfg)
    pool = _scatter_slots(_alloc_pool_like(fresh, axes, b), fresh, axes,
                          torch.arange(b, device=dev))
    del fresh
    cur, score = _select_rows(gen, logits[:, 0].float(), seed, 0)
    done = (cur == gen.eos_id) if gen.eos_id >= 0 else torch.zeros(
        b, dtype=torch.bool, device=dev)
    buf = torch.full((b, gen.max_new), gen.pad_id, dtype=torch.long, device=dev)
    buf[:, 0] = cur
    pos = lengths.clone()                     # token 0 lives at position P
    length = torch.ones(b, dtype=torch.long, device=dev)
    i = 1
    while i < gen.max_new:
        if gen.eos_id >= 0 and bool(done.all()):
            break
        lg, pool = decode_pool_step(params, pool, cur, pos, ~done, cfg,
                                    local_routing=gen.local_routing,
                                    flash_decode=gen.flash_decode)
        nxt, lp = _select_rows(gen, lg.float(), seed, i)
        cur, done, length, score = _advance(gen, nxt, lp, done, length, score)
        buf[:, i] = cur
        pos = pos + 1
        i += 1
    return GenerateResult(tokens=buf, lengths=length, scores=score, steps=i - 1)


def _check_local_routing(cfg: ModelConfig, gen: GenerateConfig):
    if (gen.local_routing and cfg.moe is not None
            and cfg.moe.gating_dropout.mode == "gate_expert_drop"):
        raise ValueError(
            "local_routing reuses the Gate-Drop LOCAL path; with "
            "gating_dropout.mode='gate_expert_drop' the dropped branch "
            "skips the MoE layer entirely — not a serving mode")


@torch.no_grad()
def generate(params, batch: Dict[str, Any], cfg: ModelConfig,
             gen: GenerateConfig = GenerateConfig(),
             seed: int = 0) -> GenerateResult:
    """Generate ``gen.max_new`` tokens for the prompts ``batch["tokens"]``
    (B, P) plus the family's conditioning inputs (``enc_tokens``), on the
    device the parameters and batch live on. ``seed`` keys sampling. Runs
    without autograd, so parameters that require grad (a model in
    training) serve as they are."""
    _check_local_routing(cfg, gen)
    return _generate_sample(params, batch, seed, cfg, gen)
