"""Decoding engine (port of ``repro/serve/engine.py``): greedy, sampled and
beam-search generation over slot-addressed stepwise primitives.

The contract of the reference (DESIGN.md §7):
  * prefill writes cache positions [0, P) for a P-token prompt and returns
    the logits of position P-1, the distribution of the FIRST generated
    token; the first ``decode_step`` therefore runs at position P.
  * per-sequence EOS: once a row emits ``eos_id`` it produces only
    ``pad_id`` and stops counting toward ``lengths``; the loop ends when
    every row is done.

The primitives, shared by the one-shot loop and the schedulers
(``serve/scheduler.py``, ``serve/paged.py``):
  * ``init_slot_pool`` / ``slot_pool_like`` -- a persistent decode cache
    whose rows are request slots;
  * ``prefill_into_slots`` -- prefill a right-padded group of requests and
    scatter their caches into assigned slot rows, in place;
  * ``decode_pool_step`` -- one batched ``decode_step`` over every slot at
    per-slot positions;
  * ``_select_rows`` -- per-row token selection whose sampling stream is
    keyed by (seed, the row's request seed, its token index) alone, so a
    request's samples do not depend on its slot or on who shares the
    batch.

The reference's ``lax.while_loop`` is a Python loop here, one decode step
per iteration; the EOS exit test is the only host sync, and it is skipped
when EOS is off. Sampling draws the reference's Gumbel noise: the row keys
``fold_in(fold_in(PRNGKey(seed), row_seed), step)`` are JAX's threefry
keys, computed on the host (``core/gating_dropout.py``), and the noise is
threefry over (key, vocab index) in torch integer ops on the device, as
``jax.random.categorical`` draws it. Beam search (``beam_width > 1``)
tiles each prompt to W rows and re-gathers every cache leaf by parent
beam at each step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gating_dropout import fold_in, prng_key, threefry2x32
from repro_torch.models.model import decode_step, init_cache, prefill
from repro_torch.tree import tree_map

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """Decoding options.

    temperature <= 0 means greedy argmax; ``top_k`` restricts sampling to
    the k highest logits (0 = full vocab). ``beam_width > 1`` switches to
    deterministic beam search (sampling options are ignored), its best
    hypothesis chosen by score / length ** ``length_penalty``. ``eos_id <
    0`` disables EOS. ``local_routing`` reuses Gating Dropout's local
    routing path at decode time. ``flash_decode`` reads decode attention
    through the flash-decode kernels. ``max_seq`` overrides the cache
    length (0 = prompt_len + max_new).
    """
    max_new: int = 32
    temperature: float = 0.0
    top_k: int = 0
    beam_width: int = 1
    eos_id: int = 2
    pad_id: int = 0
    length_penalty: float = 1.0
    local_routing: bool = False
    flash_decode: bool = False
    max_seq: int = 0

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.beam_width < 1:
            raise ValueError("beam_width must be >= 1")


class GenerateResult(NamedTuple):
    tokens: torch.Tensor     # (B, max_new) int64; pad_id after EOS
    lengths: torch.Tensor    # (B,) generated tokens incl. the EOS itself
    scores: torch.Tensor     # (B,) f32 sum log p of emitted tokens (beam:
                             #  the best hypothesis' length-penalised score)
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


def _gather_cache(caches, axes, idx: torch.Tensor):
    """Every batched cache leaf reordered by ``idx`` along its batch axis
    (new tensors)."""
    return tree_map(lambda leaf, ax: leaf if ax < 0 else leaf.index_select(ax, idx),
                    caches, axes)


def _alloc_pool_like(fresh, axes, n_slots: int, device=None):
    """Zero slot pool whose leaves mirror a per-request cache tree with the
    batch axis resized to ``n_slots`` (unbatched leaves gain the slot axis
    after the repeats axis)."""
    def alloc(fr, ax):
        if ax >= 0:
            shape = fr.shape[:ax] + (n_slots,) + fr.shape[ax + 1:]
        else:
            shape = fr.shape[:1] + (n_slots,) + fr.shape[1:]
        return torch.zeros(shape, dtype=fr.dtype, device=device or fr.device)

    return tree_map(alloc, fresh, axes)


def init_slot_pool(cfg: ModelConfig, n_slots: int, max_seq: int, *, device,
                   dtype=None, n_cross: Optional[int] = None):
    """Persistent slot-addressed decode cache for ``n_slots`` requests:
    ``init_cache`` with every leaf carrying a slot axis. ``n_cross`` sizes
    the cross-attention K/V (default the config's ``encoder_seq``)."""
    shapes = init_cache(cfg, 1, max_seq, dtype, device="meta", n_cross=n_cross)
    return _alloc_pool_like(shapes, _cache_batch_axes(cfg), n_slots,
                            device=device)


def slot_pool_like(batch: Dict[str, Any], cfg: ModelConfig, *, max_seq: int,
                   n_slots: int):
    """Slot pool shaped like the caches ``prefill`` produces for ``batch``
    (the cross-K/V length follows its source, ``cross_len``; a
    decoder-only batch has no cross leaves), on the batch's device. Shapes
    come from the meta device: nothing is computed."""
    return init_slot_pool(cfg, n_slots, max_seq, device=batch["tokens"].device,
                          n_cross=cross_len(batch))


def cross_len(batch: Dict[str, Any]) -> Optional[int]:
    """The source length of ``batch``'s cross-attention K/V (source
    tokens, audio frames or image embeddings), or None where the family
    has no source."""
    for k in ("enc_tokens", "frames", "img_embeds"):
        if k in batch:
            return batch[k].shape[1]
    return None


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


def prefill_into_slots(params, batch: Dict[str, Any], lengths: torch.Tensor,
                       slots: torch.Tensor, pool, cfg: ModelConfig, *,
                       max_seq: int):
    """Prefill a group of new requests into assigned pool slots, in place.

    ``batch["tokens"]`` is (n, bucket) right-padded; ``lengths`` (n,) are
    the true prompt lengths. Causal masking keeps each row's real positions
    independent of its padding, and later decode writes overwrite the pad
    cache rows as they become visible. Returns (logits (n, V) at each
    row's last real token, pool)."""
    logits, fresh = prefill(params, batch, cfg, max_seq=max_seq,
                            last_index=lengths - 1)
    pool = _scatter_slots(pool, fresh, _cache_batch_axes(cfg), slots)
    return logits[:, 0], pool


def decode_pool_step(params, pool, tok: torch.Tensor, pos: torch.Tensor,
                     alive: torch.Tensor, cfg: ModelConfig, *,
                     local_routing: bool = False, flash_decode: bool = False,
                     ctx=None):
    """One batched ``decode_step`` over all pool slots at per-slot
    positions; dead slots step too but take no expert capacity. Returns
    (logits (S, V), pool)."""
    lg, pool = decode_step(params, pool, tok[:, None], pos, cfg,
                           local_routing=local_routing, token_valid=alive,
                           flash_decode=flash_decode, ctx=ctx)
    return lg[:, 0], pool


def _all_done(done: torch.Tensor, ctx) -> bool:
    """The loop's exit test: every row done, over the whole group under
    a (data, model) ``ctx`` (a rank that left the loop alone would leave
    the others waiting in their next collective)."""
    if ctx is None or ctx.world == 1:
        return bool(done.all())
    left = ctx.all_reduce((~done).sum().reshape(1))
    return int(left[0]) == 0


# ---------------------------------------------------------------------------
# token selection
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory with a
    non-blocking copy on a card, so the host does not wait for the
    device's queue."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def to_device_packed(arrays: Dict[str, np.ndarray],
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """Integer (or bool) host arrays on ``device`` through ONE copy
    (``to_device`` of their concatenation): int64 views of the one device
    buffer, each in its own shape. Any other array is refused: its cast
    to int64 would truncate it."""
    bad = {k: np.asarray(a).dtype.name for k, a in arrays.items()
           if np.asarray(a).dtype.kind not in "biu"}
    if bad:
        raise TypeError(f"to_device_packed packs integer arrays only: {bad}")
    flat = np.concatenate([np.asarray(a, np.int64).reshape(-1)
                           for a in arrays.values()])
    buf = to_device(flat, device)
    out, at = {}, 0
    for name, a in arrays.items():
        n = int(np.prod(np.shape(a), dtype=np.int64))
        out[name] = buf[at:at + n].view(np.shape(a))
        at += n
    return out


def to_device_batch(arrays: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays on ``device``: the integer ones through one packed copy
    (``to_device_packed``), each float one (a conditioning input such as
    ``frames`` or ``img_embeds``) through ``to_device`` in its own dtype."""
    floats = {k for k, a in arrays.items() if np.asarray(a).dtype.kind == "f"}
    out = to_device_packed({k: a for k, a in arrays.items() if k not in floats},
                           device)
    out.update({k: to_device(np.asarray(arrays[k]), device) for k in floats})
    return out


def row_keys(seed: int, row_seeds, steps) -> np.ndarray:
    """(N, 2) uint32 threefry keys ``fold_in(fold_in(PRNGKey(seed),
    row_seeds[r]), steps[r])``: row r's key depends on its own seeds
    only."""
    k = fold_in(prng_key(seed), np.asarray(row_seeds, np.int64).astype(np.uint32))
    steps = np.asarray(steps, np.int64).astype(np.uint32)
    y0, y1 = threefry2x32(k[:, 0], k[:, 1], np.zeros_like(steps), steps)
    return np.stack([y0, y1], axis=-1)


def _threefry_torch(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 words:
    ``core/gating_dropout.threefry2x32`` in torch integer ops."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """(N, vocab) f32 Gumbel noise of ``jax.random.gumbel(key, (vocab,))``
    for each row's key (partitionable threefry: the bits of element v are
    the XOR of threefry(key, (0, v))). keys: (N, 2) int64 uint32 words."""
    v = torch.arange(vocab, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = _threefry_torch(keys[:, :1], keys[:, 1:], torch.zeros_like(v), v)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * (1.0 - _TINY) + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def _select_rows(gen: GenerateConfig, logits: torch.Tensor, seed: int,
                 row_seeds, steps):
    """(N, V) f32 logits -> (token (N,), log p of token (N,)).

    Sampling takes row r's noise from the stream of ``(seed, row_seeds[r],
    steps[r])`` (host arrays of N ints), independent of r, of N and of the
    other rows: a request's samples are the same in any slot of any
    batch."""
    logp = torch.log_softmax(logits, dim=-1)
    if gen.temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
    else:
        scaled = logits / gen.temperature
        if gen.top_k > 0:
            kth = torch.topk(scaled, gen.top_k, dim=-1).values[..., -1:]
            scaled = scaled.masked_fill(scaled < kth, NEG)
        keys = to_device(row_keys(seed, row_seeds, steps).astype(np.int64),
                         logits.device)
        tok = torch.argmax(gumbel_noise(keys, scaled.shape[-1]) + scaled, dim=-1)
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
            f"pinned cache length max_seq={max_seq}")


def _generate_sample(params, batch, seed: int, cfg: ModelConfig,
                     gen: GenerateConfig, ctx=None) -> GenerateResult:
    b, prompt_len = batch["tokens"].shape
    dev = batch["tokens"].device
    max_seq = gen.max_seq or (prompt_len + gen.max_new)
    _check_cache_budget(max_seq, prompt_len, gen.max_new)
    row_seeds = np.arange(b)
    lengths = torch.full((b,), prompt_len, dtype=torch.long, device=dev)
    logits, fresh = prefill(params, batch, cfg, max_seq=max_seq,
                            last_index=lengths - 1, ctx=ctx)
    axes = _cache_batch_axes(cfg)
    pool = _scatter_slots(_alloc_pool_like(fresh, axes, b), fresh, axes,
                          torch.arange(b, device=dev))
    del fresh
    cur, score = _select_rows(gen, logits[:, 0].float(), seed, row_seeds,
                              np.zeros(b))
    done = (cur == gen.eos_id) if gen.eos_id >= 0 else torch.zeros(
        b, dtype=torch.bool, device=dev)
    buf = torch.full((b, gen.max_new), gen.pad_id, dtype=torch.long, device=dev)
    buf[:, 0] = cur
    pos = lengths.clone()                     # token 0 lives at position P
    length = torch.ones(b, dtype=torch.long, device=dev)
    i = 1
    while i < gen.max_new:
        if gen.eos_id >= 0 and _all_done(done, ctx):
            break
        lg, pool = decode_pool_step(params, pool, cur, pos, ~done, cfg,
                                    local_routing=gen.local_routing,
                                    flash_decode=gen.flash_decode, ctx=ctx)
        nxt, lp = _select_rows(gen, lg.float(), seed, row_seeds, np.full(b, i))
        cur, done, length, score = _advance(gen, nxt, lp, done, length, score)
        buf[:, i] = cur
        pos = pos + 1
        i += 1
    return GenerateResult(tokens=buf, lengths=length, scores=score, steps=i - 1)


# ---------------------------------------------------------------------------
# beam search loop
# ---------------------------------------------------------------------------

def _generate_beam(params, batch, cfg: ModelConfig,
                   gen: GenerateConfig, ctx=None) -> GenerateResult:
    """Deterministic beam search: each prompt tiled to W rows, prefilled at
    B*W; at each step the W*V continuations of a prompt's beams compete in
    one top-W, and every cache leaf is re-gathered by parent beam. A
    finished beam proposes only ``pad_id`` at log p 0, so its score is
    carried unchanged."""
    w = gen.beam_width
    b, prompt_len = batch["tokens"].shape
    dev = batch["tokens"].device
    axes = _cache_batch_axes(cfg)
    max_seq = gen.max_seq or (prompt_len + gen.max_new)
    _check_cache_budget(max_seq, prompt_len, gen.max_new)
    tiled = {k: v.repeat_interleave(w, dim=0) for k, v in batch.items()}
    logits0, caches = prefill(params, tiled, cfg, max_seq=max_seq, ctx=ctx)
    logp0 = torch.log_softmax(logits0[:, 0].float(), dim=-1)
    vocab = logp0.shape[-1]
    # the W rows of a prompt are identical after prefill: the beams start
    # from the top-W distinct first tokens of row 0
    scores, tok = torch.topk(logp0.reshape(b, w, vocab)[:, 0], w, dim=-1)
    done = ((tok == gen.eos_id) if gen.eos_id >= 0
            else torch.zeros((b, w), dtype=torch.bool, device=dev))
    buf = torch.full((b, w, gen.max_new), gen.pad_id, dtype=torch.long,
                     device=dev)
    buf[:, :, 0] = tok
    length = torch.ones((b, w), dtype=torch.long, device=dev)
    frozen = torch.full((vocab,), NEG, dtype=torch.float32, device=dev)
    frozen[gen.pad_id] = 0.0
    base = (torch.arange(b, device=dev) * w)[:, None]
    i = 1
    while i < gen.max_new:
        if gen.eos_id >= 0 and _all_done(done, ctx):
            break
        lg, caches = decode_step(params, caches, tok.reshape(b * w, 1),
                                 prompt_len + i - 1, cfg,
                                 local_routing=gen.local_routing,
                                 flash_decode=gen.flash_decode, ctx=ctx)
        logp = torch.log_softmax(lg[:, 0].float(), dim=-1).reshape(b, w, vocab)
        logp = torch.where(done[..., None], frozen, logp)
        total = (scores[..., None] + logp).reshape(b, w * vocab)
        scores, flat = torch.topk(total, w, dim=-1)
        parent = flat // vocab
        tok = flat % vocab
        buf = buf.gather(1, parent[..., None].expand(-1, -1, gen.max_new))
        done = done.gather(1, parent)
        length = length.gather(1, parent)
        caches = _gather_cache(caches, axes, (base + parent).reshape(-1))
        length = length + (~done).long()
        if gen.eos_id >= 0:
            done = done | (tok == gen.eos_id)
        buf[:, :, i] = tok
        i += 1
    norm = scores / length.clamp_min(1).float() ** gen.length_penalty
    best = norm.argmax(dim=1)
    rows = torch.arange(b, device=dev)
    return GenerateResult(tokens=buf[rows, best], lengths=length[rows, best],
                          scores=norm[rows, best], steps=i - 1)


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
             seed: int = 0, ctx=None) -> GenerateResult:
    """Generate ``gen.max_new`` tokens for the prompts ``batch["tokens"]``
    (B, P) plus the family's conditioning inputs (``enc_tokens`` or
    ``frames`` of the encoder-decoder, ``img_embeds`` of the VLM; none for
    the decoder-only families), on the
    device the parameters and batch live on: beam search when
    ``gen.beam_width > 1``, else greedy or sampled. ``seed`` keys sampling
    (row b draws from the stream of (seed, b)). Runs without autograd, so
    parameters that require grad (a model in training) serve as they
    are. Under an expert-parallel ``ctx`` every rank generates for its own
    rows with its experts, and the EOS exit waits for the whole group."""
    _check_local_routing(cfg, gen)
    if gen.beam_width > 1:
        return _generate_beam(params, batch, cfg, gen, ctx)
    return _generate_sample(params, batch, seed, cfg, gen, ctx)
