"""Transformer assembly for the encoder-decoder MoE (port of
``repro/models/transformer.py``).

Layers are organised into SEGMENTS — contiguous repeats of a (possibly
multi-layer) pattern of LayerSpecs — whose parameters are stacked along a
leading repeats axis, as in the reference, so the parameter trees of the
two packages match leaf for leaf. The reference scans over the repeats;
here a Python loop applies each repeat's slice (a view, no copy).

Modes:
  train   -- full sequence, logits for every position, MoE aux losses.
             With ``cfg.remat`` and grad mode on, each layer is
             recomputed in the backward (``torch.utils.checkpoint``, the
             reference's per-layer ``jax.checkpoint``): the MoE forward,
             and so its kernel launches, run twice per training step.
  prefill -- full sequence + returns a decode cache.
  decode  -- one token against the cache (updated in place).

Router jitter in training draws from a generator of each layer's own,
seeded from the step's generator and the layer's index (the reference
folds the layer index into the step's key), so a recomputed layer draws
the same noise and routes the same tokens.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import _zero_aux, init_moe_params, moe_apply
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.tree import flatten_with_paths, tree_map, unflatten_paths

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerSpec:
    """One layer: GQA self-attention, optional cross-attention, then a
    dense FFN or an MoE layer (the reference's other mixers come with
    their families)."""
    cross: bool = False       # cross-attention sub-layer
    moe: bool = False
    causal: bool = True


@dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerSpec, ...]
    repeats: int


def _compress(specs: List[LayerSpec]) -> List[Segment]:
    """Compress a per-layer spec list into segments: whole-list periodic
    pattern if one exists (period <= 8), else maximal identical runs."""
    n = len(specs)
    for p in range(1, 9):
        if n % p == 0 and n // p > 1:
            if all(specs[i] == specs[i % p] for i in range(n)):
                return [Segment(tuple(specs[:p]), n // p)]
    segs: List[Segment] = []
    i = 0
    while i < n:
        j = i
        while j < n and specs[j] == specs[i]:
            j += 1
        segs.append(Segment((specs[i],), j - i))
        i = j
    return segs


def layer_plan(cfg: ModelConfig, *, encoder: bool = False) -> List[Segment]:
    if cfg.family != "encdec":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    moe_at = (lambda i: cfg.moe is not None and cfg.moe.is_moe_layer(i))
    if encoder:
        return _compress([LayerSpec(causal=cfg.encdec.encoder_causal,
                                    moe=moe_at(i))
                          for i in range(cfg.encdec.n_encoder_layers)])
    return _compress([LayerSpec(cross=True, moe=moe_at(i))
                      for i in range(cfg.n_layers)])


# ---------------------------------------------------------------------------
# per-layer init (stacked over the segment's repeats)
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig,
                dtype, n_total: int, reps: int) -> Params:
    lead = (reps,)
    out_scale = (2 * max(n_total, 1)) ** -0.5
    p: Params = {"ln1": L.init_norm(gen, cfg, cfg.d_model, dtype, lead),
                 "attn": A.init_attn(gen, cfg, dtype, out_scale, lead)}
    if spec.cross:
        p["ln_cross"] = L.init_norm(gen, cfg, cfg.d_model, dtype, lead)
        p["cross"] = A.init_cross_attn(gen, cfg, dtype, out_scale, lead)
    p["ln2"] = L.init_norm(gen, cfg, cfg.d_model, dtype, lead)
    if spec.moe:
        p["moe"] = init_moe_params(gen, cfg, dtype=dtype, lead=lead)
        if cfg.moe.n_shared_experts > 0:
            dffs = cfg.moe.d_ff(cfg.d_ff) * cfg.moe.n_shared_experts
            p["shared"] = L.init_ffn(gen, cfg.d_model, dffs, cfg, dtype,
                                     out_scale, lead)
    elif cfg.d_ff > 0:
        p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg, dtype,
                              out_scale, lead)
    return p


def init_stack(gen: torch.Generator, segs: List[Segment], cfg: ModelConfig,
               dtype, n_total: int) -> List[Params]:
    return [{f"p{pi}": _init_layer(gen, spec, cfg, dtype, n_total, seg.repeats)
             for pi, spec in enumerate(seg.pattern)} for seg in segs]


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def _init_layer_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      max_seq: int, n_cross: int, dtype, device,
                      reps: int) -> Params:
    c: Params = {"attn": A.init_kv_cache(cfg, batch, max_seq, dtype, device,
                                         lead=(reps,))}
    if spec.cross:
        shape = (reps, batch, n_cross, cfg.n_heads, cfg.head_dim_)
        c["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
    return c


def init_stack_cache(segs: List[Segment], cfg: ModelConfig, batch: int,
                     max_seq: int, n_cross: int, dtype,
                     device=None) -> List[Params]:
    return [{f"p{pi}": _init_layer_cache(spec, cfg, batch, max_seq, n_cross,
                                         dtype, device, seg.repeats)
             for pi, spec in enumerate(seg.pattern)} for seg in segs]


def _fill_kv_cache(k: torch.Tensor, v: torch.Tensor, smax: int,
                   dtype) -> Params:
    """Prefill K/V (B, l, KV, hd) zero-padded to the cache length."""
    b, l = k.shape[:2]
    ck = k.new_zeros((b, smax) + k.shape[2:], dtype=dtype)
    cv = v.new_zeros((b, smax) + v.shape[2:], dtype=dtype)
    ck[:, :l] = k
    cv[:, :l] = v
    return {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# per-layer apply
# ---------------------------------------------------------------------------

def _moe_or_ffn(p: Params, spec: LayerSpec, h: torch.Tensor, cfg: ModelConfig,
                generator, decision, is_training, token_ids, token_valid=None,
                ctx=None):
    if spec.moe:
        y, aux = moe_apply(p["moe"], h, cfg, ctx=ctx, generator=generator,
                           decision=decision, is_training=is_training,
                           token_ids=token_ids, token_valid=token_valid)
        if "shared" in p:
            y = y + L.ffn_apply(p["shared"], h, cfg)
        return y, aux
    zero = _zero_aux(cfg.moe.n_experts if cfg.moe is not None else 1, h.device)
    if "ffn" in p:
        return L.ffn_apply(p["ffn"], h, cfg), zero
    return torch.zeros_like(h), zero


def _layer_apply(spec: LayerSpec, p: Params, x: torch.Tensor,
                 cfg: ModelConfig, *, mode: str, cache: Optional[Params],
                 index, generator, decision, is_training: bool,
                 cross_src: Optional[torch.Tensor], token_ids,
                 token_valid=None, flash_decode: bool = False,
                 block_tables=None, max_seq: int = 0, cache_dtype=None,
                 ctx=None) -> Tuple[torch.Tensor, Optional[Params], Dict]:
    """One transformer layer. Returns (x, new_cache, aux). ``block_tables``
    (decode only) addresses the self-attention cache as a page arena; the
    cross-attention K/V stay slot-addressed. ``ctx`` is the
    expert-parallel context of the MoE layers."""
    new_cache: Params = {}
    l = x.shape[1]
    # ---- self-attention ----
    h = L.norm_apply(p["ln1"], x, cfg)
    if mode == "decode":
        o, new_cache["attn"] = A.decode_self_attention(
            p["attn"], h, cache["attn"], cfg, index, flash=flash_decode,
            block_tables=block_tables)
    else:
        q, k, v = A.attn_qkv(p["attn"], h)
        pos = torch.arange(l, device=x.device)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        o = A.attn_out(p["attn"], A.full_attention(q, k, v, causal=spec.causal),
                       x.dtype)
        if mode == "prefill":
            new_cache["attn"] = _fill_kv_cache(k, v, max_seq, cache_dtype)
    x = x + o
    # ---- cross attention ----
    if spec.cross:
        h = L.norm_apply(p["ln_cross"], x, cfg)
        if mode == "decode" or cross_src is None:
            ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        else:
            ck, cv = A.make_cross_kv(p["cross"], cross_src)
            if mode == "prefill":
                new_cache["cross"] = {"k": ck.to(cache_dtype),
                                      "v": cv.to(cache_dtype)}
        x = x + A.cross_attention_kv(p["cross"], h, ck, cv)
        if mode == "decode":
            new_cache["cross"] = cache["cross"]
    # ---- FFN / MoE ----
    h = L.norm_apply(p["ln2"], x, cfg)
    y, aux = _moe_or_ffn(p, spec, h, cfg, generator, decision, is_training,
                         token_ids, token_valid, ctx)
    x = x + y
    return x, (new_cache if mode in ("prefill", "decode") else None), aux


# ---------------------------------------------------------------------------
# stack apply
# ---------------------------------------------------------------------------

def _add_aux(a, b):
    return b if a is None else tree_map(torch.add, a, b)


def _layer_generator(generator: Optional[torch.Generator],
                     layer: int) -> Optional[torch.Generator]:
    """The layer's own generator, seeded from the step generator's seed and
    the layer index."""
    if generator is None:
        return None
    seed = (generator.initial_seed() * 1_000_003 + layer) % (1 << 63)
    return torch.Generator(device=generator.device).manual_seed(seed)


def _run_layer(spec: LayerSpec, p: Params, x: torch.Tensor, *, layer: int,
               generator, is_training: bool, **kw):
    """``_layer_apply`` with the layer's generator made inside the call, so
    that a remat recomputation draws the same router jitter as the
    forward did."""
    gen = _layer_generator(generator, layer) if is_training else generator
    return _layer_apply(spec, p, x, generator=gen, is_training=is_training,
                        **kw)


def _unbind_repeats(seg_p: Params) -> List[Params]:
    """A segment's stacked parameters as one tree of views per repeat.
    ``unbind`` rather than indexing: its backward stacks the repeats'
    gradients into ONE buffer, where each index's backward would allocate
    a zero buffer of the whole stack (3.2 GB per expert weight of the
    zcode-m3-base encoder)."""
    flat = {k: v.unbind(0) for k, v in flatten_with_paths(seg_p).items()}
    n = len(next(iter(flat.values())))
    return [unflatten_paths({k: v[r] for k, v in flat.items()})
            for r in range(n)]


def apply_stack(params: List[Params], segs: List[Segment], x: torch.Tensor,
                cfg: ModelConfig, *, mode: str,
                caches: Optional[List[Params]] = None, index=None,
                generator=None, decision=None, is_training=True,
                cross_src=None, token_ids=None, token_valid=None,
                flash_decode=False, block_tables=None, max_seq: int = 0,
                cache_dtype=None, ctx=None):
    """Run all segments. Returns (x, caches, aux_sum).

    prefill builds new caches (stacked over each segment's repeats);
    decode updates ``caches`` in place and returns them, reading the
    self-attention caches through ``block_tables`` when given (paged
    decode)."""
    new_caches: List[Params] = []
    aux_total = None
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    layer = 0
    for si, (seg, seg_p) in enumerate(zip(segs, params)):
        per_rep = []
        rep_params = _unbind_repeats(seg_p)
        for r in range(seg.repeats):
            for pi, spec in enumerate(seg.pattern):
                lp = rep_params[r][f"p{pi}"]
                lc = (None if mode != "decode"
                      else tree_map(lambda a: a[r], caches[si][f"p{pi}"]))
                fn = functools.partial(
                    _run_layer, spec, layer=layer, cfg=cfg, mode=mode,
                    cache=lc, index=index, generator=generator,
                    decision=decision, is_training=is_training,
                    cross_src=cross_src, token_ids=token_ids,
                    token_valid=token_valid, flash_decode=flash_decode,
                    block_tables=block_tables, max_seq=max_seq,
                    cache_dtype=cache_dtype, ctx=ctx)
                layer += 1
                if remat:
                    x, nc, aux = checkpoint(fn, lp, x, use_reentrant=False,
                                            preserve_rng_state=False)
                else:
                    x, nc, aux = fn(lp, x)
                if mode == "prefill":
                    per_rep.append((pi, nc))
                aux_total = _add_aux(aux_total, aux)
        if mode == "prefill":
            new_caches.append({
                f"p{pi}": tree_map(lambda *a: torch.stack(a),
                                   *[nc for q, nc in per_rep if q == pi])
                for pi in range(len(seg.pattern))})
    if mode == "decode":
        return x, caches, aux_total
    return x, (new_caches if mode == "prefill" else None), aux_total
