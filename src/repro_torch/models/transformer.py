"""Transformer assembly for the encoder-decoder MoE, the decoder-only
families with full or sliding-window attention or multi-head latent
attention, the Mamba-2 SSM and the Hymba hybrid (port of
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

Prefill and training attention is ``attention.flash_attention`` (blocked
past 2,048 keys), or, under ``cfg.banded_swa``, the banded flash
attention of a causal windowed layer longer than twice its window (the
reference's branch at ``scan_layers=True``, its default; the port has no
``scan_layers``). A windowed layer's decode cache is a ring buffer of
``window`` slots. An MLA layer (``mixer="mla"``, every layer of a config
with ``cfg.mla``) attends through ``models/mla.py`` and caches its
compressed latents, padded to ``max_seq`` at prefill. An SSM layer
(``mixer="ssm"``) mixes through ``models/ssm.py`` and caches its conv
window and state; a hybrid layer (``mixer="hybrid"``) runs attention and
the SSM side by side on the same input, each output RMS-scaled by its own
gain, and adds their mean (Hymba). Its attention is windowed except at
``cfg.hybrid.global_attn_layers``, so its cache is a ring or a full K/V
cache beside the SSM's. A VLM's gated cross layer (``mixer="none"``,
``gated_cross``; every ``cfg.vlm.cross_attn_period``-th layer from layer
0) has no self-attention: it cross-attends onto the projected image
embeddings and runs its FFN, each output scaled by the tanh of its own
scalar gate (zero at init), and caches the cross K/V alone.

Router jitter in training draws from a generator of each layer's own,
seeded from the step's generator and the layer's index (the reference
folds the layer index into the step's key), so a recomputed layer draws
the same noise and routes the same tokens.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import _zero_aux, init_moe_params, moe_apply
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as M
from repro_torch.models import ssm as S
from repro_torch.models.flash import banded_flash_attention
from repro_torch.tree import flatten_with_paths, tree_map, unflatten_paths

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerSpec:
    """One layer: a mixer (GQA or MLA self-attention, an SSM, both
    attention and SSM, the hybrid, or none), optional cross-attention,
    then a dense FFN or an MoE layer. ``gated_cross`` is the VLM's
    cross-only layer: no mixer, its cross-attention and FFN outputs
    tanh-gated."""
    mixer: str = "gqa"        # gqa | mla | ssm | hybrid | none (cross-only)
    cross: bool = False       # cross-attention sub-layer
    gated_cross: bool = False # VLM: tanh-gated cross-attn layer (no self-attn)
    moe: bool = False
    window: int = 0           # sliding window (0 = full)
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
    """The reference's plan for the ported families: the encoder-decoder
    (its encoder, or a decoder with cross-attention), ``dense`` / ``moe``
    (GQA self-attention with RoPE over ``cfg.sliding_window``, or MLA
    where ``cfg.mla`` is set; no cross-attention), ``ssm`` (an SSM mixer)
    and ``hybrid`` (attention and SSM, the attention global at
    ``cfg.hybrid.global_attn_layers`` and over ``cfg.sliding_window``
    elsewhere) and ``vlm`` (the decoder-only plan with a gated cross-only
    layer wherever ``i % cfg.vlm.cross_attn_period == 0``); an MoE layer
    where ``MoEConfig.is_moe_layer``."""
    if cfg.family not in ("encdec", "dense", "moe", "ssm", "hybrid", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    moe_at = (lambda i: cfg.moe is not None and cfg.moe.is_moe_layer(i))
    if encoder:
        return _compress([LayerSpec(causal=cfg.encdec.encoder_causal,
                                    moe=moe_at(i))
                          for i in range(cfg.encdec.n_encoder_layers)])
    if cfg.family == "encdec":
        return _compress([LayerSpec(cross=True, moe=moe_at(i))
                          for i in range(cfg.n_layers)])
    if cfg.family == "ssm":
        return _compress([LayerSpec(mixer="ssm", moe=moe_at(i))
                          for i in range(cfg.n_layers)])
    if cfg.family == "hybrid":
        return _compress([LayerSpec(
            mixer="hybrid", moe=moe_at(i),
            window=0 if i in cfg.hybrid.global_attn_layers else cfg.sliding_window)
            for i in range(cfg.n_layers)])
    mixer = "mla" if cfg.mla is not None else "gqa"
    gated = (lambda i: cfg.family == "vlm"
             and i % cfg.vlm.cross_attn_period == 0)
    return _compress([LayerSpec(mixer="none", cross=True, gated_cross=True)
                      if gated(i) else
                      LayerSpec(mixer=mixer, moe=moe_at(i),
                                window=cfg.sliding_window)
                      for i in range(cfg.n_layers)])


# ---------------------------------------------------------------------------
# per-layer init (stacked over the segment's repeats)
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig,
                dtype, n_total: int, reps: Optional[int]) -> Params:
    """One layer's parameters, stacked over ``reps`` repeats (``None``:
    unstacked, as the MTP head's block)."""
    lead = () if reps is None else (reps,)
    out_scale = (2 * max(n_total, 1)) ** -0.5
    p: Params = {}
    if spec.mixer != "none":
        p["ln1"] = L.init_norm(gen, cfg, cfg.d_model, dtype, lead)
    if spec.mixer == "mla":
        p["attn"] = M.init_mla(gen, cfg, dtype, out_scale, lead)
    elif spec.mixer in ("gqa", "hybrid"):
        p["attn"] = A.init_attn(gen, cfg, dtype, out_scale, lead)
    if spec.mixer in ("ssm", "hybrid"):
        p["ssm"] = S.init_ssm(gen, cfg, dtype, out_scale, lead)
    if spec.mixer == "hybrid":
        ones = torch.ones(lead + (cfg.d_model,), dtype=dtype, device=gen.device)
        p["mix_norm_attn"], p["mix_norm_ssm"] = ones, ones.clone()
    if spec.cross:
        p["ln_cross"] = L.init_norm(gen, cfg, cfg.d_model, dtype, lead)
        p["cross"] = A.init_cross_attn(gen, cfg, dtype, out_scale, lead)
        if spec.gated_cross:
            p["gate_attn"] = torch.zeros(lead, dtype=dtype, device=gen.device)
            p["gate_ffn"] = torch.zeros(lead, dtype=dtype, device=gen.device)
    p["ln2"] = L.init_norm(gen, cfg, cfg.d_model, dtype, lead)
    if spec.moe:
        p["moe"] = init_moe_params(gen, cfg, dtype=dtype, lead=lead)
        if cfg.moe.n_shared_experts > 0:
            dffs = cfg.moe.d_ff(cfg.d_ff) * cfg.moe.n_shared_experts
            p["shared"] = L.init_ffn(gen, cfg.d_model, dffs, cfg, dtype,
                                     out_scale, lead)
    elif cfg.d_ff > 0 or spec.gated_cross:
        dff = cfg.d_ff if cfg.d_ff > 0 else 4 * cfg.d_model
        p["ffn"] = L.init_ffn(gen, cfg.d_model, dff, cfg, dtype, out_scale,
                              lead)
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
    c: Params = {}
    if spec.mixer == "mla":
        c["attn"] = M.init_mla_cache(cfg, batch, max_seq, dtype, device,
                                     lead=(reps,))
    elif spec.mixer in ("gqa", "hybrid"):
        if spec.window > 0:
            c["attn"] = A.init_ring_cache(cfg, batch, spec.window, dtype,
                                          device, lead=(reps,))
        else:
            c["attn"] = A.init_kv_cache(cfg, batch, max_seq, dtype, device,
                                        lead=(reps,))
    if spec.mixer in ("ssm", "hybrid"):
        c["ssm"] = S.init_ssm_cache(cfg, batch, dtype, device, lead=(reps,))
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


def _pad_seq(x: torch.Tensor, smax: int, dtype) -> torch.Tensor:
    """(B, l, ...) zero-padded along the sequence to ``smax``, in ``dtype``."""
    out = x.new_zeros((x.shape[0], smax) + tuple(x.shape[2:]), dtype=dtype)
    out[:, :x.shape[1]] = x
    return out


def _fill_kv_cache(spec: LayerSpec, k: torch.Tensor, v: torch.Tensor,
                   smax: int, dtype) -> Params:
    """Prefill K/V (B, l, KV, hd) zero-padded to the cache length, or, for
    a windowed layer, its ring: the last ``min(l, window)`` rows, each at
    slot ``pos % window`` with its position in ``pos`` (-1 in the slots
    left empty)."""
    b, l = k.shape[:2]
    if spec.window > 0:
        w = spec.window
        ck = k.new_zeros((b, w) + k.shape[2:], dtype=dtype)
        cv = v.new_zeros((b, w) + v.shape[2:], dtype=dtype)
        cpos = torch.full((w,), -1, dtype=torch.int32, device=k.device)
        start = max(l - w, 0)
        pos = torch.arange(start, l, device=k.device)
        slots = pos % w
        ck[:, slots] = k[:, start:].to(dtype)
        cv[:, slots] = v[:, start:].to(dtype)
        cpos[slots] = pos.to(torch.int32)
        return {"k": ck, "v": cv, "pos": cpos}
    return {"k": _pad_seq(k, smax, dtype), "v": _pad_seq(v, smax, dtype)}


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


def _self_attention(spec: LayerSpec, p: Params, h: torch.Tensor,
                    cfg: ModelConfig, *, mode: str, cache: Optional[Params],
                    index, flash_decode: bool, block_tables, max_seq: int,
                    cache_dtype) -> Tuple[torch.Tensor, Optional[Params]]:
    """A layer's self-attention on its normed input ``h``: (output, its
    new cache at prefill and decode, else None)."""
    if spec.mixer == "mla":
        if mode == "decode":
            return M.mla_decode(p, h, cache, cfg, index, block_tables=block_tables)
        o, (c_kv, k_rope) = M.mla_attention(p, h, cfg, return_cache=True)
        if mode != "prefill":
            return o, None
        return o, {"c_kv": _pad_seq(c_kv, max_seq, cache_dtype),
                   "k_rope": _pad_seq(k_rope, max_seq, cache_dtype)}
    if mode == "decode":
        # windowed layers keep their slot-addressed ring cache; only
        # full-cache layers read through the page table
        return A.decode_self_attention(
            p, h, cache, cfg, index, window=spec.window, flash=flash_decode,
            block_tables=None if spec.window > 0 else block_tables)
    l = h.shape[1]
    q, k, v = A.attn_qkv(p, h)
    pos = torch.arange(l, device=h.device)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    if (cfg.banded_swa and spec.window > 0 and spec.causal
            and l > 2 * spec.window):
        qc = 1024 if l % 1024 == 0 or l > 4096 else 512
        o = banded_flash_attention(q, k, v, spec.window, q_chunk=qc,
                                   kv_chunk=512)
    else:
        o = A.flash_attention(q, k, v, causal=spec.causal, window=spec.window)
    o = A.attn_out(p, o, h.dtype)
    if mode != "prefill":
        return o, None
    return o, _fill_kv_cache(spec, k, v, max_seq, cache_dtype)


def _rms_scale(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalise ``x`` in f32 and scale it (a hybrid branch's output
    gain)."""
    xf = x.float()
    return (xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps)
            * scale.float()).to(x.dtype)


def _fill_ssm_cache(prm: Params, h: torch.Tensor, cfg: ModelConfig) -> Params:
    """The reference's prefill state of an SSM layer, recomputed from its
    normed input ``h``: the conv window and the final state. Prefill takes
    the same cache from ``ssm_apply(..., return_state=True)`` instead,
    bitwise this one (``tests/test_torch_ssm.py``)."""
    xc, xbc = S._projections(prm, h)
    xs, bs, cs, dt, a = S._scan_inputs(prm, xc, xbc, cfg)
    _, hfin = S.ssd_chunked(xs, dt, a, bs, cs, cfg.ssm.chunk)
    return {"conv": S.conv_tail(xbc, cfg.ssm.conv_kernel), "h": hfin}


def _tanh_gate(gate: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """A gated cross layer's output scaled by the tanh of its scalar gate,
    taken in f32 and cast to the output's dtype, as the reference does."""
    return torch.tanh(gate.float()).to(o.dtype) * o


def _mixer(spec: LayerSpec, p: Params, x: torch.Tensor, cfg: ModelConfig,
           new_cache: Params, *, mode: str, cache: Optional[Params], index,
           flash_decode: bool, block_tables, max_seq: int,
           cache_dtype) -> torch.Tensor:
    """A layer's mixer sub-layer (self-attention, an SSM, or both) on the
    residual ``x``; its prefill or decode cache goes into ``new_cache``."""
    h = L.norm_apply(p["ln1"], x, cfg)
    outs = []
    if spec.mixer != "ssm":
        o, attn_cache = _self_attention(
            spec, p["attn"], h, cfg, mode=mode,
            cache=None if cache is None else cache["attn"], index=index,
            flash_decode=flash_decode, block_tables=block_tables,
            max_seq=max_seq, cache_dtype=cache_dtype)
        if attn_cache is not None:
            new_cache["attn"] = attn_cache
        outs.append(o)
    if spec.mixer in ("ssm", "hybrid"):
        if mode == "decode":
            o, new_cache["ssm"] = S.ssm_decode(p["ssm"], h, cache["ssm"], cfg)
        elif mode == "prefill":
            o, new_cache["ssm"] = S.ssm_apply(p["ssm"], h, cfg, return_state=True)
        else:
            o = S.ssm_apply(p["ssm"], h, cfg)
        outs.append(o)
    if spec.mixer == "hybrid":
        return x + 0.5 * (_rms_scale(outs[0], p["mix_norm_attn"])
                          + _rms_scale(outs[1], p["mix_norm_ssm"]))
    return x + outs[0]


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
    # ---- mixer: self-attention, an SSM, both (hybrid), or none ----
    if spec.mixer != "none":
        x = _mixer(spec, p, x, cfg, new_cache, mode=mode, cache=cache,
                   index=index, flash_decode=flash_decode,
                   block_tables=block_tables, max_seq=max_seq,
                   cache_dtype=cache_dtype)
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
        o = A.cross_attention_kv(p["cross"], h, ck, cv)
        if spec.gated_cross:
            o = _tanh_gate(p["gate_attn"], o)
        x = x + o
        if mode == "decode":
            new_cache["cross"] = cache["cross"]
    # ---- FFN / MoE ----
    h = L.norm_apply(p["ln2"], x, cfg)
    y, aux = _moe_or_ffn(p, spec, h, cfg, generator, decision, is_training,
                         token_ids, token_valid, ctx)
    if spec.gated_cross:
        y = _tanh_gate(p["gate_ffn"], y)
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


_LAYER_INPUT_OBSERVERS: List[Callable[[torch.Tensor], None]] = []


@contextlib.contextmanager
def observe_layer_inputs(fn: Callable[[torch.Tensor], None]) -> Iterator[None]:
    """Within: ``fn`` sees each layer's input of a training forward (mode
    "train"), the layer-boundary activation that remat keeps for the
    backward, so that a saved-tensor count can tell those apart from the
    other saved activations. With no observer the loop is empty."""
    _LAYER_INPUT_OBSERVERS.append(fn)
    try:
        yield
    finally:
        _LAYER_INPUT_OBSERVERS.remove(fn)


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
                if mode == "train":
                    for observe in _LAYER_INPUT_OBSERVERS:
                        observe(x)
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
