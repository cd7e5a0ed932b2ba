"""Top-level model: embeddings + (the encoder-decoder's encoder, or the
VLM's image projection) + decoder stack + head, and DeepSeek-V3's
multi-token-prediction (MTP) head (port of ``repro/models/model.py``:
every family of the reference).

Public API:
  init_model(gen, cfg)                          -> params
  init_model_meta(cfg)                          -> params on "meta"
  model_apply(params, batch, cfg, ...)          -> (logits, aux)    [eval/train]
  head_matrix(params, cfg)                      -> (d, vocab) output head
  prefill(params, batch, cfg, max_seq)          -> (logits, caches)
  decode_step(params, caches, token, index,...) -> (logits, caches)
  init_cache(cfg, batch, max_seq, dtype)        -> caches

``batch`` keys: "tokens" (B, L) always; plus per family:
  vlm    : "img_embeds" (B, n_img, d_image)  [stub vision encoder output]
  encdec : "frames" (B, S_enc, d_model) for audio (stub conv frontend), or
           "enc_tokens" (B, S_enc) for text (the paper's MT models);
nothing else for the decoder-only families. The encoder takes ``frames``
where the batch has them, whatever ``cfg.encdec.frontend`` says, as the
reference does. Float inputs are cast to the activation dtype first.
Parameters live on the device of the generator that drew them.

Prefill and training attention is quadratic up to 2,048 keys and the
blocked flash attention of ``models/flash.py`` past them (O(L) memory), as
in the reference. A sliding-window layer's cache is a ring of ``window``
slots whatever ``max_seq`` is; an MLA layer's cache is its compressed
latents (``models/mla.py``); an SSM layer's is its conv window and state,
of one size at any length (``models/ssm.py``).

The hybrid (``cfg.hybrid``) prepends ``n_meta_tokens`` learned rows
(``params["meta"]``) to every sequence and cuts them off after the stack:
the stack sees positions ``[0, n_meta + L)``, the caches hold ``max_seq +
n_meta`` of them, and ``decode_step``'s ``index`` (a token's position in
its prompt and continuation) becomes ``index + n_meta`` inside, so block
tables and the flash-decode kernels' index are meta-inclusive.

With ``cfg.mtp``, training forwards (``is_training=True``) also return
``aux["mtp_hidden"]``: the MTP head's hidden states, from which the loss
predicts the token two ahead (``training/steps.py``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_model(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Parameters drawn from ``gen`` on ``gen.device``, with the
    reference's distributions (its bits differ: JAX keys are not torch
    generators)."""
    dtype = cfg.torch_param_dtype
    n_total = cfg.n_layers + (cfg.encdec.n_encoder_layers if cfg.encdec else 0)
    p: Params = {
        "embed": L.init_embed(gen, cfg.vocab, cfg.d_model, dtype),
        "decoder": T.init_stack(gen, T.layer_plan(cfg), cfg, dtype, n_total),
        "final_norm": L.init_norm(gen, cfg, cfg.d_model, dtype),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.normal(gen, (cfg.d_model, cfg.vocab),
                                cfg.d_model ** -0.5, dtype)
    if cfg.encdec is not None:
        p["encoder"] = T.init_stack(gen, T.layer_plan(cfg, encoder=True), cfg,
                                    dtype, n_total)
        p["enc_final_norm"] = L.init_norm(gen, cfg, cfg.d_model, dtype)
    if cfg.vlm is not None:
        p["img_proj"] = L.normal(gen, (cfg.vlm.d_image, cfg.d_model),
                                 cfg.vlm.d_image ** -0.5, dtype)
    if cfg.hybrid is not None:
        p["meta"] = L.normal(gen, (cfg.n_meta, cfg.d_model), 0.02, dtype)
    if cfg.mtp:
        d = cfg.d_model
        p["mtp"] = {
            "proj": L.normal(gen, (2 * d, d), (2 * d) ** -0.5, dtype),
            "norm_h": L.init_norm(gen, cfg, d, dtype),
            "norm_e": L.init_norm(gen, cfg, d, dtype),
            "block": T._init_layer(gen, _mtp_spec(cfg), cfg, dtype, n_total,
                                   None),
            "norm_out": L.init_norm(gen, cfg, d, dtype),
        }
    return p


def init_model_meta(cfg: ModelConfig) -> Params:
    """``init_model``'s tree on the meta device: the same keys, shapes and
    dtypes, nothing drawn and nothing allocated (the dry run's
    parameters)."""
    return init_model(L.MetaGenerator(), cfg)


def _mtp_spec(cfg: ModelConfig) -> T.LayerSpec:
    """The MTP head's block: one dense layer of the trunk's mixer."""
    return T.LayerSpec(mixer="mla" if cfg.mla is not None else "gqa",
                       moe=False)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _encode(params: Params, batch: Dict, cfg: ModelConfig, *, generator,
            decision, is_training, ctx=None):
    """The encoder over ``frames`` (audio stub frontend output, no token
    ids) or, without them, the ``enc_tokens`` embeddings, each with
    sinusoidal positions."""
    if "frames" in batch:
        tok = None
        x = batch["frames"].to(cfg.torch_dtype)
    else:
        tok = batch["enc_tokens"]
        x = L.embed_apply(params["embed"], tok).to(cfg.torch_dtype)
    x = x + L.sinusoidal_pos(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    x, _, aux = T.apply_stack(params["encoder"], T.layer_plan(cfg, encoder=True),
                              x, cfg, mode="train", generator=generator,
                              decision=decision, is_training=is_training,
                              token_ids=tok, ctx=ctx)
    return L.norm_apply(params["enc_final_norm"], x, cfg), aux


def _cross_source(params: Params, batch: Dict, cfg: ModelConfig, *,
                  generator, decision, is_training, ctx=None):
    """(cross_src, aux) of the families that cross-attend: the encoder's
    output, or the VLM's projected image embeddings (cast to the
    activation dtype, then to ``img_proj``'s for the product, then back,
    the reference's roundings); (None, None) for the decoder-only ones."""
    if cfg.encdec is not None:
        return _encode(params, batch, cfg, generator=generator,
                       decision=decision, is_training=is_training, ctx=ctx)
    if cfg.vlm is not None:
        proj = params["img_proj"]
        img = batch["img_embeds"].to(cfg.torch_dtype).to(proj.dtype)
        return (img @ proj).to(cfg.torch_dtype), None
    return None, None


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------

def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings in the activation dtype, behind the hybrid's meta
    tokens where it has them."""
    x = L.embed_apply(params["embed"], tokens).to(cfg.torch_dtype)
    if cfg.n_meta:
        meta = params["meta"].to(cfg.torch_dtype)
        x = torch.cat([meta[None].expand((x.shape[0],) + meta.shape), x], 1)
    return x


def head_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return torch.matmul(x.to(cfg.torch_param_dtype),
                        head_matrix(params, cfg)).float()


def model_apply(params: Params, batch: Dict, cfg: ModelConfig, *,
                ctx=None, generator: Optional[torch.Generator] = None,
                decision=None, is_training: bool = True,
                return_hidden: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward, logits for every position. ``ctx`` (a
    ``core.moe.ParallelContext``) runs the MoE layers expert-parallel
    over its group: ``batch`` holds this rank's rows and ``params`` its
    experts.

    ``return_hidden=True`` returns the final-norm hidden states instead of
    logits: the training loss applies the head itself, chunked, so the
    (B, L, V) f32 logits need not exist at once."""
    tokens = batch["tokens"]
    x = _embed(params, tokens, cfg)
    cross_src, enc_aux = _cross_source(params, batch, cfg, generator=generator,
                                       decision=decision,
                                       is_training=is_training, ctx=ctx)
    x, _, aux = T.apply_stack(params["decoder"], T.layer_plan(cfg), x, cfg,
                              mode="train", generator=generator,
                              decision=decision, is_training=is_training,
                              cross_src=cross_src,
                              token_ids=None if cfg.n_meta else tokens, ctx=ctx)
    x = L.norm_apply(params["final_norm"], x[:, cfg.n_meta:], cfg)
    if enc_aux is not None:
        aux = {k: aux[k] + enc_aux[k] for k in aux}
    if cfg.mtp and is_training:
        aux = dict(aux, mtp_hidden=_mtp_hidden(params, x, tokens, cfg,
                                               generator, decision))
    if return_hidden:
        return x, aux
    return _logits(params, x, cfg), aux


def _mtp_hidden(params: Params, h: torch.Tensor, tokens: torch.Tensor,
                cfg: ModelConfig, generator, decision) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction at depth 1: the hidden states
    that predict token t + 2 from the trunk's final-norm state at t and
    the embedding of token t + 1 (``roll`` by -1, so the last column sees
    token 0; the loss masks it). The head is applied in the loss."""
    mtp = params["mtp"]
    emb_next = L.embed_apply(params["embed"],
                             torch.roll(tokens, -1, dims=1)).to(cfg.torch_dtype)
    z = torch.cat([L.norm_apply(mtp["norm_h"], h, cfg),
                   L.norm_apply(mtp["norm_e"], emb_next, cfg)], dim=-1)
    z = (z.to(mtp["proj"].dtype) @ mtp["proj"]).to(cfg.torch_dtype)
    z, _, _ = T._layer_apply(_mtp_spec(cfg), mtp["block"], z, cfg,
                             mode="train", cache=None, index=None,
                             generator=generator, decision=decision,
                             is_training=True, cross_src=None, token_ids=None)
    return L.norm_apply(mtp["norm_out"], z, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None, n_cross: Optional[int] = None) -> List[Params]:
    """Zero decode cache of ``max_seq`` positions (plus the hybrid's meta
    tokens); ``device="meta"`` gives shapes without memory. ``n_cross`` is
    the source length of the cross-attention K/V (default the config's
    ``encoder_seq``, or the VLM's ``n_image_tokens``; the decoder-only
    families have none)."""
    dtype = dtype or cfg.torch_dtype
    if cfg.encdec is not None:
        n_cross = n_cross or cfg.encdec.encoder_seq
    elif cfg.vlm is not None:
        n_cross = n_cross or cfg.vlm.n_image_tokens
    return T.init_stack_cache(T.layer_plan(cfg), cfg, batch,
                              max_seq + cfg.n_meta, n_cross or 0, dtype, device)


def prefill(params: Params, batch: Dict, cfg: ModelConfig, *,
            max_seq: Optional[int] = None,
            generator: Optional[torch.Generator] = None,
            last_index: Optional[torch.Tensor] = None, ctx=None
            ) -> Tuple[torch.Tensor, List[Params]]:
    """Prompt forward that returns the logits of the last prompt position
    (or of ``last_index[b]`` per row, an index into the prompt) and the
    decode cache: self-attention K/V padded to ``max_seq`` positions (plus
    the hybrid's meta tokens), cross K/V (encoder-decoder, VLM) at the
    source length, an SSM layer's conv window and state."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    max_seq = max_seq or cfg.max_seq
    x = _embed(params, tokens, cfg)
    cross_src, _ = _cross_source(params, batch, cfg, generator=generator,
                                 decision=False, is_training=False, ctx=ctx)
    x, caches, _ = T.apply_stack(params["decoder"], T.layer_plan(cfg), x, cfg,
                                 mode="prefill", generator=generator,
                                 decision=False, is_training=False,
                                 cross_src=cross_src,
                                 token_ids=None if cfg.n_meta else tokens,
                                 max_seq=max_seq + cfg.n_meta,
                                 cache_dtype=cfg.torch_dtype, ctx=ctx)
    x = L.norm_apply(params["final_norm"], x[:, cfg.n_meta:], cfg)
    if last_index is not None:
        x_last = x[torch.arange(b, device=x.device), last_index.long()][:, None]
    else:
        x_last = x[:, -1:]
    return _logits(params, x_last, cfg), caches


def decode_step(params: Params, caches: List[Params], token: torch.Tensor,
                index, cfg: ModelConfig, *,
                generator: Optional[torch.Generator] = None,
                local_routing: bool = False,
                token_valid: Optional[torch.Tensor] = None,
                flash_decode: bool = False,
                block_tables: Optional[torch.Tensor] = None, ctx=None
                ) -> Tuple[torch.Tensor, List[Params]]:
    """token: (B, 1); index: absolute position of this token — an int, or a
    (B,) tensor where every row sits at its own position (the hybrid adds
    its meta tokens to it: the caches' position is ``index + n_meta``).
    Gating Dropout is off at inference, but ``local_routing=True`` reuses
    its local routing path as the decision. ``token_valid`` (B,) keeps
    rows out of expert capacity. ``flash_decode=True`` reads attention
    caches through the flash-decode kernels. ``block_tables`` (B, n_blocks) int32 reads and
    writes the self-attention caches as page arenas (``serve/paged.py``);
    it needs a (B,) ``index``; its tables cover the meta-inclusive
    positions. ``caches`` are updated in place and returned."""
    x = L.embed_apply(params["embed"], token).to(cfg.torch_dtype)
    if cfg.n_meta:
        index = index + cfg.n_meta
    if token_valid is not None and token_valid.dim() == 1:
        token_valid = token_valid[:, None]            # (B,) -> (B, L=1)
    x, caches, _ = T.apply_stack(params["decoder"], T.layer_plan(cfg), x, cfg,
                                 mode="decode", caches=caches, index=index,
                                 generator=generator,
                                 decision=bool(local_routing),
                                 is_training=False, token_ids=token,
                                 token_valid=token_valid,
                                 flash_decode=flash_decode,
                                 block_tables=block_tables, ctx=ctx)
    x = L.norm_apply(params["final_norm"], x, cfg)
    return _logits(params, x, cfg), caches
