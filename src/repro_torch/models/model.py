"""Top-level model: embeddings + encoder + decoder stack + head (port of
``repro/models/model.py`` for the encoder-decoder family).

Public API:
  init_model(gen, cfg)                          -> params
  model_apply(params, batch, cfg, ...)          -> (logits, aux)    [eval/train]
  head_matrix(params, cfg)                      -> (d, vocab) output head
  prefill(params, batch, cfg, max_seq)          -> (logits, caches)
  decode_step(params, caches, token, index,...) -> (logits, caches)
  init_cache(cfg, batch, max_seq, dtype)        -> caches

``batch`` keys: "tokens" (B, L) always; "enc_tokens" (B, S_enc) for the
text encoder-decoder (the paper's MT models). Parameters live on the
device of the generator that drew them.
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
    n_total = cfg.n_layers + cfg.encdec.n_encoder_layers
    p: Params = {
        "embed": L.init_embed(gen, cfg.vocab, cfg.d_model, dtype),
        "decoder": T.init_stack(gen, T.layer_plan(cfg), cfg, dtype, n_total),
        "final_norm": L.init_norm(gen, cfg, cfg.d_model, dtype),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.normal(gen, (cfg.d_model, cfg.vocab),
                                cfg.d_model ** -0.5, dtype)
    p["encoder"] = T.init_stack(gen, T.layer_plan(cfg, encoder=True), cfg,
                                dtype, n_total)
    p["enc_final_norm"] = L.init_norm(gen, cfg, cfg.d_model, dtype)
    return p


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _encode(params: Params, batch: Dict, cfg: ModelConfig, *, generator,
            decision, is_training, ctx=None):
    if cfg.encdec.frontend != "tokens":
        raise NotImplementedError("only the token frontend is ported")
    tok = batch["enc_tokens"]
    x = L.embed_apply(params["embed"], tok).to(cfg.torch_dtype)
    x = x + L.sinusoidal_pos(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    x, _, aux = T.apply_stack(params["encoder"], T.layer_plan(cfg, encoder=True),
                              x, cfg, mode="train", generator=generator,
                              decision=decision, is_training=is_training,
                              token_ids=tok, ctx=ctx)
    return L.norm_apply(params["enc_final_norm"], x, cfg), aux


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------

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
    x = L.embed_apply(params["embed"], tokens).to(cfg.torch_dtype)
    cross_src, enc_aux = _encode(params, batch, cfg, generator=generator,
                                 decision=decision, is_training=is_training,
                                 ctx=ctx)
    x, _, aux = T.apply_stack(params["decoder"], T.layer_plan(cfg), x, cfg,
                              mode="train", generator=generator,
                              decision=decision, is_training=is_training,
                              cross_src=cross_src, token_ids=tokens, ctx=ctx)
    x = L.norm_apply(params["final_norm"], x, cfg)
    aux = {k: aux[k] + enc_aux[k] for k in aux}
    if return_hidden:
        return x, aux
    return _logits(params, x, cfg), aux


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None, n_cross: Optional[int] = None) -> List[Params]:
    """Zero decode cache; ``device="meta"`` gives shapes without memory.
    ``n_cross`` is the source length of the cross-attention K/V (default
    the config's ``encoder_seq``)."""
    dtype = dtype or cfg.torch_dtype
    return T.init_stack_cache(T.layer_plan(cfg), cfg, batch, max_seq,
                              n_cross or cfg.encdec.encoder_seq, dtype,
                              device)


def prefill(params: Params, batch: Dict, cfg: ModelConfig, *,
            max_seq: Optional[int] = None,
            generator: Optional[torch.Generator] = None,
            last_index: Optional[torch.Tensor] = None, ctx=None
            ) -> Tuple[torch.Tensor, List[Params]]:
    """Prompt forward that returns the logits of the last prompt position
    (or of ``last_index[b]`` per row) and the decode cache: self-attention
    K/V padded to ``max_seq`` positions, cross K/V at the source length."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    max_seq = max_seq or cfg.max_seq
    x = L.embed_apply(params["embed"], tokens).to(cfg.torch_dtype)
    cross_src, _ = _encode(params, batch, cfg, generator=generator,
                           decision=False, is_training=False, ctx=ctx)
    x, caches, _ = T.apply_stack(params["decoder"], T.layer_plan(cfg), x, cfg,
                                 mode="prefill", generator=generator,
                                 decision=False, is_training=False,
                                 cross_src=cross_src, token_ids=tokens,
                                 max_seq=max_seq, cache_dtype=cfg.torch_dtype,
                                 ctx=ctx)
    x = L.norm_apply(params["final_norm"], x, cfg)
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
    (B,) tensor where every row sits at its own position. Gating Dropout is
    off at inference, but ``local_routing=True`` reuses its local routing
    path as the decision. ``token_valid`` (B,) keeps rows out of expert
    capacity. ``flash_decode=True`` reads attention caches through the
    flash-decode kernels. ``block_tables`` (B, n_blocks) int32 reads and
    writes the self-attention caches as page arenas (``serve/paged.py``);
    it needs a (B,) ``index``. ``caches`` are updated in place and
    returned."""
    x = L.embed_apply(params["embed"], token).to(cfg.torch_dtype)
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
