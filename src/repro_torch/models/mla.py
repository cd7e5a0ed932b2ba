"""Multi-head latent attention, DeepSeek-V2/V3 (arXiv:2412.19437); port of
``repro/models/mla.py``.

Keys and values are compressed jointly into a latent ``c_kv`` of
``kv_lora_rank`` plus one decoupled RoPE key ``k_rope`` shared by all
heads; that pair is the decode cache, (B, S, c) and (B, S, dr). Training
and prefill decompress K/V per head and run causal attention through
``attention.flash_attention`` with ``chunk=2048`` (quadratic up to 4,096
keys, blocked past them). Decode uses the ABSORBED formulation: the key
up-projection is folded into the query and the value up-projection into
the output, so a step reads only the compressed cache.

The reference computes all of this in jnp, with no Pallas kernel, so the
port is plain PyTorch. The projections run in the parameters' dtype (the
activations are cast up to it), the scores and softmax of decode in f32.
Cache updates are written in place, the port's convention for every
decode cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models.layers import apply_rope, normal

Params = Dict[str, Any]
NEG_INF = -1e30


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype,
             out_scale: float = 1.0, lead: Tuple[int, ...] = ()) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    ones = lambda n: torch.ones(lead + (n,), dtype=dtype,  # noqa: E731
                                device=gen.device)
    return {
        "w_dq": normal(gen, lead + (d, m.q_lora_rank), d ** -0.5, dtype),
        "q_norm": ones(m.q_lora_rank),
        "w_uq": normal(gen, lead + (m.q_lora_rank, h, dn + dr),
                       m.q_lora_rank ** -0.5, dtype),
        "w_dkv": normal(gen, lead + (d, m.kv_lora_rank + dr), d ** -0.5, dtype),
        "kv_norm": ones(m.kv_lora_rank),
        "w_ukv": normal(gen, lead + (m.kv_lora_rank, h, dn + dv),
                        m.kv_lora_rank ** -0.5, dtype),
        "wo": normal(gen, lead + (h, dv, d), (h * dv) ** -0.5 * out_scale,
                     dtype),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of the latents in f32 with its own eps (not the model's
    norm), returned in x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps)
            * scale.float()).to(x.dtype)


def _project_q(p: Params, x: torch.Tensor, cfg: ModelConfig,
               pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, d) -> q_nope (B, L, H, dn), q_rope (B, L, H, dr) roped."""
    dn = cfg.mla.qk_nope_head_dim
    cq = _rms(x.to(p["w_dq"].dtype) @ p["w_dq"], p["q_norm"])
    q = torch.einsum("blc,chk->blhk", cq, p["w_uq"])
    return q[..., :dn], apply_rope(q[..., dn:], pos, cfg.rope_theta)


def _compress_kv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (c_kv normed (B, L, c), k_rope roped (B, L, dr)): the cache
    pair. The RoPE key goes through ``apply_rope`` on a singleton head
    axis."""
    c = cfg.mla.kv_lora_rank
    full = x.to(p["w_dkv"].dtype) @ p["w_dkv"]
    c_kv = _rms(full[..., :c], p["kv_norm"])
    k_rope = apply_rope(full[..., None, c:], pos, cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  q_offset: int = 0, chunk: int = 2048,
                  return_cache: bool = False):
    """Training and prefill: decompress K/V and run causal attention over
    q/k heads of dn + dr and v heads of dv (``chunk`` bounds the score
    blocks past 2 x chunk keys). Returns y (B, L, d) in x's dtype, and
    with ``return_cache`` also the (c_kv, k_rope) pair."""
    m = cfg.mla
    b, l, _ = x.shape
    h, dn, dr = cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    pos = q_offset + torch.arange(l, device=x.device)
    q_nope, q_rope = _project_q(p, x, cfg, pos)
    c_kv, k_rope = _compress_kv(p, x, cfg, pos)
    kv = torch.einsum("blc,chk->blhk", c_kv, p["w_ukv"])
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([kv[..., :dn], k_rope[:, :, None, :].expand(b, l, h, dr)], -1)
    o = A.flash_attention(q, k, kv[..., dn:], causal=True, q_offset=q_offset,
                          chunk=chunk)
    y = torch.einsum("blhv,hvd->bld", o.to(p["wo"].dtype), p["wo"]).to(x.dtype)
    if return_cache:
        return y, (c_kv, k_rope)
    return y


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device=None, lead: Tuple[int, ...] = ()) -> Params:
    m = cfg.mla
    return {
        "c_kv": torch.zeros(lead + (batch, max_seq, m.kv_lora_rank),
                            dtype=dtype, device=device),
        "k_rope": torch.zeros(lead + (batch, max_seq, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_decode(p: Params, x: torch.Tensor, cache: Params, cfg: ModelConfig,
               index, block_tables: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Params]:
    """Absorbed one-token decode against the compressed cache. x: (B, 1,
    d); ``index`` is an int (every row at one position) or a (B,) tensor
    (slot-pool decode, each row at its own).

    ``block_tables`` (B, n_blocks) int32 switches to PAGED addressing: the
    cache leaves are then page arenas (n_pages + 1, page_size, c | dr)
    shared by all rows. The latent pair is written through the table and
    the row's pages gathered back into a contiguous view; the ``pos <=
    index`` mask zeroes everything past each row's depth exactly, so the
    paged read gives the per-row read's bits. Needs a per-row ``index``.

    The new latent row is written INTO ``cache`` in place and the same
    dict is returned."""
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    b = x.shape[0]
    per_row = torch.is_tensor(index) and index.dim() == 1
    pos = (index[:, None] if per_row
           else torch.as_tensor(index, device=x.device).reshape(1))
    q_nope, q_rope = _project_q(p, x, cfg, pos)            # (B, 1, H, dn | dr)
    c_new, kr_new = _compress_kv(p, x, cfg, pos)           # (B, 1, c), (B, 1, dr)
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    if block_tables is not None:
        if not per_row:
            raise ValueError("paged decode requires per-row positions")
        ps, nb = c_cache.shape[1], block_tables.shape[1]
        page = block_tables.gather(1, (index // ps).long()[:, None])[:, 0].long()
        off = index % ps
        c_cache[page, off] = c_new[:, 0].to(c_cache.dtype)
        r_cache[page, off] = kr_new[:, 0].to(r_cache.dtype)
        bt = block_tables.long()
        c_kv = c_cache[bt].reshape(b, nb * ps, -1)
        k_rope = r_cache[bt].reshape(b, nb * ps, -1)
        valid = torch.arange(nb * ps, device=x.device)[None, :] <= index[:, None]
    else:
        smax = c_cache.shape[1]
        if per_row:
            rows = torch.arange(b, device=x.device)
            c_cache[rows, index] = c_new[:, 0].to(c_cache.dtype)
            r_cache[rows, index] = kr_new[:, 0].to(r_cache.dtype)
            valid = torch.arange(smax, device=x.device)[None, :] <= index[:, None]
        else:
            c_cache[:, index] = c_new[:, 0].to(c_cache.dtype)
            r_cache[:, index] = kr_new[:, 0].to(r_cache.dtype)
            valid = (torch.arange(smax, device=x.device) <= index)[None, :] \
                .expand(b, smax)
        c_kv, k_rope = c_cache, r_cache
    # the key up-projection absorbed into the query, the value one into
    # the output
    w_k, w_v = p["w_ukv"][..., :dn], p["w_ukv"][..., dn:]  # (c, H, dn | dv)
    q_abs = torch.einsum("blhn,chn->blhc", q_nope, w_k)   # (B, 1, H, c)
    ckf = c_kv.float()
    s = (torch.einsum("blhc,bsc->bhls", q_abs.float(), ckf)
         + torch.einsum("blhr,bsr->bhls", q_rope.float(), k_rope.float())
         ) * ((dn + dr) ** -0.5)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    lat = torch.einsum("bhls,bsc->blhc", w, ckf)
    o = torch.einsum("blhc,chv->blhv", lat, w_v.float())
    y = torch.einsum("blhv,hvd->bld", o.to(p["wo"].dtype), p["wo"])
    return y.to(x.dtype), cache
