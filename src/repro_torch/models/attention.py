"""Attention: GQA with RoPE, full (quadratic) and blocked flash attention,
sliding windows, decode against a full, paged or ring-buffer KV cache,
cross-attention (port of ``repro/models/attention.py``).

Shapes: q (B, Lq, H, hd); k, v (B, Lk, KV, hd) with H % KV == 0.

Prefill and training attention is plain torch, as in the reference, where
it is no TPU kernel either: quadratic up to 2 * ``chunk`` keys, then the
blocked flash attention of ``models/flash.py`` (O(L) memory). The decode
read against a full cache goes through a flash-decode kernel when
``flash=True``: B5 on a contiguous cache, B6 on a paged one. A
sliding-window layer decodes against a ring buffer of ``window`` slots
whose ``pos`` leaf holds each slot's absolute position; it keeps the plain
read, as in the reference (its validity comes from ``pos``, not from a
prefix).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_decode as FD
from repro_torch.models import flash as FL
from repro_torch.models.layers import apply_rope, normal

Params = Dict[str, Any]
NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """(B, L, KV, hd) -> (B, L, H, hd) by repeating groups."""
    kv = k.shape[2]
    return k if kv == h else k.repeat_interleave(h // kv, dim=2)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int = 0) -> torch.Tensor:
    """(Lq, Lk) boolean validity mask from absolute positions."""
    m = (kpos[None, :] >= 0).expand(qpos.shape[0], kpos.shape[0])
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def full_attention(q, k, v, *, causal: bool, window: int = 0,
                   qpos: Optional[torch.Tensor] = None,
                   kpos: Optional[torch.Tensor] = None,
                   kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quadratic attention in f32. kv_valid: (B, Lk) or (Lk,) extra
    validity. Returns q's dtype."""
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    dev = q.device
    if qpos is None:
        qpos = torch.arange(lq, device=dev)
    if kpos is None:
        kpos = torch.arange(lk, device=dev)
    ke = _expand_kv(k, h).float()
    ve = _expand_kv(v, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ke) * (hd ** -0.5)
    m = _mask(qpos, kpos, causal, window)[None, None]      # (1, 1, Lq, Lk)
    if kv_valid is not None:
        kv_valid = torch.as_tensor(kv_valid, device=dev)
        if kv_valid.dim() == 1:
            m = m & kv_valid[None, None, None, :]
        else:
            m = m & kv_valid[:, None, None, :]
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, ve)
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Memory-bounded attention: the quadratic path up to ``2 * chunk``
    keys, the blocked flash attention past them, whose backward recomputes
    the probability blocks (O(L) residuals instead of O(L^2))."""
    lq, lk = q.shape[1], k.shape[1]
    if lk <= 2 * chunk:
        return full_attention(q, k, v, causal=causal, window=window,
                              qpos=q_offset + torch.arange(lq, device=q.device))
    return FL.flash_attention(q, k, v, causal, window, q_offset, 0,
                              min(chunk, lq), chunk)


# ---------------------------------------------------------------------------
# GQA projection layer
# ---------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype,
              out_scale: float = 1.0, lead: Tuple[int, ...] = ()) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    s = d ** -0.5
    return {
        "wq": normal(gen, lead + (d, h, hd), s, dtype),
        "wk": normal(gen, lead + (d, kv, hd), s, dtype),
        "wv": normal(gen, lead + (d, kv, hd), s, dtype),
        "wo": normal(gen, lead + (h, hd, d), (h * hd) ** -0.5 * out_scale, dtype),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, L, d) x (d, H, hd) -> (B, L, H, hd) in w's dtype."""
    return torch.einsum("bld,dhk->blhk", x.to(w.dtype), w)


def attn_qkv(p: Params, x: torch.Tensor):
    return _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])


def attn_out(p: Params, o: torch.Tensor, x_dtype) -> torch.Tensor:
    return torch.einsum("blhk,hkd->bld", o.to(p["wo"].dtype),
                        p["wo"]).to(x_dtype)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                  device=None, lead: Tuple[int, ...] = ()) -> Params:
    shape = lead + (batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_ring_cache(cfg: ModelConfig, batch: int, window: int, dtype,
                    device=None, lead: Tuple[int, ...] = ()) -> Params:
    """Ring buffer of a sliding-window layer: ``window`` K/V slots and the
    absolute position held in each (``pos``, int32, -1 = empty; no batch
    axis: the rows of a one-shot batch share their positions)."""
    shape = lead + (batch, window, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full(lead + (window,), -1, dtype=torch.int32,
                              device=device)}


def decode_self_attention(p: Params, x: torch.Tensor, cache: Params,
                          cfg: ModelConfig, index, *, window: int = 0,
                          flash: bool = False,
                          block_tables: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Params]:
    """One-token decode. x: (B, 1, d); ``index`` is the absolute position
    of the new token: an int (every row at one position) or a (B,) tensor
    (slot-pool decode, each row at its own).

    With ``window > 0`` and a ring cache of ``window`` slots, the new row
    goes to slot ``index % window`` and its position into ``pos``; a slot
    is read where ``index - window < pos <= index``. The per-row form
    needs the slot pool's batched ``(B, window)`` ``pos`` leaf; its masks
    equal the scalar form's in value, so the two give the same bits when
    every row sits at one position. A ring layer ignores ``flash`` and
    ``block_tables``.

    The new K/V row is written INTO ``cache`` in place (the reference
    returns an updated copy; writing in place spares a cache copy per
    step), and the same dict is returned. ``flash=True`` reads the cache
    through the flash-decode kernel; its ``pos <= index`` mask is the same
    predicate as the plain path's ``kv_valid``.

    ``block_tables`` (B, n_blocks) int32 switches to PAGED addressing:
    ``cache["k"]``/``["v"]`` are then a page arena (n_pages + 1, page_size,
    KV, hd) shared by all rows, and row b's position p lives at arena
    ``[block_tables[b, p // page_size], p % page_size]``. The new row is
    written through the table, then read through B6 (``flash=True``) or by
    gathering the row's pages into a contiguous (B, n_blocks * page_size,
    KV, hd) view under the same ``pos <= index`` mask, so positions past
    ``index`` (unwritten tail, the scratch page, another owner's bytes)
    get zero probability. Requires a per-row ``index``."""
    b = x.shape[0]
    q, k, v = attn_qkv(p, x)
    per_row = torch.is_tensor(index) and index.dim() == 1
    pos = (index[:, None] if per_row
           else torch.as_tensor(index, device=x.device).reshape(1))
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    if window > 0 and ck.shape[1] == window:
        return attn_out(p, _ring_read(q, k, v, cache, index, window, per_row),
                        x.dtype), cache
    if block_tables is not None:
        if not per_row:
            raise ValueError("paged decode requires per-row positions")
        ps, nb = ck.shape[1], block_tables.shape[1]
        page = block_tables.gather(1, (index // ps).long()[:, None])[:, 0].long()
        off = index % ps
        ck[page, off] = k[:, 0].to(ck.dtype)
        cv[page, off] = v[:, 0].to(cv.dtype)
        if flash:
            o = FD.flash_decode_paged(q[:, 0].contiguous(), ck, cv,
                                      block_tables, index)[:, None]
        else:
            bt = block_tables.long()
            gk = ck[bt].reshape((b, nb * ps) + tuple(ck.shape[2:]))
            gv = cv[bt].reshape((b, nb * ps) + tuple(cv.shape[2:]))
            valid = (torch.arange(nb * ps, device=x.device)[None, :]
                     <= index[:, None])
            o = full_attention(q, gk, gv, causal=False, kv_valid=valid)
        return attn_out(p, o, x.dtype), cache
    s = ck.shape[1]
    if per_row:
        rows = torch.arange(b, device=x.device)
        ck[rows, index] = k[:, 0].to(ck.dtype)
        cv[rows, index] = v[:, 0].to(cv.dtype)
    else:
        ck[:, index] = k[:, 0].to(ck.dtype)
        cv[:, index] = v[:, 0].to(cv.dtype)
    if flash:
        o = FD.flash_decode(q[:, 0].contiguous(), ck, cv, index)[:, None]
    elif per_row:
        valid = torch.arange(s, device=x.device)[None, :] <= index[:, None]
        o = full_attention(q, ck, cv, causal=False, kv_valid=valid)
    else:
        kpos = torch.arange(s, device=x.device)
        o = full_attention(q, ck, cv, causal=False,
                           qpos=torch.as_tensor(index, device=x.device).reshape(1),
                           kpos=kpos, kv_valid=kpos <= index)
    return attn_out(p, o, x.dtype), cache


def _ring_read(q, k, v, cache: Params, index, window: int,
               per_row: bool) -> torch.Tensor:
    """Write the new K/V row and its position into the ring ``cache`` in
    place, then attend over the slots inside the window."""
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    if per_row:
        if cpos.dim() != 2:
            raise ValueError("per-row decode needs a slot-pool ring cache "
                             "(batched pos)")
        rows = torch.arange(q.shape[0], device=q.device)
        slot = index % window
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        cpos[rows, slot] = index.to(torch.int32)
        idx = index[:, None]
        valid = (cpos >= 0) & (cpos > idx - window) & (cpos <= idx)
        return full_attention(q, ck, cv, causal=False, kv_valid=valid)
    idx = torch.as_tensor(index, device=q.device).reshape(1)
    slot = idx % window
    ck[:, slot] = k.to(ck.dtype)
    cv[:, slot] = v.to(cv.dtype)
    cpos[slot] = idx.to(torch.int32)
    valid = (cpos >= 0) & (cpos > idx - window) & (cpos <= idx)
    return full_attention(q, ck, cv, causal=False, qpos=idx,
                          kpos=cpos.clamp_min(0), kv_valid=valid)


# ---------------------------------------------------------------------------
# cross attention (enc-dec)
# ---------------------------------------------------------------------------

def init_cross_attn(gen: torch.Generator, cfg: ModelConfig, dtype,
                    out_scale: float = 1.0,
                    lead: Tuple[int, ...] = ()) -> Params:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_
    return {
        "wq": normal(gen, lead + (d, h, hd), d ** -0.5, dtype),
        "wk": normal(gen, lead + (d, h, hd), d ** -0.5, dtype),
        "wv": normal(gen, lead + (d, h, hd), d ** -0.5, dtype),
        "wo": normal(gen, lead + (h, hd, d), (h * hd) ** -0.5 * out_scale, dtype),
    }


def make_cross_kv(p: Params, kv_src: torch.Tensor):
    return _proj(kv_src, p["wk"]), _proj(kv_src, p["wv"])


def cross_attention_kv(p: Params, x: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    q = _proj(x, p["wq"])
    o = full_attention(q, k, v, causal=False)
    return attn_out(p, o, x.dtype)
