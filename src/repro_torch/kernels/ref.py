"""Plain PyTorch versions of every kernel in this package.

Each is the function its kernel computes, written with stock tensor ops:
the CPU path of the kernel's wrapper, and what ``chip_smoke.py`` and the
``cuda``-marked tests hold the kernel against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, f) -> (E, C, f). f32 accumulation, output
    in x's dtype."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def grouped_matmul_dx_ref(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dy: (E, C, f), w: (E, d, f) -> dy @ w^T (E, C, d), in dy's dtype."""
    return torch.bmm(dy.float(), w.float().transpose(1, 2)).to(dy.dtype)


def grouped_matmul_dw_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), dy: (E, C, f) -> x^T @ dy (E, d, f), in x's dtype."""
    return torch.bmm(x.float().transpose(1, 2), dy.float()).to(x.dtype)


def dispatch_ref(x: torch.Tensor, slot_token: torch.Tensor,
                 slot_valid: torch.Tensor) -> torch.Tensor:
    """Gather-form token dispatch.

    x: (T, d); slot_token: (S,) int token feeding each expert-buffer slot
    (row-major (E, C) flattened, clipped to [0, T)); slot_valid: (S,) bool.
    Returns the (S, d) expert buffer rows, zero where the slot is empty.
    """
    idx = slot_token.long().clamp(0, x.shape[0] - 1)
    rows = x.index_select(0, idx)
    return torch.where(slot_valid[:, None], rows, torch.zeros((), dtype=x.dtype,
                                                               device=x.device))


def combine_ref(buf: torch.Tensor, token_slot: torch.Tensor,
                weights: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Weighted gather-combine of expert outputs.

    buf: (S, d) flattened expert rows; token_slot: (T, K) int slot per
    (token, k), clipped to [0, S); weights: (T, K); keep: (T, K) bool.
    y[t] = sum_k weights[t,k] * keep[t,k] * buf[token_slot[t,k]] in f32,
    returned in buf's dtype.
    """
    t, k = token_slot.shape
    idx = token_slot.long().clamp(0, buf.shape[0] - 1).reshape(-1)
    g = buf.index_select(0, idx).reshape(t, k, -1).float()
    w = (weights * keep).float()
    return torch.einsum("tkd,tk->td", g, w).to(buf.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     index) -> torch.Tensor:
    """Single-token decode attention.

    q: (B, H, hd); k, v: (B, S, KV, hd); index: int or (B,) — positions
    > index (per row) are masked out. f32 math; returns (B, H, hd) in q's
    dtype.
    """
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    rep = h // kv
    ke = k.repeat_interleave(rep, dim=2).float()
    ve = v.repeat_interleave(rep, dim=2).float()
    logits = torch.einsum("bhd,bshd->bhs", q.float(), ke) * (hd ** -0.5)
    idx = torch.as_tensor(index, device=q.device).reshape(-1).expand(b)
    valid = torch.arange(s, device=q.device)[None, :] <= idx[:, None]
    logits = logits.masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, ve).to(q.dtype)


def flash_decode_paged_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, block_tables: torch.Tensor,
                           index: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention over a paged cache (the reference's
    non-flash paged read, ``models/attention.py:235-239``).

    q: (B, H, hd); k, v: page arena (n_pages + 1, page_size, KV, hd);
    block_tables: (B, n_blocks) int; index: (B,). Gathers each row's pages
    into a contiguous (B, n_blocks * page_size, KV, hd) view, masks
    positions > index[b] and takes the softmax in f32; returns (B, H, hd)
    in q's dtype.
    """
    b = q.shape[0]
    ps = k.shape[1]
    nb = block_tables.shape[1]
    bt = block_tables.long()
    gk = k[bt].reshape((b, nb * ps) + tuple(k.shape[2:]))
    gv = v[bt].reshape((b, nb * ps) + tuple(v.shape[2:]))
    return flash_decode_ref(q, gk, gv, index)


def activation(name: str):
    """The expert FFN's activation in f32: silu, or GELU in the tanh
    approximation (``jax.nn.gelu``'s default)."""
    if name == "silu":
        return F.silu
    return lambda h: F.gelu(h, approximate="tanh")


def fused_moe_ref(x: torch.Tensor, w_in: torch.Tensor,
                  w_gate: Optional[torch.Tensor], w_out: torch.Tensor,
                  wcomb: torch.Tensor, slot_token: torch.Tensor,
                  slot_valid: torch.Tensor, token_slot: torch.Tensor,
                  act: str) -> torch.Tensor:
    """The fused MoE FFN in its slot formulation (the reference's
    ``moe_megakernel._ref_forward``): gather each slot's token row (zero
    where the slot is empty), expert FFN by batched matmul with the
    activation in f32, then each token's weighted sum over its k slots.

    x: (T, d) in the weights' dtype; w_in / w_gate: (E, d, f); w_out:
    (E, f, d); wcomb: (T, K) f32 = topk_w * keep; slot_token / slot_valid:
    (E*C,); token_slot: (T, K). Returns (T, d) in x's dtype. Also the
    backward of the fused kernel, by autograd through these ops."""
    t = x.shape[0]
    e = w_in.shape[0]
    s = slot_token.shape[0]
    actf = activation(act)
    rows = x.index_select(0, slot_token.long().clamp(0, t - 1))
    buf = torch.where(slot_valid[:, None], rows, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))
    bufe = buf.reshape(e, s // e, -1).to(w_in.dtype)
    h = torch.bmm(bufe, w_in)
    if w_gate is not None:
        g = torch.bmm(bufe, w_gate)
        h = actf(g.float()).to(h.dtype) * h
    else:
        h = actf(h.float()).to(h.dtype)
    out = torch.bmm(h, w_out).reshape(s, -1)
    idx = token_slot.long().clamp(0, s - 1).reshape(-1)
    picked = out.index_select(0, idx).reshape(token_slot.shape + (out.shape[-1],))
    y = torch.einsum("tkd,tk->td", picked.float(), wcomb.float())
    return y.to(x.dtype)


def fused_moe_f32_ref(x: torch.Tensor, w_in: torch.Tensor,
                      w_gate: Optional[torch.Tensor], w_out: torch.Tensor,
                      wcomb: torch.Tensor, slot_token: torch.Tensor,
                      slot_valid: torch.Tensor, token_slot: torch.Tensor,
                      act: str) -> torch.Tensor:
    """What the fused kernel computes, as the TPU kernel does: every input
    upcast to f32, ``fused_moe_ref`` in f32, the result rounded once to
    x's dtype. (``fused_moe_ref`` in bf16 rounds the FFN's intermediates
    to bf16; it is the backward's formulation, not the kernel's.)"""
    up = [None if t is None else t.float() for t in (x, w_in, w_gate, w_out)]
    return fused_moe_ref(*up, wcomb, slot_token, slot_valid, token_slot,
                         act).to(x.dtype)
