"""Plain PyTorch versions of every kernel in this package.

Each is the function its kernel computes, written with stock tensor ops:
the CPU path of the kernel's wrapper, and what ``chip_smoke.py`` and the
``cuda``-marked tests hold the kernel against on the card.
"""
from __future__ import annotations

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), w: (E, d, f) -> (E, C, f). f32 accumulation, output
    in x's dtype."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


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
