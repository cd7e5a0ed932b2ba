"""Torch ops around the kernels (port of ``repro/kernels/ops.py``).

``routing_tables`` turns the router's DispatchInfo into the gather form
the dispatch, combine and fused kernels consume, once per layer: both
gathers of the pipeline (or the fused kernel's gather, scatter and
backward) reuse the same tables.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.router import DispatchInfo
from repro_torch.kernels import grouped_ffn, moe_dispatch, moe_megakernel, ref


class RoutingTables(NamedTuple):
    """Gather-form routing state, built once per layer from DispatchInfo.

    slot_token[e*C + c] = which token fills slot c of expert e (-1 empty);
    slot_valid[s]       = slot s is occupied;
    token_slot[t, k]    = flat slot index for the (t, k) routing choice.
    """
    slot_token: torch.Tensor    # (E*C,) int32
    slot_valid: torch.Tensor    # (E*C,) bool
    token_slot: torch.Tensor    # (T, K) int32


def routing_tables(info: DispatchInfo, n_experts: int,
                   cap: int) -> RoutingTables:
    """DispatchInfo -> RoutingTables: one scatter over (T*k,) builds both
    gather maps. Dropped entries scatter into an extra slot E*C that is
    sliced off (the reference's ``mode="drop"``)."""
    t, k = info.topk_idx.shape
    flat = info.topk_idx.reshape(-1) * cap + info.pos.reshape(-1)
    keep = info.keep.reshape(-1)
    flat_slot = torch.where(keep, flat, n_experts * cap)
    token_ids = torch.arange(t, dtype=torch.int32,
                             device=flat.device).repeat_interleave(k)
    slot_token = torch.full((n_experts * cap + 1,), -1, dtype=torch.int32,
                            device=flat.device)
    slot_token = slot_token.index_put_((flat_slot,), token_ids)[:-1]
    token_slot = torch.where(keep, flat, 0).to(torch.int32).reshape(t, k)
    return RoutingTables(slot_token, slot_token >= 0, token_slot)


def moe_dispatch_op(x: torch.Tensor, info: DispatchInfo, n_experts: int,
                    cap: int, *,
                    tables: Optional[RoutingTables] = None) -> torch.Tensor:
    """Kernel-backed equivalent of router.dispatch: (T, d) -> (E, C, d)."""
    if tables is None:
        tables = routing_tables(info, n_experts, cap)
    buf = moe_dispatch.dispatch(x, tables.slot_token, tables.slot_valid)
    return buf.reshape(n_experts, cap, x.shape[-1])


def moe_combine_op(buf: torch.Tensor, info: DispatchInfo, *,
                   tables: Optional[RoutingTables] = None) -> torch.Tensor:
    """Kernel-backed equivalent of router.combine: (E, C, d) -> (T, d)."""
    e, cap, d = buf.shape
    if tables is None:
        tables = routing_tables(info, e, cap)
    return moe_dispatch.combine(buf.reshape(e * cap, d), tables.token_slot,
                                info.topk_w, info.keep)


def fused_moe_op(x: torch.Tensor, info: DispatchInfo, w_in: torch.Tensor,
                 w_gate: Optional[torch.Tensor], w_out: torch.Tensor,
                 n_experts: int, cap: int, act: str = "silu", *,
                 tables: Optional[RoutingTables] = None) -> torch.Tensor:
    """One-launch fused equivalent of dispatch -> expert_ffn_op -> combine:
    (T, d) -> (T, d) without the (E, C, d) buffer in device memory."""
    if tables is None:
        tables = routing_tables(info, n_experts, cap)
    return moe_megakernel.fused_moe(x, w_in, w_gate, w_out, info.topk_w,
                                    info.keep, tables.slot_token,
                                    tables.slot_valid, tables.token_slot,
                                    act=act)


def expert_ffn_op(buf: torch.Tensor, w_in: torch.Tensor,
                  w_gate: Optional[torch.Tensor], w_out: torch.Tensor,
                  act: str = "silu") -> torch.Tensor:
    """Expert FFN from grouped-matmul kernels; the activation runs in f32
    (GELU is the tanh approximation, as ``jax.nn.gelu``'s default)."""
    actf = ref.activation(act)
    h = grouped_ffn.grouped_matmul(buf, w_in)
    if w_gate is not None:
        g = grouped_ffn.grouped_matmul(buf, w_gate)
        h = actf(g.float()).to(h.dtype) * h
    else:
        h = actf(h.float()).to(h.dtype)
    return grouped_ffn.grouped_matmul(h, w_out)
