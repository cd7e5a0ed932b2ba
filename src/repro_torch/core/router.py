"""Token -> expert routing: gating networks, top-k selection, capacity
dispatch/combine (port of ``repro/core/router.py``). Shard-local functions,
used unchanged by the oracle (looped over virtual shards) and the kernel
backend, so their routing is identical by construction.

Routers:
  softmax  -- Switch/GShard gating (paper's setting; jitter noise supported)
  sigmoid  -- DeepSeek-V3-style sigmoid scores, renormalized top-k
  hash     -- Hash-Layer baseline: fixed multiplicative hash of token ids

Where the reference relies on JAX semantics that PyTorch lacks:
  * top-k ties go to the lower expert id, as ``jax.lax.top_k`` does: the
    selection is a stable descending sort, not ``torch.topk``, whose tie
    order is unspecified on CUDA;
  * ``.at[].add(mode="drop")`` / ``.get(mode="fill")`` become an explicit
    out-of-bounds row appended to the buffer and sliced off or read as 0;
  * the hash router's uint32 wrap is int64 arithmetic masked to 32 bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import MoEConfig

_HASH_MULT = 2654435761  # Knuth multiplicative hash
_U32 = 0xFFFFFFFF


class RouteResult(NamedTuple):
    """Shard-local routing decision for T tokens."""
    topk_idx: torch.Tensor   # (T, k) int64 expert ids (global expert space)
    topk_w: torch.Tensor     # (T, k) f32 combine weights
    probs: torch.Tensor      # (T, E) router probabilities
    logits: torch.Tensor     # (T, E) raw logits


class DispatchInfo(NamedTuple):
    pos: torch.Tensor        # (T, k) int64 position within expert buffer
    keep: torch.Tensor       # (T, k) bool: survived capacity
    topk_idx: torch.Tensor   # (T, k)
    topk_w: torch.Tensor     # (T, k)


def capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    return max(1, math.ceil(factor * n_tokens * top_k / n_experts))


def router_logits(wr: torch.Tensor, x: torch.Tensor, cfg: MoEConfig,
                  generator: Optional[torch.Generator],
                  is_training: bool) -> torch.Tensor:
    """(T, d) -> (T, E) f32 logits; multiplicative input jitter in
    training, drawn from ``generator``."""
    if is_training and cfg.jitter_eps > 0.0 and generator is not None:
        noise = torch.empty_like(x).uniform_(1.0 - cfg.jitter_eps,
                                             1.0 + cfg.jitter_eps,
                                             generator=generator)
        x = x * noise
    return x.float() @ wr.float()


def _top_k(scores: torch.Tensor, k: int):
    """Largest k along the last axis, ties to the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def route(wr: torch.Tensor, x: torch.Tensor, cfg: MoEConfig, *,
          generator: Optional[torch.Generator] = None,
          is_training: bool = True,
          token_ids: Optional[torch.Tensor] = None,
          expert_lo: int = 0,
          n_local: Optional[int] = None) -> RouteResult:
    """Route T tokens. If ``n_local`` is given, routing is RESTRICTED to the
    local expert group [expert_lo, expert_lo + n_local) — the Gating-Dropout
    local path: tokens ignore remote experts entirely."""
    E = cfg.n_experts
    T = x.shape[0]
    k = cfg.top_k
    logits = router_logits(wr, x, cfg, generator, is_training)

    if cfg.router_type == "hash":
        if token_ids is None:
            raise ValueError("hash router needs token ids")
        h = ((token_ids.long() & _U32) * _HASH_MULT & _U32) >> 16
        if n_local is None:
            idx0 = h % E
        else:
            idx0 = h % n_local + expert_lo
        topk_idx = idx0[:, None]
        if k > 1:  # spread extra slots deterministically
            extra = [(idx0 + 1 + j) % E for j in range(k - 1)]
            topk_idx = torch.stack([idx0] + extra, dim=1)
        topk_w = torch.full((T, k), 1.0 / k, dtype=torch.float32,
                            device=x.device)
        probs = torch.zeros((T, E), device=x.device).scatter_(1, idx0[:, None], 1.0)
        return RouteResult(topk_idx, topk_w, probs, logits.detach())

    if n_local is not None:
        eids = torch.arange(E, device=x.device)
        local = (eids >= expert_lo) & (eids < expert_lo + n_local)
        logits = logits.masked_fill(~local[None, :], -math.inf)

    if cfg.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
        if n_local is not None:
            scores = torch.where(torch.isfinite(logits), scores, 0.0)
        topk_s, topk_idx = _top_k(scores, k)
        topk_w = topk_s / topk_s.sum(-1, keepdim=True).clamp_min(1e-9)
        probs = scores / scores.sum(-1, keepdim=True).clamp_min(1e-9)
    else:  # softmax (paper)
        probs = torch.softmax(logits, dim=-1)
        topk_p, topk_idx = _top_k(probs, k)
        if k > 1:
            topk_w = topk_p / topk_p.sum(-1, keepdim=True).clamp_min(1e-9)
        else:
            topk_w = topk_p  # paper eq. (2): y = p_i(x) E_i(x)
    return RouteResult(topk_idx, topk_w, probs, logits)


def _count(idx: torch.Tensor, n: int, dtype=torch.long) -> torch.Tensor:
    """Occurrences of each value in [0, n): a scatter-add, not
    ``torch.bincount``, which reads its output size back to the host."""
    return torch.zeros(n, dtype=dtype, device=idx.device).index_add_(
        0, idx, torch.ones(idx.shape, dtype=dtype, device=idx.device))


def _positions_in_expert(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each entry within its expert, in stable token order."""
    tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = _count(flat_e, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(tk, device=flat_e.device) - starts[flat_e[order]]
    return torch.empty_like(flat_e).index_put_((order,), pos_sorted)


def dispatch_info(rr: RouteResult, n_experts: int, cap: int,
                  valid: Optional[torch.Tensor] = None) -> DispatchInfo:
    """Buffer positions. ``valid`` (T, k) masks entries that must not
    consume capacity (e.g. non-local picks on a Gate-Drop local step)."""
    T, k = rr.topk_idx.shape
    flat_e = rr.topk_idx.reshape(-1)
    if valid is not None:
        # phantom bucket n_experts for invalid entries
        flat_e = torch.where(valid.reshape(-1), flat_e, n_experts)
        pos = _positions_in_expert(flat_e, n_experts + 1).reshape(T, k)
        keep = (pos < cap) & valid
    else:
        pos = _positions_in_expert(flat_e, n_experts).reshape(T, k)
        keep = pos < cap
    return DispatchInfo(pos=pos, keep=keep, topk_idx=rr.topk_idx,
                        topk_w=rr.topk_w)


def _flat_slots(info: DispatchInfo, n_experts: int, cap: int,
                expert_lo: int) -> torch.Tensor:
    """Flat slot e*cap+p of each kept (t, k), n_experts*cap (the
    out-of-bounds row) elsewhere."""
    e = (info.topk_idx - expert_lo).reshape(-1)
    p = info.pos.reshape(-1)
    ok = info.keep.reshape(-1) & (e >= 0) & (e < n_experts) & (p >= 0) & (p < cap)
    return torch.where(ok, e * cap + p, n_experts * cap)


def dispatch(x: torch.Tensor, info: DispatchInfo, n_experts: int, cap: int,
             expert_lo: int = 0) -> torch.Tensor:
    """Scatter tokens (T, d) into expert buffers (n_experts, cap, d);
    entries that did not survive land in a dropped extra row."""
    T, k = info.topk_idx.shape
    d = x.shape[-1]
    slot = _flat_slots(info, n_experts, cap, expert_lo)
    xk = x[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = torch.zeros((n_experts * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, xk)
    return buf[:-1].reshape(n_experts, cap, d)


def combine(buf: torch.Tensor, info: DispatchInfo, *,
            weight_dtype: torch.dtype = torch.float32,
            expert_lo: int = 0) -> torch.Tensor:
    """Gather expert outputs back to token order with combine weights.
    buf: (n_experts, cap, d) -> (T, d); out-of-bounds reads give 0."""
    T, k = info.topk_idx.shape
    n_experts, cap, d = buf.shape
    slot = _flat_slots(info, n_experts, cap, expert_lo)
    padded = torch.cat([buf.reshape(-1, d), buf.new_zeros((1, d))])
    gathered = padded.index_select(0, slot).reshape(T, k, d)
    w = (info.topk_w * info.keep).to(weight_dtype)
    return torch.einsum("tkd,tk->td", gathered.to(weight_dtype), w).to(buf.dtype)


def balance_loss(rr: RouteResult, cfg: MoEConfig) -> torch.Tensor:
    """Switch/GShard auxiliary balance loss: E * sum_e f_e * P_e."""
    E = cfg.n_experts
    top1 = rr.topk_idx[:, 0]
    f = _count(top1, E, torch.float32) / top1.shape[0]
    p = rr.probs.mean(dim=0)
    return E * torch.sum(f.detach() * p)


def router_z_loss(rr: RouteResult) -> torch.Tensor:
    return torch.mean(torch.logsumexp(rr.logits, dim=-1) ** 2)


def route_entropy(rr: RouteResult) -> torch.Tensor:
    """Mean per-token entropy (nats) of the router distribution."""
    p = rr.probs
    return -torch.sum(p * torch.log(p.clamp_min(1e-20)), dim=-1).mean()


def expert_load(rr: RouteResult, cfg: MoEConfig) -> torch.Tensor:
    """(E,) routed assignments per expert over all k slots, per token."""
    f = _count(rr.topk_idx.reshape(-1), cfg.n_experts, torch.float32)
    return f / rr.topk_idx.shape[0]
