"""Mixture-of-Experts layer with Gating Dropout (port of
``repro/core/moe.py`` at one device).

``moe_oracle`` is the plain reference: ``ep`` *virtual* shards, each
routing its own tokens, with the dense all-to-all emulated as a regrouping
of the stacked buffers. Gating Dropout is a per-step decision taken on the
host (a Python bool; eager PyTorch has no traced branch):

  routed step : route over all E experts -> dispatch -> expert FFN -> combine
  gate_drop   : route restricted to the local expert group -> local FFN
  gate_expert_drop : output = 0 (residual passthrough)

The reference's comm telemetry keys (wire bytes, all-to-all calls) are
absent: at one device the dense wire is the identity, and they return with
the comm and expert-parallel slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import router as R

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_moe_params(gen: torch.Generator, cfg: ModelConfig, *,
                    dtype: Optional[torch.dtype] = None,
                    lead: Tuple[int, ...] = ()) -> Params:
    """Router and expert weights, N(0, 1/fan_in) as in the reference;
    ``lead`` prepends stacking axes (layers of a segment)."""
    from repro_torch.models.layers import normal
    moe = cfg.moe
    d = cfg.d_model
    dff = moe.d_ff(cfg.d_ff)
    E = moe.n_experts
    dtype = dtype or cfg.torch_param_dtype
    p: Params = {
        "router": {"w": normal(gen, lead + (d, E), d ** -0.5, dtype)},
        "experts": {
            "w_in": normal(gen, lead + (E, d, dff), d ** -0.5, dtype),
            "w_out": normal(gen, lead + (E, dff, d), dff ** -0.5, dtype),
        },
    }
    if cfg.gated_mlp:
        p["experts"]["w_gate"] = normal(gen, lead + (E, d, dff), d ** -0.5, dtype)
    return p


# ---------------------------------------------------------------------------
# per-shard pieces (shared by the oracle and the kernel backend)
# ---------------------------------------------------------------------------

def _act(h: torch.Tensor, name: str) -> torch.Tensor:
    return F.silu(h) if name == "silu" else F.gelu(h, approximate="tanh")


def _expert_ffn(experts: Params, buf: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Per-expert FFN on (E, C, d) buffers, plain einsums."""
    w_in = experts["w_in"]
    x = buf.to(w_in.dtype)
    h = torch.einsum("ecd,edf->ecf", x, w_in)
    if cfg.gated_mlp:
        g = torch.einsum("ecd,edf->ecf", x, experts["w_gate"])
        h = _act(g, cfg.act) * h
    else:
        h = _act(h, cfg.act)
    y = torch.einsum("ecf,efd->ecd", h, experts["w_out"])
    return y.to(buf.dtype)


def _routed_aux(rr: R.RouteResult, info: R.DispatchInfo,
                moe: MoEConfig) -> Dict[str, torch.Tensor]:
    """Aux dict of a routed step, shared by every backend."""
    zero = rr.probs.new_zeros(())
    learned = moe.router_type != "hash"
    return {
        "balance": R.balance_loss(rr, moe) if learned else zero,
        "router_z": R.router_z_loss(rr) if learned else zero,
        "load": R.expert_load(rr, moe),
        "router_entropy": R.route_entropy(rr),
        "dropped_frac": 1.0 - info.keep.float().mean(),
    }


def _local_adjust(rr: R.RouteResult, moe: MoEConfig, lo: int, e_loc: int):
    """Gate-Drop local-path weight override + validity mask."""
    if moe.gating_dropout.local_combine == "one":
        rr = rr._replace(topk_w=torch.full_like(rr.topk_w, 1.0 / moe.top_k))
    # entries that could not be satisfied locally (k > e_loc) are invalid
    valid = (rr.topk_idx >= lo) & (rr.topk_idx < lo + e_loc) & (rr.topk_w > 0)
    return rr, valid


def _local_aux(rr: R.RouteResult, info: R.DispatchInfo, moe: MoEConfig,
               T: int) -> Dict[str, torch.Tensor]:
    """Aux dict of a Gate-Drop local step; ``rr`` carries GLOBAL ids. Load
    counts all k slots weighted by ``info.keep``; ids outside [0, E) are
    dropped."""
    w = (info.keep.float() / T).reshape(-1)
    idx = rr.topk_idx.reshape(-1)
    inb = (idx >= 0) & (idx < moe.n_experts)
    load = torch.zeros(moe.n_experts + 1, dtype=torch.float32,
                       device=w.device)
    load.index_add_(0, torch.where(inb, idx, moe.n_experts), w)
    zero = w.new_zeros(())
    return {"balance": zero, "router_z": zero, "load": load[:-1],
            "router_entropy": R.route_entropy(rr),
            "dropped_frac": 1.0 - info.keep.float().mean()}


def _zero_aux(E: int, device=None) -> Dict[str, torch.Tensor]:
    zero = torch.zeros((), device=device)
    return {"balance": zero, "router_z": zero,
            "load": torch.zeros((E,), device=device),
            "router_entropy": zero, "dropped_frac": zero}


def _token_valid_tk(token_valid: Optional[torch.Tensor], k: int):
    """(T,) bool token validity -> (T, k) dispatch validity (or None)."""
    if token_valid is None:
        return None
    return token_valid.reshape(-1, 1).expand(token_valid.numel(), k)


def _local_shard(wr, experts_loc, xf, moe: MoEConfig, cfg: ModelConfig,
                 generator, is_training, token_ids, my_shard: int, ep: int,
                 token_valid=None):
    """Gate-Drop local step: tokens stay on this shard, routed among the
    local expert group only."""
    T = xf.shape[0]
    E = moe.n_experts
    e_loc = E // ep
    lo = my_shard * e_loc
    rr = R.route(wr, xf, moe, generator=generator, is_training=is_training,
                 token_ids=token_ids, expert_lo=lo, n_local=e_loc)
    rr, valid = _local_adjust(rr, moe, lo, e_loc)
    if token_valid is not None:
        valid = valid & token_valid.reshape(-1, 1)
    rr_local = rr._replace(topk_idx=rr.topk_idx - lo)
    cf = moe.capacity_factor if is_training else moe.eval_capacity_factor
    cap = min(R.capacity(T, e_loc, moe.top_k, cf), T)
    info = R.dispatch_info(rr_local, e_loc, cap, valid=valid)
    buf = R.dispatch(xf, info, e_loc, cap)                   # (e_loc, cap, d)
    out = _expert_ffn(experts_loc, buf, cfg)
    return R.combine(out, info), _local_aux(rr, info, moe, T)


# ---------------------------------------------------------------------------
# oracle (plain torch, virtual shards)
# ---------------------------------------------------------------------------

def _mean_aux(auxs):
    return {k: torch.stack([a[k] for a in auxs]).mean(0) for k in auxs[0]}


def moe_oracle(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
               ep: int = 1, generator: Optional[torch.Generator] = None,
               decision: Optional[bool] = None, is_training: bool = True,
               token_ids: Optional[torch.Tensor] = None,
               token_valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """Reference MoE with ``ep`` virtual machines. x: (B, L, d) or (T, d)."""
    moe = cfg.moe
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    T = xf.shape[0]
    E = moe.n_experts
    if T % ep or E % ep:
        raise ValueError(f"{T} tokens and {E} experts must split over ep={ep}")
    Tl = T // ep
    xs = xf.reshape(ep, Tl, shape[-1])
    tok = None if token_ids is None else token_ids.reshape(ep, Tl)
    tv = None if token_valid is None else token_valid.reshape(ep, Tl)
    wr = params["router"]["w"]
    experts = params["experts"]

    def routed():
        cf = moe.capacity_factor if is_training else moe.eval_capacity_factor
        cap = min(R.capacity(Tl, E, moe.top_k, cf), Tl)
        bufs, infos, rrs = [], [], []
        for my in range(ep):
            rr = R.route(wr, xs[my], moe, generator=generator,
                         is_training=is_training,
                         token_ids=None if tok is None else tok[my])
            info = R.dispatch_info(rr, E, cap, valid=_token_valid_tk(
                None if tv is None else tv[my], moe.top_k))
            bufs.append(R.dispatch(xs[my], info, E, cap))
            infos.append(info)
            rrs.append(rr)
        # virtual dense wire: (ep, E, cap, d) -> (E, ep*cap, d) -> FFN -> back
        stacked = torch.stack(bufs)
        grouped = stacked.transpose(0, 1).reshape(E, ep * cap, -1)
        outs = _expert_ffn(experts, grouped, cfg).reshape(E, ep, cap, -1)
        outs = outs.transpose(0, 1)
        y = torch.cat([R.combine(outs[my], infos[my]) for my in range(ep)])
        aux = _mean_aux([_routed_aux(rr, info, moe)
                         for rr, info in zip(rrs, infos)])
        return y, aux

    def local():
        e_loc = E // ep
        ys, auxs = [], []
        for my in range(ep):
            ex_loc = {k: w[my * e_loc:(my + 1) * e_loc]
                      for k, w in experts.items()}
            y, aux = _local_shard(wr, ex_loc, xs[my], moe, cfg, generator,
                                  is_training,
                                  None if tok is None else tok[my], my, ep,
                                  token_valid=None if tv is None else tv[my])
            ys.append(y)
            auxs.append(aux)
        return torch.cat(ys), _mean_aux(auxs)

    def expert_drop():
        return torch.zeros_like(xf), _zero_aux(E, x.device)

    y, aux = _select_branch(moe, decision, routed, local, expert_drop)
    return y.reshape(shape), aux


def _select_branch(moe: MoEConfig, decision: Optional[bool],
                   routed: Callable, local: Callable, expert_drop: Callable):
    """Pick the routed / dropped branch from the host decision: None or
    False routes, True takes the dropped branch of the configured mode."""
    if decision is not None and not isinstance(decision, bool):
        raise TypeError("the Gating Dropout decision is a host bool, got "
                        f"{type(decision).__name__}")
    if not decision:
        return routed()
    if moe.gating_dropout.mode == "gate_expert_drop":
        return expert_drop()
    return local()


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              generator: Optional[torch.Generator] = None,
              decision: Optional[bool] = None, is_training: bool = True,
              token_ids: Optional[torch.Tensor] = None,
              token_valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict]:
    """Entry point used by the models; the execution path is chosen by
    ``cfg.moe.backend`` through the backend registry (core/backend.py).
    ``token_valid`` marks tokens of retired or empty serving slots: routed
    but never dispatched, so they take no expert capacity."""
    from repro_torch.core import backend as B
    fn = B.get_backend(B.resolve_backend(cfg.moe))
    return fn(params, x, cfg, generator=generator, decision=decision,
              is_training=is_training, token_ids=token_ids,
              token_valid=token_valid)
