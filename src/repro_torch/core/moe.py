"""Expert-parallel Mixture-of-Experts layer with Gating Dropout (port of
``repro/core/moe.py``).

Layout (the paper's): expert parallelism over the ranks of a
``torch.distributed`` group (the EP group is the data-parallel group, as
in Switch and DeepSpeed-MoE): rank r holds experts [r*E/ep, (r+1)*E/ep)
and a block of the batch rows; the router is replicated.

  * ``moe_oracle``  -- plain torch, ``ep`` *virtual* shards, the wire
                       emulated by the transport's permutes; the ground
                       truth.
  * ``moe_sharded`` -- one rank of a real group: the dispatch and combine
                       all-to-alls are the configured substrate's
                       collectives (``comm/substrate.py``). With
                       ``kernels`` the per-shard steps run the kernel
                       pipeline (the ``cuda`` backend) or, with no wire,
                       the fused kernel (``cuda_fused``).

Gating Dropout is a per-step decision taken on the host (a Python bool,
the same on every rank; eager PyTorch has no traced branch):

  routed step : route over all E experts -> dispatch -> all-to-all ->
                expert FFN -> all-to-all -> combine      (all-to-all paid)
  gate_drop   : route restricted to the local expert group -> local
                dispatch -> local expert FFN -> combine  (no all-to-all)
  gate_expert_drop : output = 0 (residual passthrough)   (no all-to-all, no FFN)

Aux dicts carry the transport's ``comm_*`` telemetry (host scalars; zero
on steps that move nothing).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.comm import CommEnv, comm_zero, make_transport
from repro_torch.comm.cost import ep_tier_groups, factored_ep
from repro_torch.configs.base import CommConfig, ModelConfig, MoEConfig
from repro_torch.core import router as R

Params = Dict[str, Any]


def is_expert_leaf(path: str) -> bool:
    """Whether the leaf at ``path`` ("/"-joined tree path) is an expert
    weight, of which a rank of the EP group holds its block along the
    expert axis (-3); every other leaf is replicated."""
    return "experts" in path.split("/")


class ParallelContext:
    """The expert-parallel group threaded through the model (the
    reference's mesh bundle): ``group`` a ``torch.distributed`` process
    group, ``rank`` this process's rank in it and ``ep`` its size. Active
    whenever a group is given, even a group of one rank, where no
    collective is issued. ``tier_groups`` builds the hierarchical
    substrates' subgroups on first use, on every rank in the same order."""

    def __init__(self, group=None, rank: int = 0, ep: int = 1):
        self.group, self.rank, self.ep = group, rank, ep
        self._tiers: Dict[int, Tuple[Any, Any]] = {}

    @property
    def active(self) -> bool:
        return self.group is not None

    def tier_groups(self, ep_inner: int) -> Tuple[Any, Any]:
        """(intra, inter): this rank's subgroup of ``ep_inner`` consecutive
        ranks and its subgroup strided by ``ep_inner`` (``ep_tier_groups``),
        None for a tier of one rank. ``dist.new_group`` is collective over
        the whole group: every rank creates every subgroup, in order."""
        gi, go = factored_ep(self.ep, ep_inner)
        if gi not in self._tiers:
            ranks = dist.get_process_group_ranks(self.group)
            mine = []
            for groups, size in zip(ep_tier_groups(self.ep, gi), (gi, go)):
                found = None
                for g in groups:
                    if size == 1:
                        continue
                    pg = dist.new_group([ranks[r] for r in g])
                    if self.rank in g:
                        found = pg
                mine.append(found)
            self._tiers[gi] = tuple(mine)
        return self._tiers[gi]

    def comm_env(self, comm: CommConfig) -> CommEnv:
        if not self.active:
            return CommEnv(ep=self.ep)
        intra = inter = None
        if comm.hierarchical and self.ep > 1:
            intra, inter = self.tier_groups(comm.ep_inner)
        return CommEnv(ep=self.ep, group=self.group, intra=intra, inter=inter)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the group, in place (nothing at ep = 1)."""
        if self.ep > 1:
            dist.all_reduce(t, group=self.group)
        return t


def shard_generator(generator: Optional[torch.Generator],
                    shard: int) -> Optional[torch.Generator]:
    """The router-jitter generator of shard ``shard`` (the reference folds
    the shard index into the key): shard 0 draws from ``generator``
    itself, so a one-rank group draws what the ungrouped path draws."""
    if generator is None or shard == 0:
        return generator
    seed = (generator.initial_seed() * 1_000_003 + 7_919 * shard) % (1 << 63)
    return torch.Generator(device=generator.device).manual_seed(seed)


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


def _expert_ffn(experts: Params, buf: torch.Tensor, cfg: ModelConfig,
                kernels: str = "") -> torch.Tensor:
    """Per-expert FFN on (E, C, d) buffers: plain einsums, or the
    grouped-matmul kernels (B1) with ``kernels``."""
    w_in = experts["w_in"]
    if kernels:
        from repro_torch.kernels import ops as K
        out = K.expert_ffn_op(buf.to(w_in.dtype), w_in, experts.get("w_gate"),
                              experts["w_out"], cfg.act)
        return out.to(buf.dtype)
    x = buf.to(w_in.dtype)
    h = torch.einsum("ecd,edf->ecf", x, w_in)
    if cfg.gated_mlp:
        g = torch.einsum("ecd,edf->ecf", x, experts["w_gate"])
        h = _act(g, cfg.act) * h
    else:
        h = _act(h, cfg.act)
    y = torch.einsum("ecf,efd->ecd", h, experts["w_out"])
    return y.to(buf.dtype)


def _routed_aux(rr: R.RouteResult, info: R.DispatchInfo, moe: MoEConfig,
                comm: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Aux dict of a routed step, shared by every backend; ``comm`` is
    the layer's transport telemetry (None: nothing on the wire)."""
    zero = rr.probs.new_zeros(())
    learned = moe.router_type != "hash"
    return {
        "balance": R.balance_loss(rr, moe) if learned else zero,
        "router_z": R.router_z_loss(rr) if learned else zero,
        "load": R.expert_load(rr, moe),
        "router_entropy": R.route_entropy(rr),
        "dropped_frac": 1.0 - info.keep.float().mean(),
        **(comm if comm is not None else comm_zero()),
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
            "dropped_frac": 1.0 - info.keep.float().mean(), **comm_zero()}


def _zero_aux(E: int, device=None) -> Dict[str, torch.Tensor]:
    zero = torch.zeros((), device=device)
    return {"balance": zero, "router_z": zero,
            "load": torch.zeros((E,), device=device),
            "router_entropy": zero, "dropped_frac": zero, **comm_zero()}


def _token_valid_tk(token_valid: Optional[torch.Tensor], k: int):
    """(T,) bool token validity -> (T, k) dispatch validity (or None)."""
    if token_valid is None:
        return None
    return token_valid.reshape(-1, 1).expand(token_valid.numel(), k)


def _pipeline(xf, info: R.DispatchInfo, experts: Params, n_experts: int,
              cap: int, cfg: ModelConfig, kernels: str,
              wire: Callable) -> torch.Tensor:
    """dispatch -> ``wire(buf, ffn)`` -> combine: plain (``kernels`` ""),
    the kernels B2, B1 per shard and B3 sharing one set of routing tables
    ("cuda"), or B4 on those tables ("cuda_fused": no buffer, so no
    wire)."""
    if kernels:
        from repro_torch.kernels import ops as K
        tables = K.routing_tables(info, n_experts, cap)
        if kernels == "cuda_fused":
            return K.fused_moe_op(xf, info, experts["w_in"], experts.get("w_gate"),
                                  experts["w_out"], n_experts, cap, cfg.act,
                                  tables=tables)
        buf = K.moe_dispatch_op(xf, info, n_experts, cap, tables=tables)
        out = wire(buf, lambda b: _expert_ffn(experts, b, cfg, kernels))
        return K.moe_combine_op(out, info, tables=tables)
    buf = R.dispatch(xf, info, n_experts, cap)               # (E, cap, d)
    return R.combine(wire(buf, lambda b: _expert_ffn(experts, b, cfg)), info)


def _routed_shard(wr, experts, xf, moe: MoEConfig, cfg: ModelConfig,
                  generator, is_training, token_ids, transport,
                  token_valid=None, kernels: str = ""):
    """Routed step on one shard: route -> dispatch -> wire -> FFN on this
    rank's E/ep experts over (E/ep, ep*cap, d) -> wire -> combine, the
    wire being the configured substrate's transport. ``token_valid``
    keeps tokens (retired serving slots) out of capacity competition."""
    T = xf.shape[0]
    E = moe.n_experts
    cf = moe.capacity_factor if is_training else moe.eval_capacity_factor
    cap = min(R.capacity(T, E, moe.top_k, cf), T)
    rr = R.route(wr, xf, moe, generator=generator, is_training=is_training,
                 token_ids=token_ids)
    info = R.dispatch_info(rr, E, cap,
                           valid=_token_valid_tk(token_valid, moe.top_k))
    comm_t = transport.telemetry(E, cap, xf.shape[-1], xf.element_size())
    y = _pipeline(xf, info, experts, E, cap, cfg, kernels, transport.pipelined)
    return y, _routed_aux(rr, info, moe, comm=comm_t)


def _local_shard(wr, experts_loc, xf, moe: MoEConfig, cfg: ModelConfig,
                 generator, is_training, token_ids, my_shard: int, ep: int,
                 token_valid=None, kernels: str = ""):
    """Gate-Drop local step: tokens stay on this shard, routed among the
    local expert group only; no collective."""
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
    y = _pipeline(xf, info, experts_loc, e_loc, cap, cfg, kernels,
                  lambda buf, ffn: ffn(buf))
    return y, _local_aux(rr, info, moe, T)


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
        transport = make_transport(moe.comm, CommEnv(ep=ep))
        bufs, infos, rrs = [], [], []
        for my in range(ep):
            rr = R.route(wr, xs[my], moe,
                         generator=shard_generator(generator, my),
                         is_training=is_training,
                         token_ids=None if tok is None else tok[my])
            info = R.dispatch_info(rr, E, cap, valid=_token_valid_tk(
                None if tv is None else tv[my], moe.top_k))
            bufs.append(R.dispatch(xs[my], info, E, cap))
            infos.append(info)
            rrs.append(rr)
        # virtual wire, one pipelined transaction:
        # (ep, E, cap, d) -> (E, ep*cap, d) -> FFN -> (ep, E, cap, d)
        outs = transport.vpipelined(torch.stack(bufs),
                                    lambda b: _expert_ffn(experts, b, cfg))
        y = torch.cat([R.combine(outs[my], infos[my]) for my in range(ep)])
        comm_t = transport.telemetry(E, cap, shape[-1], x.element_size())
        aux = _mean_aux([_routed_aux(rr, info, moe, comm=comm_t)
                         for rr, info in zip(rrs, infos)])
        return y, aux

    def local():
        e_loc = E // ep
        ys, auxs = [], []
        for my in range(ep):
            ex_loc = {k: w[my * e_loc:(my + 1) * e_loc]
                      for k, w in experts.items()}
            y, aux = _local_shard(wr, ex_loc, xs[my], moe, cfg,
                                  shard_generator(generator, my), is_training,
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


# ---------------------------------------------------------------------------
# one rank of a real group
# ---------------------------------------------------------------------------

def _group_mean(aux: Dict[str, torch.Tensor],
                ctx: ParallelContext) -> Dict[str, torch.Tensor]:
    """The aux dict's mean over the group (the reference's pmean), in one
    all-reduce. A differentiable entry keeps its value's mean but takes
    its gradient as ``entry / ep``: the step's loss is the sum of every
    rank's, so the group-mean balance term it holds once reaches each
    rank's router through its own 1/ep share. The ``comm_*`` telemetry is
    the same on every rank and stays as it is."""
    if ctx.ep == 1:
        return aux
    keys = [k for k in aux if not k.startswith("comm_")]
    flat = ctx.all_reduce(torch.cat([aux[k].detach().float().reshape(-1)
                                     for k in keys])) / ctx.ep
    out, off = dict(aux), 0
    for k in keys:
        v = aux[k]
        mean = flat[off:off + v.numel()].reshape(v.shape).to(v.dtype)
        off += v.numel()
        out[k] = v / ctx.ep + (mean - v.detach() / ctx.ep) if v.requires_grad \
            else mean
    return out


def moe_sharded(params: Params, x: torch.Tensor, cfg: ModelConfig,
                ctx: ParallelContext, *,
                generator: Optional[torch.Generator] = None,
                decision: Optional[bool] = None, is_training: bool = True,
                token_ids: Optional[torch.Tensor] = None,
                token_valid: Optional[torch.Tensor] = None,
                kernels: str = "") -> Tuple[torch.Tensor, Dict]:
    """The MoE layer on this rank of ``ctx``'s group, with real
    all-to-alls. x: this rank's tokens, (B_loc, L, d) or (T, d);
    ``params["experts"]`` this rank's E/ep experts
    (``bridge.shard_experts``); the router replicated. The jitter
    generator is folded with the rank (``shard_generator``), and the aux
    dict is the group mean. ``kernels`` "cuda" runs each shard's
    dispatch, FFN and combine on the kernels (B2, B1, B3), the routed and
    the Gate-Drop local branch alike; "cuda_fused" runs B4, which has no
    buffer to put on a wire, so only where the wire moves nothing. A
    group of one rank issues no collective."""
    moe = cfg.moe
    ep, my = ctx.ep, ctx.rank
    E = moe.n_experts
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    if E % ep:
        raise ValueError(f"{E} experts do not split over ep={ep}")
    experts = params["experts"]
    if experts["w_in"].shape[-3] != E // ep:
        raise ValueError(f"rank {my} holds {experts['w_in'].shape[-3]} experts, "
                         f"not E/ep = {E // ep}: shard them (bridge.shard_experts)")
    wr = params["router"]["w"]
    tok = None if token_ids is None else token_ids.reshape(-1)
    tv = None if token_valid is None else token_valid.reshape(-1)
    gen = shard_generator(generator, my)
    transport = make_transport(moe.comm, ctx.comm_env(moe.comm))
    if kernels == "cuda_fused" and not transport.identity:
        raise ValueError("B4 has no buffer to put on the wire: cuda_fused runs "
                         "only where the wire moves nothing")

    def routed():
        return _routed_shard(wr, experts, xf, moe, cfg, gen, is_training, tok,
                             transport, token_valid=tv, kernels=kernels)

    def local():
        return _local_shard(wr, experts, xf, moe, cfg, gen, is_training, tok,
                            my, ep, token_valid=tv, kernels=kernels)

    def expert_drop():
        return torch.zeros_like(xf), _zero_aux(E, x.device)

    y, aux = _select_branch(moe, decision, routed, local, expert_drop)
    return y.reshape(shape), _group_mean(aux, ctx)


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              ctx: Optional[ParallelContext] = None,
              generator: Optional[torch.Generator] = None,
              decision: Optional[bool] = None, is_training: bool = True,
              token_ids: Optional[torch.Tensor] = None,
              token_valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict]:
    """Entry point used by the models; the execution path is chosen by
    ``cfg.moe.backend`` through the backend registry (core/backend.py),
    ``auto`` taking ``sharded`` under an active ``ctx`` and the oracle
    otherwise. ``token_valid`` marks tokens of retired or empty serving
    slots: routed but never dispatched, so they take no expert
    capacity."""
    from repro_torch.core import backend as B
    fn = B.get_backend(B.resolve_backend(cfg.moe, ctx))
    return fn(params, x, cfg, ctx=ctx, generator=generator,
              decision=decision, is_training=is_training,
              token_ids=token_ids, token_valid=token_valid)
