"""Expert-parallel Mixture-of-Experts layer with Gating Dropout (port of
``repro/core/moe.py``).

Layout (the paper's): expert parallelism over the data axis of a
(data, model) mesh of ``torch.distributed`` ranks (the EP group is the
data-parallel group, as in Switch and DeepSpeed-MoE): shard s holds
experts [s*E/ep, (s+1)*E/ep) and a block of the batch rows; the router
is replicated. On a model axis m > 1 each expert's d_ff is sliced over
the model group and the FFN's partial outputs summed over it (tensor
parallelism, the paper's footnote 1), or, with ``MoEConfig.ep_on_model``,
the experts spread whole over data x model and the layer's tokens split
along the sequence over the model group (``ParallelContext``).

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
    """The process groups threaded through the model (the reference's mesh
    bundle) on a ``dp`` x ``tp`` (data, model) mesh of ranks: ``group``
    holds all of them, and rank r has data index r // tp and model index
    r % tp, so the tp ranks of a model group are consecutive.
    ``data_group`` holds the ranks of this rank's model index,
    ``model_group`` those of its data index (None for a group of one).
    Active whenever a group is given, even a group of one rank, where no
    collective is issued.

    The experts' layout on a model axis tp > 1 (``MoEConfig.ep_on_model``,
    fixed here):

      * tensor parallelism (default): expert parallelism over the data
        group (``ep`` = dp, the shard index the data index); each rank
        holds its shard's E/dp experts, sliced to its 1/tp of every
        expert's d_ff, and the FFN's partial outputs are summed over the
        model group;
      * ``ep_on_model``: expert parallelism over the whole group (``ep`` =
        dp * tp, the shard index the rank); each rank holds E/(dp*tp)
        whole experts and the layer's tokens are split along the sequence
        over the model group.

    ``tier_groups`` builds the hierarchical substrates' subgroups on first
    use, on every rank in the same order."""

    def __init__(self, group=None, rank: int = 0, dp: int = 1, tp: int = 1, *,
                 data_group=None, model_group=None, ep_on_model: bool = False):
        self.group, self.rank, self.dp, self.tp = group, rank, dp, tp
        self.data, self.model = divmod(rank, tp)
        # on a one-dimensional mesh the whole group is the axis's group
        self.data_group = (group if tp == 1 else data_group) if dp > 1 else None
        self.model_group = (group if dp == 1 else model_group) if tp > 1 else None
        self.ep_on_model = bool(ep_on_model) and tp > 1
        self._tiers: Dict[int, Tuple[Any, Any]] = {}

    @property
    def active(self) -> bool:
        return self.group is not None

    @property
    def world(self) -> int:
        return self.dp * self.tp

    @property
    def ep(self) -> int:
        """The expert-parallel group's size: dp, or dp * tp under
        ``ep_on_model``."""
        return self.world if self.ep_on_model else self.dp

    @property
    def shard(self) -> int:
        """This rank's index in the expert-parallel group: the data index,
        or the rank under ``ep_on_model``."""
        return self.rank if self.ep_on_model else self.data

    @property
    def ffn_tp(self) -> int:
        """Ways every expert's d_ff is sliced: tp, or 1 under
        ``ep_on_model``."""
        return 1 if self.ep_on_model else self.tp

    @property
    def layout(self) -> str:
        return "ep_on_model" if self.ep_on_model else "tensor-parallel"

    def with_layout(self, ep_on_model: bool) -> "ParallelContext":
        """The same groups under the other experts' layout."""
        return ParallelContext(self.group, self.rank, self.dp, self.tp,
                               data_group=self.data_group,
                               model_group=self.model_group,
                               ep_on_model=ep_on_model)

    def _ep_groups(self):
        """Every expert-parallel group as world ranks, in one order on
        every rank: the tp data groups, or the whole group."""
        if self.ep_on_model or self.tp == 1:
            return [list(range(self.world))]
        return [[j * self.tp + k for j in range(self.dp)] for k in range(self.tp)]

    def tier_groups(self, ep_inner: int) -> Tuple[Any, Any]:
        """(intra, inter): this rank's subgroup of ``ep_inner`` consecutive
        members of its expert-parallel group and its subgroup strided by
        ``ep_inner`` (``ep_tier_groups``), None for a tier of one rank.
        ``dist.new_group`` is collective over the whole group: every rank
        creates every subgroup of every expert-parallel group, in order."""
        gi, go = factored_ep(self.ep, ep_inner)
        if gi not in self._tiers:
            mine = [None, None]
            for ranks in self._ep_groups():
                for t, (groups, size) in enumerate(zip(ep_tier_groups(self.ep, gi),
                                                       (gi, go))):
                    if size == 1:
                        continue
                    for g in groups:
                        members = [ranks[r] for r in g]
                        pg = dist.new_group(members)
                        if self.rank in members:
                            mine[t] = pg
            self._tiers[gi] = tuple(mine)
        return self._tiers[gi]

    def comm_env(self, comm: CommConfig) -> CommEnv:
        """The transports' environment: the expert-parallel group and, for
        the hierarchical substrates, its tiers; under ``ep_on_model`` the
        tiers are the model group (intra) and the data group (inter),
        whatever ``comm.ep_inner`` says."""
        if not self.active:
            return CommEnv(ep=self.ep)
        if self.ep_on_model:
            if not comm.hierarchical:
                return CommEnv(ep=self.ep, group=self.group)
            return CommEnv(ep=self.ep, group=self.group, intra=self.model_group,
                           inter=self.data_group, inner_size=self.tp)
        intra = inter = None
        if comm.hierarchical and self.ep > 1:
            intra, inter = self.tier_groups(comm.ep_inner)
        return CommEnv(ep=self.ep, group=self.data_group, intra=intra, inter=inter)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the whole group, in place (nothing at one
        rank)."""
        if self.world > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def data_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the data group, in place (nothing at dp = 1)."""
        if self.dp > 1:
            dist.all_reduce(t, group=self.data_group)
        return t

    def model_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the model group, in place (nothing at tp = 1)."""
        if self.tp > 1:
            dist.all_reduce(t, group=self.model_group)
        return t

    def model_all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's ``t``s concatenated along ``dim`` in model
        index order."""
        return _all_gather(t, dim, self.model_group, self.tp)

    def data_all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The data group's ``t``s concatenated along ``dim`` in data index
        order."""
        return _all_gather(t, dim, self.data_group, self.dp)


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _SumOverModelBackward(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group. Placed
    where a value replicated over the model group enters a computation
    that each model rank runs on its own part (the expert FFN on its d_ff
    slice, the router on its tokens): the gradient of the replicated
    value is the sum of the parts'."""

    @staticmethod
    def forward(ctx, x, pctx):
        ctx.pctx = pctx
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.pctx.model_all_reduce(g.clone(memory_format=torch.contiguous_format)), None


class _SumOverModel(torch.autograd.Function):
    """The FFN's partial outputs summed over the model group; identity for
    the gradient, which is the same on every model rank (the layers after
    it are replicated over the model group)."""

    @staticmethod
    def forward(ctx, y, pctx):
        return pctx.model_all_reduce(y.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitSequence(torch.autograd.Function):
    """This model rank's slice of the positions (axis -2); the gradient
    gathered over the model group, so the replicated layers before the
    MoE layer see the whole sequence's gradient on every model rank."""

    @staticmethod
    def forward(ctx, x, pctx):
        ctx.pctx = pctx
        n = x.shape[-2] // pctx.tp
        return x.narrow(x.dim() - 2, pctx.model * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.pctx.model_all_gather(g, g.dim() - 2), None


class _GatherSequence(torch.autograd.Function):
    """The model group's slices gathered back along the positions (axis
    -2); the gradient is this rank's slice of the whole sequence's, which
    every model rank holds alike."""

    @staticmethod
    def forward(ctx, y, pctx):
        ctx.pctx = pctx
        return pctx.model_all_gather(y, y.dim() - 2)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-2] // ctx.pctx.tp
        return g.narrow(g.dim() - 2, ctx.pctx.model * n, n).contiguous(), None


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
                kernels: str = "", tp: Optional[ParallelContext] = None
                ) -> torch.Tensor:
    """Per-expert FFN on (E, C, d) buffers: plain einsums, or the
    grouped-matmul kernels (B1) with ``kernels``. Under ``tp`` (a context
    of the tensor-parallel layout) the experts hold this rank's slice of
    d_ff, and the partial outputs are summed over the model group (the
    paper's footnote-1 tensor slicing; the reference's ``psum`` and its
    transpose)."""
    w_in = experts["w_in"]
    x = buf.to(w_in.dtype)
    if tp is not None:
        x = _SumOverModelBackward.apply(x, tp)
    if kernels:
        from repro_torch.kernels import ops as K
        y = K.expert_ffn_op(x, w_in, experts.get("w_gate"), experts["w_out"], cfg.act)
    else:
        h = torch.einsum("ecd,edf->ecf", x, w_in)
        if cfg.gated_mlp:
            g = torch.einsum("ecd,edf->ecf", x, experts["w_gate"])
            h = _act(g, cfg.act) * h
        else:
            h = _act(h, cfg.act)
        y = torch.einsum("ecf,efd->ecd", h, experts["w_out"])
    if tp is not None:
        y = _SumOverModel.apply(y, tp)
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
              wire: Callable, tp: Optional[ParallelContext] = None) -> torch.Tensor:
    """dispatch -> ``wire(buf, ffn)`` -> combine: plain (``kernels`` ""),
    the kernels B2, B1 per shard and B3 sharing one set of routing tables
    ("cuda"), or B4 on those tables ("cuda_fused": no buffer, so no
    wire, and no model axis); ``tp`` as in ``_expert_ffn``."""
    if kernels:
        from repro_torch.kernels import ops as K
        tables = K.routing_tables(info, n_experts, cap)
        if kernels == "cuda_fused":
            return K.fused_moe_op(xf, info, experts["w_in"], experts.get("w_gate"),
                                  experts["w_out"], n_experts, cap, cfg.act,
                                  tables=tables)
        buf = K.moe_dispatch_op(xf, info, n_experts, cap, tables=tables)
        out = wire(buf, lambda b: _expert_ffn(experts, b, cfg, kernels, tp))
        return K.moe_combine_op(out, info, tables=tables)
    buf = R.dispatch(xf, info, n_experts, cap)               # (E, cap, d)
    return R.combine(wire(buf, lambda b: _expert_ffn(experts, b, cfg, tp=tp)), info)


def _routed_shard(wr, experts, xf, moe: MoEConfig, cfg: ModelConfig,
                  generator, is_training, token_ids, transport,
                  token_valid=None, kernels: str = "",
                  tp: Optional[ParallelContext] = None):
    """Routed step on one shard: route -> dispatch -> wire -> FFN on this
    rank's E/ep experts over (E/ep, ep*cap, d) -> wire -> combine, the
    wire being the configured substrate's transport. ``token_valid``
    keeps tokens (retired serving slots) out of capacity competition;
    ``tp`` as in ``_expert_ffn``."""
    T = xf.shape[0]
    E = moe.n_experts
    cf = moe.capacity_factor if is_training else moe.eval_capacity_factor
    cap = min(R.capacity(T, E, moe.top_k, cf), T)
    rr = R.route(wr, xf, moe, generator=generator, is_training=is_training,
                 token_ids=token_ids)
    info = R.dispatch_info(rr, E, cap,
                           valid=_token_valid_tk(token_valid, moe.top_k))
    comm_t = transport.telemetry(E, cap, xf.shape[-1], xf.element_size())
    y = _pipeline(xf, info, experts, E, cap, cfg, kernels, transport.pipelined, tp)
    return y, _routed_aux(rr, info, moe, comm=comm_t)


def _local_shard(wr, experts_loc, xf, moe: MoEConfig, cfg: ModelConfig,
                 generator, is_training, token_ids, my_shard: int, ep: int,
                 token_valid=None, kernels: str = "",
                 tp: Optional[ParallelContext] = None):
    """Gate-Drop local step: tokens stay on this shard, routed among the
    local expert group only; no all-to-all (under ``tp`` the FFN's
    partial outputs are still summed over the model group)."""
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
                  lambda buf, ffn: ffn(buf), tp)
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
    """The aux dict's mean over the whole group (the reference's pmean over
    every mesh axis), in one all-reduce. A differentiable entry keeps its
    value's mean but takes its gradient as ``entry / ep``: the step's loss
    is the sum of every expert-parallel shard's, so the group-mean balance
    term it holds once reaches each shard's router through its own 1/ep
    share (the model ranks of a tensor-parallel shard hold the same term
    and the same gradient). The ``comm_*`` telemetry is the same on every
    rank and stays as it is."""
    if ctx.world == 1:
        return aux
    keys = [k for k in aux if not k.startswith("comm_")]
    flat = ctx.all_reduce(torch.cat([aux[k].detach().float().reshape(-1)
                                     for k in keys])) / ctx.world
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
    ``params["experts"]`` this rank's block of experts in the context's
    layout (``bridge.shard_experts``); the router replicated. The jitter
    generator is folded with the shard index (``shard_generator``; under
    tensor parallelism the data index, so the model ranks of a shard route
    alike), and the aux dict is the group mean. Under ``ep_on_model`` the
    layer runs on this model rank's slice of the positions and gathers the
    output back. ``kernels`` "cuda" runs each shard's dispatch, FFN and
    combine on the kernels (B2, B1, B3), the routed and the Gate-Drop
    local branch alike; "cuda_fused" runs B4, which has no buffer to put
    on a wire, so only where the wire moves nothing. A group of one rank
    issues no collective."""
    moe = cfg.moe
    E = moe.n_experts
    if ctx.tp > 1 and moe.ep_on_model != ctx.ep_on_model:
        raise ValueError(f"moe.ep_on_model={moe.ep_on_model} on a group laid out "
                         f"{ctx.layout}: build the group with the config's layout")
    ep, my = ctx.ep, ctx.shard
    if E % ep:
        raise ValueError(f"{ctx.layout} layout: {E} experts do not split over "
                         f"ep={ep}")
    split = ctx.ep_on_model
    if split and x.shape[-2] % ctx.tp:
        raise ValueError(f"ep_on_model layout: {x.shape[-2]} positions do not split "
                         f"over the model axis of {ctx.tp} (decoding runs one "
                         "position a step: generate under the tensor-parallel layout)")
    experts = params["experts"]
    f_loc = moe.d_ff(cfg.d_ff) // ctx.ffn_tp
    if experts["w_in"].shape[-3] != E // ep or experts["w_in"].shape[-1] != f_loc:
        raise ValueError(f"rank {ctx.rank} holds experts of shape "
                         f"{tuple(experts['w_in'].shape[-3:])}, not E/ep = {E // ep} "
                         f"with d_ff {f_loc}: shard them (bridge.shard_experts)")
    wr = params["router"]["w"]
    if split:
        n = x.shape[-2] // ctx.tp
        x = _SplitSequence.apply(x, ctx)
        token_ids, token_valid = (
            None if t is None else t.narrow(t.dim() - 1, ctx.model * n, n)
            for t in (token_ids, token_valid))
        wr = _SumOverModelBackward.apply(wr, ctx)
    tp = ctx if ctx.tp > 1 and not split else None
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    tok = None if token_ids is None else token_ids.reshape(-1)
    tv = None if token_valid is None else token_valid.reshape(-1)
    gen = shard_generator(generator, my)
    transport = make_transport(moe.comm, ctx.comm_env(moe.comm))
    if kernels == "cuda_fused" and not transport.identity:
        raise ValueError("B4 has no buffer to put on the wire: cuda_fused runs "
                         "only where the wire moves nothing")

    def routed():
        return _routed_shard(wr, experts, xf, moe, cfg, gen, is_training, tok,
                             transport, token_valid=tv, kernels=kernels, tp=tp)

    def local():
        return _local_shard(wr, experts, xf, moe, cfg, gen, is_training, tok,
                            my, ep, token_valid=tv, kernels=kernels, tp=tp)

    def expert_drop():
        return torch.zeros_like(xf), _zero_aux(E, x.device)

    y, aux = _select_branch(moe, decision, routed, local, expert_drop)
    y = y.reshape(shape)
    if split:
        y = _GatherSequence.apply(y, ctx)
    return y, _group_mean(aux, ctx)


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
