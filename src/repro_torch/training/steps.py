"""Train and eval steps (port of ``repro/training/steps.py``).

The Gating Dropout decision of a step is a host bool: eager PyTorch has no
traced branch, so the port runs the reference's ``host_cond`` strategy
only. ``decision=None`` draws the step's consensus bit on the host
(``core/gating_dropout.py``, bitwise JAX's). The MoE layers run through
the backend named by ``cfg.moe.backend`` (oracle / sharded / cuda /
cuda_fused).

Under a (data, model) context (``core.moe.ParallelContext``) every rank
takes the global batch and runs its data index's contiguous block of rows
(the reference's batch layout; the model ranks of a data index run the
same rows); the losses are the reference's global ones: the
cross-entropy divides by the data group's count of masked tokens and the
balance term is the group mean. Gradients of replicated leaves are the
same on every model rank (the MoE layer's model-axis functions see to
it) and are summed over the data group; an expert leaf's gradient
already holds every rank's contribution through the backward
all-to-all, and is never reduced.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.comm import COMM_KEYS
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.gating_dropout import drop_decision_host
from repro_torch.core.moe import ParallelContext, is_expert_leaf
from repro_torch.models.model import head_matrix, model_apply
from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.tree import flatten_with_paths, unflatten_paths

TrainState = Dict[str, Any]

# the reference's chunk for a scanned layer stack (steps.py:111-113); the
# port's configs keep its scan_layers=True default, so this is the rule
XENT_CHUNK = 512


def init_train_state(params, tc: TrainConfig) -> TrainState:
    """{"params", "opt", "step"}; the parameters are marked as requiring
    grad (in place). Step counters are host ints."""
    for p in flatten_with_paths(params).values():
        p.requires_grad_(True)
    return {"params": params, "opt": adam_init(params, tc), "step": 0}


def n_moe_layers(cfg: ModelConfig) -> int:
    if cfg.moe is None:
        return 0
    n = sum(1 for i in range(cfg.n_layers) if cfg.moe.is_moe_layer(i))
    if cfg.encdec is not None:
        n += sum(1 for i in range(cfg.encdec.n_encoder_layers)
                 if cfg.moe.is_moe_layer(i))
    return max(n, 1)


def xent_loss(logits: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor],
              denom: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean cross-entropy and accuracy, in f32; ``denom`` replaces
    the masked token count."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels[..., None])[..., 0]
    if mask is None:
        mask = torch.ones_like(ll)
    if denom is None:
        denom = mask.sum().clamp_min(1.0)
    loss = -(ll * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
    return loss, acc


def _chunk_stats(hx, head, lx, mx):
    logits = (hx.to(head.dtype) @ head).float()
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, lx[..., None])[..., 0]
    hit = (logits.argmax(-1) == lx) * mx
    return (ll * mx).sum(), hit.sum()


def chunked_xent(hidden: torch.Tensor, head: torch.Tensor,
                 labels: torch.Tensor, mask: Optional[torch.Tensor],
                 chunk: int = XENT_CHUNK,
                 denom: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without the (B, L, V) f32 logits at once: sequence
    chunks, each chunk's logits recomputed in the backward
    (``torch.utils.checkpoint``). Sequences up to 2 * chunk take the
    unchunked loss, as in the reference. ``denom`` replaces the masked
    token count the sums are divided by (the group's count, under expert
    parallelism)."""
    b, l, _ = hidden.shape
    if mask is None:
        mask = hidden.new_ones((b, l), dtype=torch.float32)
    if l <= 2 * chunk:
        logits = (hidden.to(head.dtype) @ head).float()
        return xent_loss(logits, labels, mask, denom)
    pad = (-l) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    ll_sum = hit_sum = 0.0
    for i in range(0, l + pad, chunk):
        s, h = checkpoint(_chunk_stats, hidden[:, i:i + chunk], head,
                          labels[:, i:i + chunk], mask[:, i:i + chunk],
                          use_reentrant=False)
        ll_sum = ll_sum + s
        hit_sum = hit_sum + h
    if denom is None:
        denom = mask.sum().clamp_min(1.0)
    return -ll_sum / denom, hit_sum / denom


def _grouped(ctx: Optional[ParallelContext]) -> bool:
    """Whether the step runs over a group of more than one rank (a group
    of one runs the ungrouped arithmetic, bit for bit)."""
    return ctx is not None and ctx.world > 1


def total_loss(params, batch: Dict, cfg: ModelConfig, *,
               generator: Optional[torch.Generator], decision,
               is_training: bool = True, frame: bool = True,
               ctx: Optional[ParallelContext] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics): chunked cross-entropy plus the MoE balance and
    router-z terms, each averaged over the MoE layers; ``comm_*`` are the
    transports' telemetry summed over the MoE layers of this forward.
    With ``cfg.mtp`` in training, plus 0.3 x the MTP head's cross-entropy
    against the labels rolled by -1 (metric ``mtp_xent``), masked where a
    label or the next one is masked and at the last column.

    Under a group ``batch`` holds this rank's rows and ``loss`` is this
    rank's share of the global loss (its token sums over the data group's
    token count, plus its 1/ep share of the group-mean aux terms), so the
    data group's gradients sum to the global loss's; the metrics are the
    global values."""
    hidden, aux = model_apply(params, batch, cfg, ctx=ctx, generator=generator,
                              decision=decision, is_training=is_training,
                              return_hidden=True)
    mask = batch.get("loss_mask")
    denom = None
    if _grouped(ctx):
        count = (mask.sum() if mask is not None
                 else hidden.new_tensor(float(hidden.shape[0] * hidden.shape[1])))
        denom = ctx.data_all_reduce(count.detach().float().reshape(1))[0].clamp_min(1.0)
    head = head_matrix(params, cfg)
    loss, acc = chunked_xent(hidden, head, batch["labels"], mask, denom=denom)
    xent = loss
    if denom is not None:
        xent, acc = ctx.data_all_reduce(torch.stack([loss.detach(), acc.detach()]))
    metrics = {"xent": xent, "acc": acc}
    total = xent                 # the global loss, reported under a group
    nmoe = n_moe_layers(cfg)
    if cfg.moe is not None:
        bal = aux["balance"] / nmoe
        zl = aux["router_z"] / nmoe
        loss = loss + cfg.moe.balance_coef * bal + cfg.moe.router_z_coef * zl
        total = (total + cfg.moe.balance_coef * bal.detach()
                 + cfg.moe.router_z_coef * zl.detach())
        metrics.update(balance=bal, router_z=zl,
                       dropped_frac=aux["dropped_frac"] / nmoe,
                       **{k: aux[k] for k in COMM_KEYS})
        if frame:
            metrics.update(expert_load=aux["load"] / nmoe,
                           router_entropy=aux["router_entropy"] / nmoe)
    if cfg.mtp and is_training and "mtp_hidden" in aux:
        labels2 = torch.roll(batch["labels"], -1, dims=1)
        m2 = (mask.float() if mask is not None
              else hidden.new_ones(labels2.shape, dtype=torch.float32))
        m2 = m2 * torch.roll(m2, -1, dims=1)
        m2[:, -1] = 0.0
        denom2 = None
        if _grouped(ctx):
            denom2 = ctx.data_all_reduce(m2.sum().reshape(1))[0].clamp_min(1.0)
        mtp_l, _ = chunked_xent(aux["mtp_hidden"], head, labels2, m2,
                                denom=denom2)
        loss = loss + 0.3 * mtp_l
        mtp_x = (mtp_l if denom2 is None
                 else ctx.data_all_reduce(mtp_l.detach().reshape(1))[0])
        total = total + 0.3 * mtp_x.detach()
        metrics["mtp_xent"] = mtp_x
    metrics["loss"] = loss if denom is None else total
    return loss, metrics


def step_generator(device, seed: int, step: int,
                   micro: Optional[int] = None) -> Optional[torch.Generator]:
    """The generator of a step (and microbatch) — the reference's
    fold_in(PRNGKey(seed), step) [then fold_in(., micro)]; it seeds each
    layer's router jitter. None on the meta device, which has no
    generator: a meta step (the dry run's) draws no jitter."""
    if torch.device(device).type == "meta":
        return None
    s = (seed * 1_000_003 + step) % (1 << 62)
    if micro is not None:
        s = (s * 1_000_003 + micro + 1) % (1 << 62)
    return torch.Generator(device=device).manual_seed(s)


def rank_rows(batch: Dict, ctx: Optional[ParallelContext]) -> Dict:
    """This rank's data index's contiguous block of the batch rows (all
    of them without a group)."""
    if not _grouped(ctx):
        return batch
    b = next(iter(batch.values())).shape[0]
    if b % ctx.dp:
        raise ValueError(f"batch {b} does not split over the data axis of {ctx.dp}")
    n = b // ctx.dp
    return {k: v[ctx.data * n:(ctx.data + 1) * n] for k, v in batch.items()}


def reduce_replicated(grads: List[torch.Tensor], keys: List[str],
                      ctx: Optional[ParallelContext]) -> List[torch.Tensor]:
    """Sum the gradients of the replicated leaves over the data group, in
    one all-reduce per dtype (the model ranks of a data index hold the
    same ones); expert leaves stay (the backward all-to-all already
    brought every rank's contribution to the expert's owner)."""
    if not _grouped(ctx) or ctx.dp == 1:
        return grads
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, key in enumerate(keys):
        if not is_expert_leaf(key):
            by_dtype.setdefault(grads[i].dtype, []).append(i)
    for idx in by_dtype.values():
        flat = ctx.data_all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]))
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = part.view_as(grads[i])
    return grads


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    ctx: Optional[ParallelContext] = None) -> Callable:
    """Returns train_step(state, batch, decision=None) -> (state, metrics).

    ``decision``: a host bool, or None to draw the step's consensus bit
    from (tc.seed, state["step"]). With ``tc.microbatches`` = k > 1 the
    batch is split into k along its leading axis; gradients and metrics
    are averaged. Parameters and moments are updated in place; metrics
    are detached device scalars except ``lr`` and ``gate_dropped`` (host
    floats) and the ``comm_*`` telemetry (host scalars). Under ``ctx``
    ``batch`` is the global batch (every rank gets the same one) and
    ``state`` this rank's: replicated leaves and its block of experts."""
    gd = cfg.moe.gating_dropout if cfg.moe is not None else None
    frame = tc.metrics_frame

    def grads_of(params, leaves: List[torch.Tensor], batch, generator,
                 decision):
        loss, metrics = total_loss(params, rank_rows(batch, ctx), cfg,
                                   generator=generator, decision=decision,
                                   frame=frame, ctx=ctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a parameter the step never reached (the MoE weights on a
        # Gate-Expert-Drop step) gets a zero gradient, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: Dict,
                   decision: Optional[bool] = None) -> Tuple[TrainState, Dict]:
        step = state["step"]
        params = state["params"]
        flat = flatten_with_paths(params)
        leaves = list(flat.values())
        device = leaves[0].device
        if decision is None and gd is not None and gd.enabled:
            decision = drop_decision_host(gd, tc.seed, step)
        k = tc.microbatches
        if k == 1:
            grads, metrics = grads_of(params, leaves, batch,
                                      step_generator(device, tc.seed, step),
                                      decision)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % k:
                raise ValueError(f"batch {b} does not split into {k} microbatches")
            grads, metrics = None, None
            for i in range(k):
                mb = {key: v[i * (b // k):(i + 1) * (b // k)]
                      for key, v in batch.items()}
                g, m = grads_of(params, leaves, mb,
                                step_generator(device, tc.seed, step, i),
                                decision)
                if grads is None:
                    grads, metrics = g, m
                else:
                    for acc, gi in zip(grads, g):
                        acc.add_(gi)
                    metrics = {key: metrics[key] + m[key] for key in metrics}
            grads = [g / k for g in grads]
            metrics = {key: v / k for key, v in metrics.items()}
        grads = reduce_replicated(grads, list(flat), ctx)
        grad_tree = unflatten_paths(dict(zip(flat, grads)))
        _, new_opt, opt_m = adam_update(grad_tree, state["opt"], params, tc,
                                        ctx=ctx)
        metrics.update(opt_m)
        if frame and cfg.moe is not None:
            metrics["gate_dropped"] = float(bool(decision))
        return {"params": params, "opt": new_opt, "step": step + 1}, metrics

    return train_step


def make_eval_step(cfg: ModelConfig,
                   ctx: Optional[ParallelContext] = None) -> Callable:
    """Returns eval_fn(params, batch) -> metrics: routed (no Gating
    Dropout), eval capacity, no gradients."""
    @torch.no_grad()
    def eval_fn(params, batch):
        _, metrics = total_loss(params, rank_rows(batch, ctx), cfg,
                                generator=None, decision=False,
                                is_training=False, ctx=ctx)
        return metrics
    return eval_fn
