"""Adam with global-norm clipping, decoupled weight decay and LR schedules
(port of ``repro/optim/adam.py``), as plain functions on parameter trees.

Paper settings (§4.1): Adam, beta1=0.9, beta2=0.99, lr=0.03 with 5000
warmup steps and an inverse-square-root decay (Raffel et al., 2019).
``moment_dtype="bfloat16"`` halves optimizer memory for the huge archs.

The step count lives on the host (a Python int), so the schedule and the
bias corrections are host f32 scalars: the same float32 arithmetic the
reference runs on the device, with no device-to-host sync. Unlike the
reference, which returns new trees, ``adam_update`` updates parameters and
moments IN PLACE: a second copy of parameters and moments would need 30 GB
more for zcode-m3-base.

Under an expert-parallel group the global-norm clip counts each
replicated leaf once and sums the squares of the expert shards over the
group, so every rank clips by the norm of the whole model and the
replicated weights stay equal across ranks.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import flatten_with_paths, tree_map

Params = Any
OptState = Dict[str, Any]

_SLICE = 1 << 27      # elements per update slice (0.5 GB of f32)


def schedule(step: int, tc: TrainConfig) -> float:
    """Learning rate at (1-based) ``step``, computed in float32."""
    f32 = np.float32
    s = f32(max(step, 1))
    w = f32(max(tc.warmup_steps, 1))
    lr = f32(tc.lr)
    if tc.schedule == "inverse_sqrt":
        warm = s / w
        decay = np.sqrt(w / max(s, w))
        return float(lr * min(warm, decay))
    if tc.schedule == "cosine":
        warm = min(s / w, f32(1.0))
        t = min(max((s - w) / f32(max(tc.steps - w, 1)), f32(0.0)), f32(1.0))
        return float(lr * warm * (f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t))))
    return float(lr)


def adam_init(params: Params, tc: TrainConfig) -> OptState:
    mdt = getattr(torch, tc.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": 0}


def global_norm(tree: Params, ctx=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, on the device.
    Under a group of more than one rank (``ctx``), the expert leaves' sum
    of squares is summed over the group; replicated leaves count once."""
    flat = flatten_with_paths(tree)
    if ctx is None or ctx.ep == 1:
        norms = [torch.linalg.vector_norm(leaf.float()) for leaf in flat.values()]
        return torch.linalg.vector_norm(torch.stack(norms))
    from repro_torch.core.moe import is_expert_leaf
    sq = torch.zeros(2, dtype=torch.float32, device=next(iter(flat.values())).device)
    for key, leaf in flat.items():
        sq[int(is_expert_leaf(key))] += torch.linalg.vector_norm(leaf.float()) ** 2
    shards = ctx.all_reduce(sq[1:].clone())
    return torch.sqrt(sq[0] + shards[0])


@torch.no_grad()
def adam_update(grads: Params, opt: OptState, params: Params,
                tc: TrainConfig, ctx=None) -> Tuple[Params, OptState, Dict]:
    """One Adam step; returns (params, opt, {"lr", "grad_norm"}) with
    ``params`` and ``opt``'s moments updated in place. ``lr`` is a host
    float, ``grad_norm`` a device scalar (the whole model's norm under an
    expert-parallel ``ctx``)."""
    step = opt["step"] + 1
    lr = schedule(step, tc)
    gnorm = global_norm(grads, ctx)
    scale = None
    if tc.grad_clip > 0:
        scale = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    f32 = np.float32
    b1, b2 = tc.b1, tc.b2
    bc1 = float(f32(1.0) - f32(b1) ** f32(step))
    bc2 = float(f32(1.0) - f32(b2) ** f32(step))
    lr_wd = float(f32(lr) * f32(tc.weight_decay))
    flat_p = flatten_with_paths(params)
    flat_g = flatten_with_paths(grads)
    flat_m = flatten_with_paths(opt["m"])
    flat_v = flatten_with_paths(opt["v"])
    for key, p in flat_p.items():
        leaf = (p, flat_g[key], flat_m[key], flat_v[key])
        # a stacked leaf (the encoder's expert weights: 3.2 GB) is updated
        # in slices along its first axis, so the f32 temporaries stay small
        rows = max(1, _SLICE // max(p[0].numel(), 1)) if p.dim() else 0
        for ps, gs, ms, vs in (zip(*(t.split(rows) for t in leaf)) if rows
                               else [leaf]):
            gf = gs.float() if scale is None else gs.float() * scale
            mn = b1 * ms.float() + (1 - b1) * gf
            vn = b2 * vs.float() + (1 - b2) * gf * gf
            delta = lr * (mn / bc1) / ((vn / bc2).sqrt() + tc.eps)
            if tc.weight_decay > 0:
                delta = delta + lr_wd * ps.float()
            ps.copy_(ps.float() - delta)
            ms.copy_(mn)
            vs.copy_(vn)
    return params, {"m": opt["m"], "v": opt["v"], "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
