"""The training step in plain PyTorch at float32 with TF32 off: the masked
mean cross-entropy of the decoder's labels plus the balance term, its
gradients by autograd, global-norm clipping and Adam (bias-corrected,
inverse-square-root schedule with linear warm-up), on the weights the
benchmark made.

Stochastic parts come from the run's seed by the model's own rules:
the Gate-Drop bit of a step (``gate_drop.dropped``) and the router jitter,
uniform in [1 - eps, 1 + eps], drawn in the activation type on the device
from a generator seeded per step, layer and expert shard:

  step  s = (seed * 1_000_003 + step) mod 2^62
  layer g = (s * 1_000_003 + layer) mod 2^63      (layers counted per stack)
  shard   = g for shard 0, else (g * 1_000_003 + 7_919 * shard) mod 2^63
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench.reference import gate_drop
from bench.reference import model as M


def jitter_seed(seed: int, step: int, layer: int, shard: int) -> int:
    s = (seed * 1_000_003 + step) % (1 << 62)
    g = (s * 1_000_003 + layer) % (1 << 63)
    return g if shard == 0 else (g * 1_000_003 + 7_919 * shard) % (1 << 63)


def noise_maker(c: Dict, seed: int, step: int, device):
    eps = c["moe"]["jitter_eps"]
    dt = getattr(torch, c["dtype"])

    def of(stack: str, layer: int):
        def noise(shard: int, shape):
            g = torch.Generator(device=device).manual_seed(
                jitter_seed(seed, step, layer, shard))
            return torch.empty(shape, dtype=dt, device=device).uniform_(
                1.0 - eps, 1.0 + eps, generator=g).float()
        return noise
    return of


def loss_of(flat, c, batch, *, seed: int, step: int, shard: int = 0, shards: int = 1,
            count=None, r=None, isolated: bool = False):
    """(loss, dropped) of one step on the rows of expert shard ``shard``:
    its masked log-likelihood over ``count`` (the global batch's masked
    tokens) plus its share of the balance term (the term is the mean over
    the shards). Summed over the shards, the step's loss."""
    gd = c["moe"]["gating_dropout"]
    dropped = gd["mode"] == "gate_drop" and gate_drop.dropped(seed, step, gd["rate"])
    h, bal = M.encdec_hidden(flat, c, batch, noise_of=noise_maker(c, seed, step, h_dev(flat)),
                             local=dropped, shard=shard, shards=shards, r=r,
                             isolated=isolated, checkpoint=True)
    mask = batch["loss_mask"]
    rows = max(1, HEAD_TOKENS // h.shape[1])
    ll = sum(torch.utils.checkpoint.checkpoint(
        _ll, h[i:i + rows], flat["lm_head"], batch["labels"][i:i + rows], mask[i:i + rows],
        use_reentrant=False) for i in range(0, h.shape[0], rows))
    count = mask.sum().clamp_min(1.0) if count is None else count
    xent = -ll / count
    return xent + c["moe"]["balance_coef"] * bal / (M.n_moe_layers(c) * shards), dropped


HEAD_TOKENS = 4096      # positions whose logits are held at once


def _ll(h, w, labels, mask):
    """The masked log-likelihood of ``labels`` under the head's logits."""
    logp = torch.log_softmax(h @ w, dim=-1)
    return (logp.gather(-1, labels[..., None])[..., 0] * mask).sum()


def h_dev(flat):
    return next(iter(flat.values())).device


def lr_at(step: int, t: Dict) -> float:
    """Learning rate at 1-based ``step`` (float32 arithmetic)."""
    f32 = np.float32
    s, w = f32(max(step, 1)), f32(max(t["warmup_steps"], 1))
    if t["schedule"] != "inverse_sqrt":
        raise ValueError(t["schedule"])
    return float(f32(t["lr"]) * min(s / w, np.sqrt(w / max(s, w))))


def run(flat: Dict[str, torch.Tensor], c: Dict, batches: List[Dict], *,
        seed: int, shards: int = 1, r=None, isolated: bool = False) -> Dict:
    """Train ``flat`` (updated in place) on ``batches``, one step each, the
    rows of a batch split into ``shards`` contiguous blocks (the expert
    shards: one a rank), whose gradients add up. Returns each step's loss
    and the clipped gradient's norm per leaf at the first step (the
    gradient as Adam takes it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = c["train"]
    keys = list(flat)
    leaves = [flat[k].requires_grad_(True) for k in keys]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    out = {"losses": [], "dropped": []}
    for step, batch in enumerate(batches):
        rows = next(iter(batch.values())).shape[0] // shards
        count = batch["loss_mask"].sum().clamp_min(1.0)
        loss, grads = 0.0, None
        for s in range(shards):
            block = {k: v[s * rows:(s + 1) * rows] for k, v in batch.items()}
            part, dropped = loss_of(flat, c, block, seed=seed, step=step, shard=s,
                                    shards=shards, count=count, r=r, isolated=isolated)
            gs = torch.autograd.grad(part, leaves, allow_unused=True)
            if grads is None:
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
            else:
                for acc, g in zip(grads, gs):
                    if g is not None:
                        acc.add_(g)
            loss = loss + part.detach()
        with torch.no_grad():
            norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
            gnorm = torch.linalg.vector_norm(norms)
            scale = torch.clamp(t["grad_clip"] / gnorm.clamp_min(1e-9), max=1.0)
            if step == 0:
                out["grad_norms"] = dict(zip(keys, (norms * scale).tolist()))
            n = step + 1
            lr = lr_at(n, t)
            bc1 = float(np.float32(1) - np.float32(t["b1"]) ** np.float32(n))
            bc2 = float(np.float32(1) - np.float32(t["b2"]) ** np.float32(n))
            for p, g, mi, vi in zip(leaves, grads, m, v):
                g = g * scale
                mi.mul_(t["b1"]).add_(g, alpha=1 - t["b1"])
                vi.mul_(t["b2"]).addcmul_(g, g, value=1 - t["b2"])
                p.sub_(lr * (mi / bc1) / ((vi / bc2).sqrt() + t["eps"])
                       + lr * t["weight_decay"] * p)
        out["losses"].append(float(loss.detach()))
        out["dropped"].append(dropped)
        del grads
    for p in leaves:
        p.requires_grad_(False)
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    against the larger of the reference leaf's norm and the median leaf's."""
    keys = keep if keep is not None else list(ref)
    med = float(np.median([ref[k] for k in ref]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[List[str]] = None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, keep).values(), default=0.0)


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keep: Optional[List[str]] = None) -> float:
    """The median leaf's gap (``leaf_gaps``): steady where one small leaf's
    gap swings from seed to seed."""
    return float(np.median(list(leaf_gaps(prog, ref, keep).values())))


def moved_leaves(grad_norms: Dict[str, float], floor: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is above ``floor`` of the median
    leaf's: the others move under Adam by round-off alone."""
    med = float(np.median(list(grad_norms.values())))
    return [k for k, g in grad_norms.items() if g > floor * med]
