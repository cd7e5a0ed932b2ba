"""Train-state checkpoints in the reference's ``.npz`` layout (port of
``repro/checkpoint/checkpoint.py``).

Layout: ``<dir>/step_<n>/arrays.npz`` + ``meta.json``, plus a
``<dir>/latest`` file naming the most recent step. Keys are the
"/"-joined tree paths (``params/decoder/0/p0/attn/wq``, ``opt/m/...``,
``opt/step``, ``step``); numpy has no bfloat16, so such leaves are stored
as uint16 bit patterns listed under ``dtypes`` in the meta. A checkpoint
written by either package restores into the other's train state. Integer
leaves (the host step counters) are stored as 0-d int32 arrays, as the
reference stores its device step counters.

Under a (data, model) group of more than one rank (``ctx``, a
``core.moe.ParallelContext``) a save gathers every expert leaf (its
parameters and Adam moments) over both axes, along the expert axis and,
in the tensor-parallel layout, along d_ff, so the file holds the full
arrays the reference's checkpoint holds; rank 0 writes it and every rank
waits until it is written. A restore under a group slices each full
expert array to the rank's block (``bridge.shard_experts``). A checkpoint
carries no mesh: one saved at any (d, m) in either layout restores at any
other whose blocks divide the expert count and d_ff.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import expert_tp_axis, shard_experts, tensor_to_numpy
from repro_torch.tree import flatten_with_paths, unflatten_paths


def _grouped(ctx) -> bool:
    return ctx is not None and ctx.world > 1


def gather_experts(tree: Any, ctx) -> Any:
    """``tree`` with every expert leaf gathered over all of ``ctx``'s
    ranks: the full arrays, on every rank. Rank r's block is shard
    ``r // tp``'s experts sliced to model index ``r % tp``'s d_ff in the
    tensor-parallel layout, shard r's whole experts under
    ``ep_on_model``."""
    from repro_torch.core.moe import is_expert_leaf
    out = {}
    for key, leaf in flatten_with_paths(tree).items():
        if torch.is_tensor(leaf) and is_expert_leaf(key):
            part = leaf.detach().contiguous()
            parts = [torch.empty_like(part) for _ in range(ctx.world)]
            dist.all_gather(parts, part, group=ctx.group)
            n = ctx.ffn_tp
            if n > 1:               # d_ff over each data index's model ranks
                axis = part.dim() + expert_tp_axis(key)
                parts = [torch.cat(parts[j * n:(j + 1) * n], dim=axis)
                         for j in range(ctx.dp)]
            leaf = torch.cat(parts, dim=part.dim() - 3)
        out[key] = leaf
    return unflatten_paths(out)


def _flatten(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in flatten_with_paths(tree).items():
        if isinstance(leaf, int):
            flat[key] = np.asarray(leaf, np.int32)
            continue
        flat[key], dt = tensor_to_numpy(leaf)
        if dt:
            dtypes[key] = dt
    return flat, dtypes


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra_meta: Optional[Dict] = None, ctx=None) -> str:
    """Writes ``tree`` as ``<ckpt_dir>/step_<step>``; under a group of more
    than one rank, its expert leaves gathered, by rank 0 alone, every rank
    returning once the files are written."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _grouped(ctx):
        tree = gather_experts(tree, ctx)
        if ctx.rank == 0:
            _write(ckpt_dir, d, step, tree, extra_meta)
        dist.barrier(group=ctx.group)
        return d
    _write(ckpt_dir, d, step, tree, extra_meta)
    return d


def _write(ckpt_dir: str, d: str, step: int, tree: Any,
           extra_meta: Optional[Dict]) -> None:
    os.makedirs(d, exist_ok=True)
    flat, dtypes = _flatten(tree)
    np.savez(os.path.join(d, "arrays.npz"), **flat)
    meta = {"step": step, "n_arrays": len(flat), "dtypes": dtypes}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(ckpt_dir, "latest"), "w") as f:
        f.write(f"step_{step:08d}")


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip().split("_")[-1])


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None, ctx=None) -> Tuple[Any, Dict]:
    """Restore into ``template``'s structure: each tensor leaf comes back
    with the template leaf's shape, dtype, device and ``requires_grad``;
    each int leaf as an int. Under a group of more than one rank the full
    expert arrays are sliced to this rank's block first."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    bf16 = {k for k, v in meta.get("dtypes", {}).items() if v == "bfloat16"}
    tmpl = flatten_with_paths(template)
    arrays = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, leaf in tmpl.items():
            arr = data[key]
            if isinstance(leaf, int):
                arrays[key] = int(arr)
                continue
            t = torch.from_numpy(np.asarray(arr, order="C"))   # 0-d stays 0-d
            arrays[key] = t.view(torch.int16).view(torch.bfloat16) if key in bf16 else t
    if _grouped(ctx):
        arrays = flatten_with_paths(shard_experts(unflatten_paths(arrays), ctx))
    out = {}
    for key, leaf in tmpl.items():
        t = arrays[key]
        if isinstance(leaf, int):
            out[key] = t
            continue
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint {tuple(t.shape)} vs "
                             f"{tuple(leaf.shape)}")
        out[key] = t.to(device=leaf.device, dtype=leaf.dtype) \
            .requires_grad_(leaf.requires_grad)
    return unflatten_paths(out), meta
