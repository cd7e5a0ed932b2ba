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
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import tensor_to_numpy
from repro_torch.tree import flatten_with_paths, unflatten_paths


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
                    extra_meta: Optional[Dict] = None) -> str:
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
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
    return d


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip().split("_")[-1])


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into ``template``'s structure: each tensor leaf comes back
    with the template leaf's shape, dtype, device and ``requires_grad``;
    each int leaf as an int."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    bf16 = {k for k, v in meta.get("dtypes", {}).items() if v == "bfloat16"}
    out = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, leaf in flatten_with_paths(template).items():
            arr = data[key]
            if isinstance(leaf, int):
                out[key] = int(arr)
                continue
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint {arr.shape} vs "
                                 f"{tuple(leaf.shape)}")
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if key in bf16:
                t = t.view(torch.int16).view(torch.bfloat16)
            out[key] = t.to(device=leaf.device, dtype=leaf.dtype) \
                .requires_grad_(leaf.requires_grad)
    return unflatten_paths(out), meta
