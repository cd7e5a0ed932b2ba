"""Parameter bridge between the JAX reference and this package.

The reference's parameter trees are exchanged as numpy arrays keyed by
their "/"-joined tree path, the layout ``repro/checkpoint/checkpoint.py``
writes (``arrays.npz`` + ``meta.json``): numpy has no bfloat16, so such
leaves travel as uint16 bit patterns with "bfloat16" under their key in
``dtypes``. This package's trees use the same nesting, keys and stacked
layouts, so the conversion is leaf for leaf and bit exact both ways.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten_paths


def to_torch(flat: Dict[str, np.ndarray], device: Union[str, torch.device], *,
             dtypes: Optional[Dict[str, str]] = None) -> Any:
    """{path: array} (+ checkpoint ``dtypes``) -> parameter tree of tensors
    on ``device``, which the caller names: ``cuda`` needs a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to bridge to the CPU")
    dtypes = dtypes or {}
    leaves = {}
    for key, arr in flat.items():
        arr = np.asarray(arr, order="C")    # keeps a 0-d leaf 0-d
        if dtypes.get(key) == "bfloat16" or arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        leaves[key] = t.to(device)
    return unflatten_paths(leaves)


def tensor_to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """One leaf -> (array, "bfloat16" or None): a bfloat16 tensor becomes
    its uint16 bit patterns, as the checkpoint stores it."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def to_numpy(params: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Parameter tree -> ({path: array}, dtypes): bfloat16 leaves become
    uint16 bit patterns listed in ``dtypes``, as the checkpoint stores
    them."""
    flat, dtypes = {}, {}
    for key, t in flatten_with_paths(params).items():
        flat[key], dt = tensor_to_numpy(t)
        if dt:
            dtypes[key] = dt
    return flat, dtypes


def expert_tp_axis(key: str) -> int:
    """The axis of an expert leaf (weight or moment, "/"-joined path) that
    tensor parallelism slices: d_ff, the last axis of ``w_in`` and
    ``w_gate``, the one before it of ``w_out``."""
    return -2 if key.split("/")[-1] == "w_out" else -1


def shard_experts(params: Any, ctx) -> Any:
    """The tree this rank of ``ctx`` (a ``core.moe.ParallelContext``)
    holds: every expert leaf (``core.moe.is_expert_leaf``) sliced to its
    shard's block of E/ep experts along the expert axis (-3, after any
    stacking axes) and, in the tensor-parallel layout on a model axis,
    to its model index's 1/tp of d_ff (``expert_tp_axis``); every other
    leaf as it is (the reference's expert rules,
    ``parallel/sharding.py``). Every rank slicing the same full init
    starts a run from the model a one-rank run starts from."""
    from repro_torch.core.moe import is_expert_leaf
    if ctx is None or ctx.world == 1:
        return params
    out = {}
    for key, t in flatten_with_paths(params).items():
        if is_expert_leaf(key):
            t = _block(t, t.dim() - 3, ctx.shard, ctx.ep, key)
            if ctx.ffn_tp > 1:
                t = _block(t, t.dim() + expert_tp_axis(key), ctx.model, ctx.ffn_tp, key)
            t = t.contiguous()
        out[key] = t
    return unflatten_paths(out)


def _block(t, dim: int, i: int, n: int, key: str):
    if t.shape[dim] % n:
        raise ValueError(f"{key}: axis {dim} of {t.shape[dim]} does not split "
                         f"{n} ways")
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)
