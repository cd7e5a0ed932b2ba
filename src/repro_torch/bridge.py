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
        arr = np.ascontiguousarray(arr)
        if dtypes.get(key) == "bfloat16" or arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        leaves[key] = t.to(device)
    return unflatten_paths(leaves)


def to_numpy(params: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Parameter tree -> ({path: array}, dtypes): bfloat16 leaves become
    uint16 bit patterns listed in ``dtypes``, as the checkpoint stores
    them."""
    flat, dtypes = {}, {}
    for key, t in flatten_with_paths(params).items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            dtypes[key] = "bfloat16"
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    return flat, dtypes
