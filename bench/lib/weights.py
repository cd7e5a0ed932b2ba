"""Seeded weights, made by the benchmark on the device and handed to both
the program and the plain reference.

The layout (leaf paths and shapes) is the program's input format; the
values are the benchmark's own: one flat f32 buffer drawn N(0, 1) from a
``torch.Generator`` on the device in a few large calls, each leaf a view
of it scaled by its own rule. Drawing again from the same seed gives the
same bits, so the reference can remake the initial weights after the
program has updated its own in place.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

CHUNK = 1 << 28          # elements per draw (1 GiB of f32)

Layout = List[Tuple[str, Tuple[int, ...]]]


def init_rule(path: str, shape: Sequence[int], n_layers: int):
    """"ones", "zeros" or the standard deviation of the leaf at ``path``:
    N(0, 1/fan_in), the output projections of attention and of the dense
    FFN further scaled by (2 n_layers)^-1/2."""
    parts = path.split("/")
    name, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if name == "scale":
        return "ones"
    if name == "bias":
        return "zeros"
    out_scale = (2 * max(n_layers, 1)) ** -0.5
    if path == "embed":
        return shape[-1] ** -0.5
    if name in ("wq", "wk", "wv"):
        return shape[-3] ** -0.5
    if name == "wo":
        return (shape[-3] * shape[-2]) ** -0.5 * out_scale
    if name in ("w_in", "w_gate", "w", "lm_head"):
        return shape[-2] ** -0.5
    if name == "w_out":
        return shape[-2] ** -0.5 * (out_scale if parent == "ffn" else 1.0)
    raise KeyError(f"no init rule for {path}")


def numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def make(layout: Layout, seed: int, device, n_layers: int,
         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{path: leaf} on ``device``, every leaf a view of one buffer."""
    total = sum(numel(s) for _, s in layout)
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for at in range(0, total, CHUNK):
        buf[at:at + CHUNK].normal_(generator=gen)
    out, at = {}, 0
    for path, shape in layout:
        n = numel(shape)
        leaf = buf[at:at + n].view(tuple(shape))
        at += n
        rule = init_rule(path, shape, n_layers)
        if rule == "ones":
            leaf.fill_(1.0)
        elif rule == "zeros":
            leaf.zero_()
        else:
            leaf.mul_(rule)
        out[path] = leaf
    return out
