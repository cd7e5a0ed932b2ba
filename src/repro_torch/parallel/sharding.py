"""Partition-spec rules for parameters, optimizer state, batches and caches
(port of ``repro/parallel/sharding.py``, rule for rule).

Axes (the reference's DESIGN.md §4):
  data  -- batch sharding AND expert parallelism (EP group == DP group)
  model -- tensor parallelism (heads, d_ff, vocab)
  pod   -- extra pure data parallelism (multi-pod)

Rules are name-based over the "/"-joined tree paths of the port's inits,
which are the reference's pytree paths (``bridge.py``). A dimension is
sharded over an axis only when divisible by its size; otherwise it is
replicated on that axis (keeps every (arch x mesh) combination valid, e.g.
hymba's 25 heads on a 16-way model axis).

A spec is a plain tuple with one entry per dimension of its leaf: None
(replicated), an axis name, or a tuple of axis names (sharded over their
product). The rules read a mesh's axis names and sizes alone
(``launch/mesh.py::MeshShape``). ``shard_shape`` and ``shard_bytes`` give
one leaf's shard on a mesh; ``tree_bytes`` a tree's bytes per device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import EP_AXIS, TP_AXIS, MeshShape
from repro_torch.tree import flatten_with_paths

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]
Specs = Dict[str, Spec]


def axis_size(mesh: MeshShape, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _pad(spec: Tuple[Axis, ...], ndim: int) -> Spec:
    """A spec of ``ndim`` entries, trailing dimensions replicated; an entry
    of one axis is its name (as ``PartitionSpec`` normalizes it)."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dimensions")
    spec = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in spec)
    return spec + (None,) * (ndim - len(spec))


class SpecBuilder:
    def __init__(self, cfg: ModelConfig, mesh: MeshShape):
        self.cfg = cfg
        self.mesh = mesh
        self.tp = TP_AXIS if TP_AXIS in mesh.axis_names else None
        self.ep = EP_AXIS
        self.dp = mesh.dp_axes  # ("pod", "data") or ("data",)

    def div(self, axis: Axis, size: int) -> Axis:
        """axis if it divides size, else None."""
        if axis is None:
            return None
        return axis if size % axis_size(self.mesh, axis) == 0 else None

    def fsdp(self, size: int) -> Axis:
        if not self.cfg.fsdp:
            return None
        return self.div(self.ep, size)

    # ---- parameter rules ---------------------------------------------------
    # keyed by (leaf name, in experts?); each rule states its BASE ndim so a
    # stacked (per-segment) leaf with one extra leading repeats dim is told
    # apart (expert w_in (E, d, f) against dense w_in (d, f))
    def _rule(self, name: str, in_experts: bool
              ) -> Optional[Tuple[int, Callable[[Tuple[int, ...]], Spec]]]:
        b, tp = self, self.tp
        if in_experts:
            if self.cfg.moe is not None and self.cfg.moe.ep_on_model \
                    and tp is not None:
                eaxes = (self.ep, tp)   # EP over data x model, no TP
                if name in ("w_in", "w_gate", "w_out"):
                    return 3, lambda s: (b.div(eaxes, s[0]), None, None)
                return None
            if name in ("w_in", "w_gate"):
                return 3, lambda s: (b.div(b.ep, s[0]), None, b.div(tp, s[2]))
            if name == "w_out":
                return 3, lambda s: (b.div(b.ep, s[0]), b.div(tp, s[1]), None)
            return None
        in_tp = lambda s: (b.fsdp(s[0]), b.div(tp, s[1]))  # noqa: E731
        table = {
            "wq": (3, lambda s: (b.fsdp(s[0]), b.div(tp, s[1]), None)),
            "wk": (3, lambda s: (b.fsdp(s[0]), b.div(tp, s[1]), None)),
            "wv": (3, lambda s: (b.fsdp(s[0]), b.div(tp, s[1]), None)),
            "wo": (3, lambda s: (b.div(tp, s[0]), None, b.fsdp(s[2]))),
            "w_in": (2, in_tp),
            "w_gate": (2, in_tp),
            "w_out": (2, lambda s: (b.div(tp, s[0]), b.fsdp(s[1]))),
            "w_dq": (2, in_tp),
            "w_uq": (3, lambda s: (None, b.div(tp, s[1]), None)),
            "w_dkv": (2, lambda s: (b.fsdp(s[0]), None)),
            "w_ukv": (3, lambda s: (None, b.div(tp, s[1]), None)),
            "w_z": (2, in_tp),
            "w_x": (2, in_tp),
            "w_B": (2, in_tp),
            "w_C": (2, in_tp),
            "w_dt": (2, in_tp),
            "conv_w": (2, lambda s: (None, b.div(tp, s[1]))),
            "embed": (2, lambda s: (b.div(tp, s[0]), None)),
            "lm_head": (2, in_tp),
            "img_proj": (2, lambda s: (None, b.div(tp, s[1]))),
            "proj": (2, in_tp),
        }
        return table.get(name)

    def param_spec(self, path: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
        ndim = len(shape)
        if "router" in path:
            return _pad((), ndim)
        r = self._rule(path[-1], "experts" in path)
        if r is None:
            return _pad((), ndim)   # norms, scalars, biases, A_log, D, meta, ...
        base_ndim, fn = r
        if ndim == base_ndim:
            return _pad(fn(shape), ndim)
        if ndim == base_ndim + 1:   # stacked over segment repeats
            return _pad((None,) + fn(shape[1:]), ndim)
        return _pad((), ndim)

    # ---- cache rules -------------------------------------------------------
    def cache_spec(self, path: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
        """Cache leaves are stacked: (repeats, B, ...). Batch sharding where
        the batch divides the data axes, else sequence sharding over
        ``data`` (a batch of one: long_500k)."""
        name, ndim = path[-1], len(shape)
        if name == "pos" or ndim < 3:              # (repeats, W)
            return _pad((), ndim)
        dp = self.dp if shape[1] % axis_size(self.mesh, self.dp) == 0 else None
        seq = None if dp is not None else self.div(self.ep, shape[2])
        if name in ("k", "v"):                      # (r, B, S, KV, hd)
            return _pad((None, dp, seq, self.div(self.tp, shape[3]), None), ndim)
        if name in ("c_kv", "k_rope"):              # (r, B, S, c | dr)
            return _pad((None, dp, seq, None), ndim)
        if name == "conv":                          # (r, B, k, ch)
            return _pad((None, dp, None, self.div(self.tp, shape[3])), ndim)
        if name == "h":                             # (r, B, H, P, N)
            return _pad((None, dp, self.div(self.tp, shape[2]), None, None), ndim)
        return _pad((None, dp) if dp else (), ndim)

    # ---- batch rules -------------------------------------------------------
    def batch_spec(self, path: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
        dp = self.dp if shape[0] % axis_size(self.mesh, self.dp) == 0 else None
        return _pad((dp,), len(shape))


def leaf_shape(leaf: Any) -> Tuple[int, ...]:
    """A tensor's shape; a host int (the train state's step counters) is a
    0-d leaf, as the reference's int32 scalars."""
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def tree_specs(tree: Any, fn: Callable[[Tuple[str, ...], Tuple[int, ...]], Spec]
               ) -> Specs:
    """{path: fn(path components, shape)} over a tree's leaves."""
    return {k: fn(tuple(k.split("/")), leaf_shape(v))
            for k, v in flatten_with_paths(tree).items()}


def param_specs(cfg: ModelConfig, mesh: MeshShape, params: Any) -> Specs:
    return tree_specs(params, SpecBuilder(cfg, mesh).param_spec)


def state_specs(cfg: ModelConfig, mesh: MeshShape, state: Any) -> Specs:
    """The train state {"params", "opt": {"m", "v", "step"}, "step"}: the
    moments take their parameter's spec, the step counters replicate."""
    b = SpecBuilder(cfg, mesh)
    out: Specs = {}
    for prefix, tree in (("params", state["params"]), ("opt/m", state["opt"]["m"]),
                         ("opt/v", state["opt"]["v"])):
        out.update({f"{prefix}/{k}": s
                    for k, s in tree_specs(tree, b.param_spec).items()})
    out["opt/step"] = ()
    out["step"] = ()
    return out


def batch_specs(cfg: ModelConfig, mesh: MeshShape, batch: Any) -> Specs:
    return tree_specs(batch, SpecBuilder(cfg, mesh).batch_spec)


def cache_specs(cfg: ModelConfig, mesh: MeshShape, caches: Any) -> Specs:
    return tree_specs(caches, SpecBuilder(cfg, mesh).cache_spec)


def shard_shape(shape: Tuple[int, ...], spec: Spec, mesh: MeshShape) -> Tuple[int, ...]:
    """One device's block of a leaf of ``shape`` under ``spec`` (a dimension
    the axes do not divide rounds up, as a padded shard would)."""
    spec = _pad(spec, len(shape))
    return tuple(-(-n // axis_size(mesh, a)) for n, a in zip(shape, spec))


def itemsize(leaf: Any) -> int:
    """Bytes per element; a host int counts as the reference's int32."""
    return leaf.element_size() if isinstance(leaf, torch.Tensor) else 4


def shard_bytes(leaf: Any, spec: Spec, mesh: MeshShape) -> int:
    """Bytes of one device's shard of ``leaf`` (a tensor, or a host int)."""
    return math.prod(shard_shape(leaf_shape(leaf), spec, mesh)) * itemsize(leaf)


def tree_bytes(tree: Any, specs: Optional[Specs] = None,
               mesh: Optional[MeshShape] = None) -> int:
    """Bytes per device of a tree under ``specs`` on ``mesh``; with no
    specs, the whole tree's bytes (host ints as int32 scalars)."""
    flat = flatten_with_paths(tree)
    if specs is None:
        return sum(math.prod(leaf_shape(v)) * itemsize(v) for v in flat.values())
    return sum(shard_bytes(v, specs[k], mesh) for k, v in flat.items())
