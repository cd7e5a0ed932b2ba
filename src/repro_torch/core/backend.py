"""MoE execution-backend registry (port of ``repro/core/backend.py``).

  oracle     -- plain torch (``core/moe.py::moe_oracle``, one virtual
                shard); the ground truth.
  sharded    -- ``moe_sharded``: the plain per-shard maths on one rank of
                the context's group, the dispatch and combine being the
                substrate's real all-to-alls. Without a context it runs
                as a group of one (no collective).
  cuda       -- the kernel pipeline, counterpart of the reference's
                ``pallas`` backend: ``moe_sharded`` with routing tables
                built once per layer, then the dispatch gather (B2) ->
                wire -> grouped-matmul expert FFN (B1) on (E/ep, ep*cap,
                d) -> wire -> weighted combine gather (B3); the Gate-Drop
                local branch runs B2/B1/B3 with no wire. Without a
                context it runs as a group of one, where a wire has no
                hop and is the transport's ``roundtrip`` (quantize ->
                dequantize on a compressed substrate, else nothing), so a
                compressed substrate changes the routed numerics as on
                every other backend. (The reference's ``pallas`` at ep=1
                also quantizes around its local branch's FFN; its oracle
                and ``sharded`` do not, nor does any backend here.)
  cuda_fused -- the one-launch fused kernel (B4), counterpart of the
                reference's ``pallas_fused``: ``moe_sharded`` on a group
                of one with routing tables, then gather + expert FFN +
                weighted scatter in one kernel. Under an
                active context (the wire needs the (E, C, d) buffer) or a
                compressed substrate (its quantization applies to that
                buffer) it runs the ``cuda`` pipeline instead, as the
                reference falls back to ``pallas``; ep = 1 dense and
                hierarchical wires move nothing, so B4 skips them.
  auto       -- (default) sharded under an active context, else oracle.

On CPU tensors the kernels' wrappers run their plain versions, so the
kernel backends are testable without a card. Every backend shares the
router, the Gating Dropout branch selection and the aux dicts, so routing
is identical by construction; outputs differ only by kernel arithmetic.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import moe as M

BackendFn = Callable[..., Tuple[torch.Tensor, Dict]]

_REGISTRY: Dict[str, BackendFn] = {}


def register_backend(name: str) -> Callable[[BackendFn], BackendFn]:
    def deco(fn: BackendFn) -> BackendFn:
        _REGISTRY[name] = fn
        return fn
    return deco


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str) -> BackendFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown MoE backend {name!r}; available: "
                       f"{', '.join(available_backends())}") from None


def resolve_backend(moe: MoEConfig, ctx: Optional[M.ParallelContext] = None
                    ) -> str:
    """'auto' -> 'sharded' under an active context, else 'oracle'."""
    if moe.backend == "auto":
        return "sharded" if (ctx is not None and ctx.active) else "oracle"
    return moe.backend


def _active(ctx: Optional[M.ParallelContext]) -> bool:
    return ctx is not None and ctx.active


@register_backend("oracle")
def oracle_backend(params, x: torch.Tensor, cfg: ModelConfig, *, ctx=None,
                   **kw) -> Tuple[torch.Tensor, Dict]:
    """Plain-torch ground truth (single virtual shard)."""
    return M.moe_oracle(params, x, cfg, ep=1, **kw)


@register_backend("sharded")
def sharded_backend(params, x: torch.Tensor, cfg: ModelConfig, *, ctx=None,
                    **kw) -> Tuple[torch.Tensor, Dict]:
    """Plain per-shard maths with the substrate's real all-to-alls on
    ``ctx``'s group (a group of one without it)."""
    return M.moe_sharded(params, x, cfg, ctx if _active(ctx)
                         else M.ParallelContext(), **kw)


@register_backend("cuda")
def cuda_backend(params, x: torch.Tensor, cfg: ModelConfig, *,
                 ctx: Optional[M.ParallelContext] = None,
                 **kw) -> Tuple[torch.Tensor, Dict]:
    """Kernel pipeline: dispatch -> grouped-matmul FFN -> combine, the two
    gathers sharing one set of routing tables; ``moe_sharded`` with the
    kernels, on ``ctx``'s group (a group of one without it)."""
    return M.moe_sharded(params, x, cfg, ctx if _active(ctx) else M.ParallelContext(),
                         kernels="cuda", **kw)


def fused_runs_pipeline(moe: MoEConfig,
                        ctx: Optional[M.ParallelContext] = None) -> bool:
    """Whether ``cuda_fused`` runs the ``cuda`` pipeline instead of B4: under
    an active context or a compressed substrate."""
    return _active(ctx) or moe.comm.compressed


@register_backend("cuda_fused")
def cuda_fused_backend(params, x: torch.Tensor, cfg: ModelConfig, *,
                       ctx: Optional[M.ParallelContext] = None,
                       **kw) -> Tuple[torch.Tensor, Dict]:
    """One-launch fused kernel per MoE layer: route -> routing_tables ->
    B4, with the same router, Gating Dropout branches and aux as the
    other backends; the (E, C, d) buffer and its round trips are gone.
    Runs the ``cuda`` pipeline where ``fused_runs_pipeline`` says so."""
    if fused_runs_pipeline(cfg.moe, ctx):
        return cuda_backend(params, x, cfg, ctx=ctx, **kw)
    return M.moe_sharded(params, x, cfg, M.ParallelContext(), kernels="cuda_fused",
                         **kw)
