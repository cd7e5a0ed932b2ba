"""MoE execution-backend registry (port of ``repro/core/backend.py`` at one
device).

  oracle -- plain torch (``core/moe.py::moe_oracle``, one virtual shard);
            the ground truth.
  cuda   -- the kernel pipeline, counterpart of the reference's ``pallas``
            backend: routing tables built once per layer, then the
            dispatch gather -> grouped-matmul expert FFN -> weighted
            combine gather. On CPU tensors the kernels' wrappers run their
            plain versions, so the pipeline is testable without a card.
  auto   -- (default) oracle.

Every backend shares the router and the Gating Dropout branch selection,
so routing is identical by construction; outputs differ only by kernel
arithmetic.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import moe as M
from repro_torch.core import router as R
from repro_torch.kernels import ops as K

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


def resolve_backend(moe: MoEConfig) -> str:
    return "oracle" if moe.backend == "auto" else moe.backend


@register_backend("oracle")
def oracle_backend(params, x: torch.Tensor, cfg: ModelConfig,
                   **kw) -> Tuple[torch.Tensor, Dict]:
    """Plain-torch ground truth (single virtual shard)."""
    return M.moe_oracle(params, x, cfg, ep=1, **kw)


@register_backend("cuda")
def cuda_backend(params, x: torch.Tensor, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None,
                 decision: Optional[bool] = None, is_training: bool = True,
                 token_ids: Optional[torch.Tensor] = None,
                 token_valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """Kernel pipeline: route -> routing_tables (once) -> dispatch ->
    grouped-matmul FFN -> combine. Matches the oracle at ep=1."""
    moe = cfg.moe
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    T = xf.shape[0]
    E = moe.n_experts
    tok = None if token_ids is None else token_ids.reshape(-1)
    tv = M._token_valid_tk(None if token_valid is None
                           else token_valid.reshape(-1), moe.top_k)
    wr = params["router"]["w"]
    experts = params["experts"]
    cf = moe.capacity_factor if is_training else moe.eval_capacity_factor
    cap = min(R.capacity(T, E, moe.top_k, cf), T)

    def pipeline(info: R.DispatchInfo) -> torch.Tensor:
        tables = K.routing_tables(info, E, cap)    # built once, used twice
        buf = K.moe_dispatch_op(xf, info, E, cap, tables=tables)
        w_in = experts["w_in"]
        out = K.expert_ffn_op(buf.to(w_in.dtype), w_in, experts.get("w_gate"),
                              experts["w_out"], cfg.act)
        return K.moe_combine_op(out.to(xf.dtype), info, tables=tables)

    def routed():
        rr = R.route(wr, xf, moe, generator=generator,
                     is_training=is_training, token_ids=tok)
        info = R.dispatch_info(rr, E, cap, valid=tv)
        return pipeline(info), M._routed_aux(rr, info, moe)

    def local():
        # one device: the "local group" is all E experts (the reference's
        # _local_shard with my_shard=0, e_loc=E), kernel-executed
        rr = R.route(wr, xf, moe, generator=generator,
                     is_training=is_training, token_ids=tok,
                     expert_lo=0, n_local=E)
        rr, valid = M._local_adjust(rr, moe, 0, E)
        if tv is not None:
            valid = valid & tv
        info = R.dispatch_info(rr, E, cap, valid=valid)
        return pipeline(info), M._local_aux(rr, info, moe, T)

    def expert_drop():
        return torch.zeros_like(xf), M._zero_aux(E, x.device)

    y, aux = M._select_branch(moe, decision, routed, local, expert_drop)
    return y.reshape(shape), aux
