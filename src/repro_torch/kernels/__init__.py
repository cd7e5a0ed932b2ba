"""Hand-written Hopper kernels of the port and their wrappers.

  moe_dispatch.dispatch            B2  row gather into expert buffers
  moe_dispatch.combine             B3  weighted k-way gather back to tokens
  grouped_ffn.grouped_matmul       B1  per-expert GEMM
  grouped_ffn.grouped_matmul_dx    B1  its backward, dy @ w^T
  grouped_ffn.grouped_matmul_dw    B1  its backward, x^T @ dy
  moe_megakernel.fused_moe         B4  gather + expert FFN + scatter, one launch
  flash_decode.flash_decode        B5  single-token decode attention
  flash_decode.flash_decode_paged  B6  the same over a paged KV cache

Each wrapper takes its plain version (``ref.py``) on a CPU tensor and
launches its CUDA kernel (``csrc/``, built by ``build.py`` at first use) on
a CUDA tensor, counting launches in ``<wrapper>.launches`` (B1's forward,
dx and dw and B4 also in ``.launches_streaming``, see
``grouped_ffn.variant`` and ``moe_megakernel.variant``) and calls, on
either device, in ``build.calls``; ``build.launched_variants`` holds each
launched variant's ``variant_info`` arguments. B1-B4 are
differentiable through ``torch.autograd.Function``s that run the same
code on both devices.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.kernels import (build, flash_decode, grouped_ffn, moe_dispatch,
                                 moe_megakernel)


def wrappers() -> Dict[str, Callable]:
    return {"dispatch": moe_dispatch.dispatch, "combine": moe_dispatch.combine,
            "grouped_matmul": grouped_ffn.grouped_matmul,
            "grouped_matmul_dx": grouped_ffn.grouped_matmul_dx,
            "grouped_matmul_dw": grouped_ffn.grouped_matmul_dw,
            "fused_moe": moe_megakernel.fused_moe,
            "flash_decode": flash_decode.flash_decode,
            "flash_decode_paged": flash_decode.flash_decode_paged}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def call_counts() -> Dict[str, int]:
    """Calls of each wrapper, on either device (a call on a card is one
    launch of its kernel)."""
    return {name: build.calls[name] for name in wrappers()}


def streaming_counts() -> Dict[str, int]:
    """Launches of B1's forward, dx and dw that took the streaming kernel
    (B4's: ``moe_megakernel.fused_moe.launches_streaming``)."""
    return {name: wrappers()[name].launches_streaming
            for name in ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw")}


def reset_launch_counts() -> None:
    """Zero every wrapper's launches and calls and forget the launched
    variants."""
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_streaming"):
            fn.launches_streaming = 0
    build.calls.clear()
    build.launched_variants.clear()
