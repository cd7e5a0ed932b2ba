"""Hand-written Hopper kernels of the port and their wrappers.

  moe_dispatch.dispatch            B2  row gather into expert buffers
  moe_dispatch.combine             B3  weighted k-way gather back to tokens
  grouped_ffn.grouped_matmul       B1  per-expert GEMM
  grouped_ffn.grouped_matmul_dx    B1  its backward, dy @ w^T
  grouped_ffn.grouped_matmul_dw    B1  its backward, x^T @ dy
  moe_megakernel.fused_moe         B4  gather + expert FFN + scatter, one launch
  flash_decode.flash_decode        B5  single-token decode attention

Each wrapper takes its plain version (``ref.py``) on a CPU tensor and
launches its CUDA kernel (``csrc/``, built by ``build.py`` at first use) on
a CUDA tensor, counting launches in ``<wrapper>.launches``. B1-B4 are
differentiable through ``torch.autograd.Function``s that run the same
code on both devices.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.kernels import (flash_decode, grouped_ffn, moe_dispatch,
                                 moe_megakernel)


def wrappers() -> Dict[str, Callable]:
    return {"dispatch": moe_dispatch.dispatch, "combine": moe_dispatch.combine,
            "grouped_matmul": grouped_ffn.grouped_matmul,
            "grouped_matmul_dx": grouped_ffn.grouped_matmul_dx,
            "grouped_matmul_dw": grouped_ffn.grouped_matmul_dw,
            "fused_moe": moe_megakernel.fused_moe,
            "flash_decode": flash_decode.flash_decode}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
