"""Grouped (per-expert) matmul — the MoE compute hot spot.

x (E, C, d) @ w (E, d, f) -> (E, C, f) for every expert, f32
accumulation, output in x's dtype. The kernel (``csrc/grouped_ffn.cu``)
replaces the TPU kernel ``repro/kernels/grouped_ffn.py::_gmm_impl`` /
``_kernel``: a block owns one output tile of one expert and loops over d
through shared memory; ragged edges are masked instead of shrinking the
tile to a divisor (the reference's ``platform.fit_block``), so C = 1 works.

On the serving path C is 1-4 rows, so the kernel is bound by the bytes of
w: every expert's weights are read once per call whether or not a token
reached the expert. Its plain version is ``ref.grouped_matmul_ref``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``grouped_matmul.launches`` counts launches. Forward only: the
backward (the same GEMM on transposed operands) comes with the training
slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import grouped_matmul_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)

plain = grouped_matmul_ref


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d) @ w: (E, d, f) -> (E, C, f), per expert."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain per expert")
    if x.dtype != w.dtype:
        raise TypeError(f"grouped_matmul: x {x.dtype} vs w {w.dtype}")
    build.require_dtype("grouped_matmul", x, _DTYPES)
    build.require_contiguous("grouped_matmul", x, w)
    if x.device.type == "cpu":
        return plain(x, w)
    build.require_cuda("grouped_matmul", x, w)
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if d == 0:
        return out.zero_()
    fn = build.function("repro_grouped_matmul", [_P, _P, _P, _I, _I, _I, _I, _I, _P])
    build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                   build.DTYPE_CODES[x.dtype], build.stream_of(x)),
                "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
