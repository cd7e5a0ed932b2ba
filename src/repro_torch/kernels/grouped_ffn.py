"""Grouped (per-expert) matmul — the MoE compute hot spot.

x (E, C, d) @ w (E, d, f) -> (E, C, f) for every expert, f32
accumulation, output in x's dtype. The kernel (``csrc/grouped_ffn.cu``)
replaces the TPU kernel ``repro/kernels/grouped_ffn.py::_gmm_impl`` /
``_kernel``: a block owns one output tile of one expert and loops over the
reduction axis through shared memory; ragged edges are masked instead of
shrinking the tile to a divisor (the reference's ``platform.fit_block``),
so C = 1 works.

``grouped_matmul`` is differentiable: its backward (the reference's
``_gmm_bwd``, the same GEMM on transposed operands) is two more entry
points of the same kernel, ``grouped_matmul_dx`` (dy @ w^T) and
``grouped_matmul_dw`` (x^T @ dy), which read the transposed operand in
place: w^T is never copied out of w (1.07 GB per MoE layer of
zcode-m3-base).

On the serving and training paths C is 1-8 rows, so every entry point is
bound by the bytes of the weight-sized operand (read by the forward and
dx, written by dw). The plain versions are ``ref.grouped_matmul_ref``,
``ref.grouped_matmul_dx_ref`` and ``ref.grouped_matmul_dw_ref``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``grouped_matmul.launches``, ``grouped_matmul_dx.launches`` and
``grouped_matmul_dw.launches`` count launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (grouped_matmul_dw_ref,
                                     grouped_matmul_dx_ref,
                                     grouped_matmul_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _P]

plain = grouped_matmul_ref
plain_dx = grouped_matmul_dx_ref
plain_dw = grouped_matmul_dw_ref


def _check(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != b.dtype:
        raise TypeError(f"{name}: {a.dtype} vs {b.dtype}")
    build.require_dtype(name, a, _DTYPES)
    build.require_contiguous(name, a, b)


def _launch(entry: str, a: torch.Tensor, b: torch.Tensor, out_shape,
            e: int, c: int, d: int, f: int) -> torch.Tensor:
    """Launch ``entry`` (x, w)-shaped as (E, C, d, f) into a new tensor."""
    build.require_cuda(entry, a, b)
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    if min(c, d, f) == 0:
        return out.zero_()
    fn = build.function(entry, _ARGTYPES)
    build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), e, c, d, f,
                   build.DTYPE_CODES[a.dtype], build.stream_of(a)), entry)
    return out


def grouped_matmul_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dy: (E, C, f), w: (E, d, f) -> dy @ w^T: (E, C, d); w is read
    transposed in place."""
    if dy.dim() != 3 or w.dim() != 3 or dy.shape[0] != w.shape[0] \
            or dy.shape[2] != w.shape[2]:
        raise ValueError(f"grouped_matmul_dx: dy {tuple(dy.shape)}, w "
                         f"{tuple(w.shape)}")
    _check("grouped_matmul_dx", dy, w)
    if dy.device.type == "cpu":
        return plain_dx(dy, w)
    e, c, f = dy.shape
    d = w.shape[1]
    out = _launch("repro_grouped_matmul_dx", dy, w, (e, c, d), e, c, d, f)
    grouped_matmul_dx.launches += 1
    return out


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), dy: (E, C, f) -> x^T @ dy: (E, d, f); x is read
    transposed in place."""
    if x.dim() != 3 or dy.dim() != 3 or x.shape[:2] != dy.shape[:2]:
        raise ValueError(f"grouped_matmul_dw: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}")
    _check("grouped_matmul_dw", x, dy)
    if x.device.type == "cpu":
        return plain_dw(x, dy)
    e, c, d = x.shape
    f = dy.shape[2]
    out = _launch("repro_grouped_matmul_dw", x, dy, (e, d, f), e, c, d, f)
    grouped_matmul_dw.launches += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    """The same Function on both devices: forward and backward call the
    wrappers, which take the plain version on the CPU and launch the
    kernels on the card."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return plain(x, w)
        e, c, d = x.shape
        out = _launch("repro_grouped_matmul", x, w, (e, c, w.shape[2]),
                      e, c, d, w.shape[2])
        grouped_matmul.launches += 1
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = grouped_matmul_dx(dy, w) if ctx.needs_input_grad[0] else None
        dw = grouped_matmul_dw(x, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d) @ w: (E, d, f) -> (E, C, f), per expert;
    differentiable in x and w."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain per expert")
    if x.dtype != w.dtype:
        raise TypeError(f"grouped_matmul: x {x.dtype} vs w {w.dtype}")
    _check("grouped_matmul", x, w)
    return _GroupedMatmul.apply(x, w)


grouped_matmul.launches = 0
grouped_matmul_dx.launches = 0
grouped_matmul_dw.launches = 0
