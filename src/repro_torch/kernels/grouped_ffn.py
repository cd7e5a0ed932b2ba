"""Grouped (per-expert) matmul — the MoE compute hot spot.

x (E, C, d) @ w (E, d, f) -> (E, C, f) for every expert, f32
accumulation, output in x's dtype. The kernels (``csrc/grouped_ffn.cu``)
replace the TPU kernel ``repro/kernels/grouped_ffn.py::_gmm_impl`` /
``_kernel``.

``grouped_matmul`` is differentiable: its backward (the reference's
``_gmm_bwd``, the same GEMM on transposed operands) is two more entry
points, ``grouped_matmul_dx`` (dy @ w^T) and ``grouped_matmul_dw`` (x^T @
dy), which read the transposed operand in place: w^T is never copied out
of w (1.07 GB per MoE layer of zcode-m3-base).

What bounds them on the H100 depends on C, the rows per expert: a
product does 0.5 * C flops per f32 byte of its weight-sized operand,
against the 20 per byte (67 TFLOP/s of f32 CUDA cores over 3.35 TB/s)
past which operations set the limit. At C <= 16 (decode, serving,
training) every entry point is bound by the bytes of that operand (read by
the forward and dx, written by dw); at C >= 128 (the prefills of
dbrx-132b and deepseek-v3-671b, C = 128-1,152) by the f32 FFMA rate. An
f32 ``wgmma`` runs in TF32, which misses the f32 gate, so all kernels run
on the CUDA cores in f32. ``variant`` picks one of two designs per call:

* ``"streaming"`` (C <= 16, rows of 16-byte multiples, 16-byte aligned
  pointers: every decode and training call). The forward streams w through
  a 4-stage shared-memory ring filled by bulk asynchronous copies
  (``cp.async.bulk`` on an mbarrier, one producer warp) in a persistent
  grid of (expert, column slab) items, with x staged beside it in chunks
  over d and the split-d partial sums added in a fixed order (no
  atomics). dx is the forward transposed: items of (expert, slab of d
  rows), w's rows streamed in chunks along their contiguous axis f with
  dy's slice beside each chunk, every sum over f kept in one lane's
  registers and met across lanes by xor-shuffles in a fixed order. dw
  loads its x and dy slices once and writes dw with 16-byte streaming
  stores, a whole 512-byte run per warp.
* ``"tiled"`` (anything else: C > 16, as at every prefill of the MoE
  archs, ragged rows, misaligned views): a register-tiled SGEMM, one 128 x
  128 output tile of one expert per block of 256 threads, each thread an 8
  x 8 f32 accumulator, k in steps of 32 through a 4-stage ring of 16-byte
  ``cp.async`` copies that zero-fill ragged edges, one block per SM; x^T
  and w^T are read along their contiguous axis, no transposed copy. Rows
  that are not whole 16-byte words or misaligned views take the same
  kernel with element loads (``tiled_vec`` false). No atomics and no
  split-K: a second run gives the same bits.
  ``tiled_plan`` is its launch (tile, grid, shared memory) from the shapes.

The plain versions are ``ref.grouped_matmul_ref``,
``ref.grouped_matmul_dx_ref`` and ``ref.grouped_matmul_dw_ref``.

A CPU tensor takes the plain version; a CUDA tensor launches a kernel or
raises. ``grouped_matmul.launches``, ``grouped_matmul_dx.launches`` and
``grouped_matmul_dw.launches`` count launches of either variant; their
``.launches_streaming`` count those that took the streaming kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

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
STREAM_MAX_C = 16


def variant(c: int, d: int, f: int, itemsize: int, *addresses: int) -> str:
    """The kernel a (C, d, f) product of ``itemsize``-byte elements takes
    on the card: ``"streaming"`` where 1 <= C <= 16, rows of d and of f
    are whole 16-byte words and every operand's address is 16-byte
    aligned (its bulk and 16-byte copies need all three), else
    ``"tiled"``. The same rule for the forward (x, w, out), dx (dy, w,
    dx) and dw (x, dy, dw); ``repro_grouped_matmul*_stream`` checks it
    again."""
    if (1 <= c <= STREAM_MAX_C and (d * itemsize) % 16 == 0
            and (f * itemsize) % 16 == 0 and all(a % 16 == 0 for a in addresses)):
        return "streaming"
    return "tiled"


TILE = (128, 128, 32)        # the tiled kernel's rows, columns and k per stage
TILED_THREADS = 256
TILED_STAGES = 4             # its ring of shared-memory stages
SMEM_MAX = 232448            # an H100 block's opt-in shared memory


def tiled_vec(d: int, f: int, itemsize: int, *addresses: int) -> bool:
    """Whether the tiled kernel moves 16-byte words for a (C, d, f)
    product: rows of d and of f whole 16-byte words and every address
    16-byte aligned, any C; else it loads element by element."""
    return ((d * itemsize) % 16 == 0 and (f * itemsize) % 16 == 0
            and all(a % 16 == 0 for a in addresses))


def tiled_plan(kind: str, e: int, c: int, d: int, f: int, itemsize: int) -> dict:
    """The tiled kernel's launch for a (E, C, d, f) product of
    ``itemsize``-byte elements, from the shapes alone (what
    ``csrc/grouped_ffn.cu::launch_tiled`` launches): ``kind`` ``"fwd"``,
    ``"dx"`` or ``"dw"``; the GEMM's (m, k, n); the grid (row tiles
    fastest, column tiles, experts); the ring's stages and its dynamic
    shared memory. A k-contiguous operand (x, dy, w read as w^T) takes
    [128][32 + 16 bytes] per stage, an m- or n-contiguous one (w, dy, x
    read as x^T) [32][128]."""
    m, k, n = {"fwd": (c, d, f), "dx": (c, f, d), "dw": (d, c, f)}[kind]
    rows, cols, bk = TILE
    stages = TILED_STAGES

    def operand(kc: bool) -> int:
        return (rows * (bk + 16 // itemsize) if kc else bk * cols) * itemsize

    stage = -(-(operand(kind != "dw") + operand(kind == "dx")) // 128) * 128
    return {"gemm": (m, k, n), "tile": TILE, "threads": TILED_THREADS,
            "grid": (-(-m // rows), -(-n // cols), e), "stages": stages,
            "smem_bytes": stages * stage}


def _check(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != b.dtype:
        raise TypeError(f"{name}: {a.dtype} vs {b.dtype}")
    build.require_dtype(name, a, _DTYPES)
    build.require_contiguous(name, a, b)


def _launch(entry: str, a: torch.Tensor, b: torch.Tensor, out_shape,
            e: int, c: int, d: int, f: int, stream_entry: str = "",
            wrapper: str = "", kinds: Tuple[str, str] = ("", "")):
    """Launch ``entry`` (x, w)-shaped as (E, C, d, f) into a new tensor, or
    ``stream_entry`` where given and ``variant`` says ``"streaming"``, and
    note a ``wrapper``'s launch by its ``variant_info`` kind (``kinds``:
    tiled, streaming; the tiled kind with ``tiled_vec``). Returns (out,
    whether the streaming kernel ran)."""
    build.require_cuda(entry, a, b)
    dt = a.dtype
    out = torch.empty(out_shape, dtype=dt, device=a.device)
    if out.numel() == 0:
        return out, False
    if min(c, d, f) == 0:
        return out.zero_(), False
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr())
    streaming = bool(stream_entry) and variant(
        c, d, f, dt.itemsize, *ptrs) == "streaming"
    name = stream_entry if streaming else entry
    fn = build.function(name, _ARGTYPES)
    build.check(fn(*ptrs, e, c, d, f, build.DTYPE_CODES[dt],
                   build.stream_of(a)), name)
    if wrapper:
        build.launched_variants.add(
            (wrapper, kinds[1], dt, c) if streaming
            else (wrapper, kinds[0], dt, c, tiled_vec(d, f, dt.itemsize, *ptrs)))
    return out, streaming


def grouped_matmul_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dy: (E, C, f), w: (E, d, f) -> dy @ w^T: (E, C, d); w is read
    transposed in place."""
    if dy.dim() != 3 or w.dim() != 3 or dy.shape[0] != w.shape[0] \
            or dy.shape[2] != w.shape[2]:
        raise ValueError(f"grouped_matmul_dx: dy {tuple(dy.shape)}, w "
                         f"{tuple(w.shape)}")
    _check("grouped_matmul_dx", dy, w)
    build.calls["grouped_matmul_dx"] += 1
    if dy.device.type == "cpu":
        return plain_dx(dy, w)
    e, c, f = dy.shape
    d = w.shape[1]
    out, streaming = _launch("repro_grouped_matmul_dx", dy, w, (e, c, d),
                             e, c, d, f, "repro_grouped_matmul_dx_stream",
                             "grouped_matmul_dx", ("tiled_dx", "stream_dx"))
    grouped_matmul_dx.launches += 1
    grouped_matmul_dx.launches_streaming += streaming
    return out


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), dy: (E, C, f) -> x^T @ dy: (E, d, f); x is read
    transposed in place."""
    if x.dim() != 3 or dy.dim() != 3 or x.shape[:2] != dy.shape[:2]:
        raise ValueError(f"grouped_matmul_dw: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}")
    _check("grouped_matmul_dw", x, dy)
    build.calls["grouped_matmul_dw"] += 1
    if x.device.type == "cpu":
        return plain_dw(x, dy)
    e, c, d = x.shape
    f = dy.shape[2]
    out, streaming = _launch("repro_grouped_matmul_dw", x, dy, (e, d, f),
                             e, c, d, f, "repro_grouped_matmul_dw_stream",
                             "grouped_matmul_dw", ("tiled_dw", "stream_dw"))
    grouped_matmul_dw.launches += 1
    grouped_matmul_dw.launches_streaming += streaming
    return out


class _GroupedMatmul(torch.autograd.Function):
    """The same Function on both devices: forward and backward call the
    wrappers, which take the plain version on the CPU and launch the
    kernels on the card."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        build.calls["grouped_matmul"] += 1
        if x.device.type == "cpu":
            return plain(x, w)
        e, c, d = x.shape
        out, streaming = _launch("repro_grouped_matmul", x, w,
                                 (e, c, w.shape[2]), e, c, d, w.shape[2],
                                 "repro_grouped_matmul_stream", "grouped_matmul",
                                 ("tiled_fwd", "stream_fwd"))
        grouped_matmul.launches += 1
        grouped_matmul.launches_streaming += streaming
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


for _fn in (grouped_matmul, grouped_matmul_dx, grouped_matmul_dw):
    _fn.launches = _fn.launches_streaming = 0


def variant_info(kind: str, dtype: torch.dtype, c: int, vec: bool = True) -> dict:
    """What the card reports for one compiled kernel: registers per thread,
    shared memory per block (bytes), spill bytes per thread and resident
    blocks per SM. ``kind``: ``"stream_fwd"``, ``"stream_dw"``,
    ``"stream_dx"`` (at C rounded up to 1, 4, 8 or 16), ``"tiled_fwd"``,
    ``"tiled_dx"`` or ``"tiled_dw"`` (any C; ``vec``: the 16-byte instance,
    else the element-load one). Builds the library; needs a card."""
    kinds = ("stream_fwd", "stream_dw", "tiled_fwd", "tiled_dx", "stream_dx", "tiled_dw")
    code = kinds.index(kind)
    if kind.startswith("tiled") and not vec:
        code = {"tiled_fwd": 6, "tiled_dx": 7, "tiled_dw": 8}[kind]
    info = (ctypes.c_int * 4)()
    fn = build.function("repro_grouped_ffn_variant_info", [_I, _I, _I, _P])
    build.check(fn(code, build.DTYPE_CODES[dtype], c,
                   ctypes.cast(info, _P)), "repro_grouped_ffn_variant_info")
    return dict(zip(("registers", "smem_bytes", "spill_bytes",
                     "blocks_per_sm"), info))
