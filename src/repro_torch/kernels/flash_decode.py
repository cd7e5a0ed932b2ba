"""Flash decode attention: one query token per row against a KV cache,
contiguous (B5) or paged (B6).

``flash_decode``: q (B, H, hd), k/v (B, S, KV, hd), index scalar or (B,):
positions past index[b] are masked; softmax in f32; output in q's dtype.
Its kernel replaces the TPU kernel
``repro/kernels/flash_decode.py::_flash_decode_jit`` / ``_kernel``: the
TPU's sequential grid axis over S becomes a loop inside one block per
(row, kv head), four warps carrying their own online-softmax state that
merge at the end; the GQA group's query heads share every K/V row read.

``flash_decode_paged``: the same over a page arena k/v (n_pages + 1, ps,
KV, hd) through block tables (B, nb): row b's logical position p lives at
arena page ``block_tables[b, p // ps]``, offset ``p % ps``. Its kernel
replaces ``_flash_decode_paged_jit`` / ``_paged_kernel``, whose DMA
prologue gathers the pages; on the H100 the table lookup is the row
address inside B5's loop. Both kernels share one device body
(``csrc/flash_decode.cu::attend_rows``), so B6 equals B5 bitwise on the
contiguous cache its tables address.

Both are bound by bytes on the H100 (every live K/V row read once); at the
serving shapes (at most 96 positions) by launch latency. Their plain
versions are ``ref.flash_decode_ref`` and ``ref.flash_decode_paged_ref``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``flash_decode.launches`` and ``flash_decode_paged.launches``
count launches. Decode only: like the reference's kernels they have no
backward, so a call with grad mode on and an input that requires grad
raises rather than return a tensor cut off from autograd (on both
devices).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_decode_paged_ref, flash_decode_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
MAX_REP = 8          # query heads per kv head the kernel holds in registers
MAX_HEAD_DIM = 128

plain = flash_decode_ref
plain_paged = flash_decode_paged_ref


def _check_common(name: str, q, k, v) -> None:
    if k.dtype != v.dtype:
        raise TypeError(f"{name}: k {k.dtype} vs v {v.dtype}")
    build.require_dtype(name, q, _DTYPES)
    build.require_dtype(name, k, _DTYPES)
    build.require_contiguous(name, q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f"{name} has no backward (decode only): call "
                           "it under torch.no_grad() or on detached inputs")


def _check_kernel_shape(name: str, rep: int, hd: int) -> None:
    if rep > MAX_REP or hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: kernel takes <= {MAX_REP} query heads "
                         f"per kv head and head_dim <= {MAX_HEAD_DIM}")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 index) -> torch.Tensor:
    """q: (B, H, hd); k, v: (B, S, KV, hd); index: int or (B,) int —
    positions > index (per row) are masked; index must be >= 0. Returns
    (B, H, hd)."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, h, hd = q.shape
    _, s, kv, khd = k.shape
    if k.shape[0] != b or khd != hd or h % kv:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match "
                         f"cache {tuple(k.shape)}")
    _check_common("flash_decode", q, k, v)
    if q.device.type == "cpu":
        return plain(q, k, v, index)
    idx = torch.as_tensor(index, dtype=torch.int32, device=q.device)
    idx = idx.reshape(-1).expand(b).contiguous()
    rep = h // kv
    _check_kernel_shape("flash_decode", rep, hd)
    build.require_cuda("flash_decode", q, k, v, idx)
    out = torch.empty_like(q)
    if out.numel() == 0 or s == 0:
        return out.zero_()
    fn = build.function("repro_flash_decode",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
                         _I, _I, _P])
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), b, s, kv, rep, hd, hd ** -0.5,
                   build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k.dtype],
                   build.stream_of(q)), "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       block_tables: torch.Tensor,
                       index: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); k, v: the page arena (n_pages + 1, page_size, KV,
    hd); block_tables: (B, n_blocks) int32, contiguous, entries in [0,
    n_pages]; index: (B,) int, each row's absolute position (>= 0).
    Positions > index[b] are masked. Returns (B, H, hd). Reads neither the
    tables nor the index on the host."""
    if (q.dim() != 3 or k.dim() != 4 or k.shape != v.shape
            or block_tables.dim() != 2 or index.dim() != 1):
        raise ValueError(f"flash_decode_paged: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, tables "
                         f"{tuple(block_tables.shape)}, index {tuple(index.shape)}")
    b, h, hd = q.shape
    n_arena, ps, kv, khd = k.shape
    nb = block_tables.shape[1]
    if (block_tables.shape[0] != b or index.shape[0] != b or khd != hd
            or h % kv or nb < 1 or ps < 1):
        raise ValueError(f"flash_decode_paged: q {tuple(q.shape)} does not "
                         f"match arena {tuple(k.shape)}, tables "
                         f"{tuple(block_tables.shape)}, index {tuple(index.shape)}")
    if block_tables.dtype != torch.int32:
        raise TypeError(f"flash_decode_paged: block tables {block_tables.dtype}, "
                        "need int32")
    if index.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"flash_decode_paged: index {index.dtype}")
    _check_common("flash_decode_paged", q, k, v)
    build.require_contiguous("flash_decode_paged", block_tables)
    if q.device.type == "cpu":
        return plain_paged(q, k, v, block_tables, index)
    rep = h // kv
    _check_kernel_shape("flash_decode_paged", rep, hd)
    idx = index.to(torch.int32).contiguous()
    build.require_cuda("flash_decode_paged", q, k, v, block_tables, idx)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.function("repro_flash_decode_paged",
                        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _I, _I, _P])
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   block_tables.data_ptr(), idx.data_ptr(), out.data_ptr(),
                   b, nb, ps, n_arena, kv, rep, hd, hd ** -0.5,
                   build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k.dtype],
                   build.stream_of(q)), "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
