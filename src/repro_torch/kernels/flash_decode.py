"""Flash decode attention: one query token per row against a KV cache.

q (B, H, hd), k/v (B, S, KV, hd), index scalar or (B,): positions past
index[b] are masked; softmax in f32; output in q's dtype. The kernel
(``csrc/flash_decode.cu``) replaces the TPU kernel
``repro/kernels/flash_decode.py::_flash_decode_jit`` / ``_kernel``: the
TPU's sequential grid axis over S becomes a loop inside one block per
(row, kv head), four warps carrying their own online-softmax state that
merge at the end; the GQA group's query heads share every K/V row read.

Bound by bytes on the H100 (every live K/V row read once); at the serving
shapes (S <= 64) by launch latency. Its plain version is
``ref.flash_decode_ref``. The paged variant (the reference's
``flash_decode_paged``) comes with the paged scheduler.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``flash_decode.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_decode_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
MAX_REP = 8          # query heads per kv head the kernel holds in registers
MAX_HEAD_DIM = 128

plain = flash_decode_ref


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
    if k.dtype != v.dtype:
        raise TypeError(f"flash_decode: k {k.dtype} vs v {v.dtype}")
    build.require_dtype("flash_decode", q, _DTYPES)
    build.require_dtype("flash_decode", k, _DTYPES)
    build.require_contiguous("flash_decode", q, k, v)
    if q.device.type == "cpu":
        return plain(q, k, v, index)
    idx = torch.as_tensor(index, dtype=torch.int32, device=q.device)
    idx = idx.reshape(-1).expand(b).contiguous()
    rep = h // kv
    if rep > MAX_REP or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: kernel takes <= {MAX_REP} query heads "
                         f"per kv head and head_dim <= {MAX_HEAD_DIM}")
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
