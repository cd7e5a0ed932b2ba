"""MoE token dispatch / combine: the row gathers around the expert FFN.

Routing is precomputed into slot tables (``ops.routing_tables``), so both
ops are pure gathers:

  dispatch: buf[s] = x[slot_token[s]] * valid[s]        (S = E*C slots)
  combine : y[t]  = sum_k w[t,k] * keep[t,k] * buf[token_slot[t,k]]

Kernels (``csrc/moe_dispatch.cu``) replace the TPU kernels of
``repro/kernels/moe_dispatch.py`` (``_dispatch_impl``/``_dispatch_kernel``
and ``_combine_impl``/``_make_combine_kernel``). Both are bound by bytes
on the H100: dispatch moves each slot row once as 16-byte words, one warp
per row; combine reads the K rows of a token in one block and sums them in
f32. Each function's plain version is ``ref.dispatch_ref`` /
``ref.combine_ref``.

Both are differentiable through ``torch.autograd.Function``s whose
backwards are the reference's custom VJPs (``_dispatch_bwd``,
``_combine_bwd``), which JAX computes in jnp outside any Pallas kernel and
the port in plain torch on both devices: dispatch scatter-adds dy rows
onto their tokens in f32 (masked by ``slot_valid``); combine scatters
w * dy onto the slots and takes dw[t, k] = <dy[t], buf[slot]>, which
reaches ``weights`` (the router's top-k weights) through w = weights *
keep.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``dispatch.launches`` / ``combine.launches`` count launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import combine_ref, dispatch_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)

plain_dispatch = dispatch_ref
plain_combine = combine_ref


def _check_tables(name, idx: torch.Tensor, ndim: int) -> None:
    if idx.dtype != torch.int32 or idx.dim() != ndim:
        raise TypeError(f"{name}: index table must be {ndim}-D int32, got "
                        f"{idx.dim()}-D {idx.dtype}")


def _dispatch_fwd(x: torch.Tensor, slot_token: torch.Tensor,
                  slot_valid: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_dispatch(x, slot_token, slot_valid)
    build.require_cuda("dispatch", x, slot_token, slot_valid)
    t, d = x.shape
    s = slot_token.shape[0]
    out = torch.empty((s, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("repro_moe_dispatch", [_P, _P, _P, _P, _I, _I, _I, _P])
    build.check(fn(x.data_ptr(), slot_token.data_ptr(), slot_valid.data_ptr(),
                   out.data_ptr(), t, s, d * x.element_size(),
                   build.stream_of(x)), "dispatch")
    dispatch.launches += 1
    return out


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slot_token, slot_valid):
        ctx.save_for_backward(slot_token, slot_valid)
        ctx.x_meta = (x.shape[0], x.dtype)
        return _dispatch_fwd(x, slot_token, slot_valid)

    @staticmethod
    def backward(ctx, dy):
        slot_token, slot_valid = ctx.saved_tensors
        n_tokens, dtype = ctx.x_meta
        dyf = torch.where(slot_valid[:, None], dy.float(), 0.0)
        idx = slot_token.long().clamp(0, n_tokens - 1)
        dx = dyf.new_zeros((n_tokens, dy.shape[1])).index_add_(0, idx, dyf)
        return dx.to(dtype), None, None


def dispatch(x: torch.Tensor, slot_token: torch.Tensor,
             slot_valid: torch.Tensor) -> torch.Tensor:
    """x: (T, d); slot_token (S,) int32; slot_valid (S,) bool -> (S, d);
    differentiable in x."""
    if x.dim() != 2:
        raise ValueError(f"dispatch: x must be (T, d), got {tuple(x.shape)}")
    _check_tables("dispatch", slot_token, 1)
    if slot_valid.dtype != torch.bool or slot_valid.shape != slot_token.shape:
        raise TypeError("dispatch: slot_valid must be bool with slot_token's "
                        "shape")
    build.require_dtype("dispatch", x, _DTYPES)
    if x.shape[0] == 0:
        raise ValueError("dispatch: no tokens to gather from")
    build.require_contiguous("dispatch", x, slot_token, slot_valid)
    return _Dispatch.apply(x, slot_token, slot_valid)


dispatch.launches = 0


def _combine_fwd(buf: torch.Tensor, token_slot: torch.Tensor,
                 weights: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    if buf.device.type == "cpu":
        return plain_combine(buf, token_slot, weights, keep)
    build.require_cuda("combine", buf, token_slot, weights, keep)
    s, d = buf.shape
    t, k = token_slot.shape
    out = torch.empty((t, d), dtype=buf.dtype, device=buf.device)
    if out.numel() == 0:
        return out
    fn = build.function("repro_moe_combine",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    build.check(fn(buf.data_ptr(), token_slot.data_ptr(), weights.data_ptr(),
                   keep.data_ptr(), out.data_ptr(), t, s, k, d,
                   build.DTYPE_CODES[buf.dtype], build.stream_of(buf)),
                "combine")
    combine.launches += 1
    return out


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, token_slot, weights, keep):
        ctx.save_for_backward(buf, token_slot, weights, keep)
        return _combine_fwd(buf, token_slot, weights, keep)

    @staticmethod
    def backward(ctx, dy):
        buf, token_slot, weights, keep = ctx.saved_tensors
        t, k = token_slot.shape
        slots = token_slot.long().clamp(0, buf.shape[0] - 1).reshape(-1)
        w = (weights * keep).float()
        dyf = dy.float()
        dbuf = dw = None
        if ctx.needs_input_grad[0]:
            # dbuf[s] = sum over (t, k) -> s of w[t, k] * dy[t]
            contrib = (w[..., None] * dyf[:, None, :]).reshape(t * k, -1)
            dbuf = dyf.new_zeros(buf.shape).index_add_(0, slots, contrib)
            dbuf = dbuf.to(buf.dtype)
        if ctx.needs_input_grad[2]:
            # dw[t, k] = <dy[t], buf[slot[t, k]]>, through w = weights * keep
            rows = buf.index_select(0, slots).reshape(t, k, -1).float()
            dw = torch.einsum("td,tkd->tk", dyf, rows)
            dw = (dw * keep).to(weights.dtype)
        return dbuf, None, dw, None


def combine(buf: torch.Tensor, token_slot: torch.Tensor, weights: torch.Tensor,
            keep: torch.Tensor) -> torch.Tensor:
    """buf: (S, d); token_slot (T, K) int32; weights (T, K) f32; keep
    (T, K) bool -> y (T, d) in buf's dtype; differentiable in buf and
    weights."""
    if buf.dim() != 2:
        raise ValueError(f"combine: buf must be (S, d), got {tuple(buf.shape)}")
    _check_tables("combine", token_slot, 2)
    if weights.shape != token_slot.shape or keep.shape != token_slot.shape:
        raise ValueError("combine: weights and keep must match token_slot's "
                         f"shape {tuple(token_slot.shape)}")
    if weights.dtype != torch.float32 or keep.dtype != torch.bool:
        raise TypeError("combine: weights must be float32 and keep bool")
    build.require_dtype("combine", buf, _DTYPES)
    if buf.shape[0] == 0:
        raise ValueError("combine: no buffer rows to gather from")
    build.require_contiguous("combine", buf, token_slot, weights, keep)
    return _Combine.apply(buf, token_slot, weights, keep)


combine.launches = 0
