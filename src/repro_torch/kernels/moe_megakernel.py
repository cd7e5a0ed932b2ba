"""Fused MoE FFN: gather + expert FFN + weighted scatter in one launch.

  y[t] = sum_k wcomb[t, k] * FFN_e(x[t])     for the slot (e, c) of (t, k)

The kernel (``csrc/moe_megakernel.cu``) replaces the TPU kernel
``repro/kernels/moe_megakernel.py::_fused_impl``. The (E, C, d) expert
buffer never exists in device memory: each block gathers its expert's slot
rows, runs both matmuls with the activation between them in f32, and
scatters its weighted output rows into a zeroed (T, d) f32 buffer, which
is cast once to x's dtype. Bound by the bytes of the expert weights
(1.07 GB per MoE layer of zcode-m3-base in f32).

Weights arrive folded, as in the reference's ``_fused_jit``: ``wcomb =
topk_w * keep`` (capacity drops, Gate-Drop local validity and serving's
``token_valid`` are all in ``keep``), computed inside the op so the
gradient reaches ``topk_w`` and through it the router. Per slot, ``wslot``
sums the wcomb of the (t, k) that own it: every kept (t, k) owns exactly
one slot, dropped ones add weight 0 to their clipped slot 0
(``moe_megakernel.py:118-119``).

The backward is the reference's (``_fused_bwd``): the gradient of the
plain slot formulation ``ref.fused_moe_ref`` in the inputs' own dtypes,
which JAX takes with ``jax.vjp`` in jnp/XLA outside any Pallas kernel;
here autograd through the same plain torch ops (gather, ``torch.bmm``,
weighted gather), on both devices. The forward's plain version is
``ref.fused_moe_f32_ref``, the same formulation on inputs upcast to f32:
like the TPU kernel, the CUDA kernel keeps every intermediate in f32.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``fused_moe.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_moe_f32_ref, fused_moe_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
_ACTS = {"gelu": 0, "silu": 1}
MAX_D = 1024          # model widths the kernel holds (columns per thread x threads)

plain = fused_moe_f32_ref


def _slot_weights(wcomb: torch.Tensor, token_slot: torch.Tensor,
                  n_slots: int) -> torch.Tensor:
    """wslot[s] = sum of wcomb over the (t, k) whose token_slot is s."""
    return wcomb.new_zeros((n_slots,)).index_add_(
        0, token_slot.reshape(-1).long(), wcomb.reshape(-1))


def _kernel(x, w_in, w_gate, w_out, wcomb, slot_token, token_slot,
            act: str) -> torch.Tensor:
    tensors = [x, w_in, w_out, wcomb, slot_token, token_slot]
    if w_gate is not None:
        tensors.append(w_gate)
    build.require_cuda("fused_moe", *tensors)
    t, d = x.shape
    e, _, f = w_in.shape
    s = slot_token.shape[0]
    if d > MAX_D:
        raise ValueError(f"fused_moe: the kernel takes d <= {MAX_D}, got {d}")
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    if out.numel() == 0 or s == 0 or f == 0:
        return out.to(x.dtype)
    wslot = _slot_weights(wcomb, token_slot, s)
    fn = build.function("repro_fused_moe",
                        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _P])
    build.check(fn(x.data_ptr(), w_in.data_ptr(),
                   None if w_gate is None else w_gate.data_ptr(),
                   w_out.data_ptr(), slot_token.data_ptr(), wslot.data_ptr(),
                   out.data_ptr(), t, e, s // e, d, f, _ACTS[act],
                   build.DTYPE_CODES[x.dtype], build.stream_of(x)),
                "fused_moe")
    fused_moe.launches += 1
    return out.to(x.dtype)


class _FusedMoE(torch.autograd.Function):
    """One Function on both devices: the forward takes the plain version
    on the CPU and the kernel on the card; the backward is autograd
    through the plain slot formulation on either."""

    @staticmethod
    def forward(ctx, x, w_in, w_gate, w_out, wcomb, slot_token, slot_valid,
                token_slot, act):
        ctx.save_for_backward(x, w_in, w_gate, w_out, wcomb, slot_token,
                              slot_valid, token_slot)
        ctx.act = act
        if x.device.type == "cpu":
            return plain(x, w_in, w_gate, w_out, wcomb, slot_token,
                         slot_valid, token_slot, act)
        return _kernel(x, w_in, w_gate, w_out, wcomb, slot_token, token_slot,
                       act)

    @staticmethod
    def backward(ctx, dy):
        (x, w_in, w_gate, w_out, wcomb, slot_token, slot_valid,
         token_slot) = ctx.saved_tensors
        diff = [x, w_in, w_gate, w_out, wcomb]
        want = [i for i, (a, need) in enumerate(zip(diff, ctx.needs_input_grad))
                if a is not None and need]
        grads = [None] * 5
        if want:
            with torch.enable_grad():
                leaves = [a.detach().requires_grad_(i in want) if a is not None
                          else None for i, a in enumerate(diff)]
                y = fused_moe_ref(*leaves, slot_token, slot_valid, token_slot,
                                  ctx.act)
                got = torch.autograd.grad(y, [leaves[i] for i in want], dy)
            for i, g in zip(want, got):
                grads[i] = g
        return (*grads, None, None, None, None)


def fused_moe(x: torch.Tensor, w_in: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_out: torch.Tensor, topk_w: torch.Tensor, keep: torch.Tensor,
              slot_token: torch.Tensor, slot_valid: torch.Tensor,
              token_slot: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """One-launch fused MoE layer (the reference's ``fused_moe_ffn``).

    x: (T, d); w_in / w_gate: (E, d, f); w_out: (E, f, d); topk_w / keep:
    (T, K) routing weights and keep mask; slot_token / slot_valid: (E*C,),
    token_slot: (T, K) — the ``ops.RoutingTables``. Returns (T, d) in x's
    dtype; differentiable in x, the weights and topk_w."""
    if x.dim() != 2 or w_in.dim() != 3 or w_out.dim() != 3:
        raise ValueError(f"fused_moe: x {tuple(x.shape)}, w_in "
                         f"{tuple(w_in.shape)}, w_out {tuple(w_out.shape)}")
    e, d, f = w_in.shape
    s = slot_token.shape[0]
    if x.shape[1] != d or w_out.shape != (e, f, d) or s % e \
            or (w_gate is not None and w_gate.shape != w_in.shape):
        raise ValueError(f"fused_moe: x {tuple(x.shape)}, w_in {tuple(w_in.shape)}, "
                         f"w_out {tuple(w_out.shape)}, {s} slots")
    if x.shape[0] == 0:
        raise ValueError("fused_moe: no tokens to gather from")
    if topk_w.shape != token_slot.shape or keep.shape != token_slot.shape \
            or keep.dtype != torch.bool:
        raise ValueError("fused_moe: topk_w and keep (bool) must match "
                         f"token_slot's shape {tuple(token_slot.shape)}")
    if slot_token.dtype != torch.int32 or token_slot.dtype != torch.int32 \
            or slot_valid.dtype != torch.bool or slot_valid.shape != slot_token.shape:
        raise TypeError("fused_moe: slot_token/token_slot int32, slot_valid bool")
    if act not in _ACTS:
        raise ValueError(f"fused_moe: act {act!r}")
    build.require_dtype("fused_moe", w_in, _DTYPES)
    for w in (w_gate, w_out):
        if w is not None and w.dtype != w_in.dtype:
            raise TypeError(f"fused_moe: weights {w.dtype} vs {w_in.dtype}")
    # folded inside the op so gradients reach topk_w; x in the weights'
    # dtype, the result back in x's (the reference's _fused_jit)
    wcomb = (topk_w * keep).float()
    ts = token_slot.clamp(0, s - 1).to(torch.int32)
    xw = x.to(w_in.dtype).contiguous()
    build.require_contiguous("fused_moe", xw, w_in, w_out, slot_token,
                             slot_valid, ts,
                             *(() if w_gate is None else (w_gate,)))
    y = _FusedMoE.apply(xw, w_in, w_gate, w_out, wcomb, slot_token,
                        slot_valid, ts, act)
    return y.to(x.dtype)


fused_moe.launches = 0
