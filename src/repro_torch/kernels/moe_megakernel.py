"""Fused MoE FFN: gather + expert FFN + weighted scatter in one launch.

  y[t] = sum_k wcomb[t, k] * FFN_e(x[t])     for the slot (e, c) of (t, k)

The kernels (``csrc/moe_megakernel.cu``) replace the TPU kernel
``repro/kernels/moe_megakernel.py::_fused_impl``. The (E, C, d) expert
buffer never exists in device memory: the kernel gathers each expert's
slot rows, runs both matmuls with the activation between them in f32, and
scatters the weighted output rows into a zeroed (T, d) f32 buffer, which
is cast once to x's dtype. An expert none of whose slots carries weight
(``live_experts``) adds nothing and is not read (8.4 MB per expert of
zcode-m3-base in f32). What bounds it depends on C: at C <= 16 (decode,
serving, training) at most 8 flops per f32 byte of weights, so the bytes
of the live experts' weights; at C >= 128 (the prefills of dbrx-132b and
deepseek-v3-671b) 64-576, so the f32 FFMA rate of the CUDA cores (TF32
misses the f32 gate).

``variant`` picks one of two designs per call, each one launch:

* ``"streaming"`` (C <= 16, rows of d and f of 16-byte multiples, 16-byte
  aligned pointers: every decode and training call). A persistent grid
  walks two phases of items over the live experts only: (expert, chunk of
  f) items write h = act(x_e @ w_in) to an f32 workspace, then (expert,
  slice of d, half of f) items add wslot x (h @ w_out) to the output once
  the expert's h is whole; each streams its weight tile through a ring of
  tensor copies (one producer warp, as B1's streaming forward). Top-1
  calls give the same bits on every run and replay under a CUDA graph (the
  per-expert counts are zeroed with the output, in the same fill).
* ``"tiled"`` (anything else: C > 16, as at every prefill of the MoE
  archs, ragged rows, misaligned views), at any d: the same two phases on
  B1's register tile shaped 64 x 256. Units are (live expert, 64-row tile
  of slots up to its last weighted slot); phase-A items (unit, 256 columns
  of f, or 128 of w_gate with the same 128 of w_in when gated) gather x
  through slot_token and write h = act(..) in f32 to an E x C x f workspace;
  phase-B items (unit, 256 columns of d) run h @ w_out over all of f in
  registers and add wslot x acc with one f32 atomicAdd per (slot, column),
  after waiting on the unit's phase-A count. Items are fetched from one
  counter in order, phase A first, so none waits on a block that has not
  started. A top-1 output element receives one add onto zero: the same
  bits on every run. ``tiled_plan`` is its launch (shared memory,
  workspace, counts) from the shapes.

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
like the TPU kernel, the CUDA kernels keep every intermediate in f32.

A CPU tensor takes the plain version; a CUDA tensor launches a kernel or
raises. ``fused_moe.launches`` counts launches of either variant,
``fused_moe.launches_streaming`` those that took the streaming kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_ffn import TILED_STAGES, tiled_vec
from repro_torch.kernels.ref import fused_moe_f32_ref, fused_moe_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
_ACTS = {"gelu": 0, "silu": 1}
STREAM_MAX_C = 16

plain = fused_moe_f32_ref


def variant(c: int, d: int, f: int, itemsize: int, *addresses: int) -> str:
    """The kernel a call with C slots per expert, model width d and expert
    width f of ``itemsize``-byte weights takes on the card:
    ``"streaming"`` where 1 <= C <= 16, rows of d and of f are whole
    16-byte words and every address (x, w_in, w_gate, w_out) is 16-byte
    aligned (its bulk copies need all three), else ``"tiled"``.
    ``repro_fused_moe_stream`` checks it again."""
    if (1 <= c <= STREAM_MAX_C and (d * itemsize) % 16 == 0
            and (f * itemsize) % 16 == 0 and all(a % 16 == 0 for a in addresses)):
        return "streaming"
    return "tiled"


TILE_ROWS = 64          # the tiled kernel's slot rows per unit (its tile: 64 x 256)
TILE_COLS = 256
SMEM_MAX = 232448       # an H100 block's opt-in shared memory


def tiled_plan(e: int, c: int, d: int, f: int, itemsize: int, gated: bool) -> dict:
    """The tiled kernel's launch for E experts of C slots, width d and
    expert width f with ``itemsize``-byte weights, from the shapes alone
    (what ``csrc/moe_megakernel.cu::launch_tiled`` launches): the row tiles
    per expert, phase-A and phase-B items per live unit, the ring's stages,
    its dynamic shared memory (the ring, sized for the larger phase: x by
    w_in or f32 h by w_out; then a byte per unit and a few ints per
    expert), the f32 workspace (h, E x C x f) and the int32 counts (one per
    unit, then the item counter), both allocated by the wrapper."""
    stages = TILED_STAGES
    kb = 32 * TILE_COLS * itemsize                                 # a weight tile

    def stage(rows_bytes: int) -> int:
        return -(-(rows_bytes + kb) // 128) * 128

    ring = stages * max(stage(TILE_ROWS * (32 + 16 // itemsize) * itemsize),   # x rows
                        stage(TILE_ROWS * (32 + 4) * 4))                       # h rows, f32
    rt = -(-c // TILE_ROWS)

    def r16(n: int) -> int:
        return -(-n // 16) * 16

    tables = r16(e * rt) + r16(4 * e) + r16(4 * (e + 1)) + 4 * TILE_ROWS + 16
    return {"row_tiles": rt, "threads": 256, "stages": stages,
            "items_per_unit": (-(-f // (TILE_COLS // 2 if gated else TILE_COLS)),
                               -(-d // TILE_COLS)),
            "smem_bytes": ring + tables, "workspace_bytes": e * c * f * 4,
            "counts": e * rt + 1}


def _slot_weights(wcomb: torch.Tensor, token_slot: torch.Tensor,
                  into: torch.Tensor) -> torch.Tensor:
    """wslot[s] = sum of wcomb over the (t, k) whose token_slot is s, added
    into ``into`` (zeros, one per slot)."""
    return into.index_add_(0, token_slot.reshape(-1), wcomb.reshape(-1))


def live_experts(topk_w: torch.Tensor, keep: torch.Tensor,
                 token_slot: torch.Tensor, n_experts: int,
                 n_slots: int) -> torch.Tensor:
    """(E,) bool: the experts that hold a slot of non-zero weight, the
    only ones whose weights the kernels read (``fused_moe``'s arguments;
    with softmax top-k, the experts holding a kept slot)."""
    wcomb = (topk_w * keep).float()
    wslot = _slot_weights(wcomb, token_slot.clamp(0, n_slots - 1), wcomb.new_zeros(n_slots))
    return (wslot.reshape(n_experts, -1) != 0).any(1)


def _kernel(x, w_in, w_gate, w_out, wcomb, slot_token, token_slot,
            act: str) -> torch.Tensor:
    tensors = [x, w_in, w_out, wcomb, slot_token, token_slot]
    if w_gate is not None:
        tensors.append(w_gate)
    build.require_cuda("fused_moe", *tensors)
    t, d = x.shape
    e, _, f = w_in.shape
    s = slot_token.shape[0]
    c = s // e
    gated = w_gate is not None
    ptrs = [x.data_ptr(), w_in.data_ptr(), w_out.data_ptr()]
    if gated:
        ptrs.append(w_gate.data_ptr())
    streaming = variant(c, d, f, x.element_size(), *ptrs) == "streaming"
    n_counts = e if streaming else tiled_plan(e, c, d, f, x.element_size(), gated)["counts"]
    # the output, the slot weights and the kernel's counts (int32) zeroed by
    # one fill
    zeros = torch.zeros(t * d + s + n_counts, dtype=torch.float32, device=x.device)
    out = zeros[:t * d].view(t, d)
    if out.numel() == 0 or s == 0 or f == 0:
        return out.to(x.dtype)
    wslot = _slot_weights(wcomb, token_slot, zeros[t * d:t * d + s])
    h = torch.empty(e * c * f, dtype=torch.float32, device=x.device)
    counts = zeros[t * d + s:].view(torch.int32)
    name = "repro_fused_moe_stream" if streaming else "repro_fused_moe"
    fn = build.function(name, [_P] * 9 + [_I] * 7 + [_P])
    code = fn(x.data_ptr(), w_in.data_ptr(), None if w_gate is None else w_gate.data_ptr(),
              w_out.data_ptr(), slot_token.data_ptr(), wslot.data_ptr(), out.data_ptr(),
              h.data_ptr(), counts.data_ptr(), t, e, c, d, f, _ACTS[act],
              build.DTYPE_CODES[x.dtype], build.stream_of(x))
    build.check(code, name)
    fused_moe.launches += 1
    fused_moe.launches_streaming += streaming
    if streaming:
        build.launched_variants.add(("fused_moe", "stream_gated" if gated else "stream",
                                     x.dtype, c))
    else:
        build.launched_variants.add(("fused_moe", "tiled_gated" if gated else "tiled", x.dtype,
                                     c, tiled_vec(d, f, x.element_size(), *ptrs)))
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
        build.calls["fused_moe"] += 1
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


fused_moe.launches = fused_moe.launches_streaming = 0


def variant_info(kind: str, dtype: torch.dtype, c: int, vec: bool = True) -> dict:
    """What the card reports for one compiled kernel: registers per thread,
    shared memory per block (bytes), spill bytes per thread and resident
    blocks per SM. ``kind``: ``"stream"`` or ``"stream_gated"`` (at C
    rounded up to 1, 4, 8 or 16; shared memory for 128 experts),
    ``"tiled"`` or ``"tiled_gated"`` (shared memory for 128 experts of C
    slots; ``vec``: the 16-byte instance, else the element-load one).
    Builds the library; needs a card."""
    code = ("stream", "tiled", "tiled_gated", "stream_gated").index(kind)
    if kind.startswith("tiled") and not vec:
        code += 3
    info = (ctypes.c_int * 4)()
    fn = build.function("repro_fused_moe_variant_info", [_I, _I, _I, _P])
    build.check(fn(code, build.DTYPE_CODES[dtype], c,
                   ctypes.cast(info, _P)), "repro_fused_moe_variant_info")
    return dict(zip(("registers", "smem_bytes", "spill_bytes",
                     "blocks_per_sm"), info))
