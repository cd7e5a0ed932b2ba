"""MoE token dispatch / combine: the row gathers around the expert FFN.

Routing is precomputed into slot tables (``ops.routing_tables``), so both
ops are pure gathers:

  dispatch: buf[s] = x[slot_token[s]] * valid[s]        (S = E*C slots)
  combine : y[t]  = sum_k w[t,k] * keep[t,k] * buf[token_slot[t,k]]

Kernels (``csrc/moe_dispatch.cu``) replace the TPU kernels of
``repro/kernels/moe_dispatch.py`` (``_dispatch_impl``/``_dispatch_kernel``
and ``_combine_impl``/``_make_combine_kernel``). Their bytes are few, so
the launch and the chain of dependent loads set their time on the H100:
dispatch moves each slot row once as 16-byte words, a flat grid of one
thread per word, or per two words of a row past 4 KB, with evict-first
stores for outputs of 16 MB or more (``dispatch_plan``); combine sums the
K rows of a token in f32, one warp per token or, for wide rows at few
tokens or k > 4, one thread per 16-byte word of the output
(``combine_plan``), and launches as a programmatic dependent launch (PDL)
of the kernel before it. Each function's plain version is
``ref.dispatch_ref`` / ``ref.combine_ref``.

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
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import combine_ref, dispatch_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
# combine's grids (csrc/moe_dispatch.cu): rows, one warp per token, 4 a
# block, its lanes taking ROW_PASS_WORDS 16-byte words of the row a pass
# and ROW_STEP rows a dependent step; cols, one thread per word of the
# output
ROW_PASS_WORDS = 32 * 4
ROW_STEP = 4
ROW_WARPS_PER_SM = 4     # warps per SM the rows grid wants to hide its latency
# dispatch's plan: two words a thread for rows past WIDE_ROW_BYTES, else
# one; evict-first stores for outputs of STREAM_BYTES or more
WIDE_ROW_BYTES = 4096
STREAM_BYTES = 16 << 20

plain_dispatch = dispatch_ref
plain_combine = combine_ref


def _check_tables(name, idx: torch.Tensor, ndim: int) -> None:
    if idx.dtype != torch.int32 or idx.dim() != ndim:
        raise TypeError(f"{name}: index table must be {ndim}-D int32, got "
                        f"{idx.dim()}-D {idx.dtype}")


def dispatch_plan(n_slots: int, row_bytes: int) -> Tuple[int, bool]:
    """(words a thread, evict-first stores) of B2's grid, from shapes alone.
    One thread per 16-byte word already holds 32 KB in flight on an SM of
    2,048 resident threads, about what the card's latency at its bandwidth
    asks, so the words a thread follow what ran faster on the card: two
    for rows past ``WIDE_ROW_BYTES`` (dbrx-132b's 12 KB and
    deepseek-v3-671b's 14 KB rows: 3-5% faster at decode, equal at the
    prefills), else one (zcode-m3-base's 1-2 KB rows). Outputs of
    ``STREAM_BYTES`` or more (the prefills of the wide-row models) store
    evict-first: the next kernel would not find them in the 50 MB L2, and
    the stores stop evicting the token rows that every slot of a token
    reads again (6-7% faster at the long prefills). The copy is
    dtype-blind, so the element size plays no part, nor the card: rows of
    narrower words (not whole 16-byte words, or unaligned bases) take the
    same plan."""
    return (2 if row_bytes > WIDE_ROW_BYTES else 1), n_slots * row_bytes >= STREAM_BYTES


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def dispatch_word(x: torch.Tensor, out: torch.Tensor) -> int:
    """The word B2 moves rows in (csrc/moe_dispatch.cu::dispatch_word): the
    widest of 16, 4, 2 and 1 bytes that divides a row and both bases."""
    any_ = x.data_ptr() | out.data_ptr() | x.shape[1] * x.element_size()
    return next(w for w in (16, 4, 2, 1) if any_ % w == 0)


def launch_dispatch(x: torch.Tensor, slot_token: torch.Tensor, slot_valid: torch.Tensor,
                    out: torch.Tensor, plan: Optional[Tuple[int, bool]] = None
                    ) -> Tuple[int, bool]:
    """One launch of B2's kernel into ``out`` on the current stream, on
    ``plan`` (words a thread, evict-first stores), ``dispatch_plan``'s
    unless given. Checks nothing and counts nothing: ``dispatch`` does
    both. Returns the plan it launched."""
    t, d = x.shape
    s = slot_token.shape[0]
    row = d * x.element_size()
    per, stream = plan or dispatch_plan(s, row)
    fn = build.function("repro_moe_dispatch", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    build.check(fn(x.data_ptr(), slot_token.data_ptr(), slot_valid.data_ptr(),
                   out.data_ptr(), t, s, row, per, int(stream), build.stream_of(x)),
                "dispatch")
    return per, stream


def _dispatch_fwd(x: torch.Tensor, slot_token: torch.Tensor,
                  slot_valid: torch.Tensor) -> torch.Tensor:
    build.calls["dispatch"] += 1
    if x.device.type == "cpu":
        return plain_dispatch(x, slot_token, slot_valid)
    build.require_cuda("dispatch", x, slot_token, slot_valid)
    out = torch.empty((slot_token.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    per, stream = launch_dispatch(x, slot_token, slot_valid, out)
    dispatch.launches += 1
    build.launched_variants.add(("dispatch", dispatch_word(x, out), per, stream))
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


def combine_plan(n_tokens: int, k: int, d: int, itemsize: int, sms: int) -> bool:
    """True for the cols grid (one thread per 16-byte word of the output),
    False for rows (one warp per token), from shapes alone. Rows where a
    warp reads its row in one pass (every zcode-m3-base site); else cols
    where the rows grid puts fewer than ROW_WARPS_PER_SM warps on an SM
    (decode at any k, dbrx-132b's 256-token prefill) or takes a token's k
    rows in more than one dependent step (k > ROW_STEP: deepseek-v3-671b's
    top-8), and rows at many tokens of k <= ROW_STEP (dbrx-132b's
    2,304-token prefill), where the two ran within a few percent."""
    if d * itemsize <= 16 * ROW_PASS_WORDS:
        return False
    return n_tokens < ROW_WARPS_PER_SM * sms or k > ROW_STEP


def plan_of(buf: torch.Tensor, token_slot: torch.Tensor) -> bool:
    """``combine_plan`` for combine's inputs, on buf's card."""
    t, k = token_slot.shape
    return combine_plan(t, k, buf.shape[1], buf.element_size(), _sm_count(buf.device))


def launch_combine(buf: torch.Tensor, token_slot: torch.Tensor, weights: torch.Tensor,
                   keep: torch.Tensor, out: torch.Tensor, pdl: bool = True,
                   cols: Optional[bool] = None) -> None:
    """One launch of B3's kernel into ``out`` on the current stream, on
    the grid ``plan_of`` picks unless ``cols`` is given; as a programmatic
    dependent of the kernel before it where ``pdl`` (eagerly, and as a
    programmatic edge under CUDA-graph capture). Checks nothing and counts
    nothing: ``combine`` does both."""
    s, d = buf.shape
    t, k = token_slot.shape
    fn = build.function("repro_moe_combine",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
    build.check(fn(buf.data_ptr(), token_slot.data_ptr(), weights.data_ptr(),
                   keep.data_ptr(), out.data_ptr(), t, s, k, d,
                   build.DTYPE_CODES[buf.dtype],
                   int(plan_of(buf, token_slot) if cols is None else cols), int(pdl),
                   build.stream_of(buf)), "combine")


def _combine_fwd(buf: torch.Tensor, token_slot: torch.Tensor,
                 weights: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    build.calls["combine"] += 1
    if buf.device.type == "cpu":
        return plain_combine(buf, token_slot, weights, keep)
    build.require_cuda("combine", buf, token_slot, weights, keep)
    d = buf.shape[1]
    t, k = token_slot.shape
    out = torch.empty((t, d), dtype=buf.dtype, device=buf.device)
    if out.numel() == 0:
        return out
    launch_combine(buf, token_slot, weights, keep, out)
    combine.launches += 1
    # the 16-byte vector path or not, top-1 or k rows (the rule of
    # csrc/moe_dispatch.cu::launch_combine), the grid
    vec = (d % (16 // buf.element_size()) == 0 and buf.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    build.launched_variants.add(("combine", buf.dtype, min(k, 2), vec,
                                 plan_of(buf, token_slot)))
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


def variant_info(kind: str, dtype: torch.dtype = torch.float32, word: int = 16,
                 k: int = 1, vec: bool = True, cols: bool = False,
                 per_thread: int = 1, stream: bool = False) -> dict:
    """What the card reports for one compiled kernel: registers per thread,
    shared memory per block (bytes), spill bytes per thread and resident
    blocks per SM. ``kind``: ``"dispatch"`` (rows moved in ``word``-byte
    words: 16, 4, 2 or 1, ``per_thread`` of them a thread, 1 or 2, with
    evict-first stores where ``stream``; any dtype) or ``"combine"`` (``dtype``, on the
    cols grid where ``cols`` else rows, its top-1 instance at k = 1 else
    the k-row one, on the 16-byte vector path where ``vec``). Builds the
    library; needs a card."""
    info = (ctypes.c_int * 4)()
    fn = build.function("repro_moe_dispatch_variant_info", [_I, _I, _I, _I, _I, _I, _I, _I, _P])
    build.check(fn(("dispatch", "combine").index(kind), build.DTYPE_CODES[dtype], word,
                   per_thread, int(stream), k, int(vec), int(cols), ctypes.cast(info, _P)),
                "repro_moe_dispatch_variant_info")
    return dict(zip(("registers", "smem_bytes", "spill_bytes", "blocks_per_sm"), info))
