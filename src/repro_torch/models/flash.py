"""Memory-bounded flash attention in plain PyTorch with a custom backward
(port of ``repro/models/flash.py``).

Two-level blocking: an outer loop over query chunks, an inner loop over
key/value chunks, online softmax. The forward saves only ``(q, k, v, out,
lse)``; the backward recomputes each probability block from the saved
logsumexp, so residual memory is O(L), not O(L^2).

Supports causal masking, a sliding window, GQA (fewer KV heads than query
heads), absolute position offsets and a value head width ``hdv`` apart
from ``hd``. The masking arithmetic is the reference's: masked scores are
filled with the finite ``NEG_INF``, so a block whose keys are all masked
for a row gives p = 1 at m = NEG_INF, which the next block's correction
``exp(m - m_new)`` wipes out (``-inf`` would give NaN there).

A key block that no query row of a chunk can see (above the causal
diagonal, or before the window of the chunk's first row) is skipped: for
a row that sees some key, such a block adds exactly nothing (p = 0,
correction 1 in the forward; zero products in the backward), so skipping
it changes no bit. A chunk holding a real row that sees no key at all
visits every block, as the reference does.

Inside ``full_bands()``, ``banded_flash_attention`` computes each band
with plain full attention instead: the reference's ``use_full``
cost-accounting mode, which the meta-device dry run
(``launch/dryrun.py``) selects as the reference's unrolled costing does.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, List, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
_FULL_BANDS = contextvars.ContextVar("full_bands", default=False)


@contextlib.contextmanager
def full_bands() -> Iterator[None]:
    """Within: ``banded_flash_attention`` takes its ``use_full`` cost
    mode."""
    token = _FULL_BANDS.set(True)
    try:
        yield
    finally:
        _FULL_BANDS.reset(token)


def _pad_axis(x: torch.Tensor, mult: int, axis: int) -> Tuple[torch.Tensor, int]:
    """``x`` zero-padded at the end of ``axis`` to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x, 0
    cfg = [0, 0] * (x.dim() - axis % x.dim())
    cfg[-1] = pad
    return F.pad(x, cfg), pad


def _block_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                window: int, lk_real: int) -> torch.Tensor:
    """(Cq, Ck) validity of one block from absolute positions: keys past
    ``lk_real`` (padding) and at negative positions (front padding) are
    masked."""
    m = ((kpos[None, :] < lk_real) & (kpos[None, :] >= 0)).expand(
        qpos.shape[0], kpos.shape[0])
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def _key_range(qp: int, causal: bool, window: int, kv_offset: int,
               lk: int) -> Tuple[int, int]:
    """[lo, hi] of the absolute key positions query position ``qp`` sees
    (empty when lo > hi)."""
    lo, hi = max(kv_offset, 0), kv_offset + lk - 1
    if causal:
        hi = min(hi, qp)
    if window > 0:
        lo = max(lo, qp - window + 1)
    return lo, hi


def _visits(lq: int, q_chunk: int, nk: int, kv_chunk: int, causal: bool,
            window: int, q_offset: int, kv_offset: int, lk: int) -> List[List[int]]:
    """Per query chunk, the key blocks to visit: those that meet the hull
    of its real rows' key ranges; every block where a real row sees no
    key."""
    out = []
    for i in range(-(-lq // q_chunk)):
        first = q_offset + i * q_chunk
        last = q_offset + min((i + 1) * q_chunk, lq) - 1
        lo0, hi0 = _key_range(first, causal, window, kv_offset, lk)
        lo1, hi1 = _key_range(last, causal, window, kv_offset, lk)
        # both ends of a key range grow with the query position, so the
        # chunk's rows all see some key iff its first and last rows do
        if lo0 > hi0 or lo1 > hi1:
            out.append(list(range(nk)))
            continue
        out.append([j for j in range(nk)
                    if kv_offset + j * kv_chunk <= hi1
                    and kv_offset + (j + 1) * kv_chunk - 1 >= lo0])
    return out


def _chunks(x: torch.Tensor, n: int, c: int, axis: int = 1):
    return x.narrow(axis, n * c, c)


def _flash_fwd_impl(q, k, v, causal, window, q_offset, kv_offset, q_chunk,
                    kv_chunk):
    b, lq, h, hd = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    rep = h // kvh
    scale = hd ** -0.5
    dev = q.device
    qp, _ = _pad_axis(q, q_chunk, 1)
    kp, _ = _pad_axis(k, kv_chunk, 1)
    vp, _ = _pad_axis(v, kv_chunk, 1)
    nq, nk = qp.shape[1] // q_chunk, kp.shape[1] // kv_chunk
    visits = _visits(lq, q_chunk, nk, kv_chunk, causal, window, q_offset,
                     kv_offset, lk)
    out = torch.empty((b, nq * q_chunk, h, hdv), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, nq * q_chunk), dtype=torch.float32, device=dev)
    for i in range(nq):
        qf = _chunks(qp, i, q_chunk).float() * scale
        qpos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q_chunk, hdv), dtype=torch.float32, device=dev)
        for j in visits[i]:
            kj = _chunks(kp, j, kv_chunk).repeat_interleave(rep, 2).float()
            vj = _chunks(vp, j, kv_chunk).repeat_interleave(rep, 2).float()
            kpos = kv_offset + j * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kj)
            mask = _block_mask(qpos, kpos, causal, window, kv_offset + lk)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vj)
            m = m_new
        lc = torch.clamp_min(l, 1e-30)
        lse[:, :, i * q_chunk:(i + 1) * q_chunk] = m + torch.log(lc)
        out[:, i * q_chunk:(i + 1) * q_chunk] = (acc / lc[..., None]).transpose(1, 2)
    return out[:, :lq].to(q.dtype), lse[:, :, :lq]


def _flash_bwd_impl(q, k, v, out, lse, do, causal, window, q_offset,
                    kv_offset, q_chunk, kv_chunk):
    b, lq, h, hd = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    rep = h // kvh
    scale = hd ** -0.5
    delta = torch.einsum("blhd,blhd->bhl", do.float(), out.float())   # (B,H,Lq)
    qp, _ = _pad_axis(q, q_chunk, 1)
    dop, _ = _pad_axis(do, q_chunk, 1)
    lsep, _ = _pad_axis(lse, q_chunk, 2)
    dlt, _ = _pad_axis(delta, q_chunk, 2)
    kp, _ = _pad_axis(k, kv_chunk, 1)
    vp, _ = _pad_axis(v, kv_chunk, 1)
    nq, nk = qp.shape[1] // q_chunk, kp.shape[1] // kv_chunk
    visits = _visits(lq, q_chunk, nk, kv_chunk, causal, window, q_offset,
                     kv_offset, lk)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros((b, nq * q_chunk, h, hd), **f32)
    dk = torch.zeros((b, nk * kv_chunk, kvh, hd), **f32)
    dv = torch.zeros((b, nk * kv_chunk, kvh, hdv), **f32)
    for i in range(nq):
        qf = _chunks(qp, i, q_chunk).float()
        dof = _chunks(dop, i, q_chunk).float()
        lsei = _chunks(lsep, i, q_chunk, 2)
        dlti = _chunks(dlt, i, q_chunk, 2)
        qpos = q_offset + i * q_chunk + torch.arange(q_chunk, device=q.device)
        dqi = torch.zeros((b, q_chunk, h, hd), **f32)
        for j in visits[i]:
            ke = _chunks(kp, j, kv_chunk).repeat_interleave(rep, 2).float()
            ve = _chunks(vp, j, kv_chunk).repeat_interleave(rep, 2).float()
            kpos = kv_offset + j * kv_chunk + torch.arange(kv_chunk, device=q.device)
            s = torch.einsum("bqhd,bkhd->bhqk", qf * scale, ke)
            mask = _block_mask(qpos, kpos, causal, window, kv_offset + lk)
            s = s.masked_fill(~mask, NEG_INF)
            p = torch.exp(s - lsei[..., None])                     # (B,H,Cq,Ck)
            dve = torch.einsum("bhqk,bqhd->bkhd", p, dof)
            dp = torch.einsum("bqhd,bkhd->bhqk", dof, ve)
            ds = p * (dp - dlti[..., None]) * scale
            dqi = dqi + torch.einsum("bhqk,bkhd->bqhd", ds, ke)
            dke = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            # collapse the expanded heads back onto their KV heads
            _chunks(dk, j, kv_chunk).add_(dke.reshape(b, kv_chunk, kvh, rep, hd).sum(3))
            _chunks(dv, j, kv_chunk).add_(dve.reshape(b, kv_chunk, kvh, rep, hdv).sum(3))
        dq[:, i * q_chunk:(i + 1) * q_chunk] = dqi
    return (dq[:, :lq].to(q.dtype), dk[:, :lk].to(k.dtype),
            dv[:, :lk].to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The reference's ``jax.custom_vjp``: residuals (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_offset, q_chunk,
                kv_chunk):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, q_offset,
                                   kv_offset, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, q_offset, kv_offset, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, do, *ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_offset: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B, Lq, H, hd); k: (B, Lk, KV, hd); v: (B, Lk, KV, hdv). Returns
    (B, Lq, H, hdv) in q's dtype; query i sits at absolute position
    ``q_offset + i``, key j at ``kv_offset + j``."""
    return _FlashAttention.apply(q, k, v, causal, window, q_offset, kv_offset,
                                 q_chunk, kv_chunk)


def banded_flash_attention(q, k, v, window: int, q_offset: int = 0,
                           q_chunk: int = 1024,
                           kv_chunk: int = 512) -> torch.Tensor:
    """Causal sliding-window attention with block skipping: each query
    chunk visits only its key band [chunk_start - wpad, chunk_end), so the
    work is O(L * (window + q_chunk)) instead of the masked O(L^2).
    Gradients flow through each band's ``flash_attention`` (O(band)
    residuals per chunk). Inside ``full_bands()`` each band is plain full
    attention over its positions, the reference's ``use_full``
    cost-accounting mode."""
    use_full = _FULL_BANDS.get()
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    if q_chunk % kv_chunk:
        raise ValueError(f"q_chunk {q_chunk} is not a multiple of kv_chunk {kv_chunk}")
    wpad = -(-window // kv_chunk) * kv_chunk
    qp, _ = _pad_axis(q, q_chunk, 1)
    nq = qp.shape[1] // q_chunk
    # front-pad by wpad (masked through kpos < 0), back-pad to cover the
    # query padding
    back = max(0, nq * q_chunk - lk)
    kp = F.pad(k, (0, 0, 0, 0, wpad, back))
    vp = F.pad(v, (0, 0, 0, 0, wpad, back))
    band = wpad + q_chunk
    outs = []
    for i in range(nq):
        qi = qp[:, i * q_chunk:(i + 1) * q_chunk]
        ks = kp[:, i * q_chunk:i * q_chunk + band]
        vs = vp[:, i * q_chunk:i * q_chunk + band]
        if use_full:
            from repro_torch.models.attention import full_attention
            qpos = q_offset + i * q_chunk + torch.arange(q_chunk, device=q.device)
            kpos = q_offset + i * q_chunk - wpad + torch.arange(band, device=q.device)
            outs.append(full_attention(qi, ks, vs, causal=True, window=window,
                                       qpos=qpos, kpos=kpos))
        else:
            outs.append(flash_attention(
                qi, ks, vs, True, window, q_offset + i * q_chunk,
                q_offset + i * q_chunk - wpad, q_chunk, kv_chunk))
    return torch.cat(outs, dim=1)[:, :lq]
