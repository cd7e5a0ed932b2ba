"""Flash decode attention: one query token per row against a KV cache,
contiguous (B5) or paged (B6).

``flash_decode``: q (B, H, hd), k/v (B, S, KV, hd), index scalar or (B,):
positions past index[b] are masked; softmax in f32; output in q's dtype.
Its kernel replaces the TPU kernel
``repro/kernels/flash_decode.py::_flash_decode_jit`` / ``_kernel``, whose
grid walks S sequentially carrying the online-softmax state.

``flash_decode_paged``: the same over a page arena k/v (n_pages + 1, ps,
KV, hd) through block tables (B, nb): row b's logical position p lives at
arena page ``block_tables[b, p // ps]``, offset ``p % ps``. Its kernel
replaces ``_flash_decode_paged_jit`` / ``_paged_kernel``, whose DMA
prologue gathers the pages.

Both are bound by bytes on the H100 (every live K/V row read once). Their
kernels (``csrc/flash_decode.cu``) split the cache over blocks
(flash-decoding): the grid is (KV x head groups, B, n_split), each block
takes one contiguous range of positions, a multiple of ``TILE``, and
stages its K/V rows into shared memory with 16-byte asynchronous copies,
and the last block of a (row, kv head, head group) to finish merges the
ranges' partial softmax states in range order, in the same launch. One
query head per kv head runs on the CUDA cores; grouped-query heads (rep
> 1) on a bf16 cache with a head dim a multiple of 16 run on the tensor
cores (bf16 ``mma.sync``, an f32 query and the softmax weights as three
bf16 parts each, so every product is exact in f32), and otherwise on CUDA
cores whose lanes hold 8 heads' q in registers; either way each staged K/V
row serves every head of its block. A block takes a head group of up to
``HEAD_GROUP`` = 8 query heads of one kv head, so rep 12 (starcoder2-3b)
runs two blocks per kv head, each reading its cache. ``split_plan`` picks
the ranges from the cache's capacity, the rows, the kv heads, the head
groups and the SM count alone,
never from ``index``, so the wrapper reads nothing from the device and a
call can be captured in a CUDA graph. B5 and B6 share the plan and the device body, so
B6 equals B5 bitwise on the contiguous cache its tables address. A cache
of at most 192 positions (every serving shape) takes ``n_split`` 1: one
block per (row, kv head), no workspace, no merge.

Their plain versions are ``ref.flash_decode_ref`` and
``ref.flash_decode_paged_ref``.

A build with ``REPRO_SMEM_CHECK=1`` in the environment (a library of its
own, see ``kernels/build.py``) checks every shared-memory address the
bodies use and every cache and table read against their extents, and
traps on the first outside; ``check_record`` returns what it found. Off
by default.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``flash_decode.launches`` and ``flash_decode_paged.launches``
count launches. Decode only: like the reference's kernels they have no
backward, so a call with grad mode on and an input that requires grad
raises rather than return a tensor cut off from autograd (on both
devices).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_decode_paged_ref, flash_decode_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
HEAD_GROUP = 8       # query heads a block takes at rep > 1 (csrc/flash_decode.cu's kMaxRep)
# the kernels' widest head; the reference's configs use 64 (zcode-m3,
# hymba-1.5b, whisper-small) and 128 (yi-6b, dbrx-132b, codeqwen1.5-7b,
# starcoder2-3b, llama-3.2-vision-90b), none wider
MAX_HEAD_DIM = 128
# split plan (TILE is csrc/flash_decode.cu's kTile)
TILE = 64              # positions per staged tile
MIN_SPLIT_TILES = 2    # a shorter range is not worth a partial and a merge
MAX_SPLIT_TILES = 64   # bounds B6's table slice in shared memory
BLOCKS_PER_SM = 4      # blocks wanted over the card before ranges stop shrinking

plain = flash_decode_ref
plain_paged = flash_decode_paged_ref


def head_groups(rep: int) -> int:
    """Blocks per (row, kv head, split): head groups of ``HEAD_GROUP``."""
    return -(-rep // HEAD_GROUP)


def split_plan(capacity: int, rows: int, kv_heads: int, sms: int,
               groups: int = 1) -> Tuple[int, int]:
    """(n_split, positions per split) for a cache of ``capacity`` positions
    (B5: S; B6: n_blocks * page_size) read by ``rows * kv_heads * groups``
    blocks per split (``groups``: head groups per kv head) on a card of
    ``sms`` SMs. Split i covers positions [i * per,
    min((i + 1) * per, capacity)); ``per`` is a multiple of ``TILE``. A
    cache of fewer than 2 * ``MIN_SPLIT_TILES`` tiles (at most 192
    positions) takes one split. Else ranges shrink until the grid holds
    about ``BLOCKS_PER_SM`` blocks per SM, but not below
    ``MIN_SPLIT_TILES`` tiles, and hold at most ``MAX_SPLIT_TILES``. The
    range is picked first and rounded up, so a grid that wants more blocks
    than the cache has ranges of ``MIN_SPLIT_TILES`` takes all of them
    (yi-6b's 57 tiles over 8 (row, kv head) pairs: 29 of 2 tiles, not 19
    of 3)."""
    tiles = max(1, math.ceil(capacity / TILE))
    if tiles < 2 * MIN_SPLIT_TILES:
        return 1, tiles * TILE
    want = math.ceil(BLOCKS_PER_SM * sms / max(1, rows * kv_heads * groups))
    per = min(MAX_SPLIT_TILES, max(MIN_SPLIT_TILES, math.ceil(tiles / want)))
    return math.ceil(tiles / per), per * TILE


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_of(q: torch.Tensor, k: torch.Tensor,
            block_tables: Optional[torch.Tensor] = None,
            sms: Optional[int] = None) -> Tuple[int, int]:
    """``split_plan`` for B5's inputs (q, k) or, given ``block_tables``,
    B6's (q, arena k, tables): from shapes alone. ``sms`` defaults to the
    SM count of q's card."""
    cap = k.shape[1] * (block_tables.shape[1] if block_tables is not None else 1)
    return split_plan(cap, q.shape[0], k.shape[2], sms or _sm_count(q.device),
                      head_groups(q.shape[1] // k.shape[2]))


def _workspace(q: torch.Tensor, kv: int, n_split: int) -> Optional[torch.Tensor]:
    """f32 partial states (m, l and the unnormalised output per query head
    of a head group) of every split of every (row, kv head, head group),
    merged inside the launch, each a whole number of 16-byte words; none
    for one split."""
    if n_split == 1:
        return None
    b, h, hd = q.shape
    rep = h // kv
    stride = -(-min(rep, HEAD_GROUP) * (hd + 2) // 4) * 4
    return torch.empty(b * kv * head_groups(rep) * n_split * stride, dtype=torch.float32,
                       device=q.device)


_split_lock = threading.Lock()
_split_streams: dict = {}   # device index -> stream of the last eager launch that split


def _launch(q: torch.Tensor, n_split: int, call):
    """Returns ``call()``, the kernel's launch. A launch that splits counts
    its blocks in at the library's arrival counters (one per (row, kv head,
    head group),
    zero between launches because the merging block resets its own), so two
    such launches must not run at once: an eager one is ordered after the
    last one on its card, whatever that one's stream. A launch captured
    into a CUDA graph is not ordered so: replay a graph that splits only
    while no other launch that splits runs."""
    if n_split == 1:
        return call()
    with _split_lock:
        if not torch.cuda.is_current_stream_capturing():
            stream = torch.cuda.current_stream(q.device)
            last = _split_streams.get(q.device.index)
            if last is not None and last != stream:
                stream.wait_stream(last)
            _split_streams[q.device.index] = stream
        return call()


def _check_common(name: str, q, k, v) -> None:
    if k.dtype != v.dtype:
        raise TypeError(f"{name}: k {k.dtype} vs v {v.dtype}")
    build.require_dtype(name, q, _DTYPES)
    build.require_dtype(name, k, _DTYPES)
    build.require_contiguous(name, q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f"{name} has no backward (decode only): call "
                           "it under torch.no_grad() or on detached inputs")


def _check_kernel_shape(name: str, hd: int) -> None:
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: kernel takes head_dim <= {MAX_HEAD_DIM} (the "
                         f"reference's configs use 64 and 128), got {hd}")


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
    build.calls["flash_decode"] += 1
    if q.device.type == "cpu":
        return plain(q, k, v, index)
    idx = torch.as_tensor(index, device=q.device)
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int32)
    idx = idx.reshape(-1).expand(b).contiguous()
    rep = h // kv
    _check_kernel_shape("flash_decode", hd)
    build.require_cuda("flash_decode", q, k, v, idx)
    out = torch.empty_like(q)
    if out.numel() == 0 or s == 0:
        return out.zero_()
    n_split, per = plan_of(q, k)
    ws = _workspace(q, kv, n_split)
    fn = build.function("repro_flash_decode",
                        [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _I, _I, _P])
    build.check(_launch(q, n_split, lambda: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
        out.data_ptr(), ws.data_ptr() if ws is not None else None, b, s, kv, rep, hd, n_split,
        per, hd ** -0.5, build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k.dtype],
        build.stream_of(q))), "flash_decode")
    flash_decode.launches += 1
    build.launched_variants.add(("flash_decode", False, q.dtype, k.dtype, hd, rep, per))
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
    build.calls["flash_decode_paged"] += 1
    if q.device.type == "cpu":
        return plain_paged(q, k, v, block_tables, index)
    rep = h // kv
    _check_kernel_shape("flash_decode_paged", hd)
    idx = index.contiguous()
    build.require_cuda("flash_decode_paged", q, k, v, block_tables, idx)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_split, per = plan_of(q, k, block_tables)
    ws = _workspace(q, kv, n_split)
    fn = build.function("repro_flash_decode_paged",
                        [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, ctypes.c_float, _I, _I, _P])
    build.check(_launch(q, n_split, lambda: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), block_tables.data_ptr(), idx.data_ptr(),
        int(idx.dtype == torch.int64), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, b, nb, ps, n_arena, kv, rep, hd, n_split,
        per, hd ** -0.5, build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k.dtype],
        build.stream_of(q))), "flash_decode_paged")
    flash_decode_paged.launches += 1
    build.launched_variants.add(("flash_decode_paged", True, q.dtype, k.dtype, hd, rep, per,
                                 ps))
    return out


flash_decode_paged.launches = 0


def variant_info(paged: bool, q_dtype: torch.dtype, kv_dtype: torch.dtype, hd: int = 64,
                 rep: int = 1, per: int = 2 * TILE, ps: int = 16) -> dict:
    """What the card reports for B5's (or B6's) kernel at head dim ``hd``,
    ``rep`` query heads per kv head, ``per`` positions per split and page
    size ``ps``: registers per thread, shared memory per block (bytes),
    spill bytes per thread and resident blocks per SM. Builds the library;
    needs a card."""
    info = (ctypes.c_int * 4)()
    fn = build.function("repro_flash_decode_variant_info",
                        [_I, _I, _I, _I, _I, _I, _I, _P])
    build.check(fn(int(paged), build.DTYPE_CODES[q_dtype], build.DTYPE_CODES[kv_dtype], hd, rep,
                   per, ps, ctypes.cast(info, _P)),
                "repro_flash_decode_variant_info")
    return dict(zip(("registers", "smem_bytes", "spill_bytes", "blocks_per_sm"), info))


# what each record's site names (csrc/flash_decode.cu's CheckSite, from 1)
CHECK_SITES = ("cp.async destination", "cp.async cache source", "staged-row padding",
               "tensor-core zeroed V row", "ldmatrix K row", "ldmatrix V row",
               "staged K read", "staged V read", "q in shared memory", "table slice",
               "table read", "warp outputs")


def check_record() -> Optional[dict]:
    """The address check's record (a build with ``REPRO_SMEM_CHECK=1``):
    None while no access has failed the check, else the first that did:
    its site, block, thread, byte offset from the region's start, width and
    the region's extent (shared memory: past its 128-byte alignment; K/V:
    the cache or arena; tables: all of them). Host memory: readable after
    the trap has cost the context. Raises on a build without the check."""
    rec = (ctypes.c_int * 11)()
    fn = build.function("repro_flash_decode_check_record", [_P])
    build.check(fn(ctypes.cast(rec, _P)), "repro_flash_decode_check_record")
    if not rec[0]:
        return None
    lo_hi = lambda lo, hi: (hi << 32) | (lo & 0xffffffff)  # noqa: E731
    return {"site": CHECK_SITES[rec[1] - 1], "block": (rec[2], rec[3], rec[4]),
            "thread": rec[5], "offset": lo_hi(rec[6], rec[7]), "bytes": rec[8],
            "extent": lo_hi(rec[9], rec[10])}
