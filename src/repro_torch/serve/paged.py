"""Paged KV cache: page arena + block tables + host page allocator (port of
``repro/serve/paged.py``, vLLM-style, DESIGN.md §13).

The slot pool (``engine.init_slot_pool``) reserves a full ``max_seq``
cache row per request slot, so short requests strand most of their
reservation. Here the SLOT axis of every full-length attention-cache leaf
becomes a PHYSICAL PAGE axis:

  slot pool  : (repeats, n_slots + 1, seq_len, ...)   one row per slot
  page arena : (repeats, n_pages + 1, page_size, ...) pages shared by all

A request's logical position p lives at arena ``[table[p // ps], p % ps]``
where ``table`` is its (n_blocks,) block-table row, managed on the host by
``PageAllocator`` (refcounted: prefix sharing and copy-on-write need pages
with several owners). Arena page ``n_pages`` is a SCRATCH page: dead
slots' tables point every block at it, and prefill write-tables send
shared and beyond-prompt blocks there. Scratch bytes are only ever read at
positions the ``pos <= index`` predicate masks to zero probability, so
writes that collide there (many rows, one scratch page) are harmless; a
real page never appears twice in one write.

Which leaves page is found structurally (``_cache_page_axes``): leaves
whose shape tracks ``max_seq`` (the self-attention K/V) page; the others
(the cross-attention K/V) keep the slot-pool layout, both in one cache
tree and one decode step. A VLM's gated cross layer holds cross K/V
alone: it reads no block table, and its cache stays slot-addressed.

The reference's arrays are immutable; the port updates the arena and the
slot leaves IN PLACE (scatter, copy-on-write, swap-in), and every read
that must outlive a later write is a copy: advanced indexing
(``leaf[:, table_row]``, ``index_select``) copies, and ``copy_pages``
reads all sources before it writes any destination.

Exactness: paged decode equals slot-pool decode. Cache writes happen
before the attention read, gathers are copies, and every position past a
row's depth scores ``NEG_INF``, whose probability is exactly 0.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_step, init_cache, prefill
from repro_torch.serve.engine import _cache_batch_axes, cross_len
from repro_torch.tree import flatten_with_paths, tree_map


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# structural discovery: which cache leaves page
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _cache_page_axes(cfg: ModelConfig):
    """(batch_axes, seq_axes) leaf-aligned trees for the decode cache.

    ``seq_ax >= 0`` marks a PAGEABLE leaf (its shape tracks ``max_seq``),
    found by diffing ``init_cache`` leaf shapes at two cache lengths on the
    meta device. Pageable leaves must have the layout ``(repeats, batch,
    seq, ...)``."""
    a = init_cache(cfg, 2, 16, device="meta")
    b = init_cache(cfg, 2, 24, device="meta")

    def axis(x, y):
        diff = [i for i, (m, n) in enumerate(zip(x.shape, y.shape)) if m != n]
        if len(diff) > 1:
            raise ValueError(f"ambiguous seq axis {x.shape} vs {y.shape}")
        return diff[0] if diff else -1

    seq = tree_map(axis, a, b)
    bat = _cache_batch_axes(cfg)

    def check(ab, as_):
        if as_ >= 0 and not (ab == 1 and as_ == 2):
            raise ValueError(f"pageable leaf with batch axis {ab}, seq axis "
                             f"{as_}: need (repeats, batch, seq, ...)")

    tree_map(check, bat, seq)
    return bat, seq


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of a page arena. ``seq_len`` is the logical cache
    length, meta-inclusive (``max_seq + n_meta``; ``make_layout``);
    ``n_blocks = ceil(seq_len / page_size)`` is every block table's
    width. Arena leaves carry ``n_pages + 1`` pages: the last one
    (index ``n_pages``) is the shared scratch page."""
    page_size: int
    n_pages: int
    seq_len: int

    @property
    def n_blocks(self) -> int:
        return ceil_div(self.seq_len, self.page_size)

    @property
    def scratch(self) -> int:
        return self.n_pages

    def pages_for(self, n_positions: int) -> int:
        """Pages holding logical positions [0, n_positions)."""
        return ceil_div(n_positions, self.page_size)


def make_layout(cfg: ModelConfig, max_seq: int, page_size: int,
                n_pages: int) -> PagedLayout:
    """The arena of a ``max_seq``-token cache: its logical positions
    include the hybrid's meta tokens. Only self-attention K/V page, so the
    geometry is the same whatever share of the layers holds cross K/V
    alone (a VLM's gated layers)."""
    return PagedLayout(page_size=page_size, n_pages=n_pages,
                       seq_len=max_seq + cfg.n_meta)


# ---------------------------------------------------------------------------
# host-side page allocator (refcounted)
# ---------------------------------------------------------------------------

class PagePoolExhausted(RuntimeError):
    pass


class PageAllocator:
    """Free-list page allocator with per-page refcounts.

    ``alloc`` hands out the lowest-numbered free page first (from a FIFO of
    returned pages: deterministic schedules give deterministic placement);
    ``incref`` adds an owner (a prefix-cache entry, a sharing request);
    ``decref`` releases one and returns the page to the free list at
    refcount zero. Double free and use after free raise."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages {n_pages}")
        self.n_pages = n_pages
        self._free = deque(range(n_pages))
        self._ref = np.zeros(n_pages, np.int64)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return int((self._ref > 0).sum())

    def ref(self, page: int) -> int:
        return int(self._ref[page])

    def try_alloc(self) -> Optional[int]:
        if not self._free:
            return None
        page = self._free.popleft()
        if self._ref[page] != 0:
            raise RuntimeError(f"free page {page} has refcount {self._ref[page]}")
        self._ref[page] = 1
        return page

    def alloc(self) -> int:
        page = self.try_alloc()
        if page is None:
            raise PagePoolExhausted(f"all {self.n_pages} KV pages are referenced")
        return page

    def incref(self, page: int):
        if self._ref[page] <= 0:
            raise RuntimeError(f"incref on free page {page}")
        self._ref[page] += 1

    def decref(self, page: int):
        if self._ref[page] <= 0:
            raise RuntimeError(f"double free of page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)

    def check(self):
        """Conservation invariant: every page is free xor referenced."""
        held = int((self._ref > 0).sum())
        if ((self._ref < 0).any() or held + len(self._free) != self.n_pages
                or len(set(self._free)) != len(self._free)):
            raise AssertionError(f"page accounting broken: {held} held, "
                                 f"{len(self._free)} free of {self.n_pages}")


# ---------------------------------------------------------------------------
# token-hash prefix cache (host)
# ---------------------------------------------------------------------------

class PrefixCache:
    """LRU map from token-prefix keys to physical page lists.

    Two key families: ``("PG", f, prefix_bytes)``, the first ``f`` FULL
    pages of a prompt whose page-covered token prefix is ``prefix_bytes``
    (a page's content depends only on the tokens up to its last position,
    by causality); and ``("FULL", n, prompt_bytes)``, a whole prompt with
    its partial tail page, so identical prompts share everything and the
    first divergent DECODE write copies the tail page (copy-on-write). The
    cache holds one refcount per page per entry; eviction (LRU, under
    allocation pressure) only decrefs, so pages still owned by live
    requests survive until their last owner retires."""

    def __init__(self, alloc: PageAllocator):
        self._alloc = alloc
        self._entries: "OrderedDict[Tuple, List[int]]" = OrderedDict()
        self.hits = 0
        self.lookups = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key) -> Optional[List[int]]:
        pages = self._entries.get(key)
        if pages is not None:
            self._entries.move_to_end(key)
        return pages

    def put(self, key, pages: List[int]):
        if key in self._entries:
            return
        for p in pages:
            self._alloc.incref(p)
        self._entries[key] = list(pages)

    def evict_one(self) -> bool:
        """Drop the LRU entry; True if an entry was dropped."""
        if not self._entries:
            return False
        _, pages = self._entries.popitem(last=False)
        for p in pages:
            self._alloc.decref(p)
        return True

    def evictable_pages(self) -> int:
        """Pages that would return to the free list if every entry were
        evicted: referenced only by cache entries, not by any slot."""
        cref: Dict[int, int] = {}
        for pages in self._entries.values():
            for p in pages:
                cref[p] = cref.get(p, 0) + 1
        return sum(1 for p, c in cref.items() if self._alloc.ref(p) == c)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


# ---------------------------------------------------------------------------
# device-side paged pool primitives (all in place)
# ---------------------------------------------------------------------------

def paged_pool_like(batch: Dict[str, Any], cfg: ModelConfig, *, max_seq: int,
                    n_slots: int, layout: PagedLayout):
    """Paged decode pool shaped like the caches ``prefill`` produces for
    ``batch`` (the cross-K/V length follows its source, ``cross_len``:
    source tokens, audio frames or image embeddings; a decoder-only batch
    has no cross leaves), on the batch's device.
    Pageable leaves become page arenas ``(..., n_pages + 1, page_size,
    ...)``; the others keep the slot-pool layout over ``n_slots`` rows
    (callers include the scratch slot)."""
    fresh = init_cache(cfg, 1, max_seq, device="meta", n_cross=cross_len(batch))
    bat, seq = _cache_page_axes(cfg)
    device = batch["tokens"].device

    def alloc(fr, ab, as_):
        shape = list(fr.shape)
        if as_ >= 0:
            if fr.shape[as_] != layout.seq_len:
                raise ValueError(f"cache length {fr.shape[as_]} != layout "
                                 f"{layout.seq_len}")
            shape[ab] = layout.n_pages + 1
            shape[as_] = layout.page_size
        elif ab >= 0:
            shape[ab] = n_slots
        else:
            shape.insert(1, n_slots)
        return torch.zeros(shape, dtype=fr.dtype, device=device)

    return tree_map(alloc, fresh, bat, seq)


def _put_slot_rows(pool_leaf, fresh_leaf, ax: int, slots: torch.Tensor):
    """``engine._scatter_slots`` for one slot-addressed leaf, in place."""
    n = slots.shape[0]
    pool_ax = ax if ax >= 0 else 1
    if ax >= 0:
        rows = fresh_leaf.movedim(ax, 0)
    else:
        rows = fresh_leaf.unsqueeze(0).expand((n,) + fresh_leaf.shape)
    pool_leaf.movedim(pool_ax, 0)[slots] = rows.to(pool_leaf.dtype)
    return pool_leaf


def scatter_pages(pool, fresh, cfg: ModelConfig, write_tables: torch.Tensor,
                  slot_rows: torch.Tensor, layout: PagedLayout):
    """Write per-request prefill caches into the paged pool, in place.

    ``write_tables`` (W, n_blocks) routes each request's logical block to
    its DESTINATION page; entries pointing at the scratch page skip the
    write in effect (shared prefix pages whose content already exists,
    blocks past the request's allocation, dummy admission rows).
    ``slot_rows`` (W,) routes the slot-addressed leaves as
    ``engine._scatter_slots`` does (the scratch slot for dummies)."""
    bat, seq = _cache_page_axes(cfg)
    ps, nb = layout.page_size, layout.n_blocks
    w = write_tables.shape[0]
    flat = write_tables.reshape(-1).long()

    def put(pool_leaf, fr, ab, as_):
        if as_ < 0:
            return _put_slot_rows(pool_leaf, fr, ab, slot_rows)
        rep, rest = fr.shape[0], tuple(fr.shape[3:])
        pad = nb * ps - fr.shape[2]
        f = torch.nn.functional.pad(fr, (0, 0) * len(rest) + (0, pad)) if pad else fr
        f = f.reshape((rep, w, nb, ps) + rest).permute(
            (1, 2, 0, 3) + tuple(range(4, 4 + len(rest))))
        f = f.reshape((w * nb, rep, ps) + rest)
        pool_leaf.movedim(1, 0)[flat] = f.to(pool_leaf.dtype)
        return pool_leaf

    return tree_map(put, pool, fresh, bat, seq)


def prefill_into_pages(params, batch: Dict[str, Any], lengths: torch.Tensor,
                       write_tables: torch.Tensor, slot_rows: torch.Tensor,
                       pool, cfg: ModelConfig, *, max_seq: int,
                       layout: PagedLayout):
    """Prefill a group of new requests into their allocated pages.

    The full prompt is always COMPUTED (prefix caching saves cache memory,
    not prefill FLOPs: a shared page is simply not re-written, keeping the
    cached bytes pristine for its other owners); the write table decides
    which produced blocks land in the arena. Returns (logits (W, V) at each
    row's last real token, pool)."""
    logits, fresh = prefill(params, batch, cfg, max_seq=max_seq,
                            last_index=lengths - 1)
    pool = scatter_pages(pool, fresh, cfg, write_tables, slot_rows, layout)
    return logits[:, 0], pool


def decode_paged_step(params, pool, block_tables: torch.Tensor,
                      tok: torch.Tensor, pos: torch.Tensor, alive: torch.Tensor,
                      cfg: ModelConfig, *, local_routing: bool = False,
                      flash_decode: bool = False, ctx=None):
    """One batched paged ``decode_step`` over all S block-table rows at
    per-row positions: the paged twin of ``engine.decode_pool_step``
    (under an expert-parallel ``ctx`` the rows and the arena are this
    rank's)."""
    lg, pool = decode_step(params, pool, tok[:, None], pos, cfg,
                           local_routing=local_routing, token_valid=alive,
                           flash_decode=flash_decode,
                           block_tables=block_tables, ctx=ctx)
    return lg[:, 0], pool


def copy_pages(pool, cfg: ModelConfig, src: torch.Tensor, dst: torch.Tensor):
    """Copy-on-write: arena pages ``src[i] -> dst[i]`` on every pageable
    leaf, in place. Every source is read (a copy) before any destination
    is written, so one call is safe even when a freed source page is
    another pair's destination. Callers pad with scratch -> scratch
    pairs."""
    _, seq = _cache_page_axes(cfg)

    def cp(leaf, as_):
        if as_ >= 0:
            leaf[:, dst] = leaf[:, src]
        return leaf

    return tree_map(cp, pool, seq)


def gather_slot_state(pool, cfg: ModelConfig, table_row: torch.Tensor,
                      slot: int):
    """Swap-out reads (preemption): a slot's pages gathered page-major
    ``(repeats, n_blocks, page_size, ...)`` plus its slot-addressed leaf
    rows. Both are copies (advanced indexing, ``index_select``), so the
    host may hand the pages out again at once."""
    bat, seq = _cache_page_axes(cfg)
    row = torch.full((1,), slot, device=table_row.device)   # a fill: no copy

    def g(leaf, ab, as_):
        if as_ >= 0:
            return leaf[:, table_row]
        return leaf.index_select(ab if ab >= 0 else 1, row)

    return tree_map(g, pool, bat, seq)


def restore_slot_state(pool, cfg: ModelConfig, saved, table_row: torch.Tensor,
                       slot: int):
    """Swap-in writes, in place: the inverse of ``gather_slot_state``
    against a FRESH page allocation ``table_row``. Values round-trip
    bitwise, so a preempted request's outputs do not change. ``saved``
    holds host arrays or tensors (``hostsync.fetch`` of the gather); to a
    card they go through pinned memory, so the copy waits for nothing."""
    bat, seq = _cache_page_axes(cfg)

    def r(leaf, sv, ab, as_):
        sv = torch.as_tensor(sv)
        if leaf.device.type == "cuda":
            sv = sv.pin_memory().to(leaf.device, non_blocking=True)
        sv = sv.to(device=leaf.device, dtype=leaf.dtype)
        if as_ >= 0:
            leaf.movedim(1, 0)[table_row] = sv.movedim(1, 0)
        else:
            pool_ax = ab if ab >= 0 else 1
            leaf.narrow(pool_ax, slot, 1).copy_(sv)
        return leaf

    return tree_map(r, pool, saved, bat, seq)


def paged_kv_bytes(pool, cfg: ModelConfig) -> int:
    """Bytes of the PAGEABLE leaves of ``pool``: the memory the page arena
    pins (or, for a slot pool, the self-attention K/V it reserves)."""
    _, seq = _cache_page_axes(cfg)
    sizes = tree_map(lambda leaf, as_: leaf.numel() * leaf.element_size()
                     if as_ >= 0 else 0, pool, seq)
    return int(sum(flatten_with_paths(sizes).values()))
