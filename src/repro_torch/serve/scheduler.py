"""Continuous-batching request schedulers (port of
``repro/serve/scheduler.py``, Orca/vLLM pattern, DESIGN.md §9 and §13).

The one-shot engine runs one batch start to finish: every request waits
for the whole batch and the batch waits for its slowest sequence. The
schedulers serve a request queue on the engine's slot primitives:

  * a FIFO request queue with arrival times;
  * a persistent decode cache whose rows are request slots
    (``ContinuousScheduler``) or a page arena addressed through block
    tables (``PagedScheduler``);
  * length-bucketed admission: new prompts are right-padded to the
    smallest configured bucket and prefilled in groups whose width is
    padded to a power of two (at most ``admit_width``), dummy rows sent to
    a scratch slot or page. Expert capacity depends on the token count,
    so these are the reference's batch shapes exactly. Where padding
    would change a request's cache (``needs_exact_prefill``: an SSM state,
    which integrates the pads, or a sliding window's ring, which a padded
    prompt past the window overruns), prompts are prefilled at their exact
    length instead, in groups of one length;
  * one batched decode step over ALL slots at per-slot positions; a slot
    retires the moment its request finishes (EOS or its token budget) and
    is re-prefilled with the next queued prompt while the others decode.

Each tick moves its host state (tokens, positions, alive mask, block
tables) to the device in one pinned non-blocking copy, and fetches the
tick's tokens and log-probs in one device-to-host read
(``analysis.hostsync.fetch``): the tick's one host sync. A preemption's
swap-out adds one more, as in the reference.

Spans and instants on the tracer (the reference's vocabulary and
arguments, host scalars only): ``sched.admit`` (queued),
``sched.prefill`` (bucket, group; the slot pool's admission groups),
``sched.decode`` (alive), ``prefix_cache.hit`` (rid, shared_pages) and
``prefix_cache.miss`` (rid), ``sched.swap_in`` (rid, pages),
``sched.preempt.swap_out`` (rid, slot) and ``sched.cow_flush`` (pairs,
width).

``static_batch_serve`` is the static-batching baseline: same-length
batches through the one-shot engine.

Output parity: with greedy decoding and non-binding eval expert capacity
(``eval_capacity_factor >= n_experts``), every request's tokens equal a
per-request one-shot ``generate`` run at the pool's cache length. Sampled
requests draw from the stream of (scheduler seed, request seed, token
index) (``engine._select_rows``), so sampling is placement-invariant too.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.hostsync import fetch
from repro_torch.configs.base import ModelConfig, PagedKVConfig
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import Tracer, get_tracer, monotonic
from repro_torch.serve.engine import (GenerateConfig, _check_local_routing,
                                      _select_rows, decode_pool_step,
                                      generate, prefill_into_slots,
                                      slot_pool_like, to_device,
                                      to_device_batch, to_device_packed)
from repro_torch.serve.paged import (PageAllocator, PagePoolExhausted,
                                     PrefixCache, _cache_page_axes, ceil_div,
                                     copy_pages,
                                     decode_paged_step, gather_slot_state,
                                     make_layout, paged_kv_bytes,
                                     paged_pool_like, prefill_into_pages,
                                     restore_slot_state)
from repro_torch.tree import flatten_with_paths


@dataclasses.dataclass
class Request:
    """One generation request. ``extras`` holds the family's conditioning
    inputs WITHOUT a batch axis (``enc_tokens (S,)``, ``frames (S,
    d_model)`` or ``img_embeds (n_img, d_image)``; float inputs reach the
    device in their own dtype). ``max_new`` caps
    this request's generated tokens (default the scheduler's
    ``GenerateConfig.max_new``); ``seed`` keys its sampling stream (default
    its ``rid``); ``arrival`` is in scheduler-clock seconds."""
    rid: int
    tokens: np.ndarray
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    max_new: Optional[int] = None
    seed: Optional[int] = None
    arrival: float = 0.0


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray          # (length,) generated tokens incl. EOS
    length: int
    score: float                # sum log p of emitted tokens
    arrival: float              # scheduler-clock seconds
    admitted_at: float          # prefill started (slot assigned)
    first_token_at: float       # TTFT reference point
    finished_at: float

    @property
    def ttft(self) -> float:
        return self.first_token_at - self.arrival

    @property
    def per_token_latency(self) -> float:
        return ((self.finished_at - self.arrival) / self.length
                if self.length else 0.0)


def needs_exact_prefill(cfg: ModelConfig, max_bucket: int) -> bool:
    """True when right-padded bucket prefill cannot reproduce exact-length
    prefill: an SSM state integrates the pads (the SSM and hybrid
    families); a sliding-window ring evicts real tokens once the padded
    length exceeds the window."""
    if cfg.ssm is not None:
        return True
    return cfg.sliding_window > 0 and max_bucket > cfg.sliding_window


def _params_device(params) -> torch.device:
    return next(iter(flatten_with_paths(params).values())).device


class ContinuousScheduler:
    """Slot-based continuous-batching serving loop (host-side driver).

    The device work is one prefill per admission group and ONE pool
    decode step per tick over every slot. The host keeps per-slot
    bookkeeping as numpy vectors and collects one token per live slot per
    tick. Runs on the device the parameters live on."""

    def __init__(self, params, cfg: ModelConfig, gen: GenerateConfig, *,
                 n_slots: int = 8,
                 prefill_buckets: Sequence[int] = (8, 16, 32, 64),
                 admit_width: Optional[int] = None,
                 max_seq: Optional[int] = None, seed: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        if gen.beam_width != 1:
            raise ValueError("continuous batching serves sampling/greedy "
                             "requests; beam search stays on the one-shot engine")
        _check_local_routing(cfg, gen)
        self.params = params
        self.device = _params_device(params)
        self.cfg = cfg
        self.gen = gen
        self.n_slots = n_slots
        self.buckets = tuple(sorted(prefill_buckets))
        # exact-length prefill: each admission group holds prompts of one
        # length, prefilled unpadded (no bucket cap on the prompt)
        self.exact_prefill = needs_exact_prefill(cfg, self.buckets[-1])
        self.admit_width = admit_width or min(4, n_slots)
        self.max_seq = max_seq or (self.buckets[-1] + gen.max_new)
        self.seed = seed
        # pool row n_slots is a scratch slot: admission groups are padded
        # with dummy rows that scatter there. The pool is allocated at the
        # first admission: the cross-K/V length follows the conditioning
        # inputs actually served.
        self.pool = None
        self._extras_shapes: Optional[Dict[str, Tuple]] = None
        S = n_slots + 1
        self._tok = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._ngen = np.zeros(S, np.int64)
        self._active = np.zeros(S, bool)
        self._done = np.zeros(S, bool)
        self._budget = np.full(S, gen.max_new, np.int64)
        self._length = np.zeros(S, np.int64)
        self._score = np.zeros(S, np.float64)
        self._seed = np.zeros(S, np.int64)
        self._slot_rid: List[Optional[int]] = [None] * S
        self._free = deque(range(n_slots))
        self._queue: deque[Request] = deque()
        self._buffers: Dict[int, List[int]] = {}
        self._meta: Dict[int, Dict[str, float]] = {}
        self._reqs: Dict[int, Request] = {}
        self.stats = {"admitted": 0, "finished": 0, "prefill_calls": 0,
                      "decode_steps": 0, "max_concurrent": 0,
                      "slot_reuse": 0}
        # one registry backs every serving metric of this scheduler
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else get_tracer()
        # (kind, tokens) per device call, in order: what --trace prices
        # with the comm bytes model (launch/serve.py::trace_comm_section)
        self._ticks = self.metrics.series(
            "serve/tick_log", "device calls: label=kind, value=tokens")
        # live-slot count per decode tick
        self._alive_series = self.metrics.series(
            "serve/alive_log", "live slots per decode tick")
        self._ttft = self.metrics.histogram(
            "serve/ttft_s", "arrival -> first token, seconds")
        self._lat = self.metrics.histogram(
            "serve/per_token_latency_s", "request seconds per token")
        self._slot_uses = np.zeros(n_slots, np.int64)
        # clock state so the tick API (submit + step) works without run()
        self._t0 = monotonic()
        self._skip = 0.0

    @property
    def tick_log(self) -> List[Tuple[str, int]]:
        return self._ticks.items

    @property
    def alive_log(self) -> List[int]:
        return self._alive_series.values

    # -- request intake -----------------------------------------------------

    def submit(self, req: Request):
        if req.tokens.ndim != 1:
            raise ValueError(f"request {req.rid}: tokens must be 1-D")
        if not self.exact_prefill and len(req.tokens) > self.buckets[-1]:
            raise ValueError(
                f"prompt length {len(req.tokens)} exceeds the largest "
                f"prefill bucket {self.buckets[-1]}; add a larger bucket "
                f"at scheduler init")
        budget = req.max_new or self.gen.max_new
        if budget > self.gen.max_new:
            raise ValueError(
                f"request max_new {budget} exceeds the scheduler's "
                f"GenerateConfig.max_new {self.gen.max_new}")
        # holds for bucketed admission by construction (bucket + max_new <=
        # max_seq); exact prefill has no bucket cap
        if len(req.tokens) + budget > self.max_seq:
            raise ValueError(
                f"prompt {len(req.tokens)} + budget {budget} exceeds the "
                f"pinned pool cache length max_seq={self.max_seq}; raise "
                f"max_seq= at scheduler init — the pool cannot grow")
        self._queue.append(req)
        self._reqs[req.rid] = req
        self._meta[req.rid] = {"arrival": req.arrival}

    def _bucket(self, n: int) -> int:
        if self.exact_prefill:
            return n
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} past every bucket")

    # -- scheduling ticks ---------------------------------------------------

    def _retire(self, now: float) -> List[RequestResult]:
        out = []
        for s in range(self.n_slots):
            rid = self._slot_rid[s]
            if rid is None or not self._done[s]:
                continue
            meta = self._meta[rid]
            res = RequestResult(
                rid=rid, tokens=np.asarray(self._buffers[rid], np.int64),
                length=int(self._length[s]), score=float(self._score[s]),
                arrival=meta["arrival"], admitted_at=meta["admitted_at"],
                first_token_at=meta["first_token_at"], finished_at=now)
            out.append(res)
            self._ttft.observe(res.ttft)
            self._lat.observe(res.per_token_latency)
            self._slot_rid[s] = None
            self._active[s] = False
            self._done[s] = False
            self._free.append(s)
            self.stats["finished"] += 1
        return out

    def _token_done(self, tok: int, ngen: int, budget: int) -> bool:
        """One-shot ``_advance`` semantics: done on EOS or budget reached."""
        return (self.gen.eos_id >= 0 and tok == self.gen.eos_id) \
            or ngen >= budget

    def _can_admit(self, req: Request) -> bool:
        """Admission gate beyond slot availability: the slot scheduler
        admits whenever a slot is free; the paged scheduler gates on free
        pages (reserving them, so a True answer cannot fail later)."""
        return True

    def _admit(self, now: float):
        if not (self._free and self._queue
                and self._queue[0].arrival <= now):
            return
        with self.tracer.span("sched.admit", queued=len(self._queue)):
            self._admit_loop(now)

    def _admit_loop(self, now: float):
        while self._free and self._queue \
                and self._queue[0].arrival <= now:
            # the head of the queue sets the bucket; same-bucket peers in
            # the eligible queue prefix join its group (the head is always
            # admitted: no starvation)
            if not self._can_admit(self._queue[0]):
                break                     # backpressure: keep FIFO order
            bucket = self._bucket(len(self._queue[0].tokens))
            group: List[Request] = []
            skipped: List[Request] = []
            while (self._queue and len(group) < self.admit_width
                   and len(group) < len(self._free)
                   and self._queue[0].arrival <= now):
                r = self._queue.popleft()
                if self._bucket(len(r.tokens)) == bucket \
                        and (group == [] or self._can_admit(r)):
                    group.append(r)
                else:
                    skipped.append(r)
            for r in reversed(skipped):
                self._queue.appendleft(r)
            if not group:
                break
            self._prefill_group(group, bucket, now)

    def _stage_group(self, group: List[Request], bucket: int):
        """Host-side admission staging shared by both schedulers: pad the
        group to the next power-of-two width (<= admit_width), assign freed
        slots, and build the host arrays of the admission batch."""
        W = 1
        while W < len(group):
            W *= 2
        tokens = np.full((W, bucket), self.gen.pad_id, np.int64)
        lengths = np.ones(W, np.int64)
        slots = np.full(W, self.n_slots, np.int64)      # dummies -> scratch
        seeds = np.zeros(W, np.int64)
        for i, req in enumerate(group):
            tokens[i, :len(req.tokens)] = req.tokens
            lengths[i] = len(req.tokens)
            s = self._free.popleft()
            slots[i] = s
            seeds[i] = req.seed if req.seed is not None else req.rid
            self._slot_rid[s] = req.rid
            self._slot_uses[s] += 1
            if self._slot_uses[s] > 1:
                self.stats["slot_reuse"] += 1
        host = {"tokens": tokens}
        for k in group[0].extras:
            rows = np.stack([r.extras[k] for r in group])
            if len(group) < W:
                fill = np.zeros((W - len(group),) + rows.shape[1:], rows.dtype)
                rows = np.concatenate([rows, fill], 0)
            host[k] = rows
        shapes = {k: tuple(v.shape[1:]) for k, v in host.items() if k != "tokens"}
        if self._extras_shapes is None:
            self._extras_shapes = shapes
        elif shapes != self._extras_shapes:
            raise ValueError(
                "every request of a serving process must carry the same "
                f"conditioning shapes: {shapes} != {self._extras_shapes}")
        return W, lengths, slots, seeds, host

    def _alloc_pool(self, batch):
        return slot_pool_like(batch, self.cfg, max_seq=self.max_seq,
                              n_slots=self.n_slots + 1)

    def _ensure_pool(self, batch):
        if self.pool is None:
            self.pool = self._alloc_pool(batch)

    def _first_tokens(self, logits, seeds):
        """Select each admitted row's first token; one host read."""
        tok0, lp0 = _select_rows(self.gen, logits.float(), self.seed, seeds,
                                 np.zeros(len(seeds), np.int64))
        out = fetch(torch.stack([tok0.double(), lp0.double()]))
        return out[0].astype(np.int64), out[1]

    def _finish_admission(self, group: List[Request], bucket: int, W: int,
                          lengths, slots, seeds, tok0, lp0, now: float):
        """Per-slot host bookkeeping once the admission prefill's first
        tokens are on the host."""
        t_first = self._now()
        for i, req in enumerate(group):
            s = int(slots[i])
            self._tok[s] = tok0[i]
            self._pos[s] = lengths[i]          # tok0 lives at position P
            self._ngen[s] = 1
            self._active[s] = True
            self._budget[s] = req.max_new or self.gen.max_new
            self._done[s] = self._token_done(int(tok0[i]), 1,
                                             int(self._budget[s]))
            self._length[s] = 1
            self._score[s] = lp0[i]
            self._seed[s] = seeds[i]
            self._buffers[req.rid] = [int(tok0[i])]
            self._meta[req.rid].update(admitted_at=now,
                                       first_token_at=t_first)
            self.stats["admitted"] += 1
        self.stats["prefill_calls"] += 1
        self._ticks.append(W * bucket, label="prefill")
        self.stats["max_concurrent"] = max(
            self.stats["max_concurrent"],
            int(self._active[:self.n_slots].sum()))

    def _prefill_group(self, group: List[Request], bucket: int, now: float):
        with self.tracer.span("sched.prefill", bucket=bucket, group=len(group)):
            W, lengths, slots, seeds, host = self._stage_group(group, bucket)
            dev = to_device_batch(dict(host, lengths=lengths, slots=slots),
                                  self.device)
            batch = {k: dev[k] for k in host}
            self._ensure_pool(batch)
            logits, self.pool = prefill_into_slots(
                self.params, batch, dev["lengths"], dev["slots"], self.pool,
                self.cfg, max_seq=self.max_seq)
            tok0, lp0 = self._first_tokens(logits, seeds)
            self._finish_admission(group, bucket, W, lengths, slots, seeds,
                                   tok0, lp0, now)

    def _tick_arrays(self, alive) -> Dict[str, np.ndarray]:
        """The decode tick's host state. Dead rows step at position 0 (a
        free or finished slot's stale position may lie past the cache):
        they write into their own slot row, or the scratch page, and their
        outputs are ignored."""
        return {"tok": self._tok, "pos": np.where(alive, self._pos, 0),
                "alive": alive}

    def _decode_call(self, alive):
        """Launch the pool decode step; returns (nxt, lp) device tensors."""
        dev = to_device_packed(self._tick_arrays(alive), self.device)
        lg, self.pool = decode_pool_step(
            self.params, self.pool, dev["tok"], dev["pos"], dev["alive"].bool(),
            self.cfg, local_routing=self.gen.local_routing,
            flash_decode=self.gen.flash_decode)
        return _select_rows(self.gen, lg.float(), self.seed, self._seed,
                            self._ngen)

    def _decode_tick(self):
        alive = self._active & ~self._done
        if not alive[:self.n_slots].any():
            return
        with self.tracer.span("sched.decode",
                              alive=int(alive[:self.n_slots].sum())):
            self._decode_tick_body(alive)

    def _decode_tick_body(self, alive):
        nxt, lp = self._decode_call(alive)
        # paged preemption can deactivate slots inside the decode call
        # (their rows decode dead, outputs ignored)
        alive = self._active & ~self._done
        self._alive_series.append(int(alive[:self.n_slots].sum()))
        out = fetch(torch.stack([nxt.double(), lp.double()]))   # the tick's one sync
        nxt, lp = out[0].astype(np.int64), out[1]
        for s in range(self.n_slots):
            if not alive[s]:
                continue
            self._buffers[self._slot_rid[s]].append(int(nxt[s]))
            self._tok[s] = nxt[s]
            self._pos[s] += 1
            self._ngen[s] += 1
            self._length[s] += 1
            self._score[s] += float(lp[s])
            self._done[s] = self._token_done(int(nxt[s]), int(self._ngen[s]),
                                             int(self._budget[s]))
        self.stats["decode_steps"] += 1
        self._ticks.append(self.n_slots + 1, label="decode")

    # -- driving loop -------------------------------------------------------

    def _now(self) -> float:
        return monotonic() - self._t0 + self._skip

    @torch.no_grad()
    def step(self, now: float) -> List[RequestResult]:
        """One scheduler tick: retire finished slots, admit eligible queued
        requests into freed slots, run one pool decode step."""
        finished = self._retire(now)
        self._admit(now)
        self._decode_tick()
        return finished

    def run(self, requests: Sequence[Request]) -> List[RequestResult]:
        """Serve ``requests`` (arrival-stamped) to completion. The clock is
        wall time, fast-forwarded across idle gaps between arrivals."""
        for r in sorted(requests, key=lambda r: r.arrival):
            self.submit(r)
        self._t0 = monotonic()
        self._skip = 0.0
        results: List[RequestResult] = []
        while self._queue or self._active[:self.n_slots].any():
            now = self._now()
            if (not self._active[:self.n_slots].any() and self._queue
                    and self._queue[0].arrival > now):
                self._skip += self._queue[0].arrival - now
                now = self._now()
            results.extend(self.step(now))
        results.extend(self._retire(self._now()))
        return sorted(results, key=lambda r: r.rid)


# ---------------------------------------------------------------------------
# paged scheduler (block-table addressed KV, DESIGN.md §13)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SwapState:
    """Host snapshot of a preempted slot: its scheduler scalars plus its
    device cache state (its pages, page-major, and its slot-addressed leaf
    rows) copied to host memory."""
    tok: int
    pos: int
    ngen: int
    budget: int
    length: int
    score: float
    seed: int
    saved: object


class PagedScheduler(ContinuousScheduler):
    """Continuous batching over a paged KV cache (DESIGN.md §13).

    The host driver of ``ContinuousScheduler`` with three paged behaviours
    through its hook methods:

      * ADMISSION BY FREE PAGES (``_can_admit``): a request is admitted
        only when its prompt's pages (minus prefix-cache hits) fit in the
        free list with ``reserve_pages`` headroom; the pages are reserved
        inside the gate. Backpressure keeps FIFO order.
      * PREFIX SHARING: full prompt pages (and whole identical prompts) are
        published to a ``PrefixCache`` after prefill; later requests point
        their leading block-table entries at the shared pages and skip
        re-writing them. The keys hold the conditioning inputs as well as
        the prompt (the reference keys on the prompt alone, which shares
        pages across different sources of the encoder-decoder).
      * COPY-ON-WRITE + PREEMPTION (``_ensure_writable``): before each
        decode tick every live slot's write block must be a private real
        page. A shared write page is copied (batched ``copy_pages``, padded
        to a power-of-two pair count); page exhaustion evicts cache
        entries, then preempts the youngest-admitted live slot: swap-OUT
        to host memory, not recompute, so re-admitted requests keep their
        outputs bitwise.

    Only the caches that track ``max_seq`` page (full-attention K/V); the
    rest (a sliding window's ring, an SSM's conv window and state) stay
    slot-addressed rows beside the arena, written at prefill and carried
    by a preemption's swap-out and swap-in. The hybrid's meta tokens take
    the first ``n_meta`` logical positions of every block table: page
    counts, the write block and the prefix keys include them, and the
    pages they fill alone hold the same bytes for every request, so they
    share one prefix key.
    """

    def __init__(self, params, cfg: ModelConfig, gen: GenerateConfig, *,
                 paged: PagedKVConfig = PagedKVConfig(), n_slots: int = 8,
                 prefill_buckets: Sequence[int] = (8, 16, 32, 64),
                 admit_width: Optional[int] = None,
                 max_seq: Optional[int] = None, seed: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        super().__init__(params, cfg, gen, n_slots=n_slots,
                         prefill_buckets=prefill_buckets,
                         admit_width=admit_width, max_seq=max_seq, seed=seed,
                         registry=registry, tracer=tracer)
        _, seq_axes = _cache_page_axes(cfg)
        if not any(a >= 0 for a in flatten_with_paths(seq_axes).values()):
            raise ValueError(f"{cfg.arch_id}: no cache leaf tracks max_seq (pure "
                             "SSM/ring cache) — nothing to page; use "
                             "ContinuousScheduler")
        self.paged = paged
        ps = paged.page_size
        self._n_meta = cfg.n_meta
        n_blocks = ceil_div(self.max_seq + self._n_meta, ps)
        n_pages = paged.n_pages or paged.n_slots_equiv * n_blocks
        if n_pages < n_blocks + paged.reserve_pages:
            raise ValueError(
                f"n_pages={n_pages} cannot hold one full-length request "
                f"({n_blocks} blocks of {ps}) plus reserve_pages="
                f"{paged.reserve_pages}; the scheduler could deadlock")
        self.layout = make_layout(cfg, self.max_seq, ps, n_pages)
        self._pages = PageAllocator(n_pages)
        self._prefix = PrefixCache(self._pages) if paged.prefix_caching else None
        # rid -> (reserved page list, #prefix-shared pages) while the
        # request sits between its _can_admit reservation and its prefill
        self._plans: Dict[int, Tuple[List[int], int]] = {}
        self._swapped: Dict[int, _SwapState] = {}
        self._cow_src: List[int] = []
        self._cow_dst: List[int] = []
        self._tables = np.full((n_slots + 1, n_blocks), self.layout.scratch,
                               np.int64)
        self.stats.update(prefix_lookups=0, prefix_hits=0, cow_copies=0,
                          preemptions=0, swap_ins=0, peak_pages_in_use=0)

    # -- page accounting ----------------------------------------------------

    @property
    def page_bytes(self) -> int:
        """Bytes one physical page pins across the pageable leaves."""
        if self.pool is None:
            return 0
        return paged_kv_bytes(self.pool, self.cfg) // (self.layout.n_pages + 1)

    def _page_or_none(self) -> Optional[int]:
        """try_alloc with prefix-cache eviction pressure."""
        p = self._pages.try_alloc()
        while p is None and self._prefix is not None and self._prefix.evict_one():
            p = self._pages.try_alloc()
        return p

    def _free_capacity(self) -> int:
        ev = self._prefix.evictable_pages() if self._prefix is not None else 0
        return self._pages.n_free + ev

    def _note_pages(self):
        self.stats["peak_pages_in_use"] = max(self.stats["peak_pages_in_use"],
                                              self._pages.in_use())

    @staticmethod
    def _cond_key(req: Request) -> Tuple:
        """The request's conditioning inputs as part of its prefix keys: in
        the encoder-decoder every decoder layer after the first reads the
        source (tokens or audio frames) through cross-attention, and in the
        VLM every layer after the first gated one reads the image, so
        equal target prefixes give equal pages only under equal sources.
        Each input enters as its dtype, shape and a 128-bit digest of its
        bytes (an image is 8 MB). A decoder-only request has none: ``()``,
        and its pages are keyed on the prompt alone, the reference's
        key."""
        return tuple((k, v.dtype.str, v.shape,
                      hashlib.blake2b(v.tobytes(), digest_size=16).digest())
                     for k, v in sorted((k, np.ascontiguousarray(v))
                                        for k, v in req.extras.items()))

    def _page_key(self, req: Request, f: int):
        """Key of the first ``f`` full pages: page f-1 ends at logical
        position f*ps - 1, which depends on the tokens up to index f*ps -
        n_meta - 1 (the meta tokens take the first logical positions) and
        on the conditioning inputs."""
        tokens = np.asarray(req.tokens, np.int64)
        cut = max(0, f * self.layout.page_size - self._n_meta)
        return ("PG", f, self._cond_key(req), tokens[:cut].tobytes())

    def _full_key(self, req: Request):
        tokens = np.asarray(req.tokens, np.int64)
        return ("FULL", len(tokens), self._cond_key(req), tokens.tobytes())

    def _slot_pages(self, s: int) -> List[int]:
        scratch = self.layout.scratch
        return [int(p) for p in self._tables[s] if p != scratch]

    def _release_slot_pages(self, s: int):
        for p in self._slot_pages(s):
            self._pages.decref(p)
        self._tables[s] = self.layout.scratch

    # -- admission ----------------------------------------------------------

    def _can_admit(self, req: Request) -> bool:
        if req.rid in self._plans:      # re-asked within the same tick
            return True
        n_pos = len(req.tokens) + self._n_meta
        need = self.layout.pages_for(n_pos)
        shared: List[int] = []
        if self._prefix is not None:
            self.stats["prefix_lookups"] += 1
            self._prefix.lookups += 1
            hit = self._prefix.get(self._full_key(req))
            if hit is None:
                for f in range(n_pos // self.layout.page_size, 0, -1):
                    hit = self._prefix.get(self._page_key(req, f))
                    if hit is not None:
                        break
            if hit is not None:
                shared = list(hit)
                self.stats["prefix_hits"] += 1
                self._prefix.hits += 1
                self.tracer.instant("prefix_cache.hit", rid=req.rid,
                                    shared_pages=len(shared))
            else:
                self.tracer.instant("prefix_cache.miss", rid=req.rid)
        n_fresh = need - len(shared)
        if self._free_capacity() < n_fresh + self.paged.reserve_pages:
            return False                # backpressure
        for p in shared:
            self._pages.incref(p)
        fresh = [self._page_or_none() for _ in range(n_fresh)]
        if any(p is None for p in fresh):
            raise PagePoolExhausted("free capacity was checked above")
        self._plans[req.rid] = (shared + fresh, len(shared))
        return True

    def _alloc_pool(self, batch):
        return paged_pool_like(batch, self.cfg, max_seq=self.max_seq,
                               n_slots=self.n_slots + 1, layout=self.layout)

    def _prefill_group(self, group: List[Request], bucket: int, now: float):
        # no span of its own, as the reference's: sched.admit covers it
        W, lengths, slots, seeds, host = self._stage_group(group, bucket)
        nb, scratch = self.layout.n_blocks, self.layout.scratch
        wt = np.full((W, nb), scratch, np.int64)
        for i, req in enumerate(group):
            pages, h = self._plans.pop(req.rid)
            s = int(slots[i])
            self._tables[s] = scratch
            self._tables[s, :len(pages)] = pages
            wt[i, h:len(pages)] = pages[h:]     # shared blocks stay scratch
        dev = to_device_batch(dict(host, lengths=lengths, slots=slots, wt=wt),
                              self.device)
        batch = {k: dev[k] for k in host}
        self._ensure_pool(batch)
        logits, self.pool = prefill_into_pages(
            self.params, batch, dev["lengths"], dev["wt"], dev["slots"],
            self.pool, self.cfg, max_seq=self.max_seq, layout=self.layout)
        tok0, lp0 = self._first_tokens(logits, seeds)
        if self._prefix is not None:
            for i, req in enumerate(group):
                n_pos = len(req.tokens) + self._n_meta
                pages = [int(p) for p in
                         self._tables[int(slots[i])][:self.layout.pages_for(n_pos)]]
                for f in range(1, n_pos // self.layout.page_size + 1):
                    self._prefix.put(self._page_key(req, f), pages[:f])
                self._prefix.put(self._full_key(req), pages)
        self._finish_admission(group, bucket, W, lengths, slots, seeds,
                               tok0, lp0, now)
        self._note_pages()

    def _try_swap_in(self, req: Request) -> bool:
        st = self._swapped[req.rid]
        need = self.layout.pages_for(st.pos + self._n_meta)
        if self._free_capacity() < need + self.paged.reserve_pages:
            return False
        with self.tracer.span("sched.swap_in", rid=req.rid, pages=need):
            self._swap_in(req, st, need)
        return True

    def _swap_in(self, req: Request, st: _SwapState, need: int):
        pages = [self._page_or_none() for _ in range(need)]
        if any(p is None for p in pages):
            raise PagePoolExhausted("free capacity was checked above")
        s = self._free.popleft()
        self._tables[s] = self.layout.scratch
        self._tables[s, :need] = pages
        self.pool = restore_slot_state(self.pool, self.cfg, st.saved,
                                       to_device(self._tables[s], self.device), s)
        self._queue.popleft()
        del self._swapped[req.rid]
        self._slot_rid[s] = req.rid
        self._slot_uses[s] += 1
        self._tok[s] = st.tok
        self._pos[s] = st.pos
        self._ngen[s] = st.ngen
        self._active[s] = True
        self._done[s] = False
        self._budget[s] = st.budget
        self._length[s] = st.length
        self._score[s] = st.score
        self._seed[s] = st.seed
        self.stats["swap_ins"] += 1
        self._note_pages()

    def _admit(self, now: float):
        # preempted requests sit at the queue front (swap state, no plan);
        # drain them before normal bucketed admission
        while (self._free and self._queue
               and self._queue[0].rid in self._swapped):
            if not self._try_swap_in(self._queue[0]):
                return                  # backpressure: keep FIFO order
        super()._admit(now)

    # -- decode: COW + page growth + preemption -----------------------------

    def _victim(self) -> Optional[int]:
        """Youngest-admitted live slot (LIFO preemption: the youngest
        request has done the least work and re-enters the queue FIRST of
        the preempted, preserving FIFO completion order overall)."""
        live = [s for s in range(self.n_slots)
                if self._slot_rid[s] is not None
                and self._active[s] and not self._done[s]]
        if not live:
            return None
        return max(live, key=lambda s: (
            self._meta[self._slot_rid[s]]["admitted_at"], s))

    def _preempt(self, s: int):
        rid = self._slot_rid[s]
        with self.tracer.span("sched.preempt.swap_out", rid=rid, slot=s):
            self._swap_out(s, rid)

    def _swap_out(self, s: int, rid: int):
        # the victim's own write block may have been copied earlier in this
        # _ensure_writable pass: its table already points at the copy's
        # destination, so the pending copy runs before the gather reads it
        self._flush_cow()
        # the tick's exceptional second host sync: the swap-out lands in
        # host memory before its pages are handed out again
        saved = fetch(gather_slot_state(
            self.pool, self.cfg, to_device(self._tables[s], self.device), s))
        self._swapped[rid] = _SwapState(
            tok=int(self._tok[s]), pos=int(self._pos[s]),
            ngen=int(self._ngen[s]), budget=int(self._budget[s]),
            length=int(self._length[s]), score=float(self._score[s]),
            seed=int(self._seed[s]), saved=saved)
        self._queue.appendleft(self._reqs[rid])
        self._release_slot_pages(s)
        self._slot_rid[s] = None
        self._active[s] = False
        self._done[s] = False
        self._free.append(s)
        self.stats["preemptions"] += 1

    def _grow_page(self, s: int) -> Optional[int]:
        """A page for slot ``s``'s next write: evicting prefix-cache
        entries, then preempting victims until one frees up. None means
        ``s`` itself was preempted (it was the youngest live slot)."""
        while True:
            p = self._page_or_none()
            if p is not None:
                return p
            v = self._victim()
            if v is None:
                raise PagePoolExhausted("no free pages and no live slot to preempt")
            self._preempt(v)
            if v == s:
                return None

    def _flush_cow(self):
        """Run the queued page copies in one ``copy_pages`` call, padded
        with scratch -> scratch pairs to a power-of-two width."""
        src, dst = self._cow_src, self._cow_dst
        if not src:
            return
        self._cow_src, self._cow_dst = [], []
        scratch = self.layout.scratch
        w = 1
        while w < len(src):
            w *= 2
        with self.tracer.span("sched.cow_flush", pairs=len(src), width=w):
            src = src + [scratch] * (w - len(src))
            dst = dst + [scratch] * (w - len(dst))
            dev = to_device_packed({"src": np.asarray(src), "dst": np.asarray(dst)},
                                   self.device)
            self.pool = copy_pages(self.pool, self.cfg, dev["src"], dev["dst"])

    def _ensure_writable(self, alive):
        """Pre-decode pass: every live slot's write block must point at a
        private real page before the step writes K/V there."""
        ps, scratch = self.layout.page_size, self.layout.scratch
        self._cow_src, self._cow_dst = [], []
        for s in range(self.n_slots):
            if not alive[s] or self._slot_rid[s] is None:
                continue                # rid None: preempted this pass
            wb = (int(self._pos[s]) + self._n_meta) // ps
            page = int(self._tables[s, wb])
            if page == scratch:
                p = self._grow_page(s)
                if p is None:
                    continue
                self._tables[s, wb] = p
            elif self._pages.ref(page) > 1:
                p = self._grow_page(s)
                if p is None:
                    continue
                # a preemption inside _grow_page may itself have flushed;
                # re-read the current page (still shared: only OTHER slots'
                # pages were released)
                self._cow_src.append(int(self._tables[s, wb]))
                self._cow_dst.append(p)
                self._pages.decref(int(self._tables[s, wb]))
                self._tables[s, wb] = p
                self.stats["cow_copies"] += 1
        self._flush_cow()
        self._note_pages()

    def _decode_call(self, alive):
        self._ensure_writable(alive)
        alive = self._active & ~self._done      # preemption may shrink it
        # dead rows read and write the scratch page only: a done slot's
        # table may still hold pages other owners share
        tables = np.where(alive[:, None], self._tables, self.layout.scratch)
        arrays = dict(self._tick_arrays(alive), tables=tables)
        dev = to_device_packed(arrays, self.device)
        lg, self.pool = decode_paged_step(
            self.params, self.pool, dev["tables"].to(torch.int32), dev["tok"],
            dev["pos"], dev["alive"].bool(), self.cfg,
            local_routing=self.gen.local_routing,
            flash_decode=self.gen.flash_decode)
        return _select_rows(self.gen, lg.float(), self.seed, self._seed,
                            self._ngen)

    def _retire(self, now: float) -> List[RequestResult]:
        retiring = [s for s in range(self.n_slots)
                    if self._slot_rid[s] is not None and self._done[s]]
        out = super()._retire(now)
        for s in retiring:
            self._release_slot_pages(s)
        return out


# ---------------------------------------------------------------------------
# static-batching baseline (table 8's comparison point)
# ---------------------------------------------------------------------------

def static_batch_serve(params, cfg: ModelConfig, gen: GenerateConfig,
                       requests: Sequence[Request], *, batch_size: int,
                       seed: int = 0, max_seq: Optional[int] = None
                       ) -> Tuple[Dict[int, np.ndarray], float]:
    """Serving without a scheduler: requests grouped FIFO (by arrival,
    then rid) into same-length batches of at most ``batch_size``, each run
    through the one-shot ``generate`` (extras stacked) until its slowest
    member finishes; each output is cut to its request's budget (greedy
    decoding is prefix-stable, so the cut equals a shorter run). ``seed``
    keys sampling as ``generate``'s. Returns ({rid: tokens}, wall seconds
    on ``monotonic()``)."""
    groups: Dict[int, List[Request]] = {}
    order: List[List[Request]] = []
    for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
        g = groups.get(len(r.tokens))
        if g is None or len(g) >= batch_size:
            g = groups[len(r.tokens)] = []
            order.append(g)
        g.append(r)
    g2 = dataclasses.replace(gen, max_seq=max_seq or gen.max_seq)
    device = _params_device(params)
    out: Dict[int, np.ndarray] = {}
    t0 = monotonic()
    for g in order:
        batch = {"tokens": to_device(np.stack([r.tokens for r in g]), device)}
        for k in g[0].extras:
            batch[k] = to_device(np.stack([r.extras[k] for r in g]), device)
        res = generate(params, batch, cfg, g2, seed=seed)
        toks, lens = fetch((res.tokens, res.lengths))
        for i, r in enumerate(g):
            n = min(int(lens[i]), r.max_new or gen.max_new)
            out[r.rid] = toks[i, :n]
    return out, monotonic() - t0
