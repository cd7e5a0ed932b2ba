"""Collective-communication substrates of the MoE dispatch and combine (port
of ``repro/comm/substrate.py`` on ``torch.distributed``).

The dispatch and combine all-to-alls are the collective Gating Dropout
exists to skip. Each substrate is a transport behind a registry, chosen by
``MoEConfig.comm`` (``CommConfig``):

  dense                   -- one all-to-all over the whole ep group.
  hierarchical            -- two hops over ep = ep_inner x ep_outer: an
                             all-to-all inside each tier of ``ep_inner``
                             consecutive ranks, then one across tiers over
                             strided groups; the same permutation as
                             dense, bitwise.
  compressed              -- dense, the payload quantized to int8 or fp8
                             (e4m3) with one f32 scale per row and
                             dequantized on arrival; the backward wire is
                             quantized too, the rounding straight-through.
  hierarchical_compressed -- both.
  overlapped[...]         -- any of the above split into micro-chunks along
                             the capacity axis: chunk i+1's dispatch is
                             issued (``async_op=True``) before chunk i's
                             expert FFN, so the collective can overlap it.
                             Each chunk takes its base substrate's
                             permutation and the FFN is per row, so the
                             result is bitwise the base substrate's.

Two execution modes:

  * ``dispatch`` / ``combine``   -- real collectives: per rank (E, cap, d)
                                    <-> (E/ep, ep*cap, d), each hop one
                                    ``dist.all_to_all_single`` over equal
                                    contiguous splits, the layout of
                                    ``jax.lax.all_to_all(..., tiled=True)``;
  * ``vdispatch`` / ``vcombine`` -- the oracle's virtual emulation, plain
                                    permutes of the stacked (ep, E, cap, d)
                                    tensor.

Every all-to-all the transports issue goes through ``COUNTER`` (calls,
result bytes and wire bytes, forward and backward apart); a hop over a
group of one issues nothing. ``Transport.telemetry`` gives the layer's
``comm_*`` counters from the analytic model (``comm/cost.py``) as host
scalars: the tests hold the counter, the telemetry and the model equal.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm import cost as C
from repro_torch.comm.cost import factored_ep
from repro_torch.configs.base import CommConfig

__all__ = ["COUNTER", "CommConfig", "CommEnv", "OverlappedTransport",
           "Transport", "available_substrates", "comm_zero", "dequantize",
           "get_substrate", "make_transport", "quantize",
           "register_substrate"]

COMM_KEYS = ("comm_a2a_calls", "comm_bytes", "comm_wire_bytes",
             "comm_exposed_bytes", "comm_hidden_bytes")


@dataclasses.dataclass(frozen=True)
class CommEnv:
    """Where a transport runs. ``group`` is the expert-parallel process
    group (None: the oracle's virtual emulation); ``intra`` and ``inter``
    are this rank's tier subgroups for the hierarchical substrates (built
    by ``ParallelContext.comm_env``; None where a tier has one rank).
    ``inner_size`` > 0 fixes the intra tier's size and overrides
    ``CommConfig.ep_inner``: under ``ep_on_model`` the tiers are the model
    group (intra) and the data group (inter)."""
    ep: int
    group: Any = None
    intra: Any = None
    inter: Any = None
    inner_size: int = 0


# ---------------------------------------------------------------------------
# the collective counter
# ---------------------------------------------------------------------------

_PHASE = contextvars.ContextVar("comm_phase", default="fwd")


@contextlib.contextmanager
def _backward():
    token = _PHASE.set("bwd")
    try:
        yield
    finally:
        _PHASE.reset(token)


class WireCounter:
    """Every all-to-all the transports issued: calls, result bytes (an
    all-to-all keeps its size, so also the bytes sent) and wire bytes
    (bytes * (g - 1) / g over a group of g: a rank keeps its own block),
    under "fwd" and "bwd". A forward recomputed in the backward (remat)
    counts as forward."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = {"fwd": 0, "bwd": 0}
        self.bytes = {"fwd": 0.0, "bwd": 0.0}
        self.wire_bytes = {"fwd": 0.0, "bwd": 0.0}

    def add(self, nbytes: int, group_size: int) -> None:
        ph = _PHASE.get()
        self.calls[ph] += 1
        self.bytes[ph] += float(nbytes)
        self.wire_bytes[ph] += float(nbytes) * (group_size - 1) / group_size

    def total_calls(self) -> int:
        return self.calls["fwd"] + self.calls["bwd"]


COUNTER = WireCounter()


# ---------------------------------------------------------------------------
# quantization (compressed substrates)
# ---------------------------------------------------------------------------

_FP8_MAX = 448.0          # float8_e4m3fn finite max
_INT8_MAX = 127.0


def quantize(x: torch.Tensor, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last dim) scaled quantization: (..., d) -> int8 or fp8
    payload and one f32 scale per row. Zero rows get scale 1, so their
    dequantization is exact; int8 rounds half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    top = _FP8_MAX if mode == "fp8" else _INT8_MAX
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    y = (xf / scale).clamp(-top, top)
    if mode == "fp8":
        return y.to(torch.float8_e4m3fn), scale
    return torch.round(y).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


# ---------------------------------------------------------------------------
# the wire: hops of all-to-all over dim 0 or 1, under autograd
# ---------------------------------------------------------------------------

Hop = Tuple[Any, int]     # (process group, axis it exchanges: 0 or 1)


class _Pending:
    """One issued all-to-all; ``wait`` returns its result in the layout of
    its input."""

    def __init__(self, out, work, dtype, dim, keep):
        self.out, self.work, self.dtype, self.dim = out, work, dtype, dim
        self.keep = keep          # the input stays alive until the wait

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        out = self.out.view(self.dtype)
        return out.transpose(0, 1) if self.dim else out


def _exchange(x: torch.Tensor, group, dim: int, async_op: bool) -> _Pending:
    """Tiled all-to-all along axis ``dim`` (0 or 1) of ``x`` over
    ``group``: block j of that axis goes to member j, and block j of the
    result came from member j. fp8 travels as its bytes."""
    src = (x.transpose(0, 1) if dim else x).contiguous()
    wire = src.view(torch.uint8) if src.dtype == torch.float8_e4m3fn else src
    out = torch.empty_like(wire)
    COUNTER.add(out.numel() * out.element_size(), dist.get_world_size(group))
    work = dist.all_to_all_single(out, wire, group=group, async_op=async_op)
    return _Pending(out, work, src.dtype, dim, wire)


class _Transfer:
    """Payload tensors on their way through a hop sequence: the first hop
    is issued at construction, the others when the result is asked for."""

    def __init__(self, payload: List[torch.Tensor], hops: Sequence[Hop],
                 async_op: bool):
        self.hops, self.payload = hops, payload
        self.first = ([_exchange(t, *hops[0], async_op) for t in payload]
                      if hops else None)

    def result(self) -> List[torch.Tensor]:
        if not self.hops:
            return self.payload
        ts = [p.wait() for p in self.first]
        for group, dim in self.hops[1:]:
            ts = [_exchange(t, group, dim, False).wait() for t in ts]
        return ts


class _Wire:
    """One direction of a transport: ``fwd`` hops in the forward, ``bwd``
    hops (the inverse permutation) for the gradient, the payload
    quantized (``quant``) both ways or carried as it is."""

    def __init__(self, fwd: Sequence[Hop], bwd: Sequence[Hop],
                 quant: Optional[str]):
        self.fwd, self.bwd, self.quant = list(fwd), list(bwd), quant

    @property
    def identity(self) -> bool:
        return not self.fwd and self.quant is None

    def pack(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x] if self.quant is None else list(quantize(x, self.quant))

    def unpack(self, ts: List[torch.Tensor], dtype) -> torch.Tensor:
        return ts[0] if self.quant is None else dequantize(ts[0], ts[1], dtype)

    def reverse(self, g: torch.Tensor) -> torch.Tensor:
        """The gradient's wire: the inverse hops, quantized as forward."""
        return self.unpack(_Transfer(self.pack(g), self.bwd, False).result(),
                           g.dtype)

    def start(self, x: torch.Tensor):
        box: List[_Transfer] = []
        return _WireStart.apply(x, self, box), box

    def finish(self, started) -> torch.Tensor:
        out, box = started
        return _WireFinish.apply(out, self, box)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.finish(self.start(x))


class _WireStart(torch.autograd.Function):
    """Issues the wire's first hop and returns the buffer ``_WireFinish``
    fills; its backward is the reverse wire of the gradient."""

    @staticmethod
    def forward(ctx, x, wire: _Wire, box):
        ctx.wire = wire
        box.append(_Transfer(wire.pack(x), wire.fwd, async_op=True))
        return torch.empty_like(x)

    @staticmethod
    def backward(ctx, g):
        with _backward():
            return ctx.wire.reverse(g.contiguous()), None, None


class _WireFinish(torch.autograd.Function):
    """Waits for the wire started by ``_WireStart``, runs its other hops
    and dequantizes into the started buffer; identity for the gradient."""

    @staticmethod
    def forward(ctx, out, wire: _Wire, box):
        out.copy_(wire.unpack(box.pop().result(), out.dtype))
        ctx.mark_dirty(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


# ---------------------------------------------------------------------------
# topologies (permutation algebra; payload-dtype agnostic)
# ---------------------------------------------------------------------------

class _Topo:
    """Rank r = o * gi + i of an ep = gi x go group holds experts
    [r * E/ep, (r + 1) * E/ep). On the wire a rank's (E, cap, d) buffer is
    viewed (go, gi, E/ep * cap, d): block (o, i) is what it sends to rank
    o * gi + i. ``dispatch_hops`` run in order deliver block (o, i) of
    every sender, indexed by the sender's (o, i); ``combine_hops`` (the
    same hops reversed, each self-inverse) undo them."""

    env: CommEnv
    tiers: Optional[Tuple[int, int]]
    grid: Tuple[int, int]                 # (go, gi)
    dispatch_hops: List[Hop]
    combine_hops: List[Hop]

    def to_dispatch_wire(self, buf: torch.Tensor) -> torch.Tensor:
        go, gi = self.grid
        return buf.reshape(go, gi, -1, buf.shape[-1])

    def from_dispatch_wire(self, b: torch.Tensor, cap: int) -> torch.Tensor:
        """The expert FFN's (E/ep, ep*cap, d) buffer, contiguous: at cap = 1
        the reshape is a strided view, and B1 reads its rows in place."""
        go, gi = self.grid
        e_loc = b.shape[2] // cap
        b = b.reshape(go, gi, e_loc, cap, b.shape[-1]).permute(2, 0, 1, 3, 4)
        return b.reshape(e_loc, self.env.ep * cap, b.shape[-1]).contiguous()

    def to_combine_wire(self, buf: torch.Tensor) -> torch.Tensor:
        go, gi = self.grid
        e_loc, n, d = buf.shape
        b = buf.reshape(e_loc, go, gi, n // self.env.ep, d).permute(1, 2, 0, 3, 4)
        return b.reshape(go, gi, -1, d)

    def from_combine_wire(self, b: torch.Tensor, cap: int) -> torch.Tensor:
        return b.reshape(-1, cap, b.shape[-1])


class _FlatTopo(_Topo):
    """Single-hop all-to-all over the whole ep group."""

    def __init__(self, env: CommEnv):
        self.env, self.tiers, self.grid = env, None, (env.ep, 1)
        self.dispatch_hops = ([(env.group, 0)]
                              if env.group is not None and env.ep > 1 else [])
        self.combine_hops = self.dispatch_hops

    def vdispatch(self, bufs: torch.Tensor) -> torch.Tensor:   # (ep, E, cap, ..)
        ep, E = bufs.shape[:2]
        b = bufs.reshape((ep, ep, E // ep) + bufs.shape[2:])
        b = b.movedim(0, 2)                        # (dst, e_loc, src, cap, ..)
        return b.reshape((E, ep * bufs.shape[2]) + bufs.shape[3:])

    def vcombine(self, buf: torch.Tensor) -> torch.Tensor:     # (E, ep*cap, ..)
        ep = self.env.ep
        E = buf.shape[0]
        cap = buf.shape[1] // ep
        b = buf.reshape((ep, E // ep, ep, cap) + buf.shape[2:])
        b = b.movedim(2, 0)                        # (src, dst, e_loc, cap, ..)
        return b.reshape((ep, E, cap) + buf.shape[2:])


class _FactoredTopo(_Topo):
    """Two-hop exchange over ep = ep_inner x ep_outer (rank = o*gi + i).

    Hop algebra (X[src][dst] = the block src holds for dst; src=(o,i)):
      intra:  A[(o,i)][o',i'] = X[(o,i')][o',i]     (tiers exchange inside)
      inter:  B[(o,i)][o2,i2] = A[(o2,i)][o ,i2]    (strided across tiers)
      =>      B[(o,i)][o2,i2] = X[(o2,i2)][o ,i ]   -- exactly the flat a2a.
    Both hops are self-inverse, so ``combine`` replays them in reverse."""

    def __init__(self, comm: CommConfig, env: CommEnv):
        self.env = env
        gi, go = factored_ep(env.ep, env.inner_size or comm.ep_inner)
        self.tiers, self.grid = (gi, go), (go, gi)
        real = env.group is not None
        intra = [(env.intra, 1)] if real and gi > 1 else []
        inter = [(env.inter, 0)] if real and go > 1 else []
        self.dispatch_hops = intra + inter
        self.combine_hops = inter + intra

    # the virtual emulation: the same two hops as stacked-axis swaps
    def vdispatch(self, bufs: torch.Tensor) -> torch.Tensor:   # (ep, E, cap, ..)
        gi, go = self.tiers
        ep, E, cap = bufs.shape[:3]
        b = bufs.reshape((go, gi, go, gi, E // ep) + bufs.shape[2:])
        b = b.transpose(1, 3)                      # intra hop
        b = b.transpose(0, 2)                      # inter hop
        # axes now (o_dst, i_dst, o_src, i_src, e_loc, cap, ...)
        b = b.movedim(4, 2)                        # (o_d, i_d, e_loc, o_s, ..)
        return b.reshape((E, ep * cap) + bufs.shape[3:])

    def vcombine(self, buf: torch.Tensor) -> torch.Tensor:     # (E, ep*cap, ..)
        gi, go = self.tiers
        ep = self.env.ep
        E = buf.shape[0]
        cap = buf.shape[1] // ep
        b = buf.reshape((go, gi, E // ep, go, gi, cap) + buf.shape[2:])
        b = b.movedim(2, 4)                        # (o_d, i_d, o_s, i_s, e, ..)
        b = b.transpose(0, 2)                      # undo the inter hop
        b = b.transpose(1, 3)                      # undo the intra hop
        return b.reshape((ep, E, cap) + buf.shape[2:])


# ---------------------------------------------------------------------------
# transport = topology (+ compression) + telemetry
# ---------------------------------------------------------------------------

def _host_scalar(v: float) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32)


class Transport:
    """One routed layer's wire. ``dispatch``: per rank (E, cap, d) ->
    (E/ep, ep*cap, d); ``combine`` its exact inverse; ``vdispatch`` /
    ``vcombine`` the oracle's stacked emulation (ep, E, cap, d) <->
    (E, ep*cap, d). ``roundtrip`` applies only the payload transform
    (quantize then dequantize, no movement): the ep=1 kernel pipeline uses
    it, so the choice of backend never changes numerics."""

    def __init__(self, comm: CommConfig, env: CommEnv, topo: _Topo):
        self.comm, self.env, self.topo = comm, env, topo
        self.quant = comm.quant if comm.compressed else None
        self._dwire = _Wire(topo.dispatch_hops, topo.combine_hops, self.quant)
        self._cwire = _Wire(topo.combine_hops, topo.dispatch_hops, self.quant)
        self._rwire = _Wire([], [], self.quant)

    @property
    def identity(self) -> bool:
        """Whether the wire moves and transforms nothing (ep = 1,
        uncompressed)."""
        return self._dwire.identity and self._cwire.identity

    # -- real collectives ----------------------------------------------------
    def _start_dispatch(self, buf: torch.Tensor):
        if self._dwire.identity:
            return buf, None
        return self._dwire.start(self.topo.to_dispatch_wire(buf)), buf.shape[1]

    def _finish_dispatch(self, started) -> torch.Tensor:
        x, cap = started
        if cap is None:
            return x
        return self.topo.from_dispatch_wire(self._dwire.finish(x), cap)

    def dispatch(self, buf: torch.Tensor) -> torch.Tensor:
        return self._finish_dispatch(self._start_dispatch(buf))

    def combine(self, buf: torch.Tensor) -> torch.Tensor:
        if self._cwire.identity:
            return buf
        cap = buf.shape[1] // self.env.ep
        return self.topo.from_combine_wire(
            self._cwire(self.topo.to_combine_wire(buf)), cap)

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.quant is None else self._rwire(x)

    # -- the oracle's emulation ----------------------------------------------
    def vdispatch(self, bufs: torch.Tensor) -> torch.Tensor:
        # per-row quantization commutes with moving rows, so the
        # quantized wire is the permutation of the roundtrip, bitwise
        return self.topo.vdispatch(self.roundtrip(bufs))

    def vcombine(self, buf: torch.Tensor) -> torch.Tensor:
        return self.topo.vcombine(self.roundtrip(buf))

    # -- one transaction -----------------------------------------------------
    def pipelined(self, buf: torch.Tensor, fn: Callable) -> torch.Tensor:
        """``dispatch -> fn -> combine`` as one transaction, the expert FFN
        handed in per chunk so that overlapped substrates can interleave
        it with the wire. Non-overlapped substrates are one chunk."""
        return self.combine(fn(self.dispatch(buf)))

    def vpipelined(self, bufs: torch.Tensor, fn: Callable) -> torch.Tensor:
        return self.vcombine(fn(self.vdispatch(bufs)))

    def telemetry(self, n_experts: int, cap: int, d_model: int,
                  itemsize: int) -> Dict[str, torch.Tensor]:
        """The layer's ``comm_*`` counters from the analytic model, as
        host f32 scalars (pure functions of the shapes): calls, payload
        bytes, wire bytes, and the wire split into the part a chunked
        pipeline cannot hide (its edge chunks) and the rest;
        non-overlapped substrates expose everything."""
        c = C.transport_cost(self.comm, ep=self.env.ep, n_experts=n_experts,
                             cap=cap, d_model=d_model, itemsize=itemsize,
                             tiers=self.topo.tiers)
        return {"comm_a2a_calls": _host_scalar(c["calls"]),
                "comm_bytes": _host_scalar(c["bytes"]),
                "comm_wire_bytes": _host_scalar(c["wire_bytes"]),
                "comm_exposed_bytes": _host_scalar(c["exposed_wire_bytes"]),
                "comm_hidden_bytes": _host_scalar(c["hidden_wire_bytes"])}


class OverlappedTransport(Transport):
    """Micro-chunked pipeline over any base topology.

    ``pipelined`` splits the (E, cap, d) payload into
    ``effective_chunks(cap, n_chunks)`` slices along the capacity axis and
    issues, per chunk i: the dispatch of chunk i+1 (``async_op=True``),
    then the FFN of chunk i once its own dispatch has landed, then its
    combine. Bitwise its base substrate: each chunk takes the base
    permutation (the dispatched axis 1 is (src_rank, cap), so chunk i is
    the [i*cc, (i+1)*cc) capacity slice of every sender's block), the FFN
    is per row, and compressed scales are per row. With nothing on the
    wire (ep = 1) nothing can overlap, and the payload runs as one
    chunk."""

    def _n_chunks(self, cap: int) -> int:
        if self.env.ep == 1:
            return 1
        return C.effective_chunks(cap, self.comm.n_chunks)

    def pipelined(self, buf: torch.Tensor, fn: Callable) -> torch.Tensor:
        n = self._n_chunks(buf.shape[1])
        if n == 1:
            return self.combine(fn(self.dispatch(buf)))
        cc = buf.shape[1] // n
        chunks = [buf[:, i * cc:(i + 1) * cc] for i in range(n)]
        started = self._start_dispatch(chunks[0])
        outs = []
        for i in range(n):
            nxt = self._start_dispatch(chunks[i + 1]) if i + 1 < n else None
            outs.append(self.combine(fn(self._finish_dispatch(started))))
            started = nxt
        return torch.cat(outs, dim=1)

    def vpipelined(self, bufs: torch.Tensor, fn: Callable) -> torch.Tensor:
        n = self._n_chunks(bufs.shape[2])
        if n == 1:
            return self.vcombine(fn(self.vdispatch(bufs)))
        cc = bufs.shape[2] // n
        return torch.cat([self.vcombine(fn(self.vdispatch(
            bufs[:, :, i * cc:(i + 1) * cc]))) for i in range(n)], dim=2)


def comm_zero() -> Dict[str, torch.Tensor]:
    """Telemetry of a layer that moves nothing (Gate-Drop local step,
    expert drop, dense FFN layers)."""
    return {k: _host_scalar(0.0) for k in COMM_KEYS}


# ---------------------------------------------------------------------------
# registry (mirrors core/backend.py)
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[CommConfig, CommEnv], Transport]] = {}


def register_substrate(name: str):
    """Decorator: add a communication substrate under ``name``."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def available_substrates() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_substrate(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown comm substrate {name!r}; available: "
            f"{', '.join(available_substrates())}") from None


def make_transport(comm: CommConfig, env: CommEnv) -> Transport:
    """The configured substrate's transport for one layer call."""
    return get_substrate(comm.substrate)(comm, env)


@register_substrate("dense")
def _dense(comm: CommConfig, env: CommEnv) -> Transport:
    return Transport(comm, env, _FlatTopo(env))


@register_substrate("hierarchical")
def _hierarchical(comm: CommConfig, env: CommEnv) -> Transport:
    return Transport(comm, env, _FactoredTopo(comm, env))


@register_substrate("compressed")
def _compressed(comm: CommConfig, env: CommEnv) -> Transport:
    return Transport(comm, env, _FlatTopo(env))


@register_substrate("hierarchical_compressed")
def _hierarchical_compressed(comm: CommConfig, env: CommEnv) -> Transport:
    return Transport(comm, env, _FactoredTopo(comm, env))


@register_substrate("overlapped")
def _overlapped(comm: CommConfig, env: CommEnv) -> Transport:
    return OverlappedTransport(comm, env, _FlatTopo(env))


@register_substrate("overlapped_hierarchical")
def _overlapped_hierarchical(comm: CommConfig, env: CommEnv) -> Transport:
    return OverlappedTransport(comm, env, _FactoredTopo(comm, env))


@register_substrate("overlapped_compressed")
def _overlapped_compressed(comm: CommConfig, env: CommEnv) -> Transport:
    return OverlappedTransport(comm, env, _FlatTopo(env))


@register_substrate("overlapped_hierarchical_compressed")
def _overlapped_hierarchical_compressed(comm: CommConfig,
                                        env: CommEnv) -> Transport:
    return OverlappedTransport(comm, env, _FactoredTopo(comm, env))
