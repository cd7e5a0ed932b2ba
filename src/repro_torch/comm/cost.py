"""Analytic bytes model of the communication substrate (port of
``repro/comm/cost.py``, the same pure math).

The single source of "how many bytes does a routed MoE layer move": the
transports' telemetry (``comm/substrate.py``) is computed from these
functions, and the transports count every collective they issue
(``substrate.COUNTER``), which the tests hold against this model.

Conventions (the reference's):

  * ``bytes``       -- sum over all-to-all ops of the per-device RESULT
                       bytes (an a2a preserves element count, so this is
                       also the per-device send buffer size).
  * ``wire_bytes``  -- per-device traffic actually crossing the wire:
                       ``bytes * (g - 1) / g`` per op for an a2a over a
                       group of ``g`` (a device keeps its own chunk).
  * ``calls``       -- number of all-to-all ops.

Pure host math.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.configs.base import CommConfig, ModelConfig

# wire itemsizes: int8 and float8_e4m3fn payloads, f32 scales
_QUANT_ITEMSIZE = {"int8": 1, "fp8": 1}
_SCALE_ITEMSIZE = 4   # one scale per (expert, cap-slot) row


def factored_ep(ep: int, ep_inner: int = 0):
    """Factor an expert-parallel group of ``ep`` ranks into
    ``(ep_inner, ep_outer)`` tiers for the hierarchical substrate: rank
    r = outer * ep_inner + inner, i.e. consecutive ranks share a tier
    (machine/node). ``ep_inner == 0`` picks the largest divisor <=
    sqrt(ep), so the two hops are as square as possible."""
    if ep_inner == 0:
        ep_inner = max(g for g in range(1, int(math.isqrt(ep)) + 1)
                       if ep % g == 0)
    if ep % ep_inner:
        raise ValueError(f"ep_inner {ep_inner} does not divide ep {ep}")
    return ep_inner, ep // ep_inner


def ep_tier_groups(ep: int, ep_inner: int = 0):
    """Rank groups of the two hierarchical hops over an ep group of size
    ``ep``: ``intra`` groups hold the ``ep_inner``
    consecutive ranks of each tier; ``inter`` groups hold the ranks with
    equal intra-tier index, strided by ``ep_inner`` — the member index
    within a group is the tier index, which the two-hop exchange algebra
    relies on."""
    gi, go = factored_ep(ep, ep_inner)
    intra = tuple(tuple(o * gi + i for i in range(gi)) for o in range(go))
    inter = tuple(tuple(o * gi + i for o in range(go)) for i in range(gi))
    return intra, inter


def effective_chunks(cap: int, n_chunks: int) -> int:
    """Micro-chunk count the overlapped transport ACTUALLY runs: the
    largest divisor of ``cap`` that is <= the requested ``n_chunks``
    (clamped to [1, cap]). Shared by the transport (comm/substrate.py)
    and this cost model so the two agree on how many per-chunk
    collectives a layer issues."""
    n = max(1, min(int(n_chunks), max(int(cap), 1)))
    while cap % n:
        n -= 1
    return n


def _a2a(elems: int, itemsize: int, g: int) -> Dict[str, float]:
    b = float(elems * itemsize)
    return {"calls": 1.0, "bytes": b, "wire_bytes": b * (g - 1) / max(g, 1)}


def _acc(total: Dict[str, float], op: Dict[str, float], tier: str) -> None:
    for k, v in op.items():
        total[k] += v
    total[f"{tier}_wire_bytes"] += op["wire_bytes"]


def transport_cost(comm: CommConfig, *, ep: int, n_experts: int, cap: int,
                   d_model: int, itemsize: int,
                   tiers: Optional[tuple] = None) -> Dict[str, float]:
    """Bytes and calls of ONE routed layer's transport (dispatch + combine)
    per device. ``itemsize`` is the activation dtype's wire width for the
    uncompressed payload; ``tiers`` (gi, go) overrides the hierarchical
    factorization where the mesh fixes it (``ep_on_model``: the model and
    data groups, (m, d)). Keys: calls, bytes, wire_bytes,
    intra_wire_bytes, inter_wire_bytes, exposed_wire_bytes,
    hidden_wire_bytes. A flat substrate's single hop spans every tier, so
    ALL its wire counts as inter-tier — the pessimistic cross-machine
    bytes the paper targets; hierarchical substrates split the wire
    between the two tiers.

    Overlapped substrates run every hop ``n_eff`` times (one per
    capacity micro-chunk, ``effective_chunks``): ``calls`` multiplies by
    n_eff while ``bytes``/``wire_bytes`` stay EXACTLY equal to the one
    dense exchange (each chunk carries 1/n_eff of the rows — cap is
    divisible by n_eff by construction). ``exposed_wire_bytes`` is the
    structurally non-overlappable fraction: the pipeline's edge chunks
    (first dispatch, last combine) can never hide behind compute, so
    exposed = wire / n_eff and hidden = the rest; non-overlapped
    substrates expose everything (hidden = 0)."""
    rows = n_experts * cap
    elems = rows * d_model
    n_eff = effective_chunks(cap, comm.n_chunks) if comm.overlapped else 1
    total = {"calls": 0.0, "bytes": 0.0, "wire_bytes": 0.0,
             "intra_wire_bytes": 0.0, "inter_wire_bytes": 0.0}
    # tensors crossing the wire per direction: [(elems, itemsize, name)]
    if comm.compressed:
        wire = [(elems, _QUANT_ITEMSIZE[comm.quant]),
                (rows, _SCALE_ITEMSIZE)]
    else:
        wire = [(elems, itemsize)]
    if comm.hierarchical:
        gi, go = tiers or factored_ep(ep, comm.ep_inner)
        hops = [(gi, "intra"), (go, "inter")]
    else:
        hops = [(ep, "inter")]
    # a group-of-1 exchange moves nothing and the transport issues no
    # collective for it (ep=1, and degenerate hierarchical factorizations:
    # prime ep -> ep_inner=1), so it is not counted
    hops = [(g, tier) for g, tier in hops if g > 1]
    for _direction in ("dispatch", "combine"):
        for g, tier in hops:
            for e, isz in wire:
                # n_eff per-chunk ops of e/n_eff elements each: the
                # integer division is exact (cap % n_eff == 0), so the
                # byte totals reproduce the unchunked exchange EXACTLY
                chunk_op = _a2a(e // n_eff, isz, g)
                _acc(total, {k: v * n_eff for k, v in chunk_op.items()},
                     tier)
    total["exposed_wire_bytes"] = total["wire_bytes"] / n_eff
    total["hidden_wire_bytes"] = (total["wire_bytes"]
                                  - total["exposed_wire_bytes"])
    return total


def routed_capacity(cfg: ModelConfig, tokens_per_shard: int, *,
                    is_training: bool = True) -> int:
    """Per-shard expert buffer capacity of a routed step — the same
    formula every backend uses (core/moe.py::_routed_shard)."""
    from repro_torch.core.router import capacity
    moe = cfg.moe
    cf = moe.capacity_factor if is_training else moe.eval_capacity_factor
    return min(capacity(tokens_per_shard, moe.n_experts, moe.top_k, cf),
               tokens_per_shard)


def layer_cost(cfg: ModelConfig, *, tokens_per_shard: int, ep: int,
               comm: Optional[CommConfig] = None,
               is_training: bool = True) -> Dict[str, float]:
    """Transport cost of one routed MoE layer for a model config."""
    moe = cfg.moe
    assert moe is not None
    itemsize = cfg.torch_dtype.itemsize
    return transport_cost(
        comm if comm is not None else moe.comm, ep=ep,
        n_experts=moe.n_experts,
        cap=routed_capacity(cfg, tokens_per_shard, is_training=is_training),
        d_model=cfg.d_model, itemsize=itemsize)


def step_cost(cfg: ModelConfig, *, tokens_per_shard: int, ep: int,
              comm: Optional[CommConfig] = None, is_training: bool = True,
              backward: bool = False) -> Dict[str, float]:
    """Transport cost of one ROUTED model step: ``layer_cost`` x the
    number of MoE layers; ``backward=True`` doubles everything (the VJP
    of every wire hop is the reverse hop — exact when ``remat`` is off;
    remat recomputes the forward inside the backward, adding one more
    forward's worth of collectives on top)."""
    from repro_torch.training.steps import n_moe_layers
    per = layer_cost(cfg, tokens_per_shard=tokens_per_shard, ep=ep,
                     comm=comm, is_training=is_training)
    mult = n_moe_layers(cfg) * (2 if backward else 1)
    return {k: v * mult for k, v in per.items()}


def transport_time(cost: Dict[str, float], topology) -> Dict[str, float]:
    """Bandwidth-weighted two-tier wire time: intra-tier wire priced at
    the topology's intra-tier bandwidth, inter-tier at the inter-tier
    one. ``exposed_s``/``hidden_s`` split the total by the cost
    dict's structural exposed fraction. Pure math — never changes
    numerics, only estimates."""
    intra_s = cost["intra_wire_bytes"] / topology.intra_bps
    inter_s = cost["inter_wire_bytes"] / topology.inter_bps
    comm_s = intra_s + inter_s
    w = cost["wire_bytes"]
    frac = (cost.get("exposed_wire_bytes", w) / w) if w > 0 else 1.0
    return {"comm_s": comm_s, "exposed_s": comm_s * frac,
            "hidden_s": comm_s * (1.0 - frac)}


def pipeline_time(compute_s: float, comm_s: float, n_chunks: int) -> float:
    """Step time of the n-chunk double-buffered pipeline under a
    two-resource (network + compute) FIFO event model: dispatch(0) is
    issued first, then per chunk i the schedule issues dispatch(i+1),
    FFN(i) (after dispatch(i) lands), combine(i) (after FFN(i)) — the
    program order ``Transport.pipelined`` emits. Network ops serialize in
    issue order on one channel; compute on another. n_chunks=1 collapses
    to the serial comm + compute sum (nothing overlaps)."""
    n = max(1, int(n_chunks))
    if n == 1:
        return comm_s + compute_s
    hop_s = comm_s / (2 * n)           # one chunk's dispatch OR combine
    ffn_s = compute_s / n
    net = hop_s                        # dispatch(0) in flight
    d_done = [net] + [0.0] * (n - 1)
    cpu = 0.0
    for i in range(n):
        if i + 1 < n:
            net += hop_s
            d_done[i + 1] = net
        cpu = max(cpu, d_done[i]) + ffn_s          # FFN(i)
        net = max(net, cpu) + hop_s                # combine(i)
    return net


def substrate_table(cfg: ModelConfig, *, tokens_per_shard: int, ep: int,
                    is_training: bool = True, quant: str = "int8",
                    n_chunks: int = 0,
                    topology=None) -> Dict[str, Dict[str, float]]:
    """Predicted per-step forward bytes for every registered substrate at
    a given factorization. Pure math (the registry import only defines
    transport builders). Each row also carries the two-tier time
    estimates ``t_comm_s``/``t_exposed_s`` (``transport_time`` at the
    config's — or the given — topology); ``n_chunks`` overrides the
    overlapped substrates' chunk count (0 keeps the config's)."""
    import dataclasses
    from repro_torch.comm.substrate import available_substrates
    out = {}
    for name in available_substrates():
        comm = dataclasses.replace(
            cfg.moe.comm, substrate=name, quant=quant,
            n_chunks=n_chunks or cfg.moe.comm.n_chunks)
        c = step_cost(cfg, tokens_per_shard=tokens_per_shard,
                      ep=ep, comm=comm, is_training=is_training)
        t = transport_time(c, topology or comm.topology)
        c["t_comm_s"] = t["comm_s"]
        c["t_exposed_s"] = t["exposed_s"]
        out[name] = c
    return out


def format_table(table: Dict[str, Dict[str, float]]) -> str:
    """Human-readable substrate comparison (MiB per device per step);
    ``exp MiB`` is the structurally exposed (non-overlappable) wire and
    ``t_exp`` its two-tier bandwidth-weighted time."""
    hdr = (f"{'substrate':<36}{'a2a':>5}{'bytes MiB':>12}"
           f"{'wire MiB':>11}{'inter MiB':>11}{'exp MiB':>10}"
           f"{'t_comm ms':>11}{'t_exp ms':>10}{'vs dense':>10}")
    lines = [hdr, "-" * len(hdr)]
    base = table.get("dense", {}).get("wire_bytes", 0.0) or math.inf
    for name, c in table.items():
        rel = c["wire_bytes"] / base if base else 0.0
        exposed = c.get("exposed_wire_bytes", c["wire_bytes"])
        t_comm = c.get("t_comm_s", 0.0) * 1e3
        t_exp = c.get("t_exposed_s", 0.0) * 1e3
        lines.append(
            f"{name:<36}{int(c['calls']):>5}{c['bytes']/2**20:>12.2f}"
            f"{c['wire_bytes']/2**20:>11.2f}"
            f"{c['inter_wire_bytes']/2**20:>11.2f}"
            f"{exposed/2**20:>10.2f}{t_comm:>11.3f}{t_exp:>10.3f}"
            f"{rel:>9.2f}x")
    return "\n".join(lines)
