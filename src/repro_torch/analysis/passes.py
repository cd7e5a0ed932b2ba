"""Lint pass registry (port of ``repro/analysis/passes.py``).

Passes register under an id via ``@register_pass`` and run against every
executable in the registry (``analysis/executables.py``) whose spec opts
in by carrying an expectation for that pass. A pass returns Findings,
never raises on a violation, so one broken invariant does not mask the
rest of the report; the gate aggregates afterwards.

Suppression: a spec can carry ``ignore=("pass-id", ...)`` (written in
the registry as a trailing ``# lint: ignore[pass-id]`` comment on the
registration line; ``register_executable`` parses it from source).
Suppressed findings stay in the report flagged ``suppressed`` but do not
fail the gate.

The five passes keep the reference's ids but one: the reference's
``vmem-budget`` (a TPU core's VMEM) is ``smem-budget`` here (a CUDA
block's shared memory). What each reads is the executable's one eager
run (``executables.Artifacts``), where the reference reads its jaxpr and
compiled HLO:

  no-collectives  ``wire``      comm.COUNTER's all-to-alls against
                                comm/cost.py, or zero, or nonzero;
  dtype-flow      ``ops``       the aten ops a TorchDispatchMode saw: an
                                f32 mm/bmm/addmm/baddbmm over an operand
                                widened from bf16/f16;
  launch-count    ``launches``  the kernel wrappers' calls against a
                                budget and, on a card, the profiler's
                                kernel launches against the calls;
  smem-budget     ``kernels``   each launched kernel's shared memory per
                                block (card only);
  host-sync       ``scenario``  unsanctioned device-to-host pulls inside
                                steady-state chunks and ticks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

__all__ = ["Finding", "LintPass", "UpcastMatmul", "available_passes",
           "f32_upcast_matmuls", "get_pass", "register_pass", "run_pass"]

SEVERITIES = ("error", "warning", "info")
ARTIFACTS = ("wire", "ops", "launches", "kernels", "scenario")
SMEM_BUDGET = 227 << 10        # an H100 block's opt-in shared memory maximum


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_id: str
    severity: str            # error | warning | info
    executable: str
    location: str            # "ops:repro_torch/models/attention.py:64 (full_attention)", ...
    message: str
    suppressed: bool = False

    def as_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class LintPass:
    pass_id: str
    doc: str
    fn: Callable              # fn(spec, artifacts) -> List[Finding]
    needs: Tuple[str, ...]    # artifact kinds, of ARTIFACTS


_REGISTRY: Dict[str, LintPass] = {}


def register_pass(pass_id: str, *, needs: Tuple[str, ...]
                  ) -> Callable[[Callable], Callable]:
    """Decorator: add a lint pass under ``pass_id``. ``needs`` declares
    which artifacts the pass reads; ``--lint-table`` runs only passes
    whose needs exclude "scenario"."""
    unknown = set(needs) - set(ARTIFACTS)
    if unknown:
        raise ValueError(f"{pass_id}: unknown artifacts {sorted(unknown)}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY[pass_id] = LintPass(pass_id=pass_id,
                                      doc=(fn.__doc__ or "").strip(),
                                      fn=fn, needs=needs)
        return fn
    return deco


def available_passes() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_pass(pass_id: str) -> LintPass:
    try:
        return _REGISTRY[pass_id]
    except KeyError:
        raise KeyError(f"unknown lint pass {pass_id!r}; available: "
                       f"{', '.join(available_passes())}") from None


def run_pass(pass_id: str, spec, art) -> List[Finding]:
    """Run one pass over one executable, applying the spec's
    suppressions. Inapplicable passes (no expectation in the spec)
    return []."""
    p = get_pass(pass_id)
    findings = p.fn(spec, art)
    if pass_id in spec.ignore:
        findings = [dataclasses.replace(f, suppressed=True)
                    for f in findings]
    return findings


# --------------------------------------------------------------------------
# dtype flow over recorded aten ops (the reference's jaxprs.f32_upcast_dots)
# --------------------------------------------------------------------------

_F16 = ("torch.bfloat16", "torch.float16")
_MATMULS = {"aten.mm": (0, 1), "aten.bmm": (0, 1), "aten.addmm": (1, 2),
            "aten.baddbmm": (1, 2)}
# ops that only move or alias their first input: einsum and matmul reach
# bmm through them, so a widening cast is followed through them
_LAYOUT = {"aten.permute", "aten.view", "aten._unsafe_view", "aten.expand",
           "aten.clone", "aten.reshape", "aten._reshape_alias", "aten.t",
           "aten.transpose", "aten.contiguous", "aten.unsqueeze",
           "aten.squeeze", "aten.alias", "aten.detach", "aten.as_strided",
           "aten.slice", "aten.select", "aten.lift_fresh"}


@dataclasses.dataclass(frozen=True)
class UpcastMatmul:
    origin: str
    op: str
    out_shape: Tuple[int, ...]
    out_elems: int
    src_dtypes: Tuple[str, ...]   # 16-bit dtypes the operands came from


def _widened_from(ops: Sequence, i: int):
    """The 16-bit dtype the tensor made by op ``i`` was cast to f32 from,
    through layout ops; None when it was not."""
    while i >= 0:
        op = ops[i]
        if op.name == "aten._to_copy":
            src = op.in_dtypes[0] if op.in_dtypes else ""
            return src if src in _F16 and op.out_dtype == "torch.float32" else None
        if op.name not in _LAYOUT or not op.sources:
            return None
        i = op.sources[0]
    return None


def f32_upcast_matmuls(ops: Sequence, *, min_elems: int = 4096) -> List[UpcastMatmul]:
    """The f32 matmuls (mm, bmm, addmm, baddbmm) of ``ops`` (the
    ``executables.OpRecord`` list of one run) with an f32 operand that was
    CAST from a 16-bit dtype, followed back through layout ops (permute,
    view, expand, clone, ...), the way ``torch.einsum`` reaches ``bmm``.
    Whitelisted f32 accumulators stay legal: outputs below ``min_elems``
    are skipped, and a matmul whose operands are still 16-bit never
    matches (its output is not f32)."""
    hits: List[UpcastMatmul] = []
    for op in ops:
        pos = _MATMULS.get(op.name)
        if pos is None or op.out_dtype != "torch.float32":
            continue
        elems = 1
        for d in op.out_shape:
            elems *= int(d)
        if elems < min_elems:
            continue
        if any(op.in_dtypes[p] != "torch.float32" for p in pos):
            continue
        srcs = [s for s in (_widened_from(ops, op.sources[p]) for p in pos) if s]
        if srcs:
            hits.append(UpcastMatmul(origin=op.origin, op=op.name,
                                     out_shape=tuple(op.out_shape),
                                     out_elems=elems, src_dtypes=tuple(srcs)))
    return hits


# --------------------------------------------------------------------------
# the five shipped passes
# --------------------------------------------------------------------------

def _finding(spec, pass_id, sev, loc, msg, **kw) -> Finding:
    return Finding(pass_id=pass_id, severity=sev, executable=spec.name,
                   location=loc, message=msg, **kw)


@register_pass("no-collectives", needs=("wire",))
def no_collectives_pass(spec, art) -> List[Finding]:
    """Zero-communication / bytes-equality gate: Gate-Drop LOCAL,
    dropped-chunk and local-routing executables must issue ZERO
    all-to-alls (the paper's §3 structural claim); routed executables'
    all-to-all calls and bytes must equal the comm/cost.py analytic model
    per rank (``comm.COUNTER``, forward and backward, over the whole
    run: a train chunk of K steps is K x ``step_cost``)."""
    exp = spec.expect.get("no-collectives")
    if exp is None:
        return []
    w = art.wire
    calls, nbytes, wire = w["calls"], w["bytes"], w["wire_bytes"]
    loc = "comm.COUNTER"
    out: List[Finding] = []
    if exp.get("zero"):
        if calls:
            out.append(_finding(
                spec, "no-collectives", "error", loc,
                f"expected ZERO all-to-alls, found {calls} moving "
                f"{nbytes:.0f} B"))
        return out
    if exp.get("nonzero") and not calls:
        out.append(_finding(
            spec, "no-collectives", "error", loc,
            "expected a routed executable (all-to-alls present), found "
            "none: the expert exchange was silently elided"))
    cost = exp.get("cost")
    if cost is not None:
        if int(calls) != int(cost["calls"]):
            out.append(_finding(
                spec, "no-collectives", "error", loc,
                f"all-to-all count {int(calls)} != cost model "
                f"{int(cost['calls'])}"))
        if float(nbytes) != float(cost["bytes"]):
            out.append(_finding(
                spec, "no-collectives", "error", loc,
                f"all-to-all payload {nbytes:.0f} B != cost model "
                f"{cost['bytes']:.0f} B"))
        if abs(float(wire) - float(cost["wire_bytes"])) >= 1:
            out.append(_finding(
                spec, "no-collectives", "error", loc,
                f"all-to-all wire {wire:.1f} B != cost model "
                f"{cost['wire_bytes']:.1f} B"))
    return out


@register_pass("dtype-flow", needs=("ops",))
def dtype_flow_pass(spec, art) -> List[Finding]:
    """No f32 leakage in 16-bit paths: flags f32 matmuls (mm, bmm, addmm,
    baddbmm) over an operand CAST from bf16/f16 (2x the FLOP and read
    width of the declared model dtype), read from the aten ops one run
    dispatched, a cast followed through layout ops. Whitelisted f32
    accumulators (router logits, attention probabilities at small
    shapes) don't match: they are below ``min_elems`` or keep 16-bit
    operands."""
    exp = spec.expect.get("dtype-flow")
    if exp is None:
        return []
    hits = f32_upcast_matmuls(art.ops, min_elems=exp.get("min_elems", 4096))
    return [
        _finding(spec, "dtype-flow", "error", "ops:" + h.origin,
                 f"f32 {h.op} over operands widened from "
                 f"{'/'.join(sorted(set(h.src_dtypes)))}; output "
                 f"{h.out_shape} ({h.out_elems} elems): keep the 16-bit "
                 f"operands and accumulate in f32 instead")
        for h in hits]


@register_pass("smem-budget", needs=("kernels",))
def smem_budget_pass(spec, art) -> List[Finding]:
    """Kernel residency (the reference's vmem-budget): each launched
    kernel's shared memory per block, as the card reports it for the
    launch (``torch.profiler``) and for the variant (``variant_info``),
    against the spec's budget (default 227 KiB, an H100 block's opt-in
    maximum). Needs a card: on the CPU it returns one warning, no error."""
    exp = spec.expect.get("smem-budget")
    if exp is None:
        return []
    if art.kernels is None:
        return [_finding(spec, "smem-budget", "warning", "gate",
                         "skipped: needs a CUDA device")]
    budget = exp.get("budget_bytes", SMEM_BUDGET)
    out: List[Finding] = []
    for k in art.kernels:
        if k["smem_bytes"] > budget:
            out.append(_finding(
                spec, "smem-budget", "error", f"kernel:{k['kernel']}",
                f"{k['wrapper']}: shared memory {k['smem_bytes']} B per block > "
                f"budget {budget} B ({k['registers']} registers per thread, "
                f"{k['spill_bytes']} B spilled per thread)"))
    return out


@register_pass("launch-count", needs=("launches",))
def launch_count_pass(spec, art) -> List[Finding]:
    """Kernel-launch budget: ``cuda_fused`` must stay a SINGLE kernel
    call per step (the fusion claim), the unfused pipeline within its
    dispatch/FFN/combine budget. Counted as the wrappers' calls, which the
    CPU also makes; on a card each wrapper's kernel launches in the
    profiler's trace must also equal its calls (a wrapper that launches a
    second kernel, or none, fails)."""
    exp = spec.expect.get("launch-count")
    if exp is None:
        return []
    calls = {k: v for k, v in art.launches["calls"].items() if v}
    out: List[Finding] = []
    total, budget = sum(calls.values()), exp["max"]
    if total > budget:
        names = ", ".join(f"{k} x{v}" for k, v in sorted(calls.items()))
        out.append(_finding(
            spec, "launch-count", "error", f"wrappers:{names}",
            f"{total} kernel calls > budget {budget}"))
    kernels = art.launches.get("kernels")
    if kernels is not None:
        for name in sorted(set(calls) | {k for k, v in kernels.items() if v}):
            if kernels.get(name, 0) != calls.get(name, 0):
                out.append(_finding(
                    spec, "launch-count", "error", f"profiler:{name}",
                    f"{name}: {calls.get(name, 0)} calls but "
                    f"{kernels.get(name, 0)} kernel launches on the card"))
    return out


@register_pass("host-sync", needs=("scenario",))
def host_sync_pass(spec, art) -> List[Finding]:
    """No hidden device->host transfers inside steady-state Trainer
    chunks or scheduler ticks (``analysis.hostsync.fetch`` is sanctioned;
    on a card the CUDA sync debug mode's events count too). The
    reference's second half, jit cache growth across ticks, has no
    counterpart: eager PyTorch compiles nothing per tick."""
    if spec.scenario is None:
        return []
    res = spec.scenario(art.device)
    out: List[Finding] = []
    for ev in res.get("events", ()):
        if ev.sanctioned or ev.internal:
            continue
        out.append(_finding(
            spec, "host-sync", "error", ev.origin,
            f"implicit device->host transfer via {ev.method} inside a "
            f"steady-state tick; use analysis.hostsync.fetch if the sync "
            f"is intentional"))
    return out
