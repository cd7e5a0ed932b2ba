"""Kernel launch counts from a ``torch.profiler`` trace (the counterpart
of the reference's launch-count pass, ``repro/analysis/passes.py`` over
``analysis/jaxprs.py::pallas_launches``).

The reference counts ``pallas_call`` sites in a jaxpr; the port counts
what the card ran: the kernel events of a ``torch.profiler`` window (its
Chrome trace, ``cat == "kernel"``), by name, and maps the port's kernels
(``kernels/csrc/*.cu``) to the wrappers of B1-B6. Each wrapper call on the
main path is ONE launch of its kernel, so over a window these counts equal
the wrappers' ``launch_counts()``:

  B1 ``grouped_matmul`` / ``_dx`` / ``_dw``: one ``gmm_stream_fwd`` /
      ``gmm_stream_dx`` / ``gmm_stream_dw`` (streaming) or
      ``grouped_matmul_tiled<T, A_T, B_T, VEC>`` (tiled; the forward
      <.., false, false, ..>, dx <.., false, true, ..>, dW <.., true,
      false, ..>). Its
      output comes from ``torch.empty``: no fill (an empty product's
      ``zero_`` is the only other launch, off the main path).
  B2 ``dispatch``: one ``dispatch_words_kernel<W, N>``.
  B3 ``combine``: one ``combine_rows_kernel`` or ``combine_cols_kernel``
      (a programmatic dependent launch, still one launch).
  B4 ``fused_moe``: one ``fused_moe_stream`` or ``fused_moe_tiled``,
      beside PyTorch's own launches in the wrapper (the zero fill of the
      output, slot weights and counts; the slot-weight scatter; the cast).
  B5 ``flash_decode`` / B6 ``flash_decode_paged``: one
      ``flash_decode_kernel<TQ, TKV, false|true>`` (one query head per
      kv head), ``flash_decode_mma_kernel<TQ, false|true>`` (grouped-query
      heads on a bf16 cache) or ``flash_decode_gqa_kernel<TQ, TKV,
      false|true>`` (the others); a split cache's merge runs inside the
      same launch, its arrival counters reset by the merging block, so
      there is no memset and no second kernel.

``repro_launch_floor``'s and ``repro_copy_early_trigger``'s kernels are
timing and test aids and map to no wrapper.
"""
from __future__ import annotations

import json
import re
from collections import Counter
from typing import Any, Dict, List, Optional, Union

__all__ = ["KERNELS", "kernel_counts", "launched_kernels", "port_counts"]

# wrapper -> pattern over the demangled kernel name
KERNELS = {
    "grouped_matmul": r"gmm_stream_fwd<|grouped_matmul_tiled<[^,>]*, false, false,",
    "grouped_matmul_dx": r"gmm_stream_dx<|grouped_matmul_tiled<[^,>]*, false, true,",
    "grouped_matmul_dw": r"gmm_stream_dw<|grouped_matmul_tiled<[^,>]*, true, false,",
    "dispatch": r"dispatch_words_kernel<",
    "combine": r"combine_(rows|cols)_kernel<",
    "fused_moe": r"fused_moe_stream<|fused_moe_tiled<",
    "flash_decode": r"flash_decode(_gqa|_mma)?_kernel<[^>]*, false>",
    "flash_decode_paged": r"flash_decode(_gqa|_mma)?_kernel<[^>]*, true>",
}
_COMPILED = {name: re.compile(p) for name, p in KERNELS.items()}


def _kernel_events(trace: Union[str, Dict[str, Any]]) -> List[Dict[str, Any]]:
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    return [ev for ev in trace["traceEvents"]
            if ev.get("ph") == "X" and ev.get("cat") == "kernel"]


def kernel_counts(trace: Union[str, Dict[str, Any]]) -> Dict[str, int]:
    """Device kernel launches by name in a ``torch.profiler`` Chrome trace
    (its path, or the loaded document)."""
    return dict(Counter(ev["name"] for ev in _kernel_events(trace)))


def wrapper_of(kernel: str) -> Optional[str]:
    """The wrapper whose kernel ``kernel`` (a demangled name) is, or None
    for a kernel that is not the port's."""
    hits = [name for name, rx in _COMPILED.items() if rx.search(kernel)]
    if len(hits) > 1:
        raise ValueError(f"kernel {kernel!r} matches {hits}")
    return hits[0] if hits else None


def launched_kernels(trace: Union[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """The port's kernels in a trace, by name: their wrapper, launches and
    what the card reported for the launches (CUPTI's kernel record, in the
    event's args): the most registers per thread and shared memory per
    block, static and dynamic (None where the trace carries no such
    argument)."""
    out: Dict[str, Dict[str, Any]] = {}
    for ev in _kernel_events(trace):
        wrapper = wrapper_of(ev["name"])
        if wrapper is None:
            continue
        row = out.setdefault(ev["name"], {"wrapper": wrapper, "launches": 0,
                                          "registers": None, "smem_bytes": None})
        row["launches"] += 1
        args = ev.get("args", {})
        for key, arg in (("registers", "registers per thread"),
                         ("smem_bytes", "shared memory")):
            if arg in args:
                row[key] = max(int(args[arg]), row[key] or 0)
    return out


def port_counts(kernels: Dict[str, int]) -> Dict[str, int]:
    """Launches of the port's kernels per wrapper (every wrapper of
    ``kernels.wrappers()``, 0 where none ran), from ``kernel_counts``."""
    out = {name: 0 for name in KERNELS}
    for kname, n in kernels.items():
        wrapper = wrapper_of(kname)
        if wrapper is not None:
            out[wrapper] += n
    return out
