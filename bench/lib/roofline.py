"""The least time a kernel call could take on one H100, from its shapes.

The peaks are NVIDIA's data sheet for the H100 SXM (dense): HBM at 3.35
TB/s; 989 TFLOP/s in bf16 on the tensor cores; 67 TFLOP/s in f32 on the
CUDA cores, which the port's f32 kernels use. A call's bound is the
larger of its bytes over the bandwidth and its operations over the peak
of its input type. Bytes count each input byte read once (only the rows
the routing selects) and each output byte written once; operations count
only the slots that hold a token. ``work`` is a frozen copy of
``chip_smoke.py::work`` for B1-B4, taking the routing state as host
numbers so that no call reads the device.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
MODEL_PEAK_FLOPS = 989e12        # bf16 dense: the peak an MFU is taken over

# wrapper -> pattern over the demangled kernel name (a frozen copy of
# ``repro_torch/analysis/launches.py::KERNELS``)
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


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype])


def work(name: str, a: Dict) -> Tuple[float, float, str]:
    """(bytes, operations, input type) of one call; ``a`` holds its sizes:
    B1 ``e, c, d, f, itemsize, dtype``; B2 ``rows`` (distinct tokens read),
    ``slots``, ``row_bytes``; B3 ``rows`` (distinct buffer rows read),
    ``t, k, row_bytes, d``; B4 ``live`` (experts holding a weighted kept
    slot), ``kept`` (kept slots), ``mats``, ``d, f, w_itemsize, x_bytes,
    slots, t, k, dtype``."""
    if name in ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw"):
        e, c, d, f = a["e"], a["c"], a["d"], a["f"]
        return ((e * c * d + e * d * f + e * c * f) * a["itemsize"],
                2.0 * e * c * d * f, a["dtype"])
    if name == "dispatch":
        rb = a["row_bytes"]
        return a["rows"] * rb + a["slots"] * (rb + 4 + 1), 0.0, a["dtype"]
    if name == "combine":
        rb = a["row_bytes"]
        return (a["rows"] * rb + a["t"] * rb + a["t"] * a["k"] * 9,
                2.0 * a["t"] * a["k"] * a["d"], "float32")
    if name == "fused_moe":
        d, f = a["d"], a["f"]
        nbytes = (a["live"] * a["mats"] * d * f * a["w_itemsize"] + 2 * a["x_bytes"]
                  + a["slots"] * 5 + a["t"] * a["k"] * 9)
        return nbytes, 2.0 * a["mats"] * a["kept"] * d * f, a["dtype"]
    raise KeyError(name)
