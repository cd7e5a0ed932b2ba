"""The frozen trace reduction (busy time as the union of device intervals,
idle gaps named by the host event open at their start, kernel time by
wrapper), the frozen ``work`` of B1-B4 and the kernel-call wrappers that
note each call's sizes in the traced run."""
import pytest
import torch

from bench.lib import hooks, readers, roofline, trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_is_the_union_of_device_intervals_and_gaps_are_named():
    events = [
        _ev("kernel", "void (anonymous namespace)::grouped_matmul_tiled<float, false, false, true>(x)", 0, 10),
        _ev("kernel", "dispatch_words_kernel<16, 1>", 5, 10),        # overlaps: 0-15
        _ev("gpu_memcpy", "Memcpy HtoD", 20, 5),                    # gap 15-20
        _ev("kernel", "fused_moe_tiled<float, true, true>", 40, 10),  # gap 25-40
        _ev("cpu_op", "aten::item", 24, 30),
        _ev("user_annotation", "train_chunk", 0, 100),
        {"ph": "i", "name": "x", "ts": 1},
    ]
    s = trace.reduce(events, window_s=100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert [round(g * 1e6) for _, g in s["idle_gaps"]] == [15, 5]
    assert s["idle_gaps"][0][0] == "cpu_op:aten::item"
    assert s["idle_gaps"][1][0] == "user_annotation:train_chunk"
    assert s["kernels"]["grouped_matmul"] == {"launches": 1, "seconds": pytest.approx(10e-6)}
    assert s["kernels"]["fused_moe"]["launches"] == 1
    assert readers.idle({"profile": s}) == pytest.approx(70.0)


@pytest.mark.parametrize("name,wrapper", [
    ("gmm_stream_dx<float>", "grouped_matmul_dx"),
    ("void (anonymous namespace)::grouped_matmul_tiled<float, true, false, true>(float)", "grouped_matmul_dw"),
    ("combine_cols_kernel<__nv_bfloat16>", "combine"),
    ("flash_decode_mma_kernel<float, true>", "flash_decode_paged"),
    ("cutlass_80_simt_sgemm_256x128_8x4_nn_align1", None),
])
def test_kernel_names_map_to_wrappers(name, wrapper):
    assert trace.wrapper_of(name) == wrapper


def test_work_counts_bytes_once_and_operations_of_kept_slots():
    a = dict(e=128, c=64, d=512, f=2048, itemsize=4, dtype="float32")
    nbytes, ops, dt = roofline.work("grouped_matmul", a)
    assert nbytes == (128 * 64 * 512 + 128 * 512 * 2048 + 128 * 64 * 2048) * 4
    assert ops == 2.0 * 128 * 64 * 512 * 2048 and dt == "float32"
    assert roofline.bound_s(nbytes, ops, dt) == pytest.approx(ops / 67e12)
    b4 = dict(live=16, kept=256, mats=3, d=6144, f=10752, w_itemsize=4, x_bytes=65 * 6144 * 2,
              slots=16 * 65, t=65, k=4, dtype="float32")
    nbytes, ops, _ = roofline.work("fused_moe", b4)
    assert nbytes == 16 * 3 * 6144 * 10752 * 4 + 2 * 65 * 6144 * 2 + 16 * 65 * 5 + 65 * 4 * 9
    assert ops == 2.0 * 3 * 256 * 6144 * 10752
    assert readers.roofline({"profile": {"kernels": {"fused_moe": {"launches": 2, "seconds": 4.0}}},
                             "bounds": {"fused_moe": [1.0, 2.0, 3.0]}},
                            ("fused_moe",)) == pytest.approx(100.0 * 2.0 * 2 / 4.0)


def test_kernel_calls_note_each_call_and_restore_the_wrappers():
    from repro_torch.core.router import DispatchInfo
    from repro_torch.kernels import grouped_ffn, moe_dispatch, moe_megakernel, ops
    before = (grouped_ffn.grouped_matmul, moe_dispatch.dispatch, moe_megakernel.fused_moe)
    t, e, c, d, f = 6, 2, 4, 8, 16
    x = torch.randn(t, d)
    idx = torch.tensor([[0], [1], [0], [0], [1], [1]])
    info = DispatchInfo(pos=torch.tensor([[0], [0], [1], [2], [1], [2]]),
                        keep=torch.ones(t, 1, dtype=torch.bool), topk_idx=idx,
                        topk_w=torch.full((t, 1), 0.5))
    w_in, w_out = torch.randn(e, d, f), torch.randn(e, f, d)
    with hooks.KernelCalls() as kc:
        buf = ops.moe_dispatch_op(x, info, e, c)
        y = ops.expert_ffn_op(buf, w_in, None, w_out, "gelu")
        ops.moe_combine_op(y, info)
        ops.fused_moe_op(x, info, w_in, None, w_out, e, c, "gelu")
    assert (grouped_ffn.grouped_matmul, moe_dispatch.dispatch, moe_megakernel.fused_moe) == before
    b = kc.bounds()
    assert {k: len(v) for k, v in b.items()} == {"dispatch": 1, "grouped_matmul": 2,
                                                 "combine": 1, "fused_moe": 1}
    rows = dict(kc.calls)["dispatch"]
    assert rows["slots"] == e * c
    expect = roofline.bound_s(*roofline.work("fused_moe", dict(
        live=2, kept=6, mats=2, d=d, f=f, w_itemsize=4, x_bytes=x.numel() * 4,
        slots=e * c, t=t, k=1, dtype="float32")))
    assert b["fused_moe"][0] == pytest.approx(expect)
