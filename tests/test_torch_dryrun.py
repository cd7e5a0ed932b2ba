"""The meta-device dry run (``repro_torch/launch/dryrun.py``) on the CPU:

  * the meta init draws nothing and gives the CPU init's tree (keys,
    shapes, dtypes) for every arch;
  * FLOPs: the meta count of a step equals the count of the same step on
    CPU tensors (reduced zcode-m3-base: a routed, a Gate-Drop and a
    Gate-Expert-Drop train step, a prefill and a decode step); the
    extrapolation over ``_variant_cfgs`` equals the direct full-depth count
    for a reduced config of each family (encoder-decoder, VLM, hybrid,
    ``first_dense_layers``, ``moe_layer_period``, dense); a reduced dense
    decoder's prefill equals its analytic matmul count;
  * saved activations: ``seq_parallel`` divides the layer-boundary share
    of the bytes per device by the model axis and leaves the rest;
  * ``banded_flash_attention`` inside ``full_bands()`` (the ``use_full``
    cost mode) against the reference's ``use_full=True`` within f32 1e-5;
  * the MoE all-to-alls of the layout against the reference's cost model;
  * the CLI: one full-size pair writes its artifact, the inapplicable
    yi-6b x long_500k is refused, ``--comm-table`` prints the reference's
    table.

Counts (FLOPs, bytes) are compared exactly; attention outputs within
1e-5 abs.
"""
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.comm import cost as jax_cost  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.flash import banded_flash_attention as jax_banded  # noqa: E402
from repro_torch.configs import (ARCHS, INPUT_SHAPES, GatingDropoutConfig,  # noqa: E402
                                 InputShape, get_config, reduced)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import production_mesh  # noqa: E402
from repro_torch.models import flash as FL  # noqa: E402
from repro_torch.models import init_model, init_model_meta  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

MESHES = (production_mesh(), production_mesh(multi_pod=True))
TRAIN = InputShape("train_small", 16, 4, "train")
PREFILL = InputShape("prefill_small", 16, 4, "prefill")
DECODE = InputShape("decode_small", 16, 4, "decode")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_comm_table():
    """The reference's ``comm_table``; importing its module sets XLA_FLAGS
    for its own CLI, which is put back at once."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import comm_table
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return comm_table


def _zcode(mode="gate_drop"):
    cfg = reduced(get_config("zcode-m3-base"), remat=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, gating_dropout=GatingDropoutConfig(mode=mode, rate=0.3)))


# ---------------------------------------------------------------------------
# meta init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_equals_cpu_init(arch):
    """``init_model_meta`` draws nothing (a meta generator is refused by
    torch) and gives the seeded CPU init's keys, shapes and dtypes."""
    cfg = reduced(get_config(arch))
    meta = flatten_with_paths(init_model_meta(cfg))
    cpu = flatten_with_paths(init_model(torch.Generator().manual_seed(0), cfg))
    assert list(meta) == list(cpu)
    for k, t in meta.items():
        assert t.device.type == "meta", k
        assert (t.shape, t.dtype) == (cpu[k].shape, cpu[k].dtype), k


# ---------------------------------------------------------------------------
# FLOPs and saved activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["train_routed", "train_gate_drop", "train_expert_drop",
                                  "prefill", "decode"])
def test_meta_counts_equal_cpu_counts(case):
    """The meta step's FLOPs and saved bytes equal the same step's on CPU
    tensors (seeded weights and ids): they depend on shapes alone."""
    cfg = _zcode("gate_expert_drop" if case == "train_expert_drop" else "gate_drop")
    shape = {"prefill": PREFILL, "decode": DECODE}.get(case, TRAIN)
    decision = case in ("train_gate_drop", "train_expert_drop")
    meta = D.run_step(cfg, shape, decision, MESHES)
    cpu = D.run_step(cfg, shape, decision, MESHES, device="cpu")
    assert meta == cpu and meta["flops"] > 0
    if shape.kind == "train":
        assert meta["boundary"] > 0 and meta["saved"] > meta["boundary"]
    if case == "train_expert_drop":         # the MoE layers skipped: less work
        assert meta["flops"] < D.run_step(cfg, shape, False, MESHES)["flops"]


def _family_cfg(family):
    """A reduced config of each ``_variant_cfgs`` family, at a depth the
    variants' layer counts span (remat on for the dense decoder alone:
    the recomputation doubles the forward's cost on the CPU, and the
    meta-against-CPU tests run zcode with it)."""
    if family == "encdec":
        cfg = dataclasses.replace(_zcode(), remat=False)
        return dataclasses.replace(cfg, n_layers=4, encdec=dataclasses.replace(
            cfg.encdec, n_encoder_layers=4))
    if family == "vlm":
        cfg = reduced(get_config("llama-3.2-vision-90b"))
        return dataclasses.replace(cfg, n_layers=15, vlm=dataclasses.replace(
            cfg.vlm, cross_attn_period=5))
    if family == "hybrid":
        cfg = reduced(get_config("hymba-1.5b"))
        return dataclasses.replace(cfg, n_layers=6, hybrid=dataclasses.replace(
            cfg.hybrid, global_attn_layers=(0, 5)))
    if family == "first_dense_layers":
        cfg = reduced(get_config("deepseek-v3-671b"))
        return dataclasses.replace(cfg, n_layers=5, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=2))
    if family == "moe_layer_period":
        cfg = reduced(get_config("dbrx-132b"))
        return dataclasses.replace(cfg, n_layers=8, moe=dataclasses.replace(
            cfg.moe, moe_layer_period=2))
    return dataclasses.replace(reduced(get_config("yi-6b"), remat=True), n_layers=5)


FAMILIES = ["encdec", "vlm", "hybrid", "first_dense_layers", "moe_layer_period", "dense"]


@pytest.fixture(scope="module")
def pooled():
    """``run_all`` (the --all path: the variants' steps on spawned
    workers, costliest first) over a train step of every family, a job
    whose step raises, and a prefill: {job name: (cfg, shape, artifacts or
    None)} and the failures."""
    bad = dataclasses.replace(reduced(get_config("yi-6b")), family="nope")
    jobs = {f: (_family_cfg(f), TRAIN) for f in FAMILIES}
    jobs["bad"] = (bad, DECODE)
    jobs["prefill"] = (reduced(get_config("mamba2-1.3b")), PREFILL)
    results, failures = D.run_all(list(jobs.values()), MESHES, workers=4)
    return {k: (*job, got) for (k, job), got in zip(jobs.items(), results)}, failures


@pytest.mark.parametrize("family", FAMILIES)
def test_extrapolation_equals_full_depth(family, pooled):
    """FLOPs, saved and layer-boundary bytes and the bytes per device of a
    train step, extrapolated from the variants (``run_all``), equal the
    full-depth count exactly."""
    cfg, _, arts = pooled[0][family]
    variants = D._variant_cfgs(cfg)
    assert all(v.n_layers < cfg.n_layers or (v.encdec and v.encdec.n_encoder_layers
                                             < cfg.encdec.n_encoder_layers)
               for v in variants)
    want = D.run_step(cfg, TRAIN, False, MESHES)
    for mesh, art in zip(MESHES, arts):
        mem = art["memory"]
        assert (art["flops_step"], mem["saved_activation_bytes"],
                mem["saved_layer_boundary_bytes"],
                mem["saved_activation_bytes_per_device"]) == (
            want["flops"], want["saved"], want["boundary"],
            want[f"saved_per_device/{mesh.name}"])


def test_dense_prefill_equals_analytic_count():
    """A reduced dense decoder's prefill (quadratic attention at 64 keys)
    counts exactly its matmuls: Q/K/V/O projections, scores and values
    over every head, the gated FFN, and the head at the last position."""
    cfg = reduced(get_config("yi-6b"))
    b, l = 2, 64
    d, h, kv, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
                          cfg.d_ff, cfg.vocab)
    t = b * l
    per_layer = (2 * t * d * (h + 2 * kv) * hd + 2 * 2 * b * h * l * l * hd
                 + 2 * t * h * hd * d + 3 * 2 * t * d * f)
    want = cfg.n_layers * per_layer + 2 * b * d * v
    assert D.run_step(cfg, InputShape("p", l, b, "prefill"))["flops"] == want


def test_seq_parallel_divides_the_layer_boundary_share():
    """Under ``seq_parallel`` the per-device saved bytes divide the layer
    inputs (one (B, L, d) f32 tensor per layer, kept by remat) by the
    model axis as well; the rest splits over the data axes only."""
    cfg = reduced(get_config("yi-6b"), remat=True)
    shape = InputShape("t", 32, 32, "train")
    off = D.run_step(cfg, shape, False, MESHES)
    on = D.run_step(dataclasses.replace(cfg, seq_parallel=True), shape, False, MESHES)
    assert (on["saved"], on["boundary"], on["flops"]) == \
        (off["saved"], off["boundary"], off["flops"])
    assert off["boundary"] == cfg.n_layers * 32 * 32 * cfg.d_model * 4
    rest = off["saved"] - off["boundary"]
    for mesh in MESHES:
        dp = S.axis_size(mesh, mesh.dp_axes)
        assert off[f"saved_per_device/{mesh.name}"] * dp == off["saved"]
        assert on[f"saved_per_device/{mesh.name}"] * dp == rest + off["boundary"] / 16
    res = D.dry_run(dataclasses.replace(cfg, seq_parallel=True), shape, MESHES[:1])[0]
    assert res["memory"]["saved_activation_split"] == \
        ("batch over data; layer-boundary saves also over model; model axis not "
         "applied to the other saves (overstates a device's share)")


# ---------------------------------------------------------------------------
# use_full
# ---------------------------------------------------------------------------

def test_use_full_matches_reference():
    """Each band by plain full attention inside ``full_bands()``, against
    the reference's ``use_full`` and the port's blocked bands (the FLOP
    count follows the mode, and the mode ends with the block)."""
    from torch.utils.flop_counter import FlopCounterMode
    rs = np.random.RandomState(0)
    q = rs.randn(2, 100, 4, 16).astype(np.float32)
    k = rs.randn(2, 100, 2, 16).astype(np.float32)
    v = rs.randn(2, 100, 2, 16).astype(np.float32)
    kw = dict(q_chunk=32, kv_chunk=16)
    want = np.asarray(jax_banded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 24,
                                 use_full=True, **kw))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with FL.full_bands():
        full = FL.banded_flash_attention(tq, tk, tv, 24, **kw)
    np.testing.assert_allclose(full.numpy(), want, atol=1e-5, rtol=0)
    blocked = FL.banded_flash_attention(tq, tk, tv, 24, **kw)
    np.testing.assert_allclose(blocked.numpy(), want, atol=1e-5, rtol=0)

    def flops():
        with FlopCounterMode(display=False) as fc:
            FL.banded_flash_attention(tq, tk, tv, 24, **kw)
        return fc.get_total_flops()
    blocked_f = flops()
    with FL.full_bands():
        full_f = flops()
    assert full_f != blocked_f and flops() == blocked_f


# ---------------------------------------------------------------------------
# collectives, artifacts, CLI
# ---------------------------------------------------------------------------

def test_collectives_follow_the_reference_cost_model():
    """zcode-m3-base x train_4k: the forward, backward and remat's
    recomputed forward (3 x the reference's forward bytes); a prefill
    pays the forward alone; a dropped step and a dense arch nothing."""
    cfg, jcfg = get_config("zcode-m3-base"), jax_get_config("zcode-m3-base")
    tokens = 256 * 4096 // 16
    fwd = jax_cost.step_cost(jcfg, tokens_per_shard=tokens, ep=16, is_training=True)
    got = D.a2a_per_device(cfg, INPUT_SHAPES["train_4k"], MESHES[0], False)["all-to-all"]
    assert got == {"count": 3 * fwd["calls"], "bytes": 3 * fwd["bytes"],
                   "wire_bytes": 3 * fwd["wire_bytes"]}
    pf = jax_cost.step_cost(jcfg, tokens_per_shard=32 * 32768 // 32, ep=16,
                            is_training=False)
    got = D.a2a_per_device(cfg, INPUT_SHAPES["prefill_32k"], MESHES[1], False)["all-to-all"]
    assert (got["count"], got["bytes"]) == (pf["calls"], pf["bytes"])
    assert D.a2a_per_device(cfg, INPUT_SHAPES["train_4k"], MESHES[0], True)[
        "all-to-all"]["count"] == 0
    assert D.a2a_per_device(get_config("yi-6b"), INPUT_SHAPES["train_4k"], MESHES[0],
                            False)["all-to-all"]["count"] == 0


def test_cli_full_size_pair_writes_its_artifact(tmp_path):
    """dbrx-132b x decode_32k at full width and depth on the meta device:
    the artifact's keys, its bytes per device against the rules, its
    all-to-alls (routed: 40 MoE layers x dispatch + combine), the trace
    and the metrics."""
    out = tmp_path / "dry"
    trace, metrics = tmp_path / "t.json", tmp_path / "m.prom"
    assert D.main(["--arch", "dbrx-132b", "--shape", "decode_32k", "--out-dir", str(out),
                   "--tag", "t", "--trace-out", str(trace),
                   "--metrics-out", str(metrics)]) == 0
    res = json.loads((out / "dbrx-132b__decode_32k__pod256__t.json").read_text())
    cfg = get_config("dbrx-132b")
    shape = INPUT_SHAPES["decode_32k"]
    assert res["memory"] == {"argument_bytes_per_device": D.argument_bytes(
        cfg, MESHES[0], D.step_arguments(cfg, shape))}
    assert (res["n_devices"], res["mesh"], res["tokens_per_step"], res["decision"],
            res["moe_backend"], res["variants"]) == (256, {"data": 16, "model": 16}, 128,
                                                      "routed", "oracle", 2)
    assert res["flops_step"] > 0 and res["n_params"] == cfg.n_params()
    assert res["collectives"]["all-to-all"]["count"] == 80
    assert "temp" not in json.dumps(res) and "flops" not in res
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"dryrun.measure", "dryrun.arguments"} <= names
    assert "dryrun_combos 1.0" in metrics.read_text()


def test_cli_refuses_an_inapplicable_pair(capsys):
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "yi-6b", "--shape", "long_500k"])
    assert e.value.code == 2 and "inapplicable" in capsys.readouterr().err
    with pytest.raises(ValueError, match="inapplicable"):
        D.run_one("yi-6b", "long_500k", out_dir=None, verbose=False)


@pytest.mark.parametrize("extra,kw", [
    ([], {}),
    (["--multi-pod", "--comm-quant", "fp8", "--comm-chunks", "2"],
     dict(multi_pod=True, quant="fp8", n_chunks=2)),
])
def test_comm_table_prints_the_reference_table(extra, kw):
    comm_table = _ref_comm_table()
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        comm_table("zcode-m3-base", "train_4k", **kw)
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        assert D.main(["--comm-table", "--arch", "zcode-m3-base", "--shape",
                       "train_4k"] + extra) == 0
    assert got.getvalue() == want.getvalue() and "hierarchical_compressed" in want.getvalue()


def test_run_all_matches_dry_run(pooled):
    """``run_all`` gives ``dry_run``'s artifacts in the jobs' order (the
    prefill's variants ran first), and reports a pair whose step raises
    instead of stopping."""
    jobs, failures = pooled
    assert jobs["bad"][2] is None and len(failures) == 1 and "nope" in failures[0]
    cfg, shape, got = jobs["prefill"]
    for g, w in zip(got, D.dry_run(cfg, shape, MESHES)):
        g, w = dict(g), dict(w)
        g.pop("seconds"), w.pop("seconds")
        assert g == w
