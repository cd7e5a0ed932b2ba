"""The port's lint gate (src/repro_torch/analysis/{passes,executables,lint}.py,
launch/lint.py) on the CPU, against the reference's (src/repro/analysis).

  * each of the five passes fires on a seeded violation, written in torch
    (an extra all-to-all on 2 gloo ranks; an f32 matmul over an upcast
    bf16 tensor; an extra kernel-wrapper call; a ``.item()`` inside a
    guarded tick; kernel resources over the shared-memory budget), and
    not on its clean counterpart (an f32 output below ``min_elems``,
    bf16 operands, the wrapper's budget, a sanctioned fetch);
  * the same seeded upcast, below-threshold and bf16 cases give the
    reference's ``f32_upcast_dots`` hit counts;
  * a ``# lint: ignore[...]`` comment keeps the finding and passes the
    gate;
  * the registry holds the reference's 27 executables, two names mapped
    (``REFERENCE_NAMES``), and the reference's ``vmem-budget`` is
    ``smem-budget``;
  * the CLI: ``--list``, ``--table``, ``--gate --json-out --device cpu``
    over all 27 (8 gloo ranks), and no card without ``--device cpu``
    exits nonzero;
  * parity: on every cell the reference can run (``no-collectives``,
    ``dtype-flow``, ``host-sync``) the port's verdict is the reference's
    (ok everywhere), and for ``moe_layer/dense`` and
    ``train_chunk/routed`` every rank's all-to-all calls, bytes and wire
    bytes equal the reference's compiled HLO (the chunk: K = 2 times the
    reference's scan body, which its HLO holds once). The other
    executables are held to ``comm/cost.py`` by the port's own pass.

Tolerances: counts and bytes exact; wire bytes within 1 B, as the
reference's pass compares them.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import SRC  # noqa: E402
from repro.analysis.jaxprs import f32_upcast_dots  # noqa: E402
from repro_torch.analysis import executables as X  # noqa: E402
from repro_torch.analysis import lint as LL  # noqa: E402
from repro_torch.analysis import passes as P  # noqa: E402
from repro_torch.analysis.hostsync import fetch, guard_host_transfers  # noqa: E402
from repro_torch.kernels import moe_dispatch  # noqa: E402

CLI = [sys.executable, "-m", "repro_torch.launch.lint"]
HLO_NAMES = ("moe_layer/dense", "train_chunk/routed")
REF_PASSES = ("no-collectives", "dtype-flow", "host-sync")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


def _cli(*args, **kw):
    return subprocess.run(CLI + list(args), capture_output=True, text=True, env=_env(),
                          **kw)


# ---------------------------------------------------------------------------
# the reference's verdicts and compiled-HLO all-to-alls (8 CPU devices)
# ---------------------------------------------------------------------------

_REF_CODE = """
import json, sys
from repro.analysis.executables import Artifacts, available_executables, get_executable
from repro.analysis.hlo import collectives_summary
from repro.analysis.lint import _applicable
from repro.analysis.passes import run_pass
cells, hlo = {}, {}
for name in available_executables():
    spec = get_executable(name)
    art = Artifacts(spec)
    row = {}
    for pid in %r:
        if not _applicable(spec, pid):
            continue
        try:
            fs = run_pass(pid, spec, art)
            row[pid] = "FAIL" if any(f.severity == "error" and not f.suppressed
                                     for f in fs) else "ok"
        except Exception as e:
            row[pid] = "CRASH %%s" %% e
    cells[name] = row
    if name in %r:
        a2a = collectives_summary(art.hlo)["all-to-all"]
        hlo[name] = {k: a2a[k] for k in ("count", "bytes", "wire_bytes")}
print(json.dumps({"cells": cells, "hlo": hlo}))
""" % (REF_PASSES, HLO_NAMES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's cells (a subprocess on 8 devices) and the port's
    ``--gate --json-out --device cpu`` run (8 gloo ranks), at once."""
    env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _REF_CODE], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env)
    out = tmp_path_factory.mktemp("lint") / "sub" / "report.json"
    port = _cli("--gate", "--json-out", str(out), "--device", "cpu", timeout=600)
    stdout, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1]), port, json.loads(out.read_text())


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_names_are_the_references():
    from repro.analysis import executables as JX
    mapped = {X.REFERENCE_NAMES.get(n, n) for n in X.available_executables()}
    assert mapped == set(JX.available_executables())
    assert len(X.available_executables()) == 27
    assert set(X.REFERENCE_NAMES.values()) <= set(JX.available_executables())


def test_pass_ids_are_the_references_with_smem_for_vmem():
    from repro.analysis import passes as JP
    assert {"vmem-budget" if p == "smem-budget" else p for p in P.available_passes()} \
        == set(JP.available_passes())
    assert {p: P.get_pass(p).needs for p in P.available_passes()} == {
        "no-collectives": ("wire",), "dtype-flow": ("ops",), "launch-count": ("launches",),
        "smem-budget": ("kernels",), "host-sync": ("scenario",)}


def test_expectations_follow_the_reference():
    """The same passes apply to the same executables as in the reference,
    with its launch budgets; the multi-rank ones run on 8 ranks."""
    from repro.analysis import executables as JX
    for name in X.available_executables():
        spec, ref = X.get_executable(name), JX.get_executable(X.REFERENCE_NAMES.get(name, name))
        got = {"vmem-budget" if p == "smem-budget" else p for p in spec.expect}
        assert got == set(ref.expect), name
        if "launch-count" in spec.expect:
            assert spec.expect["launch-count"] == ref.expect["launch-count"], name
        assert spec.n_ranks == ref.n_devices and (spec.scenario is None) == (ref.scenario is None)


# ---------------------------------------------------------------------------
# dtype-flow: the seeded upcast, against the reference's jaxpr walker
# ---------------------------------------------------------------------------

def _torch_cases():
    rs = np.random.RandomState(0)
    big = torch.from_numpy(rs.randn(128, 128).astype(np.float32)).bfloat16()
    small = big[:32, :32].contiguous()
    w = torch.from_numpy(rs.randn(128, 128).astype(np.float32))
    return {
        "upcast": lambda: big.float() @ w,
        "upcast_einsum": lambda: torch.einsum("ij,jk->ik", big.float(), big.float()),
        "below_threshold": lambda: small.float() @ w[:32, :32],
        "bf16": lambda: big @ big,
    }


def _jax_cases():
    rs = np.random.RandomState(0)
    big = jnp.asarray(rs.randn(128, 128).astype(np.float32)).astype(jnp.bfloat16)
    w = jnp.asarray(rs.randn(128, 128).astype(np.float32))
    small = big[:32, :32]
    return {
        "upcast": lambda: big.astype(jnp.float32) @ w,
        "upcast_einsum": lambda: jnp.einsum("ij,jk->ik", big.astype(jnp.float32),
                                            big.astype(jnp.float32)),
        "below_threshold": lambda: small.astype(jnp.float32) @ w[:32, :32],
        "bf16": lambda: jnp.dot(big, big, preferred_element_type=jnp.float32),
    }


def test_upcast_hits_equal_the_references():
    port, ref = _torch_cases(), _jax_cases()
    want = {"upcast": 1, "upcast_einsum": 1, "below_threshold": 0, "bf16": 0}
    for case, n in want.items():
        _, ops = X.record_ops(port[case])
        got = P.f32_upcast_matmuls(ops)
        assert len(got) == n, (case, got)
        assert len(f32_upcast_dots(jax.make_jaxpr(ref[case])())) == n, case
    hit = P.f32_upcast_matmuls(X.record_ops(port["upcast"])[1])[0]
    assert hit.src_dtypes == ("torch.bfloat16",) and hit.out_shape == (128, 128)
    assert hit.origin.startswith(os.path.basename(__file__)) or __file__ in hit.origin


def _spec(name, build, expect, **kw):
    return X.ExecutableSpec(name=name, build=build, expect=expect, **kw)


def test_dtype_flow_pass_fires_on_the_seeded_upcast():
    for case, n in (("upcast", 1), ("below_threshold", 0), ("bf16", 0)):
        fn = _torch_cases()[case]
        spec = _spec(f"seeded/{case}", lambda device, ctx, fn=fn: (fn, ()),
                     {"dtype-flow": {"min_elems": 4096}})
        fs = P.run_pass("dtype-flow", spec, X.Artifacts(spec, "cpu", needs=("ops",)))
        assert len(fs) == n and all(f.severity == "error" for f in fs), case
        if n:
            assert "bfloat16" in fs[0].message and "test_torch_lint.py" in fs[0].location


# ---------------------------------------------------------------------------
# launch-count: an extra wrapper call; suppression
# ---------------------------------------------------------------------------

def _extra_dispatch(device, ctx):
    fn, args = X._build_cuda_fused("fwd")(device, ctx)

    def seeded(p, x):
        y = fn(p, x)
        xt = x.reshape(-1, x.shape[-1])
        moe_dispatch.dispatch(xt, torch.zeros(4, dtype=torch.int32),
                              torch.ones(4, dtype=torch.bool))    # the extra call
        return y
    return seeded, args


def test_launch_count_pass_fires_on_an_extra_call():
    ok = X.get_executable("cuda_fused/fwd")
    assert P.run_pass("launch-count", ok, X.Artifacts(ok, "cpu")) == []
    spec = _spec("seeded/extra_call", _extra_dispatch, {"launch-count": {"max": 1}})
    fs = P.run_pass("launch-count", spec, X.Artifacts(spec, "cpu"))
    assert len(fs) == 1 and fs[0].severity == "error"
    assert "2 kernel calls > budget 1" in fs[0].message
    assert "dispatch x1" in fs[0].location and "fused_moe x1" in fs[0].location
    # on a card the profiler's launches must equal the calls
    art = type("A", (), {"launches": {"calls": {"fused_moe": 1, "dispatch": 0},
                                      "kernels": {"fused_moe": 2, "dispatch": 0}}})()
    fs = P.run_pass("launch-count", _spec("seeded/two_kernels", None,
                                          {"launch-count": {"max": 1}}), art)
    assert [f.location for f in fs] == ["profiler:fused_moe"]
    assert "1 calls but 2 kernel launches" in fs[0].message


def test_ignore_comment_suppresses_and_passes_the_gate():
    spec = X.register_executable(_spec(
        "seeded/suppressed", _extra_dispatch,
        {"launch-count": {"max": 1}}))  # lint: ignore[launch-count]
    try:
        assert spec.ignore == ("launch-count",)
        fs = LL.run_lint(only=["seeded/suppressed"], device="cpu")
        assert len(fs) == 1 and fs[0].suppressed and fs[0].severity == "error"
        ok, verdict = LL.gate(fs)
        assert ok and "1 suppressed" in verdict
        assert LL.cell_of(fs) == "supp"
    finally:
        X._REGISTRY.pop("seeded/suppressed")


# ---------------------------------------------------------------------------
# smem-budget and host-sync
# ---------------------------------------------------------------------------

def test_smem_budget_pass_fires_over_budget_and_skips_off_a_card():
    spec = X.get_executable("cuda_fused/fwd")
    row = {"kernel": "fused_moe_stream<float, 16, true>", "wrapper": "fused_moe",
           "registers": 96, "smem_bytes": P.SMEM_BUDGET, "spill_bytes": 0}
    fake = lambda rows: type("A", (), {"kernels": rows})()   # noqa: E731
    assert P.run_pass("smem-budget", spec, fake([row])) == []
    over = dict(row, smem_bytes=P.SMEM_BUDGET + 16, spill_bytes=8)
    fs = P.run_pass("smem-budget", spec, fake([row, over]))
    assert len(fs) == 1 and fs[0].severity == "error"
    assert fs[0].location == "kernel:fused_moe_stream<float, 16, true>"
    assert "96 registers" in fs[0].message and "8 B spilled" in fs[0].message
    fs = P.run_pass("smem-budget", spec, X.Artifacts(spec, "cpu", needs=("kernels",)))
    assert [(f.severity, f.message) for f in fs] == [("warning", "skipped: needs a CUDA device")]
    assert LL.gate(fs)[0]


def _tick_scenario(pull):
    def scenario(device):
        t = torch.arange(4.0, device=device)
        events = []
        with guard_host_transfers(events=events):
            if pull:
                t.sum().item()                  # the seeded implicit pull
            fetch({"t": t})
        return {"events": events}
    return scenario


def test_host_sync_pass_fires_on_a_hidden_pull():
    for pull, n in ((True, 1), (False, 0)):
        spec = _spec("seeded/tick", None, {"host-sync": {}}, scenario=_tick_scenario(pull))
        fs = P.run_pass("host-sync", spec, X.Artifacts(spec, "cpu", needs=()))
        assert len(fs) == n
        if n:
            assert "via item" in fs[0].message and "test_torch_lint.py" in fs[0].location


# ---------------------------------------------------------------------------
# no-collectives: an extra all-to-all on 2 gloo ranks
# ---------------------------------------------------------------------------

_RANK_CODE = """
import json, sys
import torch
from repro_torch.analysis import executables as X, lint as LL
from repro_torch.comm.substrate import make_transport
from repro_torch.launch.mesh import close_group, make_group
rank, d = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
ctx = make_group((2, 1), "cpu", init_method="file://%s/rdv" % d, rank=rank,
                 world_size=2, backend="gloo")
cfg = X._moe_cfg("dense")


def seeded(decision, extra):
    def build(device, ctx):
        fn, args = X._build_moe_layer("dense", decision)(device, ctx)
        wire = make_transport(cfg.moe.comm, ctx.comm_env(cfg.moe.comm))

        def run(*a):
            out = fn(*a)
            if extra:      # the seeded exchange: one more all-to-all
                wire.dispatch(torch.zeros(8, 4, 32))
            return out
        return run, args
    return build


out = {}
for extra in (False, True):
    for decision, expect in ((False, X._layer_cost_expect(cfg, tokens_per_shard=16, ep=2)),
                             (True, {"zero": True})):
        name = "seeded/%s/%s" % ("local" if decision else "routed", extra)
        X.register_executable(X.ExecutableSpec(
            name=name, build=seeded(decision, extra),
            expect={"no-collectives": expect}, n_ranks=2))
        cells = LL._spec_cells(name, ["no-collectives"], torch.device("cpu"), ctx=ctx)
        out[name] = [f.as_dict() for f in cells[(name, "no-collectives")]]
close_group()
json.dump(out, open("%s/rank%d.json" % (d, rank), "w"))
"""


def test_no_collectives_pass_fires_on_an_extra_all_to_all(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_CODE, str(r), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_env()) for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["seeded/routed/False"] == [] and got["seeded/local/False"] == []
        # a layer moves (8 experts, capacity 4, d 32) f32 = 4,096 B each way;
        # the seeded exchange 4,096 B more, half of it over the wire
        routed = [f["message"] for f in got["seeded/routed/True"]]
        assert routed == ["all-to-all count 3 != cost model 2",
                          "all-to-all payload 12288 B != cost model 8192 B",
                          "all-to-all wire 6144.0 B != cost model 4096.0 B"], routed
        local = got["seeded/local/True"]
        assert [f["message"] for f in local] == [
            "expected ZERO all-to-alls, found 1 moving 4096 B"]
        assert local[0]["severity"] == "error"


# ---------------------------------------------------------------------------
# the CLI, and parity with the reference
# ---------------------------------------------------------------------------

def test_cli_list_and_no_card():
    r = _cli("--list")
    assert r.returncode == 0
    assert "smem-budget" in r.stdout and "cuda_pipeline/fwd" in r.stdout
    assert "pallas" not in r.stdout
    if not torch.cuda.is_available():
        r = _cli("--gate")
        assert r.returncode == 2 and "no CUDA device" in r.stderr
        assert "LINT GATE" not in r.stdout


def test_cli_table():
    r = _cli("--table", "--device", "cpu", "--only", "flash_decode/step",
             "--only", "decode_pool/local", "--only", "trainer/ticks")
    assert r.returncode == 0, r.stderr
    rows = {ln.split()[0]: ln.split()[1:] for ln in r.stdout.splitlines()[2:]}
    head = r.stdout.splitlines()[0].split()[1:]
    assert head == ["dtype-flow", "launch-count", "no-collectives", "smem-budget"]
    assert rows == {"flash_decode/step": ["ok", "ok", "-", "skip"],
                    "decode_pool/local": ["-", "-", "ok", "-"],
                    "trainer/ticks": ["-", "-", "-", "-"]}


def test_cli_gate_on_the_cpu(runs):
    _, port, report = runs
    assert port.returncode == 0, port.stdout[-3000:] + port.stderr[-3000:]
    assert "LINT GATE: ok — 0 errors (5 warning(s), 0 suppressed)" in port.stdout
    assert report["ok"] and set(report["cells"]) == set(X.available_executables())
    for f in report["findings"]:
        assert (f["pass_id"], f["severity"], f["message"]) == (
            "smem-budget", "warning", "skipped: needs a CUDA device")
    for name, row in report["cells"].items():
        spec = X.get_executable(name)
        assert set(row) == {p for p in P.available_passes() if LL._applicable(spec, p)}
        for pid, cell in row.items():
            assert cell == ("skip" if pid == "smem-budget" else "ok"), (name, pid)
    calls = {n: {k: v for k, v in res["launches"]["calls"].items() if v}
             for n, res in report["resources"].items() if "launches" in res}
    assert calls == {"cuda_fused/fwd": {"fused_moe": 1}, "cuda_fused/vjp": {"fused_moe": 1},
                     "cuda_pipeline/fwd": {"dispatch": 1, "grouped_matmul": 2, "combine": 1},
                     "flash_decode/step": {"flash_decode": 1},
                     "flash_decode/paged": {"flash_decode_paged": 1}}


def test_verdicts_equal_the_references(runs):
    ref, _, report = runs
    for name, row in report["cells"].items():
        want = ref["cells"][X.REFERENCE_NAMES.get(name, name)]
        mine = {p: c for p, c in row.items() if p in REF_PASSES}
        assert mine == want, name
    # 18 no-collectives on the mesh, 4 more, 5 dtype-flow, 3 host-sync ... as
    # the reference applies them: 28 cells
    assert sum(len(r) for r in ref["cells"].values()) == 28


def test_all_to_alls_equal_the_references_hlo(runs):
    ref, _, report = runs
    for name, times in (("moe_layer/dense", 1), ("train_chunk/routed", X.CHUNK_STEPS)):
        hlo = ref["hlo"][name]
        ranks = report["resources"][name]["ranks"]
        assert len(ranks) == 8
        for wire in (r["wire"] for r in ranks):
            assert wire["calls"] == times * hlo["count"] > 0, name
            assert wire["bytes"] == times * hlo["bytes"], name
            assert abs(wire["wire_bytes"] - times * hlo["wire_bytes"]) < 1, name
