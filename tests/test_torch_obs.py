"""The port's observability and tooling (src/repro_torch: obs, analysis,
the Trainer's and schedulers' instrumentation, the CLIs' ``--trace-out``,
``--metrics-out`` and ``--profile``) on the CPU.

Against the JAX package's ``repro.obs``, on the same inputs:
  * ``obs.frame``: ``load_imbalance``, ``MetricsFrame.summary`` and
    ``router_health`` equal (numpy on both sides: exact);
  * ``obs.registry``: fed the same observations, ``to_json`` and
    ``to_prometheus`` byte-equal, empty histograms (NaN) included;
  * ``obs.trace``: the exported Chrome trace equal but for its clock
    readings and pid (phases, names, arguments, ``thread_name`` metadata,
    track ids), spans nested by time.
The port alone: the Trainer's span vocabulary and records, the host-sync
guard (steady scheduler ticks and a training chunk pass it in ``raise``
mode with the tracer and the registry live; a seeded ``float(t)`` is
caught at its file:line), the launch-count mapping of the kernels' names,
and the CLIs' outputs. Reduced zcode-m3-base (d 64, 2 layers, d_ff 128,
vocab 97), one torch thread.
"""
import dataclasses
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import frame as jax_frame  # noqa: E402
from repro.obs import registry as jax_registry  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.analysis import hostsync, launches  # noqa: E402
from repro_torch.configs import PagedKVConfig, get_config, reduced  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data import MTTaskConfig, MultilingualMT, stack_batches  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.obs import frame, registry, trace  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, GenerateConfig,  # noqa: E402
                               PagedScheduler, Request)
from repro_torch.serve import scheduler as sched_mod  # noqa: E402
from repro_torch.training import Trainer, same_decision_runs  # noqa: E402

REDUCED = dict(d_model=64, n_layers=2, d_ff=128, vocab=97)
SPANS = {"train_chunk", "chunk.execute", "chunk.fetch", "eval", "prefetch.produce",
         "prefetch.wait"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# frame and registry against the reference
# ---------------------------------------------------------------------------

def _frame_metrics(seed, k=6, e=8):
    rng = np.random.default_rng(seed)
    load = rng.random((k, e)) * rng.integers(0, 2, (k, e))
    load[2] = 0.0                                   # a step that routed nothing
    return {"expert_load": load, "router_entropy": rng.random(k),
            "dropped_frac": rng.random(k) * 0.2,
            "gate_dropped": np.array([0, 1, 0, 1, 0, 0][:k], np.float32),
            **{key: rng.integers(0, 5, k).astype(np.float64)
               for key in frame.FRAME_KEYS if key.startswith("comm_")}}


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_matches_reference(seed):
    ms = _frame_metrics(seed)
    mine, ref = frame.MetricsFrame.from_metrics(ms), jax_frame.MetricsFrame.from_metrics(ms)
    assert frame.FRAME_KEYS == jax_frame.FRAME_KEYS
    assert len(mine) == len(ref) == 6
    np.testing.assert_array_equal(mine.load_imbalance(), ref.load_imbalance())
    np.testing.assert_array_equal(frame.load_imbalance(ms["expert_load"]),
                                  jax_frame.load_imbalance(ms["expert_load"]))
    assert mine.summary() == ref.summary()
    assert frame.MetricsFrame.from_metrics({"expert_load": ms["expert_load"]}) is None
    history = [{"router_entropy": float(ms["router_entropy"][i]),
                "load_imbalance": float(mine.load_imbalance()[i]),
                "gate_dropped": float(ms["gate_dropped"][i])} for i in range(6)]
    history.insert(3, {"loss": 1.0})                 # a record without the frame
    for hist in (history, history[3:4], []):
        np.testing.assert_equal(frame.router_health(hist), jax_frame.router_health(hist))


def _feed(reg, seed):
    rng = np.random.default_rng(seed)
    c = reg.counter("serve/admitted", "requests admitted")
    c.inc()
    c.inc(2.5)
    reg.gauge("serve/wall_s", "seconds").set(rng.random())
    reg.gauge("serve/never_set")                     # NaN
    h = reg.histogram("serve/ttft_s", "arrival -> first token, seconds")
    for v in rng.standard_normal(17):
        h.observe(v)
    reg.histogram("serve/empty")                     # NaN percentiles
    s = reg.series("serve/tick_log", "device calls: label=kind, value=tokens")
    for v, lab in ((64, "prefill"), (9, "decode"), (9, "decode"), (3, None)):
        s.append(v, label=lab)
    reg.series("9 starts-with a digit")
    return reg


@pytest.mark.parametrize("seed", [0, 3])
def test_registry_exports_byte_equal_reference(seed, tmp_path):
    mine = _feed(registry.MetricsRegistry(), seed)
    ref = _feed(jax_registry.MetricsRegistry(), seed)
    assert mine.names() == ref.names()
    assert mine.to_json() == ref.to_json()
    assert mine.to_prometheus() == ref.to_prometheus()
    for fmt in ("to_json", "to_prometheus"):
        getattr(mine, fmt)(str(tmp_path / "a"))
        getattr(ref, fmt)(str(tmp_path / "b"))
        assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    assert mine.histogram("serve/ttft_s").count == 17
    assert mine.series("serve/tick_log").values is mine.series("serve/tick_log").values
    with pytest.raises(TypeError, match="already registered"):
        mine.gauge("serve/ttft_s")
    with pytest.raises(ValueError, match="cannot decrease"):
        mine.counter("serve/admitted").inc(-1)


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def _trace_calls(tr):
    with tr.span("outer", step=1, label="a"):
        tr.instant("tick", rid=3)
        with tr.span("inner", width=np.int64(4)):    # not a JSON type: str
            tr.counter("queue", depth=2, free=5)
    def produce():
        with tr.span("produce", item=str((0, 2))):
            pass

    worker = threading.Thread(name="prefetcher", target=produce)
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    with tr.span("after"):
        pass


def _schema(doc):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur", "pid")}
            for ev in doc["traceEvents"]]


def test_tracer_export_matches_reference(tmp_path):
    mine, ref = trace.Tracer(), jax_trace.Tracer()
    _trace_calls(mine)
    _trace_calls(ref)
    assert len(mine) == len(ref) == 6
    doc = mine.export(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == doc
    assert _schema(doc) == _schema(ref.export())
    names = {ev["args"]["name"] for ev in doc["traceEvents"] if ev["name"] == "thread_name"}
    assert names == {threading.current_thread().name, "prefetcher"}
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert ev["inner"]["args"] == {"width": "4"} and ev["tick"]["s"] == "t"
    outer, inner = ev["outer"], ev["inner"]
    assert outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert ev["produce"]["tid"] != ev["outer"]["tid"]
    assert mine.durations("outer") == [mine.events[3][3]]
    mine.clear()
    assert len(mine) == 0 and _schema(mine.export())[1:] == []


def test_disabled_tracer_records_nothing():
    tr = trace.Tracer(enabled=False)
    assert tr.span("a", x=1) is tr.span("b") is tr.annotation("c") \
        is tr.profile_window("dir") is trace._NULL
    with tr.span("a"):
        tr.instant("b")
        tr.counter("c", v=1)
    assert len(tr) == 0 and trace.get_tracer().enabled is False
    on = trace.Tracer()
    assert on.profile_window(None) is trace._NULL
    prev = trace.get_tracer()
    try:
        assert trace.set_tracer(on) is trace.get_tracer() is on
    finally:
        trace.set_tracer(prev)


def test_profile_window_writes_a_trace_the_launch_counter_reads(tmp_path):
    tr = trace.Tracer()
    with tr.profile_window(str(tmp_path / "prof")) as win, tr.annotation("region"):
        torch.ones(4) + 1
    doc = json.loads(open(win.path).read())
    assert any(ev.get("name") == "region" for ev in doc["traceEvents"])
    assert launches.port_counts(launches.kernel_counts(win.path)) == {
        name: 0 for name in kernels.wrappers()}


# ---------------------------------------------------------------------------
# launch counts: the kernels' names as the profiler reports them
# ---------------------------------------------------------------------------

KERNEL_NAMES = {
    "void (anonymous namespace)::gmm_stream_fwd<float, 8>(float const*, float const*, "
    "float*, int, int, int, int)": ("grouped_matmul", 5),
    "void (anonymous namespace)::grouped_matmul_tiled<__nv_bfloat16, false, false, true>("
    "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int)":
        ("grouped_matmul", 2),
    "void (anonymous namespace)::gmm_stream_dx<__nv_bfloat16, 8>(...)": ("grouped_matmul_dx", 3),
    "void (anonymous namespace)::grouped_matmul_tiled<float, false, true, false>(...)":
        ("grouped_matmul_dx", 1),
    "void (anonymous namespace)::gmm_stream_dw<float, 8>(...)": ("grouped_matmul_dw", 4),
    "void (anonymous namespace)::grouped_matmul_tiled<float, true, false, true>(...)":
        ("grouped_matmul_dw", 1),
    "void (anonymous namespace)::dispatch_words_kernel<uint4, 1>(...)": ("dispatch", 7),
    "void (anonymous namespace)::combine_rows_kernel<float, 4, 1>(...)": ("combine", 7),
    "void (anonymous namespace)::combine_cols_kernel<__nv_bfloat16, 8, 8>(...)": ("combine", 2),
    "void (anonymous namespace)::fused_moe_stream<float, 8, false>(...)": ("fused_moe", 2),
    "void (anonymous namespace)::fused_moe_tiled<__nv_bfloat16, true, true>(...)":
        ("fused_moe", 1),
    "void (anonymous namespace)::flash_decode_kernel<float, __nv_bfloat16, false>"
    "((anonymous namespace)::Args)": ("flash_decode", 6),
    "void (anonymous namespace)::flash_decode_gqa_kernel<float, __nv_bfloat16, true>"
    "((anonymous namespace)::Args)": ("flash_decode_paged", 6),
    "void (anonymous namespace)::flash_decode_mma_kernel<__nv_bfloat16, false>"
    "((anonymous namespace)::Args)": ("flash_decode", 4),
    "void (anonymous namespace)::flash_decode_mma_kernel<float, true>"
    "((anonymous namespace)::Args)": ("flash_decode_paged", 5),
    "void (anonymous namespace)::launch_floor_kernel(int)": (None, 3),
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
    "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)":
        (None, 9),
}


def test_launch_counts_map_kernel_names_to_wrappers():
    assert set(launches.KERNELS) == set(kernels.wrappers())
    events = [{"ph": "X", "cat": "kernel", "name": name}
              for name, (_, n) in KERNEL_NAMES.items() for _ in range(n)]
    events += [{"ph": "X", "cat": "cpu_op", "name": "aten::add"},
               {"ph": "i", "cat": "kernel", "name": "not a launch"}]
    counts = launches.kernel_counts({"traceEvents": events})
    assert counts == {name: n for name, (_, n) in KERNEL_NAMES.items()}
    want = {name: 0 for name in kernels.wrappers()}
    for wrapper, n in KERNEL_NAMES.values():
        if wrapper:
            want[wrapper] += n
    assert launches.port_counts(counts) == want


# ---------------------------------------------------------------------------
# the Trainer's spans and records
# ---------------------------------------------------------------------------

def _train_cfg():
    cfg = reduced(get_config("zcode-m3-base"), **REDUCED)
    gd = dataclasses.replace(cfg.moe.gating_dropout, mode="gate_drop", rate=0.3)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, backend="cuda",
                                                            gating_dropout=gd))


def _trainer(tracer, steps=4, **kw):
    cfg = _train_cfg()
    task = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=4, max_len=8))
    tc = TrainConfig(lr=1e-3, warmup_steps=2, steps=steps, seed=0)
    return Trainer(cfg, tc, task.train_batches(2), device=torch.device("cpu"), chunk=2,
                   log=None, tracer=tracer, **kw)


def test_trainer_spans_and_records():
    tr = trace.Tracer()
    t = _trainer(tr, eval_every=2, eval_fn=lambda state, step: {"bleu": 0.5}, log_every=1)
    _, history = t.run()
    names = {e[1] for e in tr.events}
    assert names == SPANS
    main = threading.get_ident()
    for ph, name, _, _, tid, args in tr.events:
        assert ph == "X" and (tid != main) == (name == "prefetch.produce")
    execute = [e[5] for e in tr.events if e[1] == "chunk.execute"]
    spans = t.schedule()                      # cut at the eval steps 0, 2 and 3
    assert spans == [(0, 1), (1, 3), (3, 4)]
    want = [run for s, e in spans for run in same_decision_runs(t.gd, 0, s, e)]
    assert [(a["start"], a["stop"], a["decision"]) for a in execute] == want
    chunks = [e[5] for e in tr.events if e[1] == "train_chunk"]
    assert [(a["start"], a["stop"]) for a in chunks] == spans
    assert all(a["tokens"] == (a["stop"] - a["start"]) * 2 * (8 + 8) for a in chunks)
    assert [e[5]["step"] for e in tr.events if e[1] == "eval"] == [0, 2, 3]
    assert [r["step"] for r in history] == [0, 1, 2, 3]
    for rec in history:
        assert {"router_entropy", "load_imbalance", "gate_dropped"} <= set(rec)
        assert rec["load_imbalance"] >= 1.0 - 1e-6     # every step routes
    assert [r["gate_dropped"] for r in history] == [
        float(dec) for s, e, dec in same_decision_runs(t.gd, 0, 0, 4) for _ in range(s, e)]


# ---------------------------------------------------------------------------
# the host-sync guard
# ---------------------------------------------------------------------------

def _scheduler(paged):
    cfg = reduced(get_config("zcode-m3-base"), **REDUCED)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, backend="cuda"))
    params = init_model(torch.Generator().manual_seed(0), cfg)
    gen = GenerateConfig(max_new=24, eos_id=-1, flash_decode=True)
    kw = dict(n_slots=4, prefill_buckets=(8,), registry=registry.MetricsRegistry(),
              tracer=trace.Tracer())
    if paged:
        sched = PagedScheduler(params, cfg, gen, paged=PagedKVConfig(
            page_size=8, n_slots_equiv=8), **kw)
    else:
        sched = ContinuousScheduler(params, cfg, gen, **kw)
    rs = np.random.RandomState(0)
    for rid in range(3):
        sched.submit(Request(rid=rid, tokens=np.arange(3 + rid) + 3,
                             extras={"enc_tokens": rs.randint(3, 96, 32)}))
    sched.step(0.0)                           # admission and the first tick
    sched.step(0.0)
    return sched


@pytest.mark.parametrize("paged", [False, True])
def test_steady_ticks_pass_the_guard(paged):
    sched = _scheduler(paged)
    events = []
    with hostsync.guard_host_transfers(mode="raise", events=events):
        for _ in range(3):
            sched.step(0.0)
    fetches, bad = hostsync.syncs(events)
    assert fetches == 3 and bad == []
    assert len(sched.tracer.durations("sched.decode")) == 5
    assert "item" not in vars(torch.Tensor) and np.asarray.__module__ == "numpy"


def test_training_chunk_passes_the_guard():
    t = _trainer(trace.Tracer(), prefetch=False)
    t.run()
    events = []
    with hostsync.guard_host_transfers(mode="raise", events=events):
        ms = t._run_chunk((4, 6), stack_batches(t.batch_fn, 4, 6))
    assert hostsync.syncs(events) == (1, [])
    assert ms["loss"].shape == (2,) and ms["expert_load"].shape == (2, t.cfg.moe.n_experts)
    fetch_span = t.tracer.events[-1]
    assert fetch_span[1] == "chunk.fetch" and fetch_span[5] == {"start": 4, "stop": 6}


def test_guard_catches_a_seeded_pull(monkeypatch):
    sched = _scheduler(False)
    select = sched_mod._select_rows
    lines = []

    def seeded(gen, logits, *a):
        lines.append(sys._getframe().f_lineno + 1)
        float(logits[0, 0])                   # the seeded implicit pull
        return select(gen, logits, *a)

    monkeypatch.setattr(sched_mod, "_select_rows", seeded)
    events = []
    with hostsync.guard_host_transfers(events=events):
        sched.step(0.0)
    fetches, bad = hostsync.syncs(events)
    assert fetches == 1 and [e.method for e in bad] == ["__float__"]
    assert bad[0].origin.startswith(f"{__file__}:{lines[0]} ")
    with pytest.raises(RuntimeError, match=f"__float__ at .*test_torch_obs.py:{lines[0]} "):
        with hostsync.guard_host_transfers(mode="raise"):
            sched.step(0.0)
    assert "__float__" not in vars(torch.Tensor)


def test_fetch_and_the_pulls_it_sanctions():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    events = []
    with hostsync.guard_host_transfers(events=events):
        out = hostsync.fetch({"a": t, "b": [t.bfloat16(), 3], "c": (t[0],)})
        np.asarray(t)
    assert isinstance(out["a"], np.ndarray) and out["b"][1] == 3
    assert out["b"][0].dtype == torch.bfloat16 and isinstance(out["c"], tuple)
    fetches, bad = hostsync.syncs(events)
    assert fetches == 1 and [e.method for e in bad] == ["np.asarray", "__array__"]
    assert [e.method for e in events if e.internal] == ["numpy"]   # __array__'s own
    assert all(e.sanctioned for e in events[:3])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _load_trace(path):
    doc = json.loads(path.read_text())
    return [ev for ev in doc["traceEvents"] if ev["ph"] != "M"]


@pytest.mark.parametrize("fmt,frame_on", [("prom", True), ("json", False)])
def test_train_cli_trace_and_metrics(tmp_path, fmt, frame_on, capsys):
    out, met = tmp_path / "trace.json", tmp_path / f"metrics.{fmt}"
    argv = ["--arch", "zcode-m3-base", "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "8", "--langs", "4", "--task", "mt", "--gd-mode",
            "gate_drop", "--gd-rate", "0.3", "--chunk", "2", "--log-every", "1",
            "--trace-out", str(out), "--metrics-out", str(met)]
    if frame_on:
        argv += ["--profile", str(tmp_path / "prof")]
    else:
        argv += ["--no-metrics-frame"]
    prev = trace.get_tracer()
    try:
        train_cli.main(argv)
    finally:
        trace.set_tracer(prev)
    names = {ev["name"] for ev in _load_trace(out)}
    assert names == SPANS - {"eval"}
    if fmt == "prom":
        text = met.read_text()
        assert "train_loss_count 3" in text and "train_router_load_imbalance" in text
        assert len(list((tmp_path / "prof").glob("profile_*.json"))) == 1
    else:
        snap = json.loads(met.read_text())
        assert snap["train/loss"]["count"] == 3 and "train/final_loss" in snap
        assert not any(k.startswith("train/router/") for k in snap)
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert "load_imbalance" not in rec and "router_entropy" not in rec


def test_serve_cli_trace_and_metrics(tmp_path):
    prev = trace.get_tracer()
    try:
        serve_cli.main(["--arch", "zcode-m3-base", "--reduced", "--device", "cpu",
                        "--trace", "6", "--paged", "--eos", "-1", "--max-new", "6",
                        "--trace-out", str(tmp_path / "t.json"),
                        "--metrics-out", str(tmp_path / "m.json")])
        serve_cli.main(["--arch", "zcode-m3-base", "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "4", "--max-new", "3", "--eos", "-1",
                        "--trace-out", str(tmp_path / "o.json"),
                        "--metrics-out", str(tmp_path / "o.prom")])
    finally:
        trace.set_tracer(prev)
    evs = _load_trace(tmp_path / "t.json")
    snap = json.loads((tmp_path / "m.json").read_text())
    count = {name: sum(ev["name"] == name for ev in evs)
             for name in ("sched.decode", "prefix_cache.miss", "prefix_cache.hit")}
    assert count["sched.decode"] == snap["serve/stats/decode_steps"]["value"] > 0
    assert count["prefix_cache.miss"] + count["prefix_cache.hit"] == \
        snap["serve/stats/prefix_lookups"]["value"] == 6
    assert snap["serve/ttft_s"]["count"] == 6 and snap["serve/tok_s"]["value"] > 0
    assert [ev["name"] for ev in _load_trace(tmp_path / "o.json")] == [
        "generate.first", "generate.steady"]
    text = (tmp_path / "o.prom").read_text()
    assert all(f"# TYPE serve_{k} gauge" in text for k in ("first_s", "wall_s", "tok_s"))
