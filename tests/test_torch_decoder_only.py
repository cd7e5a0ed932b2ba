"""The decoder-only family with full attention (yi-6b, codeqwen1.5-7b,
dbrx-132b) in the port against the JAX package, on the CPU, at the
reference's ``reduced()`` size (2 layers, d 256, d_ff 512, vocab 512;
dbrx 4 experts of 256). ``reduced`` alone keeps 4 kv heads of 4 (rep 1),
so both packages get the same override forcing GQA: yi 1 kv head (rep 4),
codeqwen and dbrx 2 (rep 2). dbrx runs at its reduced top-2 and, by
override, at top-4 (every expert).

  * layer plans of the full and reduced configs, ``n_params`` and
    ``n_active_params``: equal;
  * the init layout: the reference's keys and shapes;
  * ``model_apply``, prefill and decode (plain, flash, per-row) on
    bridged weights: f32 logits within 2e-4 (``test_torch_models.py``'s
    bound); the port's kernel backends (plain versions here) against the
    reference's oracle, and dbrx's ``cuda``/``cuda_fused`` also against
    its ``pallas``/``pallas_fused``;
  * the slot-pool and paged schedulers (B6 on and off) give every request
    the tokens of a one-shot B=1 ``generate``, and a decoder-only request's
    prefix key is its prompt alone;
  * 3 ``--task lm`` steps of Gate-Drop 0.3 (drop bits False, False, True
    for seed 0) against the reference's per-step update: loss within 2e-5,
    parameters within 2e-4 (``test_torch_train.py``'s bounds). As that
    file notes, Adam divides each gradient entry by its own magnitude, so
    an entry whose gradient is at rounding level moves by up to lr per
    step as rounding decides. On this task the embedding has one such
    entry: its summed gradient cancels to ~1e-9 against a leaf maximum of
    ~2.6e-3, and the reference's f32 steps leave it 3.2e-4 from the
    port's. The reference's own steps in f64 land it within 1e-5 of the
    port's f32 value, so the reference's f32 rounding parted them. The
    test holds one entry at most to that: both packages' first moments
    there below 1e-6 of their leaf's largest, and the port within 2e-4 of
    the reference's f64 steps;
  * the serve and train CLIs on the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import TrainConfig as JaxTC  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.models import model_apply as jax_model_apply  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import init_train_state as jax_init_state  # noqa: E402
from repro.training import make_train_step as jax_make_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (ARCHS, PagedKVConfig, TrainConfig,  # noqa: E402
                                 get_config, reduced)
from repro_torch.core import gating_dropout as G  # noqa: E402
from repro_torch.data import LMTaskConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import (decode_step, init_model, model_apply,  # noqa: E402
                                prefill)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, GenerateConfig,  # noqa: E402
                               PagedScheduler, Request, generate)
from repro_torch.training import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 2e-4
DECODER_ONLY = ("yi-6b", "codeqwen1.5-7b", "dbrx-132b")
# model: (arch, reduced() overrides forcing GQA, MoE overrides)
MODELS = {
    "yi": ("yi-6b", dict(n_kv_heads=1), {}),
    "codeqwen": ("codeqwen1.5-7b", dict(n_kv_heads=2), {}),
    "dbrx": ("dbrx-132b", dict(n_kv_heads=2), {}),
    "dbrx_top4": ("dbrx-132b", dict(n_kv_heads=1), dict(top_k=4)),
}


def jax_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfgs(model, port_backend="oracle", jax_backend="oracle", **moe_kw):
    arch, red, moe = MODELS[model]
    jc, tc = jax_reduced(jax_get_config(arch), **red), reduced(get_config(arch), **red)
    if tc.moe is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, backend=jax_backend, jitter_eps=0.0, **moe, **moe_kw))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, backend=port_backend, jitter_eps=0.0, **moe, **moe_kw))
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    """The reference's seeded init per model, and its bridge to torch."""
    cache = {}

    def get(model):
        if model not in cache:
            jc, _ = _cfgs(model)
            jp = jax_init_model(jax.random.PRNGKey(0), jc)
            cache[model] = (jp, bridge.to_torch(jax_flat(jp), "cpu"))
        return cache[model]
    return get


def _tokens(cfg, b, l, seed=1):
    toks = np.random.RandomState(seed).randint(3, cfg.vocab, (b, l))
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# configs, plans, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_configs_plans_and_counts_match(arch):
    jfull, tfull = jax_get_config(arch), get_config(arch)
    for f in dataclasses.fields(tfull):
        if f.name != "moe":
            assert getattr(tfull, f.name) == getattr(jfull, f.name), f.name
    if tfull.moe is not None:
        for f in dataclasses.fields(tfull.moe):
            if f.name not in ("backend", "comm", "gating_dropout"):
                assert getattr(tfull.moe, f.name) == getattr(jfull.moe, f.name), f.name
        assert tfull.moe.gating_dropout.mode == jfull.moe.gating_dropout.mode == "gate_drop"
        assert tfull.moe.gating_dropout.rate == jfull.moe.gating_dropout.rate == 0.3
    # the layout fields the dry run's sharding rules read: fsdp on dbrx-132b
    assert (tfull.fsdp, tfull.seq_parallel) == (jfull.fsdp, jfull.seq_parallel) == \
        (arch == "dbrx-132b", False)
    for red in ({}, dict(n_kv_heads=1), dict(n_kv_heads=2)):
        for jc, tc in ((jfull, tfull), (jax_reduced(jfull, **red), reduced(tfull, **red))):
            js, ts = JT.layer_plan(jc), T.layer_plan(tc)
            assert all(p.mixer == "gqa" and p.window == 0 for s in js for p in s.pattern)
            assert [(s.repeats, [(p.cross, p.moe, p.causal) for p in s.pattern]) for s in ts] \
                == [(s.repeats, [(p.cross, p.moe, p.causal) for p in s.pattern]) for s in js]
            assert tc.n_params() == jc.n_params()
            assert tc.n_active_params() == jc.n_active_params()
            assert tc.n_kv_heads == jc.n_kv_heads and tc.head_dim_ == jc.head_dim_
    assert arch in ARCHS


def test_unported_layers_raise_naming_their_roadmap_item():
    cfg = reduced(get_config("yi-6b"))
    # the VLM is ported: a gated cross-only layer (no mixer) wherever
    # i % cross_attn_period == 0, the self-attention plan elsewhere
    vlm = get_config("llama-3.2-vision-90b")
    flat = [p for s in T.layer_plan(vlm) for _ in range(s.repeats) for p in s.pattern]
    period = vlm.vlm.cross_attn_period
    assert [(p.mixer, p.gated_cross, p.cross) for p in flat] == [
        ("none", True, True) if i % period == 0 else ("gqa", False, False)
        for i in range(vlm.n_layers)]
    # sliding windows are ported: the plan carries the window
    assert {p.window for s in T.layer_plan(dataclasses.replace(cfg, sliding_window=64))
            for p in s.pattern} == {64}
    # the SSM and the hybrid are ported: their mixers, and the hybrid's
    # window everywhere but at its global-attention layers
    ssm = reduced(get_config("mamba2-1.3b"))
    assert [(p.mixer, p.window) for s in T.layer_plan(ssm) for p in s.pattern
            for _ in range(s.repeats)] == [("ssm", 0)] * ssm.n_layers
    hymba = get_config("hymba-1.5b")
    flat = [(p.mixer, p.window) for s in T.layer_plan(hymba) for p in s.pattern
            for _ in range(s.repeats)]
    assert flat == [("hybrid", 0 if i in (0, 15, 31) else 1024) for i in range(32)]


@pytest.mark.parametrize("model", ["yi", "dbrx"])
def test_init_model_matches_reference_layout(model, weights):
    jp, _ = weights(model)
    _, tc = _cfgs(model)
    jflat = jax_flat(jp)
    tflat = flatten_with_paths(init_model(torch.Generator().manual_seed(0), tc))
    assert sorted(tflat) == sorted(jflat)
    assert not any(k.startswith("encoder") or "cross" in k for k in tflat)
    for key, want in jflat.items():
        assert tuple(tflat[key].shape) == want.shape, key
        assert tflat[key].dtype == torch.float32
        if want.size > 1000:    # same distribution, different bits
            assert abs(float(tflat[key].std()) - float(want.std())) \
                < 0.1 * float(want.std()) + 1e-6, key


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,backend,against", [
    ("yi", "oracle", "oracle"), ("yi", "cuda", "oracle"),
    ("codeqwen", "oracle", "oracle"), ("codeqwen", "cuda", "oracle"),
    ("dbrx", "oracle", "oracle"), ("dbrx", "cuda", "oracle"), ("dbrx", "cuda", "pallas"),
    ("dbrx_top4", "cuda", "oracle"), ("dbrx_top4", "cuda_fused", "pallas_fused"),
])
def test_model_apply_matches(model, backend, against, weights):
    jc, tc = _cfgs(model, backend, against)
    jp, tp = weights(model)
    jb, tb = _tokens(tc, 2, 9)
    want, jaux = jax_model_apply(jp, jb, jc, is_training=False)
    got, taux = model_apply(tp, tb, tc, is_training=False)
    _close(got, want)
    if tc.moe is not None:
        for key in ("balance", "router_z", "load", "dropped_frac"):
            _close(taux[key], jaux[key], atol=1e-4)


P_LEN, N_DECODE = 5, 3


@pytest.fixture(scope="module")
def jax_prefilled(weights):
    """The reference's oracle prefill of ``P_LEN`` tokens per model,
    shared by the decode modes."""
    cache = {}

    def get(model):
        if model not in cache:
            jc, tc = _cfgs(model)
            jb, _ = _tokens(tc, 2, 8, seed=2)
            cache[model] = jax_prefill(weights(model)[0], {"tokens": jb["tokens"][:, :P_LEN]},
                                       jc, max_seq=P_LEN + N_DECODE)
        return cache[model]
    return get


@pytest.mark.parametrize("flash,per_row", [(False, False), (True, True), (False, True)])
@pytest.mark.parametrize("model", list(MODELS))
def test_prefill_and_decode_match(model, flash, per_row, weights, jax_prefilled):
    """Prefill 5 tokens, decode 3 (the port's kernel backend and, with
    ``flash``, B5's plain version) against the reference's oracle
    prefill and decode with its flash-decode kernel in the same mode."""
    jc, tc = _cfgs(model, "cuda" if flash else "oracle")
    jp, tp = weights(model)
    jb, tb = _tokens(tc, 2, 8, seed=2)
    P, steps = P_LEN, N_DECODE
    jl, jcache = jax_prefilled(model)
    tl, tcache = prefill(tp, {"tokens": tb["tokens"][:, :P]}, tc, max_seq=P + steps)
    _close(tl, jl)
    assert all("cross" not in k for k in flatten_with_paths(tcache))
    for i in range(steps):
        pos = P + i
        jidx = jnp.full((2,), pos, jnp.int32) if per_row else pos
        tidx = torch.full((2,), pos) if per_row else pos
        jl, jcache = jax_decode_step(jp, jcache, jb["tokens"][:, pos:pos + 1], jidx, jc,
                                     flash_decode=flash)
        tl, tcache = decode_step(tp, tcache, tb["tokens"][:, pos:pos + 1], tidx, tc,
                                 flash_decode=flash)
        _close(tl, jl)


# ---------------------------------------------------------------------------
# serving: schedulers against one-shot generate, the CLI
# ---------------------------------------------------------------------------

SCHED = dict(n_slots=3, prefill_buckets=(8, 16), max_seq=40)


def _requests(cfg, n=6, lens=(4, 7, 11, 14), budgets=(3, 6, 9)):
    rng = np.random.default_rng(1)
    return [(i, rng.integers(3, cfg.vocab, size=lens[i % len(lens)]).astype(np.int32),
             budgets[i % len(budgets)]) for i in range(n)]


@pytest.mark.parametrize("model", ["yi", "dbrx_top4"])
def test_schedulers_equal_oneshot_generate(model, weights):
    """Greedy tokens of every request through the slot pool and the page
    arena (B6 on and off) equal a one-shot B=1 ``generate`` at the pool's
    cache length; non-binding eval capacity (= n_experts), so that rows
    batched together route as they do alone."""
    _, tc = _cfgs(model, "cuda", eval_capacity_factor=4.0)
    _, tp = weights(model)
    spec = _requests(tc)
    reqs = lambda: [Request(rid=i, tokens=t, max_new=m, arrival=0.0)  # noqa: E731
                    for i, t, m in spec]
    gen = GenerateConfig(max_new=9, eos_id=-1)
    runs = {"slot": ContinuousScheduler(tp, tc, gen, **SCHED).run(reqs())}
    for flash in (False, True):
        sched = PagedScheduler(tp, tc, dataclasses.replace(gen, flash_decode=flash),
                               paged=PagedKVConfig(page_size=8, n_slots_equiv=4), **SCHED)
        runs[f"paged flash={flash}"] = sched.run(reqs())
        assert sched.stats["admitted"] == sched.stats["finished"] == len(spec)
    for i, toks, budget in spec:
        g = GenerateConfig(max_new=budget, eos_id=-1, max_seq=SCHED["max_seq"],
                           flash_decode=True)
        want = generate(tp, {"tokens": torch.from_numpy(toks[None]).long()}, tc, g).tokens[0]
        for name, res in runs.items():
            got = {r.rid: r.tokens for r in res}[i]
            np.testing.assert_array_equal(np.asarray(got), want.numpy(), err_msg=f"{name} {i}")
    assert len({int(t) for r in runs["slot"] for t in r.tokens}) > 3


def test_decoder_only_prefix_key_is_the_prompt_alone(weights):
    """No conditioning inputs: ``_cond_key`` is ``()``, and two requests
    with one prompt share their full prefix pages."""
    _, tc = _cfgs("yi")
    _, tp = weights("yi")
    req = Request(rid=0, tokens=np.arange(3, 19, dtype=np.int32), max_new=2)
    assert PagedScheduler._cond_key(req) == ()
    sched = PagedScheduler(tp, tc, GenerateConfig(max_new=2, eos_id=-1),
                           paged=PagedKVConfig(page_size=8, n_slots_equiv=4), **SCHED)
    res = sched.run([dataclasses.replace(req, rid=i, arrival=float(i)) for i in range(2)])
    assert sched.stats["prefix_hits"] > 0
    np.testing.assert_array_equal(res[0].tokens, res[1].tokens)


def test_serve_cli_decoder_only_on_cpu(tmp_path, capsys):
    out = tmp_path / "s.json"
    serve_cli.main(["--arch", "dbrx-132b", "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "5", "--max-new", "3", "--eos", "-1", "--backend",
                    "cuda_fused", "--flash-decode", "--json-out", str(out)])
    rec = json.load(open(out))
    assert rec["arch"] == "dbrx-132b" and len(rec["tokens"]) == 2
    assert len(rec["tokens"][0]) == 3
    serve_cli.main(["--arch", "yi-6b", "--reduced", "--layers", "1", "--device", "cpu",
                    "--trace", "4", "--paged", "--slots", "2", "--buckets", "8",
                    "--max-new", "3", "--eos", "-1", "--json-out", str(out)])
    rec = json.load(open(out))
    assert rec["scheduler"]["admitted"] == rec["scheduler"]["finished"] == 4
    assert "comm" not in rec            # a dense arch has no expert dispatch
    assert "n_layers=1" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# --task lm training
# ---------------------------------------------------------------------------

N_STEPS = 3


def _lm_batches(cfg):
    task = SyntheticLM(LMTaskConfig(vocab=cfg.vocab, seq_len=16))
    return lambda step: task.sample_batch(step, 4)


@pytest.fixture(scope="module")
def jax_lm_steps(weights):
    """The reference's three Gate-Drop steps of reduced dbrx (top-2) on
    the LM task, per-step ``make_train_step`` with its oracle backend;
    also the parameters after the same steps in f64 (``jax.enable_x64``)."""
    jc, tc = _cfgs("dbrx")
    jp, _ = weights("dbrx")
    jtc = JaxTC(lr=1e-3, warmup_steps=2, seed=0, steps=N_STEPS)
    batches = _lm_batches(tc)
    bits = G.drop_decisions_host(tc.moe.gating_dropout, 0, 0, N_STEPS)

    def run(params):
        step = jax_make_step(jc, jtc)
        state = jax_init_state(params, jtc)
        metrics = []
        for i in range(N_STEPS):
            state, m = step(state, {k: jnp.asarray(v) for k, v in batches(i).items()},
                            bool(bits[i]))
            metrics.append(jax.device_get(m))
        return metrics, state

    metrics, state = run(jax.tree_util.tree_map(jnp.array, jp))   # the step donates
    with jax.enable_x64(True):
        _, state64 = run(jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), jp))
        params64 = jax_flat(state64["params"])
    return metrics, jax_flat(state["params"]), jax_flat(state["opt"]), params64


@pytest.mark.parametrize("backend", ["cuda", "cuda_fused"])
def test_lm_train_steps_match_reference(backend, jax_lm_steps, weights):
    jms, jparams, jopt, jparams64 = jax_lm_steps
    _, tc = _cfgs("dbrx", backend)
    _, tp = weights("dbrx")
    ttc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=N_STEPS)
    state = init_train_state(bridge.to_torch(bridge.to_numpy(tp)[0], "cpu"), ttc)
    step = make_train_step(tc, ttc)
    batches = _lm_batches(tc)
    assert "enc_tokens" not in batches(0)
    for i in range(N_STEPS):
        state, tm = step(state, {k: torch.from_numpy(v) for k, v in batches(i).items()})
        jm = jms[i]
        assert float(tm["gate_dropped"]) == float(jm["gate_dropped"]) == float(i == 2)
        for k in ("loss", "xent", "balance", "router_z"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=2e-5, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-5)
    tparams = flatten_with_paths(state["params"])
    topt = flatten_with_paths(state["opt"])
    assert sorted(tparams) == sorted(jparams)
    n_apart = 0
    for key, want in jparams.items():
        got = tparams[key].detach().numpy()
        mr, mt = np.abs(jopt["m/" + key]), np.abs(topt["m/" + key].detach().numpy())
        # both packages put this entry's gradient at rounding level
        rounding = (mr < 1e-6 * mr.max()) & (mt < 1e-6 * mt.max())
        apart = rounding & (np.abs(got - want) > 2e-4)
        n_apart += int(apart.sum())
        np.testing.assert_allclose(got[~apart], want[~apart], atol=2e-4, err_msg=key)
        np.testing.assert_allclose(got[apart], jparams64[key][apart], atol=2e-4, err_msg=key)
    assert n_apart <= 1, n_apart


def test_train_cli_task_lm_on_cpu(tmp_path, capsys):
    out = tmp_path / "h.json"
    train_cli.main(["--arch", "dbrx-132b", "--reduced", "--device", "cpu", "--task", "lm",
                    "--steps", "3", "--batch", "2", "--seq", "8", "--gd-mode", "gate_drop",
                    "--gd-rate", "0.3", "--backend", "cuda_fused", "--log-every", "1",
                    "--eval-every", "2", "--no-prefetch", "--json-out", str(out)])
    hist = json.load(open(out))["history"]
    assert [r["step"] for r in hist] == [0, 1, 2]
    assert [r["gate_dropped"] for r in hist] == [0.0, 0.0, 1.0]
    assert all("bleu" not in r for r in hist)         # BLEU is the MT task's
    assert all(np.isfinite(r["loss"]) for r in hist)
    train_cli.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                    "--task", "lm", "--steps", "1", "--batch", "2", "--seq", "8",
                    "--no-prefetch", "--json-out", str(out)])
    assert json.load(open(out))["backend"] is None        # dense: no MoE layer
    with pytest.raises(ValueError, match="--task mt"):
        train_cli.main(["--arch", "zcode-m3-base", "--reduced", "--device", "cpu",
                        "--task", "lm", "--steps", "1"])
