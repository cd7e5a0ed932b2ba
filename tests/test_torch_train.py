"""The port's training path (src/repro_torch: gating_dropout, optim,
training, data, checkpoint, launch/train) against the JAX package's, on
the CPU. Both packages get the same numpy inputs and, through
``bridge.py``, the same weights; the port's kernel wrappers take their
plain versions here, and run the same autograd.Function backwards as on
the card. The ``cuda``-marked tests run a training step on the card and
skip without one.

Tolerances (f32 everywhere):
  * Gating Dropout bits, data batches, checkpoints: bitwise.
  * Adam: 1e-6 relative on parameters and moments (the same f32
    formula; XLA may fuse a multiply-add that torch rounds twice).
  * chunked cross-entropy: 1e-5 on the loss and the gradients.
  * three training steps of reduced zcode-m3-base: loss, xent and balance
    within 2e-5, grad_norm within 2e-5 relative, router metrics within
    2e-5, counting metrics exact; parameters within 2e-4 absolute. Adam
    divides each gradient entry by its own running magnitude, so an entry
    whose gradient is at rounding level (1e-7 against 1e-1) moves by up to
    lr per step in a direction that rounding decides; such entries set the
    parameter bound, not the arithmetic.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import GatingDropoutConfig as JaxGD  # noqa: E402
from repro.configs.base import TrainConfig as JaxTC  # noqa: E402
from repro.core import gating_dropout as JG  # noqa: E402
from repro.data import LMTaskConfig as JaxLMC  # noqa: E402
from repro.data import MTTaskConfig as JaxMTC  # noqa: E402
from repro.data import MultilingualMT as JaxMT  # noqa: E402
from repro.data import SyntheticLM as JaxLM  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.optim import adam as JA  # noqa: E402
from repro.training import init_train_state as jax_init_state  # noqa: E402
from repro.training import make_train_step as jax_make_step  # noqa: E402
from repro.training import steps as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import GatingDropoutConfig, TrainConfig  # noqa: E402
from repro_torch.core import gating_dropout as G  # noqa: E402
from repro_torch.data import (LMTaskConfig, MTTaskConfig, MultilingualMT,  # noqa: E402
                              SyntheticLM, stack_batches)
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.optim import adam as A  # noqa: E402
from repro_torch.training import (Trainer, chunked_xent, init_train_state,  # noqa: E402
                                  make_eval_step, make_train_step,
                                  same_decision_runs)
from repro_torch.tree import flatten_with_paths  # noqa: E402

N_STEPS = 3
# the transports' wire counters: zero at one device, as the reference's
COMM_KEYS = {"comm_a2a_calls", "comm_bytes", "comm_wire_bytes",
             "comm_exposed_bytes", "comm_hidden_bytes"}


def jax_flat(tree):
    """The reference's checkpoint keys: '/'-joined tree paths."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# Gating Dropout consensus bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123_456_789])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_drop_bits_match_jax_bitwise(seed, rate):
    """1000 steps of the threefry draw, ported to numpy, against JAX's."""
    gd = GatingDropoutConfig(mode="gate_drop", rate=rate)
    jgd = JaxGD(mode="gate_drop", rate=rate)
    got = G.drop_decisions_host(gd, seed, 0, 1000)
    want = JG.drop_decisions_host(jgd, seed, 0, 1000)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 1000
    for step in (0, 1, 999, 123_456):
        assert G.drop_decision_host(gd, seed, step) == JG.drop_decision_host(jgd, seed, step)
    np.testing.assert_array_equal(G.drop_decisions_host(gd, seed, 500, 510), got[500:510])


def test_drop_bits_off_and_expected_fractions():
    for mode, rate in (("off", 0.3), ("gate_drop", 0.0), ("gate_drop", 0.3),
                       ("gate_expert_drop", 0.2)):
        gd, jgd = GatingDropoutConfig(mode=mode, rate=rate), JaxGD(mode=mode, rate=rate)
        assert gd.enabled == jgd.enabled
        np.testing.assert_array_equal(G.drop_decisions_host(gd, 3, 0, 50),
                                      JG.drop_decisions_host(jgd, 3, 0, 50))
        assert not G.drop_decisions_host(gd, 3, 0, 50, is_training=False).any()
        assert G.expected_alltoall_fraction(gd) == JG.expected_alltoall_fraction(jgd)
        assert G.expected_expert_flop_fraction(gd) == JG.expected_expert_flop_fraction(jgd)
    assert same_decision_runs(GatingDropoutConfig(mode="gate_drop", rate=0.3), 0, 0, 4) == [
        (0, 2, False), (2, 3, True), (3, 4, False)]


# ---------------------------------------------------------------------------
# Adam and the schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["inverse_sqrt", "cosine", "constant"])
def test_schedule_matches(schedule):
    tc = TrainConfig(lr=3e-3, warmup_steps=7, steps=40, schedule=schedule)
    jtc = JaxTC(lr=3e-3, warmup_steps=7, steps=40, schedule=schedule)
    got = [A.schedule(s, tc) for s in range(0, 45)]
    want = [float(JA.schedule(jnp.asarray(s, jnp.int32), jtc)) for s in range(0, 45)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", [
    dict(schedule="inverse_sqrt", grad_clip=1.0, weight_decay=0.0),     # clipping on
    dict(schedule="cosine", grad_clip=100.0, weight_decay=0.01),        # not clipped
    dict(schedule="constant", grad_clip=0.0, weight_decay=0.1,
         moment_dtype="bfloat16"),                                      # bf16 moments
])
def test_adam_update_matches(case):
    kw = dict(lr=1e-2, warmup_steps=2, steps=10, **case)
    tc, jtc = TrainConfig(**kw), JaxTC(**kw)
    rs = np.random.RandomState(11)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 2)}}
    p_np = jax.tree.map(lambda s: rs.randn(*s).astype(np.float32), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p_np)
    jopt, topt = JA.adam_init(jp, jtc), A.adam_init(tp, tc)
    for i in range(3):
        g_np = jax.tree.map(lambda a: (rs.randn(*a.shape) * (3.0 - i)).astype(np.float32),
                            p_np)
        jp, jopt, jm = JA.adam_update(jax.tree.map(jnp.asarray, g_np), jopt, jp, jtc)
        tp, topt, tm = A.adam_update(jax.tree.map(torch.from_numpy, g_np), topt, tp, tc)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        np.testing.assert_allclose(_np(tm["grad_norm"]), jm["grad_norm"], rtol=1e-6)
        assert topt["step"] == int(jopt["step"])
        for tree_t, tree_j in ((tp, jp), (topt["m"], jopt["m"]), (topt["v"], jopt["v"])):
            ft, fj = flatten_with_paths(tree_t), jax_flat(tree_j)
            for key, want in fj.items():
                assert str(ft[key].dtype).replace("torch.", "") == str(want.dtype)
                np.testing.assert_allclose(_np(ft[key]), np.asarray(want, np.float32),
                                           rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,chunk", [(11, 4), (8, 4)])   # chunked + padded; whole
def test_chunked_xent_matches(length, chunk):
    rs = np.random.RandomState(12)
    b, d, v = 2, 8, 13
    h = rs.randn(b, length, d).astype(np.float32)
    head = rs.randn(d, v).astype(np.float32)
    labels = rs.randint(0, v, (b, length))
    mask = (rs.rand(b, length) < 0.8).astype(np.float32)

    def jloss(h_, w_):
        loss, acc = JS.chunked_xent(h_, w_, jnp.asarray(labels), jnp.asarray(mask), chunk=chunk)
        return loss, acc

    (jl, jacc), (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(head).requires_grad_(True)
    tl, tacc = chunked_xent(th, tw, torch.from_numpy(labels), torch.from_numpy(mask),
                            chunk=chunk)
    tl.backward()
    np.testing.assert_allclose(_np(tl), jl, atol=1e-5)
    np.testing.assert_allclose(_np(tacc), jacc, atol=1e-6)
    np.testing.assert_allclose(_np(th.grad), jgh, atol=1e-5)
    np.testing.assert_allclose(_np(tw.grad), jgw, atol=1e-5)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_data_batches_bitwise():
    for n_langs, max_len in ((4, 16), (8, 33)):
        mine = MultilingualMT(MTTaskConfig(vocab=512, n_langs=n_langs, max_len=max_len))
        ref = JaxMT(JaxMTC(vocab=512, n_langs=n_langs, max_len=max_len))
        got, want = mine.train_batches(4), ref.train_batches(4)
        for step in (0, 1, 17):
            a, b = got(step), want(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        a = mine.sample_batch(3, 6, shard=1, n_shards=2)
        b = ref.sample_batch(3, 6, shard=1, n_shards=2)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    lm, jlm = SyntheticLM(LMTaskConfig(vocab=300, seq_len=20)), JaxLM(JaxLMC(vocab=300, seq_len=20))
    for step in (0, 5):
        a, b = lm.sample_batch(step, 3), jlm.sample_batch(step, 3)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    stacked = stack_batches(mine.train_batches(2), 4, 7)
    assert stacked["tokens"].shape[0] == 3
    np.testing.assert_array_equal(stacked["tokens"][1], mine.train_batches(2)(5)["tokens"])


# ---------------------------------------------------------------------------
# three training steps against the reference's per-step make_train_step
# ---------------------------------------------------------------------------

def _train_cfgs(port_backend, jax_backend, mode="gate_drop"):
    jc = jax_reduced(jax_get_config("zcode-m3-base"))
    tc = reduced(get_config("zcode-m3-base"))
    out = []
    for c, b in ((jc, jax_backend), (tc, port_backend)):
        gd = dataclasses.replace(c.moe.gating_dropout, mode=mode, rate=0.3)
        out.append(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, jitter_eps=0.0, backend=b, gating_dropout=gd)))
    return out


def _mt_batches(tcfg):
    return MultilingualMT(MTTaskConfig(vocab=tcfg.vocab, n_langs=4, max_len=16)).train_batches(4)


@pytest.fixture(scope="module")
def jax_runs():
    """The reference's three per-step updates, built once per (backend,
    microbatches) for the module."""
    cache = {}

    def run(jax_backend, microbatches):
        key = (jax_backend, microbatches)
        if key not in cache:
            jc, tcfg = _train_cfgs("oracle", jax_backend)
            jtc = JaxTC(lr=1e-3, warmup_steps=2, seed=0, steps=N_STEPS,
                        microbatches=microbatches)
            jp = jax_init_model(jax.random.PRNGKey(0), jc)
            init = jax_flat(jp)
            step = jax_make_step(jc, jtc)
            state = jax_init_state(jp, jtc)
            batches = _mt_batches(tcfg)
            bits = G.drop_decisions_host(tcfg.moe.gating_dropout, 0, 0, N_STEPS)
            metrics = []
            for i in range(N_STEPS):
                state, m = step(state, {k: jnp.asarray(v) for k, v in batches(i).items()},
                                bool(bits[i]))
                metrics.append(jax.device_get(m))
            cache[key] = (init, metrics, jax_flat(state["params"]), jax_flat(state["opt"]))
        return cache[key]
    return run


@pytest.mark.parametrize("port_backend,jax_backend,microbatches", [
    ("cuda_fused", "pallas_fused", 1),
    ("cuda", "pallas", 1),
    ("cuda_fused", "pallas_fused", 2),
])
def test_train_steps_match_reference(port_backend, jax_backend, microbatches, jax_runs):
    """The port's make_train_step against the reference's per-step
    make_train_step, the same consensus bits (False, False, True for seed
    0: a Gate-Drop step among routed ones), batches and weights."""
    init, jms, jparams, jopt = jax_runs(jax_backend, microbatches)
    _, tcfg = _train_cfgs(port_backend, jax_backend)
    tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=N_STEPS, microbatches=microbatches)
    state = init_train_state(bridge.to_torch(init, "cpu"), tc)
    step = make_train_step(tcfg, tc)
    batches = _mt_batches(tcfg)
    bits = G.drop_decisions_host(tcfg.moe.gating_dropout, 0, 0, N_STEPS)
    assert list(bits) == [False, False, True]
    for i in range(N_STEPS):
        # decision=None: the step draws its own bit, which must be the reference's
        state, tm = step(state, {k: torch.from_numpy(v) for k, v in batches(i).items()})
        jm = jms[i]
        assert set(tm) == set(jm)
        for k in ("dropped_frac", "gate_dropped", "acc", "expert_load", *COMM_KEYS):
            np.testing.assert_array_equal(_np(tm[k]), np.asarray(jm[k], np.float32), err_msg=k)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        for k in ("loss", "xent", "balance", "router_z", "router_entropy"):
            np.testing.assert_allclose(_np(tm[k]), jm[k], atol=2e-5, err_msg=k)
        np.testing.assert_allclose(_np(tm["grad_norm"]), jm["grad_norm"], rtol=2e-5)
    assert state["step"] == N_STEPS
    tparams = flatten_with_paths(state["params"])
    assert sorted(tparams) == sorted(jparams)
    for key, want in jparams.items():
        np.testing.assert_allclose(_np(tparams[key]), want, atol=2e-4, err_msg=key)
    for key, t in flatten_with_paths(state["opt"]["m"]).items():
        np.testing.assert_allclose(_np(t), jopt["m/" + key], atol=1e-6, err_msg=key)


def test_gate_expert_drop_step_skips_the_experts():
    """A dropped Gate-Expert-Drop step: no expert output, so the expert
    weights and the router get a zero gradient, and Adam leaves them."""
    _, tcfg = _train_cfgs("cuda_fused", "pallas_fused", mode="gate_expert_drop")
    tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=1)
    params = init_model(torch.Generator().manual_seed(0), tcfg)
    before = {k: v.clone() for k, v in flatten_with_paths(params).items()}
    state = init_train_state(params, tc)
    state, m = make_train_step(tcfg, tc)(
        state, {k: torch.from_numpy(v) for k, v in _mt_batches(tcfg)(0).items()}, True)
    after = flatten_with_paths(state["params"])
    moe_keys = [k for k in after if "/moe/" in k]
    assert moe_keys
    for k in moe_keys:
        assert torch.equal(after[k], before[k]), k
    assert any(not torch.equal(after[k], before[k]) for k in after if k not in moe_keys)
    assert float(m["gate_dropped"]) == 1.0 and float(m["balance"]) == 0.0


def test_remat_recomputes_the_same_route():
    """With remat each layer's forward runs again in the backward; router
    jitter (on in the paper's config) must draw the same noise there, so
    loss and gradients equal those without remat."""
    tcfg = reduced(get_config("zcode-m3-base"))
    assert tcfg.moe.jitter_eps > 0
    tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=3, steps=1)
    batch = {k: torch.from_numpy(v) for k, v in _mt_batches(tcfg)(0).items()}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, moe=dataclasses.replace(
            tcfg.moe, backend="cuda_fused"))
        state = init_train_state(init_model(torch.Generator().manual_seed(1), cfg), tc)
        state, m = make_train_step(cfg, tc)(state, batch, False)
        out[remat] = (m, flatten_with_paths(state["params"]))
    for k in ("loss", "grad_norm", "balance"):
        torch.testing.assert_close(out[True][0][k], out[False][0][k], atol=1e-6, rtol=1e-6)
    for key, t in out[True][1].items():
        torch.testing.assert_close(t, out[False][1][key], atol=1e-6, rtol=0)


def test_eval_step_matches_reference():
    jc, tcfg = _train_cfgs("cuda", "pallas")
    jp = jax_init_model(jax.random.PRNGKey(2), jc)
    tp = bridge.to_torch(jax_flat(jp), "cpu")
    b = _mt_batches(tcfg)(4)
    want = JS.make_eval_step(jc)(jp, {k: jnp.asarray(v) for k, v in b.items()})
    got = make_eval_step(tcfg)(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "xent", "acc", "balance", "dropped_frac"):
        np.testing.assert_allclose(_np(got[k]), want[k], atol=2e-5, err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints, the Trainer and the CLI
# ---------------------------------------------------------------------------

def test_checkpoint_round_trips_with_the_reference(tmp_path):
    """A JAX train state restores into the port's, and back, bitwise."""
    jc, tcfg = _train_cfgs("oracle", "oracle")
    jtc = JaxTC(moment_dtype="bfloat16")
    tc = TrainConfig(moment_dtype="bfloat16")
    jstate = jax_init_state(jax_init_model(jax.random.PRNGKey(4), jc), jtc)
    rs = np.random.RandomState(0)
    jstate["opt"]["m"] = jax.tree.map(
        lambda a: jnp.asarray(rs.randn(*a.shape), jnp.bfloat16), jstate["opt"]["m"])
    jstate["step"] = jnp.asarray(5, jnp.int32)
    jstate["opt"]["step"] = jnp.asarray(5, jnp.int32)
    jax_save(str(tmp_path / "j"), 5, jstate, {"arch": "zcode-m3-base"})
    template = init_train_state(init_model(torch.Generator().manual_seed(0), tcfg), tc)
    state, meta = restore_checkpoint(str(tmp_path / "j"), template)
    assert meta["step"] == 5 and state["step"] == 5 and state["opt"]["step"] == 5
    want = jax_flat(jstate)
    got = flatten_with_paths(state)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(g, int):
            assert g == int(w)
            continue
        assert g.requires_grad == key.startswith("params/")
        np.testing.assert_array_equal(bridge.tensor_to_numpy(g)[0],
                                      np.asarray(w).view(np.uint16) if w.dtype == jnp.bfloat16
                                      else w)
    save_checkpoint(str(tmp_path / "t"), 5, state)
    back, _ = jax_restore(str(tmp_path / "t"), jstate)
    for key, w in jax_flat(back).items():
        assert w.dtype == want[key].dtype
        np.testing.assert_array_equal(np.asarray(w, np.float32), np.asarray(want[key], np.float32))


def test_trainer_chunks_equal_per_step_calls():
    """The chunked loop (bits from same_decision_runs, metrics fetched once
    per chunk) gives the losses of plain per-step calls; tok/s counts the
    encoder tokens too."""
    _, tcfg = _train_cfgs("cuda_fused", "pallas_fused")
    tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=5)
    batches = _mt_batches(tcfg)
    tr = Trainer(tcfg, tc, batches, device=torch.device("cpu"), chunk=2, log=None,
                 log_every=1)
    _, hist = tr.run()
    assert [r["step"] for r in hist] == list(range(5))
    assert [r["gate_dropped"] for r in hist] == [0.0, 0.0, 1.0, 0.0, 0.0]
    state = init_train_state(init_model(torch.Generator().manual_seed(0), tcfg), tc)
    step = make_train_step(tcfg, tc)
    for i in range(5):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batches(i).items()})
        assert hist[i]["loss"] == float(m["loss"])
    b = batches(0)
    per_step = b["tokens"].size + b["enc_tokens"].size
    last = hist[-1]
    assert last["tok_s"] * last["time_s"] == pytest.approx(5 * per_step, rel=1e-9)


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    """4 uninterrupted steps against 2 steps, a checkpoint and --resume for
    2 more: the resumed run continues at the absolute step and reproduces
    the uninterrupted run's losses."""
    base = ["--arch", "zcode-m3-base", "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--langs", "4", "--task", "mt", "--gd-mode", "gate_drop",
            "--gd-rate", "0.3", "--backend", "cuda_fused", "--log-every", "1",
            "--chunk", "2", "--warmup", "2"]
    cli.main(base + ["--steps", "4", "--json-out", str(tmp_path / "full.json")])
    full = json.loads((tmp_path / "full.json").read_text())
    assert full["device"] == "cpu" and full["backend"] == "cuda_fused"
    assert [r["step"] for r in full["history"]] == [0, 1, 2, 3]
    ck = str(tmp_path / "ck")
    cli.main(base + ["--steps", "2", "--ckpt-dir", ck])
    cli.main(base + ["--steps", "4", "--ckpt-dir", ck, "--resume",
                     "--json-out", str(tmp_path / "resumed.json")])
    assert "@ step 2" in capsys.readouterr().out
    resumed = json.loads((tmp_path / "resumed.json").read_text())["history"]
    assert [r["step"] for r in resumed] == [2, 3]
    for r in resumed:
        assert r["loss"] == full["history"][r["step"]]["loss"]
        assert r["lr"] == full["history"][r["step"]]["lr"]


def test_train_cli_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--reduced", "--steps", "1", "--device", "cuda"])
    with pytest.raises(SystemExit):
        cli.main(["--reduced", "--resume"])          # --resume needs --ckpt-dir
