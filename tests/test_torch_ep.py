"""The port's expert parallelism (core/moe.py::moe_sharded, the sharded
training step, generation under a group, launch/mesh.py and the train
CLI's --mesh) on a 2-rank gloo group, against the JAX package on the CPU:

  * the MoE layer on every substrate and branch against the reference's
    ``moe_oracle(ep=2)`` (outputs, aux and gradients within 1e-5; the
    transport's counter equals its telemetry and the cost model, and is
    zero on dropped steps);
  * three Gate-Drop steps through the ``Trainer`` (drop bits False,
    False, True for seed 0) against the reference's sharded train step on
    a 2-device CPU mesh from the same init: losses within 2e-5,
    parameters within 2e-4 (the bound of ``test_torch_train.py``), the
    ``comm_*`` records exactly the reference's, nonzero exactly on routed
    steps; on the ``sharded`` (plain) and ``cuda`` (kernel pipeline per
    shard, plain versions on the CPU) backends;
  * greedy generation and ``greedy_bleu`` under the group against the
    reference's ``generate`` / ``greedy_bleu`` on the mesh: tokens and
    BLEU equal;
  * a group of one rank: grouped steps bitwise the ungrouped ones, no
    collective, and ``cuda_fused`` running the pipeline, never B4;
  * gathered checkpoints: the 2-rank Gate-Drop run's checkpoint has the
    reference's keys, shapes and dtypes and its values (the reference's
    sharded run, saved by its own ``save_checkpoint``) within the bounds
    above (moments within 1e-6); a run whose steps are the same function
    at any group size (``torch_ep_worker.ckpt_cfg``) saves at mesh 2 what
    it saves at mesh 1, within the same bounds, and each checkpoint
    restores at mesh 1 and at mesh 2 and steps on to the state an
    unbroken mesh-1 run reaches.

The ranks run as processes of their own (``torch_ep_worker.py``); the
reference's sharded step runs in a subprocess with two simulated devices,
at the same time.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro_torch.comm import COUNTER  # noqa: E402
from repro_torch.configs import TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.configs.base import COMM_SUBSTRATES  # noqa: E402
from repro_torch.core import backend as B  # noqa: E402
from repro_torch.data import MTTaskConfig, MultilingualMT  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.mesh import close_group, make_group  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.training import Trainer  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

import torch_ep_worker as W  # noqa: E402
from torch_ep_jax import check_layer, gather_ranks, jax_layer, layer_inputs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
STEPS = 3
GEN_N, GEN_NEW = 8, 10

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = ([dict(name=s, substrate=s, decision=False) for s in COMM_SUBSTRATES]
         + [dict(name="top2_masked", substrate="compressed", decision=False, top_k=2,
                 masked=True),
            dict(name="local", substrate="dense", decision=True),
            dict(name="expert_drop", substrate="overlapped", decision=True,
                 mode="gate_expert_drop"),
            dict(name="cuda_routed", substrate="dense", decision=False, backend="cuda"),
            dict(name="cuda_local", substrate="compressed", decision=True,
                 backend="cuda"),
            # 4 tokens a rank on 4 experts: capacity 1, where the dispatch
            # wire's (E/ep, ep * cap, d) arrival was a strided view
            dict(name="cuda_capacity_1", substrate="dense", decision=False, backend="cuda",
                 rows=2)])
for _c in CASES:
    _c.setdefault("ep_inner", 0)

# the reference's sharded train step (built as tests/test_sharding.py
# builds it) and its generate on the same 2-device mesh
JAX_REFERENCE = f"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.configs.base import TrainConfig
from repro.core.moe import ParallelContext
from repro.core.gating_dropout import drop_decisions_host
from repro.data import MTTaskConfig, MultilingualMT
from repro.launch.mesh import make_mesh
from repro.launch.train import greedy_bleu
from repro.models import init_model
from repro.parallel.sharding import batch_specs, state_specs, to_shardings
from repro.serve import GenerateConfig, generate
from repro.training import init_train_state, make_train_step
out = sys.argv[1]

def flat(tree):
    return {{"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
             np.asarray(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}}

cfg = reduced(get_config('zcode-m3-base'))
gd = dataclasses.replace(cfg.moe.gating_dropout, mode='gate_drop', rate=0.3)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, jitter_eps=0.0, backend='sharded', gating_dropout=gd))
tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps={STEPS})
mesh = make_mesh((2,), ('data',))
ctx = ParallelContext(mesh=mesh)
state = init_train_state(init_model(jax.random.PRNGKey(0), cfg), tc)
np.savez(out + "/jax_init.npz", **flat(state["params"]))
st_specs = to_shardings(mesh, state_specs(cfg, ctx, jax.eval_shape(lambda: state)))
batches = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=4, max_len=16)).train_batches(4)
b0 = {{k: jnp.asarray(v) for k, v in batches(0).items()}}
b_specs = to_shardings(mesh, batch_specs(cfg, ctx, b0))
state = jax.device_put(state, st_specs)
step = jax.jit(make_train_step(cfg, tc, ctx, jit=False), in_shardings=(st_specs, b_specs),
               static_argnums=(2,), out_shardings=(st_specs, None))
bits = drop_decisions_host(cfg.moe.gating_dropout, 0, 0, {STEPS})
metrics = []
for i in range({STEPS}):
    b = jax.device_put({{k: jnp.asarray(v) for k, v in batches(i).items()}}, b_specs)
    state, m = step(state, b, bool(bits[i]))
    metrics.append({{k: np.asarray(v).tolist() for k, v in jax.device_get(m).items()}})
np.savez(out + "/jax_final.npz", **flat(jax.device_get(state["params"])))
from repro.checkpoint import save_checkpoint
save_checkpoint(out + "/jax_ckpt", {STEPS}, jax.device_get(state), {{"arch": cfg.arch_id}})

gcfg = reduced(get_config('zcode-m3-base'))
gp = jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a, init_model(jax.random.PRNGKey(7), gcfg))
task = MultilingualMT(MTTaskConfig(vocab=gcfg.vocab, n_langs=4, max_len=16))
bleu = greedy_bleu(gp, gcfg, task, n={GEN_N}, max_new={GEN_NEW}, ctx=ctx)
bb = task.sample_batch(10_000, {GEN_N})
res = generate(gp, {{"enc_tokens": jnp.asarray(bb["enc_tokens"]),
                    "tokens": jnp.asarray(bb["tokens"][:, :1])}},
               gcfg, GenerateConfig(max_new={GEN_NEW}), ctx=ctx)
np.save(out + "/jax_tokens.npy", np.asarray(res.tokens))
json.dump({{"metrics": metrics, "bits": [bool(x) for x in bits], "bleu": bleu,
           "steps": int(res.steps)}}, open(out + "/jax.json", "w"))
"""


CLOCK = ("time_s", "tok_s")


def _untimed(history):
    return [{k: v for k, v in rec.items() if k not in CLOCK} for rec in history]


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _gen_params():
    """The reference's seeded init, scaled x3 (as tests/test_torch_serve.py
    does: greedy decoding on it does not collapse onto one token)."""
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    return jcfg, jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a,
                              jax_init_model(jax.random.PRNGKey(7), jcfg))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Starts the reference's subprocess and the ranks together; returns
    (reference layer results, layer inputs, rank results, dir)."""
    d = tmp_path_factory.mktemp("ep2")
    jp, arrays = layer_inputs()
    np.savez(d / "layer.npz", **arrays)
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    np.savez(d / "init.npz", **_flat(jax_init_model(jax.random.PRNGKey(0), jcfg)))
    np.savez(d / "gen_params.npz", **_flat(_gen_params()[1]))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    ref = subprocess.Popen([sys.executable, "-c", JAX_REFERENCE, str(d)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    W.ckpt_trainer(str(d), "ckpt_m1", STEPS).run()       # the mesh-1 checkpoint
    ranks = W.Ranks(WORLD, d, {
        "layer": CASES,
        "train": {"steps": STEPS, "backends": ["sharded", "cuda"], "ckpt": "ckpt_gd",
                  "ckpt_backend": "sharded"},
        "generate": {"backend": "sharded", "n": GEN_N, "max_new": GEN_NEW},
        "ckpt": {"steps": STEPS, "save": "ckpt_m2", "resume": ["ckpt_m1", "ckpt_m2"]}},
        timeout=200)
    try:
        want = {c["name"]: jax_layer(jp, arrays, c, WORLD) for c in CASES}
        results = ranks.join()
        log = ref.communicate(timeout=200)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-6000:]
    return want, arrays, results, d


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_layer_on_two_ranks_matches_oracle(case, run):
    want, arrays, results, _ = run
    moe_cfg = jax_reduced(jax_get_config("zcode-m3-base")).moe
    check_layer(results, want[case["name"]], arrays, case, WORLD, moe_cfg)


def test_two_ranks_dense_hierarchical_overlapped_bitwise(run):
    """At ep = 2 the hierarchical factorization is (1, 2): its intra hop
    has one rank and issues nothing (the 4-rank test exercises both)."""
    _, _, results, _ = run
    want = gather_ranks(results, "dense/y")
    for name in ("hierarchical", "overlapped", "overlapped_hierarchical"):
        np.testing.assert_array_equal(gather_ranks(results, f"{name}/y"), want)
    assert results[0][1]["hierarchical"]["fwd_calls"] == results[0][1]["dense"]["fwd_calls"]
    assert results[0][1]["overlapped"]["fwd_calls"] == 4 * results[0][1]["dense"]["fwd_calls"]


@pytest.mark.parametrize("backend", ["sharded", "cuda"])
def test_training_matches_reference_sharded_step(backend, run):
    _, _, results, d = run
    ref = json.load(open(d / "jax.json"))
    assert ref["bits"] == [False, False, True]
    np.testing.assert_array_equal(
        np.load(d / "jax_init.npz")["decoder/0/p0/moe/experts/w_in"],
        np.load(d / "init.npz")["decoder/0/p0/moe/experts/w_in"])
    hist = [_untimed(rec[f"train/{backend}"]) for _, rec in results]
    assert hist[0] == hist[1]               # every rank records the global values
    for rec, jm in zip(hist[0], ref["metrics"]):
        routed = not jm["gate_dropped"]
        assert rec["gate_dropped"] == jm["gate_dropped"]
        assert rec["lr"] == pytest.approx(jm["lr"], rel=1e-6)
        for k in ("loss", "balance"):
            np.testing.assert_allclose(rec[k], jm[k], atol=2e-5, err_msg=k)
        np.testing.assert_allclose(rec["acc"], jm["acc"], atol=1e-6)
        for k in ("comm_wire_bytes", "comm_a2a_calls", "comm_exposed_bytes",
                  "comm_hidden_bytes"):
            assert rec[k] == jm[k], k
        assert (rec["comm_a2a_calls"] > 0) == routed
    final = np.load(d / "jax_final.npz")
    for key in final.files:
        parts = [out[f"train/{backend}/{key}"] for out, _ in results]
        got = (np.concatenate(parts, axis=parts[0].ndim - 3)
               if "experts" in key.split("/") else parts[0])
        if "experts" not in key.split("/"):      # replicated leaves stay equal
            np.testing.assert_array_equal(parts[0], parts[1], err_msg=key)
        np.testing.assert_allclose(got, final[key], atol=2e-4, err_msg=key)


def test_generate_and_bleu_under_group_match_reference(run):
    _, _, results, d = run
    ref = json.load(open(d / "jax.json"))
    tokens = gather_ranks(results, "gen/tokens")
    np.testing.assert_array_equal(tokens, np.load(d / "jax_tokens.npy"))
    assert results[0][1]["gen_steps"] == results[1][1]["gen_steps"] == ref["steps"]
    assert results[0][1]["bleu"] == results[1][1]["bleu"] == ref["bleu"]
    assert results[0][1]["gen_calls"] > 0             # the decode steps' all-to-alls
    assert len(set(tokens.flatten().tolist())) > 3


# ---------------------------------------------------------------------------
# the train CLI's --mesh, a group of one rank
# ---------------------------------------------------------------------------

def test_train_cli_mesh_under_torchrun(tmp_path):
    """torchrun --standalone --nproc-per-node 2 ... --mesh 2 --eval-every:
    rank 0 prints every step's record with comm_* and BLEU at the eval
    steps and writes --json-out."""
    out = tmp_path / "h.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--device", "cpu",
         "--mesh", "2", "--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
         "--langs", "4", "--gd-mode", "gate_drop", "--gd-rate", "0.3",
         "--eval-every", "2", "--log-every", "1", "--comm", "hierarchical_compressed",
         "--no-prefetch", "--json-out", str(out), "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    recs = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
    assert [rec["step"] for rec in recs] == [0, 1, 2]    # rank 0 alone prints
    assert [("bleu" in rec) for rec in recs] == [True, False, True]
    assert [rec["comm_a2a_calls"] > 0 for rec in recs] == [True, True, False]
    hist = json.load(open(out))
    assert hist["ep"] == 2 and hist["comm"] == "hierarchical_compressed"
    assert _untimed(hist["history"]) == _untimed(recs)
    # the gathered checkpoint: all 4 experts of every expert leaf
    arrays = np.load(tmp_path / "ckpt" / "step_00000003" / "arrays.npz")
    assert arrays["params/decoder/0/p0/moe/experts/w_in"].shape[-3] == 4
    assert arrays["opt/v/encoder/0/p0/moe/experts/w_out"].shape[-3] == 4


def test_train_cli_rejects_what_is_not_ported(tmp_path, monkeypatch):
    """``--mesh 2,2`` is four ranks: under a world of two the group refuses
    it (``test_train_cli_mesh_2x2_under_torchrun`` runs it on four);
    ``--ep-on-model`` cannot decode, so it refuses ``--eval-every`` on a
    model axis; and the CLI still refuses ``--resume`` without a
    directory."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="under a world of 2"):
        cli.main(["--device", "cpu", "--reduced", "--mesh", "2,2"])
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--reduced", "--mesh", "2,2", "--ep-on-model",
                  "--eval-every", "2"])
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--reduced", "--mesh", "2", "--resume"])


@pytest.mark.parametrize("layout", ["tensor_parallel", "ep_on_model"])
def test_train_cli_mesh_2x2_under_torchrun(layout, tmp_path):
    """torchrun --standalone --nproc-per-node 4 ... --mesh 2,2: 3 Gate-Drop
    steps in each layout of the model axis (BLEU at the eval steps under
    tensor parallelism; ``--ep-on-model`` cannot decode); rank 0 alone
    prints, the Gate-Drop step moves nothing on the wire, and the gathered
    checkpoint holds every expert whole."""
    out = tmp_path / "h.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    extra = (["--ep-on-model", "--comm", "hierarchical"] if layout == "ep_on_model"
             else ["--eval-every", "2"])
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", "--device", "cpu",
         "--mesh", "2,2", "--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
         "--langs", "4", "--gd-mode", "gate_drop", "--gd-rate", "0.3", "--log-every", "1",
         "--no-prefetch", "--json-out", str(out), "--ckpt-dir", str(tmp_path / "ckpt"),
         *extra],
        capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    recs = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
    assert [rec["step"] for rec in recs] == [0, 1, 2]    # rank 0 alone prints
    assert [rec["gate_dropped"] for rec in recs] == [0.0, 0.0, 1.0]
    assert [rec["comm_a2a_calls"] for rec in recs] == (
        [8.0, 8.0, 0.0] if layout == "ep_on_model" else [4.0, 4.0, 0.0])
    assert [("bleu" in rec) for rec in recs] == (
        [False] * 3 if layout == "ep_on_model" else [True, False, True])
    hist = json.load(open(out))
    assert (hist["ep"], hist["tp"], hist["ep_on_model"]) == (
        (4, 2, True) if layout == "ep_on_model" else (2, 2, False))
    arrays = np.load(tmp_path / "ckpt" / "step_00000003" / "arrays.npz")
    assert arrays["params/decoder/0/p0/moe/experts/w_in"].shape[-3:] == (4, 256, 256)
    assert arrays["opt/m/encoder/0/p0/moe/experts/w_out"].shape[-3:] == (4, 256, 256)


def _one_rank_cfg(backend, substrate="dense", mode="gate_drop"):
    cfg = reduced(get_config("zcode-m3-base"))
    gd = dataclasses.replace(cfg.moe.gating_dropout, mode=mode, rate=0.3)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, backend=backend, gating_dropout=gd,
        comm=dataclasses.replace(cfg.moe.comm, substrate=substrate)))


def _train(cfg, ctx, steps=STEPS):
    tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=steps)
    batches = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=4,
                                          max_len=16)).train_batches(4)
    params = init_model(torch.Generator().manual_seed(0), cfg)
    trainer = Trainer(cfg, tc, batches, device="cpu", params=params, ctx=ctx,
                      chunk=2, log_every=1, log=None, prefetch=False)
    state, hist = trainer.run()
    return flatten_with_paths(state["params"]), _untimed(hist)


def test_one_rank_group_is_the_ungrouped_step(tmp_path, monkeypatch):
    """The card's ep phase on the CPU: under a one-rank group (router
    jitter on, as configured) the cuda backend's steps are bitwise the
    ungrouped ones, no collective is issued, the comm records read 0, and
    cuda_fused runs the pipeline (B4 is never called)."""
    ctx = make_group((1, 1), "cpu", init_method=f"file://{tmp_path}/rdv", rank=0,
                     world_size=1)
    try:
        assert ctx.active and ctx.ep == 1
        for substrate in ("dense", "hierarchical", "overlapped"):
            want_p, want_h = _train(_one_rank_cfg("cuda", substrate), None)
            COUNTER.reset()
            got_p, got_h = _train(_one_rank_cfg("cuda", substrate), ctx)
            assert COUNTER.total_calls() == 0
            assert got_h == want_h
            assert all(rec["comm_a2a_calls"] == rec["comm_wire_bytes"] == 0 for rec in got_h)
            for k in want_p:
                assert torch.equal(got_p[k], want_p[k]), k

        def no_b4(*a, **k):
            raise AssertionError("B4 launched under a group")
        monkeypatch.setattr(K, "fused_moe_op", no_b4)
        assert B.fused_runs_pipeline(_one_rank_cfg("cuda_fused").moe, ctx)
        fused_p, fused_h = _train(_one_rank_cfg("cuda_fused"), ctx, steps=1)
        cuda_p, cuda_h = _train(_one_rank_cfg("cuda"), ctx, steps=1)
        assert fused_h == cuda_h
        with pytest.raises(AssertionError, match="B4"):
            _train(_one_rank_cfg("cuda_fused"), None, steps=1)
    finally:
        close_group()


# ---------------------------------------------------------------------------
# gathered checkpoints under --mesh 2
# ---------------------------------------------------------------------------

def test_gathered_checkpoint_has_the_reference_layout(run):
    """The 2-rank Gate-Drop run (sharded backend) saved by rank 0 against
    the reference's sharded run saved by its own ``save_checkpoint``."""
    *_, d = run
    got = W.read_checkpoint(d, "ckpt_gd", STEPS)
    want = W.read_checkpoint(d, "jax_ckpt", STEPS)
    assert got[0]["params/decoder/0/p0/moe/experts/w_in"].shape[-3] == 4
    W.assert_same_checkpoint(got, want)


def test_gathered_checkpoint_equals_the_mesh1_checkpoint(run):
    *_, d = run
    W.assert_same_checkpoint(W.read_checkpoint(d, "ckpt_m2", STEPS),
                             W.read_checkpoint(d, "ckpt_m1", STEPS))


@pytest.fixture(scope="module")
def unbroken(run, tmp_path_factory):
    """The parameters of 4 steps of ``ckpt_cfg`` at mesh 1 in one run."""
    init = W.bridge.to_torch(dict(np.load(run[-1] / "init.npz")), "cpu")
    d = tmp_path_factory.mktemp("unbroken")
    state, _ = W.ckpt_trainer(str(d), "ckpt", STEPS + 1, params=init).run()
    return flatten_with_paths(state["params"])


@pytest.mark.parametrize("saved", ["ckpt_m1", "ckpt_m2"])
@pytest.mark.parametrize("restored", [1, 2])
def test_checkpoint_restores_across_meshes(saved, restored, run, unbroken, tmp_path):
    """A checkpoint saved at mesh 1 or mesh 2, restored at mesh 1 or mesh
    2, steps on to the state of an unbroken 4-step mesh-1 run."""
    _, _, results, d = run
    want = unbroken
    if restored == 1:
        trainer = W.ckpt_trainer(str(d), W.resume_copy(str(d), saved, f"{saved}_{tmp_path.name}"),
                                 STEPS + 1)
        assert trainer.restore() == STEPS
        got = {k: v.detach().numpy() for k, v in
               flatten_with_paths(trainer.run()[0]["params"]).items()}
    else:
        assert all(rec[f"ckpt/{saved}/restored_step"] == STEPS for _, rec in results)
        got = {}
        for key in want:
            parts = [out[f"ckpt/{saved}/{key}"] for out, _ in results]
            got[key] = (np.concatenate(parts, axis=parts[0].ndim - 3)
                        if "experts" in key.split("/") else parts[0])
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w.detach().numpy(), atol=2e-4, rtol=0,
                                   err_msg=key)
