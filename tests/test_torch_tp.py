"""The port's model axis (``--mesh d,m``: tensor parallelism inside the
experts and ``MoEConfig.ep_on_model``) on gloo groups of 4 ranks (2, 2)
and 2 ranks (1, 2), against the JAX package's ``moe_sharded``, sharded
train step and ``generate`` on a simulated (data, model) CPU mesh:

  * the MoE layer at (1, 2) and (2, 2), in both layouts, routed and
    Gate-Drop local, on the dense and hierarchical wires: output, aux and
    the gradients of sum(y * g) w.r.t. x, the router and the experts
    (gathered over both axes) within 1e-5 (``torch_ep_jax.TOL``), and the
    gradients of the balance term alone (each shard's 1/ep share of the
    group mean);
    what is replicated over a model group (y, the x and router gradients)
    bitwise equal on its ranks; each rank's collective counter equals its
    telemetry and the cost model, with the model and data groups as the
    tiers under ``ep_on_model``, and is zero on the Gate-Drop steps;
  * router jitter on: the model ranks of a data group route alike under
    tensor parallelism (their all-reduce would otherwise sum FFNs of
    different routings);
  * ``ep_on_model`` at one position (every decode step) raises the port's
    ValueError; the reference fails there too (ROADMAP C);
  * three Gate-Drop steps (drop bits False, False, True) of reduced
    zcode-m3-base through the Trainer at (2, 2) tensor-parallel and (1, 2)
    ``ep_on_model``, on ``sharded`` and ``cuda``: losses within 2e-5, drop
    bits and ``comm_*`` equal, final parameters within 2e-4;
  * greedy ``generate`` and ``greedy_bleu`` at (1, 2) tensor-parallel:
    tokens and BLEU equal to the reference's on the same mesh;
  * checkpoints (``torch_ep_worker.ckpt_cfg``, the same function at any
    mesh): saved at (2, 2) equal to one saved at mesh 1, and each restores
    at (1, 1), (1, 2) and (2, 2), in both layouts, and steps on to the
    state of an unbroken mesh-1 run.

The ranks (``torch_ep_worker.py``) and the reference's two subprocesses
(``torch_ep_jax.py`` as a script, 4 simulated devices each) run at the
same time.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro_torch.comm import cost as C  # noqa: E402
from repro_torch.configs.base import CommConfig  # noqa: E402
from repro_torch.core import router as R  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

import torch_ep_jax as J  # noqa: E402
import torch_ep_worker as W  # noqa: E402

STEPS = 3
GEN_N, GEN_NEW = 8, 10
MESHES = ((2, 2), (1, 2))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cases(mesh):
    """The layer cases of one mesh: each layout, branch and wire with the
    loss sum(y * g); and each layout's routed step with the loss its
    balance term alone (``loss`` "balance": its 1/ep share per shard)."""
    tag = f"{mesh[0]}x{mesh[1]}"
    return [dict(name=f"{tag}_{_layout(eom)}_{'local' if dec else 'routed'}_{sub}",
                 mesh=list(mesh), ep_on_model=eom, decision=dec, substrate=sub,
                 ep_inner=0)
            for eom in (False, True) for dec in (False, True)
            for sub in ("dense", "hierarchical")] + \
        [dict(name=f"{tag}_{_layout(eom)}_balance", mesh=list(mesh), ep_on_model=eom,
              decision=False, substrate="dense", ep_inner=0, loss="balance")
         for eom in (False, True)]


def _layout(eom):
    return "eom" if eom else "tp"


CASES = _cases((2, 2)) + _cases((1, 2))
TRAIN = {(2, 2): False, (1, 2): True}          # mesh -> ep_on_model of its run


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Starts the reference's two subprocesses and both groups of ranks
    together; returns (reference arrays, reference records, {mesh: rank
    results}, layer inputs, dir)."""
    d = tmp_path_factory.mktemp("tp")
    jp, arrays = J.layer_inputs()
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    init = J._flat(jax_init_model(jax.random.PRNGKey(0), jcfg))
    gen = J._flat(jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a,
                               jax_init_model(jax.random.PRNGKey(7), jcfg)))
    dirs = {k: d / k for k in ("ref_layer", "ref_train", "w4", "w2")}
    for sub in dirs.values():
        sub.mkdir()
        np.savez(sub / "layer.npz", **arrays)
        np.savez(sub / "init.npz", **init)
        np.savez(sub / "gen_params.npz", **gen)
    np.savez(d / "init.npz", **init)
    refs = [J.start(dirs["ref_train"], {
                "train": [dict(name=f"{m[0]}x{m[1]}", mesh=list(m), ep_on_model=eom,
                               steps=STEPS) for m, eom in TRAIN.items()],
                "generate": dict(mesh=[1, 2], n=GEN_N, max_new=GEN_NEW)}, 4),
            J.start(dirs["ref_layer"], {"layer": CASES, "fault": dict(mesh=[2, 2])}, 4)]
    ckpt_22 = str(dirs["w4"] / "ckpt_22")
    ckpt_m1 = str(d / "ckpt_m1")
    train = dict(steps=STEPS, backends=["sharded", "cuda"])
    ranks = {(2, 2): W.Ranks(4, dirs["w4"], {
                 "mesh": [2, 2], "layer": _cases((2, 2)), "routing": {},
                 "fault": {}, "train": dict(train, ep_on_model=TRAIN[(2, 2)]),
                 "ckpt": {"steps": STEPS, "save": "ckpt_22", "resume": [ckpt_m1, ckpt_22],
                          "layouts": [False, True]}}, timeout=400),
             (1, 2): W.Ranks(2, dirs["w2"], {
                 "mesh": [1, 2], "layer": _cases((1, 2)),
                 "train": dict(train, ep_on_model=TRAIN[(1, 2)]),
                 "generate": {"backend": "sharded", "n": GEN_N, "max_new": GEN_NEW},
                 "ckpt": {"steps": STEPS, "resume": [ckpt_m1, ckpt_22],
                          "layouts": [False, True]}}, timeout=400)}
    try:
        W.ckpt_trainer(str(d), "ckpt_m1", STEPS).run()      # the mesh-1 checkpoint
        results = {mesh: r.join() for mesh, r in ranks.items()}
        logs = [p.communicate(timeout=400)[0] for p in refs]
    finally:
        for p in refs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(refs, logs):
        assert p.returncode == 0, log[-6000:]
    ref, rec = {}, {}
    for k in ("ref_layer", "ref_train"):
        ref.update(np.load(dirs[k] / "jax.npz"))
        rec.update(json.load(open(dirs[k] / "jax.json")))
    return ref, rec, results, arrays, d


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _gather_experts(parts, key, mesh, eom):
    """The full expert array from the ranks' blocks (rank order): along
    d_ff over each data index's model ranks under tensor parallelism, then
    along the expert axis."""
    dp, tp = mesh
    axis = parts[0].ndim - 3
    if not eom:
        tp_axis = parts[0].ndim + W.bridge.expert_tp_axis(key)
        parts = [np.concatenate(parts[j * tp:(j + 1) * tp], axis=tp_axis)
                 for j in range(dp)]
    return np.concatenate(parts, axis=axis)


def moe_aux_keys(ref, name):
    return [k.split("/aux/")[1] for k in ref if k.startswith(f"{name}/aux/")]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_layer_matches_reference_moe_sharded(case, run):
    ref, _, results, arrays, _ = run
    mesh = tuple(case["mesh"])
    dp, tp = mesh
    ranks = results[mesh]
    name, eom = case["name"], case["ep_on_model"]
    moe = jax_reduced(jax_get_config("zcode-m3-base")).moe
    first = [ranks[j * tp][0] for j in range(dp)]       # model index 0 of each data index
    # replicated over each model group: bitwise equal on its ranks
    keys = [f"{name}/y", f"{name}/grad/x", f"{name}/grad/router/w"]
    for j in range(dp):
        for k in range(1, tp):
            for key in keys:
                np.testing.assert_array_equal(ranks[j * tp + k][0][key], first[j][key],
                                              err_msg=key)
    J.assert_close(np.concatenate([o[f"{name}/y"] for o in first]), ref[f"{name}/y"],
                   case, "y")
    for out, _ in ranks:
        for k in moe_aux_keys(ref, name):
            np.testing.assert_allclose(out[f"{name}/aux/{k}"], ref[f"{name}/aux/{k}"],
                                       **J.TOL, err_msg=k)
    J.assert_close(np.concatenate([o[f"{name}/grad/x"] for o in first]),
                   ref[f"{name}/grad/x"], case, "x")
    b, l = arrays["x"].shape[:2]
    J.assert_sum_close(sum(o[f"{name}/grad/router/w"] for o in first),
                       ref[f"{name}/grad/router/w"], b * l, "router")
    for key in ("experts/w_in", "experts/w_out"):
        if f"{name}/grad/{key}" not in ranks[0][0]:        # never reached: zero
            assert case.get("loss") == "balance"
            got = 0.0
        else:
            got = _gather_experts([o[f"{name}/grad/{key}"] for o, _ in ranks], key,
                                  mesh, eom)
        J.assert_close(got, ref[f"{name}/grad/{key}"], case, key)
    # the counter == the telemetry == the cost model, per rank; 0 on Gate-Drop
    tokens = b // dp * (l // tp if eom else l)
    ep = dp * tp if eom else dp
    cap = min(R.capacity(tokens, moe.n_experts, 1, moe.capacity_factor), tokens)
    comm = CommConfig(substrate=case["substrate"])
    cost = C.transport_cost(comm, ep=ep, n_experts=moe.n_experts, cap=cap,
                            d_model=arrays["x"].shape[-1], itemsize=4,
                            tiers=(tp, dp) if eom and comm.hierarchical else None)
    routed = not case["decision"]
    for out, rec in ranks:
        r = rec[name]
        assert r["fwd_calls"] == float(out[f"{name}/aux/comm_a2a_calls"]) == \
            (cost["calls"] if routed else 0)
        assert r["fwd_bytes"] == float(out[f"{name}/aux/comm_bytes"]) == \
            (cost["bytes"] if routed else 0)
        assert r["fwd_wire"] == pytest.approx(float(out[f"{name}/aux/comm_wire_bytes"]),
                                              rel=1e-12)
        # the balance term alone does not reach the wire's output
        assert (r["bwd_calls"], r["bwd_bytes"]) == (
            (0, 0.0) if case.get("loss") == "balance" else (r["fwd_calls"], r["fwd_bytes"]))


def test_hierarchical_wire_is_the_dense_wire_bitwise(run):
    """Under ``ep_on_model`` the hierarchical substrate's tiers are the model
    group and the data group (both hops real at (2, 2)); its permutation is
    the flat all-to-all's, bit for bit."""
    _, _, results, _, _ = run
    for mesh in MESHES:
        for lay in ("tp", "eom"):
            name = f"{mesh[0]}x{mesh[1]}_{lay}_routed"
            for out, _ in results[mesh]:
                np.testing.assert_array_equal(out[f"{name}_hierarchical/y"],
                                              out[f"{name}_dense/y"])
    rec = results[(2, 2)][0][1]
    assert rec["2x2_eom_routed_hierarchical"]["fwd_calls"] == \
        2 * rec["2x2_eom_routed_dense"]["fwd_calls"] == 4


def test_model_ranks_route_alike_under_jitter(run):
    """Router jitter on (a seeded generator): under tensor parallelism the
    two model ranks of each data index pick the same experts for every
    token (the jitter is folded with the data index only); the jitter does
    change some picks against the unjittered route."""
    _, _, results, _, _ = run
    ranks = results[(2, 2)]
    changed = 0
    for j in range(2):
        a, b = ranks[2 * j][0], ranks[2 * j + 1][0]
        np.testing.assert_array_equal(a["routing/ids/0.5"], b["routing/ids/0.5"])
        changed += int((a["routing/ids/0.5"] != a["routing/ids/0.0"]).sum())
    assert changed > 0


def test_ep_on_model_at_one_position_raises(run):
    """A decode step's one position does not split over the model axis: the
    port raises a ValueError that names the layout, where the reference
    (``core/moe.py:399-401``) falls back to its tensor-parallel body on
    experts already split E/(d*m) ways and fails in the FFN's einsum."""
    _, rec, results, _, _ = run
    for _, r in results[(2, 2)]:
        assert r["fault"] is not None and "ep_on_model" in r["fault"]
    assert rec["fault"] is not None and rec["fault"].startswith("ValueError")
    assert "Size of label 'e'" in rec["fault"]


# ---------------------------------------------------------------------------
# the trainer and generation
# ---------------------------------------------------------------------------

CLOCK = ("time_s", "tok_s")


def _untimed(history):
    return [{k: v for k, v in r.items() if k not in CLOCK} for r in history]


@pytest.mark.parametrize("backend", ["sharded", "cuda"])
@pytest.mark.parametrize("mesh", MESHES, ids=["2x2_tp", "1x2_eom"])
def test_training_matches_reference_sharded_step(mesh, backend, run):
    ref, rec, results, _, _ = run
    ranks = results[mesh]
    eom = TRAIN[mesh]
    want = rec[f"train/{mesh[0]}x{mesh[1]}"]
    assert want["bits"] == [False, False, True]
    hist = [_untimed(r[f"train/{backend}"]) for _, r in ranks]
    assert all(h == hist[0] for h in hist)      # every rank records the global values
    for got, jm in zip(hist[0], want["metrics"]):
        assert got["gate_dropped"] == jm["gate_dropped"]
        assert got["lr"] == pytest.approx(jm["lr"], rel=1e-6)
        for k in ("loss", "balance"):
            np.testing.assert_allclose(got[k], jm[k], atol=2e-5, err_msg=k)
        np.testing.assert_allclose(got["acc"], jm["acc"], atol=1e-6)
        for k in ("comm_wire_bytes", "comm_a2a_calls", "comm_exposed_bytes",
                  "comm_hidden_bytes"):
            assert got[k] == jm[k], k
        assert (got["comm_a2a_calls"] > 0) == (not jm["gate_dropped"])
    prefix = f"train/{mesh[0]}x{mesh[1]}/"
    keys = [k[len(prefix):] for k in ref if k.startswith(prefix)]
    assert keys
    for key in keys:
        parts = [out[f"train/{backend}/{key}"] for out, _ in ranks]
        if "experts" in key.split("/"):
            got = _gather_experts(parts, key, mesh, eom)
        else:                                   # replicated leaves stay equal
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0], err_msg=key)
            got = parts[0]
        np.testing.assert_allclose(got, ref[prefix + key], atol=2e-4, err_msg=key)


def test_generate_and_bleu_under_tensor_parallelism_match_reference(run):
    ref, rec, results, _, _ = run
    ranks = results[(1, 2)]
    np.testing.assert_array_equal(ranks[0][0]["gen/tokens"], ranks[1][0]["gen/tokens"])
    np.testing.assert_array_equal(ranks[0][0]["gen/tokens"], ref["gen/tokens"])
    assert all(r["gen_steps"] == rec["gen_steps"] for _, r in ranks)
    assert all(r["bleu"] == rec["bleu"] for _, r in ranks)
    assert all(r["gen_calls"] == 0 for _, r in ranks)     # ep = 1: no all-to-all
    assert len(set(ref["gen/tokens"].flatten().tolist())) > 3


# ---------------------------------------------------------------------------
# checkpoints over both axes
# ---------------------------------------------------------------------------

def test_checkpoint_saved_at_2x2_equals_the_mesh1_checkpoint(run):
    *_, d = run
    got = W.read_checkpoint(str(d / "w4"), "ckpt_22", STEPS)
    assert got[0]["params/decoder/0/p0/moe/experts/w_in"].shape[-3:] == (4, 256, 256)
    W.assert_same_checkpoint(got, W.read_checkpoint(str(d), "ckpt_m1", STEPS))


@pytest.fixture(scope="module")
def unbroken(run, tmp_path_factory):
    """The parameters of STEPS + 1 steps of ``ckpt_cfg`` at mesh 1 in one
    run."""
    init = W.bridge.to_torch(dict(np.load(run[-1] / "init.npz")), "cpu")
    d = tmp_path_factory.mktemp("unbroken")
    state, _ = W.ckpt_trainer(str(d), "ckpt", STEPS + 1, params=init).run()
    return {k: v.detach().numpy() for k, v in flatten_with_paths(state["params"]).items()}


RESTORES = [((1, 1), False), ((1, 2), False), ((2, 2), False), ((1, 2), True),
            ((2, 2), True)]


@pytest.mark.parametrize("saved", ["ckpt_m1", "ckpt_22"])
@pytest.mark.parametrize("restored", RESTORES,
                         ids=[f"{m[0]}x{m[1]}_{_layout(e)}" for m, e in RESTORES])
def test_checkpoint_restores_across_meshes(saved, restored, run, unbroken, tmp_path):
    """A checkpoint saved at mesh 1 or at (2, 2), restored at (1, 1), (1, 2)
    or (2, 2) in either layout, steps on to the state of an unbroken mesh-1
    run."""
    _, _, results, _, d = run
    mesh, eom = restored
    src = str(d / saved) if saved == "ckpt_m1" else str(d / "w4" / saved)
    if mesh == (1, 1):
        trainer = W.ckpt_trainer(str(d), W.resume_copy(str(d), src, f"{saved}_{tmp_path.name}"),
                                 STEPS + 1)
        assert trainer.restore() == STEPS
        got = {k: v.detach().numpy()
               for k, v in flatten_with_paths(trainer.run()[0]["params"]).items()}
    else:
        tag = f"{saved}@eom" if eom else saved
        ranks = results[mesh]
        assert all(r[f"ckpt/{tag}/restored_step"] == STEPS for _, r in ranks)
        got = {}
        for key in unbroken:
            parts = [out[f"ckpt/{tag}/{key}"] for out, _ in ranks]
            got[key] = (_gather_experts(parts, key, mesh, eom)
                        if "experts" in key.split("/") else parts[0])
    for key, want in unbroken.items():
        np.testing.assert_allclose(got[key], want, atol=2e-4, rtol=0, err_msg=key)
