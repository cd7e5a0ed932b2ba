"""The JAX side of the port's expert-parallel layer tests
(``test_torch_comm.py`` at 4 ranks, ``test_torch_ep.py`` at 2): the
reference's weights and inputs, its ``moe_oracle(ep)`` with gradients,
and the checks of one case of a rank run (``torch_ep_worker.py``) against
it. Tolerance: 1e-5 absolute and relative (f32; the two packages' CPU
matmuls sum in different orders). A compressed wire quantizes the expert
FFN's output (forward) and its input gradient (backward), which the two
packages compute to within 1e-7: an element that lies on a rounding
boundary may land one quantum apart. Such elements (at most 0.1% of a
tensor, at least one allowed) may differ by one quantum of the tensor's
largest row: amax / 127 for int8, amax / 14 for fp8 (e4m3's spacing just
below its top, 448). ``test_torch_tp.py`` holds its router gradients,
summed over tokens and shards, by ``assert_sum_close``.

Run as a script (``python tests/torch_ep_jax.py DIR``, ``start`` starts
it) it is the reference's side of ``test_torch_tp.py`` on a simulated
(data, model) CPU mesh: ``moe_sharded`` per layer case (``sharded_layer``),
the sharded train step, ``generate`` / ``greedy_bleu`` and the
``ep_on_model`` fault at one position, as ``DIR/jax_spec.json`` names
them; it writes ``DIR/jax.npz`` and ``DIR/jax.json``."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import CommConfig as JaxComm
from repro.core import moe as jax_moe
from repro_torch.comm import cost as C
from repro_torch.configs.base import CommConfig
from repro_torch.core import router as R
from torch_ep_worker import case_arrays

TOL = dict(atol=1e-5, rtol=1e-5)


def layer_inputs(seed=0):
    """Reduced zcode-m3-base MoE weights (the reference's init) and
    seeded activations, cotangents and a token mask."""
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    jp = jax_moe.init_moe_params(jax.random.PRNGKey(seed), jcfg)
    rs = np.random.RandomState(seed + 1)
    arrays = {"x": rs.randn(8, 4, jcfg.d_model).astype(np.float32),
              "g": rs.randn(8, 4, jcfg.d_model).astype(np.float32),
              "tv": rs.rand(8, 4) < 0.75}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        arrays["p/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    return jp, arrays


def _layer_cfg(case):
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    gd = dataclasses.replace(jcfg.moe.gating_dropout, mode=case.get("mode", "gate_drop"),
                             rate=0.3)
    return dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, jitter_eps=0.0, top_k=case.get("top_k", 1), gating_dropout=gd,
        ep_on_model=case.get("ep_on_model", False),
        comm=JaxComm(substrate=case["substrate"], quant=case.get("quant", "int8"),
                     ep_inner=case.get("ep_inner", 0), n_chunks=4)))


def jax_layer(jp, arrays, case, ep):
    """moe_oracle(ep) under the case's substrate: output, aux and the
    gradients of sum(y * g) w.r.t. x and the weights."""
    jcfg = _layer_cfg(case)
    arrays = case_arrays(arrays, case)
    tv = jnp.asarray(arrays["tv"]) if case.get("masked") else None

    @jax.jit
    def run(p, x, g):
        def f(p, x):
            return jax_moe.moe_oracle(p, x, jcfg, ep=ep, decision=case["decision"],
                                      is_training=True, token_valid=tv)
        (y, aux), vjp = jax.vjp(f, p, x)
        return y, aux, vjp((g, jax.tree.map(jnp.zeros_like, aux)))

    y, aux, (gp, gx) = run(jp, jnp.asarray(arrays["x"]), jnp.asarray(arrays["g"]))
    grads = {"x": np.asarray(gx)}
    for path, leaf in jax.tree_util.tree_flatten_with_path(gp)[0]:
        grads["/".join(p.key for p in path)] = np.asarray(leaf)
    return np.asarray(y), jax.device_get(aux), grads


def gather_ranks(results, key, axis=0):
    return np.concatenate([out[key] for out, _ in results], axis=axis)


def assert_close(got, want, case, err_msg=""):
    """``TOL``, up to the rounding-boundary flips of a compressed wire."""
    got, want = np.broadcast_to(np.asarray(got, np.float32), np.shape(want)), \
        np.asarray(want, np.float32)
    if not case["substrate"].endswith("compressed") or case["decision"]:
        np.testing.assert_allclose(got, want, **TOL, err_msg=err_msg)
        return
    diff = np.abs(got - want)
    off = diff > TOL["atol"] + TOL["rtol"] * np.abs(want)
    quantum = np.abs(want).max(initial=0.0) / (14 if case.get("quant") == "fp8" else 127)
    assert off.sum() <= max(1, want.size // 1000), (err_msg, int(off.sum()), want.size)
    assert (diff[off] <= 1.05 * quantum).all(), (err_msg, diff[off].max(), quantum)


def assert_sum_close(got, want, terms, err_msg=""):
    """``assert_close`` for a gradient that is a sum of ``terms`` products
    per entry (the router's: x^T @ dlogits over a shard's tokens, then
    over the shards): an entry the sum cancels to near zero carries the
    rounding of its large terms, which two f32 implementations that sum
    in different orders each commit. Beyond ``TOL`` an entry may differ
    by 2 * terms * 2**-24 * the largest entry of its column (one
    expert's): the first-order f32 error bound of an n-term sum, n * u *
    sum |term|, once for each package, with sum |term| estimated by the
    largest sum the column holds. The other checks of a layer case stay
    at ``TOL``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    col = np.abs(want).max(axis=0, keepdims=True)
    bound = TOL["atol"] + TOL["rtol"] * np.abs(want) + 2 * terms * 2.0 ** -24 * col
    diff = np.abs(got - want)
    assert (diff <= bound).all(), (err_msg, float(diff.max()),
                                   float((diff - bound).max()))


def check_layer(results, want, arrays, case, ep, moe_cfg):
    """One case of a rank run against the reference's (``jax_layer``),
    and its counters."""
    name = case["name"]
    y, aux, grads = want
    arrays = case_arrays(arrays, case)
    assert_close(gather_ranks(results, f"{name}/y"), y, case, "y")
    for out, _ in results:
        for k, v in aux.items():
            np.testing.assert_allclose(out[f"{name}/aux/{k}"], v, **TOL, err_msg=k)
    for key, want in grads.items():
        if all(f"{name}/grad/{key}" not in out for out, _ in results):
            got = 0.0                # never reached (expert drop): zero
        elif key == "x" or "experts" in key.split("/"):
            got = gather_ranks(results, f"{name}/grad/{key}")
        else:                        # replicated: every rank's share, summed
            got = sum(out.get(f"{name}/grad/{key}", 0.0) for out, _ in results)
        assert_close(got, want, case, key)
    # the counter == the telemetry == the cost model, per rank
    tokens = arrays["x"][..., 0].size // ep
    cap = min(R.capacity(tokens, moe_cfg.n_experts, case.get("top_k", 1),
                         moe_cfg.capacity_factor), tokens)
    comm = CommConfig(substrate=case["substrate"], quant=case.get("quant", "int8"),
                      ep_inner=case["ep_inner"], n_chunks=4)
    cost = C.transport_cost(comm, ep=ep, n_experts=moe_cfg.n_experts, cap=cap,
                            d_model=arrays["x"].shape[-1], itemsize=4)
    routed = not case["decision"]
    for out, rec in results:
        r = rec[name]
        assert r["fwd_calls"] == float(out[f"{name}/aux/comm_a2a_calls"]) == \
            (cost["calls"] if routed else 0)
        assert r["fwd_bytes"] == float(out[f"{name}/aux/comm_bytes"]) == \
            (cost["bytes"] if routed else 0)
        assert r["fwd_wire"] == pytest.approx(float(out[f"{name}/aux/comm_wire_bytes"]),
                                              rel=1e-12)
        assert (r["bwd_calls"], r["bwd_bytes"]) == (r["fwd_calls"], r["fwd_bytes"])


# ---------------------------------------------------------------------------
# the reference on a simulated (data, model) mesh (a subprocess's devices)
# ---------------------------------------------------------------------------

def mesh_of(shape):
    """A ("data", "model") mesh over the first d * m devices."""
    from jax.sharding import Mesh
    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(shape)), ("data", "model"))


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def sharded_layer(jp, arrays, case):
    """The reference's ``moe_sharded`` on the case's mesh and layout:
    output, aux and the gradients of sum(y * g) (of the balance term alone
    with ``case["loss"]`` "balance") w.r.t. x and the weights."""
    jcfg = _layer_cfg(case)
    ctx = jax_moe.ParallelContext(mesh=mesh_of(case["mesh"]))

    @jax.jit
    def run(p, x, g):
        def f(p, x):
            return jax_moe.moe_sharded(p, x, jcfg, ctx, decision=case["decision"],
                                       is_training=True)
        (y, aux), vjp = jax.vjp(f, p, x)
        ct = jax.tree.map(jnp.zeros_like, aux)
        if case.get("loss") == "balance":
            ct["balance"] = jnp.ones_like(aux["balance"])
            g = jnp.zeros_like(g)
        return y, aux, vjp((g, ct))

    y, aux, (gp, gx) = run(jp, jnp.asarray(arrays["x"]), jnp.asarray(arrays["g"]))
    return np.asarray(y), jax.device_get(aux), {"x": np.asarray(gx), **_flat(gp)}


def _train(spec, out, rec):
    """The reference's sharded train step (built as tests/test_sharding.py
    builds it) on the spec's mesh and layout, from the seed-0 init."""
    from repro.configs.base import TrainConfig
    from repro.core.gating_dropout import drop_decisions_host
    from repro.data import MTTaskConfig, MultilingualMT
    from repro.models import init_model
    from repro.parallel.sharding import batch_specs, state_specs, to_shardings
    from repro.training import init_train_state, make_train_step
    cfg = jax_reduced(jax_get_config("zcode-m3-base"))
    gd = dataclasses.replace(cfg.moe.gating_dropout, mode="gate_drop", rate=0.3)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, jitter_eps=0.0, backend="sharded", gating_dropout=gd,
        ep_on_model=spec["ep_on_model"]))
    steps = spec["steps"]
    tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=steps)
    mesh = mesh_of(spec["mesh"])
    ctx = jax_moe.ParallelContext(mesh=mesh)
    state = init_train_state(init_model(jax.random.PRNGKey(0), cfg), tc)
    st_specs = to_shardings(mesh, state_specs(cfg, ctx, jax.eval_shape(lambda: state)))
    batches = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=4,
                                          max_len=16)).train_batches(4)
    b0 = {k: jnp.asarray(v) for k, v in batches(0).items()}
    b_specs = to_shardings(mesh, batch_specs(cfg, ctx, b0))
    state = jax.device_put(state, st_specs)
    step = jax.jit(make_train_step(cfg, tc, ctx, jit=False),
                   in_shardings=(st_specs, b_specs), static_argnums=(2,),
                   out_shardings=(st_specs, None))
    bits = drop_decisions_host(cfg.moe.gating_dropout, 0, 0, steps)
    metrics = []
    for i in range(steps):
        b = jax.device_put({k: jnp.asarray(v) for k, v in batches(i).items()}, b_specs)
        state, m = step(state, b, bool(bits[i]))
        metrics.append({k: np.asarray(v).tolist() for k, v in jax.device_get(m).items()})
    name = spec["name"]
    for k, v in _flat(jax.device_get(state["params"])).items():
        out[f"train/{name}/{k}"] = v
    rec[f"train/{name}"] = {"metrics": metrics, "bits": [bool(x) for x in bits]}


def _generate(spec, out, rec):
    """``greedy_bleu`` and ``generate`` under the spec's mesh on the
    reference's seed-7 init scaled x3 (``gen_params.npz`` in the port's
    run)."""
    from repro.data import MTTaskConfig, MultilingualMT
    from repro.launch.train import greedy_bleu
    from repro.models import init_model
    from repro.serve import GenerateConfig, generate
    gcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    gp = jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a,
                      init_model(jax.random.PRNGKey(7), gcfg))
    ctx = jax_moe.ParallelContext(mesh=mesh_of(spec["mesh"]))
    task = MultilingualMT(MTTaskConfig(vocab=gcfg.vocab, n_langs=4, max_len=16))
    rec["bleu"] = greedy_bleu(gp, gcfg, task, n=spec["n"], max_new=spec["max_new"], ctx=ctx)
    b = task.sample_batch(10_000, spec["n"])
    res = generate(gp, {"enc_tokens": jnp.asarray(b["enc_tokens"]),
                        "tokens": jnp.asarray(b["tokens"][:, :1])},
                   gcfg, GenerateConfig(max_new=spec["max_new"]), ctx=ctx)
    out["gen/tokens"] = np.asarray(res.tokens)
    rec["gen_steps"] = int(res.steps)


def _fault(spec, rec):
    """``moe_sharded`` under ``ep_on_model`` at one position (a decode
    step's x, (4, 1, 32); 8 experts): the error the reference raises, or
    None."""
    from repro.configs.base import ModelConfig, MoEConfig
    cfg = ModelConfig(d_model=32, d_ff=64, vocab=64, dtype="float32", moe=MoEConfig(
        n_experts=8, top_k=1, d_ff_expert=64, jitter_eps=0.0, ep_on_model=True,
        backend="sharded"))
    ctx = jax_moe.ParallelContext(mesh=mesh_of(spec["mesh"]))
    p = jax_moe.init_moe_params(jax.random.PRNGKey(0), cfg)
    x = jnp.zeros((4, 1, 32), jnp.float32)
    try:
        jax.jit(lambda p, x: jax_moe.moe_sharded(p, x, cfg, ctx, decision=False))(p, x)
        rec["fault"] = None
    except Exception as e:           # noqa: BLE001 - recorded for the test
        rec["fault"] = f"{type(e).__name__}: {e}"


def start(d, spec, n_devices):
    """Starts this file as a script on ``n_devices`` simulated CPU devices
    over ``d``; returns the process."""
    with open(os.path.join(d, "jax_spec.json"), "w") as f:
        json.dump(spec, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), str(d)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    d = sys.argv[1]
    spec = json.load(open(os.path.join(d, "jax_spec.json")))
    arrays = dict(np.load(os.path.join(d, "layer.npz")))
    jp = layer_inputs()[0]
    out, rec = {}, {}
    for case in spec.get("layer", []):
        y, aux, grads = sharded_layer(jp, arrays, case)
        name = case["name"]
        out[f"{name}/y"] = y
        out.update({f"{name}/aux/{k}": np.asarray(v) for k, v in aux.items()})
        out.update({f"{name}/grad/{k}": v for k, v in grads.items()})
    for t in spec.get("train", []):
        _train(t, out, rec)
    if spec.get("generate"):
        _generate(spec["generate"], out, rec)
    if spec.get("fault"):
        _fault(spec["fault"], rec)
    np.savez(os.path.join(d, "jax.npz"), **out)
    with open(os.path.join(d, "jax.json"), "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    main()
