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
below its top, 448)."""
import dataclasses

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


def jax_layer(jp, arrays, case, ep):
    """moe_oracle(ep) under the case's substrate: output, aux and the
    gradients of sum(y * g) w.r.t. x and the weights."""
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    gd = dataclasses.replace(jcfg.moe.gating_dropout, mode=case.get("mode", "gate_drop"),
                             rate=0.3)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, jitter_eps=0.0, top_k=case.get("top_k", 1), gating_dropout=gd,
        comm=JaxComm(substrate=case["substrate"], quant=case.get("quant", "int8"),
                     ep_inner=case.get("ep_inner", 0), n_chunks=4)))
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


def check_layer(results, want, arrays, case, ep, moe_cfg):
    """One case of a rank run against the reference's (``jax_layer``),
    and its counters."""
    name = case["name"]
    y, aux, grads = want
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
