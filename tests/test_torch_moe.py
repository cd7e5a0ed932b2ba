"""Port router, routing tables and MoE layer against the JAX package on the
same numpy inputs and weights (CPU). Integer outputs (expert ids, buffer
positions, keep masks, slot tables) must match exactly; float outputs
within 1e-5 in f32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.core import backend as jax_backend  # noqa: E402
from repro.core import moe as jax_moe  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import backend as port_backend  # noqa: E402
from repro_torch.core import moe as port_moe  # noqa: E402
from repro_torch.core import router as R  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=1e-5)


def _moe_cfgs(**kw):
    kw.setdefault("jitter_eps", 0.0)
    return JaxMoEConfig(**kw), MoEConfig(**kw)


def _inputs(T, d, E, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(T, d).astype(np.float32), rs.randn(d, E).astype(np.float32),
            rs.randint(0, 2**31 - 1, size=T).astype(np.int32))


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router", ["softmax", "sigmoid", "hash"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("local", [None, (2, 2)])
def test_route_matches(router, k, local):
    jm, tm = _moe_cfgs(n_experts=6, top_k=k, router_type=router)
    x, wr, tok = _inputs(40, 16, 6)
    kw = {} if local is None else {"expert_lo": local[0], "n_local": local[1]}
    want = JR.route(jnp.asarray(wr), jnp.asarray(x), jm, is_training=False,
                    token_ids=jnp.asarray(tok), **kw)
    got = R.route(_t(wr), _t(x), tm, is_training=False, token_ids=_t(tok), **kw)
    _eq(got.topk_idx, want.topk_idx)
    _close(got.topk_w, want.topk_w)
    _close(got.probs, want.probs)


def test_topk_ties_go_to_the_lower_expert():
    """Exactly tied router scores: both packages pick the lowest ids."""
    jm, tm = _moe_cfgs(n_experts=8, top_k=2)
    wr = np.zeros((4, 8), np.float32)
    wr[:, 5] = wr[:, 6] = 1.0                     # experts 5 and 6 tie on top
    x = np.abs(np.random.RandomState(0).randn(10, 4)).astype(np.float32)
    x[3] = 0.0                                    # all 8 experts tie
    want = JR.route(jnp.asarray(wr), jnp.asarray(x), jm, is_training=False)
    got = R.route(_t(wr), _t(x), tm, is_training=False)
    _eq(got.topk_idx, want.topk_idx)
    assert got.topk_idx[0].tolist() == [5, 6] and got.topk_idx[3].tolist() == [0, 1]


def test_hash_router_wraps_like_uint32():
    jm, tm = _moe_cfgs(n_experts=7, top_k=1, router_type="hash")
    tok = np.array([0, 1, 2**16, 2**31 - 1, 123456789, 4000000], np.int32)
    x = np.zeros((len(tok), 4), np.float32)
    wr = np.zeros((4, 7), np.float32)
    want = JR.route(jnp.asarray(wr), jnp.asarray(x), jm, token_ids=jnp.asarray(tok))
    got = R.route(_t(wr), _t(x), tm, token_ids=_t(tok))
    _eq(got.topk_idx, want.topk_idx)


@pytest.mark.parametrize("k,cap,valid_p", [(1, 3, None), (2, 2, None),
                                           (2, 4, 0.6), (1, 1, 0.8)])
def test_dispatch_info_and_routing_tables_match(k, cap, valid_p):
    E = 5
    jm, tm = _moe_cfgs(n_experts=E, top_k=k)
    x, wr, _ = _inputs(24, 8, E, seed=1)
    valid = None if valid_p is None else np.random.RandomState(2).rand(24, k) < valid_p
    jrr = JR.route(jnp.asarray(wr), jnp.asarray(x), jm, is_training=False)
    trr = R.route(_t(wr), _t(x), tm, is_training=False)
    jinfo = JR.dispatch_info(jrr, E, cap, None if valid is None else jnp.asarray(valid))
    tinfo = R.dispatch_info(trr, E, cap, None if valid is None else _t(valid))
    _eq(tinfo.pos, jinfo.pos)
    _eq(tinfo.keep, jinfo.keep)
    jt = jax_ops.routing_tables(jinfo, E, cap)
    tt = ops.routing_tables(tinfo, E, cap)
    for got, want in zip(tt, jt):
        _eq(got, want)
    assert tt.slot_token.dtype == tt.token_slot.dtype == torch.int32
    # router dispatch/combine and their kernel-op forms
    jbuf = JR.dispatch(jnp.asarray(x), jinfo, E, cap)
    tbuf = R.dispatch(_t(x), tinfo, E, cap)
    _eq(tbuf, jbuf)
    _eq(ops.moe_dispatch_op(_t(x), tinfo, E, cap, tables=tt), jbuf)
    _close(R.combine(tbuf, tinfo), JR.combine(jbuf, jinfo))
    _close(ops.moe_combine_op(tbuf, tinfo), JR.combine(jbuf, jinfo))


def test_aux_losses_match():
    jm, tm = _moe_cfgs(n_experts=6, top_k=2)
    x, wr, _ = _inputs(30, 8, 6, seed=3)
    jrr = JR.route(jnp.asarray(wr), jnp.asarray(x), jm, is_training=False)
    trr = R.route(_t(wr), _t(x), tm, is_training=False)
    _close(R.balance_loss(trr, tm), JR.balance_loss(jrr, jm))
    _close(R.router_z_loss(trr), JR.router_z_loss(jrr), atol=1e-4)
    _close(R.route_entropy(trr), JR.route_entropy(jrr))
    _close(R.expert_load(trr, tm), JR.expert_load(jrr, jm))
    assert R.capacity(30, 6, 2, 1.25) == JR.capacity(30, 6, 2, 1.25)


# ---------------------------------------------------------------------------
# MoE layer
# ---------------------------------------------------------------------------

def _layer(top_k=1, mode="gate_drop", local_combine="prob", seed=0):
    """Reduced zcode MoE config in both packages and bridged weights."""
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    tcfg = reduced(get_config("zcode-m3-base"))
    gd = dict(mode=mode, rate=0.3, local_combine=local_combine)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, top_k=top_k, gating_dropout=dataclasses.replace(
            jcfg.moe.gating_dropout, **gd)))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, top_k=top_k, gating_dropout=dataclasses.replace(
            tcfg.moe.gating_dropout, **gd)))
    jp = jax_moe.init_moe_params(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: _t(a), jp)
    x = np.random.RandomState(seed + 7).randn(2, 8, jcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _check_aux(got, want):
    assert set(got) == set(want)
    for key in got:
        _close(got[key], want[key], atol=1e-4)


@pytest.mark.parametrize("ep", [1, 2])
@pytest.mark.parametrize("decision", [None, True])
@pytest.mark.parametrize("top_k,mode,local_combine,masked", [
    (1, "gate_drop", "prob", False), (2, "gate_drop", "one", True),
    (1, "gate_expert_drop", "prob", True)])
def test_moe_oracle_matches(ep, decision, top_k, mode, local_combine, masked):
    jcfg, tcfg, jp, tp, x = _layer(top_k, mode, local_combine)
    tv = None
    if masked:
        tv = np.random.RandomState(1).rand(2, 8) < 0.7
    kw = dict(ep=ep, decision=decision, is_training=False)
    jy, jaux = jax_moe.moe_oracle(jp, jnp.asarray(x), jcfg,
                                  token_valid=None if tv is None else jnp.asarray(tv),
                                  **kw)
    ty, taux = port_moe.moe_oracle(tp, _t(x), tcfg,
                                   token_valid=None if tv is None else _t(tv), **kw)
    _close(ty, jy, atol=1e-4)
    _check_aux(taux, jaux)


@pytest.mark.parametrize("decision", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_backend_matches_pallas_backend(decision, masked):
    """The kernel pipeline (plain versions on the CPU) against the JAX
    package's Pallas pipeline in interpret mode, routed and local."""
    jcfg, tcfg, jp, tp, x = _layer(seed=2)
    tv = np.random.RandomState(3).rand(2, 8) < 0.6 if masked else None
    jy, jaux = jax_backend.get_backend("pallas")(
        jp, jnp.asarray(x), jcfg, decision=decision, is_training=False,
        token_valid=None if tv is None else jnp.asarray(tv), interpret=True)
    ty, taux = port_backend.get_backend("cuda")(
        tp, _t(x), tcfg, decision=decision, is_training=False,
        token_valid=None if tv is None else _t(tv))
    _close(ty, jy, atol=1e-4)
    _check_aux(taux, jaux)


def test_backend_registry():
    assert port_backend.available_backends() == ("cuda", "cuda_fused", "oracle",
                                                 "sharded")
    assert port_backend.resolve_backend(MoEConfig()) == "oracle"
    with pytest.raises(KeyError):
        port_backend.get_backend("pallas")
    with pytest.raises(ValueError):
        MoEConfig(backend="pallas")
    with pytest.raises(TypeError):     # the drop decision is a host bool
        port_moe._select_branch(MoEConfig(), torch.tensor(True), None, None, None)
