"""The port's fused MoE kernel (B4, ``repro_torch/kernels/moe_megakernel``)
and its ``cuda_fused`` backend against the JAX package's ``fused_moe_ffn``
and ``pallas_fused`` backend run in Pallas interpret mode, on the same
numpy inputs and bridged weights (CPU, where the port's wrapper takes its
plain version and the same autograd.Function backward the card runs).
The ``cuda``-marked tests hold the CUDA kernel against its plain version
on the card and skip without one.

Tolerances: f32 outputs and gradients within 1e-5 absolute + 1e-5
relative (the same arithmetic, sums in another order); bf16 outputs
within 1e-2 + 1.6e-2 * |ref|, about two bf16 ulps: like the Pallas
kernel, the port's forward keeps every intermediate in f32 and rounds
once (``ref.fused_moe_f32_ref``), so only that last rounding can differ.
On the card: f32 within 1e-4 + 1e-4 * |plain| (the kernel's f32 sums run
in another order than cuBLAS's), bf16 within 2e-2 + 1.6e-2 * |plain|.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import backend as port_backend  # noqa: E402
from repro_torch.core import router as R  # noqa: E402
from repro_torch.kernels import moe_megakernel, ops, ref  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here so that the ``cuda`` tests run where
    JAX is not installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.core import backend as jbackend
    from repro.core.moe import init_moe_params
    from repro.kernels.moe_megakernel import fused_moe_ffn
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget,
                                 reduced=jreduced, backend=jbackend,
                                 init_moe_params=init_moe_params,
                                 fused_moe_ffn=fused_moe_ffn)


def make_case(E, k, cap, T, d, f, *, gated=True, seed=0, keep_none=False):
    """numpy inputs of one fused call: tokens, weights and the routing
    tables of a softmax top-k route at capacity ``cap``."""
    rs = np.random.RandomState(seed)
    x = rs.randn(T, d).astype(np.float32)
    wr = rs.randn(d, E).astype(np.float32)
    w_in = (rs.randn(E, d, f) * 0.1).astype(np.float32)
    w_gate = (rs.randn(E, d, f) * 0.1).astype(np.float32) if gated else None
    w_out = (rs.randn(E, f, d) * 0.1).astype(np.float32)
    moe = MoEConfig(n_experts=E, top_k=k, jitter_eps=0.0)
    rr = R.route(torch.from_numpy(wr), torch.from_numpy(x), moe, is_training=False)
    info = R.dispatch_info(rr, E, cap)
    if keep_none:
        info = info._replace(keep=torch.zeros_like(info.keep))
    tables = ops.routing_tables(info, E, cap)
    routing = {"topk_w": info.topk_w.numpy(), "keep": info.keep.numpy(),
               "slot_token": tables.slot_token.numpy(),
               "slot_valid": tables.slot_valid.numpy(),
               "token_slot": tables.token_slot.numpy()}
    return {"x": x, "w_in": w_in, "w_gate": w_gate, "w_out": w_out}, routing


def _port(case, routing, act, dtype=torch.float32, grad=False):
    t = {k: None if v is None else torch.from_numpy(v).to(dtype).requires_grad_(grad)
         for k, v in case.items()}
    tw = torch.from_numpy(routing["topk_w"]).requires_grad_(grad)
    y = moe_megakernel.fused_moe(
        t["x"], t["w_in"], t["w_gate"], t["w_out"], tw,
        torch.from_numpy(routing["keep"]), torch.from_numpy(routing["slot_token"]),
        torch.from_numpy(routing["slot_valid"]), torch.from_numpy(routing["token_slot"]),
        act=act)
    return y, t, tw


def _jax_fused(jx, case, routing, act, dtype="float32"):
    jnp = jx.jnp
    c = {k: None if v is None else jnp.asarray(v).astype(dtype) for k, v in case.items()}
    r = {k: jnp.asarray(v) for k, v in routing.items()}
    return lambda x, wi, wg, wo, tw: jx.fused_moe_ffn(
        x, wi, wg, wo, tw, r["keep"], r["slot_token"], r["slot_valid"],
        r["token_slot"], act=act, interpret=True), c, r


def _close(got, want, atol=1e-5, rtol=1e-5):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# forward and gradients of the fused op against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,k,cap,T,d,f", [
    (4, 1, 8, 32, 16, 32),      # k=1, the paper's routing
    (4, 2, 8, 37, 24, 40),      # k=2; T, d, f with no friendly divisors
    (4, 1, 1, 16, 16, 16),      # capacity 1
    (2, 1, 1, 1, 8, 8),         # one token
])
@pytest.mark.parametrize("gated,act", [(False, "gelu"), (True, "silu")])
def test_fused_moe_matches_pallas(E, k, cap, T, d, f, gated, act, jx):
    case, routing = make_case(E, k, cap, T, d, f, gated=gated)
    got, _, _ = _port(case, routing, act)
    fn, c, r = _jax_fused(jx, case, routing, act)
    want = fn(c["x"], c["w_in"], c["w_gate"], c["w_out"], r["topk_w"])
    assert got.shape == (T, d) and got.dtype == torch.float32
    _close(got, want)


def test_fused_moe_all_dropped_is_exact_zero(jx):
    case, routing = make_case(4, 2, 8, 24, 16, 16, keep_none=True)
    got, _, _ = _port(case, routing, "silu")
    assert float(got.abs().max()) == 0.0


def test_fused_moe_bf16_matches_pallas(jx):
    case, routing = make_case(4, 2, 8, 32, 32, 48)
    got, _, _ = _port(case, routing, "silu", dtype=torch.bfloat16)
    fn, c, r = _jax_fused(jx, case, routing, "silu", dtype="bfloat16")
    want = fn(c["x"], c["w_in"], c["w_gate"], c["w_out"], r["topk_w"])
    assert got.dtype == torch.bfloat16
    _close(got, want, atol=1e-2, rtol=1.6e-2)


@pytest.mark.parametrize("k,gated,act", [(1, False, "gelu"), (2, True, "silu")])
def test_fused_moe_grads_match_jax(k, gated, act, jx):
    """Gradients of x, w_in, (w_gate), w_out and topk_w: the port's
    Function backward (autograd through the plain slot formulation)
    against jax.grad through the reference's custom VJP."""
    case, routing = make_case(4, k, 8, 24, 16, 24, gated=gated, seed=3)
    r_np = np.random.RandomState(9).randn(24, 16).astype(np.float32)
    y, t, tw = _port(case, routing, act, grad=True)
    assert type(y.grad_fn).__name__ == "_FusedMoEBackward"
    (y * torch.from_numpy(r_np)).sum().backward()
    fn, c, r = _jax_fused(jx, case, routing, act)
    jnp = jx.jnp
    args = (c["x"], c["w_in"], c["w_gate"], c["w_out"], r["topk_w"])
    argnums = (0, 1, 2, 3, 4) if gated else (0, 1, 3, 4)
    grads = jx.jax.grad(lambda *a: (fn(*a) * jnp.asarray(r_np)).sum(),
                        argnums=argnums)(*args)
    port = {0: t["x"], 1: t["w_in"], 2: t["w_gate"], 3: t["w_out"], 4: tw}
    for i, g in zip(argnums, grads):
        _close(port[i].grad, g)
    assert float(tw.grad.abs().sum()) > 0       # the router is reached


# ---------------------------------------------------------------------------
# the cuda_fused backend against pallas_fused, outputs, aux and grads
# ---------------------------------------------------------------------------

def _backend_cfgs(jx, mode):
    jcfg = jx.reduced(jx.get_config("zcode-m3-base"))
    tcfg = reduced(get_config("zcode-m3-base"))
    jgd = dataclasses.replace(jcfg.moe.gating_dropout, mode=mode, rate=0.3)
    tgd = dataclasses.replace(tcfg.moe.gating_dropout, mode=mode, rate=0.3)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, jitter_eps=0.0, gating_dropout=jgd))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, jitter_eps=0.0, gating_dropout=tgd))
    return jcfg, tcfg


@pytest.mark.parametrize("mode,decision", [("gate_drop", False),
                                           ("gate_drop", True),
                                           ("gate_expert_drop", True)])
def test_cuda_fused_backend_matches_pallas_fused(mode, decision, jx):
    jax, jnp = jx.jax, jx.jnp
    jcfg, tcfg = _backend_cfgs(jx, mode)
    jp = jx.init_moe_params(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(5)
    x = rs.randn(2, 16, tcfg.d_model).astype(np.float32)
    r_np = rs.randn(2, 16, tcfg.d_model).astype(np.float32)
    jfn = jx.backend.get_backend("pallas_fused")

    def jloss(p, x_):
        y, aux = jfn(p, x_, jcfg, None, rng=jax.random.PRNGKey(7),
                     decision=decision, is_training=True, token_ids=None)
        return (y * jnp.asarray(r_np)).sum(), (y, aux)

    (_, (jy, jaux)), (jg_p, jg_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    tp = {"router": {"w": torch.from_numpy(np.asarray(jp["router"]["w"]))},
          "experts": {k: torch.from_numpy(np.asarray(v))
                      for k, v in jp["experts"].items()}}
    leaves = [tp["router"]["w"], tp["experts"]["w_in"], tp["experts"]["w_out"]]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = port_backend.get_backend("cuda_fused")(
        tp, tx, tcfg, decision=decision, is_training=True)

    _close(ty, jy)
    np.testing.assert_array_equal(taux["dropped_frac"].numpy(),
                                  np.asarray(jaux["dropped_frac"]))
    np.testing.assert_array_equal(taux["load"].numpy(), np.asarray(jaux["load"]))
    _close(taux["balance"], jaux["balance"], atol=1e-6)
    if mode == "gate_expert_drop":
        # the MoE sub-layer is skipped: a constant zero output, no graph,
        # and JAX's gradients are exactly zero
        assert not ty.requires_grad and float(ty.abs().max()) == 0.0
        for g in (jg_x, jg_p["router"]["w"], jg_p["experts"]["w_in"],
                  jg_p["experts"]["w_out"]):
            assert float(jnp.abs(g).max()) == 0.0
        return
    (ty * torch.from_numpy(r_np)).sum().backward()
    _close(tx.grad, jg_x)
    _close(leaves[0].grad, jg_p["router"]["w"])
    _close(leaves[1].grad, jg_p["experts"]["w_in"])
    _close(leaves[2].grad, jg_p["experts"]["w_out"])


def test_cuda_fused_backend_never_falls_back():
    """On the CPU the fused backend runs the fused op, not the pipeline's
    three wrappers."""
    from repro_torch.kernels import grouped_ffn, moe_dispatch
    tcfg = reduced(get_config("zcode-m3-base"))
    calls = []
    orig = (moe_dispatch.dispatch, grouped_ffn.grouped_matmul,
            moe_megakernel.fused_moe)
    try:
        moe_dispatch.dispatch = lambda *a, **k: calls.append("dispatch")
        grouped_ffn.grouped_matmul = lambda *a, **k: calls.append("gmm")
        moe_megakernel.fused_moe = (
            lambda *a, **k: calls.append("fused") or orig[2](*a, **k))
        p = {"router": {"w": torch.randn(tcfg.d_model, 4)},
             "experts": {"w_in": torch.randn(4, tcfg.d_model, 256) * 0.05,
                         "w_out": torch.randn(4, 256, tcfg.d_model) * 0.05}}
        port_backend.get_backend("cuda_fused")(p, torch.randn(8, tcfg.d_model), tcfg)
    finally:
        (moe_dispatch.dispatch, grouped_ffn.grouped_matmul,
         moe_megakernel.fused_moe) = orig
    assert calls == ["fused"]


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gpu_case(dev, E, k, cap, T, d, f, gated, dtype, keep_none=False, seed=0):
    case, routing = make_case(E, k, cap, T, d, f, gated=gated, seed=seed,
                              keep_none=keep_none)
    t = {n: None if v is None else torch.from_numpy(v).to(dev, dtype)
         for n, v in case.items()}
    r = {n: torch.from_numpy(v).to(dev) for n, v in routing.items()}
    return t, r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_moe_matches_plain(dtype):
    dev = _card()
    cases = [(128, 1, 8, 1024, 512, 2048, False, "gelu"),   # the training site
             (4, 2, 8, 37, 24, 40, True, "silu"),           # k=2, ragged d, f
             (4, 1, 1, 16, 100, 70, False, "gelu"),         # capacity 1
             (2, 1, 1, 1, 8, 8, True, "gelu"),              # one token
             (8, 1, 20, 64, 1000, 600, True, "silu")]       # 16-row tiles, d > 512
    for E, k, cap, T, d, f, gated, act in cases:
        t, r = _gpu_case(dev, E, k, cap, T, d, f, gated, dtype)
        args = (t["x"], t["w_in"], t["w_gate"], t["w_out"], r["topk_w"], r["keep"],
                r["slot_token"], r["slot_valid"], r["token_slot"])
        got = moe_megakernel.fused_moe(*args, act=act)
        wcomb = (r["topk_w"] * r["keep"]).float()
        want = ref.fused_moe_f32_ref(t["x"], t["w_in"], t["w_gate"], t["w_out"], wcomb,
                                     r["slot_token"], r["slot_valid"],
                                     r["token_slot"].clamp(0, E * cap - 1), act)
        torch.cuda.synchronize()
        atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1.6e-2)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    t, r = _gpu_case(dev, 4, 2, 8, 24, 16, 16, True, dtype, keep_none=True)
    got = moe_megakernel.fused_moe(t["x"], t["w_in"], t["w_gate"], t["w_out"],
                                   r["topk_w"], r["keep"], r["slot_token"],
                                   r["slot_valid"], r["token_slot"])
    assert float(got.abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_fused_backend_grads_match_oracle():
    dev = _card()
    tcfg = reduced(get_config("zcode-m3-base"))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, jitter_eps=0.0))
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name in ("oracle", "cuda_fused"):
        g.manual_seed(0)
        p = {"router": {"w": torch.randn(tcfg.d_model, 4, generator=g, device=dev)},
             "experts": {"w_in": torch.randn(4, tcfg.d_model, 256, generator=g,
                                             device=dev) * 0.05,
                         "w_out": torch.randn(4, 256, tcfg.d_model, generator=g,
                                              device=dev) * 0.05}}
        x = torch.randn(64, tcfg.d_model, generator=g, device=dev).requires_grad_(True)
        leaves = [p["router"]["w"], p["experts"]["w_in"], p["experts"]["w_out"]]
        for leaf in leaves:
            leaf.requires_grad_(True)
        y, _ = port_backend.get_backend(name)(p, x, tcfg, decision=False)
        (y ** 2).sum().backward()
        out[name] = [y.detach(), x.grad] + [leaf.grad for leaf in leaves]
    for a, b in zip(out["oracle"], out["cuda_fused"]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_train_steps_match_oracle_and_count_launches():
    """Three steps of reduced zcode-m3-base with remat on, both kernel
    backends against the plain oracle on the card, f32: losses within
    1e-4, parameters within 2e-4 (Adam's sign-like first steps: an entry
    whose gradient is at rounding level may move by up to lr per step).
    Launches per step: B4 twice per MoE layer (forward and remat
    recompute); the pipeline's kernels twice per layer, B1's backward
    kernels once per GEMM."""
    dev = _card()
    from repro_torch.configs import TrainConfig
    from repro_torch.data import MTTaskConfig, MultilingualMT
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_model
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.steps import n_moe_layers
    from repro_torch.tree import flatten_with_paths
    base = dataclasses.replace(reduced(get_config("zcode-m3-base")), remat=True)
    n_steps = 3
    tc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=n_steps)
    batches = MultilingualMT(MTTaskConfig(vocab=base.vocab, n_langs=4,
                                          max_len=16)).train_batches(4)
    n = n_moe_layers(base)
    out = {}
    for backend in ("oracle", "cuda_fused", "cuda"):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, backend=backend))
        params = init_model(torch.Generator(device=dev).manual_seed(0), cfg)
        state = init_train_state(params, tc)
        step = make_train_step(cfg, tc)
        losses = []
        for i in range(n_steps):
            reset_launch_counts()
            state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                    for k, v in batches(i).items()})
            torch.cuda.synchronize()
            losses.append(float(m["loss"]))
            c = launch_counts()
            if backend == "cuda_fused":
                assert c["fused_moe"] == 2 * n and c["grouped_matmul"] == 0, c
            if backend == "cuda":
                assert (c["dispatch"], c["combine"], c["grouped_matmul"],
                        c["grouped_matmul_dx"], c["grouped_matmul_dw"]) == (
                            2 * n, 2 * n, 4 * n, 2 * n, 2 * n), c
        out[backend] = (losses, flatten_with_paths(state["params"]))
    for backend in ("cuda_fused", "cuda"):
        np.testing.assert_allclose(out[backend][0], out["oracle"][0], atol=1e-4)
        for key, t in out[backend][1].items():
            torch.testing.assert_close(t, out["oracle"][1][key], atol=2e-4, rtol=0)
