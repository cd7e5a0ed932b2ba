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


def test_fused_moe_variant_choice():
    """``moe_megakernel.variant``, as ``grouped_ffn.variant`` for B1:
    streaming at 1 <= C <= 16 with rows of d and f of whole 16-byte words
    and x, w_in, w_gate, w_out 16-byte aligned (every call on the main
    path: C = 1, 4, 8 at d = 512, f = 2048, f32), tiled past C = 16, on
    rows that are not whole words, and on a view off a 16-byte boundary."""
    v = moe_megakernel.variant
    for c in (1, 4, 8, 12, 16):
        assert v(c, 512, 2048, 4) == "streaming"
    assert v(0, 512, 2048, 4) == v(17, 512, 2048, 4) == v(20, 1000, 600, 4) == "tiled"
    assert v(8, 24, 40, 4) == v(8, 24, 40, 2) == "streaming"   # 96 / 160 and 48 / 80 bytes
    assert v(1, 100, 70, 4) == "tiled"                         # rows of f: 280 bytes
    assert v(8, 100, 64, 2) == "tiled"                         # rows of d: 200 bytes
    assert v(8, 100, 64, 4) == "streaming"                     # rows of d: 400 bytes
    base = torch.zeros(1 + 16 * 64)
    x = base[1:].reshape(16, 64)                               # 4 bytes off
    w_in, w_out = torch.zeros(4, 64, 32), torch.zeros(4, 32, 64)
    w_gate = torch.zeros(1 + 4 * 64 * 32)[1:].reshape(4, 64, 32)
    ptrs = (w_in.data_ptr(), w_out.data_ptr())
    assert v(4, 64, 32, 4, base.data_ptr(), *ptrs) == "streaming"
    assert v(4, 64, 32, 4, x.data_ptr(), *ptrs) == "tiled"
    assert v(4, 64, 32, 4, base.data_ptr(), *ptrs, w_gate.data_ptr()) == "tiled"


# (E, C, d, f) of the tiled kernel: dbrx-132b's prefill and long prefill,
# deepseek-v3-671b's long prefill (PERF.md's kernel table), the ragged
# cases of the card tests
_TILED_SITES = [(16, 128, 6144, 10752), (16, 1152, 6144, 10752), (256, 128, 7168, 2048),
                (4, 40, 1100, 300), (8, 300, 1030, 520), (16, 20, 1100, 200),
                (256, 2048, 7168, 2048)]     # deepseek-v3-671b at 32k tokens, top-8


@pytest.mark.parametrize("e,c,d,f", _TILED_SITES)
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("gated", [False, True])
def test_fused_moe_tiled_plan(e, c, d, f, itemsize, gated):
    """``tiled_plan``: shared memory within an H100 block's 232,448 B (the
    ring sized for the larger phase, then the unit tables), the f32 h
    workspace E * C * f * 4 bytes, one count per unit of 64 slot rows plus
    the item counter, and the items per live unit of each phase (256
    columns; gated phase-A items cover 128 columns of w_gate and the same
    128 of w_in)."""
    plan = moe_megakernel.tiled_plan(e, c, d, f, itemsize, gated)
    rt = -(-c // 64)
    assert plan["row_tiles"] == rt
    assert plan["smem_bytes"] <= moe_megakernel.SMEM_MAX
    assert plan["workspace_bytes"] == e * c * f * 4
    assert plan["counts"] == e * rt + 1
    assert plan["items_per_unit"] == (-(-f // (128 if gated else 256)), -(-d // 256))
    assert plan["threads"] == 256


@pytest.mark.parametrize("k", [1, 2])
def test_live_experts_hold_a_kept_slot(k):
    """The kernels skip an expert none of whose slots carries weight
    (``live_experts``); with softmax top-k weights, which are positive,
    those are the experts holding no kept slot, the ones chip_smoke's
    bound leaves out. All dropped: no expert is live."""
    E, cap = 16, 2
    _, routing = make_case(E, k, cap, 24, 8, 8, seed=k)
    r = {n: torch.from_numpy(v) for n, v in routing.items()}
    live = moe_megakernel.live_experts(r["topk_w"], r["keep"], r["token_slot"], E, E * cap)
    assert torch.equal(live, r["slot_valid"].reshape(E, cap).any(1))
    assert 0 < int(live.sum()) < E
    none = moe_megakernel.live_experts(r["topk_w"], torch.zeros_like(r["keep"]),
                                       r["token_slot"], E, E * cap)
    assert not none.any()


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


def _took(args, act):
    """Runs the kernel once; (output, the variant it took by its counters)."""
    before = moe_megakernel.fused_moe.launches_streaming
    got = moe_megakernel.fused_moe(*args, act=act)
    took = "streaming" if moe_megakernel.fused_moe.launches_streaming > before else "tiled"
    return got, took


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_moe_matches_plain(dtype):
    """Each case takes the variant ``moe_megakernel.variant`` names."""
    dev = _card()
    cases = [(128, 1, 8, 1024, 512, 2048, False, "gelu", "streaming"),   # training site
             (4, 2, 8, 37, 24, 40, True, "silu", "streaming"),   # k=2, ragged d, f
             (4, 1, 1, 16, 100, 70, False, "gelu", "tiled"),     # capacity 1, f ragged
             (2, 1, 1, 1, 8, 8, True, "gelu", "streaming"),      # one token
             (8, 1, 20, 64, 1000, 600, True, "silu", "tiled"),   # C = 20, d > 512
             (8, 2, 12, 40, 512, 2048, False, "gelu", "streaming")]   # C = 12
    for E, k, cap, T, d, f, gated, act, variant in cases:
        t, r = _gpu_case(dev, E, k, cap, T, d, f, gated, dtype)
        args = (t["x"], t["w_in"], t["w_gate"], t["w_out"], r["topk_w"], r["keep"],
                r["slot_token"], r["slot_valid"], r["token_slot"])
        got, took = _took(args, act)
        assert took == variant, (E, k, cap, T, d, f, dtype)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_moe_at_deepseek_widths_matches_plain(dtype):
    """deepseek-v3-671b's expert shapes: d 7,168, f 2,048, gated, sigmoid
    top-8 (32 of its 256 experts: the weights of all 256 take 45 GB in
    f32); 8 tokens at eval capacity 2.0 (C = 4, the streaming kernel, its
    f32 atomics adding 8 rows per token) and 256 (C = 128, the tiled kernel
    past d = 1,024); outputs against the plain version."""
    dev = _card()
    e, k, d, f = 32, 8, 7168, 2048
    g = torch.Generator(device=dev).manual_seed(7)
    w = {n: (torch.randn(shape, generator=g, device=dev) * shape[1] ** -0.5).to(dtype)
         for n, shape in (("w_in", (e, d, f)), ("w_gate", (e, d, f)), ("w_out", (e, f, d)))}
    wr = torch.randn(d, e, generator=g, device=dev) * d ** -0.5
    moe = MoEConfig(n_experts=e, top_k=k, router_type="sigmoid", jitter_eps=0.0)
    for t, variant in ((8, "streaming"), (256, "tiled")):
        x = torch.randn(t, d, generator=g, device=dev).to(dtype)
        cap = R.capacity(t, e, k, 2.0)
        info = R.dispatch_info(R.route(wr, x.float(), moe, is_training=False), e, cap)
        tables = ops.routing_tables(info, e, cap)
        args = (x, w["w_in"], w["w_gate"], w["w_out"], info.topk_w, info.keep,
                tables.slot_token, tables.slot_valid, tables.token_slot)
        got, took = _took(args, "silu")
        assert took == variant, (t, dtype)
        want = ref.fused_moe_f32_ref(x, w["w_in"], w["w_gate"], w["w_out"],
                                     (info.topk_w * info.keep).float(), tables.slot_token,
                                     tables.slot_valid,
                                     tables.token_slot.clamp(0, e * cap - 1), "silu")
        torch.cuda.synchronize()
        atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1.6e-2)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        assert int(info.keep.sum()) > t * k // 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("d", [1536, 6144])
def test_cuda_fused_moe_tiled_any_width(d, k, dtype):
    """B4's tiled kernel past d = 1,024: dbrx-132b's width 6,144 and 1,536
    (a ragged last 256-column tile of d), gated silu, small E and f, C = 40
    (one 64-row unit, cut ragged), against the plain version. The weights take the model's init scale (std d^-0.5 in,
    f^-0.5 out; ``make_case``'s 0.1 would put pre-activations at std 7.8
    at this width), so the outputs are O(1) as the f32 tolerance of sums
    in another order assumes."""
    dev = _card()
    t, r = _gpu_case(dev, 4, k, 40, 48, d, 1100, True, dtype)
    for name, fan_in in (("w_in", d), ("w_gate", d), ("w_out", 1100)):
        t[name] = (t[name].float() * (10.0 * fan_in ** -0.5)).to(dtype)
    args = (t["x"], t["w_in"], t["w_gate"], t["w_out"], r["topk_w"], r["keep"],
            r["slot_token"], r["slot_valid"], r["token_slot"])
    got, took = _took(args, "silu")
    assert took == "tiled"
    wcomb = (r["topk_w"] * r["keep"]).float()
    want = ref.fused_moe_f32_ref(t["x"], t["w_in"], t["w_gate"], t["w_out"], wcomb,
                                 r["slot_token"], r["slot_valid"],
                                 r["token_slot"].clamp(0, 4 * 40 - 1), "silu")
    torch.cuda.synchronize()
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1.6e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert float(want.abs().max()) > 0


# B4 calls on the tiled kernel (E, k, capacity, T, d, f, gated, act):
# chip_smoke.py's B4_TILED_RAGGED
_TILED_CASES = [(4, 1, 40, 100, 1100, 300, True, "silu"),
                (8, 4, 300, 256, 1030, 520, False, "gelu"),
                (4, 1, 130, 200, 520, 136, False, "silu"),
                (6, 4, 64, 60, 1100, 260, True, "gelu"),
                (16, 1, 20, 8, 1100, 200, True, "silu")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _TILED_CASES)
def test_cuda_fused_moe_tiled_matches_plain(case, dtype):
    """B4's tiled kernel at C > 16: one to five 64-row units of slots, top-1
    and top-4, gated and not, gelu and silu, d past 1,024 and d, f off the
    256-column tiles, against the plain version (weights at the model's init
    scale); at top-1 the same bits on a second run and after CUDA-graph
    replays; NaN in the unrouted experts' weights changes nothing (bitwise
    at top-1: they are never read)."""
    E, k, cap, T, d, f, gated, act = case
    dev = _card()
    t, r = _gpu_case(dev, E, k, cap, T, d, f, gated, dtype, seed=9)
    for name, fan_in in (("w_in", d), ("w_gate", d), ("w_out", f)):
        if t[name] is not None:
            t[name] = (t[name].float() * (10.0 * fan_in ** -0.5)).to(dtype)
    args = [t["x"], t["w_in"], t["w_gate"], t["w_out"], r["topk_w"], r["keep"],
            r["slot_token"], r["slot_valid"], r["token_slot"]]
    got, took = _took(args, act)
    assert took == "tiled"
    wcomb = (r["topk_w"] * r["keep"]).float()
    want = ref.fused_moe_f32_ref(*args[:4], wcomb, r["slot_token"], r["slot_valid"],
                                 r["token_slot"].clamp(0, E * cap - 1), act)
    torch.cuda.synchronize()
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1.6e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert float(want.abs().max()) > 0
    if k == 1:
        assert torch.equal(got, moe_megakernel.fused_moe(*args, act=act))
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            moe_megakernel.fused_moe(*args, act=act)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = moe_megakernel.fused_moe(*args, act=act)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, got)
    live = moe_megakernel.live_experts(r["topk_w"], r["keep"], r["token_slot"], E, E * cap)
    if not bool(live.all()):
        for i in (1, 2, 3):
            if args[i] is not None:
                args[i] = args[i].clone()
                args[i][~live] = float("nan")
        poisoned = moe_megakernel.fused_moe(*args, act=act)
        if k == 1:
            assert torch.equal(poisoned, got)
        else:
            torch.testing.assert_close(poisoned.float(), got.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_fused_moe_tiled_resources():
    """The tiled kernel's instances report the shared memory ``tiled_plan``
    gives (128 experts of C slots) and spill nothing."""
    _card()
    for kind in ("tiled", "tiled_gated"):
        for dtype in (torch.float32, torch.bfloat16):
            for c in (128, 1152):
                plan = moe_megakernel.tiled_plan(128, c, 512, 512, dtype.itemsize,
                                                 kind == "tiled_gated")
                for vec in (True, False):
                    info = moe_megakernel.variant_info(kind, dtype, c, vec)
                    assert info["smem_bytes"] == plan["smem_bytes"], (kind, dtype, c, info)
                    assert info["spill_bytes"] == 0, (kind, dtype, c, vec, info)
                    assert info["blocks_per_sm"] >= 1, info


@pytest.mark.cuda
@pytest.mark.parametrize("balanced", [False, True])
def test_cuda_fused_moe_streaming_skips_unrouted_and_replays(balanced):
    """The streaming kernel at full width (E = 128, d = 512, f = 2048, C =
    8, f32): against the plain version; the same bits on a second run and
    after CUDA-graph replays (top-1: an output element takes two additions
    onto zero, whose sum does not depend on their order, and every call
    zeroes the per-expert counts with the output); with 64 tokens most
    experts are unrouted, and NaN in their weights changes no bit (they
    are never read). Balanced: every expert holds 8 kept slots."""
    dev = _card()
    E, cap, T, d, f = 128, 8, (1024 if balanced else 64), 512, 2048
    t, r = _gpu_case(dev, E, 1, cap, T, d, f, False, torch.float32, seed=4)
    if balanced:
        slots = torch.arange(E * cap, dtype=torch.int32, device=dev)
        r = {"topk_w": torch.rand(T, 1, device=dev) + 0.1,
             "keep": torch.ones(T, 1, dtype=torch.bool, device=dev),
             "slot_token": slots, "slot_valid": torch.ones(E * cap, dtype=torch.bool,
                                                           device=dev),
             "token_slot": slots[:, None].clone()}
    args = [t["x"], t["w_in"], None, t["w_out"], r["topk_w"], r["keep"], r["slot_token"],
            r["slot_valid"], r["token_slot"]]
    got, took = _took(args, "gelu")
    assert took == "streaming"
    want = ref.fused_moe_f32_ref(*args[:4], (r["topk_w"] * r["keep"]).float(),
                                 *args[6:], "gelu")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, moe_megakernel.fused_moe(*args, act="gelu"))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe_megakernel.fused_moe(*args, act="gelu")
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = moe_megakernel.fused_moe(*args, act="gelu")
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)
    live = moe_megakernel.live_experts(r["topk_w"], r["keep"], r["token_slot"], E, E * cap)
    assert bool(live.all()) == balanced
    if not balanced:
        args[1], args[3] = t["w_in"].clone(), t["w_out"].clone()
        args[1][~live] = float("nan")
        args[3][~live] = float("nan")
        assert torch.equal(moe_megakernel.fused_moe(*args, act="gelu"), got)


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
