"""Port kernels (src/repro_torch/kernels) against the JAX package's Pallas
kernels run in interpret mode: same numpy inputs through both, on the
CPU, where each port wrapper takes its plain PyTorch version. The
``cuda``-marked tests hold each CUDA kernel against that plain version on
the card and skip without one.

Tolerances: f32 1e-5 (sums in another order); bf16 outputs within 1e-2
+ 1.6e-2 * |ref|, about two bf16 ulps, since an f32 sum that differs in
its last bits can round to the neighbouring bf16 value.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (build, flash_decode, grouped_ffn,  # noqa: E402
                                 launch_counts, moe_dispatch, ops, ref,
                                 reset_launch_counts)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels, imported here and not at module level so
    that the ``cuda`` tests run where JAX is not installed (the GPU
    machine; run there with ``--noconftest``)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro import kernels
    from repro.kernels import moe_dispatch as md
    from repro.kernels import ops as jops
    return types.SimpleNamespace(jax=jax, jnp=jnp, flash_decode=kernels.flash_decode,
                                 grouped_matmul=kernels.grouped_matmul,
                                 dispatch=md.dispatch, combine=md.combine,
                                 expert_ffn_op=jops.expert_ffn_op)


def _pair(jx, a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jx.jnp.asarray(a).astype(getattr(jx.jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype)))


def _close(out, want, dtype: str):
    out = out.float().numpy() if torch.is_tensor(out) else np.asarray(out, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(out, want, atol=1e-2, rtol=1.6e-2)


# ---------------------------------------------------------------------------
# B1 grouped matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,c,d,f", [(2, 1, 64, 128),     # C = 1: decode
                                     (3, 5, 100, 70),     # non-divisible d, f
                                     (2, 24, 32, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_matches_pallas(e, c, d, f, dtype, jx):
    rs = np.random.RandomState(0)
    ja, tx = _pair(jx, rs.randn(e, c, d).astype(np.float32), dtype)
    jw, tw = _pair(jx, (rs.randn(e, d, f) * d ** -0.5).astype(np.float32), dtype)
    want = jx.grouped_matmul(ja, jw, interpret=True)
    got = grouped_ffn.grouped_matmul(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (e, c, f)
    _close(got, want, dtype)


def test_expert_ffn_op_matches_pallas(jx):
    rs = np.random.RandomState(1)
    e, c, d, f = 3, 4, 32, 48
    buf = rs.randn(e, c, d).astype(np.float32)
    w_in = (rs.randn(e, d, f) * 0.2).astype(np.float32)
    w_out = (rs.randn(e, f, d) * 0.2).astype(np.float32)
    for act in ("gelu", "silu"):
        want = jx.expert_ffn_op(jx.jnp.asarray(buf), jx.jnp.asarray(w_in), None,
                                jx.jnp.asarray(w_out), act, interpret=True)
        got = ops.expert_ffn_op(torch.from_numpy(buf), torch.from_numpy(w_in),
                                None, torch.from_numpy(w_out), act)
        _close(got, want, "float32")


# ---------------------------------------------------------------------------
# B2 dispatch, B3 combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,s,d,valid_p", [(16, 24, 64, 0.7),
                                           (8, 4, 37, 0.5),    # capacity 1
                                           (6, 8, 40, 0.0)])   # all dropped
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_matches_pallas(t, s, d, valid_p, dtype, jx):
    rs = np.random.RandomState(2)
    ja, tx = _pair(jx, rs.randn(t, d).astype(np.float32), dtype)
    st = rs.randint(-1, t + 2, size=s).astype(np.int32)   # clipped by both
    sv = rs.rand(s) < valid_p
    want = jx.dispatch(ja, jx.jnp.asarray(st), jx.jnp.asarray(sv), interpret=True)
    got = moe_dispatch.dispatch(tx, torch.from_numpy(st), torch.from_numpy(sv))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("t,k,s,d,keep_p", [(12, 1, 16, 64, 0.8),
                                            (10, 2, 12, 37, 0.8),   # k=2
                                            (5, 2, 6, 32, 0.0)])    # all dropped
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_matches_pallas(t, k, s, d, keep_p, dtype, jx):
    rs = np.random.RandomState(3)
    jb, tb = _pair(jx, rs.randn(s, d).astype(np.float32), dtype)
    ts = rs.randint(0, s, size=(t, k)).astype(np.int32)
    w = rs.rand(t, k).astype(np.float32)
    keep = rs.rand(t, k) < keep_p
    want = jx.combine(jb, jx.jnp.asarray(ts), jx.jnp.asarray(w),
                      jx.jnp.asarray(keep), interpret=True)
    got = moe_dispatch.combine(tb, torch.from_numpy(ts), torch.from_numpy(w),
                               torch.from_numpy(keep))
    assert got.dtype == tb.dtype
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# gradients: the autograd.Functions against jax.grad through the Pallas VJPs
# ---------------------------------------------------------------------------

def _jax_grad(jx, fn, args, r, argnums):
    """jax.grad of sum(fn(*args) * r) in f32."""
    jnp = jx.jnp
    return jx.jax.grad(lambda *a: (fn(*a).astype(jnp.float32) * jnp.asarray(r)).sum(),
                       argnums=argnums)(*args)


def _torch_grad(out, r, leaves):
    (out.float() * torch.from_numpy(r)).sum().backward()
    return [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("e,c,d,f", [(2, 1, 64, 128), (3, 5, 100, 70)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_grads_match_pallas_vjp(e, c, d, f, dtype, jx):
    """dx = dy @ w^T and dw = x^T @ dy (the card's grouped_matmul_dx/_dw)
    against the reference's _gmm_bwd, the Pallas kernel on swapped axes."""
    rs = np.random.RandomState(5)
    ja, tx = _pair(jx, rs.randn(e, c, d).astype(np.float32), dtype)
    jw, tw = _pair(jx, (rs.randn(e, d, f) * d ** -0.5).astype(np.float32), dtype)
    r = rs.randn(e, c, f).astype(np.float32)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    y = grouped_ffn.grouped_matmul(tx, tw)
    assert type(y.grad_fn).__name__ == "_GroupedMatmulBackward"
    got = _torch_grad(y, r, [tx, tw])
    want = _jax_grad(jx, lambda a, b: jx.grouped_matmul(a, b, interpret=True),
                     (ja, jw), r, (0, 1))
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, dtype)


@pytest.mark.parametrize("t,s,valid_p", [(16, 24, 0.7), (6, 8, 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_grads_match_pallas_vjp(t, s, valid_p, dtype, jx):
    """Scatter-add of dy rows onto their tokens in f32, masked by the
    slot's validity (the reference's _dispatch_bwd)."""
    rs = np.random.RandomState(6)
    d = 40
    ja, tx = _pair(jx, rs.randn(t, d).astype(np.float32), dtype)
    st = rs.randint(-1, t + 2, size=s).astype(np.int32)
    sv = rs.rand(s) < valid_p
    r = rs.randn(s, d).astype(np.float32)
    tx.requires_grad_(True)
    y = moe_dispatch.dispatch(tx, torch.from_numpy(st), torch.from_numpy(sv))
    assert type(y.grad_fn).__name__ == "_DispatchBackward"
    (got,) = _torch_grad(y, r, [tx])
    (want,) = _jax_grad(jx, lambda a: jx.dispatch(a, jx.jnp.asarray(st), jx.jnp.asarray(sv),
                                                  interpret=True), (ja,), r, (0,))
    _close(got, want, dtype)


@pytest.mark.parametrize("t,k,s,keep_p", [(12, 1, 16, 0.8), (10, 2, 12, 0.8),
                                          (5, 2, 6, 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_grads_match_pallas_vjp(t, k, s, keep_p, dtype, jx):
    """dbuf (scatter of w * dy) and d weights (<dy, buf[slot]>, through
    w = weights * keep) against the reference's _combine_bwd."""
    rs = np.random.RandomState(7)
    d = 37
    jb, tb = _pair(jx, rs.randn(s, d).astype(np.float32), dtype)
    ts = rs.randint(0, s, size=(t, k)).astype(np.int32)
    w = rs.rand(t, k).astype(np.float32)
    keep = rs.rand(t, k) < keep_p
    r = rs.randn(t, d).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_(True)
    tb.requires_grad_(True)
    y = moe_dispatch.combine(tb, torch.from_numpy(ts), tw, torch.from_numpy(keep))
    assert type(y.grad_fn).__name__ == "_CombineBackward"
    got = _torch_grad(y, r, [tb, tw])
    jnp = jx.jnp
    want = _jax_grad(jx, lambda b, w_: jx.combine(b, jnp.asarray(ts), w_, jnp.asarray(keep),
                                                  interpret=True),
                     (jb, jnp.asarray(w)), r, (0, 1))
    _close(got[0], want[0], dtype)
    _close(got[1], want[1], "float32" if dtype == "float32" else dtype)


def test_flash_decode_raises_under_grad():
    """Decode only, no backward: under grad it raises instead of returning
    a tensor cut off from autograd; without grad it runs."""
    q = torch.randn(1, 2, 8, requires_grad=True)
    kv = torch.randn(1, 4, 2, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_decode.flash_decode(q, kv, kv, 3)
    with torch.no_grad():
        assert flash_decode.flash_decode(q, kv, kv, 3).shape == (1, 2, 8)
    assert flash_decode.flash_decode(q.detach(), kv, kv, 3).grad_fn is None


# ---------------------------------------------------------------------------
# B5 flash decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,kv,hd,s", [(8, 8, 64, 40), (8, 2, 32, 96),
                                       (4, 1, 40, 24)])
@pytest.mark.parametrize("index", ["zero", "mixed", "scalar"])
def test_flash_decode_matches_pallas(h, kv, hd, s, index, jx):
    rs = np.random.RandomState(4)
    b = 3
    q = rs.randn(b, h, hd).astype(np.float32)
    k = rs.randn(b, s, kv, hd).astype(np.float32)
    v = rs.randn(b, s, kv, hd).astype(np.float32)
    idx = {"zero": np.zeros(b, np.int32),
           "mixed": np.array([0, s // 2, s - 1], np.int32),
           "scalar": np.int32(s // 3)}[index]
    want = jx.flash_decode(jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v),
                           jx.jnp.asarray(idx), bs=16, interpret=True)
    got = flash_decode.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(np.asarray(idx)))
    _close(got, want, "float32")


def test_flash_decode_bf16_cache_matches_pallas(jx):
    """The serving path's mix: f32 queries against a bf16 cache."""
    rs = np.random.RandomState(5)
    b, h, kv, hd, s = 2, 4, 4, 32, 20
    q = rs.randn(b, h, hd).astype(np.float32)
    jk, tk = _pair(jx, rs.randn(b, s, kv, hd).astype(np.float32), "bfloat16")
    jv, tv = _pair(jx, rs.randn(b, s, kv, hd).astype(np.float32), "bfloat16")
    idx = np.array([3, 19], np.int32)
    want = jx.flash_decode(jx.jnp.asarray(q), jk, jv, jx.jnp.asarray(idx), bs=8,
                           interpret=True)
    got = flash_decode.flash_decode(torch.from_numpy(q), tk, tv,
                                    torch.from_numpy(idx))
    assert got.dtype == torch.float32
    _close(got, want, "float32")


def test_flash_decode_ignores_keys_past_index():
    rs = np.random.RandomState(6)
    q = torch.from_numpy(rs.randn(2, 2, 16).astype(np.float32))
    k = torch.from_numpy(rs.randn(2, 32, 1, 16).astype(np.float32))
    v = torch.from_numpy(rs.randn(2, 32, 1, 16).astype(np.float32))
    idx = torch.tensor([5, 20])
    o1 = flash_decode.flash_decode(q, k, v, idx)
    k2, v2 = k.clone(), v.clone()
    k2[0, 6:] = 99.0
    v2[1, 21:] = -99.0
    torch.testing.assert_close(flash_decode.flash_decode(q, k2, v2, idx), o1,
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# wrapper contract
# ---------------------------------------------------------------------------

def test_wrappers_check_inputs():
    x = torch.randn(4, 8)
    st = torch.zeros(3, dtype=torch.int32)
    sv = torch.ones(3, dtype=torch.bool)
    with pytest.raises(TypeError):
        moe_dispatch.dispatch(x, st.long(), sv)                 # int64 table
    with pytest.raises(TypeError):
        moe_dispatch.dispatch(x.double(), st, sv)               # dtype
    with pytest.raises(ValueError):
        moe_dispatch.dispatch(x.t(), st, sv)                    # non-contiguous
    with pytest.raises(ValueError):
        grouped_ffn.grouped_matmul(torch.randn(2, 3, 4), torch.randn(2, 5, 6))
    with pytest.raises(ValueError):
        flash_decode.flash_decode(torch.randn(1, 3, 8), torch.randn(1, 4, 2, 8),
                                  torch.randn(1, 4, 2, 8), 0)   # 3 % 2 heads
    # no silent fallback: a tensor that is neither on the CPU nor on a card
    # has no kernel and no plain path
    with pytest.raises(ValueError, match="no kernel"):
        moe_dispatch.dispatch(x.to("meta"), st.to("meta"), sv.to("meta"))


def test_cpu_path_never_launches_or_builds():
    reset_launch_counts()
    w = torch.randn(2, 4, 5, requires_grad=True)
    grouped_ffn.grouped_matmul(torch.randn(2, 3, 4), w).sum().backward()
    assert w.grad.shape == w.shape
    moe_dispatch.dispatch(torch.randn(4, 8), torch.zeros(3, dtype=torch.int32),
                          torch.ones(3, dtype=torch.bool))
    assert launch_counts() == {"dispatch": 0, "combine": 0,
                               "grouped_matmul": 0, "grouped_matmul_dx": 0,
                               "grouped_matmul_dw": 0, "fused_moe": 0,
                               "flash_decode": 0}
    assert build._lib is None
    assert {p.name for p in build.sources()} == {
        "moe_dispatch.cu", "grouped_ffn.cu", "flash_decode.cu", "errors.cu",
        "moe_megakernel.cu"}
    assert build.lib_path().parts[-4:-2] == ("build", "kernels")


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gpu_close(out, want):
    atol, rtol = (1e-4, 1e-4) if out.dtype == torch.float32 else (1e-2, 1.6e-2)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_grouped_matmul_matches_plain(dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    for e, c, d, f in ((128, 1, 512, 2048), (4, 5, 100, 70), (2, 100, 130, 200)):
        x = torch.randn(e, c, d, generator=g, device=dev).to(dtype)
        w = (torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5).to(dtype)
        _gpu_close(grouped_ffn.grouped_matmul(x, w), ref.grouped_matmul_ref(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dispatch_matches_plain(dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    for t, s, d in ((256, 512, 512), (9, 4, 37), (50, 40, 100)):
        x = torch.randn(t, d, generator=g, device=dev).to(dtype)
        st = torch.randint(-1, t + 2, (s,), generator=g, device=dev,
                           dtype=torch.int32)
        sv = torch.rand(s, generator=g, device=dev) < 0.7
        assert torch.equal(moe_dispatch.dispatch(x, st, sv),
                           ref.dispatch_ref(x, st, sv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_combine_matches_plain(dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    for t, k, s, d in ((256, 1, 512, 512), (32, 2, 48, 100), (7, 2, 5, 64)):
        buf = torch.randn(s, d, generator=g, device=dev).to(dtype)
        ts = torch.randint(0, s, (t, k), generator=g, device=dev, dtype=torch.int32)
        w = torch.rand(t, k, generator=g, device=dev)
        keep = torch.rand(t, k, generator=g, device=dev) < 0.8
        _gpu_close(moe_dispatch.combine(buf, ts, w, keep),
                   ref.combine_ref(buf, ts, w, keep))


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.float32, torch.bfloat16),
                                      (torch.bfloat16, torch.bfloat16)])
def test_cuda_flash_decode_matches_plain(qdt, kvdt):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    for b, h, kv, s, hd in ((8, 8, 8, 64, 64), (3, 8, 2, 300, 128), (2, 8, 1, 1000, 40)):
        q = torch.randn(b, h, hd, generator=g, device=dev).to(qdt)
        k = torch.randn(b, s, kv, hd, generator=g, device=dev).to(kvdt)
        v = torch.randn(b, s, kv, hd, generator=g, device=dev).to(kvdt)
        idx = torch.randint(0, s, (b,), generator=g, device=dev)
        idx[0] = 0
        _gpu_close(flash_decode.flash_decode(q, k, v, idx),
                   ref.flash_decode_ref(q, k, v, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_grouped_matmul_bwd_matches_plain(dtype):
    """The two backward kernels at the training site (C = 8) and ragged
    shapes, and the Function's backward launching them."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    for e, c, d, f in ((128, 8, 512, 2048), (4, 1, 100, 70), (3, 17, 130, 200)):
        x = torch.randn(e, c, d, generator=g, device=dev).to(dtype)
        w = (torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5).to(dtype)
        dy = torch.randn(e, c, f, generator=g, device=dev).to(dtype)
        _gpu_close(grouped_ffn.grouped_matmul_dx(dy, w), ref.grouped_matmul_dx_ref(dy, w))
        _gpu_close(grouped_ffn.grouped_matmul_dw(x, dy), ref.grouped_matmul_dw_ref(x, dy))
    reset_launch_counts()
    x.requires_grad_(True)
    w.requires_grad_(True)
    grouped_ffn.grouped_matmul(x, w).backward(dy)
    assert (grouped_ffn.grouped_matmul_dx.launches,
            grouped_ffn.grouped_matmul_dw.launches) == (1, 1)
    _gpu_close(x.grad, ref.grouped_matmul_dx_ref(dy, w.detach()))
    _gpu_close(w.grad, ref.grouped_matmul_dw_ref(x.detach(), dy))
