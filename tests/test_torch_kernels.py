"""Port kernels (src/repro_torch/kernels) against the JAX package's Pallas
kernels run in interpret mode: same numpy inputs through both, on the
CPU, where each port wrapper takes its plain PyTorch version. The
``cuda``-marked tests hold each CUDA kernel against that plain version on
the card and skip without one.

Tolerances: f32 1e-5 (sums in another order); bf16 outputs within 1e-2
+ 1.6e-2 * |ref|, about two bf16 ulps, since an f32 sum that differs in
its last bits can round to the neighbouring bf16 value.
"""
import ctypes
import inspect
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (build, flash_decode, grouped_ffn,  # noqa: E402
                                 launch_counts, moe_dispatch, ops, ref,
                                 reset_launch_counts, streaming_counts)


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


# (C, d, f, element bytes, operand addresses) -> the B1 kernel on the card.
# The main path: decode (C = 1, and the scheduler's 9 rows at capacity 2.0
# give C = 1), prefill (C = 4) and training (C = 8), f32 weights, both
# products of the expert FFN, and dx at both training sites (operands dy,
# w, dx); then what must stay on the tiled kernel.
_VARIANT_CASES = [
    ((1, 2048, 512, 4, 0, 256, 512), "streaming"),       # decode, w_out
    ((1, 512, 2048, 4, 0, 256, 512), "streaming"),       # decode, w_in
    ((4, 512, 2048, 4, 0, 256, 512), "streaming"),       # prefill
    ((8, 2048, 512, 4, 0, 256, 512), "streaming"),       # training
    ((8, 2048, 512, 4, 0, 4096, 8192), "streaming"),     # dx, down: dy (128,8,512), w (128,2048,512)
    ((8, 512, 2048, 4, 0, 4096, 8192), "streaming"),     # dx, up: dy (128,8,2048), w (128,512,2048)
    ((16, 512, 2048, 2, 0, 256, 512), "streaming"),      # bf16, C = 16
    ((5, 96, 64, 4), "streaming"),                       # ragged stage and slab
    ((17, 2048, 512, 4), "tiled"),                       # C = 17
    ((100, 130, 200, 4), "tiled"),                       # C = 100, d = 130
    ((5, 100, 70, 4), "tiled"),                          # f = 70: 280-byte rows
    ((17, 130, 200, 4), "tiled"),                        # d = 130: 520-byte rows
    ((5, 100, 64, 2), "tiled"),                          # bf16 d = 100: 200-byte rows
    ((1, 2048, 512, 4, 0, 260, 512), "tiled"),           # a misaligned operand
    ((0, 2048, 512, 4), "tiled"),                        # no rows
]


@pytest.mark.parametrize("args,want", _VARIANT_CASES)
def test_grouped_matmul_variant_choice(args, want):
    assert grouped_ffn.variant(*args) == want


def test_grouped_matmul_variant_of_views():
    """A view whose first element is off a 16-byte boundary must not take
    the streaming kernel's bulk copies; the CPU path counts no launch,
    forward, dx or dw."""
    base = torch.randn(1 + 2 * 4 * 64)
    x = base[1:].reshape(2, 4, 64)
    w = torch.randn(2, 64, 32)
    assert grouped_ffn.variant(4, 64, 32, 4, x.data_ptr(), w.data_ptr()) == "tiled"
    assert grouped_ffn.variant(4, 64, 32, 4, base.data_ptr(), w.data_ptr()) \
        == "streaming"
    dy = base[1:1 + 2 * 4 * 32].reshape(2, 4, 32)       # dx's dy, off a boundary
    assert grouped_ffn.variant(4, 64, 32, 4, dy.data_ptr(), w.data_ptr()) == "tiled"
    reset_launch_counts()
    torch.testing.assert_close(grouped_ffn.grouped_matmul(x, w),
                               ref.grouped_matmul_ref(x, w))
    torch.testing.assert_close(grouped_ffn.grouped_matmul_dx(dy, w),
                               ref.grouped_matmul_dx_ref(dy, w))
    torch.testing.assert_close(grouped_ffn.grouped_matmul_dw(x, dy),
                               ref.grouped_matmul_dw_ref(x, dy))
    assert streaming_counts() == {"grouped_matmul": 0, "grouped_matmul_dx": 0,
                                  "grouped_matmul_dw": 0}


# The tiled kernel's (E, C, d, f) at every C > 16 site of PERF.md's kernel
# table (dbrx-132b's prefills, both products of its FFN; deepseek-v3-671b's
# long prefill, both products) and at chip_smoke.py's ragged tiled shapes.
_TILED_SITES = [(16, 128, 6144, 10752), (16, 1152, 6144, 10752), (16, 1152, 10752, 6144),
                (256, 128, 7168, 2048), (256, 128, 2048, 7168), (2, 17, 1030, 130),
                (3, 100, 136, 260), (2, 300, 260, 72)]


@pytest.mark.parametrize("kind", ["fwd", "dx", "dw"])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_grouped_matmul_tiled_plan_fits_a_block(kind, itemsize):
    """``tiled_plan``: the GEMM each product runs, a grid of 128 x 128
    tiles (row tiles fastest), and a ring of 4 stages whose shared memory
    fits an H100 block (232,448 B) at every width of the table."""
    for e, c, d, f in _TILED_SITES:
        plan = grouped_ffn.tiled_plan(kind, e, c, d, f, itemsize)
        m, k, n = {"fwd": (c, d, f), "dx": (c, f, d), "dw": (d, c, f)}[kind]
        assert plan["gemm"] == (m, k, n)
        assert plan["grid"] == (-(-m // 128), -(-n // 128), e)
        assert plan["threads"] == 256 and plan["tile"] == (128, 128, 32)
        assert plan["stages"] == 4
        assert plan["smem_bytes"] <= grouped_ffn.SMEM_MAX
    # a k-contiguous operand: 128 rows of 32 + 16 bytes; else 32 rows of 128
    kc = 128 * (32 + 16 // itemsize) * itemsize
    mn = 32 * 128 * itemsize
    ring = {"fwd": kc + mn, "dx": 2 * kc, "dw": 2 * mn}[kind]
    assert plan["smem_bytes"] == plan["stages"] * ring


@pytest.mark.parametrize("args,want", [
    ((6144, 10752, 4, 0, 256, 512), True),        # dbrx-132b's prefill, f32
    ((7168, 2048, 2, 0, 256, 512), True),         # deepseek-v3-671b's, bf16
    ((130, 200, 4), False),                       # rows of d: 520 bytes
    ((136, 260, 2), False),                       # bf16 rows of f: 520 bytes
    ((64, 96, 4, 4, 256, 512), False),            # a view 4 bytes off
])
def test_grouped_matmul_tiled_vec(args, want):
    """The tiled kernel moves 16-byte words where rows of d and f are whole
    words and every operand is 16-byte aligned (any C), else elements."""
    assert grouped_ffn.tiled_vec(*args) == want


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
                                            (5, 2, 6, 32, 0.0),     # all dropped
                                            (8, 8, 64, 1024, 0.9)])  # decode, wide rows
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


@pytest.mark.parametrize("t,k,d,itemsize,sms,cols", [
    (8, 8, 7168, 2, 132, True),      # deepseek-v3-671b decode: 7 passes a warp on rows
    (8, 4, 6144, 2, 132, True),      # dbrx-132b decode
    (256, 4, 6144, 2, 132, True),    # dbrx-132b prefill: 2 warps an SM on rows
    (527, 4, 6144, 2, 132, True),
    (528, 4, 6144, 2, 132, False),   # 4 warps an SM
    (2304, 4, 6144, 2, 132, False),  # dbrx-132b long prefill
    (2048, 8, 7168, 2, 132, True),   # deepseek-v3-671b long prefill: k in two steps on rows
    (2048, 5, 7168, 2, 132, True),
    (8, 2, 1024, 4, 132, True),      # f32 rows past one pass
    (1024, 1, 512, 4, 132, False),   # zcode's training site: a row in one pass
    (256, 1, 512, 2, 132, False),    # zcode's prefill
    (8, 1, 512, 2, 132, False),      # zcode's decode
    (8, 8, 1024, 2, 132, False),
    (64, 4, 6144, 2, 8, False),      # a small card, its warps filled
])
def test_combine_plan(t, k, d, itemsize, sms, cols):
    """Rows where a warp reads its row in one pass; else cols where the
    rows grid puts fewer than 4 warps on an SM or takes k rows in more
    than one step. From shapes alone: no table, weight or keep value."""
    import inspect
    assert moe_dispatch.combine_plan(t, k, d, itemsize, sms) is cols
    assert set(inspect.signature(moe_dispatch.combine_plan).parameters) == {
        "n_tokens", "k", "d", "itemsize", "sms"}


# ---------------------------------------------------------------------------
# gradients: the autograd.Functions against jax.grad through the Pallas VJPs
# ---------------------------------------------------------------------------

# B2's sites (PERF.md's kernel table): (label, slots, row bytes, words a
# thread, evict-first stores)
_DISPATCH_SITES = [("zcode-m3-base decode", 128, 1024, 1, False),
                   ("zcode-m3-base prefill", 512, 1024, 1, False),
                   ("zcode-m3-base training", 1024, 2048, 1, False),
                   ("dbrx-132b decode", 64, 12288, 2, False),
                   ("dbrx-132b prefill", 2048, 12288, 2, True),
                   ("dbrx-132b long prefill", 18432, 12288, 2, True),
                   ("deepseek-v3-671b decode", 256, 14336, 2, False),
                   ("deepseek-v3-671b long prefill", 32768, 14336, 2, True)]


@pytest.mark.parametrize("label,slots,row,per,stream", _DISPATCH_SITES)
def test_dispatch_plan_at_the_sites(label, slots, row, per, stream):
    """B2's plan from shapes alone (no tensor, no device, no state): two
    16-byte words a thread for rows past 4 KB, else one; evict-first
    stores for outputs of 16 MB or more (the wide-row models' prefills,
    never a decode or the training site); the same plan on every call and
    for any row the same width in another dtype."""
    assert moe_dispatch.dispatch_plan(slots, row) == (per, stream)
    assert moe_dispatch.dispatch_plan(slots, row) == (per, stream)
    assert list(inspect.signature(moe_dispatch.dispatch_plan).parameters) == [
        "n_slots", "row_bytes"]
    assert (per == 2) == (row > moe_dispatch.WIDE_ROW_BYTES)
    assert stream == (slots * row >= moe_dispatch.STREAM_BYTES)


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


def test_flash_decode_rep12_matches_pallas(jx):
    """starcoder2-3b's grouping: 24 query heads over 2 kv heads of 128 (rep
    12, past the 8 heads a kernel block takes, so two head groups on the
    card), B5 and B6 (pages of 4 in a permuted arena) against the
    reference's kernels in interpret mode. The CPU path takes the plain
    version before the kernel's shape checks."""
    from repro.kernels import flash_decode_paged as jpaged
    rs = np.random.RandomState(12)
    b, h, kv, hd, s, ps = 2, 24, 2, 128, 12, 4
    q = rs.randn(b, h, hd).astype(np.float32)
    k = rs.randn(b, s, kv, hd).astype(np.float32)
    v = rs.randn(b, s, kv, hd).astype(np.float32)
    idx = np.array([3, 11], np.int32)
    want = jx.flash_decode(jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v),
                           jx.jnp.asarray(idx), bs=4, interpret=True)
    got = flash_decode.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(idx))
    _close(got, want, "float32")
    nb = s // ps
    perm = rs.permutation(b * nb)
    ka = np.zeros((b * nb + 1, ps, kv, hd), np.float32)
    va = np.zeros_like(ka)
    ka[perm] = k.reshape(b * nb, ps, kv, hd)
    va[perm] = v.reshape(b * nb, ps, kv, hd)
    bt = perm.reshape(b, nb).astype(np.int32)
    want_p = jpaged(*(jx.jnp.asarray(a) for a in (q, ka, va, bt, idx)), interpret=True)
    got_p = flash_decode.flash_decode_paged(*(torch.from_numpy(a) for a in (q, ka, va, bt, idx)))
    _close(got_p, want_p, "float32")
    torch.testing.assert_close(got_p, got, atol=0, rtol=0)


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
# B5 and B6's split over the cache: the host's plan and the merge's math
# ---------------------------------------------------------------------------

_PLAN_CASES = [(1, 1, 1, 132), (34, 8, 8, 132), (96, 9, 8, 132), (191, 1, 1, 132),
               (192, 1, 1, 132), (300, 3, 2, 132), (1000, 2, 1, 132), (1024, 8, 8, 132),
               (1024, 8, 8, 114), (1025, 4, 8, 132), (4096, 64, 8, 132),
               (32768, 1, 1, 132), (32768, 64, 8, 132)]


@pytest.mark.parametrize("cap,rows,kv,sms", _PLAN_CASES)
def test_split_plan_covers_the_capacity(cap, rows, kv, sms):
    """Splits [i * per, (i + 1) * per) cover [0, cap) exactly, each a whole
    number of tiles, none empty; at most MAX_SPLIT_TILES tiles each."""
    n, per = flash_decode.split_plan(cap, rows, kv, sms)
    assert per % flash_decode.TILE == 0 and per >= flash_decode.TILE
    assert n * per >= cap > (n - 1) * per
    assert per <= flash_decode.MAX_SPLIT_TILES * flash_decode.TILE


def test_split_plan_at_the_serving_and_full_cache_shapes():
    """One split below 193 positions (the main path's 34-162-position
    caches: no workspace, no merge) on any card size and any grid;
    zcode's full 1,024-position cache over 8 rows of 8 kv heads takes 8
    splits of 128 on 132 SMs, and yi-6b's 3,586-position cache over 2 rows
    of 4 kv heads 29 of 128 (every range at MIN_SPLIT_TILES: 232 blocks)."""
    for cap in range(1, 193):
        for rows in (1, 2, 8, 9, 32):
            for kv in (1, 4, 5, 8):
                for sms in (1, 66, 114, 132, 1000):
                    assert flash_decode.split_plan(cap, rows, kv, sms) == (
                        1, -(-cap // flash_decode.TILE) * flash_decode.TILE)
    assert flash_decode.split_plan(193, 8, 8, 132)[0] == 2
    assert flash_decode.split_plan(1024, 8, 8, 132) == (8, 128)
    assert flash_decode.split_plan(3586, 2, 4, 132) == (29, 128)


@pytest.mark.parametrize("cap", [193, 1024, 3586, 7232, 32768])
def test_split_plan_ranges_fill_the_grid(cap):
    """Past 192 positions every range holds MIN_SPLIT_TILES tiles or more,
    and fewer tiles only where the grid already holds BLOCKS_PER_SM
    blocks per SM (or the range is at MAX_SPLIT_TILES)."""
    for rows, kv, sms in ((1, 1, 132), (2, 4, 132), (8, 8, 132), (64, 8, 132), (3, 4, 114)):
        n, per = flash_decode.split_plan(cap, rows, kv, sms)
        tiles = -(-cap // flash_decode.TILE)
        assert per >= flash_decode.MIN_SPLIT_TILES * flash_decode.TILE
        if per > flash_decode.MIN_SPLIT_TILES * flash_decode.TILE:
            smaller = per - flash_decode.TILE
            assert (-(-tiles * flash_decode.TILE // smaller) * rows * kv
                    > flash_decode.BLOCKS_PER_SM * sms
                    or per == flash_decode.MAX_SPLIT_TILES * flash_decode.TILE)


@pytest.mark.parametrize("rep,groups", [(1, 1), (5, 1), (8, 1), (9, 2), (12, 2), (16, 2), (17, 3)])
def test_split_plan_counts_head_groups(rep, groups):
    """A block takes up to HEAD_GROUP query heads of one kv head, so a
    launch at rep > 8 has head_groups(rep) blocks per (row, kv head,
    split), and the plan counts them as more (row, kv head) pairs: rep 12
    over 2 kv heads plans as 4 kv heads of one group."""
    assert flash_decode.head_groups(rep) == groups
    q = torch.empty(2, 2 * rep, 128, device="meta")
    k = torch.empty(2, 4096, 2, 128, device="meta", dtype=torch.bfloat16)
    assert (flash_decode.plan_of(q, k, sms=132)
            == flash_decode.split_plan(4096, 2, 2 * groups, 132)
            == flash_decode.split_plan(4096, 2, 2, 132, groups))


def test_address_check_flag_is_off_by_default_and_keys_the_build(monkeypatch):
    """REPRO_SMEM_CHECK=1 adds -DREPRO_SMEM_CHECK to the compile flags and
    so builds a library of its own (the flags are in its key); unset, the
    flags and the key are the default build's. The record's sites name the
    kernel's CheckSite values in order."""
    monkeypatch.delenv(build.CHECK_ENV, raising=False)
    default = build.lib_path()
    assert build.nvcc_flags() == build.NVCC_FLAGS
    monkeypatch.setenv(build.CHECK_ENV, "1")
    assert build.nvcc_flags() == (*build.NVCC_FLAGS, "-DREPRO_SMEM_CHECK")
    assert build.lib_path() != default
    monkeypatch.setenv(build.CHECK_ENV, "0")
    assert build.lib_path() == default
    src = (build.CSRC / "flash_decode.cu").read_text()
    enum = re.search(r"enum CheckSite : int \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"^\s*(kSite\w+)", enum, re.M)[0] == "kSiteCopyToShared"
    assert len(re.findall(r"^\s*kSite\w+", enum, re.M)) == len(flash_decode.CHECK_SITES)


@pytest.mark.parametrize("nb,ps", [(6, 16), (64, 16), (1024, 1), (300, 1), (16, 17), (5, 17)])
def test_split_plan_b5_equals_b6_and_reads_no_index(nb, ps):
    """B5 over S = nb * ps and B6 over nb pages of ps take the same plan,
    from shapes alone: on meta tensors, which hold no values, and with no
    index among the plan's inputs."""
    import inspect
    q = torch.empty(4, 8, 64, device="meta")
    kc = torch.empty(4, nb * ps, 8, 64, device="meta", dtype=torch.bfloat16)
    arena = torch.empty(4 * nb + 1, ps, 8, 64, device="meta", dtype=torch.bfloat16)
    bt = torch.empty(4, nb, device="meta", dtype=torch.int32)
    assert (flash_decode.plan_of(q, kc, sms=132) == flash_decode.plan_of(q, arena, bt, sms=132)
            == flash_decode.split_plan(nb * ps, 4, 8, 132))
    for fn in (flash_decode.split_plan, flash_decode.plan_of):
        assert "index" not in inspect.signature(fn).parameters


def _partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, index, per: int):
    """The partial softmax states of B5's kernel split over the cache: for
    each range [lo, lo + per) of positions, (m, l, acc) per (row, query
    head): the range's max logit, its sum of exp(logit - m) and its
    unnormalised output, in f32. A range past a row's index has m = -1e30,
    l = 0 and acc = 0."""
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    rep = h // kv
    ke = k.repeat_interleave(rep, dim=2).float()
    ve = v.repeat_interleave(rep, dim=2).float()
    logits = torch.einsum("bhd,bshd->bhs", q.float(), ke) * (hd ** -0.5)
    idx = torch.as_tensor(index, device=q.device).reshape(-1).expand(b)
    valid = (torch.arange(s, device=q.device)[None, :] <= idx[:, None])[:, None, :]
    parts = []
    for lo in range(0, s, per):
        lg, ok = logits[..., lo:lo + per], valid[..., lo:lo + per].expand(b, h, -1)
        m = torch.where(ok, lg, torch.full_like(lg, -1e30)).amax(-1)
        p = torch.where(ok, torch.exp(lg - m[..., None]), torch.zeros_like(lg))
        parts.append((m, p.sum(-1), torch.einsum("bhs,bshd->bhd", p, ve[:, lo:lo + per])))
    return parts


def _merge(parts) -> torch.Tensor:
    """The merge of ``_partials``, in range order: out =
    sum_i w_i acc_i / sum_i w_i l_i with w_i = exp(m_i - max m), where a
    range with l = 0 takes no part (weight 0, its acc never read). f32."""
    live = [l > 0 for _, l, _ in parts]
    m_all = torch.stack([torch.where(ok, m, torch.full_like(m, -1e30))
                         for (m, _, _), ok in zip(parts, live)]).amax(0)
    l_all = torch.zeros_like(m_all)
    out = torch.zeros_like(parts[0][2])
    for (m, l, acc), ok in zip(parts, live):
        w = torch.exp(m - m_all)
        l_all = l_all + torch.where(ok, l * w, torch.zeros_like(l))
        out = out + torch.where(ok[..., None], acc * w[..., None], torch.zeros_like(acc))
    return torch.where(l_all[..., None] > 0, out / l_all[..., None], torch.zeros_like(out))


@pytest.mark.parametrize("s,per", [(1024, 128), (300, 192), (130, 64)])
def test_split_merge_matches_flash_decode_ref(s, per):
    """The merge formula in plain torch: partials of disjoint ranges merged
    in order equal ``flash_decode_ref`` within 1e-6 (f32), with rows at 0,
    a split's last position, the next split's first and the last; a range
    past a row's index (l = 0) takes weight 0, whatever its m and acc. This
    checks the formula, not the kernel's merge, which runs only on the card
    (``test_cuda_flash_decode_matches_plain``, ``chip_smoke.py`` phase 8)."""
    rs = np.random.RandomState(s)
    b, h, kv, hd = 5, 8, 2, 64
    q = torch.from_numpy(rs.randn(b, h, hd).astype(np.float32))
    k = torch.from_numpy(rs.randn(b, s, kv, hd).astype(np.float32))
    v = torch.from_numpy(rs.randn(b, s, kv, hd).astype(np.float32))
    idx = torch.tensor([0, per - 1, per, s - 1, s // 2])
    parts = _partials(q, k, v, idx, per)
    want = ref.flash_decode_ref(q, k, v, idx)
    torch.testing.assert_close(_merge(parts), want, atol=1e-6, rtol=0)
    _, l_last, acc_last = parts[-1]
    assert torch.equal(l_last[0], torch.zeros(h)) and torch.equal(acc_last[0], torch.zeros(h, hd))
    poisoned = [(torch.where(l > 0, m, torch.full_like(m, 1e30)), l,
                 torch.where(l[..., None] > 0, acc, torch.full_like(acc, float("nan"))))
                for m, l, acc in parts]
    assert torch.equal(_merge(poisoned), _merge(parts))


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
    arena = torch.randn(5, 4, 2, 8)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(TypeError):                              # int64 tables
        flash_decode.flash_decode_paged(torch.randn(2, 4, 8), arena, arena,
                                        bt.long(), torch.zeros(2, dtype=torch.long))
    with pytest.raises(ValueError):                             # index per row
        flash_decode.flash_decode_paged(torch.randn(2, 4, 8), arena, arena, bt,
                                        torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError):                             # non-contiguous
        flash_decode.flash_decode_paged(torch.randn(2, 4, 8), arena, arena,
                                        torch.zeros(3, 2, dtype=torch.int32).t(),
                                        torch.zeros(2, dtype=torch.long))
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
                               "flash_decode": 0, "flash_decode_paged": 0}
    assert streaming_counts() == {"grouped_matmul": 0, "grouped_matmul_dx": 0,
                                  "grouped_matmul_dw": 0}
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
    """Bitwise, with invalid slots and out-of-range tokens; (1024, 1024,
    512) is the training site's shape (1,024 slots)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    for t, s, d in ((256, 512, 512), (1024, 1024, 512), (9, 4, 37), (50, 40, 100)):
        x = torch.randn(t, d, generator=g, device=dev).to(dtype)
        st = torch.randint(-1, t + 2, (s,), generator=g, device=dev,
                           dtype=torch.int32)
        sv = torch.rand(s, generator=g, device=dev) < 0.7
        assert torch.equal(moe_dispatch.dispatch(x, st, sv),
                           ref.dispatch_ref(x, st, sv))


def _routed_tables(t, k, e, c, g):
    """(slot_token, slot_valid) of t tokens routed to k distinct experts
    each (seeded), filled in token order into e experts of c slots: the
    router's tables (a slot past an expert's capacity dropped, an unfilled
    one invalid)."""
    dev = g.device
    experts = torch.rand(t, e, generator=g, device=dev).argsort(dim=1)[:, :k].reshape(-1)
    pos = torch.nn.functional.one_hot(experts, e).cumsum(0).gather(1, experts[:, None])[:, 0] - 1
    kept = pos < c
    st = torch.zeros(e * c, dtype=torch.int32, device=dev)
    sv = torch.zeros(e * c, dtype=torch.bool, device=dev)
    st[(experts * c + pos)[kept]] = (torch.arange(t * k, device=dev) // k)[kept].to(torch.int32)
    sv[(experts * c + pos)[kept]] = True
    return st, sv


_DISPATCH_PLANS = ((1, False), (2, False), (1, True), (2, True))


def _dispatch_each_instance(x, st, sv):
    """B2 through the wrapper (its plan), bitwise its plain version, and each
    instance (1 or 2 words a thread, plain or evict-first stores) bitwise
    that."""
    want = ref.dispatch_ref(x, st, sv)
    assert torch.equal(moe_dispatch.dispatch(x, st, sv), want)
    for plan in _DISPATCH_PLANS:
        out = torch.full((st.shape[0], x.shape[1]), 7, dtype=x.dtype, device=x.device)
        assert moe_dispatch.launch_dispatch(x, st, sv, out, plan=plan) == plan
        assert torch.equal(out, want), plan


# B2's sites: (label, tokens, k, experts, slots an expert, d, dtype), as
# chip_smoke.py's B2_SITES
_B2_SITES = [("zcode-m3-base decode", 8, 1, 128, 1, 512, torch.bfloat16),
             ("zcode-m3-base prefill", 256, 1, 128, 4, 512, torch.bfloat16),
             ("zcode-m3-base training", 1024, 1, 128, 8, 512, torch.float32),
             ("dbrx-132b decode", 8, 4, 16, 4, 6144, torch.bfloat16),
             ("dbrx-132b prefill", 256, 4, 16, 128, 6144, torch.bfloat16),
             ("dbrx-132b long prefill", 2304, 4, 16, 1152, 6144, torch.bfloat16),
             ("deepseek-v3-671b decode", 8, 8, 256, 1, 7168, torch.bfloat16),
             ("deepseek-v3-671b long prefill", 2048, 8, 256, 128, 7168, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("label,t,k,e,c,d,dtype", _B2_SITES)
def test_cuda_dispatch_at_the_sites_bitwise(label, t, k, e, c, d, dtype):
    """B2 at every site of the kernel table, on the router's tables, with
    the words a thread its plan picks and with every other instance:
    bitwise the plain version."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(t, d, generator=g, device=dev).to(dtype)
    _dispatch_each_instance(x, *_routed_tables(t, k, e, c, g))


@pytest.mark.cuda
def test_cuda_dispatch_edges_bitwise():
    """B2 bitwise its plain version, every instance: all slots invalid (no
    row read, zeros stored), capacity 1 (one slot an expert), tokens out of
    range (clipped), and rows in 4-byte words (a view off a 16-byte
    boundary; f32 rows of 101), 2-byte (bf16 rows of 101; a bf16 view off a
    4-byte boundary, rows of 512) and 1-byte (rows of 37 bytes, the
    kernel's byte copy launched on uint8)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(32)
    x = torch.randn(64, 6144, generator=g, device=dev).bfloat16()
    st = torch.randint(0, 64, (64,), generator=g, device=dev, dtype=torch.int32)
    _dispatch_each_instance(x, st, torch.zeros(64, dtype=torch.bool, device=dev))
    _dispatch_each_instance(x, *_routed_tables(64, 2, 128, 1, g))
    wild = torch.randint(-5, 80, (200,), generator=g, device=dev, dtype=torch.int32)
    _dispatch_each_instance(x, wild, torch.rand(200, generator=g, device=dev) < 0.7)
    base = torch.randn(1 + 50 * 512, generator=g, device=dev)
    views = (base[1:].view(50, 512), torch.randn(50, 101, generator=g, device=dev),
             torch.randn(50, 101, generator=g, device=dev).bfloat16(),
             base.bfloat16()[1:].view(50, 512))
    for xv, word in zip(views, (4, 4, 2, 2)):
        st, sv = _routed_tables(50, 2, 16, 4, g)
        assert moe_dispatch.dispatch_word(xv, torch.empty(1, device=dev)) == word
        _dispatch_each_instance(xv, st, sv)
    xb = torch.randint(0, 256, (50, 37), generator=g, device=dev, dtype=torch.uint8)
    st, sv = _routed_tables(50, 2, 16, 4, g)
    for plan in _DISPATCH_PLANS:
        out = torch.empty((st.shape[0], 37), dtype=torch.uint8, device=dev)
        moe_dispatch.launch_dispatch(xb, st, sv, out, plan=plan)
        assert torch.equal(out, ref.dispatch_ref(xb, st, sv)), plan


@pytest.mark.cuda
def test_cuda_dispatch_variant_resources():
    """B2's instances (16-, 4-, 2- and 1-byte words, 1 or 2 a thread, plain
    or evict-first stores) do not spill and fit 16 blocks of 128 threads
    on an SM (2,048 threads: 32 KB of 16-byte words in flight, what
    dispatch_plan counts on)."""
    _card()
    for word in (16, 4, 2, 1):
        for n, stream in _DISPATCH_PLANS:
            info = moe_dispatch.variant_info("dispatch", word=word, per_thread=n, stream=stream)
            assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 16, (word, n, info)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_combine_matches_plain(dtype):
    """The vector path (16-byte words) and the scalar one (d = 100; a view
    off a 16-byte boundary); k = 1 (the top-1 instance), 2, 5 and 40 (one
    step of 4 rows, two, and ten: the general instance)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    for t, k, s, d, offset in ((256, 1, 512, 512, 0), (32, 2, 48, 100, 0), (7, 2, 5, 64, 0),
                               (9, 2, 16, 64, 1), (10, 5, 40, 512, 0), (3, 40, 50, 96, 0)):
        base = torch.randn(offset + s * d, generator=g, device=dev).to(dtype)
        buf = base[offset:].view(s, d)
        ts = torch.randint(0, s, (t, k), generator=g, device=dev, dtype=torch.int32)
        w = torch.rand(t, k, generator=g, device=dev)
        keep = torch.rand(t, k, generator=g, device=dev) < 0.8
        _gpu_close(moe_dispatch.combine(buf, ts, w, keep),
                   ref.combine_ref(buf, ts, w, keep))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_combine_top8_at_deepseek_widths_matches_plain(dtype):
    """deepseek-v3-671b's combine: k = 8 (two steps of 4 rows), d 7,168,
    256 experts; the decode site (8 tokens, C = 1) and the long prefill's
    (2,048 tokens, C = 128), each token's 8 slots on distinct experts,
    some dropped."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(8)
    e, k, d = 256, 8, 7168
    for t, cap in ((8, 1), (2048, 128)):
        buf = torch.randn(e * cap, d, generator=g, device=dev).to(dtype)
        experts = torch.rand(t, e, generator=g, device=dev).argsort(dim=1)[:, :k]
        ts = (experts * cap + torch.randint(0, cap, (t, k), generator=g, device=dev))
        ts = ts.to(torch.int32)
        w = torch.rand(t, k, generator=g, device=dev)
        keep = torch.rand(t, k, generator=g, device=dev) < 0.9
        _gpu_close(moe_dispatch.combine(buf, ts, w, keep), ref.combine_ref(buf, ts, w, keep))


def _combine_no_pdl(buf, ts, w, keep, cols=None):
    """B3's kernel without PDL (which the wrapper never asks for), on the
    grid the plan picks or, given ``cols``, on that one."""
    out = torch.empty((ts.shape[0], buf.shape[1]), dtype=buf.dtype, device=buf.device)
    moe_dispatch.launch_combine(buf, ts, w, keep, out, pdl=False, cols=cols)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_combine_top1_bitwise(dtype):
    """Top-1 at the decode and training sites' shapes: one product onto
    zero, so the same bits on a second run, with PDL off, and as the plain
    version's."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    for t, s, d in ((8, 128, 512), (1024, 1024, 512), (8, 64, 7168)):
        buf = torch.randn(s, d, generator=g, device=dev).to(dtype)
        ts = torch.randint(-2, s + 2, (t, 1), generator=g, device=dev, dtype=torch.int32)
        w = torch.rand(t, 1, generator=g, device=dev)
        keep = torch.rand(t, 1, generator=g, device=dev) < 0.8
        y = moe_dispatch.combine(buf, ts, w, keep)
        assert torch.equal(y, moe_dispatch.combine(buf, ts, w, keep))
        assert torch.equal(y, _combine_no_pdl(buf, ts, w, keep))
        assert torch.equal(y, ref.combine_ref(buf, ts, w, keep))
        cols = moe_dispatch.plan_of(buf, ts)
        assert cols == (d == 7168)
        assert torch.equal(y, _combine_no_pdl(buf, ts, w, keep, cols=not cols))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,k", [(6144, 4), (7168, 8)])
def test_cuda_combine_wide_rows_at_decode_matches_plain(d, k, dtype):
    """dbrx-132b's (d 6,144, top-4 of 16 experts) and deepseek-v3-671b's
    (d 7,168, top-8 of 256) decode combine, 8 tokens: the plan takes the
    cols grid; against the plain version, bitwise the rows grid (both sum
    in the order of k), on a second run and after CUDA-graph replays. Then
    the cols grid past one step of 8 rows (k = 12) and on its element path
    (a view off a 16-byte boundary, d + 2)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(12)
    e, t = (16, 8) if k == 4 else (256, 8)
    buf = torch.randn(e * 4, d, generator=g, device=dev).to(dtype)
    experts = torch.rand(t, e, generator=g, device=dev).argsort(dim=1)[:, :k]
    ts = (experts * 4 + torch.randint(0, 4, (t, k), generator=g, device=dev)).to(torch.int32)
    w = torch.rand(t, k, generator=g, device=dev)
    keep = torch.rand(t, k, generator=g, device=dev) < 0.9
    assert moe_dispatch.plan_of(buf, ts)
    y = moe_dispatch.combine(buf, ts, w, keep)
    _gpu_close(y, ref.combine_ref(buf, ts, w, keep))
    assert torch.equal(y, _combine_no_pdl(buf, ts, w, keep, cols=False))
    assert torch.equal(y, moe_dispatch.combine(buf, ts, w, keep))
    assert torch.equal(_graph_replayed(lambda: moe_dispatch.combine(buf, ts, w, keep)), y)
    for kk, offset in ((12, 0), (k, 1)):
        base = torch.randn(offset + 50 * (d + 2 * offset), generator=g, device=dev).to(dtype)
        wide = base[offset:].view(50, d + 2 * offset)
        ts2 = torch.randint(-1, 51, (3, kk), generator=g, device=dev, dtype=torch.int32)
        w2 = torch.rand(3, kk, generator=g, device=dev)
        keep2 = torch.rand(3, kk, generator=g, device=dev) < 0.8
        assert moe_dispatch.plan_of(wide, ts2)
        y2 = moe_dispatch.combine(wide, ts2, w2, keep2)
        _gpu_close(y2, ref.combine_ref(wide, ts2, w2, keep2))
        assert torch.equal(y2, _combine_no_pdl(wide, ts2, w2, keep2, cols=False))


@pytest.mark.cuda
def test_cuda_combine_dropped_nan_row_propagates():
    """A dropped (t, k) still reads its row and multiplies it by 0, as the
    reference does: a NaN row gives NaN there, and only there."""
    dev = _card()
    for d in (64, 2048):                       # the rows grid, then cols
        buf = torch.ones(6, d, device=dev)
        buf[3] = float("nan")
        ts = torch.tensor([[3, 0], [1, 2], [0, 3]], dtype=torch.int32, device=dev)
        w = torch.full((3, 2), 0.5, device=dev)
        keep = torch.tensor([[False, True], [True, True], [True, False]], device=dev)
        assert moe_dispatch.plan_of(buf, ts) == (d == 2048)
        got = moe_dispatch.combine(buf, ts, w, keep)
        want = ref.combine_ref(buf, ts, w, keep)
        assert torch.equal(got.isnan(), want.isnan())
        assert got[[0, 2]].isnan().all() and not got[1].isnan().any()
        torch.testing.assert_close(got[1], want[1])


def _combine_arena(t, k, s, d, dtype, dev, head=0):
    """B3's four inputs as views of one byte buffer, after ``head`` bytes
    and in the order rows, tables, weights, keep, so that one kernel over
    the buffer writes them all, the tables last; its size is whole 16-byte
    words; returns (arena, views)."""
    es = torch.empty(0, dtype=dtype).element_size()
    sizes = [s * d * es, t * k * 4, t * k * 4, t * k]
    offs = [head]
    for n in sizes[:-1]:
        offs.append(offs[-1] + (n + 15) // 16 * 16)
    arena = torch.zeros((offs[-1] + sizes[-1] + 15) // 16 * 16, dtype=torch.uint8, device=dev)

    def view(i, dt, shape):
        return arena[offs[i]:offs[i] + sizes[i]].view(dt).view(shape)

    return arena, (view(0, dtype, (s, d)), view(1, torch.int32, (t, k)),
                   view(2, torch.float32, (t, k)), view(3, torch.bool, (t, k)))


def _fill_combine(views, g):
    buf, ts, w, keep = views
    s = buf.shape[0]
    buf.copy_(torch.randn(buf.shape, generator=g, device=buf.device))
    ts.copy_(torch.randint(-1, s + 1, ts.shape, generator=g, device=buf.device))
    w.copy_(torch.rand(w.shape, generator=g, device=buf.device))
    keep.copy_(torch.rand(keep.shape, generator=g, device=buf.device) < 0.8)


def _copy_early_trigger(src, dst):
    """dst <- src by ``repro_copy_early_trigger``: a copy kernel that lets
    the kernel launched after it with PDL start as it starts."""
    fn = build.function("repro_copy_early_trigger", [ctypes.c_void_p, ctypes.c_void_p,
                                                     ctypes.c_longlong, ctypes.c_void_p])
    build.check(fn(src.data_ptr(), dst.data_ptr(), src.numel(),
                   torch.cuda.current_stream().cuda_stream), "copy")


@pytest.mark.cuda
@pytest.mark.parametrize("before", ["bitwise_not", "early_trigger_copy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_combine_waits_for_the_kernel_before_it(dtype, before):
    """B3 launched (with PDL) right after a kernel that writes all its
    inputs in place, over one byte buffer (64 MiB of padding, then B3's
    rows, tables, weights and keep, so the tables come last): equal to
    plain on each of several calls, eagerly and in a CUDA graph replayed
    with fresh inputs. ``bitwise_not`` is a torch kernel, which triggers
    its dependent only at its grid's end; ``early_trigger_copy``
    (``repro_copy_early_trigger``) triggers it as it starts, so B3 runs
    while its inputs are written, and a global load that B3 issued before
    griddepcontrol.wait would see the old values."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(8)
    t, k, s, d = 1024, 1, 1024, 512                 # the training site's shape
    head = 64 << 20
    arena, views = _combine_arena(t, k, s, d, dtype, dev, head)
    if before == "bitwise_not":
        encode, write = torch.bitwise_not, lambda src: torch.bitwise_not(src, out=arena)
    else:
        encode, write = torch.clone, lambda src: _copy_early_trigger(src, arena)
    fresh = []
    for _ in range(6):
        src, src_views = _combine_arena(t, k, s, d, dtype, dev, head)
        _fill_combine(src_views, g)
        fresh.append((encode(src), [v.clone() for v in src_views]))
    for _ in range(3):
        for encoded, want_views in fresh:
            write(encoded)
            y = moe_dispatch.combine(*views)
            torch.cuda.synchronize()
            assert torch.equal(y, ref.combine_ref(*want_views))

    src = torch.zeros_like(arena)

    def step():
        write(src)
        return moe_dispatch.combine(*views)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = step()
    for _ in range(3):
        for encoded, want_views in fresh:
            src.copy_(encoded)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(y, ref.combine_ref(*want_views))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_b1_b3_pipeline_graph_replays(dtype):
    """B1's down projection -> B3 (PDL) captured in one CUDA graph and
    replayed with new rows, weights and tables: equal to the plain
    versions each time."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(9)
    e, c, f, d, t = 16, 8, 2048, 512, 128
    h = torch.zeros(e, c, f, dtype=dtype, device=dev)
    w_out = torch.zeros(e, f, d, dtype=dtype, device=dev)
    ts = torch.zeros(t, 1, dtype=torch.int32, device=dev)
    w = torch.zeros(t, 1, device=dev)
    keep = torch.zeros(t, 1, dtype=torch.bool, device=dev)

    def refill():
        h.copy_(torch.randn(h.shape, generator=g, device=dev))
        w_out.copy_(torch.randn(w_out.shape, generator=g, device=dev) * f ** -0.5)
        ts.copy_(torch.randint(0, e * c, ts.shape, generator=g, device=dev))
        w.copy_(torch.rand(w.shape, generator=g, device=dev))
        keep.copy_(torch.rand(keep.shape, generator=g, device=dev) < 0.8)

    def pipeline():
        return moe_dispatch.combine(grouped_ffn.grouped_matmul(h, w_out).reshape(e * c, d),
                                    ts, w, keep)

    refill()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pipeline()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = pipeline()
    for _ in range(3):
        refill()
        graph.replay()
        torch.cuda.synchronize()
        want = ref.combine_ref(ref.grouped_matmul_ref(h, w_out).reshape(e * c, d), ts, w,
                               keep)
        _gpu_close(y, want)


@pytest.mark.cuda
def test_cuda_launch_floor_runs():
    """The empty kernel chip_smoke.py times as the launch floor launches,
    with and without PDL."""
    _card()
    fn = build.function("repro_launch_floor", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    for pdl in (1, 0):
        build.check(fn(2, pdl, torch.cuda.current_stream().cuda_stream), "launch floor")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.float32, torch.bfloat16),
                                      (torch.bfloat16, torch.bfloat16)])
def test_cuda_flash_decode_matches_plain(qdt, kvdt):
    """B5 against its plain version: one split (64 positions), ragged
    splits (300, 1,000), zcode's full 1,024-position cache with rows at 0,
    a split's last position, the next split's first and 1,023, a 4,160-
    position cache of 17 splits (the merge takes them in batches of 8, 8
    and 1) with rows at the edge of the first batch, and head dims 40 and 33
    (rows of 80 and 66 bytes take narrower copies); the long caches bitwise
    on a second run and after 3 CUDA-graph replays."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    for b, h, kv, s, hd in ((8, 8, 8, 64, 64), (3, 8, 2, 300, 128), (2, 8, 1, 1000, 40),
                            (4, 8, 8, 1024, 64), (4, 8, 4, 1024, 33), (4, 8, 8, 4160, 64)):
        q = torch.randn(b, h, hd, generator=g, device=dev).to(qdt)
        k = torch.randn(b, s, kv, hd, generator=g, device=dev).to(kvdt)
        v = torch.randn(b, s, kv, hd, generator=g, device=dev).to(kvdt)
        n_split, per = flash_decode.plan_of(q, k)
        if s >= 1024:
            edge = 8 * per if n_split > 8 else per   # the first merge batch's or split's end
            idx = torch.tensor([0, edge - 1, edge, s - 1], device=dev)
        else:
            idx = torch.randint(0, s, (b,), generator=g, device=dev)
            idx[0] = 0
        out = flash_decode.flash_decode(q, k, v, idx)
        _gpu_close(out, ref.flash_decode_ref(q, k, v, idx))
        if s == 4160:
            assert n_split > 8, n_split
        if s >= 1024:
            assert n_split > 1
            assert torch.equal(flash_decode.flash_decode(q, k, v, idx), out)
            assert torch.equal(_graph_replayed(lambda: flash_decode.flash_decode(q, k, v, idx)),
                               out)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", [(32, 4), (48, 8)])
def test_cuda_flash_decode_gqa_geometries_match_plain(h, kv, qdt):
    """B5 and B6 at the decoder-only archs' decode geometry, head dim 128
    with 8 query heads per kv head (yi-6b: 32 / 4, both of the kernel's
    limits at once) and 6 (dbrx-132b: 48 / 8, on the 8-row instance with
    two rows masked), bf16 caches: against the plain versions at 64
    positions (one split) and 1,024 (several, rows at split edges), B6
    through a permuted arena of 16-position pages bitwise equal to B5."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    ps = 16
    for b, s in ((8, 64), (4, 1024)):
        q = torch.randn(b, h, 128, generator=g, device=dev).to(qdt)
        k = torch.randn(b, s, kv, 128, generator=g, device=dev).bfloat16()
        v = torch.randn(b, s, kv, 128, generator=g, device=dev).bfloat16()
        n_split, per = flash_decode.plan_of(q, k)
        if s == 1024:
            assert n_split > 1
            idx = torch.tensor([0, per - 1, per, s - 1], device=dev, dtype=torch.int32)
        else:
            idx = torch.randint(0, s, (b,), generator=g, device=dev, dtype=torch.int32)
        out = flash_decode.flash_decode(q, k, v, idx)
        _gpu_close(out, ref.flash_decode_ref(q, k, v, idx))
        nb = s // ps
        perm = torch.randperm(b * nb, generator=g, device=dev)
        tables = perm.reshape(b, nb).to(torch.int32)
        ka = torch.empty((b * nb + 1, ps, kv, 128), dtype=k.dtype, device=dev)
        va = torch.empty_like(ka)
        ka[perm] = k.reshape(b * nb, ps, kv, 128)
        va[perm] = v.reshape(b * nb, ps, kv, 128)
        ka[-1], va[-1] = 1e4, -1e4                      # the scratch page
        paged = flash_decode.flash_decode_paged(q, ka, va, tables, idx)
        _gpu_close(paged, ref.flash_decode_paged_ref(q, ka, va, tables, idx))
        assert torch.equal(paged, out)


@pytest.mark.cuda
@pytest.mark.parametrize("kvdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("rep", [5, 8, 12, 16])
def test_cuda_flash_decode_gqa_sweep_matches_plain(rep, hd, kvdt):
    """B5 and B6 on the grouped-query kernel: rep 5 and 8 over 4 kv heads
    (one head group), 12 and 16 (two: a part and a whole second group),
    head dims 64 and 128, f32 queries, f32 and bf16 caches of 34 (one
    split), 1,024 and 3,586 positions (several, rows at a split's last
    position, the next split's first and the last): against the plain
    version, bitwise on a second run, and B6 (pages of 17, 16 and 2, as
    the cache divides, in a permuted arena) bitwise B5."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(100 * rep + hd)
    kv = 4
    for b, s, ps in ((8, 34, 17), (4, 1024, 16), (2, 3586, 2)):
        q = torch.randn(b, rep * kv, hd, generator=g, device=dev)
        k = torch.randn(b, s, kv, hd, generator=g, device=dev).to(kvdt)
        v = torch.randn(b, s, kv, hd, generator=g, device=dev).to(kvdt)
        n_split, per = flash_decode.plan_of(q, k)
        assert (n_split > 1) == (s > 192)
        if s > 192:
            idx = torch.tensor([per - 1, per, s - 1, s // 2][:b], device=dev, dtype=torch.int32)
        else:
            idx = torch.randint(0, s, (b,), generator=g, device=dev, dtype=torch.int32)
            idx[0] = 0
        out = flash_decode.flash_decode(q, k, v, idx)
        _gpu_close(out, ref.flash_decode_ref(q, k, v, idx))
        assert torch.equal(flash_decode.flash_decode(q, k, v, idx), out)
        nb = s // ps
        perm = torch.randperm(b * nb, generator=g, device=dev)
        tables = perm.reshape(b, nb).to(torch.int32)
        ka = torch.empty((b * nb + 1, ps, kv, hd), dtype=kvdt, device=dev)
        va = torch.empty_like(ka)
        ka[perm] = k.reshape(b * nb, ps, kv, hd)
        va[perm] = v.reshape(b * nb, ps, kv, hd)
        ka[-1], va[-1] = 1e4, -1e4                      # the scratch page
        assert torch.equal(flash_decode.flash_decode_paged(q, ka, va, tables, idx), out)


@pytest.mark.cuda
@pytest.mark.parametrize("kvdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [5, 12])
def test_cuda_flash_decode_partial_warp_rows_match_plain(rep, kvdt):
    """The shape at which the tensor-core body's zeroing of a warp's dead V
    rows, written as a runtime-unrolled loop, faulted on the card: hd 64, a
    192-position cache (three tiles: every stage of the ring), the live
    positions ending inside a warp's 16 rows of the last tile, 9-15 of them
    and every other count, and inside the first tile; the CUDA-core body (an
    f32 cache, 8 rows a warp) at the same indices, whose position loops
    unrolled by 2 returned only each warp's first row. One split: against
    the plain version, bitwise on a second run, and B6 (pages of 16,
    permuted) bitwise B5."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(200 + rep)
    kv, hd, s = 5, 64, 192
    ends = [1, 5, 8, 9, 10, 11, 12, 13, 14, 15, 16, 25, 26, 32, 41, 48, 57, 63, 64]
    idx = torch.tensor([8, 12] + [128 + n - 1 for n in ends], device=dev, dtype=torch.int32)
    b = idx.shape[0]
    q = torch.randn(b, rep * kv, hd, generator=g, device=dev)
    k = torch.randn(b, s, kv, hd, generator=g, device=dev).to(kvdt)
    v = torch.randn(b, s, kv, hd, generator=g, device=dev).to(kvdt)
    assert flash_decode.plan_of(q, k)[0] == 1
    out = flash_decode.flash_decode(q, k, v, idx)
    _gpu_close(out, ref.flash_decode_ref(q, k, v, idx))
    assert torch.equal(flash_decode.flash_decode(q, k, v, idx), out)
    ps, nb = 16, s // 16
    perm = torch.randperm(b * nb, generator=g, device=dev)
    ka = torch.empty((b * nb + 1, ps, kv, hd), dtype=kvdt, device=dev)
    va = torch.empty_like(ka)
    ka[perm] = k.reshape(b * nb, ps, kv, hd)
    va[perm] = v.reshape(b * nb, ps, kv, hd)
    ka[-1], va[-1] = 1e4, -1e4                      # the scratch page
    tables = perm.reshape(b, nb).to(torch.int32)
    assert torch.equal(flash_decode.flash_decode_paged(q, ka, va, tables, idx), out)


@pytest.mark.cuda
def test_cuda_flash_decode_refuses_wide_heads():
    """Head dims past 128 (wider than any of the reference's configs) raise
    on the card; rep has no limit."""
    dev = _card()
    q = torch.randn(2, 24, 192, device=dev)
    k = torch.randn(2, 16, 2, 192, device=dev).bfloat16()
    with pytest.raises(ValueError, match="head_dim <= 128"):
        flash_decode.flash_decode(q, k, k, 3)


@pytest.mark.cuda
def test_cuda_flash_decode_split_launches_on_two_streams():
    """Launches that split, issued in turns on two streams with no sync
    between them (two server threads, each with its stream), are ordered by
    the wrapper, since they share the arrival counters: each output equals
    the same call's on one stream, bitwise."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    cases = []
    for _ in range(2):
        q = torch.randn(8, 8, 64, generator=g, device=dev)
        k, v = (torch.randn(8, 1024, 8, 64, generator=g, device=dev).bfloat16() for _ in range(2))
        cases.append((q, k, v, torch.randint(0, 1024, (8,), generator=g, device=dev)))
    assert flash_decode.plan_of(cases[0][0], cases[0][1])[0] > 1
    want = [flash_decode.flash_decode(*c) for c in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for i in range(40):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(flash_decode.flash_decode(*cases[i % 2]))
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert torch.equal(out, want[i % 2]), i


def _graph_replayed(fn):
    """``fn()``'s output after three replays of a CUDA graph that captured
    one call (after an eager warm-up on a side stream)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = fn()
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    return y


@pytest.mark.cuda
def test_cuda_flash_decode_variant_resources():
    """The serving instance (f32 q, bf16 cache, hd 64, one query head per
    kv head) does not spill and fits four blocks per SM, B5 and B6, at one
    tile and at two tiles per split (zcode's full cache: 512 blocks, all
    resident at once on 132 SMs). At hd 128, rep 8 the tensor-core body (a
    bf16 cache) does not spill and fits two blocks per SM (yi-6b's 3,586
    positions: 232 blocks, all resident at once), and the CUDA-core body
    (an f32 cache) does not spill and fits one."""
    _card()
    for paged in (False, True):
        for per in (flash_decode.TILE, 2 * flash_decode.TILE):
            info = flash_decode.variant_info(paged, torch.float32, torch.bfloat16, per=per)
            assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 4, info
        for kvdt, blocks in ((torch.bfloat16, 2), (torch.float32, 1)):
            info = flash_decode.variant_info(paged, torch.float32, kvdt, hd=128, rep=8)
            assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= blocks, info


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


_STREAM_SHAPES = [(4, c, d, f) for c in (1, 4, 8, 9, 16)
                  for d, f in ((512, 2048), (2048, 512))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", _STREAM_SHAPES)
def test_cuda_grouped_matmul_streaming_matches_plain(e, c, d, f, dtype):
    """B1's streaming forward, dx and dw kernels against their plain
    versions, launched once each (per-variant counters), with the same
    result on a second run (no atomics)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5 + c)
    x = torch.randn(e, c, d, generator=g, device=dev).to(dtype)
    w = (torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5).to(dtype)
    dy = torch.randn(e, c, f, generator=g, device=dev).to(dtype)
    reset_launch_counts()
    out = grouped_ffn.grouped_matmul(x, w)
    dx = grouped_ffn.grouped_matmul_dx(dy, w)
    dw = grouped_ffn.grouped_matmul_dw(x, dy)
    assert streaming_counts() == {"grouped_matmul": 1, "grouped_matmul_dx": 1,
                                  "grouped_matmul_dw": 1}
    assert (grouped_ffn.grouped_matmul.launches, grouped_ffn.grouped_matmul_dx.launches,
            grouped_ffn.grouped_matmul_dw.launches) == (1, 1, 1)
    _gpu_close(out, ref.grouped_matmul_ref(x, w))
    _gpu_close(dx, ref.grouped_matmul_dx_ref(dy, w))
    _gpu_close(dw, ref.grouped_matmul_dw_ref(x, dy))
    assert torch.equal(out, grouped_ffn.grouped_matmul(x, w))
    assert torch.equal(dx, grouped_ffn.grouped_matmul_dx(dy, w))
    assert torch.equal(dw, grouped_ffn.grouped_matmul_dw(x, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_grouped_matmul_unaligned_takes_tiled(dtype):
    """An unaligned row tail (f = 70) and a view off a 16-byte boundary
    take the tiled kernel, forward, dx and dw: counted as launches, not as
    streaming ones."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(4, 5, 100, generator=g, device=dev).to(dtype)
    w = (torch.randn(4, 100, 70, generator=g, device=dev) * 0.1).to(dtype)
    dy = torch.randn(4, 5, 70, generator=g, device=dev).to(dtype)
    base = torch.randn(1 + 4 * 5 * 64, generator=g, device=dev).to(dtype)
    xv = base[1:].reshape(4, 5, 64)
    wv = (torch.randn(4, 64, 64, generator=g, device=dev) * 0.1).to(dtype)
    reset_launch_counts()
    _gpu_close(grouped_ffn.grouped_matmul(x, w), ref.grouped_matmul_ref(x, w))
    _gpu_close(grouped_ffn.grouped_matmul_dx(dy, w), ref.grouped_matmul_dx_ref(dy, w))
    _gpu_close(grouped_ffn.grouped_matmul_dw(x, dy), ref.grouped_matmul_dw_ref(x, dy))
    _gpu_close(grouped_ffn.grouped_matmul(xv, wv), ref.grouped_matmul_ref(xv, wv))
    _gpu_close(grouped_ffn.grouped_matmul_dx(xv, wv), ref.grouped_matmul_dx_ref(xv, wv))
    _gpu_close(grouped_ffn.grouped_matmul_dw(xv, xv), ref.grouped_matmul_dw_ref(xv, xv))
    assert (grouped_ffn.grouped_matmul.launches, grouped_ffn.grouped_matmul_dx.launches,
            grouped_ffn.grouped_matmul_dw.launches) == (2, 2, 2)
    assert streaming_counts() == {"grouped_matmul": 0, "grouped_matmul_dx": 0,
                                  "grouped_matmul_dw": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", _TILED_SITES[5:] + [(2, 128, 200, 300)])
def test_cuda_grouped_matmul_tiled_matches_plain(e, c, d, f, dtype):
    """B1's tiled forward, dx and dw at C > 16 with the 128-row, 128-column
    and 32-deep tiles cut ragged (16-byte rows and not), one launch each,
    none streaming, against their plain versions and bitwise on a second
    run (no atomics, no split-K); then on views off a 16-byte boundary
    (element loads)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(17 + c)
    x = torch.randn(e, c, d, generator=g, device=dev).to(dtype)
    w = (torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5).to(dtype)
    dy = torch.randn(e, c, f, generator=g, device=dev).to(dtype)
    reset_launch_counts()
    out = grouped_ffn.grouped_matmul(x, w)
    dx = grouped_ffn.grouped_matmul_dx(dy, w)
    dw = grouped_ffn.grouped_matmul_dw(x, dy)
    assert (grouped_ffn.grouped_matmul.launches, grouped_ffn.grouped_matmul_dx.launches,
            grouped_ffn.grouped_matmul_dw.launches) == (1, 1, 1)
    assert streaming_counts() == {"grouped_matmul": 0, "grouped_matmul_dx": 0,
                                  "grouped_matmul_dw": 0}
    _gpu_close(out, ref.grouped_matmul_ref(x, w))
    _gpu_close(dx, ref.grouped_matmul_dx_ref(dy, w))
    _gpu_close(dw, ref.grouped_matmul_dw_ref(x, dy))
    assert torch.equal(out, grouped_ffn.grouped_matmul(x, w))
    assert torch.equal(dx, grouped_ffn.grouped_matmul_dx(dy, w))
    assert torch.equal(dw, grouped_ffn.grouped_matmul_dw(x, dy))
    xv = torch.randn(1 + e * c * d, generator=g, device=dev).to(dtype)[1:].view(e, c, d)
    dyv = torch.randn(1 + e * c * f, generator=g, device=dev).to(dtype)[1:].view(e, c, f)
    assert not grouped_ffn.tiled_vec(d, f, x.element_size(), xv.data_ptr())
    _gpu_close(grouped_ffn.grouped_matmul(xv, w), ref.grouped_matmul_ref(xv, w))
    _gpu_close(grouped_ffn.grouped_matmul_dx(dyv, w), ref.grouped_matmul_dx_ref(dyv, w))
    _gpu_close(grouped_ffn.grouped_matmul_dw(xv, dyv), ref.grouped_matmul_dw_ref(xv, dyv))


@pytest.mark.cuda
def test_cuda_grouped_matmul_tiled_resources():
    """The tiled kernel's instances report the shared memory ``tiled_plan``
    gives, spill nothing, and fit one block per SM."""
    _card()
    for kind in ("fwd", "dx", "dw"):
        for dtype in (torch.float32, torch.bfloat16):
            plan = grouped_ffn.tiled_plan(kind, 1, 128, 128, 128, dtype.itemsize)
            for vec in (True, False):
                info = grouped_ffn.variant_info(f"tiled_{kind}", dtype, 128, vec)
                assert info["smem_bytes"] == plan["smem_bytes"], (kind, dtype, vec, info)
                assert info["spill_bytes"] == 0, (kind, dtype, vec, info)
                assert info["blocks_per_sm"] == 1, (kind, dtype, vec, info)


@pytest.mark.cuda
def test_cuda_grouped_matmul_variant_resources():
    """The f32 streaming forward fits three blocks per SM and dx four at
    every C of the main path (their rate follows the bytes in flight per
    SM), and no main-path kernel spills."""
    _card()
    for c in (1, 4, 8):
        fwd = grouped_ffn.variant_info("stream_fwd", torch.float32, c)
        dx = grouped_ffn.variant_info("stream_dx", torch.float32, c)
        dw = grouped_ffn.variant_info("stream_dw", torch.float32, c)
        assert fwd["blocks_per_sm"] == 3 and fwd["spill_bytes"] == 0, fwd
        assert dx["blocks_per_sm"] == 4 and dx["spill_bytes"] == 0, dx
        assert dw["blocks_per_sm"] >= 2 and dw["spill_bytes"] == 0, dw
