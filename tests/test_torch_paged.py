"""The port's paged KV cache (``serve/paged.py``) and paged flash decode
(B6, ``kernels/flash_decode.py::flash_decode_paged``) against the JAX
package, on the CPU: B6's plain version against the Pallas kernel in
interpret mode (f32, atol 1e-5), the host page allocator and prefix cache
against the reference's under one seeded schedule of operations
(bitwise: free lists, refcounts, hit rates), and the pool primitives
(scatter, copy-on-write, swap out and in) against the reference's on the
same values (bitwise). The ``cuda``-marked test holds the B6 kernel
against its plain version and, bitwise, against B5 on the card.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import flash_decode, ref, reset_launch_counts  # noqa: E402
from repro_torch.serve import paged as P  # noqa: E402
from repro_torch.tree import flatten_with_paths, unflatten_paths  # noqa: E402

REDUCED = dict(d_model=64, n_layers=2, d_ff=128, vocab=97)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here and not at module level so that the
    ``cuda`` test runs where JAX is not installed (run there with
    ``--noconftest``)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.kernels import flash_decode_paged
    from repro.serve import paged as jpaged
    return types.SimpleNamespace(jax=jax, jnp=jnp, fdp=flash_decode_paged,
                                 paged=jpaged,
                                 cfg=jreduced(jget("zcode-m3-base"), **REDUCED))


def paged_case(gen, b, h, kv, hd, ps, nb, qdt, kvdt, device, index=None):
    """A permuted page arena holding B rows of nb pages, rows 0 and 1
    sharing their first page, every row's pages past its index pointing at
    the scratch page (index n_pages, filled with large values that must
    not leak in): (q, arena k, arena v, tables, index, contiguous k, v).
    The index is drawn (row 0 at 0, the last row at the last position)
    unless given."""
    n_pages = b * nb + 3
    perm = torch.randperm(n_pages, generator=gen, device="cpu")[:b * nb]
    tables = perm.reshape(b, nb).to(torch.int32)
    if b > 1:
        tables[1, 0] = tables[0, 0]
    if index is None:
        index = torch.randint(0, nb * ps, (b,), generator=gen, device="cpu")
        index[0] = 0
        index[-1] = nb * ps - 1
    index = torch.as_tensor(index)
    for r in range(b):
        live = int(index[r]) // ps + 1
        tables[r, live:] = n_pages
    ka = torch.randn(n_pages + 1, ps, kv, hd, generator=gen, device="cpu")
    va = torch.randn(n_pages + 1, ps, kv, hd, generator=gen, device="cpu")
    ka[n_pages] = 1e4
    va[n_pages] = -1e4
    q = torch.randn(b, h, hd, generator=gen, device="cpu")
    kc = ka[tables.long()].reshape(b, nb * ps, kv, hd)
    vc = va[tables.long()].reshape(b, nb * ps, kv, hd)
    to = lambda t, dt: t.to(device=device, dtype=dt).contiguous()
    return (to(q, qdt), to(ka, kvdt), to(va, kvdt), tables.to(device),
            index.to(device), to(kc, kvdt), to(vc, kvdt))


# ---------------------------------------------------------------------------
# B6's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kv,hd,ps,nb", [(4, 4, 2, 16, 8, 5),
                                             (3, 8, 8, 32, 4, 3),
                                             (2, 8, 1, 16, 5, 4),
                                             (1, 4, 4, 16, 16, 1)])
def test_flash_decode_paged_plain_matches_pallas(jx, b, h, kv, hd, ps, nb):
    g = torch.Generator().manual_seed(b * 100 + ps)
    q, ka, va, bt, idx, kc, vc = paged_case(g, b, h, kv, hd, ps, nb,
                                            torch.float32, torch.float32, "cpu")
    want = jx.fdp(*(jx.jnp.asarray(t.numpy()) for t in (q, ka, va, bt, idx)),
                  interpret=True)
    reset_launch_counts()
    got = flash_decode.flash_decode_paged(q, ka, va, bt, idx)
    assert flash_decode.flash_decode_paged.launches == 0      # CPU: plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the plain version IS B5's plain version on the gathered cache
    assert torch.equal(got, ref.flash_decode_ref(q, kc, vc, idx))


def test_flash_decode_paged_raises_under_grad():
    g = torch.Generator().manual_seed(0)
    q, ka, va, bt, idx, _, _ = paged_case(g, 2, 4, 2, 16, 8, 2, torch.float32,
                                          torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        flash_decode.flash_decode_paged(q.requires_grad_(), ka, va, bt, idx)
    with torch.no_grad():
        flash_decode.flash_decode_paged(q, ka, va, bt, idx)


# ---------------------------------------------------------------------------
# host page allocator and prefix cache against the reference's
# ---------------------------------------------------------------------------

def _drive(mod, seed: int, n_pages: int = 13, n_ops: int = 1500):
    """One seeded schedule of alloc / incref / decref / put / get /
    evict_one on ``mod``'s PageAllocator and PrefixCache; the observable
    state after every op."""
    rng = np.random.default_rng(seed)
    alloc = mod.PageAllocator(n_pages)
    cache = mod.PrefixCache(alloc)
    held, keys, trail = [], [], []
    for _ in range(n_ops):
        op = int(rng.integers(0, 6))
        if op == 0:
            p = alloc.try_alloc()
            if p is not None:
                held.append(p)
        elif op == 1 and held:
            p = held[int(rng.integers(len(held)))]
            alloc.incref(p)
            held.append(p)
        elif op == 2 and held:
            alloc.decref(held.pop(int(rng.integers(len(held)))))
        elif op == 3 and held:
            pages = sorted(set(held[int(i)] for i in
                               rng.integers(0, len(held), size=int(rng.integers(1, 4)))))
            key = ("PG", len(pages), bytes(pages))
            cache.put(key, pages)
            keys.append(key)
        elif op == 4 and keys:
            cache.lookups += 1
            key = keys[int(rng.integers(len(keys)))] if rng.random() < 0.7 \
                else ("FULL", 0, b"")
            if cache.get(key) is not None:
                cache.hits += 1
        elif op == 5:
            cache.evict_one()
        alloc.check()
        trail.append((list(alloc._free), alloc._ref.tolist(), alloc.in_use(),
                      len(cache), cache.evictable_pages(), cache.hit_rate))
    while cache.evict_one():
        pass
    for p in held:
        alloc.decref(p)
    alloc.check()
    trail.append((list(alloc._free), alloc._ref.tolist(), alloc.n_free))
    return trail


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_prefix_cache_match_reference(jx, seed):
    got = _drive(P, seed)
    want = _drive(jx.paged, seed)
    assert got == want
    assert got[-1][2] == 13                       # no leak, no double free


def test_allocator_misuse_raises():
    alloc = P.PageAllocator(2)
    p = alloc.alloc()
    alloc.decref(p)
    with pytest.raises(RuntimeError):
        alloc.decref(p)                           # double free
    with pytest.raises(RuntimeError):
        alloc.incref(p)                           # incref on a free page
    alloc.alloc()
    alloc.alloc()
    with pytest.raises(P.PagePoolExhausted):
        alloc.alloc()


def test_layout_geometry():
    lay = P.PagedLayout(page_size=8, n_pages=20, seq_len=44)
    assert lay.n_blocks == P.ceil_div(44, 8) == 6
    assert lay.scratch == 20
    assert [lay.pages_for(n) for n in (0, 8, 9)] == [0, 1, 2]


# ---------------------------------------------------------------------------
# pool primitives against the reference's
# ---------------------------------------------------------------------------

def _pools(jx, n_slots=3, max_seq=24, ps=8, n_pages=9, seed=0):
    """The same random values in a port paged pool and a reference one."""
    cfg = reduced(get_config("zcode-m3-base"), **REDUCED)
    lay = P.PagedLayout(page_size=ps, n_pages=n_pages, seq_len=max_seq)
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long),
             "enc_tokens": torch.zeros(1, 32, dtype=torch.long)}
    pool = P.paged_pool_like(batch, cfg, max_seq=max_seq, n_slots=n_slots,
                             layout=lay)
    rng = np.random.default_rng(seed)
    flat = flatten_with_paths(pool)
    for t in flat.values():
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)))
    jlay = jx.paged.PagedLayout(page_size=ps, n_pages=n_pages, seq_len=max_seq)
    jpool = unflatten_paths({k: jx.jnp.asarray(v.numpy()) for k, v in flat.items()})
    return cfg, lay, pool, jlay, jpool


def _assert_same(jx, pool, jpool):
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf)
            for path, leaf in jx.jax.tree_util.tree_flatten_with_path(jpool)[0]}
    got = {k: v.numpy() for k, v in flatten_with_paths(pool).items()}
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_page_axes_match_reference(jx):
    cfg = reduced(get_config("zcode-m3-base"), **REDUCED)
    bat, seq = P._cache_page_axes(cfg)
    jbat, jseq = jx.paged._cache_page_axes(jx.cfg)
    assert (flatten_with_paths(bat), flatten_with_paths(seq)) == (
        flatten_with_paths(jbat), flatten_with_paths(jseq))
    # only the decoder's self-attention K/V page; cross K/V stay per slot
    paged = {k for k, v in flatten_with_paths(seq).items() if v >= 0}
    assert paged == {k for k in flatten_with_paths(seq) if "/attn/" in k}
    assert paged and all(not k.endswith(("cross/k", "cross/v")) for k in paged)


def test_scatter_and_copy_pages_match_reference(jx):
    cfg, lay, pool, jlay, jpool = _pools(jx)
    rng = np.random.default_rng(3)
    w, nb = 2, lay.n_blocks
    fresh = P.init_cache(cfg, w, lay.seq_len, device="cpu", n_cross=32)
    for t in flatten_with_paths(fresh).values():
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)))
    # row 0 writes its blocks 0-1 (block 2 past its allocation goes to
    # scratch); row 1 (a dummy) writes nothing but the scratch slot 2
    wt = np.array([[4, 1, lay.scratch], [lay.scratch] * nb])
    slots = np.array([1, 2])
    pool = P.scatter_pages(pool, fresh, cfg, torch.from_numpy(wt),
                           torch.from_numpy(slots), lay)
    jfresh = unflatten_paths({k: jx.jnp.asarray(v.numpy())
                              for k, v in flatten_with_paths(fresh).items()})
    jpool = jx.paged.scatter_pages(jpool, jfresh, jx.cfg, jx.jnp.asarray(wt),
                                   jx.jnp.asarray(slots), jlay)
    # scratch bytes hold whichever colliding write won: compare the rest
    for t in flatten_with_paths(pool).values():
        if t.shape[1] == lay.n_pages + 1:
            t[:, lay.scratch] = 0
    jpool = jx.jax.tree.map(lambda a: a.at[:, lay.scratch].set(0)
                            if a.shape[1] == lay.n_pages + 1 else a, jpool)
    _assert_same(jx, pool, jpool)
    # copy-on-write reads every source before writing: 4 -> 1 and 1 -> 6
    # copy the OLD page 1 into 6
    src, dst = np.array([4, 1, lay.scratch]), np.array([1, 6, lay.scratch])
    pool = P.copy_pages(pool, cfg, torch.from_numpy(src), torch.from_numpy(dst))
    jpool = jx.paged.copy_pages(jpool, jx.cfg, jx.jnp.asarray(src), jx.jnp.asarray(dst))
    _assert_same(jx, pool, jpool)
    assert P.paged_kv_bytes(pool, cfg) == jx.paged.paged_kv_bytes(jpool, jx.cfg)


def test_swap_out_is_a_copy_and_round_trips(jx):
    """The saved state must not alias the arena: the host frees the pages
    at once and they may be written before the swap-in."""
    cfg, lay, pool, _, _ = _pools(jx)
    row = torch.tensor([3, 0, lay.scratch])
    saved = P.gather_slot_state(pool, cfg, row, 1)
    keep = {k: v.clone() for k, v in flatten_with_paths(saved).items()}
    for t in flatten_with_paths(pool).values():
        t.zero_()                                  # pages handed out again
    assert all(torch.equal(flatten_with_paths(saved)[k], v) for k, v in keep.items())
    new_row = torch.tensor([5, 7, lay.scratch])
    pool = P.restore_slot_state(pool, cfg, saved, new_row, 2)
    again = P.gather_slot_state(pool, cfg, new_row, 2)
    for k, v in flatten_with_paths(again).items():
        if "attn" in k:                            # scratch block aside
            assert torch.equal(v[:, :2], keep[k][:, :2]), k
        else:
            assert torch.equal(v, keep[k]), k


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.float32, torch.bfloat16),
                                      (torch.bfloat16, torch.bfloat16)])
def test_cuda_flash_decode_paged_matches_plain_and_b5(qdt, kvdt):
    """B6 against its plain version, and bitwise equal to B5 on the
    contiguous cache its tables address; page sizes 1, 8, 16, 17, GQA
    groups 1, 2, 8, head dims 32, 64, 128, nb = 1 and B = 1 (one split);
    zcode's full 1,024-position cache (16-position pages, and pages of 1)
    and pages of 17 over 272 positions, with rows at 0, a split's last
    position, the next split's first and the last (several splits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    for b, h, kv, hd, ps, nb in ((8, 8, 8, 64, 16, 6), (3, 8, 4, 32, 1, 40),
                                 (4, 8, 1, 128, 8, 5), (2, 16, 2, 64, 17, 3),
                                 (1, 8, 8, 64, 16, 1), (4, 8, 8, 64, 16, 64),
                                 (4, 8, 8, 64, 1, 1024), (4, 8, 2, 64, 17, 16)):
        index = None
        if nb * ps > 96:                               # split boundaries
            n, per = flash_decode.split_plan(nb * ps, b, kv,
                                             torch.cuda.get_device_properties(dev)
                                             .multi_processor_count)
            assert n > 1
            index = [0, per - 1, per, nb * ps - 1]
        q, ka, va, bt, idx, kc, vc = paged_case(g, b, h, kv, hd, ps, nb, qdt, kvdt, dev,
                                                index)
        reset_launch_counts()
        out = flash_decode.flash_decode_paged(q, ka, va, bt, idx)
        assert flash_decode.flash_decode_paged.launches == 1
        want = ref.flash_decode_paged_ref(q, ka, va, bt, idx)
        atol, rtol = (1e-4, 1e-4) if qdt == torch.float32 else (1e-2, 1.6e-2)
        torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
        assert torch.equal(out, flash_decode.flash_decode(q, kc, vc, idx))
