"""The port's blocked flash attention (``repro_torch.models.flash``) and the
attention dispatch in front of it against the JAX package, on the CPU.

The same seeded numpy inputs go through ``repro.models.flash`` and its
port at chunk 16 (so a few dozen positions span several query and key
blocks): causal and not, window 0 and 13, 1, 2 and 4 KV heads of 4 query
heads, a query offset that crosses chunks, a value width apart from the
key width, and the banded sliding-window form. Forward outputs agree
within 2e-5 abs + 1e-5 rel (f32, sums in another order); gradients
(``torch.autograd`` against ``jax.vjp``) within 1e-4 abs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models import flash as JF  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import flash as F  # noqa: E402

FWD_ATOL, FWD_RTOL = 2e-5, 1e-5
GRAD_ATOL = 1e-4
CHUNK = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, lq, lk, h, kv, hd, hdv, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, lq, h, hd).astype(np.float32),
            rs.randn(b, lk, kv, hd).astype(np.float32),
            rs.randn(b, lk, kv, hdv).astype(np.float32),
            rs.randn(b, lq, h, hdv).astype(np.float32))


def _both(jfn, tfn, q, k, v, do):
    """(reference out, reference grads, port out, port grads) of
    ``sum(out * do)``."""
    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    to = tfn(tq, tk, tv)
    to.backward(torch.from_numpy(do))
    return (np.asarray(jo), [np.asarray(g) for g in jg], to.detach().numpy(),
            [t.grad.numpy() for t in (tq, tk, tv)])


def _assert_match(jo, jg, to, tg):
    np.testing.assert_allclose(to, jo, atol=FWD_ATOL, rtol=FWD_RTOL)
    for name, got, want in zip("qkv", tg, jg):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=0, err_msg=f"d{name}")


# (lq, lk, kv heads, hdv, q_offset): self-attention over several chunks;
# a query block offset into a longer key range (a continued prefill); a
# value width apart from the key width
SHAPES = {
    "self": (40, 40, 2, 8, 0),
    "mha": (40, 40, 4, 8, 0),
    "mqa": (40, 40, 1, 8, 0),
    "offset": (24, 56, 2, 8, 30),
    "hdv": (40, 40, 2, 6, 0),
    "offset_hdv": (20, 52, 1, 12, 21),
}


@pytest.mark.parametrize("window", [0, 13])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_flash_attention_matches_reference(shape, causal, window):
    lq, lk, kv, hdv, q_offset = SHAPES[shape]
    q, k, v, do = _inputs(2, lq, lk, 4, kv, 8, hdv)
    opts = (causal, window, q_offset, 0, CHUNK, CHUNK)
    jo, jg, to, tg = _both(lambda *a: JF.flash_attention(*a, *opts),
                           lambda *a: F.flash_attention(*a, *opts), q, k, v, do)
    _assert_match(jo, jg, to, tg)


def test_flash_attention_rows_that_see_no_key_match_reference():
    """Query positions past the window of every key: the reference's
    arithmetic (every block visited, p = 1 at NEG_INF) in both packages,
    beside a chunk of rows that see keys."""
    q, k, v, do = _inputs(1, 40, 20, 4, 2, 8, 8, seed=3)
    opts = (True, 5, 12, 0, CHUNK, CHUNK)
    assert F._visits(40, CHUNK, 2, CHUNK, True, 5, 12, 0, 20) == [[0, 1], [0, 1], [0, 1]]
    jo, jg, to, tg = _both(lambda *a: JF.flash_attention(*a, *opts),
                           lambda *a: F.flash_attention(*a, *opts), q, k, v, do)
    _assert_match(jo, jg, to, tg)
    assert np.isfinite(to).all()


@pytest.mark.parametrize("window", [0, 13])
def test_skipped_blocks_change_no_bit(window, monkeypatch):
    """The blocks the port skips (above the causal diagonal, before a
    chunk's window) add exactly nothing: forward and gradients are
    bitwise those of visiting every block, as the reference does."""
    q, k, v, do = _inputs(2, 64, 64, 4, 2, 8, 8, seed=4)
    visits = F._visits(64, CHUNK, 4, CHUNK, True, window, 0, 0, 64)
    assert visits[0] == [0] and visits[3][-1] == 3
    assert sum(map(len, visits)) < 16

    def run():
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        out = F.flash_attention(tq, tk, tv, True, window, 0, 0, CHUNK, CHUNK)
        out.backward(torch.from_numpy(do))
        return [out.detach()] + [t.grad for t in (tq, tk, tv)]

    skipping = run()
    monkeypatch.setattr(F, "_visits", lambda lq, qc, nk, *a: [list(range(nk))] * (-(-lq // qc)))
    for a, b in zip(skipping, run()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lq,window,q_chunk,kv_chunk,kv", [
    (70, 13, 32, 16, 2), (64, 8, 16, 8, 1), (50, 20, 16, 16, 4)])
def test_banded_flash_attention_matches_reference(lq, window, q_chunk, kv_chunk, kv):
    q, k, v, do = _inputs(2, lq, lq, 4, kv, 8, 8, seed=5)
    jo, jg, to, tg = _both(
        lambda *a: JF.banded_flash_attention(*a, window, 0, q_chunk, kv_chunk),
        lambda *a: F.banded_flash_attention(*a, window, 0, q_chunk, kv_chunk), q, k, v, do)
    _assert_match(jo, jg, to, tg)
    # banded equals masked sliding-window attention over the whole sequence
    full = F.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), True, window, 0, 0,
                             q_chunk, kv_chunk)
    np.testing.assert_allclose(to, full.numpy(), atol=FWD_ATOL, rtol=FWD_RTOL)


@pytest.mark.parametrize("lk,blocked", [(2 * CHUNK, False), (2 * CHUNK + 1, True)])
@pytest.mark.parametrize("window", [0, 7])
def test_attention_dispatch_switches_at_twice_the_chunk(lk, blocked, window, monkeypatch):
    """``attention.flash_attention``: quadratic up to ``2 * chunk`` keys,
    blocked past them (``q_chunk = min(chunk, lq)``), as the reference;
    outputs and gradients against the reference's dispatch."""
    q, k, v, do = _inputs(2, lk, lk, 4, 2, 8, 8, seed=6)
    calls = []
    real = F.flash_attention
    monkeypatch.setattr(F, "flash_attention", lambda *a: calls.append(a[3:]) or real(*a))
    jo, jg, to, tg = _both(
        lambda *a: JA.flash_attention(*a, causal=True, window=window, chunk=CHUNK),
        lambda *a: A.flash_attention(*a, causal=True, window=window, chunk=CHUNK),
        q, k, v, do)
    _assert_match(jo, jg, to, tg)
    assert calls == ([(True, window, 0, 0, CHUNK, CHUNK)] if blocked else [])
