"""Mamba-2 (SSD) in the port against the JAX package, on the CPU:
``models/ssm.py`` (the chunked scan, the full-sequence mixer, the decode
recurrence, the prefill state), mamba2-1.3b through the model, one-shot
and beam ``generate``, the slot-pool scheduler with exact-length prefill,
the paged scheduler's refusal and ``--task lm``.

Both packages run the reference's ``reduced()`` config (d 256, 2 layers,
16 SSD heads of 32 over d_inner 512, state 16, chunk 16, a dense FFN). Weights are the
reference's seeded init, carried over by ``bridge``; inputs are seeded
numpy.

Tolerances: integer outputs (tokens, plans, the exact-prefill decision)
are exact; ``ssd_chunked``'s output and final state within 2e-4 abs, the
bound ``tests/test_ssm.py`` holds it to against the naive recurrence
(plus 1e-5 rel at the 128-position chunk, whose outputs reach ~7); the
mixer's and the models' f32 outputs within 2e-4 abs (the bound of
``test_torch_decoder_only.py``: two layers of f32 GEMMs summed in another
order); ``--task lm`` losses within 2e-5, parameters within 2e-4, that
file's training bounds.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import TrainConfig as JaxTC  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.models import model_apply as jax_model_apply  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import ContinuousScheduler as JaxScheduler  # noqa: E402
from repro.serve import GenerateConfig as JaxGen  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro.serve import needs_exact_prefill as jax_needs_exact  # noqa: E402
from repro.training import init_train_state as jax_init_state  # noqa: E402
from repro.training import make_train_step as jax_make_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (ARCHS, PagedKVConfig, TrainConfig,  # noqa: E402
                                 get_config, reduced)
from repro_torch.data import LMTaskConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import (decode_step, init_model, model_apply,  # noqa: E402
                                prefill)
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, GenerateConfig,  # noqa: E402
                               PagedScheduler, Request, generate,
                               needs_exact_prefill)
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.serve.engine import _cache_batch_axes  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCH = "mamba2-1.3b"
SSD_ATOL = 2e-4
ATOL = 2e-4
# the reference's functions compiled once per shape (eager jnp dispatch
# takes seconds per call at these sizes)
_jax_decode = jax.jit(jax_decode_step, static_argnums=(4,))
_jax_ssm_decode = jax.jit(JS.ssm_decode, static_argnums=3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfgs(**kw):
    return (jax_reduced(jax_get_config(ARCH), **kw), reduced(get_config(ARCH), **kw))


@pytest.fixture(scope="module")
def weights():
    """The reference's seeded init of reduced mamba2-1.3b, and its bridge."""
    jc, _ = _cfgs()
    jp = jax.jit(jax_init_model, static_argnums=1)(jax.random.PRNGKey(0), jc)
    return jp, bridge.to_torch(jax_flat(jp), "cpu")


@pytest.fixture(scope="module")
def mixer():
    """One reference SSM mixer's parameters (``init_ssm``) and their bridge."""
    jc, _ = _cfgs()
    jp = JS.init_ssm(jax.random.PRNGKey(5), jc, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _tokens(vocab, b, l, seed=1):
    toks = np.random.RandomState(seed).randint(3, vocab, (b, l))
    return jnp.asarray(toks), torch.from_numpy(toks)


def _ssd_inputs(b, l, h, g, p, n, seed):
    rs = np.random.RandomState(seed)
    xh = rs.randn(b, l, h, p).astype(np.float32)
    dt = (np.log1p(np.exp(rs.randn(b, l, h))) * 0.5).astype(np.float32)
    a = (-np.exp(rs.randn(h) * 0.3)).astype(np.float32)
    bs = rs.randn(b, l, g, n).astype(np.float32)
    cs = rs.randn(b, l, g, n).astype(np.float32)
    return xh, dt, a, bs, cs


# ---------------------------------------------------------------------------
# config, plan, layout
# ---------------------------------------------------------------------------

def test_config_plan_and_counts_match():
    jfull, tfull = jax_get_config(ARCH), get_config(ARCH)
    assert ARCH in ARCHS and tfull.source == "arXiv:2405.21060"
    for jc, tc in ((jfull, tfull), _cfgs()):
        for f in dataclasses.fields(tc):
            if f.name != "ssm":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert dataclasses.asdict(tc.ssm) == dataclasses.asdict(jc.ssm)
        assert tc.n_params() == jc.n_params()
        js, ts = JT.layer_plan(jc), T.layer_plan(tc)
        assert [(s.repeats, [(p.mixer, p.moe, p.window) for p in s.pattern]) for s in ts] \
            == [(s.repeats, [(p.mixer, p.moe, p.window) for p in s.pattern]) for s in js]
        assert {p.mixer for s in ts for p in s.pattern} == {"ssm"}
    # 48 layers of 64 SSD heads of 64 (d_inner 4,096), state 128, chunk 128
    s = tfull.ssm
    assert (tfull.n_layers, s.d_inner(2048), s.n_heads(2048), s.d_state, s.chunk) == \
        (48, 4096, 64, 128, 128)
    assert round(tfull.n_params() / 1e9, 3) == 1.445
    assert (reduced(tfull).ssm.d_state, reduced(tfull).ssm.head_dim,
            reduced(tfull).ssm.chunk) == (16, 32, 16)


def test_init_layout_matches_reference(weights):
    """The reference's keys and shapes leaf for leaf (the SSM's twelve
    leaves stacked over the layers; reduced() gives the arch a dense FFN,
    as in the reference); the bridged tree is the port's layout."""
    jp, tp = weights
    _, tc = _cfgs()
    jflat = jax_flat(jp)
    tflat = flatten_with_paths(init_model(torch.Generator().manual_seed(0), tc))
    assert sorted(tflat) == sorted(jflat) == sorted(flatten_with_paths(tp))
    for key, want in jflat.items():
        assert tuple(tflat[key].shape) == want.shape and tflat[key].dtype == torch.float32, key
    ssm_keys = {k.split("/")[-1] for k in tflat if "/ssm/" in k}
    assert ssm_keys == {"w_z", "w_x", "w_B", "w_C", "w_dt", "dt_bias", "A_log", "D",
                        "conv_w", "conv_b", "out_norm", "w_out"}
    assert not any("/attn/" in k for k in tflat)
    assert tflat["decoder/0/p0/ssm/conv_w"].shape == (2, 4, 512 + 2 * 16)
    np.testing.assert_allclose(tflat["decoder/0/p0/ssm/A_log"][0].numpy(),
                               jflat["decoder/0/p0/ssm/A_log"][0], rtol=1e-6)


def test_cache_layout_matches_reference():
    """One conv window (model dtype) and one f32 state per row, batch axis
    1 under the repeats, no axis that grows with max_seq."""
    jc, tc = _cfgs()
    jcache = JT.init_stack_cache(JT.layer_plan(jc), jc, 3, 64, 0, jnp.bfloat16)
    tcache = T.init_stack_cache(T.layer_plan(tc), tc, 3, 64, 0, torch.bfloat16)
    jflat, tflat = jax_flat(jcache), flatten_with_paths(tcache)
    assert sorted(tflat) == sorted(jflat) == ["0/p0/ssm/conv", "0/p0/ssm/h"]
    for key, want in jflat.items():
        assert tuple(tflat[key].shape) == want.shape, key
    assert tflat["0/p0/ssm/conv"].dtype == torch.bfloat16
    assert tflat["0/p0/ssm/h"].dtype == torch.float32
    assert flatten_with_paths(_cache_batch_axes(tc)) == {"0/p0/ssm/conv": 1, "0/p0/ssm/h": 1}


# ---------------------------------------------------------------------------
# models/ssm.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l,chunk,h,g,seed", [
    (16, 8, 2, 1, 0), (32, 16, 4, 2, 1), (48, 8, 4, 1, 2),
    (32, 8, 2, 2, 3), (48, 16, 2, 1, 4), (16, 16, 4, 2, 5),
])
def test_ssd_chunked_matches_reference(l, chunk, h, g, seed):
    """The reference's sweep (``tests/test_ssm.py``), g = 2 among it: B and
    C repeated per group in place (``repeat_interleave``), the output and
    the final state; the g = 2 cases also from an initial state."""
    ins = _ssd_inputs(2, l, h, g, 8, 8, seed)
    h0 = np.random.RandomState(seed + 9).randn(2, h, 8, 8).astype(np.float32)
    for init in ((None, None), (jnp.asarray(h0), torch.from_numpy(h0)))[:1 + (g == 2)]:
        jy, jh = jax.jit(JS.ssd_chunked, static_argnums=5)(*map(jnp.asarray, ins), chunk,
                                                            init[0])
        ty, th = S.ssd_chunked(*map(torch.from_numpy, ins), chunk, init[1])
        assert ty.dtype == torch.float32 and th.shape == (2, h, 8, 8)
        _close(ty, jy, SSD_ATOL)
        _close(th, jh, SSD_ATOL)
    if g == 2:
        # Tensor.repeat would pair the heads with the other group's B and C
        xh, dt, a, bs, cs = map(torch.from_numpy, ins)
        wrong = S.ssd_chunked(xh, dt, a, bs[:, :, [1, 0]], cs[:, :, [1, 0]], chunk)[0]
        assert float((wrong - S.ssd_chunked(xh, dt, a, bs, cs, chunk)[0]).abs().max()) > 1e-2


def test_softplus_is_jaxs():
    x = np.concatenate([np.linspace(-40, 40, 2001), [-1e4, -88.7, 0.0, 20.0, 25.0, 1e4]])
    x = x.astype(np.float32)
    _close(S.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)), 1e-6)


def test_ssm_apply_matches_reference(mixer):
    """Lengths of a whole chunk, past one and under one (padded to the
    chunk inside)."""
    jp, tp = mixer
    jc, tc = _cfgs()
    for l in (16, 37, 5):
        x = np.random.RandomState(l).randn(2, l, tc.d_model).astype(np.float32)
        _close(S.ssm_apply(tp, torch.from_numpy(x), tc),
               jax.jit(JS.ssm_apply, static_argnums=2)(jp, jnp.asarray(x), jc))


@pytest.mark.parametrize("l", [1, 2, 3, 24])
def test_fill_ssm_cache_and_decode_match_reference(l, mixer):
    """The prefill state of an l-token prefix (l < conv_kernel - 1 pads the
    conv window with zero rows) against the reference's
    ``_fill_ssm_cache``; ``ssm_apply``'s state bitwise the port's
    ``_fill_ssm_cache``; then decode continues the prefix: 4 steps against
    the reference's ``ssm_decode`` (output, conv window, state), the last
    also against ``ssm_apply`` over the whole sequence (the reference's own
    check). The decode writes its cache in place."""
    jp, tp = mixer
    jc, tc = _cfgs()
    steps = 4
    x = np.random.RandomState(40 + l).randn(2, l + steps, tc.d_model).astype(np.float32)
    jcache = jax.jit(JT._fill_ssm_cache, static_argnums=2)(jp, jnp.asarray(x[:, :l]), jc)
    tcache = T._fill_ssm_cache(tp, torch.from_numpy(x[:, :l]), tc)
    assert tcache["conv"].shape == (2, 3, 512 + 32) and tcache["h"].dtype == torch.float32
    for key in ("conv", "h"):
        _close(tcache[key], jcache[key])
    if l < 3:
        assert not tcache["conv"][:, :3 - l].any()
    _, state = S.ssm_apply(tp, torch.from_numpy(x[:, :l]), tc, return_state=True)
    for key in ("conv", "h"):
        assert torch.equal(state[key], tcache[key]), key
    for i in range(l, l + steps):
        jo, jcache = _jax_ssm_decode(jp, jnp.asarray(x[:, i:i + 1]), jcache, jc)
        conv, hst = tcache["conv"], tcache["h"]
        to, out_cache = S.ssm_decode(tp, torch.from_numpy(x[:, i:i + 1]), tcache, tc)
        assert out_cache["conv"] is conv and out_cache["h"] is hst
        _close(to, jo)
        for key in ("conv", "h"):
            _close(tcache[key], jcache[key])
    full = S.ssm_apply(tp, torch.from_numpy(x), tc)
    _close(to[:, 0], full[:, -1].detach().numpy(), 1e-4)


def test_overflowing_chunk_forward_and_finite_gradients():
    """mamba2-1.3b's chunk of 128 with |a| = 16: the masked exponent of the
    upper triangle passes 88 and overflows f32. The port's forward equals
    the reference's; its gradients are finite and equal the naive
    recurrence's, where the reference's are NaN (``where``'s backward
    multiplies the overflowed ``exp`` by 0). The forward is held within
    2e-4 abs + 1e-5 rel: outputs reach ~7 here, and the chunk sums 128
    terms in another order."""
    b, l, h, p, n = 1, 128, 2, 4, 4
    xh, dt, _, bs, cs = _ssd_inputs(b, l, h, 1, p, n, 11)
    a = np.array([-16.0, -9.0], np.float32)
    span = np.cumsum(-dt * a, axis=1)
    assert span[:, -1].max() > 88.0           # the upper triangle's exponent overflows
    jy, _ = jax.jit(JS.ssd_chunked, static_argnums=5)(*map(jnp.asarray, (xh, dt, a, bs, cs)),
                                                     l)
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (xh, dt, a, bs, cs)]
    ty, th = S.ssd_chunked(*ts, l)
    assert bool(torch.isfinite(ty).all())
    _close(ty, jy, SSD_ATOL, 1e-5)
    (ty.square().sum() + th.sum()).backward()
    grads = [t.grad.clone() for t in ts]
    assert all(bool(torch.isfinite(g).all()) for g in grads)

    def jloss(*v):
        y, hf = JS.ssd_chunked(*v, l)
        return jnp.square(y).sum() + hf.sum()
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*map(jnp.asarray,
                                                               (xh, dt, a, bs, cs)))
    assert any(bool(jnp.isnan(g).any()) for g in jgrads)

    # the naive recurrence's gradients, in f64
    v = [torch.from_numpy(t).double().requires_grad_(True) for t in (xh, dt, a, bs, cs)]
    hst = torch.zeros((b, h, p, n), dtype=torch.float64)
    ys = []
    for t in range(l):
        hst = hst * torch.exp(v[1][:, t] * v[2])[..., None, None] + \
            (v[1][:, t, :, None] * v[0][:, t])[..., None] * v[3][:, t, 0][:, None, None, :]
        ys.append(torch.einsum("bn,bhpn->bhp", v[4][:, t, 0], hst))
    (torch.stack(ys, 1).square().sum() + hst.sum()).backward()
    for got, ref in zip(grads, v):
        np.testing.assert_allclose(got.numpy(), ref.grad.numpy(), atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode, generate
# ---------------------------------------------------------------------------

def test_model_apply_matches(weights):
    jc, tc = _cfgs()
    jp, tp = weights
    jt, tt = _tokens(tc.vocab, 2, 40)
    want, _ = jax.jit(lambda p, t: jax_model_apply(p, {"tokens": t}, jc,
                                                   is_training=False))(jp, jt)
    got, _ = model_apply(tp, {"tokens": tt}, tc, is_training=False)
    _close(got, want)


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_and_decode_match(per_row, weights):
    """A 13-token prefill (not a whole chunk), then 6 decode steps at one
    scalar index or per row through a slot-pool layout: logits and the
    caches against the reference."""
    jc, tc = _cfgs()
    jp, tp = weights
    plen, steps = 13, 6
    jt, tt = _tokens(tc.vocab, 2, plen + steps, seed=3)
    jl, jcache = jax.jit(lambda p, t: jax_prefill(p, {"tokens": t}, jc,
                                                  max_seq=plen + steps))(jp, jt[:, :plen])
    tl, tcache = prefill(tp, {"tokens": tt[:, :plen]}, tc, max_seq=plen + steps)
    _close(tl, jl)
    for i in range(plen, plen + steps):
        jidx = jnp.full((2,), i, jnp.int32) if per_row else i
        tidx = torch.full((2,), i) if per_row else i
        jl, jcache = _jax_decode(jp, jcache, jt[:, i:i + 1], jidx, jc)
        tl, tcache = decode_step(tp, tcache, tt[:, i:i + 1], tidx, tc, flash_decode=True)
        _close(tl, jl)
    for key, want in jax_flat(jcache).items():
        _close(flatten_with_paths(tcache)[key], want)


@pytest.mark.parametrize("beam", [1, 3])
def test_generate_matches_reference(beam, weights):
    """Greedy (the slot pool, per-row) and beam-3 search (the SSM leaves
    re-gathered by parent beam along their batch axis): the reference's
    tokens; beam 1 is greedy."""
    jc, tc = _cfgs()
    jp, tp = weights
    jt, tt = _tokens(tc.vocab, 2, 11, seed=5)
    gen = GenerateConfig(max_new=10, eos_id=-1, beam_width=beam, flash_decode=True)
    want = jax_generate(jp, {"tokens": jt}, jc, JaxGen(max_new=10, eos_id=-1, beam_width=beam))
    got = generate(tp, {"tokens": tt}, tc, gen)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert len(set(got.tokens.flatten().tolist())) > 3
    if beam == 1:
        # the beam-search loop at width 1 (every cache leaf re-gathered each
        # step) gives the greedy tokens
        assert torch.equal(E._generate_beam(tp, {"tokens": tt}, tc, gen).tokens, got.tokens)
        sampled = generate(tp, {"tokens": tt}, tc,
                           dataclasses.replace(gen, temperature=1.0), seed=4)
        want = jax_generate(jp, {"tokens": jt}, jc, JaxGen(max_new=10, eos_id=-1,
                                                           temperature=1.0),
                            rng=jax.random.PRNGKey(4))
        np.testing.assert_array_equal(sampled.tokens.numpy(), np.asarray(want.tokens))


# ---------------------------------------------------------------------------
# serving: exact prefill, the paged refusal, needs_exact_prefill, the CLI
# ---------------------------------------------------------------------------

def test_needs_exact_prefill_matches_reference_for_every_arch():
    for arch in ARCHS:
        for full in (True, False):
            tc = get_config(arch) if full else reduced(get_config(arch))
            jc = jax_get_config(arch) if full else jax_reduced(jax_get_config(arch))
            for bucket in (8, 64, 128, 1024, 4096, 8192):
                assert needs_exact_prefill(tc, bucket) == jax_needs_exact(jc, bucket), \
                    (arch, full, bucket)
    assert needs_exact_prefill(get_config(ARCH), 8)
    assert needs_exact_prefill(get_config("hymba-1.5b"), 8)
    assert not needs_exact_prefill(get_config("yi-6b"), 8192)


EXACT_LENS, EXACT_BUDGETS = (5, 12, 20), (6, 9, 4)


def _exact_requests(vocab, cls):
    rng = np.random.default_rng(2)
    return [cls(rid=i, tokens=rng.integers(3, vocab, size=EXACT_LENS[i % 3]).astype(np.int32),
                max_new=EXACT_BUDGETS[i % 3], arrival=0.0) for i in range(5)]


def test_continuous_exact_prefill_matches_oneshot_and_reference(weights):
    """The slot pool prefills every SSM prompt at its exact length (groups
    of one length, never padded to the 8/16 buckets, a prompt past the
    largest bucket accepted): tokens equal the port's one-shot ``generate``
    at the pool's cache length and the reference's scheduler."""
    jc, tc = _cfgs()
    jp, tp = weights
    kw = dict(n_slots=2, prefill_buckets=(8, 16), max_seq=32)
    sched = ContinuousScheduler(tp, tc, GenerateConfig(max_new=9, eos_id=-1), **kw)
    assert sched.exact_prefill and sched._bucket(5) == 5
    groups = []
    real = sched._prefill_group
    sched._prefill_group = lambda group, bucket, now: groups.append(
        (bucket, [len(r.tokens) for r in group])) or real(group, bucket, now)
    reqs = _exact_requests(tc.vocab, Request)
    got = {r.rid: r.tokens for r in sched.run(reqs)}
    assert sched.stats["admitted"] == sched.stats["finished"] == len(reqs)
    assert sched.stats["slot_reuse"] > 0
    assert all(lens == [bucket] * len(lens) for bucket, lens in groups)
    assert {bucket for bucket, _ in groups} == set(EXACT_LENS)
    jsched = JaxScheduler(jp, jc, JaxGen(max_new=9, eos_id=-1), **kw)
    want = {r.rid: r.tokens for r in jsched.run(_exact_requests(jc.vocab, JaxRequest))}
    for r in reqs:
        one = generate(tp, {"tokens": torch.from_numpy(r.tokens[None]).long()}, tc,
                       GenerateConfig(max_new=r.max_new, eos_id=-1, max_seq=32)).tokens[0]
        np.testing.assert_array_equal(got[r.rid], one.numpy(), err_msg=f"one-shot {r.rid}")
        np.testing.assert_array_equal(got[r.rid], np.asarray(want[r.rid]), err_msg=str(r.rid))


def test_paged_scheduler_refuses_the_ssm(weights):
    """No cache leaf of mamba2 tracks max_seq: nothing to page, as in the
    reference."""
    _, tc = _cfgs()
    _, tp = weights
    with pytest.raises(ValueError, match="nothing to page"):
        PagedScheduler(tp, tc, GenerateConfig(max_new=4, eos_id=-1),
                       paged=PagedKVConfig(page_size=8, n_slots_equiv=2), n_slots=2)


def test_serve_cli_on_cpu(tmp_path):
    out = tmp_path / "s.json"
    serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "20", "--max-new", "3", "--eos", "-1", "--flash-decode",
                    "--json-out", str(out)])
    assert len(json.load(open(out))["tokens"][0]) == 3
    serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--trace", "4",
                    "--slots", "2", "--max-new", "3", "--eos", "-1", "--json-out", str(out)])
    rec = json.load(open(out))
    assert rec["scheduler"]["admitted"] == rec["scheduler"]["finished"] == 4
    with pytest.raises(ValueError, match="nothing to page"):
        serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--trace", "2",
                        "--paged", "--eos", "-1"])


# ---------------------------------------------------------------------------
# --task lm training
# ---------------------------------------------------------------------------

N_STEPS = 3


def test_lm_train_steps_match_reference(weights):
    """Three steps of reduced mamba2 on the LM task (sequences of 24: one
    whole chunk and a padded one) against the reference's per-step update:
    the loss, the gradient norm and every parameter."""
    jc, tc = _cfgs()
    jp, tp = weights
    kw = dict(lr=1e-3, warmup_steps=2, seed=0, steps=N_STEPS)
    task = SyntheticLM(LMTaskConfig(vocab=tc.vocab, seq_len=24))
    jstep = jax_make_step(jc, JaxTC(**kw))
    jstate = jax_init_state(jax.tree_util.tree_map(jnp.array, jp), JaxTC(**kw))
    state = init_train_state(bridge.to_torch(bridge.to_numpy(tp)[0], "cpu"), TrainConfig(**kw))
    step = make_train_step(tc, TrainConfig(**kw))
    for i in range(N_STEPS):
        batch = task.sample_batch(i, 4)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, False)
        state, tm = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "xent"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=2e-5, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-5)
    jparams = jax_flat(jstate["params"])
    tparams = flatten_with_paths(state["params"])
    assert sorted(tparams) == sorted(jparams)
    for key, want in jparams.items():
        np.testing.assert_allclose(tparams[key].detach().numpy(), want, atol=2e-4, err_msg=key)


def test_train_cli_on_cpu(tmp_path):
    out = tmp_path / "h.json"
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--task", "lm",
                    "--steps", "2", "--batch", "2", "--seq", "20", "--log-every", "1",
                    "--no-prefetch", "--json-out", str(out)])
    hist = json.load(open(out))["history"]
    assert [r["step"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in hist)
