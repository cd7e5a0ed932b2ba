"""Sliding-window attention and long prompts in the port against the JAX
package, on the CPU: starcoder2-3b and h2o-danube-3-4b, their ring caches,
exact-length prefill in the slot-pool scheduler, and the blocked flash
prefill of a full-attention arch past 2,048 keys.

Both packages run the reference's ``reduced()`` configs with the same
overrides: starcoder2 (LayerNorm, GELU, 2 of 4 kv heads) at window 16;
h2o-danube (RMSNorm, gated SiLU) at window 8 with 2 of 4 kv heads and its
full arch's head width of 120. Weights are the reference's seeded init,
carried over by ``bridge``; inputs are seeded numpy.

Tolerances: integer outputs (ring ``pos`` leaves, tokens, the exact-prefill
decision) are exact; f32 attention outputs within 2e-5 abs + 1e-5 rel; the
models' f32 logits within 2e-4 abs, the bound of
``test_torch_decoder_only.py`` (two layers of f32 GEMMs summed in another
order, at logits of magnitude ~3); ``--task lm`` losses within 2e-5 and
parameters within 2e-4, that file's training bounds.
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
from repro.models import attention as JA  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.models import model_apply as jax_model_apply  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
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
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import (decode_step, init_model, model_apply,  # noqa: E402
                                prefill)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import flash as F  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, GenerateConfig,  # noqa: E402
                               PagedScheduler, Request, generate,
                               needs_exact_prefill)
from repro_torch.serve.engine import _cache_batch_axes  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ATT_ATOL, ATT_RTOL = 2e-5, 1e-5
LOGIT_ATOL = 2e-4
WINDOWED = ("starcoder2-3b", "h2o-danube-3-4b")
# the reference's decode step, compiled once per model and index form
_jax_decode = jax.jit(jax_decode_step, static_argnums=(4,))
# model: (arch, reduced() overrides of both packages)
MODELS = {
    "starcoder2": ("starcoder2-3b", dict(sliding_window=16)),
    "danube": ("h2o-danube-3-4b", dict(sliding_window=8, n_kv_heads=2, head_dim=120)),
}


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


def _cfgs(model, **kw):
    arch, red = MODELS[model]
    red = {**red, **kw}
    return jax_reduced(jax_get_config(arch), **red), reduced(get_config(arch), **red)


@pytest.fixture(scope="module")
def weights():
    """The reference's seeded init per model, and its bridge to torch."""
    cache = {}

    def get(model, **kw):
        key = (model, tuple(sorted(kw.items())))
        if key not in cache:
            jc, _ = _cfgs(model, **kw)
            jp = jax_init_model(jax.random.PRNGKey(0), jc)
            cache[key] = (jp, bridge.to_torch(jax_flat(jp), "cpu"))
        return cache[key]
    return get


def _tokens(vocab, b, l, seed=1):
    toks = np.random.RandomState(seed).randint(3, vocab, (b, l))
    return jnp.asarray(toks), torch.from_numpy(toks)


def _close(got, want, atol=LOGIT_ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.fixture
def b5_calls(monkeypatch):
    """Calls of the flash-decode wrappers (B5, B6) during the test."""
    calls = []
    for name in ("flash_decode", "flash_decode_paged"):
        real = getattr(FD, name)
        monkeypatch.setattr(FD, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    return calls


# ---------------------------------------------------------------------------
# configs, plans, the parameter layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", WINDOWED)
def test_configs_plans_and_counts_match(arch):
    jfull, tfull = jax_get_config(arch), get_config(arch)
    for f in dataclasses.fields(tfull):
        assert getattr(tfull, f.name) == getattr(jfull, f.name), f.name
    assert tfull.source == {"starcoder2-3b": "arXiv:2402.19173",
                            "h2o-danube-3-4b": "arXiv:2401.16818"}[arch]
    assert tfull.sliding_window == 4096 and arch in ARCHS
    assert reduced(tfull).sliding_window == jax_reduced(jfull).sliding_window == 128
    for jc, tc in ((jfull, tfull), (jax_reduced(jfull), reduced(tfull)),
                   _cfgs("starcoder2" if arch.startswith("star") else "danube")):
        js, ts = JT.layer_plan(jc), T.layer_plan(tc)
        assert [(s.repeats, [(p.cross, p.moe, p.window, p.causal) for p in s.pattern])
                for s in ts] == \
            [(s.repeats, [(p.cross, p.moe, p.window, p.causal) for p in s.pattern])
             for s in js]
        assert all(p.window == tc.sliding_window for s in ts for p in s.pattern)
        assert tc.n_params() == jc.n_params() and tc.head_dim_ == jc.head_dim_
    # starcoder2-3b: 3.18 B parameters, h2o-danube-3-4b: 3.96 B, head width 120
    assert round(tfull.n_params() / 1e9, 2) == {"starcoder2-3b": 3.18,
                                                "h2o-danube-3-4b": 3.96}[arch]
    assert tfull.head_dim_ == {"starcoder2-3b": 128, "h2o-danube-3-4b": 120}[arch]


@pytest.mark.parametrize("model", list(MODELS))
def test_bridged_weights_have_the_ports_layout(model, weights):
    """The reference's tree carries over leaf for leaf: starcoder2's
    LayerNorm biases, h2o-danube's gated FFN at head width 120."""
    jp, tp = weights(model)
    _, tc = _cfgs(model)
    tflat = flatten_with_paths(init_model(torch.Generator().manual_seed(0), tc))
    bflat = flatten_with_paths(tp)
    assert sorted(tflat) == sorted(bflat) == sorted(jax_flat(jp))
    for key, t in tflat.items():
        assert t.shape == bflat[key].shape and t.dtype == bflat[key].dtype, key
    if model == "starcoder2":
        assert "decoder/0/p0/ln1/bias" in tflat and "final_norm/bias" in tflat
        assert "decoder/0/p0/ffn/w_gate" not in tflat
    else:
        assert tflat["decoder/0/p0/attn/wq"].shape[-1] == 120
        assert "decoder/0/p0/ffn/w_gate" in tflat and "final_norm/bias" not in tflat


# ---------------------------------------------------------------------------
# ring caches
# ---------------------------------------------------------------------------

W = 8


@pytest.mark.parametrize("l", [5, W, 13, 2 * W + 3])
def test_ring_fill_matches_reference(l):
    """Prefill into a ring of W slots: the last W rows (all l of them,
    pos -1 past l, when l < W), each at slot pos % W; K/V bitwise, pos
    exact."""
    jc, tc = _cfgs("danube")
    rs = np.random.RandomState(l)
    k, v = (rs.randn(2, l, 2, 120).astype(np.float32) for _ in range(2))
    spec = JT.LayerSpec(window=W)
    want = JT._fill_kv_cache(spec, jc, JA.init_ring_cache(jc, 2, W, jnp.float32),
                             jnp.asarray(k), jnp.asarray(v))
    got = T._fill_kv_cache(T.LayerSpec(window=W), torch.from_numpy(k), torch.from_numpy(v),
                           64, torch.float32)
    assert sorted(got) == ["k", "pos", "v"] and got["pos"].dtype == torch.int32
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("per_row", [False, True])
def test_ring_decode_matches_reference(per_row):
    """``decode_self_attention`` on a ring of W slots, prefilled with 5
    positions, over 2W + 2 steps (the ring wraps twice): outputs within
    the f32 attention bound, K/V within it, ``pos`` exact. The per-row
    form runs on a slot-pool ring (batched ``pos``)."""
    jc, tc = _cfgs("danube")
    jp = JA.init_attn(jax.random.PRNGKey(3), jc, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rs = np.random.RandomState(7)
    P, steps = 5, 2 * W + 2
    kv = [rs.randn(2, P, 2, 120).astype(np.float32) for _ in range(2)]
    jcache = JT._fill_kv_cache(JT.LayerSpec(window=W), jc,
                               JA.init_ring_cache(jc, 2, W, jnp.float32),
                               *map(jnp.asarray, kv))
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    if per_row:
        jcache = dict(jcache, pos=jnp.broadcast_to(jcache["pos"], (2, W)))
        tcache["pos"] = tcache["pos"].expand(2, W).clone()
    for i in range(steps):
        x = rs.randn(2, 1, tc.d_model).astype(np.float32)
        pos = P + i
        jidx = jnp.full((2,), pos, jnp.int32) if per_row else pos
        tidx = torch.full((2,), pos) if per_row else pos
        jo, jcache = JA.decode_self_attention(jp, jnp.asarray(x), jcache, jc, jidx, window=W)
        to, tcache = A.decode_self_attention(tp, torch.from_numpy(x), tcache, tc, tidx,
                                             window=W, flash=True)
        _close(to, jo, ATT_ATOL, ATT_RTOL)
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], ATT_ATOL, ATT_RTOL)
    assert sorted(np.asarray(jcache["pos"]).reshape(-1, W)[0].tolist()) == \
        list(range(P + steps - W, P + steps))


# ---------------------------------------------------------------------------
# models: forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", list(MODELS))
def test_model_apply_matches(model, weights):
    jc, tc = _cfgs(model)
    jp, tp = weights(model)
    jt, tt = _tokens(tc.vocab, 2, 40)
    want, _ = jax_model_apply(jp, {"tokens": jt}, jc, is_training=False)
    got, _ = model_apply(tp, {"tokens": tt}, tc, is_training=False)
    _close(got, want)


def test_banded_swa_model_matches_reference(weights, monkeypatch):
    """``banded_swa`` on both packages, reduced starcoder2 (window 16) at 40
    tokens (past 2 x window): every layer's prefill and forward attention
    go through ``banded_flash_attention`` (q_chunk 512, kv_chunk 512, the
    reference's choice at this length); logits and the rings against the
    reference's banded model, and against the port's default blocked path."""
    jc, tc = _cfgs("starcoder2", banded_swa=True)
    jp, tp = weights("starcoder2")
    jt, tt = _tokens(tc.vocab, 2, 40, seed=8)
    calls = []
    real = T.banded_flash_attention
    monkeypatch.setattr(T, "banded_flash_attention",
                        lambda *a, **k: calls.append((a[3], k)) or real(*a, **k))
    want, _ = jax_model_apply(jp, {"tokens": jt}, jc, is_training=False)
    got, _ = model_apply(tp, {"tokens": tt}, tc, is_training=False)
    _close(got, want)
    jl, jcache = jax_prefill(jp, {"tokens": jt}, jc, max_seq=48)
    tl, tcache = prefill(tp, {"tokens": tt}, tc, max_seq=48)
    _close(tl, jl)
    np.testing.assert_array_equal(tcache[0]["p0"]["attn"]["pos"].numpy(),
                                  np.asarray(jcache[0]["p0"]["attn"]["pos"]))
    assert calls == [(16, dict(q_chunk=512, kv_chunk=512))] * (2 * tc.n_layers)
    plain, _ = model_apply(tp, {"tokens": tt}, dataclasses.replace(tc, banded_swa=False),
                           is_training=False)
    _close(got, plain.detach().numpy(), atol=ATT_ATOL)


def test_sliding_window_attention_limits_context(weights):
    """The reference's receptive-field check (``tests/test_models.py``): with
    2 layers x window 8, token 0 cannot reach the last position."""
    _, tc = _cfgs("danube")
    _, tp = weights("danube")
    _, t1 = _tokens(tc.vocab, 1, 32, seed=2)
    t2 = t1.clone()
    t2[:, 0] = (t1[:, 0] + 7) % tc.vocab
    l1, _ = model_apply(tp, {"tokens": t1}, tc, is_training=False)
    l2, _ = model_apply(tp, {"tokens": t2}, tc, is_training=False)
    np.testing.assert_allclose(l1[:, -1].numpy(), l2[:, -1].numpy(), atol=1e-5)
    assert float((l1[:, 0] - l2[:, 0]).abs().max()) > 1e-3


@pytest.mark.parametrize("plen", [10, 27])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("model", list(MODELS))
def test_prefill_and_decode_match(model, per_row, plen, weights, b5_calls):
    """Prefill shorter and longer than the window, then decode past it
    (the ring wraps), per-row through a slot pool or at one scalar index,
    against the reference; ``flash_decode`` reaches no B5 on ring layers."""
    jc, tc = _cfgs(model)
    jp, tp = weights(model)
    steps = 10
    jt, tt = _tokens(tc.vocab, 2, plen + steps, seed=3)
    max_seq = plen + steps
    jl, jcache = jax_prefill(jp, {"tokens": jt[:, :plen]}, jc, max_seq=max_seq)
    tl, tcache = prefill(tp, {"tokens": tt[:, :plen]}, tc, max_seq=max_seq)
    _close(tl, jl)
    jpos = [np.asarray(c["p0"]["attn"]["pos"]) for c in jcache]
    np.testing.assert_array_equal(tcache[0]["p0"]["attn"]["pos"].numpy(), jpos[0])
    if per_row:
        axes = _cache_batch_axes(tc)
        assert axes[0]["p0"]["attn"]["pos"] == -1 and axes[0]["p0"]["attn"]["k"] == 1
        jcache = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a[:, None], (a.shape[0], 2) + a.shape[1:])
            if a.dtype == jnp.int32 else a, jcache)
        tcache = [{"p0": {"attn": dict(c["p0"]["attn"], pos=c["p0"]["attn"]["pos"][:, None]
                                       .expand(-1, 2, -1).clone())}} for c in tcache]
    for i in range(steps):
        pos = plen + i
        jidx = jnp.full((2,), pos, jnp.int32) if per_row else pos
        tidx = torch.full((2,), pos) if per_row else pos
        jl, jcache = _jax_decode(jp, jcache, jt[:, pos:pos + 1], jidx, jc)
        tl, tcache = decode_step(tp, tcache, tt[:, pos:pos + 1], tidx, tc, flash_decode=True)
        _close(tl, jl)
        np.testing.assert_array_equal(tcache[0]["p0"]["attn"]["pos"].numpy(),
                                      np.asarray(jcache[0]["p0"]["attn"]["pos"]))
    assert b5_calls == []


def test_scalar_and_per_row_ring_decode_give_the_same_bits(weights):
    """The reference's contract (``attention.py``): per-row decode on a
    slot-pool ring equals the scalar form bitwise when every row sits at
    one position."""
    _, tc = _cfgs("starcoder2")
    _, tp = weights("starcoder2")
    _, tt = _tokens(tc.vocab, 2, 22, seed=4)
    _, c1 = prefill(tp, {"tokens": tt[:, :12]}, tc, max_seq=22)
    _, c2 = prefill(tp, {"tokens": tt[:, :12]}, tc, max_seq=22)
    c2 = [{"p0": {"attn": dict(c["p0"]["attn"], pos=c["p0"]["attn"]["pos"][:, None]
                               .expand(-1, 2, -1).clone())}} for c in c2]
    for pos in range(12, 22):
        l1, c1 = decode_step(tp, c1, tt[:, pos:pos + 1], pos, tc)
        l2, c2 = decode_step(tp, c2, tt[:, pos:pos + 1], torch.full((2,), pos), tc)
        assert torch.equal(l1, l2)


@pytest.mark.parametrize("beam", [1, 3])
def test_generate_matches_reference(beam, weights, b5_calls):
    """Greedy (a slot pool with per-row ring decode) and beam-3 search
    (one scalar index against the batchless ``pos`` leaf, left ungathered)
    on starcoder2 past its window: the reference's tokens."""
    jc, tc = _cfgs("starcoder2")
    jp, tp = weights("starcoder2")
    jt, tt = _tokens(tc.vocab, 2, 13, seed=5)
    want = jax_generate(jp, {"tokens": jt}, jc, JaxGen(max_new=12, eos_id=-1, beam_width=beam))
    got = generate(tp, {"tokens": tt}, tc,
                   GenerateConfig(max_new=12, eos_id=-1, beam_width=beam, flash_decode=True))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert b5_calls == []


def test_long_prompt_prefill_takes_the_blocked_path(monkeypatch):
    """Reduced yi-6b at its full max_seq, a 2,080-token prompt: both
    packages prefill through blocked flash attention (past 2 x 1,024
    keys); last-position logits within the models' bound, the ring-free
    cache exact in length."""
    red = dict(n_kv_heads=1, max_seq=4096)
    jc, tc = jax_reduced(jax_get_config("yi-6b"), **red), reduced(get_config("yi-6b"), **red)
    jp = jax_init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.to_torch(jax_flat(jp), "cpu")
    jt, tt = _tokens(tc.vocab, 1, 2080, seed=6)
    calls = []
    real = F.flash_attention
    monkeypatch.setattr(F, "flash_attention", lambda *a: calls.append(a[3:]) or real(*a))
    jl, _ = jax_prefill(jp, {"tokens": jt}, jc, max_seq=2088)
    tl, tcache = prefill(tp, {"tokens": tt}, tc, max_seq=2088)
    _close(tl, jl)
    assert calls == [(True, 0, 0, 0, 1024, 1024)] * tc.n_layers
    assert tcache[0]["p0"]["attn"]["k"].shape[2] == 2088


# ---------------------------------------------------------------------------
# serving: exact-length prefill, the paged refusal, the CLI
# ---------------------------------------------------------------------------

def test_needs_exact_prefill_matches_reference():
    for arch in ("starcoder2-3b", "h2o-danube-3-4b", "yi-6b", "zcode-m3-base"):
        for window in (0, 8, 16, 128, 4096):
            for bucket in (8, 16, 17, 64, 4096, 8192):
                jc = dataclasses.replace(jax_get_config(arch), sliding_window=window)
                tc = dataclasses.replace(get_config(arch), sliding_window=window)
                assert needs_exact_prefill(tc, bucket) == jax_needs_exact(jc, bucket)
    assert needs_exact_prefill(get_config("starcoder2-3b"), 8192)
    assert not needs_exact_prefill(get_config("starcoder2-3b"), 4096)


# prompts of three lengths (JAX compiles each), two past the window of 16
EXACT_LENS, EXACT_BUDGETS = (5, 20, 27), (6, 9, 4)


def _exact_requests(vocab, cls):
    rng = np.random.default_rng(2)
    return [cls(rid=i, tokens=rng.integers(3, vocab, size=EXACT_LENS[i % 3]).astype(np.int32),
                max_new=EXACT_BUDGETS[i % 3], arrival=0.0) for i in range(6)]


def test_continuous_exact_prefill_matches_oneshot_and_reference(weights):
    """Buckets up to 32 past the window of 16: the slot-pool scheduler
    prefills each prompt at its exact length (groups of one length, none
    padded to a bucket, a prompt past the largest bucket accepted), and
    every request's tokens equal the port's one-shot ``generate`` and the
    reference's scheduler."""
    jc, tc = _cfgs("starcoder2")
    jp, tp = weights("starcoder2")
    kw = dict(n_slots=3, prefill_buckets=(8, 24), max_seq=40)
    gen = GenerateConfig(max_new=9, eos_id=-1)
    sched = ContinuousScheduler(tp, tc, gen, **kw)
    assert sched.exact_prefill and sched._bucket(27) == 27
    groups = []
    real = sched._prefill_group
    sched._prefill_group = lambda group, bucket, now: groups.append(
        (bucket, [len(r.tokens) for r in group])) or real(group, bucket, now)
    reqs = _exact_requests(tc.vocab, Request)
    got = {r.rid: r.tokens for r in sched.run(reqs)}
    assert sched.stats["admitted"] == sched.stats["finished"] == len(reqs)
    assert all(lens == [bucket] * len(lens) for bucket, lens in groups)
    assert {bucket for bucket, _ in groups} == set(EXACT_LENS)
    jsched = JaxScheduler(jp, jc, JaxGen(max_new=9, eos_id=-1), **kw)
    assert jsched.exact_prefill
    want = {r.rid: r.tokens for r in jsched.run(_exact_requests(jc.vocab, JaxRequest))}
    for r in reqs:
        one = generate(tp, {"tokens": torch.from_numpy(r.tokens[None]).long()}, tc,
                       GenerateConfig(max_new=r.max_new, eos_id=-1, max_seq=40)).tokens[0]
        np.testing.assert_array_equal(got[r.rid], one.numpy(), err_msg=f"one-shot {r.rid}")
        np.testing.assert_array_equal(got[r.rid], np.asarray(want[r.rid]), err_msg=f"{r.rid}")
    with pytest.raises(ValueError, match="exceeds the pinned pool cache length"):
        sched.submit(Request(rid=9, tokens=np.arange(3, 38, dtype=np.int32), max_new=9))


@pytest.mark.parametrize("model", list(MODELS))
def test_paged_scheduler_refuses_all_window_archs(model, weights):
    _, tc = _cfgs(model)
    _, tp = weights(model)
    with pytest.raises(ValueError, match="nothing to page"):
        PagedScheduler(tp, tc, GenerateConfig(max_new=4, eos_id=-1),
                       paged=PagedKVConfig(page_size=8, n_slots_equiv=2), n_slots=2)


def test_serve_cli_windowed_on_cpu(tmp_path, capsys, b5_calls):
    out = tmp_path / "s.json"
    serve_cli.main(["--arch", "starcoder2-3b", "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "20", "--max-new", "3", "--eos", "-1", "--flash-decode",
                    "--json-out", str(out)])
    rec = json.load(open(out))
    assert rec["arch"] == "starcoder2-3b" and len(rec["tokens"][0]) == 3
    serve_cli.main(["--arch", "h2o-danube-3-4b", "--reduced", "--layers", "1", "--device",
                    "cpu", "--batch", "2", "--beam", "2", "--prompt-len", "6", "--max-new", "3", "--eos", "-1",
                    "--json-out", str(out)])
    assert len(json.load(open(out))["tokens"]) == 2
    serve_cli.main(["--arch", "starcoder2-3b", "--reduced", "--device", "cpu", "--trace", "4",
                    "--slots", "2", "--buckets", "8,160", "--max-new", "3", "--eos", "-1",
                    "--flash-decode", "--json-out", str(out)])
    rec = json.load(open(out))
    assert rec["scheduler"]["admitted"] == rec["scheduler"]["finished"] == 4
    assert "n_layers=1" in capsys.readouterr().out
    assert b5_calls == []
    with pytest.raises(ValueError, match="nothing to page"):
        serve_cli.main(["--arch", "h2o-danube-3-4b", "--reduced", "--device", "cpu",
                        "--trace", "2", "--paged", "--eos", "-1"])


# ---------------------------------------------------------------------------
# --task lm training
# ---------------------------------------------------------------------------

N_STEPS = 3


def _lm_batches(cfg):
    task = SyntheticLM(LMTaskConfig(vocab=cfg.vocab, seq_len=24))
    return lambda step: task.sample_batch(step, 4)


def test_lm_train_steps_match_reference(weights):
    """Three steps of reduced h2o-danube (window 8, sequences of 24) on the
    LM task against the reference's per-step update; a dense arch, so the
    Gate-Drop decision has no layer to act on."""
    jc, tc = _cfgs("danube")
    jp, tp = weights("danube")
    kw = dict(lr=1e-3, warmup_steps=2, seed=0, steps=N_STEPS)
    batches = _lm_batches(tc)
    jstep = jax_make_step(jc, JaxTC(**kw))
    jstate = jax_init_state(jax.tree_util.tree_map(jnp.array, jp), JaxTC(**kw))
    state = init_train_state(bridge.to_torch(bridge.to_numpy(tp)[0], "cpu"), TrainConfig(**kw))
    step = make_train_step(tc, TrainConfig(**kw))
    for i in range(N_STEPS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batches(i).items()}, False)
        state, tm = step(state, {k: torch.from_numpy(v) for k, v in batches(i).items()})
        for k in ("loss", "xent"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=2e-5, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-5)
    jparams = jax_flat(jstate["params"])
    tparams = flatten_with_paths(state["params"])
    assert sorted(tparams) == sorted(jparams)
    for key, want in jparams.items():
        np.testing.assert_allclose(tparams[key].detach().numpy(), want, atol=2e-4, err_msg=key)


def test_train_cli_windowed_on_cpu(tmp_path):
    out = tmp_path / "h.json"
    train_cli.main(["--arch", "h2o-danube-3-4b", "--reduced", "--device", "cpu", "--task",
                    "lm", "--steps", "2", "--batch", "2", "--seq", "136", "--gd-mode",
                    "gate_drop", "--gd-rate", "0.3", "--log-every", "1", "--no-prefetch",
                    "--json-out", str(out)])
    hist = json.load(open(out))["history"]
    assert [r["step"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in hist)
