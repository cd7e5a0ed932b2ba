"""The Hymba hybrid in the port against the JAX package, on the CPU:
hymba-1.5b's plan (attention and SSM heads in every layer, global
attention at layers 0, 15 and 31, sliding windows elsewhere), its layout,
the meta tokens and their offset through the model, one-shot and beam
``generate``, the slot pool with exact-length prefill, the paged arena
(meta pages shared by every request, preemption) and ``--task lm``.
B5 and B6 at hymba's decode shape on the card: ``test_torch_hybrid_cuda.py``.

Both packages run the reference's ``reduced()`` config (d 256, 2 layers:
layer 0 global, layer 1 windowed over 128; 4 meta tokens; the SSM of
``test_torch_ssm.py``) with 2 kv heads for 4 query heads; the paged tests
take 16 meta tokens, two pages of 8. Weights are the reference's seeded
init, carried over by ``bridge``; inputs are seeded numpy.

Tolerances: integer outputs (plans, tokens, ring positions, page counters)
are exact; the models' f32 logits within 2e-4 abs (the bound of
``test_torch_decoder_only.py``); ``--task lm`` losses within 2e-5 and
parameters within 2e-4.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import PagedKVConfig as JaxPagedKVConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import HybridConfig as JaxHybridConfig  # noqa: E402
from repro.configs.base import TrainConfig as JaxTC  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.models import model_apply as jax_model_apply  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import ContinuousScheduler as JaxScheduler  # noqa: E402
from repro.serve import GenerateConfig as JaxGen  # noqa: E402
from repro.serve import PagedScheduler as JaxPagedScheduler  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro.training import init_train_state as jax_init_state  # noqa: E402
from repro.training import make_train_step as jax_make_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (ARCHS, HybridConfig, PagedKVConfig,  # noqa: E402
                                 TrainConfig, get_config, reduced)
from repro_torch.data import LMTaskConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import (decode_step, init_cache, init_model,  # noqa: E402
                                model_apply, prefill)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, GenerateConfig,  # noqa: E402
                               PagedScheduler, Request, generate)
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.serve.engine import _cache_batch_axes  # noqa: E402
from repro_torch.serve.paged import _cache_page_axes  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

_jax_decode = jax.jit(jax_decode_step, static_argnums=(4,))

ARCH = "hymba-1.5b"
ATOL = 2e-4
RED = dict(n_kv_heads=2)


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


def _cfgs(n_meta=None, **kw):
    """(reference, port) reduced configs with the same overrides; ``n_meta``
    replaces the reduced hybrid's 4 meta tokens."""
    kw = {**RED, **kw}
    jkw, tkw = dict(kw), dict(kw)
    if n_meta is not None:
        jkw["hybrid"] = JaxHybridConfig(n_meta_tokens=n_meta, global_attn_layers=(0,))
        tkw["hybrid"] = HybridConfig(n_meta_tokens=n_meta, global_attn_layers=(0,))
    return jax_reduced(jax_get_config(ARCH), **jkw), reduced(get_config(ARCH), **tkw)


@pytest.fixture(scope="module")
def weights():
    """The reference's seeded init per meta-token count, and its bridge."""
    cache = {}

    def get(n_meta=None):
        if n_meta not in cache:
            jc, _ = _cfgs(n_meta)
            jp = jax.jit(jax_init_model, static_argnums=1)(jax.random.PRNGKey(0), jc)
            cache[n_meta] = (jp, bridge.to_torch(jax_flat(jp), "cpu"))
        return cache[n_meta]
    return get


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0.0)


def _tokens(vocab, b, l, seed=1):
    toks = np.random.RandomState(seed).randint(3, vocab, (b, l))
    return jnp.asarray(toks), torch.from_numpy(toks)


@pytest.fixture
def b5_calls(monkeypatch):
    """Calls of the flash-decode wrappers (B5, B6) during the test."""
    calls = []
    for name in ("flash_decode", "flash_decode_paged"):
        real = getattr(FD, name)
        monkeypatch.setattr(FD, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    return calls


def _plan(segs):
    return [(s.repeats, [(p.mixer, p.moe, p.window) for p in s.pattern]) for s in segs]


# ---------------------------------------------------------------------------
# config, plan, layout
# ---------------------------------------------------------------------------

def test_config_plan_and_counts_match():
    """hymba-1.5b's fields and counts (the reference counts a hybrid
    layer's attention and FFN, not its SSM); its plan: five segments over
    32 layers, global (window 0) at layers 0, 15 and 31, the window of
    1,024 elsewhere; the depth cut keeps the global layers below it."""
    jfull, tfull = jax_get_config(ARCH), get_config(ARCH)
    assert ARCH in ARCHS and tfull.source == "arXiv:2411.13676"
    for jc, tc in ((jfull, tfull), _cfgs(), _cfgs(16)):
        for f in dataclasses.fields(tc):
            if f.name not in ("ssm", "hybrid"):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        for f in ("ssm", "hybrid"):
            assert dataclasses.asdict(getattr(tc, f)) == dataclasses.asdict(getattr(jc, f))
        assert tc.n_params() == jc.n_params()
        assert _plan(T.layer_plan(tc)) == _plan(JT.layer_plan(jc))
    segs = T.layer_plan(tfull)
    assert [s.repeats for s in segs] == [1, 14, 1, 15, 1]
    flat = [p for s in segs for p in s.pattern for _ in range(s.repeats)]
    assert len(flat) == 32 and {p.mixer for p in flat} == {"hybrid"}
    assert [i for i, p in enumerate(flat) if p.window == 0] == [0, 15, 31]
    assert {p.window for p in flat} == {0, 1024}
    assert (tfull.n_meta, tfull.n_heads, tfull.n_kv_heads, tfull.head_dim_) == (128, 25, 5, 64)
    assert round(tfull.n_params() / 1e9, 3) == 1.144
    cut = serve_cli.cut_depth(tfull, 16)
    assert cut.hybrid.global_attn_layers == (0, 15)
    assert [p.window for s in T.layer_plan(cut) for p in s.pattern
            for _ in range(s.repeats)] == [0] + [1024] * 14 + [0]
    assert serve_cli.cut_depth(tfull, 4).hybrid.global_attn_layers == (0,)


def test_init_layout_matches_reference(weights):
    """The reference's keys and shapes: attention, the SSM's twelve leaves,
    the two mixing gains per layer and the meta tokens; the bridged tree is
    the port's layout; the decode cache holds a full K/V cache at the
    global layer (max_seq + n_meta positions, the only pageable leaves), a
    ring at the windowed one and the SSM's window and state at both."""
    jp, tp = weights()
    jc, tc = _cfgs()
    jflat = jax_flat(jp)
    tflat = flatten_with_paths(init_model(torch.Generator().manual_seed(0), tc))
    assert sorted(tflat) == sorted(jflat) == sorted(flatten_with_paths(tp))
    for key, want in jflat.items():
        assert tuple(tflat[key].shape) == want.shape and tflat[key].dtype == torch.float32, key
    assert tflat["meta"].shape == (4, 256)
    for seg in ("0", "1"):
        assert {f"decoder/{seg}/p0/{k}" for k in ("mix_norm_attn", "mix_norm_ssm",
                                                   "attn/wq", "ssm/w_dt")} <= set(tflat)
    jcache = jax_flat(JT.init_stack_cache(JT.layer_plan(jc), jc, 2, 20 + 4, 0, jnp.float32))
    tcache = flatten_with_paths(init_cache(tc, 2, 20))
    assert sorted(tcache) == sorted(jcache)
    for key, want in jcache.items():
        assert tuple(tcache[key].shape) == want.shape, key
    assert tcache["0/p0/attn/k"].shape[2] == 24 and tcache["1/p0/attn/pos"].shape == (1, 128)
    _, seq = _cache_page_axes(tc)
    assert {k for k, a in flatten_with_paths(seq).items() if a >= 0} == \
        {"0/p0/attn/k", "0/p0/attn/v"}
    assert flatten_with_paths(_cache_batch_axes(tc))["1/p0/attn/pos"] == -1


# ---------------------------------------------------------------------------
# the model: meta tokens, prefill, decode
# ---------------------------------------------------------------------------

def test_model_apply_matches(weights):
    jc, tc = _cfgs()
    jp, tp = weights()
    jt, tt = _tokens(tc.vocab, 2, 40)
    want, _ = jax.jit(lambda p, t: jax_model_apply(p, {"tokens": t}, jc,
                                                   is_training=False))(jp, jt)
    got, _ = model_apply(tp, {"tokens": tt}, tc, is_training=False)
    assert got.shape == (2, 40, tc.vocab)
    _close(got, want)


@pytest.mark.parametrize("plen", [9, 130])
@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_and_decode_match(per_row, plen, weights, b5_calls):
    """Prefill, then 8 decode steps at the meta-shifted index, per row
    through a slot-pool layout or at one scalar index: logits, the ring's
    positions and the global layer's K/V against the reference. A prompt
    of 130 tokens (134 positions with the meta tokens) evicts the meta
    tokens from the 128-slot ring at prefill. ``flash_decode`` reaches B5
    on the global layer alone: one call per step."""
    jc, tc = _cfgs()
    jp, tp = weights()
    steps = 8
    jt, tt = _tokens(tc.vocab, 2, plen + steps, seed=3)
    max_seq = plen + steps
    jl, jcache = jax.jit(lambda p, t: jax_prefill(p, {"tokens": t}, jc, max_seq=max_seq))(
        jp, jt[:, :plen])
    tl, tcache = prefill(tp, {"tokens": tt[:, :plen]}, tc, max_seq=max_seq)
    _close(tl, jl)
    pos = tcache[1]["p0"]["attn"]["pos"]
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jcache[1]["p0"]["attn"]["pos"]))
    assert int(pos.min()) == (plen + 4 - 128 if plen == 130 else -1)
    if per_row:
        jcache = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a[:, None], (a.shape[0], 2) + a.shape[1:])
            if a.dtype == jnp.int32 else a, jcache)
        tcache[1]["p0"]["attn"]["pos"] = pos[:, None].expand(-1, 2, -1).clone()
    for i in range(plen, plen + steps):
        jidx = jnp.full((2,), i, jnp.int32) if per_row else i
        tidx = torch.full((2,), i) if per_row else i
        jl, jcache = _jax_decode(jp, jcache, jt[:, i:i + 1], jidx, jc)
        tl, tcache = decode_step(tp, tcache, tt[:, i:i + 1], tidx, tc, flash_decode=True)
        _close(tl, jl)
    for key, want in jax_flat(jcache).items():
        got = flatten_with_paths(tcache)[key]
        if got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=key)
        else:
            _close(got, want)
    assert b5_calls == ["flash_decode"] * steps


@pytest.mark.parametrize("beam", [1, 3])
def test_generate_matches_reference(beam, weights, b5_calls):
    """Greedy (the slot pool, per-row) and beam-3 search (the SSM leaves and
    the global K/V re-gathered by parent beam, the ring's batchless ``pos``
    left as it is): the reference's tokens; beam 1 is greedy."""
    jc, tc = _cfgs()
    jp, tp = weights()
    jt, tt = _tokens(tc.vocab, 2, 11, seed=5)
    gen = GenerateConfig(max_new=10, eos_id=-1, beam_width=beam, flash_decode=True)
    want = jax_generate(jp, {"tokens": jt}, jc, JaxGen(max_new=10, eos_id=-1, beam_width=beam))
    got = generate(tp, {"tokens": tt}, tc, gen)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert len(set(got.tokens.flatten().tolist())) > 3
    if beam == 1:
        # the beam-search loop at width 1 (one scalar index, every cache
        # leaf re-gathered each step) gives the greedy tokens
        beam1 = E._generate_beam(tp, {"tokens": tt}, tc, gen)
        assert torch.equal(beam1.tokens, got.tokens)
        assert b5_calls.count("flash_decode") == 2 * 9


# ---------------------------------------------------------------------------
# serving: the slot pool, the paged arena
# ---------------------------------------------------------------------------

LENS, BUDGETS = (5, 12, 20), (6, 9, 4)


def _requests(vocab, cls, n=5):
    rng = np.random.default_rng(2)
    return [cls(rid=i, tokens=rng.integers(3, vocab, size=LENS[i % 3]).astype(np.int32),
                max_new=BUDGETS[i % 3], arrival=0.0) for i in range(n)]


def _oneshot(tp, tc, reqs, max_seq):
    return {r.rid: generate(tp, {"tokens": torch.from_numpy(r.tokens[None]).long()}, tc,
                            GenerateConfig(max_new=r.max_new, eos_id=-1, max_seq=max_seq)
                            ).tokens[0].numpy() for r in reqs}


def test_continuous_exact_prefill_matches_oneshot_and_reference(weights):
    """The slot pool prefills each prompt at its exact length (the SSM
    state integrates pads): tokens equal the port's one-shot ``generate``
    and the reference's scheduler."""
    jc, tc = _cfgs()
    jp, tp = weights()
    kw = dict(n_slots=2, prefill_buckets=(8, 16), max_seq=32)
    sched = ContinuousScheduler(tp, tc, GenerateConfig(max_new=9, eos_id=-1,
                                                       flash_decode=True), **kw)
    assert sched.exact_prefill
    reqs = _requests(tc.vocab, Request)
    got = {r.rid: r.tokens for r in sched.run(reqs)}
    assert sched.stats["admitted"] == sched.stats["finished"] == len(reqs)
    jsched = JaxScheduler(jp, jc, JaxGen(max_new=9, eos_id=-1), **kw)
    want = {r.rid: r.tokens for r in jsched.run(_requests(jc.vocab, JaxRequest))}
    one = _oneshot(tp, tc, reqs, 32)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], one[r.rid], err_msg=f"one-shot {r.rid}")
        np.testing.assert_array_equal(got[r.rid], np.asarray(want[r.rid]), err_msg=str(r.rid))


PAGED_META, PAGE, PAGES = 16, 8, 9


def test_paged_arena_shares_meta_pages_preempts_and_matches_reference(weights, b5_calls):
    """An arena of 9 pages of 8 over 16 meta tokens: the two meta pages
    hold the same bytes for every request and share one prefix key, so
    every admission after the first group (two prompts of one length)
    hits the prefix cache; the arena is too small for the 3 slots and
    preempts (swap-out and swap-in carry the ring and the SSM state beside
    the pages). Tokens and page counters equal the reference's scheduler;
    tokens equal the port's slot pool; B6 (its plain version here) reads
    the global layer alone."""
    jc, tc = _cfgs(PAGED_META)
    jp, tp = weights(PAGED_META)
    gen = GenerateConfig(max_new=9, eos_id=-1, flash_decode=True)
    kw = dict(n_slots=3, prefill_buckets=(8, 16), max_seq=32)
    sched = PagedScheduler(tp, tc, gen, paged=PagedKVConfig(page_size=PAGE, n_pages=PAGES),
                           **kw)
    assert sched.layout.seq_len == 32 + PAGED_META and sched.layout.n_blocks == 6
    reqs = _requests(tc.vocab, Request, n=6)
    got = {r.rid: r.tokens for r in sched.run(reqs)}
    jsched = JaxPagedScheduler(jp, jc, JaxGen(max_new=9, eos_id=-1),
                               paged=JaxPagedKVConfig(page_size=PAGE, n_pages=PAGES), **kw)
    want = {r.rid: np.asarray(r.tokens)
            for r in jsched.run(_requests(jc.vocab, JaxRequest, n=6))}
    st = sched.stats
    assert st["admitted"] == st["finished"] == len(reqs)
    for k in ("prefix_hits", "prefix_lookups", "cow_copies", "preemptions", "swap_ins",
              "peak_pages_in_use", "decode_steps", "prefill_calls"):
        assert st[k] == jsched.stats[k], (k, st, jsched.stats)
    assert st["prefix_hits"] >= len(reqs) - 2 and st["preemptions"] > 0
    slot = ContinuousScheduler(tp, tc, gen, **kw)
    pool = {r.rid: r.tokens for r in slot.run(_requests(tc.vocab, Request, n=6))}
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid], err_msg=str(r.rid))
        np.testing.assert_array_equal(got[r.rid], pool[r.rid], err_msg=f"pool {r.rid}")
    assert b5_calls.count("flash_decode_paged") == st["decode_steps"]
    sched._pages.check()


# ---------------------------------------------------------------------------
# --task lm, the CLIs
# ---------------------------------------------------------------------------

def test_lm_train_steps_match_reference(weights):
    """Three steps of reduced hymba on the LM task (sequences of 24 behind
    the 4 meta tokens) against the reference's per-step update."""
    jc, tc = _cfgs()
    jp, tp = weights()
    kw = dict(lr=1e-3, warmup_steps=2, seed=0, steps=3)
    task = SyntheticLM(LMTaskConfig(vocab=tc.vocab, seq_len=24))
    jstep = jax_make_step(jc, JaxTC(**kw))
    jstate = jax_init_state(jax.tree_util.tree_map(jnp.array, jp), JaxTC(**kw))
    state = init_train_state(bridge.to_torch(bridge.to_numpy(tp)[0], "cpu"), TrainConfig(**kw))
    step = make_train_step(tc, TrainConfig(**kw))
    for i in range(3):
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
    assert not torch.equal(state["params"]["meta"].detach(), tp["meta"])    # meta trains


def test_clis_on_cpu(tmp_path, b5_calls):
    out = tmp_path / "s.json"
    serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "20", "--max-new", "3", "--eos", "-1", "--flash-decode",
                    "--json-out", str(out)])
    assert len(json.load(open(out))["tokens"][0]) == 3
    serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--trace", "4",
                    "--slots", "2", "--max-new", "3", "--eos", "-1", "--paged",
                    "--flash-decode", "--json-out", str(out)])
    rec = json.load(open(out))
    assert rec["scheduler"]["admitted"] == rec["scheduler"]["finished"] == 4
    assert "flash_decode" in b5_calls and "flash_decode_paged" in b5_calls
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--task", "lm",
                    "--steps", "2", "--batch", "2", "--seq", "20", "--log-every", "1",
                    "--no-prefetch", "--json-out", str(out)])
    hist = json.load(open(out))["history"]
    assert [r["step"] for r in hist] == [0, 1] and all(np.isfinite(r["loss"]) for r in hist)
