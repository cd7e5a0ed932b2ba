"""whisper-small (the encoder-decoder on audio frames) in the port against
the JAX package, on the CPU: its config and plans, its layout, the
encoder on ``frames`` (the stub conv frontend's output: no token ids,
sinusoidal positions) and on ``enc_tokens`` through the same config,
``prefill`` and ``decode_step`` (B5 on every decoder layer), greedy and
beam ``generate``, the slot pool and the page arena on requests that
carry their own float frames, the staging of float conditioning inputs
(``serve/engine.py``), ``--task mt`` and the CLIs.

Both packages run the reference's ``reduced()`` config (d 256, 4 heads,
2 encoder and 2 decoder layers, 32 frames, layernorm, GELU). Weights are
the reference's seeded init, carried over by ``bridge``; inputs are
seeded numpy, the frames f32 N(0, 1).

Tolerances: integer outputs (plans, tokens, page counters) are exact; the
models' f32 logits and caches within 2e-4 abs (the bound of
``test_torch_decoder_only.py``); float inputs staged for the device are
bitwise the host's; ``--task mt`` losses within 2e-5 and parameters
within 2e-4 (those of ``test_torch_hybrid.py``).
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
from repro_torch.configs import (ARCHS, PagedKVConfig, TrainConfig,  # noqa: E402
                                 get_config, reduced)
from repro_torch.data import MTTaskConfig, MultilingualMT  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import (decode_step, init_cache, init_model,  # noqa: E402
                                model_apply, prefill)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, GenerateConfig,  # noqa: E402
                               PagedScheduler, Request, generate)
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

_jax_decode = jax.jit(jax_decode_step, static_argnums=(4,))

ARCH = "whisper-small"
ATOL = 2e-4
N_FRAMES, D = 32, 256              # reduced()'s encoder_seq and d_model


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


def _cfgs():
    return jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))


@pytest.fixture(scope="module")
def weights():
    """The reference's seeded init and its bridge: (reference, port)."""
    jc, _ = _cfgs()
    jp = jax.jit(jax_init_model, static_argnums=1)(jax.random.PRNGKey(0), jc)
    return jp, bridge.to_torch(jax_flat(jp), "cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0.0)


def _batch(vocab, b, l, seed=1, source="frames"):
    """Seeded prompt tokens and f32 N(0, 1) frames (or source tokens), as
    (reference batch, port batch)."""
    rs = np.random.RandomState(seed)
    out = {"tokens": rs.randint(3, vocab, (b, l))}
    if source == "frames":
        out["frames"] = rs.standard_normal((b, N_FRAMES, D)).astype(np.float32)
    else:
        out["enc_tokens"] = rs.randint(3, vocab, (b, 20))
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


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
    return [(s.repeats, [(p.mixer, p.cross, p.moe, p.causal) for p in s.pattern])
            for s in segs]


# ---------------------------------------------------------------------------
# config, plans, layout
# ---------------------------------------------------------------------------

def test_config_plans_and_layout_match(weights):
    """The config field for field and its counts, full and reduced; the
    encoder's plan (non-causal, no cross-attention) and the decoder's
    (cross-attention in every layer); the init's keys and shapes (no
    ``img_proj``, layernorm biases); the decode cache's cross K/V at the
    frames' length by default (``encoder_seq``)."""
    jfull, tfull = jax_get_config(ARCH), get_config(ARCH)
    assert ARCH in ARCHS and tfull.source == jfull.source
    for jc, tc in ((jfull, tfull), _cfgs()):
        for f in dataclasses.fields(tc):
            if f.name != "encdec":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert dataclasses.asdict(tc.encdec) == dataclasses.asdict(jc.encdec)
        assert tc.n_params() == jc.n_params()
        for enc in (False, True):
            assert _plan(T.layer_plan(tc, encoder=enc)) == _plan(JT.layer_plan(jc, encoder=enc))
    assert tfull.encdec.frontend == "stub" and round(tfull.n_params() / 1e6, 1) == 277.8
    assert _plan(T.layer_plan(tfull, encoder=True)) == [(12, [("gqa", False, False, False)])]
    assert _plan(T.layer_plan(tfull)) == [(12, [("gqa", True, False, True)])]
    jp, tp = weights
    jc, tc = _cfgs()
    jflat = jax_flat(jp)
    tflat = flatten_with_paths(init_model(torch.Generator().manual_seed(0), tc))
    assert sorted(tflat) == sorted(jflat) == sorted(flatten_with_paths(tp))
    for key, want in jflat.items():
        assert tuple(tflat[key].shape) == want.shape and tflat[key].dtype == torch.float32, key
    assert "img_proj" not in tflat and "encoder/0/p0/ln1/bias" in tflat
    tcache = flatten_with_paths(init_cache(tc, 2, 20))
    jcache = jax_flat(JT.init_stack_cache(JT.layer_plan(jc), jc, 2, 20, N_FRAMES, jnp.float32))
    assert sorted(tcache) == sorted(jcache)
    for key, want in jcache.items():
        assert tuple(tcache[key].shape) == want.shape, key


# ---------------------------------------------------------------------------
# the model: frames and source tokens, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["frames", "enc_tokens"])
def test_model_apply_matches(source, weights):
    """The encoder on frames (cast to the activation dtype, sinusoidal
    positions, no embedding) and on source tokens through the same config:
    logits against the reference."""
    jc, tc = _cfgs()
    jp, tp = weights
    jb, tb = _batch(tc.vocab, 2, 12, source=source)
    want, _ = jax.jit(lambda p, b: jax_model_apply(p, b, jc, is_training=False))(jp, jb)
    got, _ = model_apply(tp, tb, tc, is_training=False)
    assert got.shape == (2, 12, tc.vocab)
    _close(got, want)


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_and_decode_match(per_row, weights, b5_calls):
    """Prefill on frames, then 6 decode steps at one scalar index or per
    row: logits and every cache leaf (the cross K/V of the 32 frames)
    against the reference; B5 on every decoder layer, every step."""
    jc, tc = _cfgs()
    jp, tp = weights
    plen, steps = 7, 6
    jb, tb = _batch(tc.vocab, 2, plen + steps, seed=3)
    max_seq = plen + steps
    jl, jcache = jax.jit(lambda p, b: jax_prefill(p, b, jc, max_seq=max_seq))(
        jp, dict(jb, tokens=jb["tokens"][:, :plen]))
    tl, tcache = prefill(tp, dict(tb, tokens=tb["tokens"][:, :plen]), tc, max_seq=max_seq)
    _close(tl, jl)
    assert tcache[0]["p0"]["cross"]["k"].shape[2] == N_FRAMES
    for i in range(plen, plen + steps):
        jidx = jnp.full((2,), i, jnp.int32) if per_row else i
        tidx = torch.full((2,), i) if per_row else i
        jl, jcache = _jax_decode(jp, jcache, jb["tokens"][:, i:i + 1], jidx, jc)
        tl, tcache = decode_step(tp, tcache, tb["tokens"][:, i:i + 1], tidx, tc,
                                 flash_decode=True)
        _close(tl, jl)
    tflat = flatten_with_paths(tcache)
    for key, want in jax_flat(jcache).items():
        _close(tflat[key], want)
    assert b5_calls == ["flash_decode"] * tc.n_layers * steps


@pytest.mark.parametrize("beam", [1, 3])
def test_generate_matches_reference(beam, weights):
    jc, tc = _cfgs()
    jp, tp = weights
    jb, tb = _batch(tc.vocab, 2, 9, seed=5)
    want = jax_generate(jp, jb, jc, JaxGen(max_new=8, eos_id=-1, beam_width=beam))
    got = generate(tp, tb, tc, GenerateConfig(max_new=8, eos_id=-1, beam_width=beam,
                                              flash_decode=True))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert len(set(got.tokens.flatten().tolist())) > 3


# ---------------------------------------------------------------------------
# serving: float frames staged, through the slot pool and the page arena
# ---------------------------------------------------------------------------

def test_float_inputs_reach_the_device_unchanged():
    """``to_device_packed`` packs integer (and bool) arrays only and refuses
    a float one rather than cast it to int64; ``to_device_batch`` sends the
    integer arrays packed and each float one in its own dtype, bitwise;
    ``cross_len`` reads whichever source a batch has."""
    rs = np.random.RandomState(0)
    frames = rs.standard_normal((2, 5, 3)).astype(np.float32)
    ints = {"tokens": rs.randint(0, 9, (2, 4)), "alive": np.array([True, False])}
    with pytest.raises(TypeError, match="frames"):
        E.to_device_packed(dict(ints, frames=frames), torch.device("cpu"))
    out = E.to_device_batch(dict(ints, frames=frames), torch.device("cpu"))
    assert out["frames"].dtype == torch.float32
    np.testing.assert_array_equal(out["frames"].numpy(), frames)
    np.testing.assert_array_equal(out["tokens"].numpy(), ints["tokens"])
    assert out["alive"].tolist() == [1, 0]
    for key, shape in (("enc_tokens", (2, 7)), ("frames", (2, 5, 3)), ("img_embeds", (2, 6, 4))):
        assert E.cross_len({"tokens": np.zeros((2, 3)), key: np.zeros(shape)}) == shape[1]
    assert E.cross_len({"tokens": np.zeros((2, 3))}) is None


LENS, BUDGETS = (5, 12, 20), (6, 9, 4)


def _requests(vocab, cls, n=5):
    """Requests with their own f32 frames (no whole numbers among them)."""
    rng = np.random.default_rng(2)
    return [cls(rid=i, tokens=rng.integers(3, vocab, size=LENS[i % 3]).astype(np.int32),
                extras={"frames": rng.standard_normal((N_FRAMES, D)).astype(np.float32)},
                max_new=BUDGETS[i % 3], arrival=0.0) for i in range(n)]


def test_schedulers_carry_float_frames_and_match_reference(weights, b5_calls):
    """Five requests, each with its own f32 frames, through the slot pool
    and an arena of 6 pages of 8 that preempts: tokens equal the port's
    one-shot ``generate`` and the reference's ``ContinuousScheduler`` and
    ``PagedScheduler``, whose page counters the arena's equal. Frames cast
    to integers on admission would change the tokens."""
    jc, tc = _cfgs()
    jp, tp = weights
    gen = GenerateConfig(max_new=9, eos_id=-1, flash_decode=True)
    kw = dict(n_slots=3, prefill_buckets=(8, 16, 32), max_seq=32)
    reqs = _requests(tc.vocab, Request)
    assert all((r.extras["frames"] != np.round(r.extras["frames"])).all() for r in reqs)
    pool = ContinuousScheduler(tp, tc, gen, **kw)
    got_pool = {r.rid: r.tokens for r in pool.run(reqs)}
    paged = PagedScheduler(tp, tc, gen, paged=PagedKVConfig(page_size=8, n_pages=6), **kw)
    got_paged = {r.rid: r.tokens for r in paged.run(_requests(tc.vocab, Request))}
    assert paged.stats["finished"] == len(reqs) and paged.stats["preemptions"] > 0
    assert b5_calls.count("flash_decode_paged") == tc.n_layers * paged.stats["decode_steps"]
    jgen = JaxGen(max_new=9, eos_id=-1)
    want_pool = {r.rid: np.asarray(r.tokens)
                 for r in JaxScheduler(jp, jc, jgen, **kw).run(_requests(jc.vocab, JaxRequest))}
    jpaged = JaxPagedScheduler(jp, jc, jgen, paged=JaxPagedKVConfig(page_size=8, n_pages=6),
                               **kw)
    want_paged = {r.rid: np.asarray(r.tokens)
                  for r in jpaged.run(_requests(jc.vocab, JaxRequest))}
    for k in ("prefix_hits", "prefix_lookups", "cow_copies", "preemptions", "swap_ins",
              "peak_pages_in_use", "decode_steps", "prefill_calls"):
        assert paged.stats[k] == jpaged.stats[k], (k, paged.stats, jpaged.stats)
    for r in reqs:
        one = generate(tp, {"tokens": torch.from_numpy(r.tokens[None]).long(),
                            "frames": torch.from_numpy(r.extras["frames"][None])}, tc,
                       GenerateConfig(max_new=r.max_new, eos_id=-1, max_seq=32)).tokens[0]
        for name, got in (("pool", got_pool), ("paged", got_paged)):
            np.testing.assert_array_equal(got[r.rid], one.numpy(), err_msg=f"{name} {r.rid}")
        np.testing.assert_array_equal(got_pool[r.rid], want_pool[r.rid], err_msg=str(r.rid))
        np.testing.assert_array_equal(got_paged[r.rid], want_paged[r.rid], err_msg=str(r.rid))
    paged._pages.check()


# ---------------------------------------------------------------------------
# --task mt, the CLIs
# ---------------------------------------------------------------------------

def test_mt_train_steps_match_reference(weights):
    """Three steps of reduced whisper-small on the reference's MT task (the
    encoder on source tokens, as the reference's ``--task mt`` runs it)
    against the reference's per-step update."""
    jc, tc = _cfgs()
    jp, tp = weights
    kw = dict(lr=1e-3, warmup_steps=2, seed=0, steps=3)
    batches = MultilingualMT(MTTaskConfig(vocab=tc.vocab, n_langs=4,
                                          max_len=16)).train_batches(4)
    jstep = jax_make_step(jc, JaxTC(**kw))
    jstate = jax_init_state(jax.tree_util.tree_map(jnp.array, jp), JaxTC(**kw))
    state = init_train_state(bridge.to_torch(bridge.to_numpy(tp)[0], "cpu"), TrainConfig(**kw))
    step = make_train_step(tc, TrainConfig(**kw))
    for i in range(3):
        batch = batches(i)
        assert "enc_tokens" in batch and "frames" not in batch
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


def test_clis_on_cpu(tmp_path, b5_calls):
    """The serve CLI one-shot and through the slot pool on synthetic frames
    (drawn per request), the train CLI's ``--task mt``, and ``--task lm``
    refused (no source)."""
    out = tmp_path / "s.json"
    serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "6", "--max-new", "3", "--eos", "-1", "--flash-decode",
                    "--json-out", str(out)])
    assert len(json.load(open(out))["tokens"][0]) == 3
    serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--trace", "4",
                    "--slots", "2", "--max-new", "3", "--eos", "-1", "--flash-decode",
                    "--json-out", str(out)])
    rec = json.load(open(out))
    assert rec["scheduler"]["admitted"] == rec["scheduler"]["finished"] == 4
    assert b5_calls.count("flash_decode") > 0
    reqs = serve_cli.synth_trace(reduced(get_config(ARCH)), 0, 2, 10.0, (8,), 4)
    assert reqs[0].extras["frames"].dtype == np.float32
    assert reqs[0].extras["frames"].shape == (N_FRAMES, D)
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--task", "mt",
                    "--steps", "2", "--batch", "2", "--seq", "12", "--langs", "2",
                    "--log-every", "1", "--no-prefetch", "--json-out", str(out)])
    hist = json.load(open(out))["history"]
    assert [r["step"] for r in hist] == [0, 1] and all(np.isfinite(r["loss"]) for r in hist)
    with pytest.raises(ValueError, match="--task mt"):
        train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--task", "lm",
                        "--steps", "1", "--batch", "2", "--seq", "8", "--no-prefetch"])
