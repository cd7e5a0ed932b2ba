"""The VLM (llama-3.2-vision-90b) in the port against the JAX package, on the
CPU: its config and plan (a tanh-gated cross-attention layer every fifth
layer, no self-attention there), its layout (``img_proj``, the scalar
gates, no ``ln1`` and only cross K/V at a gated layer), the image
projection through ``model_apply``, ``prefill`` and ``decode_step`` (B5
on the self-attention layers alone), greedy and beam ``generate``, the
slot pool and the page arena on requests that carry their own float
images, and the gradients of a loss step.

Both packages run the reference's ``reduced()`` config (d 256, 4 heads,
16 image embeddings of width 64, a gated layer every 2nd layer) at 2
layers (two segments of one layer) and at 4 (one segment of a gated and
a self-attention layer, repeated twice). The gates are set to seeded
nonzero values in the numpy parameters fed to both packages: at the
reference's zero init the cross layers add exactly nothing. Weights are
the reference's seeded init, carried over by ``bridge``; inputs are
seeded numpy.

Tolerances: integer outputs (plans, tokens, page counters) are exact; the
models' f32 logits and caches within 2e-4 abs (the bound of
``test_torch_decoder_only.py``); gradients within 2e-5 abs.
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
from repro.training.steps import total_loss as jax_total_loss  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS, PagedKVConfig, get_config, reduced  # noqa: E402
from repro_torch.data import LMTaskConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import (decode_step, init_cache, init_model,  # noqa: E402
                                model_apply, prefill)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, GenerateConfig,  # noqa: E402
                               PagedScheduler, Request, generate)
from repro_torch.serve.engine import _cache_batch_axes  # noqa: E402
from repro_torch.serve.paged import _cache_page_axes  # noqa: E402
from repro_torch.training.steps import total_loss  # noqa: E402
from repro_torch.tree import flatten_with_paths, unflatten_paths  # noqa: E402

_jax_decode = jax.jit(jax_decode_step, static_argnums=(4,))

ARCH = "llama-3.2-vision-90b"
ATOL = 2e-4
N_IMG, D_IMG = 16, 64              # reduced()'s image embeddings


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


def _cfgs(n_layers=2):
    return (jax_reduced(jax_get_config(ARCH), n_layers=n_layers),
            reduced(get_config(ARCH), n_layers=n_layers))


@pytest.fixture(scope="module")
def weights():
    """The reference's seeded init per depth with every gate set to a
    seeded value in [0.3, 1): (reference tree, port tree)."""
    cache = {}

    def get(n_layers=2):
        if n_layers not in cache:
            jc, _ = _cfgs(n_layers)
            jp = jax.jit(jax_init_model, static_argnums=1)(jax.random.PRNGKey(0), jc)
            flat = jax_flat(jp)
            rs = np.random.RandomState(11)
            for k in sorted(flat):
                if k.rsplit("/", 1)[-1] in ("gate_attn", "gate_ffn"):
                    flat[k] = rs.uniform(0.3, 1.0, flat[k].shape).astype(np.float32)
            cache[n_layers] = (jax.tree_util.tree_map(jnp.asarray, unflatten_paths(flat)),
                               bridge.to_torch(flat, "cpu"))
        return cache[n_layers]
    return get


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0.0)


def _batch(vocab, b, l, seed=1):
    """Seeded prompt tokens and f32 N(0, 1) image embeddings, as (reference
    batch, port batch)."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(3, vocab, (b, l))
    img = rs.standard_normal((b, N_IMG, D_IMG)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "img_embeds": jnp.asarray(img)},
            {"tokens": torch.from_numpy(toks), "img_embeds": torch.from_numpy(img)})


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
    return [(s.repeats, [(p.mixer, p.cross, p.gated_cross, p.moe, p.window)
                         for p in s.pattern]) for s in segs]


# ---------------------------------------------------------------------------
# config, plan, layout
# ---------------------------------------------------------------------------

def test_config_plan_and_counts_match():
    """The config field for field (``fsdp`` on, as in the reference) and
    its counts; the plan of 100 layers is one segment of a gated layer and
    four self-attention layers, repeated 20 times, as the reference's
    (``tests/test_models.py``); the reduced plans at 2 and 4 layers; the
    depth cut to 10 keeps layers 0 and 5 gated."""
    jfull, tfull = jax_get_config(ARCH), get_config(ARCH)
    assert ARCH in ARCHS and tfull.source == jfull.source
    for jc, tc in ((jfull, tfull), _cfgs(2), _cfgs(4)):
        for f in dataclasses.fields(tc):
            if f.name != "vlm":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert dataclasses.asdict(tc.vlm) == dataclasses.asdict(jc.vlm)
        assert tc.n_params() == jc.n_params()
        assert _plan(T.layer_plan(tc)) == _plan(JT.layer_plan(jc))
    assert jfull.fsdp and tfull.fsdp == jfull.fsdp
    segs = T.layer_plan(tfull)
    assert len(segs) == 1 and segs[0].repeats == 20 and len(segs[0].pattern) == 5
    gated = segs[0].pattern[0]
    assert (gated.mixer, gated.cross, gated.gated_cross, gated.moe) == ("none", True, True,
                                                                        False)
    assert {(p.mixer, p.cross) for p in segs[0].pattern[1:]} == {("gqa", False)}
    assert [s.repeats for s in T.layer_plan(_cfgs(2)[1])] == [1, 1]
    assert [(s.repeats, len(s.pattern)) for s in T.layer_plan(_cfgs(4)[1])] == [(2, 2)]
    cut = serve_cli.cut_depth(tfull, 10)
    flat = [p for s in T.layer_plan(cut) for _ in range(s.repeats) for p in s.pattern]
    assert [i for i, p in enumerate(flat) if p.gated_cross] == [0, 5]
    assert all(p.mixer == ("none" if p.gated_cross else "gqa") for p in flat)
    # the reference counts a gated layer as a GQA self-attention layer and
    # leaves out img_proj (and, as for every arch, the norms): the init
    # holds four d x d cross projections; shown on a reduced config with
    # GQA (2 kv heads for 4), where the two counts differ as at full size
    gqa = reduced(get_config(ARCH), n_layers=4, n_kv_heads=2)
    init = sum(t.numel() for t in flatten_with_paths(
        init_model(torch.Generator().manual_seed(0), gqa)).values())
    d, kvd = gqa.d_model, gqa.n_kv_heads * gqa.head_dim_
    n_norms = 2 * gqa.n_layers + 1
    assert init - gqa.n_params() == 2 * 2 * d * (d - kvd) + D_IMG * d + n_norms * d + 2 * 2
    assert round(tfull.n_params() / 1e9, 2) == 87.67


@pytest.mark.parametrize("n_layers", [2, 4])
def test_init_layout_matches_reference(n_layers, weights):
    """The reference's keys and shapes: ``img_proj`` (d_image, d) at std
    d_image^-0.5, the gates stacked over the segment's repeats, no ``ln1``
    at a gated layer; the decode cache holds only cross K/V there (of
    ``n_image_tokens`` by default), slot-addressed; only the
    self-attention K/V page; the gates round-trip through the bridge."""
    jp, tp = weights(n_layers)
    jc, tc = _cfgs(n_layers)
    jflat = jax_flat(jp)
    tflat = flatten_with_paths(init_model(torch.Generator().manual_seed(0), tc))
    assert sorted(tflat) == sorted(jflat) == sorted(flatten_with_paths(tp))
    for key, want in jflat.items():
        assert tuple(tflat[key].shape) == want.shape and tflat[key].dtype == torch.float32, key
    reps = 2 if n_layers == 4 else 1
    assert tflat["decoder/0/p0/gate_attn"].shape == (reps,)
    assert not torch.count_nonzero(tflat["decoder/0/p0/gate_ffn"])
    assert "decoder/0/p0/ln1/scale" not in tflat and "decoder/0/p0/attn/wq" not in tflat
    assert tflat["img_proj"].shape == (D_IMG, 256)
    assert abs(float(tflat["img_proj"].std()) - D_IMG ** -0.5) < 0.1 * D_IMG ** -0.5
    jcache = jax_flat(JT.init_stack_cache(JT.layer_plan(jc), jc, 2, 20, N_IMG, jnp.float32))
    tcache = flatten_with_paths(init_cache(tc, 2, 20))
    assert sorted(tcache) == sorted(jcache)
    for key, want in jcache.items():
        assert tuple(tcache[key].shape) == want.shape, key
    gated = "0/p0"
    assert {k for k in tcache if k.startswith(gated + "/")} == {f"{gated}/cross/k",
                                                                f"{gated}/cross/v"}
    bat, seq = _cache_page_axes(tc)
    assert {k for k, a in flatten_with_paths(seq).items() if a >= 0} == \
        {k for k in tcache if "/attn/" in k}
    assert flatten_with_paths(_cache_batch_axes(tc))[f"{gated}/cross/k"] == 1
    # gates through the bridge both ways, a 0-d leaf kept 0-d
    back, _ = bridge.to_numpy(tp)
    for k in ("decoder/0/p0/gate_attn", "decoder/0/p0/gate_ffn", "img_proj"):
        np.testing.assert_array_equal(back[k], jflat[k], err_msg=k)
        assert back[k].shape == jflat[k].shape
    scalar = bridge.to_torch({"g": np.float32(0.5)}, "cpu")["g"]
    assert scalar.shape == () and float(scalar) == 0.5
    assert bridge.to_numpy({"g": scalar})[0]["g"].shape == ()


# ---------------------------------------------------------------------------
# the model: image projection, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [2, 4])
def test_model_apply_matches(n_layers, weights):
    """Logits against the reference with nonzero gates; at zero gates the
    image changes nothing (the cross layers add exactly zero)."""
    jc, tc = _cfgs(n_layers)
    jp, tp = weights(n_layers)
    jb, tb = _batch(tc.vocab, 2, 12)
    want, _ = jax.jit(lambda p, b: jax_model_apply(p, b, jc, is_training=False))(jp, jb)
    got, _ = model_apply(tp, tb, tc, is_training=False)
    assert got.shape == (2, 12, tc.vocab)
    _close(got, want)
    other = dict(tb, img_embeds=tb["img_embeds"] + 1.0)
    assert not torch.allclose(model_apply(tp, other, tc, is_training=False)[0], got)
    zero = {k: (torch.zeros_like(v) if "gate_" in k else v)
            for k, v in flatten_with_paths(tp).items()}
    zero = unflatten_paths(zero)
    assert torch.equal(model_apply(zero, tb, tc, is_training=False)[0],
                       model_apply(zero, other, tc, is_training=False)[0])


@pytest.mark.parametrize("n_layers,per_row", [(2, False), (2, True), (4, True)])
def test_prefill_and_decode_match(n_layers, per_row, weights, b5_calls):
    """Prefill, then 6 decode steps at one scalar index or per row (the slot
    pool's layout): logits and every cache leaf against the reference;
    ``flash_decode`` reaches B5 on the self-attention layers alone."""
    jc, tc = _cfgs(n_layers)
    jp, tp = weights(n_layers)
    plen, steps = 7, 6
    jb, tb = _batch(tc.vocab, 2, plen + steps, seed=3)
    max_seq = plen + steps
    jl, jcache = jax.jit(lambda p, b: jax_prefill(p, b, jc, max_seq=max_seq))(
        jp, dict(jb, tokens=jb["tokens"][:, :plen]))
    tl, tcache = prefill(tp, dict(tb, tokens=tb["tokens"][:, :plen]), tc, max_seq=max_seq)
    _close(tl, jl)
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
    assert b5_calls == ["flash_decode"] * (n_layers // 2) * steps


@pytest.mark.parametrize("beam", [1, 3])
def test_generate_matches_reference(beam, weights, b5_calls):
    """Greedy (the slot pool, per-row) and beam-3 search (each image tiled
    with its prompt, the cross K/V re-gathered by parent beam): the
    reference's tokens."""
    jc, tc = _cfgs(4)
    jp, tp = weights(4)
    jb, tb = _batch(tc.vocab, 2, 9, seed=5)
    want = jax_generate(jp, jb, jc, JaxGen(max_new=8, eos_id=-1, beam_width=beam))
    got = generate(tp, tb, tc, GenerateConfig(max_new=8, eos_id=-1, beam_width=beam,
                                              flash_decode=True))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert len(set(got.tokens.flatten().tolist())) > 3
    assert b5_calls.count("flash_decode") == 2 * 7


# ---------------------------------------------------------------------------
# serving: float images through the slot pool and the page arena
# ---------------------------------------------------------------------------

LENS, BUDGETS = (5, 12, 20), (6, 9, 4)


def _requests(vocab, cls, n=5, same_prompt=False):
    """Requests with their own f32 images (no whole numbers among them);
    ``same_prompt`` gives every request the first one's prompt."""
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(n):
        toks = rng.integers(3, vocab, size=LENS[i % 3]).astype(np.int32)
        img = rng.standard_normal((N_IMG, D_IMG)).astype(np.float32)
        reqs.append(cls(rid=i, tokens=reqs[0].tokens if same_prompt and reqs else toks,
                        extras={"img_embeds": img}, max_new=BUDGETS[i % 3], arrival=0.0))
    return reqs


def _oneshot(tp, tc, reqs, max_seq):
    return {r.rid: generate(tp, {"tokens": torch.from_numpy(r.tokens[None]).long(),
                                 "img_embeds": torch.from_numpy(r.extras["img_embeds"][None])},
                            tc, GenerateConfig(max_new=r.max_new, eos_id=-1, max_seq=max_seq)
                            ).tokens[0].numpy() for r in reqs}


def test_schedulers_carry_float_images_and_match_reference(weights, b5_calls):
    """Five requests, each with its own f32 image, through the slot pool
    and an arena of 6 pages of 8 that preempts: tokens equal the port's
    one-shot ``generate`` and the reference's ``ContinuousScheduler`` and
    ``PagedScheduler``, whose page counters the arena's equal. An image
    cast to integers on admission changes every token that reads it."""
    jc, tc = _cfgs(4)
    jp, tp = weights(4)
    gen = GenerateConfig(max_new=9, eos_id=-1, flash_decode=True)
    kw = dict(n_slots=3, prefill_buckets=(8, 16, 32), max_seq=32)
    reqs = _requests(tc.vocab, Request)
    assert all((r.extras["img_embeds"] != np.round(r.extras["img_embeds"])).all()
               for r in reqs)
    pool = ContinuousScheduler(tp, tc, gen, **kw)
    got_pool = {r.rid: r.tokens for r in pool.run(reqs)}
    paged = PagedScheduler(tp, tc, gen, paged=PagedKVConfig(page_size=8, n_pages=6), **kw)
    got_paged = {r.rid: r.tokens for r in paged.run(_requests(tc.vocab, Request))}
    assert paged.stats["finished"] == len(reqs) and paged.stats["preemptions"] > 0
    assert b5_calls.count("flash_decode_paged") == 2 * paged.stats["decode_steps"]
    assert b5_calls.count("flash_decode") == 2 * pool.stats["decode_steps"]
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
    one = _oneshot(tp, tc, reqs, 32)
    for r in reqs:
        for name, got in (("pool", got_pool), ("paged", got_paged)):
            np.testing.assert_array_equal(got[r.rid], one[r.rid], err_msg=f"{name} {r.rid}")
        np.testing.assert_array_equal(got_pool[r.rid], want_pool[r.rid], err_msg=str(r.rid))
        np.testing.assert_array_equal(got_paged[r.rid], want_paged[r.rid], err_msg=str(r.rid))
    paged._pages.check()


def test_arena_keys_prefix_pages_on_the_image(weights):
    """Four requests with one prompt and four images: every layer after
    the first (gated) one reads the image, so no page is shared between
    them (the reference keys pages on the prompt alone and would share
    them, ROADMAP.md C); tokens equal one-shot. The same image again hits
    the prefix cache."""
    _, tc = _cfgs(4)
    _, tp = weights(4)
    gen = GenerateConfig(max_new=5, eos_id=-1)
    kw = dict(n_slots=2, prefill_buckets=(16, 32), max_seq=32)
    reqs = _requests(tc.vocab, Request, n=4, same_prompt=True)
    for r in reqs:
        r.max_new = 5
    sched = PagedScheduler(tp, tc, gen, paged=PagedKVConfig(page_size=4), **kw)
    got = {r.rid: r.tokens for r in sched.run(reqs)}
    assert sched.stats["prefix_hits"] == 0
    one = _oneshot(tp, tc, reqs, 32)
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], one[r.rid], err_msg=str(r.rid))
    assert len({tuple(t) for t in got.values()}) > 1
    again = dataclasses.replace(reqs[1], rid=9)
    sched.run([again])
    assert sched.stats["prefix_hits"] == 1


# ---------------------------------------------------------------------------
# gradients, the CLIs
# ---------------------------------------------------------------------------

def test_loss_and_gradients_match_reference(weights):
    """The LM loss on a batch with images (``training/steps.py::total_loss``)
    and every gradient against ``jax.grad`` of the reference's: the gates'
    and ``img_proj``'s are nonzero and agree."""
    jc, tc = _cfgs(4)
    jp, tp = weights(4)
    batch = SyntheticLM(LMTaskConfig(vocab=tc.vocab, seq_len=12)).sample_batch(0, 2)
    img = np.random.RandomState(7).standard_normal((2, N_IMG, D_IMG)).astype(np.float32)
    jb = {**{k: jnp.asarray(v) for k, v in batch.items()}, "img_embeds": jnp.asarray(img)}
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jax_total_loss(p, jb, jc, None, rng=None, decision=False),
        has_aux=True))(jp)
    params = bridge.to_torch(bridge.to_numpy(tp)[0], "cpu")
    leaves = flatten_with_paths(params)
    for t in leaves.values():
        t.requires_grad_(True)
    tb = {**{k: torch.from_numpy(v) for k, v in batch.items()},
          "img_embeds": torch.from_numpy(img)}
    loss, _ = total_loss(params, tb, tc, generator=None, decision=False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=2e-5)
    jflat = jax_flat(jgrad)
    assert sorted(jflat) == sorted(leaves)
    for key, want in jflat.items():
        _close(leaves[key].grad, want, atol=2e-5)
    for key in ("decoder/0/p0/gate_attn", "decoder/0/p0/gate_ffn", "img_proj"):
        assert bool((leaves[key].grad != 0).all()), key


def test_clis_on_cpu(tmp_path, b5_calls):
    """The serve CLI one-shot and through the arena (images drawn per
    request); the train CLI refuses the VLM (no task carries images)."""
    out = tmp_path / "s.json"
    serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "6", "--max-new", "3", "--eos", "-1", "--flash-decode",
                    "--json-out", str(out)])
    assert len(json.load(open(out))["tokens"][0]) == 3
    serve_cli.main(["--arch", ARCH, "--reduced", "--layers", "2", "--device", "cpu",
                    "--trace", "4", "--slots", "2", "--max-new", "3", "--eos", "-1",
                    "--paged", "--flash-decode", "--json-out", str(out)])
    rec = json.load(open(out))
    assert rec["scheduler"]["admitted"] == rec["scheduler"]["finished"] == 4
    assert "flash_decode" in b5_calls and "flash_decode_paged" in b5_calls
    reqs = serve_cli.synth_trace(reduced(get_config(ARCH)), 0, 2, 10.0, (8,), 4)
    assert reqs[0].extras["img_embeds"].dtype == np.float32
    assert reqs[0].extras["img_embeds"].shape == (N_IMG, D_IMG)
    for task in ("lm", "mt"):
        with pytest.raises(ValueError, match="img_embeds"):
            train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--task", task,
                            "--steps", "1", "--batch", "2", "--seq", "8", "--no-prefetch"])
