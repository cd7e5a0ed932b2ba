"""DeepSeek-V3 in the port against the JAX package, on the CPU: multi-head
latent attention (MLA) with its absorbed, per-row and paged decode, the
multi-token-prediction (MTP) head and its loss, and the sigmoid top-k MoE
with a shared expert after a leading dense layer, through serving and
``--task lm``.

Both packages run the reference's ``reduced()`` deepseek-v3-671b: 2 layers
(layer 0 dense, layer 1 MoE: 4 experts, sigmoid top-2 and one shared
expert), d 256, 4 heads, MLA ranks 64/32 and head dims 32/16/32 (q/k heads
of 48, v heads of 32), vocab 512, MTP on. Weights are the reference's
seeded init carried over by ``bridge``; inputs are seeded numpy.

Tolerances (``test_torch_swa.py``'s): attention outputs and latent caches
within 2e-5 abs + 1e-5 rel; f32 logits and MTP hidden states within 2e-4
abs; training losses within 2e-5, the grad norm within 2e-5 relative and
parameters within 2e-4 after the steps; expert ids, keep masks, drop bits,
tokens and positions exact; the paged decode bitwise the per-row decode.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.configs import PagedKVConfig as JaxPagedKVConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import TrainConfig as JaxTC  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.models import mla as JM  # noqa: E402
from repro.models import model_apply as jax_model_apply  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import GenerateConfig as JaxGen  # noqa: E402
from repro.serve import PagedScheduler as JaxPagedScheduler  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro.training import init_train_state as jax_init_state  # noqa: E402
from repro.training import make_train_step as jax_make_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import (ARCHS, PagedKVConfig, TrainConfig,  # noqa: E402
                                 get_config, reduced)
from repro_torch.core import gating_dropout as G  # noqa: E402
from repro_torch.core import router as R  # noqa: E402
from repro_torch.data import LMTaskConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import (decode_step, init_model, model_apply,  # noqa: E402
                                prefill)
from repro_torch.models import flash as F  # noqa: E402
from repro_torch.models import mla as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, GenerateConfig,  # noqa: E402
                               PagedScheduler, Request, generate)
from repro_torch.serve.engine import _cache_batch_axes  # noqa: E402
from repro_torch.serve.paged import _cache_page_axes  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCH = "deepseek-v3-671b"
ATT_ATOL, ATT_RTOL = 2e-5, 1e-5
LOGIT_ATOL = 2e-4
# the reference's decode step, compiled once per index form
_jax_decode = jax.jit(jax_decode_step, static_argnums=(4,))


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


def _cfgs(port_backend="oracle", jax_backend="oracle", **moe_kw):
    """Reduced deepseek-v3-671b in both packages, router jitter off."""
    jc, tc = jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, backend=jax_backend, jitter_eps=0.0, **moe_kw))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, backend=port_backend, jitter_eps=0.0, **moe_kw))
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    """The reference's seeded init and its bridge to torch."""
    jc, _ = _cfgs()
    jp = jax_init_model(jax.random.PRNGKey(0), jc)
    return jp, bridge.to_torch(jax_flat(jp), "cpu")


def _tokens(vocab, b, l, seed=1):
    toks = np.random.RandomState(seed).randint(3, vocab, (b, l))
    return jnp.asarray(toks), torch.from_numpy(toks)


def _close(got, want, atol=LOGIT_ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _same_fields(port, ref, path=""):
    """Every field of the port's (nested) config equals the reference's."""
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            _same_fields(got, want, f"{path}{f.name}.")
        else:
            assert got == want, f"{path}{f.name}: {got!r} != {want!r}"


# ---------------------------------------------------------------------------
# configs, counts, plans, the parameter layout
# ---------------------------------------------------------------------------

def test_config_matches_reference_but_fsdp():
    jfull, tfull = jax_get_config(ARCH), get_config(ARCH)
    _same_fields(tfull, jfull)
    _same_fields(reduced(tfull), jax_reduced(jfull))
    assert ARCH in ARCHS and tfull.source == "arXiv:2412.19437" and tfull.mtp
    # the weight sharding over the data axis, read by the dry run's
    # sharding rules (parallel/sharding.py)
    assert jfull.fsdp and tfull.fsdp == jfull.fsdp
    m = reduced(tfull).mla
    assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
            m.v_head_dim) == (64, 32, 32, 16, 32) and reduced(tfull).head_dim == 0
    moe = tfull.moe
    assert (moe.n_experts, moe.top_k, moe.n_shared_experts, moe.router_type,
            moe.first_dense_layers) == (256, 8, 1, "sigmoid", 3)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_match_reference(arch):
    """``n_params`` and ``n_active_params`` (MLA's attention term on
    deepseek) equal the reference's, full and reduced, for every ported
    arch."""
    for tc, jc in ((get_config(arch), jax_get_config(arch)),
                   (reduced(get_config(arch)), jax_reduced(jax_get_config(arch)))):
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
    if arch == ARCH:            # 671 B parameters, 37 B of them a token's (+ the embeddings)
        assert round(get_config(arch).n_params() / 1e9) == 671
        assert round(get_config(arch).n_active_params() / 1e9) == 40


def test_layer_plan_and_depth_cut():
    for tc, jc, dense in ((get_config(ARCH), jax_get_config(ARCH), 3),
                          (reduced(get_config(ARCH)), jax_reduced(jax_get_config(ARCH)), 1)):
        ts, js = T.layer_plan(tc), JT.layer_plan(jc)
        assert [(s.repeats, [(p.mixer, p.moe, p.window) for p in s.pattern]) for s in ts] == \
            [(s.repeats, [(p.mixer, p.moe, p.window) for p in s.pattern]) for s in js]
        flat = [p for s in ts for p in s.pattern for _ in range(s.repeats)]
        assert {p.mixer for p in flat} == {"mla"}
        assert [p.moe for p in flat][:dense + 1] == [False] * dense + [True]
    # the depth cut keeps the arch's two kinds of layer
    cut = serve_cli.cut_depth(get_config(ARCH), 2)
    assert cut.n_layers == 2 and cut.moe.first_dense_layers == 1
    assert [p.moe for s in T.layer_plan(cut) for p in s.pattern] == [False, True]
    assert serve_cli.cut_depth(get_config("dbrx-132b"), 2).moe.first_dense_layers == 0
    with pytest.raises(ValueError, match="--layers 62"):
        serve_cli.cut_depth(get_config(ARCH), 62)


def test_init_model_matches_reference_layout(weights):
    """The reference's keys and shapes, the MTP tree's block unstacked; the
    bridged tree is the port's layout."""
    jp, tp = weights
    _, tc = _cfgs()
    jflat = jax_flat(jp)
    tflat = flatten_with_paths(init_model(torch.Generator().manual_seed(0), tc))
    assert sorted(tflat) == sorted(jflat) == sorted(flatten_with_paths(tp))
    for key, want in jflat.items():
        assert tuple(tflat[key].shape) == want.shape, key
        assert tflat[key].dtype == torch.float32
        if want.size > 1000:    # same distribution, different bits
            assert abs(float(tflat[key].std()) - float(want.std())) \
                < 0.1 * float(want.std()) + 1e-6, key
    assert tflat["mtp/proj"].shape == (512, 256)
    assert tflat["mtp/block/attn/w_ukv"].shape == (32, 4, 64)          # no repeats axis
    assert tflat["mtp/block/ffn/w_in"].shape == (256, tc.d_ff)
    assert tflat["decoder/1/p0/shared/w_gate"].shape == (1, 256, 256)
    assert "decoder/0/p0/moe/router/w" not in tflat and "decoder/0/p0/ffn/w_in" in tflat
    assert not any(k.endswith(("/wq", "/wk", "/wv")) for k in tflat)


# ---------------------------------------------------------------------------
# MLA: attention, cache, absorbed decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_params():
    jc, _ = _cfgs()
    jp = JM.init_mla(jax.random.PRNGKey(3), jc, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("l,chunk", [(24, 2048), (160, 64)])
def test_mla_attention_matches_reference(l, chunk, mla_params, monkeypatch):
    """Outputs and the (c_kv, k_rope) cache pair; at chunk 64 both packages
    take the blocked flash attention (160 keys > 2 x 64) with q/k heads of
    48 and v heads of 32."""
    jc, tc = _cfgs()
    jp, tp = mla_params
    x = np.random.RandomState(l).randn(2, l, tc.d_model).astype(np.float32)
    calls = []
    real = F.flash_attention
    monkeypatch.setattr(F, "flash_attention", lambda *a: calls.append(a[3:]) or real(*a))
    jy, (jck, jkr) = JM.mla_attention(jp, jnp.asarray(x), jc, chunk=chunk, return_cache=True)
    ty, (tck, tkr) = M.mla_attention(tp, torch.from_numpy(x), tc, chunk=chunk,
                                     return_cache=True)
    assert calls == ([] if chunk == 2048 else [(True, 0, 0, 0, 64, 64)])
    assert tck.shape == (2, l, 32) and tkr.shape == (2, l, 16)
    for got, want in ((ty, jy), (tck, jck), (tkr, jkr)):
        _close(got, want, ATT_ATOL, ATT_RTOL)


S, PS = 16, 4             # cache length; page size of the paged form (S = 4 pages)


def _decode_case():
    rs = np.random.RandomState(11)
    c_kv = rs.randn(2, S, 32).astype(np.float32)
    k_rope = rs.randn(2, S, 16).astype(np.float32)
    xs = [rs.randn(2, 1, 256).astype(np.float32) for _ in range(4)]
    return c_kv, k_rope, xs


def _arena(cache, table, n_pages, seed):
    """The (2, S, .) cache as an arena of ``n_pages + 1`` pages of PS,
    row b's page j at ``table[b, j]``; the other pages hold noise."""
    arena = np.random.RandomState(seed).randn(n_pages + 1, PS, cache.shape[-1])
    arena = arena.astype(np.float32)
    for b in range(cache.shape[0]):
        for j in range(S // PS):
            arena[table[b, j]] = cache[b, j * PS:(j + 1) * PS]
    return arena


@pytest.mark.parametrize("mode", ["scalar", "per_row", "paged"])
def test_mla_decode_matches_reference(mode, mla_params):
    """Four absorbed decode steps against a filled cache: at one position
    (scalar), at the rows' own positions (5 and 9 onward), or through
    block tables over a permuted arena of pages of 4. Outputs and caches
    against the reference's; the paged read bitwise the per-row read, and
    its arena holding the per-row cache's rows."""
    jc, tc = _cfgs()
    jp, tp = mla_params
    c_kv, k_rope, xs = _decode_case()
    jcache = {"c_kv": jnp.asarray(c_kv), "k_rope": jnp.asarray(k_rope)}
    tcache = {"c_kv": torch.from_numpy(c_kv.copy()), "k_rope": torch.from_numpy(k_rope.copy())}
    table = None
    if mode == "paged":
        n_pages = 10
        table = np.random.RandomState(5).permutation(n_pages)[:2 * S // PS] \
            .reshape(2, S // PS).astype(np.int32)
        parts = {k: _arena(v, table, n_pages, i) for i, (k, v) in
                 enumerate((("c_kv", c_kv), ("k_rope", k_rope)))}
        jcache = {k: jnp.asarray(v) for k, v in parts.items()}
        pcache = {k: torch.from_numpy(v.copy()) for k, v in parts.items()}
        rcache = tcache                    # the per-row read it must equal bitwise
    for i, x in enumerate(xs):
        if mode == "scalar":
            jidx, tidx = 5 + i, 5 + i
        else:
            pos = np.array([5 + i, 9 + i], np.int32)
            jidx, tidx = jnp.asarray(pos), torch.from_numpy(pos).long()
        jy, jcache = JM.mla_decode(jp, jnp.asarray(x), jcache, jc, jidx,
                                   block_tables=None if table is None else jnp.asarray(table))
        if mode == "paged":
            ty, pcache = M.mla_decode(tp, torch.from_numpy(x), pcache, tc, tidx,
                                      block_tables=torch.from_numpy(table))
            ry, rcache = M.mla_decode(tp, torch.from_numpy(x), rcache, tc, tidx)
            assert torch.equal(ty, ry)
            tcache = pcache
        else:
            ty, tcache = M.mla_decode(tp, torch.from_numpy(x), tcache, tc, tidx)
        _close(ty, jy, ATT_ATOL, ATT_RTOL)
        for key in ("c_kv", "k_rope"):
            _close(tcache[key], jcache[key], ATT_ATOL, ATT_RTOL)
    if mode == "paged":
        bt = torch.from_numpy(table).long()
        for key in ("c_kv", "k_rope"):
            assert torch.equal(pcache[key][bt].reshape(2, S, -1), rcache[key])
    with pytest.raises(ValueError, match="per-row"):
        M.mla_decode(tp, torch.from_numpy(xs[0]), tcache, tc, 5,
                     block_tables=torch.zeros((2, S // PS), dtype=torch.int32))


def test_mla_cache_layout_is_batched_and_pageable():
    """The latent caches (repeats, batch, seq, c | dr): the slot pool finds
    their batch axis, the page arena their sequence axis."""
    _, tc = _cfgs()
    leaves = flatten_with_paths(M.init_mla_cache(tc, 3, 24, torch.float32, "meta",
                                                 lead=(1,)))
    assert {k: tuple(v.shape) for k, v in leaves.items()} == \
        {"c_kv": (1, 3, 24, 32), "k_rope": (1, 3, 24, 16)}
    bat, seq = _cache_page_axes(tc)
    assert flatten_with_paths(bat) == flatten_with_paths(_cache_batch_axes(tc))
    for si in range(2):
        assert bat[si]["p0"]["attn"] == {"c_kv": 1, "k_rope": 1}
        assert seq[si]["p0"]["attn"] == {"c_kv": 2, "k_rope": 2}


# ---------------------------------------------------------------------------
# the model: forward with the MTP head, prefill, decode, generate
# ---------------------------------------------------------------------------

@pytest.fixture
def routes(monkeypatch):
    """The (expert ids, keep mask) of every ``dispatch_info`` call in each
    package, in call order (the reference's through a debug callback: its
    layers run inside ``lax.scan``)."""
    got = {"jax": [], "port": []}
    real_j, real_t = JR.dispatch_info, R.dispatch_info

    def jax_info(rr, *a, **k):
        info = real_j(rr, *a, **k)
        jax.debug.callback(lambda i, m: got["jax"].append((np.asarray(i), np.asarray(m))),
                           rr.topk_idx, info.keep, ordered=True)
        return info

    def port_info(rr, *a, **k):
        info = real_t(rr, *a, **k)
        got["port"].append((rr.topk_idx.numpy().copy(), info.keep.numpy().copy()))
        return info

    monkeypatch.setattr(JR, "dispatch_info", jax_info)
    monkeypatch.setattr(R, "dispatch_info", port_info)
    return got


BRANCHES = {"routed": ("gate_drop", False), "gate_drop": ("gate_drop", True),
            "gate_expert_drop": ("gate_expert_drop", True)}


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("backend,against", [("oracle", "oracle"), ("cuda", "pallas"),
                                             ("cuda_fused", "pallas_fused")])
def test_model_apply_matches(backend, against, branch, weights, routes):
    """A training forward (capacity 1.25, the MTP head on) of a sigmoid
    top-2 routed step, a Gate-Drop step and a Gate-Expert-Drop step, each
    beside the shared expert, on the port's backends against the
    reference's (Pallas in interpret mode): logits, MTP hidden states and
    the MoE aux; expert ids and keep masks exactly."""
    mode, decision = BRANCHES[branch]
    gd = dataclasses.replace(get_config(ARCH).moe.gating_dropout, mode=mode)
    jc, tc = _cfgs(backend, against)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, gating_dropout=dataclasses.replace(jc.moe.gating_dropout, mode=mode)))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, gating_dropout=gd))
    jp, tp = weights
    jt, tt = _tokens(tc.vocab, 2, 12, seed=2)
    want, jaux = jax_model_apply(jp, {"tokens": jt}, jc, decision=decision, is_training=True)
    got, taux = model_apply(tp, {"tokens": tt}, tc, decision=decision, is_training=True)
    _close(got, want)
    _close(taux["mtp_hidden"], jaux["mtp_hidden"])
    for key in ("balance", "router_z", "load", "dropped_frac"):
        _close(taux[key], jaux[key], atol=1e-4)
    assert len(routes["port"]) == len(routes["jax"]) == (0 if branch == "gate_expert_drop"
                                                        else 1)
    for (ti, tk), (ji, jk) in zip(routes["port"], routes["jax"]):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tk, jk)
        assert ti.shape == (24, 2)
    assert "shared" in tp["decoder"][1]["p0"] and tc.moe.router_type == "sigmoid"


def test_mtp_hidden_only_in_training(weights):
    _, tp = weights
    _, tc = _cfgs()
    _, tt = _tokens(tc.vocab, 2, 7)
    _, aux = model_apply(tp, {"tokens": tt}, tc, is_training=False)
    assert "mtp_hidden" not in aux
    _, aux = model_apply(tp, {"tokens": tt}, tc, is_training=True)
    assert aux["mtp_hidden"].shape == (2, 7, tc.d_model)


P_LEN, N_DECODE = 5, 4


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_and_decode_match(per_row, weights):
    """Prefill 5 tokens, decode 4 teacher-forced on the ``cuda`` backend
    (its plain versions here): each step's logits against the reference's
    oracle decode (scalar or per-row index) and against the port's own
    full-sequence forward at that position; the latents against the
    reference's."""
    jc, tc = _cfgs("cuda")
    jp, tp = weights
    jt, tt = _tokens(tc.vocab, 2, P_LEN + N_DECODE, seed=3)
    max_seq = P_LEN + N_DECODE
    full, _ = model_apply(tp, {"tokens": tt}, tc, is_training=False)
    jl, jcache = jax_prefill(jp, {"tokens": jt[:, :P_LEN]}, jc, max_seq=max_seq)
    tl, tcache = prefill(tp, {"tokens": tt[:, :P_LEN]}, tc, max_seq=max_seq)
    _close(tl, jl)
    _close(tl[:, 0], full[:, P_LEN - 1].detach().numpy())
    assert tcache[0]["p0"]["attn"]["c_kv"].shape == (1, 2, max_seq, 32)
    for i in range(N_DECODE - 1):
        pos = P_LEN + i
        jidx = jnp.full((2,), pos, jnp.int32) if per_row else pos
        tidx = torch.full((2,), pos) if per_row else pos
        jl, jcache = _jax_decode(jp, jcache, jt[:, pos:pos + 1], jidx, jc)
        tl, tcache = decode_step(tp, tcache, tt[:, pos:pos + 1], tidx, tc, flash_decode=True)
        _close(tl, jl)
        _close(tl[:, 0], full[:, pos].detach().numpy())
    for key in ("c_kv", "k_rope"):
        _close(tcache[1]["p0"]["attn"][key], jcache[1]["p0"]["attn"][key], ATT_ATOL, ATT_RTOL)


@pytest.fixture
def b5_calls(monkeypatch):
    """Calls of the flash-decode wrappers (B5, B6) during the test."""
    calls = []
    for name in ("flash_decode", "flash_decode_paged"):
        real = getattr(FD, name)
        monkeypatch.setattr(FD, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    return calls


@pytest.mark.parametrize("kind", ["sampled", "beam"])
def test_generate_matches_reference(kind, weights, b5_calls):
    """Sampled (temperature 0.8, top-8, the reference's Gumbel noise) and
    beam-3 ``generate`` on the ``cuda_fused`` backend: the reference's
    tokens; ``flash_decode`` reaches no flash-decode kernel on MLA
    layers."""
    jc, tc = _cfgs("cuda_fused")
    jp, tp = weights
    jt, tt = _tokens(tc.vocab, 2, 6, seed=5)
    kw = (dict(max_new=6, eos_id=-1, temperature=0.8, top_k=8) if kind == "sampled"
          else dict(max_new=6, eos_id=-1, beam_width=3))
    want = jax_generate(jp, {"tokens": jt}, jc, JaxGen(**kw), rng=jax.random.PRNGKey(4))
    got = generate(tp, {"tokens": tt}, tc, GenerateConfig(**kw, flash_decode=True), seed=4)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert b5_calls == []


# ---------------------------------------------------------------------------
# serving: the schedulers, the CLI
# ---------------------------------------------------------------------------

SCHED = dict(n_slots=2, prefill_buckets=(16,), max_seq=24)
PAGED = dict(page_size=8, n_slots_equiv=3)


def _requests(cls, vocab):
    rng = np.random.default_rng(4)
    head = np.arange(8, dtype=np.int32) + 3            # one full shared page
    out = []
    for i, (n, budget) in enumerate(((5, 4), (9, 6), (3, 5), (12, 3))):
        toks = rng.integers(3, vocab, size=n).astype(np.int32)
        if i % 2:
            toks = np.concatenate([head, toks[:4]]).astype(np.int32)
        out.append(cls(rid=i, tokens=toks, max_new=budget, arrival=0.0))
    return out


def test_schedulers_match_reference(weights):
    """The slot pool and the page arena (shared prefix pages, copy on
    write) on the port's ``cuda`` backend give the reference
    ``PagedScheduler``'s tokens for every request, at non-binding eval
    capacity."""
    jc, tc = _cfgs("cuda", "oracle", eval_capacity_factor=4.0)
    jp, tp = weights
    gen = dict(max_new=6, eos_id=-1)
    jsched = JaxPagedScheduler(jp, jc, JaxGen(**gen), paged=JaxPagedKVConfig(**PAGED), **SCHED)
    want = {r.rid: np.asarray(r.tokens) for r in jsched.run(_requests(JaxRequest, jc.vocab))}
    slot = ContinuousScheduler(tp, tc, GenerateConfig(**gen), **SCHED)
    paged = PagedScheduler(tp, tc, GenerateConfig(**gen, flash_decode=True),
                           paged=PagedKVConfig(**PAGED), **SCHED)
    for sched in (slot, paged):
        got = {r.rid: r.tokens for r in sched.run(_requests(Request, tc.vocab))}
        assert sched.stats["admitted"] == sched.stats["finished"] == 4
        for rid, toks in want.items():
            np.testing.assert_array_equal(got[rid], toks, err_msg=f"{type(sched)} {rid}")
    assert paged.stats["prefix_hits"] == jsched.stats["prefix_hits"] > 0
    assert paged.stats["cow_copies"] == jsched.stats["cow_copies"]
    paged._pages.check()


def test_serve_cli_on_cpu(tmp_path, capsys, b5_calls):
    out = tmp_path / "s.json"
    serve_cli.main(["--arch", ARCH, "--reduced", "--layers", "2", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "5", "--max-new", "3", "--eos", "-1",
                    "--backend", "cuda_fused", "--flash-decode", "--json-out", str(out)])
    rec = json.load(open(out))
    assert rec["arch"] == ARCH and len(rec["tokens"]) == 2 and len(rec["tokens"][0]) == 3
    serve_cli.main(["--arch", ARCH, "--reduced", "--layers", "1", "--device", "cpu",
                    "--trace", "3", "--paged", "--slots", "2", "--buckets", "8",
                    "--max-new", "3", "--eos", "-1", "--backend", "cuda", "--json-out",
                    str(out)])
    rec = json.load(open(out))
    assert rec["scheduler"]["admitted"] == rec["scheduler"]["finished"] == 3
    assert "n_layers=1" in capsys.readouterr().out
    assert b5_calls == []


# ---------------------------------------------------------------------------
# --task lm training with the MTP loss, checkpoints, the CLI
# ---------------------------------------------------------------------------

N_STEPS = 3


def _lm_batches(cfg):
    task = SyntheticLM(LMTaskConfig(vocab=cfg.vocab, seq_len=16))
    return lambda step: task.sample_batch(step, 4)


@pytest.fixture(scope="module")
def jax_lm_steps(weights):
    """The reference's three Gate-Drop steps of reduced deepseek (drop bits
    False, False, True for seed 0) on the LM task with MTP, its oracle
    backend: one ``make_train_step`` executable that draws each step's
    bit in the step (the reference's default ``traced_cond``); its
    metrics, parameters and Adam first moments."""
    jc, tc = _cfgs()
    jp, _ = weights
    jtc = JaxTC(lr=1e-3, warmup_steps=2, seed=0, steps=N_STEPS)
    batches = _lm_batches(tc)
    step = jax_make_step(jc, jtc)
    state = jax_init_state(jax.tree_util.tree_map(jnp.array, jp), jtc)   # the step donates
    metrics = []
    for i in range(N_STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batches(i).items()}, None)
        metrics.append(jax.device_get(m))
    return metrics, jax_flat(state["params"]), jax_flat(state["opt"]["m"])


def _adam_drift_bound(tc, steps: int) -> float:
    """How far two runs' parameters may part in ``steps`` Adam steps
    whatever their gradients (``chip_smoke.py::adam_drift_bound``): each
    step moves a parameter by lr_t * |m_hat / (sqrt(v_hat) + eps)|, at most
    lr_t * R_t with R_t = sqrt(sum_i a_i^2 / b_i) over the moments' weights
    a_i, b_i; two runs part by at most 2 * sum lr_t R_t."""
    from repro_torch.optim.adam import schedule
    total = 0.0
    for t in range(1, steps + 1):
        a = [(1 - tc.b1) * tc.b1 ** (t - i) / (1 - tc.b1 ** t) for i in range(1, t + 1)]
        b = [(1 - tc.b2) * tc.b2 ** (t - i) / (1 - tc.b2 ** t) for i in range(1, t + 1)]
        total += schedule(t, tc) * np.sqrt(sum(x * x / y for x, y in zip(a, b)))
    return 2.0 * total


def _run_port(tc, params, ttc, batches):
    """The port's N_STEPS train steps from ``params``: (metrics, state)."""
    state = init_train_state(params, ttc)
    step = make_train_step(tc, ttc)
    metrics = []
    for i in range(N_STEPS):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batches(i).items()})
        metrics.append(m)
    return metrics, state


@pytest.mark.parametrize("backend", ["cuda", "cuda_fused"])
def test_lm_train_steps_match_reference(backend, jax_lm_steps, weights):
    """Losses (``mtp_xent`` among them), the grad norm and the parameters
    after the steps against the reference's. As
    ``test_torch_decoder_only.py`` notes, Adam divides each gradient entry
    by its own magnitude, so an entry whose gradient is at rounding level
    moves by up to lr per step in a direction that f32 rounding decides.
    On this task one embedding entry is such: the reference's f32 first
    moment there and the port's plain path's in f64 are below 1e-6 of
    their leaf's largest (3.9e-07, 6.4e-07), and the two packages' f32
    steps part there by 3.1e-4. One such entry at most is held to the
    drift that Adam allows between any two runs (``_adam_drift_bound``)
    instead."""
    jms, jparams, jm1 = jax_lm_steps
    _, tc = _cfgs(backend)
    _, tp = weights
    ttc = TrainConfig(lr=1e-3, warmup_steps=2, seed=0, steps=N_STEPS)
    batches = _lm_batches(tc)
    tms, state = _run_port(tc, bridge.to_torch(bridge.to_numpy(tp)[0], "cpu"), ttc, batches)
    for i, (tm, jm) in enumerate(zip(tms, jms)):
        assert float(tm["gate_dropped"]) == float(jm["gate_dropped"]) == float(i == 2)
        for k in ("loss", "xent", "mtp_xent", "balance", "router_z"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=2e-5, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-5)
    # the same steps on the port's plain path in f64: which entries'
    # gradients are at rounding level
    _, tc64 = _cfgs()
    tc64 = dataclasses.replace(tc64, param_dtype="float64", dtype="float64")
    p64 = bridge.to_torch({k: v.astype(np.float64) for k, v in
                           bridge.to_numpy(tp)[0].items()}, "cpu")
    _, state64 = _run_port(tc64, p64, ttc, batches)
    m64 = {k[2:]: v.numpy() for k, v in flatten_with_paths(state64["opt"]).items()
           if k.startswith("m/")}
    tparams = flatten_with_paths(state["params"])
    assert sorted(tparams) == sorted(jparams)
    drift = _adam_drift_bound(ttc, N_STEPS)
    n_apart = 0
    for key, want in jparams.items():
        got = tparams[key].detach().numpy()
        mr, mp = np.abs(jm1[key]), np.abs(m64[key])
        rounding = (mr < 1e-6 * mr.max()) & (mp < 1e-6 * mp.max())
        apart = rounding & (np.abs(got - want) > 2e-4)
        n_apart += int(apart.sum())
        np.testing.assert_allclose(got[~apart], want[~apart], atol=2e-4, err_msg=key)
        np.testing.assert_allclose(got[apart], want[apart], atol=drift, err_msg=key)
    assert n_apart <= 1, n_apart


def test_mtp_loss_masks_the_last_column_and_masked_labels(weights):
    """The MTP term predicts labels rolled by -1 under the mask times its
    roll, the last column masked: a loss mask that drops position 3 drops
    MTP positions 2 and 3, and changing the token two ahead of the last
    column (wrapped to column 0's label) moves nothing there."""
    from repro_torch.training.steps import total_loss
    _, tp = weights
    _, tc = _cfgs()
    batch = {k: torch.from_numpy(v) for k, v in _lm_batches(tc)(0).items()}
    mask = torch.ones(batch["labels"].shape)
    mask[:, 3] = 0.0
    _, m = total_loss(tp, dict(batch, loss_mask=mask), tc, generator=None, decision=False)
    _, aux = model_apply(tp, batch, tc, decision=False, is_training=True, return_hidden=True)
    from repro_torch.models.model import head_matrix
    logits = (aux["mtp_hidden"] @ head_matrix(tp, tc)).float()
    ll = torch.log_softmax(logits, -1).gather(-1, torch.roll(batch["labels"], -1, 1)[..., None])
    m2 = mask * torch.roll(mask, -1, 1)
    m2[:, -1] = 0.0
    assert float(m2[:, 2].sum()) == float(m2[:, 3].sum()) == 0.0
    want = -(ll[..., 0] * m2).sum() / m2.sum()
    np.testing.assert_allclose(float(m["mtp_xent"]), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(m["loss"]), float(m["xent"] + 0.01 * m["balance"]
                                                      + 0.3 * m["mtp_xent"]), rtol=1e-6)


def test_checkpoint_round_trips_mla_and_mtp_leaves(tmp_path, weights):
    """A port train state with MLA and MTP leaves saves and restores
    bitwise, and the reference restores the port's checkpoint."""
    jp, tp = weights
    jc, tc = _cfgs()
    state = init_train_state(bridge.to_torch(bridge.to_numpy(tp)[0], "cpu"), TrainConfig())
    save_checkpoint(str(tmp_path / "t"), 3, state)
    template = init_train_state(init_model(torch.Generator().manual_seed(1), tc), TrainConfig())
    back, meta = restore_checkpoint(str(tmp_path / "t"), template)
    assert meta["step"] == 3
    want = flatten_with_paths(state)
    got = flatten_with_paths(back)
    assert sorted(got) == sorted(want)
    assert {"params/mtp/block/attn/w_dkv", "params/decoder/0/p0/attn/kv_norm",
            "opt/m/mtp/proj"} <= set(got)
    for key, w in want.items():
        if torch.is_tensor(w):
            assert torch.equal(got[key], w), key
    jback, _ = jax_restore(str(tmp_path / "t"), jax_init_state(jp, JaxTC()))
    for key, w in jax_flat(jback["params"]).items():
        np.testing.assert_array_equal(w, want["params/" + key].detach().numpy(), err_msg=key)


def test_train_cli_task_lm_on_cpu(tmp_path):
    out = tmp_path / "h.json"
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--task", "lm",
                    "--steps", "3", "--batch", "2", "--seq", "8", "--gd-mode", "gate_drop",
                    "--gd-rate", "0.3", "--backend", "cuda_fused", "--log-every", "1",
                    "--no-prefetch", "--json-out", str(out)])
    hist = json.load(open(out))["history"]
    assert [r["step"] for r in hist] == [0, 1, 2]
    assert [r["gate_dropped"] for r in hist] == [0.0, 0.0, 1.0]
    assert all(np.isfinite(r["loss"]) and r["mtp_xent"] > 0 for r in hist)
