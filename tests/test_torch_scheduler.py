"""The port's serving schedulers (``serve/scheduler.py``) against the JAX
package's, on bridged weights of reduced zcode-m3-base (d 64, 2 layers,
d_ff 128, vocab 97, non-binding eval capacity = n_experts, f32).

Greedy per-request tokens of the port's ``ContinuousScheduler``,
``PagedScheduler`` and ``PagedScheduler`` with B6 (its plain version on
the CPU) equal the reference ``PagedScheduler``'s, and the paged
scheduler's counters and its tracer's sequence of spans and instants
(names and arguments) equal the reference's, on four traces: EOS off, EOS
on, a shared-prefix trace (prefix hits) and an exhausted arena
(preemption and swap-in); with the ``oracle`` and ``cuda`` MoE backends.
The static-batching baseline gives the reference's tokens.
The reference's runs (Pallas-free, oracle backend) are shared through a
module fixture. Sampling: a request's samples do not depend on its row or
batch, and equal the reference's (JAX's threefry keys and Gumbel noise).
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
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.obs import Tracer as JaxTracer  # noqa: E402
from repro.serve import ContinuousScheduler as JaxContinuousScheduler  # noqa: E402
from repro.serve import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.serve import PagedScheduler as JaxPagedScheduler  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro.serve.scheduler import static_batch_serve as jax_static_batch_serve  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import PagedKVConfig, get_config, reduced  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, GenerateConfig,  # noqa: E402
                               PagedScheduler, Request, generate,
                               static_batch_serve)
from repro_torch.serve.engine import _select_rows  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REDUCED = dict(d_model=64, n_layers=2, d_ff=128, vocab=97)
SCHED = dict(n_slots=3, prefill_buckets=(8, 16), max_seq=40)
# case: (gen kwargs, paged kwargs, request builder kwargs)
CASES = {
    "base": (dict(max_new=10, eos_id=-1), dict(page_size=8, n_slots_equiv=4),
             dict(n=6)),
    "prefix": (dict(max_new=8, eos_id=-1), dict(page_size=8, n_slots_equiv=4),
               dict(n=8, lens=(4, 7, 8, 5), budgets=(3, 6, 8), prefix=True)),
    "exhausted": (dict(max_new=20, eos_id=-1), dict(page_size=4, n_pages=13),
                  dict(n=6, lens=(4, 9, 13), budgets=(20,))),
}


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tcfg(backend):
    cfg = reduced(get_config("zcode-m3-base"), **REDUCED)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, eval_capacity_factor=float(cfg.moe.n_experts), backend=backend))


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"), **REDUCED)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, eval_capacity_factor=float(jcfg.moe.n_experts), backend="oracle"))
    # a scaled-up init keeps greedy decoding from collapsing onto one token
    jp = jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a,
                      jax_init_model(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, bridge.to_torch(_flat(jp), "cpu")


def _requests(n, *, lens=(4, 7, 11, 14), budgets=(3, 6, 9), prefix=False,
              seed=1):
    """(rid, tokens, source, budget) tuples; with ``prefix`` the even
    requests share one 8-token prompt prefix (a full page at page size 8)
    AND one source sentence, so their pages are equal."""
    rng = np.random.default_rng(seed)
    shared_src = rng.integers(3, 96, size=32).astype(np.int32)
    head = np.arange(8, dtype=np.int32) + 3
    out = []
    for i in range(n):
        toks = rng.integers(3, 96, size=lens[i % len(lens)]).astype(np.int32)
        src = rng.integers(3, 96, size=32).astype(np.int32)
        if prefix and i % 2 == 0:
            toks, src = np.concatenate([head, toks]).astype(np.int32), shared_src
        out.append((i, toks, src, budgets[i % len(budgets)]))
    return out


def _reqs(cls, spec, **kw):
    return [cls(rid=i, tokens=t, extras={"enc_tokens": s}, max_new=m, arrival=0.0, **kw)
            for i, t, s, m in spec]


def _events(tracer):
    """A tracer's (phase, name, arguments) sequence, clock readings left
    out."""
    return [(ph, name, args) for ph, name, _, _, _, args in tracer.events]


@pytest.fixture(scope="module")
def refs(model):
    """The reference PagedScheduler's tokens, counters and tracer events
    per case, and the EOS case built from the base case's output."""
    jcfg, jp, _ = model
    out = {}

    def run(gen_kw, paged_kw, spec):
        tracer = JaxTracer()
        sched = JaxPagedScheduler(jp, jcfg, JaxGenerateConfig(**gen_kw),
                                  paged=JaxPagedKVConfig(**paged_kw), tracer=tracer,
                                  **SCHED)
        res = sched.run(_reqs(JaxRequest, spec))
        return ({r.rid: np.asarray(r.tokens) for r in res}, dict(sched.stats),
                _events(tracer))

    for name, (gen_kw, paged_kw, req_kw) in CASES.items():
        out[name] = run(gen_kw, paged_kw, _requests(**req_kw))
    base_gen, base_paged, base_req = CASES["base"]
    eos = int(out["base"][0][2][3])            # request 2's 4th token
    eos_gen = dict(base_gen, eos_id=eos)
    out["eos"] = run(eos_gen, base_paged, _requests(**base_req))
    return out, dict(CASES, eos=(eos_gen, base_paged, base_req))


def _port(cls, model, backend, gen_kw, paged_kw, spec, **extra):
    _, _, tp = model
    kw = dict(SCHED, **extra)
    if cls is PagedScheduler:
        kw["paged"] = PagedKVConfig(**paged_kw)
    sched = cls(tp, _tcfg(backend), GenerateConfig(**gen_kw), **kw)
    res = sched.run(_reqs(Request, spec))
    return {r.rid: r.tokens for r in res}, sched


@pytest.mark.parametrize("backend", ["oracle", "cuda"])
@pytest.mark.parametrize("case", ["base", "eos", "prefix", "exhausted"])
def test_schedulers_match_reference_paged_scheduler(refs, model, case, backend):
    ref_out, cases = refs
    want, want_stats, want_events = ref_out[case]
    gen_kw, paged_kw, req_kw = cases[case]
    spec = _requests(**req_kw)
    slot, ss = _port(ContinuousScheduler, model, backend, gen_kw, paged_kw, spec)
    for flash in (False, True):
        g = dict(gen_kw, flash_decode=flash)
        paged, ps = _port(PagedScheduler, model, backend, g, paged_kw, spec,
                          tracer=Tracer())
        assert ps.stats == want_stats, (flash, ps.stats, want_stats)
        assert _events(ps.tracer) == want_events, flash
    names = {name for _, name, _ in want_events}
    assert {"sched.admit", "sched.decode", "prefix_cache.miss", "sched.cow_flush"} <= names
    if case == "exhausted":
        assert {"sched.preempt.swap_out", "sched.swap_in"} <= names
    if case == "prefix":
        assert "prefix_cache.hit" in names
        for rid, toks in want.items():
            np.testing.assert_array_equal(paged[rid], toks, err_msg=f"{flash} {rid}")
        ps._pages.check()
        while ps._prefix.evict_one():
            pass
        assert ps._pages.n_free == ps.layout.n_pages, "page leak"
    for rid, toks in want.items():
        np.testing.assert_array_equal(slot[rid], toks, err_msg=f"slot {rid}")
    assert ss.stats["admitted"] == ss.stats["finished"] == len(spec)
    if case == "exhausted":
        assert want_stats["preemptions"] > 0
        assert want_stats["swap_ins"] == want_stats["preemptions"]
    if case == "prefix":
        assert want_stats["prefix_hits"] > 0
    if case == "eos":                  # a request stopped at its EOS
        assert any(len(want[rid]) < budget for rid, _, _, budget in spec)
    if case != "exhausted":            # same schedule: same counters
        assert {k: ss.stats[k] for k in ss.stats} == {k: want_stats[k] for k in ss.stats}


def test_scheduler_tokens_equal_oneshot_generate(refs, model):
    """Every request's scheduled tokens equal a one-shot B=1 ``generate``
    at the pool's cache length (bridged weights, kernel backend)."""
    ref_out, cases = refs
    want = ref_out["base"][0]
    gen_kw, _, req_kw = cases["base"]
    _, _, tp = model
    for rid, toks, src, budget in _requests(**req_kw):
        g = GenerateConfig(**dict(gen_kw, max_new=budget, max_seq=SCHED["max_seq"],
                                  flash_decode=True))
        res = generate(tp, {"tokens": torch.from_numpy(toks[None]).long(),
                            "enc_tokens": torch.from_numpy(src[None]).long()},
                       _tcfg("cuda"), g)
        np.testing.assert_array_equal(res.tokens[0].numpy(), want[rid])


def test_static_batch_serve_matches_reference(model):
    """The static-batching baseline: FIFO same-length batches of at most
    2 (lengths 6, 6, 9, 9, 6: batches {0, 1}, {2, 3}, {4}) through the
    one-shot engine, each output cut to its budget, equal the reference's
    on the same requests and weights."""
    jcfg, jp, tp = model
    spec = _requests(5, lens=(6, 6, 9, 9, 6), budgets=(4, 7, 5))
    kw = dict(max_new=7, eos_id=-1)
    want, _ = jax_static_batch_serve(jp, jcfg, JaxGenerateConfig(**kw),
                                     _reqs(JaxRequest, spec), batch_size=2)
    got, wall = static_batch_serve(tp, _tcfg("oracle"), GenerateConfig(**kw),
                                   _reqs(Request, spec), batch_size=2)
    assert sorted(got) == sorted(want) == list(range(5)) and wall > 0
    for rid, _, _, budget in spec:
        assert len(got[rid]) == budget
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))


def _same_prompt_spec():
    """One target prompt under source A, source B, then source A again."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(3, 96, size=12).astype(np.int32)
    srcs = [rng.integers(3, 96, size=32).astype(np.int32) for _ in range(2)]
    return [(0, prompt, srcs[0], 6), (1, prompt, srcs[1], 6), (2, prompt, srcs[0], 6)]


def test_prefix_cache_keys_on_the_source(model):
    """Requests with one target prompt but different sources must not
    share pages (their decoder K/V differ past the first layer); the same
    prompt under the same source does. Paged tokens equal the slot
    pool's either way. (The reference keys on the prompt alone.)"""
    spec = _same_prompt_spec()
    gen_kw, paged_kw = dict(max_new=6, eos_id=-1), dict(page_size=8)
    slot, _ = _port(ContinuousScheduler, model, "cuda", gen_kw, paged_kw, spec,
                    n_slots=1)
    paged, ps = _port(PagedScheduler, model, "cuda", gen_kw, paged_kw, spec, n_slots=1)
    assert ps.stats["prefix_hits"] == 1                  # request 2 only
    assert not np.array_equal(slot[0], slot[1])
    for rid in slot:
        np.testing.assert_array_equal(paged[rid], slot[rid])


def test_reference_prefix_cache_ignores_the_source(model):
    """The fault the source-keyed prefix cache repairs: the reference's
    paged scheduler keys prefix pages on the target prompt alone, so
    request 1 (same prompt, other source) decodes against request 0's
    cached K/V. Its tokens then differ from the reference slot pool's from
    the second token on, while the port's paged scheduler gives the slot
    pool's tokens to every request."""
    jcfg, jp, _ = model
    spec = _same_prompt_spec()
    g = JaxGenerateConfig(max_new=6, eos_id=-1)
    kw = dict(SCHED, n_slots=1)
    slot = {r.rid: np.asarray(r.tokens) for r in
            JaxContinuousScheduler(jp, jcfg, g, **kw).run(_reqs(JaxRequest, spec))}
    ref = JaxPagedScheduler(jp, jcfg, g, paged=JaxPagedKVConfig(page_size=8), **kw)
    paged = {r.rid: np.asarray(r.tokens) for r in ref.run(_reqs(JaxRequest, spec))}
    assert ref.stats["prefix_hits"] == 2                 # requests 1 and 2
    for rid in (0, 2):
        np.testing.assert_array_equal(paged[rid], slot[rid])
    assert paged[1][0] == slot[1][0]                     # prefill: own source
    assert not np.array_equal(paged[1][1:], slot[1][1:])
    port, _ = _port(PagedScheduler, model, "cuda", dict(max_new=6, eos_id=-1),
                    dict(page_size=8), spec, n_slots=1)
    for rid in slot:
        np.testing.assert_array_equal(port[rid], slot[rid])


def test_paged_scheduler_rejects_undersized_arena_and_overflow(model):
    _, _, tp = model
    gen = GenerateConfig(max_new=8, eos_id=-1)
    with pytest.raises(ValueError, match="deadlock"):
        PagedScheduler(tp, _tcfg("cuda"), gen, max_seq=40,
                       paged=PagedKVConfig(page_size=8, n_pages=4))
    sched = PagedScheduler(tp, _tcfg("cuda"), GenerateConfig(max_new=32, eos_id=-1),
                           max_seq=40, paged=PagedKVConfig(page_size=8))
    with pytest.raises(ValueError, match="pinned pool cache length"):
        sched.submit(Request(rid=0, tokens=np.arange(16, dtype=np.int32) + 3))
    with pytest.raises(ValueError, match="beam search"):
        ContinuousScheduler(tp, _tcfg("cuda"), GenerateConfig(beam_width=2))


# ---------------------------------------------------------------------------
# sampling: per-row streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.8, 8), (1.5, 3)])
def test_select_rows_draws_each_row_from_its_own_stream(temperature, top_k):
    """A request sampled alone (B=1) and the same request in row 2 of a
    B=3 batch, with the same seeds, draw the same tokens."""
    gen = GenerateConfig(temperature=temperature, top_k=top_k)
    rng = np.random.default_rng(0)
    for trial in range(20):
        lg = torch.from_numpy(rng.standard_normal((3, 97)).astype(np.float32))
        row_seeds, steps = rng.integers(0, 50, 3), rng.integers(0, 30, 3)
        batched, _ = _select_rows(gen, lg, 7, row_seeds, steps)
        alone, _ = _select_rows(gen, lg[2:], 7, row_seeds[2:], steps[2:])
        assert int(batched[2]) == int(alone[0]), trial


def test_sampled_generate_row_independent_of_batch(model):
    """One-shot ``generate`` keys row b by (seed, b): a prompt sampled alone
    equals the same prompt in row 0 of a batch of three."""
    _, _, tp = model
    rng = np.random.default_rng(8)
    toks, src = rng.integers(3, 96, (3, 6)), rng.integers(3, 96, (3, 32))
    gen = GenerateConfig(max_new=6, eos_id=-1, temperature=1.0)
    three = generate(tp, {"tokens": torch.from_numpy(toks),
                          "enc_tokens": torch.from_numpy(src)}, _tcfg("cuda"), gen, seed=2)
    one = generate(tp, {"tokens": torch.from_numpy(toks[:1]),
                        "enc_tokens": torch.from_numpy(src[:1])}, _tcfg("cuda"), gen, seed=2)
    assert torch.equal(three.tokens[:1], one.tokens)


def test_sampled_generate_matches_reference(model):
    """The port's sampling draws JAX's Gumbel noise from JAX's keys: the
    same sampled tokens as the reference's ``generate``."""
    jcfg, jp, tp = model
    rng = np.random.default_rng(9)
    toks, src = rng.integers(3, 96, (3, 6)), rng.integers(3, 96, (3, 32))
    kw = dict(max_new=8, eos_id=-1, temperature=0.8, top_k=8)
    want = jax_generate(jp, {"tokens": jnp.asarray(toks), "enc_tokens": jnp.asarray(src)},
                        jcfg, JaxGenerateConfig(**kw), rng=jax.random.PRNGKey(4))
    got = generate(tp, {"tokens": torch.from_numpy(toks), "enc_tokens": torch.from_numpy(src)},
                   _tcfg("cuda"), GenerateConfig(**kw), seed=4)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    # sums of 8 f32 log-probs of logits |x| ~ 30 (the x3 init), taken in
    # another order: relative 5e-4
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=5e-4)


def test_continuous_sampling_placement_invariant(model):
    """Requests submitted with one seed draw the same samples in a slot of
    the pool as one-shot B=1 ``generate`` with that seed."""
    _, _, tp = model
    gen = GenerateConfig(max_new=6, eos_id=-1, temperature=0.8, top_k=8)
    spec = _requests(4, lens=(5, 8), budgets=(6,))
    sched = ContinuousScheduler(tp, _tcfg("cuda"), gen, n_slots=2,
                                prefill_buckets=(8,), admit_width=2, seed=3)
    results = sched.run(_reqs(Request, spec, seed=0))
    assert sched.stats["slot_reuse"] > 0
    for res, (_, toks, src, _) in zip(results, spec):
        one = generate(tp, {"tokens": torch.from_numpy(toks[None]).long(),
                            "enc_tokens": torch.from_numpy(src[None]).long()},
                       _tcfg("cuda"), dataclasses.replace(gen, max_seq=sched.max_seq),
                       seed=3)
        np.testing.assert_array_equal(res.tokens, one.tokens[0].numpy())


def test_cli_trace_paged_on_cpu(tmp_path, capsys):
    out = tmp_path / "trace.json"
    cli.main(["--arch", "zcode-m3-base", "--reduced", "--device", "cpu",
              "--trace", "6", "--paged", "--eos", "-1", "--max-new", "6",
              "--backend", "cuda", "--flash-decode", "--json-out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["mode"] == "paged" and rec["device"] == "cpu"
    assert rec["n_requests"] == rec["scheduler"]["finished"] == 6
    assert rec["n_tokens"] == sum(len(t) for t in rec["tokens"].values())
    assert rec["cache"]["peak_pages_in_use"] > 0
    assert set(rec["ttft_s"]) == {"50", "90", "99"}
    assert "cache[paged 16tok]" in capsys.readouterr().out
