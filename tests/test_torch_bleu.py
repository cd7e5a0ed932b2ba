"""The port's BLEU evaluation (src/repro_torch/metrics, launch/train.py's
greedy_bleu and --eval-every, the Trainer's eval schedule) against the JAX
package's, on the CPU. Everything here is exact: the same id lists give
the same BLEU float, the same weights the same greedy tokens and BLEU, the
same (steps, chunk, eval_every) the same schedule.
"""
import json
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.data import MTTaskConfig as JaxMTC  # noqa: E402
from repro.data import MultilingualMT as JaxMT  # noqa: E402
from repro.launch.train import greedy_bleu as jax_greedy_bleu  # noqa: E402
from repro.metrics import bleu as JB  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.training.loop import Trainer as JaxTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.data import MTTaskConfig, MultilingualMT  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.launch.train import greedy_bleu  # noqa: E402
from repro_torch.metrics import bleu as B  # noqa: E402
from repro_torch.training import Trainer  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lists(seed, n, lo, hi, vocab=12):
    rs = np.random.RandomState(seed)
    return [rs.randint(3, vocab, size=rs.randint(lo, hi + 1)).tolist() for _ in range(n)]


def _mutate(refs, seed, p):
    rs = np.random.RandomState(seed)
    return [[t if rs.rand() > p else int(rs.randint(3, 12)) for t in r] for r in refs]


REFS = _lists(0, 16, 3, 12)
CASES = {
    "overlap": (_mutate(REFS, 1, 0.3), REFS, 4),
    "identical": (REFS, REFS, 4),
    "brevity_penalty": ([r[: max(1, len(r) // 2)] for r in REFS], REFS, 4),
    "longer_hyps": ([r + r[:3] for r in _mutate(REFS, 2, 0.5)], REFS, 4),
    "empty_hyps": ([[] for _ in REFS], REFS, 4),
    "too_short_for_4grams": ([r[:2] for r in REFS], REFS, 4),
    "bigrams": (_mutate(REFS, 3, 0.6), REFS, 2),
    "disjoint": ([[t + 20 for t in r] for r in REFS], REFS, 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_corpus_bleu_matches_reference(name):
    hyps, refs, max_n = CASES[name]
    got = B.corpus_bleu(hyps, refs, max_n=max_n)
    assert got == JB.corpus_bleu(hyps, refs, max_n=max_n)
    if name == "identical":
        assert got == pytest.approx(100.0)
    if name in ("empty_hyps", "too_short_for_4grams"):
        assert got == 0.0
    with pytest.raises(ValueError):
        B.corpus_bleu(hyps, refs[:-1])


def test_strip_special_and_token_accuracy_match_reference():
    rs = np.random.RandomState(4)
    for _ in range(50):
        seq = rs.randint(0, 6, size=rs.randint(0, 12))
        for kw in ({}, {"eos": 5, "pad": 3}):
            got = B.strip_special(seq, **kw)
            assert got == JB.strip_special(seq, **kw)
            assert all(type(t) is int for t in got)
    pred, labels = rs.randint(0, 4, (3, 7)), rs.randint(0, 4, (3, 7))
    for mask in (rs.rand(3, 7) < 0.6, np.zeros((3, 7))):
        assert B.token_accuracy(pred, labels, mask) == JB.token_accuracy(pred, labels, mask)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kw", [{}, {"n": 6, "max_new": 9, "lang": 2, "seed": 3}],
                         ids=["defaults", "one_language"])
def test_greedy_bleu_matches_reference(kw):
    """Reduced zcode-m3-base, the reference's seeded weights scaled x3 (as
    tests/test_torch_serve.py scales them, so that greedy decoding does not
    collapse onto one token) carried by bridge.to_torch."""
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    jp = jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a,
                      jax_init_model(jax.random.PRNGKey(7), jcfg))
    cfg = reduced(get_config("zcode-m3-base"))
    task = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=4, max_len=16))
    jtask = JaxMT(JaxMTC(vocab=jcfg.vocab, n_langs=4, max_len=16))
    got = greedy_bleu(bridge.to_torch(_flat(jp), "cpu"), cfg, task, device="cpu", **kw)
    assert got == jax_greedy_bleu(jp, jcfg, jtask, **kw)


# ---------------------------------------------------------------------------
# the Trainer's eval schedule and records
# ---------------------------------------------------------------------------

SCHEDULES = [(10, 4, 3, 20), (10, 4, 0, 1), (7, 8, 2, 0), (9, 2, 4, 5), (5, 3, 1, 2)]


@pytest.mark.parametrize("steps,chunk,eval_every,log_every", SCHEDULES)
def test_eval_schedule_matches_reference(steps, chunk, eval_every, log_every):
    """Chunk spans cut at eval steps, eval steps and record steps, as the
    reference's Trainer computes them (its methods run on a plain
    namespace: nothing of its model is built)."""
    cfg = reduced(get_config("zcode-m3-base"))
    port = Trainer(cfg, TrainConfig(steps=steps), lambda s: {}, device="cpu",
                   chunk=chunk, eval_every=eval_every, eval_fn=lambda st, i: {},
                   log_every=log_every, log=None)
    ref = types.SimpleNamespace(tc=types.SimpleNamespace(steps=steps), chunk=chunk,
                                start_step=0, eval_every=eval_every,
                                eval_fn=lambda st, i: {}, log_every=log_every)
    ref._eval_steps = lambda: JaxTrainer._eval_steps(ref)
    assert port._eval_steps() == JaxTrainer._eval_steps(ref)
    assert port._record_steps() == JaxTrainer._record_steps(ref)
    assert port.schedule() == JaxTrainer.schedule(ref)


@pytest.mark.parametrize("prefetch", [True, False])
def test_eval_records_and_clock(prefetch):
    """The eval runs on the params after its step, merges into that
    step's record, and its time lands in later records' clocks only."""
    cfg = reduced(get_config("zcode-m3-base"))
    batches = MultilingualMT(MTTaskConfig(vocab=cfg.vocab, n_langs=4,
                                          max_len=16)).train_batches(4)
    seen = []

    def eval_fn(state, step):
        seen.append((step, state["step"]))
        time.sleep(0.3)
        return {"bleu": float(step)}

    trainer = Trainer(cfg, TrainConfig(lr=1e-3, warmup_steps=2, steps=5), batches,
                      device="cpu", chunk=2, eval_every=2, eval_fn=eval_fn,
                      log_every=0, log=None, prefetch=prefetch)
    _, hist = trainer.run()
    assert seen == [(0, 1), (2, 3), (4, 5)]
    assert [r["step"] for r in hist] == [0, 2, 4]
    assert [r["bleu"] for r in hist] == [0.0, 2.0, 4.0]
    assert all(set(r) >= {"comm_wire_bytes", "comm_a2a_calls", "comm_exposed_bytes",
                          "comm_hidden_bytes"} for r in hist)
    # each record's clock was read before its eval ran
    assert hist[1]["time_s"] - hist[0]["time_s"] >= 0.3
    assert hist[2]["time_s"] - hist[1]["time_s"] >= 0.3


def test_train_cli_eval_every(tmp_path, capsys):
    out = tmp_path / "h.json"
    cli.main(["--device", "cpu", "--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
              "--langs", "4", "--gd-mode", "gate_drop", "--gd-rate", "0.3",
              "--eval-every", "2", "--log-every", "1", "--no-prefetch",
              "--json-out", str(out)])
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [("bleu" in r) for r in recs] == [True, False, True]
    assert all(r["comm_a2a_calls"] == 0 for r in recs)     # one device: no wire
    hist = json.load(open(out))
    assert hist["ep"] == 1 and [r["step"] for r in hist["history"]] == [0, 1, 2]
