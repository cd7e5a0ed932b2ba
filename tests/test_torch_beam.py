"""Beam search of the port's engine (``serve/engine.py::_generate_beam``)
against the JAX package's, on bridged weights of reduced zcode-m3-base
(d 64, 2 layers, d_ff 128, vocab 97, f32): beam-4 tokens and lengths
equal the reference's, best-hypothesis scores within 1e-4 (f32 sums of
log-probs taken in another order), with length penalty 1.0 (EOS on, so
finished beams freeze) and 0.0 (EOS off); beam width 1 is greedy; the
serving CLI's ``--beam``.
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
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.serve import GenerateConfig as JaxGenerateConfig  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.serve import GenerateConfig, generate  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REDUCED = dict(d_model=64, n_layers=2, d_ff=128, vocab=97)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"), **REDUCED)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, backend="oracle"))
    tcfg = reduced(get_config("zcode-m3-base"), **REDUCED)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, backend="cuda"))
    jp = jax_init_model(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(4)
    toks, src = rng.integers(3, 96, (3, 6)), rng.integers(3, 96, (3, 32))
    jb = {"tokens": jnp.asarray(toks), "enc_tokens": jnp.asarray(src)}
    tb = {"tokens": torch.from_numpy(toks), "enc_tokens": torch.from_numpy(src)}
    return jcfg, tcfg, jp, bridge.to_torch(_flat(jp), "cpu"), jb, tb


def _both(setup, **gen):
    jcfg, tcfg, jp, tp, jb, tb = setup
    want = jax_generate(jp, jb, jcfg, JaxGenerateConfig(**gen))
    got = generate(tp, tb, tcfg, GenerateConfig(flash_decode=True, **gen))
    return got, want


@pytest.mark.parametrize("length_penalty,eos", [(1.0, True), (0.0, False)])
def test_beam4_matches_reference(setup, length_penalty, eos):
    kw = dict(max_new=8, beam_width=4, length_penalty=length_penalty, eos_id=-1)
    if eos:
        free, _ = _both(setup, **kw)
        kw["eos_id"] = int(free.tokens[1, 2])      # row 1's third token
    got, want = _both(setup, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-4)
    assert got.steps == int(want.steps)
    if eos:
        assert int(got.lengths.min()) < 8


def test_beam_width_1_is_greedy(setup):
    _, tcfg, _, tp, _, tb = setup
    greedy = generate(tp, tb, tcfg, GenerateConfig(max_new=6, eos_id=-1))
    beam1 = generate(tp, tb, tcfg, GenerateConfig(max_new=6, eos_id=-1, beam_width=1))
    assert torch.equal(greedy.tokens, beam1.tokens)
    np.testing.assert_allclose(greedy.scores.numpy(), beam1.scores.numpy())


def test_cli_beam_on_cpu(tmp_path, capsys):
    out = tmp_path / "beam.json"
    cli.main(["--arch", "zcode-m3-base", "--reduced", "--device", "cpu",
              "--batch", "2", "--prompt-len", "4", "--max-new", "4", "--eos", "-1",
              "--beam", "2", "--backend", "cuda", "--flash-decode",
              "--json-out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["beam"] == 2 and rec["n_tokens"] == 8 and len(rec["scores"]) == 2
    assert "beam=2" in capsys.readouterr().out
