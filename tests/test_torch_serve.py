"""Port decoding engine and serving CLI against the JAX package: greedy
tokens from ``generate`` on bridged weights, reduced zcode-m3-base in f32,
through the kernel pipeline with flash decode (the JAX package's
``pallas`` backend with ``flash_decode=True``, Pallas in interpret mode),
with and without EOS and with local routing; and through the fused kernel
(the port's ``cuda_fused`` against the JAX package's ``pallas_fused``).
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
from repro_torch.models import decode_step, prefill  # noqa: E402
from repro_torch.serve import GenerateConfig, generate  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


PIPELINE = ("cuda", "pallas")         # (port backend, JAX package backend)
FUSED = ("cuda_fused", "pallas_fused")


@pytest.fixture(scope="module")
def setup(request):
    backend, jax_backend = getattr(request, "param", PIPELINE)
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    tcfg = reduced(get_config("zcode-m3-base"))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, backend=jax_backend))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, backend=backend))
    # a scaled-up init keeps greedy decoding from collapsing onto one token
    jp = jax.tree.map(lambda a: a * 3.0 if a.ndim >= 2 else a,
                      jax_init_model(jax.random.PRNGKey(7), jcfg))
    tp = bridge.to_torch(_flat(jp), "cpu")
    rs = np.random.RandomState(11)
    toks = rs.randint(3, tcfg.vocab, (3, 5))
    src = rs.randint(3, tcfg.vocab, (3, 32))
    jb = {"tokens": jnp.asarray(toks), "enc_tokens": jnp.asarray(src)}
    tb = {"tokens": torch.from_numpy(toks), "enc_tokens": torch.from_numpy(src)}
    return jcfg, tcfg, jp, tp, jb, tb


def _both(setup, **gen):
    jcfg, tcfg, jp, tp, jb, tb = setup
    want = jax_generate(jp, jb, jcfg, JaxGenerateConfig(flash_decode=True, **gen))
    got = generate(tp, tb, tcfg, GenerateConfig(flash_decode=True, **gen))
    return got, want


@pytest.mark.parametrize("setup,local_routing", [
    pytest.param(PIPELINE, False, id="False"),
    pytest.param(PIPELINE, True, id="True"),
    pytest.param(FUSED, False, id="cuda_fused-False"),
    pytest.param(FUSED, True, id="cuda_fused-True"),
], indirect=["setup"])
def test_greedy_tokens_match_jax(setup, local_routing):
    got, want = _both(setup, max_new=8, eos_id=-1, local_routing=local_routing)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-3)
    assert got.steps == int(want.steps) == 7
    assert len(set(got.tokens.flatten().tolist())) > 3   # not a collapsed run


def test_greedy_tokens_match_jax_with_eos(setup):
    free, _ = _both(setup, max_new=8, eos_id=-1)
    eos = int(free.tokens[0, 2])     # make row 0's third token the EOS
    got, want = _both(setup, max_new=8, eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.steps == int(want.steps)
    assert int(got.lengths[0]) <= 3 and (got.tokens[0, 3:] == 0).all()


def test_engine_equals_reference_loop(setup):
    """``generate`` == a hand-rolled loop over prefill/decode_step."""
    _, tcfg, _, tp, _, tb = setup
    P, N = tb["tokens"].shape[1], 6
    lg, caches = prefill(tp, tb, tcfg, max_seq=P + N)
    cur = lg.argmax(-1)
    ref = [cur[:, 0]]
    for i in range(N - 1):
        lg, caches = decode_step(tp, caches, cur, P + i, tcfg)
        cur = lg.argmax(-1)
        ref.append(cur[:, 0])
    res = generate(tp, tb, tcfg, GenerateConfig(max_new=N, eos_id=-1))
    assert torch.equal(res.tokens, torch.stack(ref, 1))
    assert res.lengths.tolist() == [N] * 3


def test_sampling_seeded_and_topk1_is_greedy(setup):
    _, tcfg, _, tp, _, tb = setup
    greedy = generate(tp, tb, tcfg, GenerateConfig(max_new=5, eos_id=-1))
    top1 = generate(tp, tb, tcfg, GenerateConfig(max_new=5, eos_id=-1,
                                                 temperature=1.0, top_k=1), seed=3)
    assert torch.equal(greedy.tokens, top1.tokens)
    gen = GenerateConfig(max_new=5, eos_id=-1, temperature=1.5)
    a = generate(tp, tb, tcfg, gen, seed=4)
    b = generate(tp, tb, tcfg, gen, seed=4)
    assert torch.equal(a.tokens, b.tokens)
    assert ((a.tokens >= 0) & (a.tokens < tcfg.vocab)).all()


def test_generate_rejects_small_cache(setup):
    _, tcfg, _, tp, _, tb = setup
    with pytest.raises(ValueError):
        generate(tp, tb, tcfg, GenerateConfig(max_new=4, max_seq=6))


def test_cli_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "serve.json"
    cli.main(["--arch", "zcode-m3-base", "--reduced", "--device", "cpu",
              "--batch", "2", "--prompt-len", "4", "--max-new", "3", "--eos", "-1",
              "--backend", "cuda", "--flash-decode", "--json-out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and rec["n_tokens"] == 6 and rec["steps"] == 2
    assert all(len(v) == cli.TIMED_ROUNDS for v in rec["rounds"].values())
    assert "sample:" in capsys.readouterr().out


def test_cli_serves_with_the_fused_kernel_on_cpu(tmp_path):
    """``--backend cuda_fused`` (and ``auto``, the oracle) give the
    pipeline's greedy tokens on the CPU, where every kernel wrapper takes
    its plain version."""
    tokens = {}
    for backend in ("cuda", "cuda_fused", "auto"):
        out = tmp_path / f"{backend}.json"
        cli.main(["--arch", "zcode-m3-base", "--reduced", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "4", "--max-new", "3", "--eos", "-1",
                  "--backend", backend, "--flash-decode", "--json-out", str(out)])
        tokens[backend] = json.loads(out.read_text())["tokens"]
    assert tokens["cuda_fused"] == tokens["cuda"] == tokens["auto"]
    with pytest.raises(SystemExit):
        cli.main(["--backend", "pallas_fused"])


def test_cli_needs_a_card_unless_asked_for_cpu():
    assert cli.resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert cli.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.resolve_device("cuda")
