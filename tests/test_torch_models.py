"""Port model (layers, attention, encoder-decoder stack, prefill/decode)
against the JAX package on bridged weights: reduced zcode-m3-base in f32
(2 encoder + 2 decoder layers, d=256, 4 experts), logits within 2e-4. Also
the parameter bridge (bitwise round trip) and the import isolation of the
port from JAX.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import save_checkpoint  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_model as jax_init_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model_apply as jax_model_apply  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import (decode_step, init_model, model_apply,  # noqa: E402
                                prefill)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on few
    cores, and torch's thread pool would contend with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-4


def jax_flat(tree):
    """The reference's checkpoint keys: '/'-joined tree paths."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _setup(backend="oracle", ample_capacity=False, B=2, L_=7, seed=0):
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    tcfg = reduced(get_config("zcode-m3-base"))
    moe_kw = {}
    if ample_capacity:
        # capacity >= T in the full forward and in a decode step, so the
        # forward and prefill+decode route the same tokens
        moe_kw["eval_capacity_factor"] = float(jcfg.moe.n_experts)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, backend="pallas" if backend == "cuda" else "oracle", **moe_kw))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, backend=backend, **moe_kw))
    jp = jax_init_model(jax.random.PRNGKey(seed), jcfg)
    tp = bridge.to_torch(jax_flat(jp), "cpu")
    rs = np.random.RandomState(seed + 1)
    toks = rs.randint(3, tcfg.vocab, (B, L_))
    src = rs.randint(3, tcfg.vocab, (B, 32))
    jb = {"tokens": jnp.asarray(toks), "enc_tokens": jnp.asarray(src)}
    tb = {"tokens": torch.from_numpy(toks), "enc_tokens": torch.from_numpy(src)}
    return jcfg, tcfg, jp, tp, jb, tb


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layers_match():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 16).astype(np.float32) * 3 + 1
    p = {"scale": rs.rand(16).astype(np.float32), "bias": rs.randn(16).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for norm in ("layernorm", "rmsnorm"):
        jc = dataclasses.replace(jax_reduced(jax_get_config("zcode-m3-base")), norm=norm)
        tc = dataclasses.replace(reduced(get_config("zcode-m3-base")), norm=norm)
        _close(L.norm_apply(tp, torch.from_numpy(x), tc),
               JL.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jc), atol=1e-5)
    _close(L.sinusoidal_pos(40, 64), JL.sinusoidal_pos(40, 64), atol=1e-5)
    pos = np.array([0, 3, 17, 200])
    _close(L.apply_rope(torch.from_numpy(x[:, :4, None, :]), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x[:, :4, None, :]), jnp.asarray(pos), 1e4),
           atol=1e-4)
    with pytest.raises(RuntimeError):      # odd d: the cosine half does not fit
        L.sinusoidal_pos(4, 5)


def test_layer_plan_matches():
    """Same segments as the reference: the full model's period-2 pattern
    (MoE, dense) x 6 / x 3, the reduced model's two single-layer runs."""
    from repro.models import transformer as JT
    for arch in ("zcode-m3-base", "zcode-m3-big"):
        for red in (False, True):
            jc, tc = jax_get_config(arch), get_config(arch)
            if red:
                jc, tc = jax_reduced(jc), reduced(tc)
            for enc in (False, True):
                js = JT.layer_plan(jc, encoder=enc)
                ts = T.layer_plan(tc, encoder=enc)
                assert [(len(s.pattern), s.repeats, [(p.cross, p.moe, p.causal)
                                                     for p in s.pattern]) for s in ts] == \
                       [(len(s.pattern), s.repeats, [(p.cross, p.moe, p.causal)
                                                     for p in s.pattern]) for s in js]
    assert get_config("zcode-m3-base").n_params() == jax_get_config("zcode-m3-base").n_params()


def test_init_model_matches_reference_layout():
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    tcfg = reduced(get_config("zcode-m3-base"))
    jflat = jax_flat(jax_init_model(jax.random.PRNGKey(0), jcfg))
    tflat = flatten_with_paths(init_model(torch.Generator().manual_seed(0), tcfg))
    assert sorted(tflat) == sorted(jflat)
    for key, want in jflat.items():
        got = tflat[key]
        assert tuple(got.shape) == want.shape, key
        assert got.dtype == torch.float32
        if want.size > 1000:    # same distribution, different bits
            assert abs(float(got.std()) - float(want.std())) < 0.1 * float(want.std()) + 1e-6, key


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["oracle", "cuda"])
def test_model_apply_matches(backend):
    jcfg, tcfg, jp, tp, jb, tb = _setup(backend)
    want, jaux = jax_model_apply(jp, jb, jcfg, is_training=False)
    got, taux = model_apply(tp, tb, tcfg, is_training=False)
    _close(got, want)
    for key in taux:
        _close(taux[key], jaux[key], atol=1e-4)


@pytest.mark.parametrize("flash,per_row", [(False, False), (True, True),
                                           (False, True)])
def test_prefill_and_decode_match(flash, per_row):
    jcfg, tcfg, jp, tp, jb, tb = _setup("cuda" if flash else "oracle")
    P, steps = 4, 3
    jpre = dict(jb, tokens=jb["tokens"][:, :P])
    tpre = dict(tb, tokens=tb["tokens"][:, :P])
    jl, jc = jax_prefill(jp, jpre, jcfg, max_seq=P + steps)
    tl, tc = prefill(tp, tpre, tcfg, max_seq=P + steps)
    _close(tl, jl)
    for i in range(steps):
        pos = P + i
        jidx = jnp.full((2,), pos, jnp.int32) if per_row else pos
        tidx = torch.full((2,), pos) if per_row else pos
        jl, jc = jax_decode_step(jp, jc, jb["tokens"][:, pos:pos + 1], jidx, jcfg,
                                 flash_decode=flash)
        tl, tc = decode_step(tp, tc, tb["tokens"][:, pos:pos + 1], tidx, tcfg,
                             flash_decode=flash)
        _close(tl, jl)


@pytest.mark.parametrize("prompt_len", [1, 5])
def test_prefill_decode_equals_forward_everywhere(prompt_len):
    """Prefill P tokens, then teacher-force decode positions P..L-1: logits
    equal the full forward at every position (first decode index is P)."""
    _, tcfg, _, tp, _, tb = _setup("cuda", ample_capacity=True, L_=8)
    L_ = tb["tokens"].shape[1]
    full, _ = model_apply(tp, tb, tcfg, decision=None, is_training=False)
    lg, caches = prefill(tp, dict(tb, tokens=tb["tokens"][:, :prompt_len]), tcfg,
                         max_seq=L_ + 1)
    torch.testing.assert_close(lg[:, 0], full[:, prompt_len - 1], atol=ATOL, rtol=0)
    for pos in range(prompt_len, L_):
        lg, caches = decode_step(tp, caches, tb["tokens"][:, pos:pos + 1], pos,
                                 tcfg, flash_decode=True)
        torch.testing.assert_close(lg[:, 0], full[:, pos], atol=3e-4, rtol=0,
                                   msg=f"position {pos}")


# ---------------------------------------------------------------------------
# bridge and isolation
# ---------------------------------------------------------------------------

def test_bridge_round_trip_bitwise(tmp_path):
    jcfg = jax_reduced(jax_get_config("zcode-m3-base"))
    jp = jax_init_model(jax.random.PRNGKey(3), jcfg)
    flat = jax_flat(jp)
    back, dtypes = bridge.to_numpy(bridge.to_torch(flat, "cpu"))
    assert dtypes == {} and sorted(back) == sorted(flat)
    for key in flat:
        assert back[key].dtype == flat[key].dtype
        np.testing.assert_array_equal(back[key], flat[key])
    # a bf16 tree through the reference's checkpoint layout (uint16 bits +
    # dtypes in meta.json), to torch and back
    jb16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    d = save_checkpoint(str(tmp_path), 1, jb16)
    arrays = dict(np.load(os.path.join(d, "arrays.npz")))
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    tp16 = bridge.to_torch(arrays, "cpu", dtypes=meta["dtypes"])
    wq = jb16["decoder"][0]["p0"]["attn"]["wq"]
    assert tp16["decoder"][0]["p0"]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp16["decoder"][0]["p0"]["attn"]["wq"].float().numpy(),
        np.asarray(wq.astype(jnp.float32)))
    back16, dtypes16 = bridge.to_numpy(tp16)
    assert dtypes16 == meta["dtypes"]
    for key in arrays:
        np.testing.assert_array_equal(back16[key], arrays[key])


def test_bridge_needs_a_card_unless_asked_for_cpu():
    flat = {"embed": np.ones((3, 2), np.float32)}
    assert bridge.to_torch(flat, "cpu")["embed"].device.type == "cpu"
    if torch.cuda.is_available():
        assert bridge.to_torch(flat, "cuda")["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bridge.to_torch(flat, "cuda")


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "need = {'repro_torch.core.gating_dropout', 'repro_torch.optim.adam',\n"
        "        'repro_torch.training.steps', 'repro_torch.training.loop',\n"
        "        'repro_torch.data.pipeline', 'repro_torch.data.prefetch',\n"
        "        'repro_torch.checkpoint.checkpoint', 'repro_torch.launch.train',\n"
        "        'repro_torch.kernels.moe_megakernel', 'repro_torch.serve.paged',\n"
        "        'repro_torch.serve.scheduler', 'repro_torch.obs.registry',\n"
        "        'repro_torch.obs.trace', 'repro_torch.kernels.flash_decode',\n"
        "        'repro_torch.comm', 'repro_torch.comm.cost', 'repro_torch.comm.substrate',\n"
        "        'repro_torch.metrics', 'repro_torch.metrics.bleu', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.obs.frame', 'repro_torch.analysis.hostsync',\n"
        "        'repro_torch.analysis.launches', 'repro_torch.models.mla',\n"
        "        'repro_torch.configs.deepseek_v3_671b', 'repro_torch.launch.dryrun',\n"
        "        'repro_torch.parallel.sharding'}\n"
        "assert need <= set(mods), sorted(need - set(mods))\n"
        "assert len(mods) >= 55, mods\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0, r.stderr
