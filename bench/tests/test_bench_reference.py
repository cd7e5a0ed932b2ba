"""The plain reference is the model's mathematics: at reduced sizes on the
CPU, in float32, it agrees with the port's plain path — three zcode
training steps (losses, first gradients, updated parameters, a Gate-Drop
step among them) and dbrx-like logits of a prefill followed by decode
steps through the cache. This file imports both; the reference itself
imports nothing of the port."""
import numpy as np
import pytest
import torch

from bench.lib import modelcfg, traffic, weights
from bench.reference import gate_drop
from bench.reference import model as RM
from bench.reference import train as RT
from bench.tests import tiny_cells as T


def _f32(files):
    cj = dict(files["config"], dtype="float32")
    return cj


@pytest.mark.parametrize("backend", ["cuda", "oracle"])
def test_three_training_steps_match_the_ports(backend):
    from repro_torch.training import Trainer
    from repro_torch.tree import flatten_with_paths
    f = T.zcode_files()
    cj, tj = _f32(f), f["traffic"]
    seed = T.SEED
    assert [gate_drop.dropped(seed, s, 0.3) for s in range(3)].count(True) >= 1
    cfg = modelcfg.model_config(cj, {"backend": backend})
    layout = modelcfg.layout(cfg)
    dev = torch.device("cpu")
    batch_fn = traffic.MTBatches(tj, cj["vocab"], 11)
    flat = weights.make(layout, 5, dev, 4)
    tc = modelcfg.train_config(cj, seed, steps=1)
    trainer = Trainer(cfg, tc, batch_fn, device=dev, params=modelcfg.tree(flat), chunk=1,
                      log=None, log_every=1)
    trainer.run()
    grads = {k: float(v.norm()) / (1 - tc.b1)
             for k, v in flatten_with_paths(trainer.state["opt"]["m"]).items()}
    import dataclasses
    trainer.start_step, trainer.tc = 1, dataclasses.replace(tc, steps=3)
    trainer.run()
    ref = weights.make(layout, 5, dev, 4)
    batches = [{k: torch.from_numpy(v) for k, v in batch_fn(i).items()} for i in range(3)]
    out = RT.run(ref, cj, batches, seed=seed)
    assert out["dropped"] == [gate_drop.dropped(seed, s, 0.3) for s in range(3)]
    np.testing.assert_allclose([h["loss"] for h in trainer.history], out["losses"], rtol=2e-6)
    for k, g in out["grad_norms"].items():
        assert grads[k] == pytest.approx(g, rel=1e-4, abs=1e-7), k
    # Adam moves an element whose gradient is round-off by up to lr (1.8e-3
    # at step 3) in either direction; 1e-5 allows that on a few elements
    for k in flat:
        torch.testing.assert_close(flat[k], ref[k], rtol=1e-5, atol=1e-5)


def test_gate_drop_bits_are_the_ports():
    from repro_torch.configs.base import GatingDropoutConfig
    from repro_torch.core.gating_dropout import drop_decisions_host
    cfg = GatingDropoutConfig(mode="gate_drop", rate=0.3)
    for seed in (0, 7, (1 << 31) + 977, 3_000_000_101):
        bits = drop_decisions_host(cfg, seed, 0, 64)
        assert list(bits) == [gate_drop.dropped(seed, s, 0.3) for s in range(64)]


def test_the_jitter_is_the_ports():
    """The reference's jitter generators draw what the port's layer
    generators draw (the model's stream: step, layer, shard)."""
    from repro_torch.core.moe import shard_generator
    from repro_torch.models.transformer import _layer_generator
    from repro_torch.training.steps import step_generator
    seed = T.SEED
    for step, layer, shard in ((0, 0, 0), (2, 5, 0), (1, 3, 2)):
        g = shard_generator(_layer_generator(step_generator("cpu", seed, step), layer), shard)
        want = torch.empty(4, 8, dtype=torch.bfloat16).uniform_(0.99, 1.01, generator=g)
        got = torch.empty(4, 8, dtype=torch.bfloat16).uniform_(
            0.99, 1.01, generator=torch.Generator().manual_seed(RT.jitter_seed(seed, step, layer, shard)))
        assert torch.equal(want, got)


def test_prefill_and_decode_logits_match_the_ports():
    from repro_torch.models.model import decode_step, prefill
    f = T.dbrx_files()
    cj = _f32(f)
    cfg = modelcfg.model_config(cj, {"backend": "cuda_fused"})
    flat = weights.make(modelcfg.layout(cfg), 9, torch.device("cpu"), cj["n_layers"])
    params = modelcfg.tree(flat)
    seq = torch.randint(3, cj["vocab"], (14,), generator=torch.Generator().manual_seed(1))
    p = 9
    with torch.no_grad():
        logits, caches = prefill(params, {"tokens": seq[None, :p]}, cfg, max_seq=20)
        got = [logits[0, -1]]
        for i in range(p, len(seq) - 1):
            lg, caches = decode_step(params, caches, seq[None, i:i + 1], i, cfg,
                                     flash_decode=True)
            got.append(lg[0, -1])
        ref = RM.decoder_logits(flat, cj, seq[:-1])[p - 1:]
    torch.testing.assert_close(torch.stack(got), ref, rtol=1e-4, atol=1e-4)


def test_served_tokens_of_the_scheduler_have_no_gap_in_float32():
    from bench.lib import common
    f = T.dbrx_files()
    f["config"]["dtype"] = "float32"
    drv = common.load_module(common.BENCH / "drivers" / "serve_open.py")
    out = drv.run(T.job("dbrx-serve-conv", f, seconds=0.5))
    assert out["numbers"]["logit_gap"] < 1e-4
    assert out["e2e"]["ttft_p90_ms"] > 0 and out["e2e"]["tpot_p90_ms"] > 0


def test_layer_grouping_is_the_ports():
    from repro_torch.models.transformer import LayerSpec, _compress
    for kinds in ([True, False] * 6, [True] * 4, [True, False], [True, True, False]):
        segs = _compress([LayerSpec(moe=k) for k in kinds])
        assert [(len(s.pattern), s.repeats) for s in segs] == RM.segments(kinds)
