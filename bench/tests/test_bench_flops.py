"""Model FLOPs: the frozen count against a hand count at zcode-m3-base's
shapes, and against the matrix-product FLOPs PyTorch counts in the port's
own training step (remat off, a tiny config) and dbrx-like prefill."""
import pytest
import torch

from bench.lib import common, flops
from bench.tests import tiny_cells as T


def test_zcode_step_against_a_hand_count():
    c = common.cell_files("zcode-train-gd03")["config"]
    b, s, t, d, f, v = 128, 64, 64, 512, 2048, 64000
    attn_proj = 2 * 4 * d * d
    enc = 12 * b * s * (attn_proj + 4 * s * d + 2 * 2 * d * f) + 6 * b * s * 2 * d * 128
    dec = 6 * b * t * (attn_proj + 4 * t * d + 4 * d * d + 4 * s * d + 2 * 2 * d * f) \
        + 3 * b * t * 2 * d * 128 + 6 * b * s * 4 * d * d
    head = b * t * 2 * d * v
    count = flops.train_batch(c, [s] * b, [t] * b)
    assert count == pytest.approx(3 * (enc + dec + head), rel=1e-12)
    assert 4.5e12 < count < 5.5e12


def test_train_count_takes_only_the_real_tokens_of_a_padded_batch():
    """Rows of 5 and 3 real tokens padded to 8: each real token's products,
    its queries against its own row's real keys, the head on real targets."""
    c = common.cell_files("zcode-train-gd03")["config"]
    d, f, v, e = 512, 2048, 64000, 128
    attn_proj, a1 = 2 * 4 * d * d, 4 * d
    rows = [(5, 4), (3, 2)]                               # (source, target) real tokens
    want = 0
    for s, t in rows:
        want += 12 * (s * (attn_proj + 2 * 2 * d * f) + a1 * s * s) + 6 * s * 2 * d * e
        want += 6 * (t * (attn_proj + 4 * d * d + 2 * 2 * d * f) + a1 * t * t + a1 * t * s
                     + s * 4 * d * d) + 3 * t * 2 * d * e
        want += t * 2 * d * v
    got = flops.train_batch(c, [s for s, _ in rows], [t for _, t in rows])
    assert got == pytest.approx(3 * want, rel=1e-12)
    assert got < flops.train_batch(c, [8, 8], [8, 8])
    from bench.lib import traffic
    tj = dict(common.cell_files("zcode-train-gd03")["traffic"], tokens_per_side=256)
    mt = traffic.MTBatches(tj, 64000, 7)
    src, tgt = traffic.MTBatches.lengths_of(mt(0))
    assert (src <= mt.buckets[mt.bucket(0)]).all() and (tgt == src - 1).all()
    assert src.sum() + tgt.sum() == traffic.MTBatches.tokens(mt(0))


def test_train_count_equals_the_ports_matmul_flops():
    from torch.utils.flop_counter import FlopCounterMode
    from bench.lib import modelcfg, traffic, weights
    from repro_torch.training.steps import total_loss
    f = T.zcode_files()
    cj, tj = f["config"], f["traffic"]
    cj = dict(cj, remat=False, dtype="float32")
    cj["moe"] = dict(cj["moe"], capacity_factor=4.0)     # every expert row a token
    cfg = modelcfg.model_config(cj, {"backend": "oracle"})
    flat = weights.make(modelcfg.layout(cfg), 3, torch.device("cpu"), 4)
    tree = modelcfg.tree(flat)
    for p in flat.values():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in
             traffic.MTBatches(tj, cj["vocab"], 5)(0).items()}
    b, L = batch["tokens"].shape                          # every position computed
    with FlopCounterMode(display=False) as fc:
        loss, _ = total_loss(tree, batch, cfg, generator=None, decision=False)
        torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    e = cj["moe"]["n_experts"]
    T_tok = b * L
    cap = min(-(-4 * T_tok // e), T_tok)                  # rows computed per expert
    d, dff = cj["d_model"], cj["d_ff"]
    n_moe = 2                                             # one a stack
    padding = 3 * n_moe * 2 * 2 * d * dff * (e * cap - T_tok)
    assert fc.get_total_flops() == pytest.approx(
        flops.train_batch(cj, [L] * b, [L] * b) + padding, rel=1e-9)


def test_serve_count_equals_the_ports_prefill_flops_at_the_last_position():
    from torch.utils.flop_counter import FlopCounterMode
    from bench.lib import modelcfg, weights
    from repro_torch.models.model import prefill
    f = T.dbrx_files()
    cj = dict(f["config"], dtype="float32")
    cfg = modelcfg.model_config(cj, {"backend": "oracle"})
    flat = weights.make(modelcfg.layout(cfg), 3, torch.device("cpu"), 2)
    n = 16
    tokens = torch.randint(3, cj["vocab"], (1, n))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        prefill(modelcfg.tree(flat), {"tokens": tokens}, cfg, max_seq=32)
    m = cj["moe"]
    cap = min(-(-m["eval_capacity_factor"] * n * m["top_k"] // m["n_experts"]), n)
    e_rows = m["n_experts"] * cap - n * m["top_k"]        # empty capacity rows
    ffn_row = 2 * 3 * cj["d_model"] * m["d_ff_expert"]
    h, hd = cj["n_heads"], cj["head_dim"]
    causal_saving = cj["n_layers"] * 4 * h * hd * (n * n - n * (n + 1) / 2)
    combine = 2 * n * m["top_k"] * cj["d_model"]        # the plain backend's weighted sum
    want = (flops.serve_request(cj, n, 1) + causal_saving
            + cj["n_layers"] * (e_rows * ffn_row + combine))
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-9)
