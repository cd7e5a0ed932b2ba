"""A run with the timed path broken underneath comes out not correct: the
harness past its look for a card, on tiny cells on the CPU, against the
cells' own limits, once for each fault a cell can have. Training: a step
that returns its state unchanged; half of the batch left out, the mean
taken over the rest. Serving: tokens altered where they are produced.
(The exchange between chips exists in no cell of this benchmark.)"""
import pytest

from bench.lib import common
from bench.run import run_job
from bench.tests import tiny_cells as T

MAN = common.manifest()


def test_a_sound_run_is_correct():
    assert run_job(T.job("zcode-train-gd03", T.zcode_files()), MAN)["correct"]
    assert run_job(T.job("dbrx-serve-conv", T.dbrx_files(), seconds=0.5), MAN)["correct"]


def _unchanged(grads, opt, params, tc, ctx=None):
    import torch
    zero = torch.zeros((), device=next(iter(opt["m"].values())).device) \
        if isinstance(opt["m"], dict) else torch.zeros(())
    return params, {"m": opt["m"], "v": opt["v"], "step": opt["step"] + 1}, \
        {"lr": 0.0, "grad_norm": zero}


def _half(batch, ctx):
    n = next(iter(batch.values())).shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(fault, monkeypatch):
    from repro_torch.training import steps
    if fault == "state_unchanged":
        monkeypatch.setattr(steps, "adam_update", _unchanged)
    else:
        monkeypatch.setattr(steps, "rank_rows", _half)
    r = run_job(T.job("zcode-train-gd03", T.zcode_files()), MAN)
    assert not r["correct"], r["check"]


def test_tokens_altered_where_produced_are_not_correct(monkeypatch):
    from repro_torch.serve import scheduler
    orig = scheduler._select_rows

    def altered(gen, logits, seed, row_seeds, steps):
        tok, lp = orig(gen, logits, seed, row_seeds, steps)
        import torch
        bad = torch.as_tensor(steps, device=tok.device).reshape(-1) % 5 == 3
        return torch.where(bad, (tok + 1) % logits.shape[-1], tok), lp

    monkeypatch.setattr(scheduler, "_select_rows", altered)
    r = run_job(T.job("dbrx-serve-conv", T.dbrx_files(), seconds=0.5), MAN)
    assert not r["correct"], r["check"]
