"""The window's arithmetic (a rate over the whole window, a percentile
over every request, the quartile spread) and the result line."""
import io
import json
import statistics
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from bench.lib import common


def test_rate_is_all_the_work_over_all_the_time():
    assert common.rate(300, 1.5) == 200
    with pytest.raises(ValueError):
        common.rate(1, 0.0)


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_matches_numpy_over_every_value(q):
    rng = np.random.default_rng(q)
    xs = list(rng.lognormal(size=257))
    assert common.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)
    assert common.percentile([3.0], q) == 3.0
    with pytest.raises(ValueError):
        common.percentile([], q)


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert common.spread(xs) == pytest.approx((q3 - q1) / med)


def test_judge_compares_only_limited_numbers_and_emit_puts_check_last():
    check = common.judge({"a": 0.5, "b": 2.0, "c": 9.0}, {"a": 1.0, "b": 1.0})
    assert set(check) == {"a", "b"}
    assert not common.passes(check)
    assert common.passes(common.judge({"a": 0.5}, {"a": 1.0}))
    assert not common.passes(common.judge({"a": float("nan")}, {"a": 1.0}))
    with pytest.raises(KeyError):
        common.judge({}, {"a": 1.0})
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        common.emit({"check": check, "device": {}, "metrics": {}, "failed": 0,
                     "attempted": 1, "correct": False})
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert err.getvalue().strip().splitlines()[-1].startswith("check b: 2.0 limit 1.0")


def test_seed_streams_differ_and_fit_a_generator():
    s = (1 << 31) + 7
    seeds = {common.seed_stream(s, k) for k in range(4)}
    assert len(seeds) == 4 and all(0 <= x < 1 << 63 for x in seeds)
    assert common.forbidden_modules(["jax.numpy", "repro_torch.models", "repro.core", "flax"]) \
        == ["flax", "jax.numpy", "repro.core"]
