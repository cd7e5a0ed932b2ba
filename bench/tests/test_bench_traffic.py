"""The traffic generators: deterministic per seed, the same sizes for every
seed in another order, and the distributions the mixes state."""
import statistics

import numpy as np
import pytest

from bench.lib import common, traffic

MT = common.cell_files("zcode-train-gd03")["traffic"]
CONV = common.cell_files("dbrx-serve-conv")["traffic"]
BIG = (1 << 31) + 12345


def test_quantile_lengths_follow_the_stated_distribution():
    n = 4096
    logn = traffic.quantile_lengths(n, 32, 256, median=96, sigma=0.5)
    assert min(logn) == 32 and max(logn) == 256
    assert abs(statistics.median(logn) - 96) <= 1
    assert logn == sorted(logn)
    uni = traffic.quantile_lengths(128, 16, 62)
    assert uni[0] == 16 and uni[-1] == 62
    assert abs(statistics.mean(uni) - 39) < 0.5


def test_lognormal_lengths_invert_their_distribution():
    d = traffic.LogNormalLengths({"median": 27, "sigma": 0.55, "min": 4, "max": 126})
    assert d.cdf(3) == 0.0 and d.cdf(126) == 1.0
    assert d.inv(0.5) == 27 and abs(d.cdf(27) - 0.5) < 0.02
    for u in (0.01, 0.2, 0.7, 0.95):
        n = d.inv(u)
        assert d.cdf(n - 1) <= u <= d.cdf(n) + 1e-12
    within = d.between(100, 30, 46)
    assert min(within) == 31 and max(within) == 46 and within == sorted(within)


@pytest.mark.parametrize("seed", [BIG, BIG + 1, 3])
def test_open_loop_sends_the_same_sizes_at_the_same_gaps_for_every_seed(seed):
    a = traffic.OpenLoop(CONV, 1000, seed)
    ref = traffic.OpenLoop(CONV, 1000, BIG + 7)
    n = a.block
    for blk in (0, 3):
        sa = [a.sizes(blk * n + i) for i in range(n)]
        assert sorted(x for x, _ in sa) == sorted(ref.prompt_q)
        assert sorted(y for _, y in sa) == sorted(ref.output_q)
        gaps = [a.due(blk * n + i) - (a.due(blk * n + i - 1) if blk * n + i else 0.0)
                for i in range(n)]
        assert sorted(gaps) == pytest.approx(sorted(ref.gap_q))
    assert [a.sizes(i) for i in range(n)] != [ref.sizes(i) for i in range(n)]
    assert a.due(n - 1) == pytest.approx(sum(ref.gap_q))       # whole blocks end alike
    assert a.due(4 * n - 1) == pytest.approx(sum(ref.gap_q) * 4)
    t, budget = a.request(5)
    t2, budget2 = traffic.OpenLoop(CONV, 1000, seed).request(5)
    assert np.array_equal(t, t2) and budget == budget2 and len(t) == a.sizes(5)[0]
    assert t.min() >= 3 and t.max() < 1000


def test_open_loop_follows_the_stated_distributions():
    a = traffic.OpenLoop(CONV, 1000, BIG)
    p, o = CONV["prompt"], CONV["output"]
    assert abs(statistics.median(a.prompt_q) - p["median"]) <= p["median"] * 0.05
    assert abs(statistics.median(a.output_q) - o["median"]) <= o["median"] * 0.05
    assert p["min"] <= min(a.prompt_q) and max(a.prompt_q) <= p["max"]
    assert o["min"] <= min(a.output_q) and max(a.output_q) <= o["max"]
    assert statistics.mean(a.gap_q) == pytest.approx(1 / CONV["rate"], rel=0.05)


def test_mt_batches_are_deterministic_and_hold_the_same_token_count():
    a = traffic.MTBatches(MT, 64000, BIG)
    b = traffic.MTBatches(MT, 64000, BIG)
    c = traffic.MTBatches(MT, 64000, BIG + 1)
    x, y = a(5), b(5)
    for k in x:
        assert np.array_equal(x[k], y[k])
    nb = len(a.buckets)
    # every bucket once in set-up, in an order drawn from the seed
    assert sorted(a.bucket(i) for i in range(nb)) == list(range(nb))
    assert [a.bucket(i) for i in range(nb)] != [c.bucket(i) for i in range(nb)]
    # any run of steps holds each bucket's share to within a step
    for lo, n in ((nb, 40), (nb + 17, 100)):
        seq = [a.bucket(i) for i in range(lo, lo + n)]
        for bi in range(nb):
            assert abs(seq.count(bi) - n * a.share[bi]) < 2
    # a bucket's batch: the same rows and token count for every seed
    for bi, L in enumerate(a.buckets):
        sa = next(i for i in range(nb) if a.bucket(i) == bi)
        sc = next(i for i in range(nb) if c.bucket(i) == bi)
        xa, xc = a(sa), c(sc)
        assert xa["tokens"].shape == xc["tokens"].shape == (a.rows[bi], L)
        assert a.rows[bi] * L <= MT["tokens_per_side"] and a.rows[bi] % MT["row_multiple"] == 0
        assert traffic.MTBatches.tokens(xa) == traffic.MTBatches.tokens(xc)
        assert not np.array_equal(xa["enc_tokens"], xc["enc_tokens"])
    # every row: language tag, content, EOS, pads; target = BOS + body, labels end in EOS
    x = a(0)
    rows = np.arange(len(x["tokens"]))
    n = (x["enc_tokens"] != traffic.PAD).sum(1) - 2
    assert np.array_equal(np.sort(n), np.sort(a.lengths[a.bucket(0)]))
    assert (x["tokens"][:, 0] == traffic.BOS).all()
    assert (x["labels"][rows, n] == traffic.EOS).all()
    assert np.array_equal(x["loss_mask"].sum(1), n + 1)
    assert np.array_equal(x["tokens"][:, 1:][x["loss_mask"][:, 1:] > 0],
                          x["labels"][:, :-1][x["loss_mask"][:, 1:] > 0])


def test_mt_pads_are_a_small_share_of_the_positions():
    a = traffic.MTBatches(MT, 64000, BIG)
    nb = len(a.buckets)
    real = pos = 0
    for i in range(nb, nb + 200):
        bi = a.bucket(i)
        real += int((2 * a.lengths[bi] + 3).sum())
        pos += 2 * a.rows[bi] * a.buckets[bi]
    assert 1 - real / pos < 0.15
