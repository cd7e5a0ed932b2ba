"""The traffic generators. A mix is a data file (``traffic/<name>.json``)
of parameters that one of these reads; the inputs come from ``--seed``.

Every seed does the same work in another order: lengths are quantiles of
the stated distribution, the same set for every seed, and the seed draws
their order and the tokens.

``MTBatches`` (kind ``mt_bucketed``): the synthetic multilingual
translation task of the program's trainer (a copy of
``repro_torch/data/pipeline.py``'s ``MultilingualMT``: per-language token
permutations, a reversed target, Zipf content, a quarter of the languages
low-resource), batched as a translation trainer batches by length: each
step holds sentences of one length bucket, padded to the bucket's
length, as many rows as fill a fixed budget of positions a side. The
sentence lengths are a clipped log-normal; each bucket's rows take the
quantiles of the distribution within the bucket. The first steps run
every bucket once (set-up warms every shape); after them the buckets
come in proportion to the steps their sentences need, interleaved so
that any run of steps holds each bucket's share to within one step.

``OpenLoop`` (kind ``open_loop``): independent users sending on a
schedule whatever the system's state: Poisson arrivals at a fixed rate,
prompt and output lengths from clipped log-normals; the gaps and the
sizes come in blocks of quantiles, each block in an order drawn from the
seed; prompt tokens uniform over the vocabulary past the special ids.
"""
from __future__ import annotations

import math
import threading
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

PAD, BOS, EOS = 0, 1, 2
_N = NormalDist()


def quantile_lengths(n: int, lo: int, hi: int, *, median: float = None,
                     sigma: float = None) -> List[int]:
    """``n`` lengths at the mid quantiles (i + 1/2) / n of a log-normal of
    this median and sigma clipped to [lo, hi], or of the uniform over
    [lo, hi] without them."""
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if median is None:
            v = lo + u * (hi - lo)
        else:
            v = math.exp(math.log(median) + sigma * _N.inv_cdf(u))
        out.append(int(min(max(round(v), lo), hi)))
    return out


class LogNormalLengths:
    """Whole lengths ``round(v)``, v log-normal of ``median`` and ``sigma``,
    clipped to [``min``, ``max``]."""

    def __init__(self, d: Dict):
        self.median, self.sigma = float(d["median"]), float(d["sigma"])
        self.lo, self.hi = int(d["min"]), int(d["max"])

    def cdf(self, x: float) -> float:
        """P(length <= x)."""
        if x < self.lo:
            return 0.0
        if x >= self.hi:
            return 1.0
        return _N.cdf((math.log(math.floor(x) + 0.5) - math.log(self.median)) / self.sigma)

    def inv(self, u: float) -> int:
        """The length at quantile u."""
        u = min(max(u, 1e-12), 1 - 1e-12)
        v = math.exp(math.log(self.median) + self.sigma * _N.inv_cdf(u))
        return int(min(max(round(v), self.lo), self.hi))

    def between(self, n: int, a: int, c: int) -> List[int]:
        """``n`` lengths at the mid quantiles of the distribution within
        (a, c]."""
        fa, fc = self.cdf(a), self.cdf(c)
        return [min(max(self.inv(fa + (i + 0.5) / n * (fc - fa)), a + 1), c)
                for i in range(n)]


class MTBatches:
    """step -> the batch of that step (numpy, the program's
    ``enc_tokens``/``tokens``/``labels``/``loss_mask`` layout). A row of
    bucket P holds a sentence of n content tokens, 4 - 2 < n <= P - 2:
    source = language tag, content, EOS; target = BOS and the content's
    translation; labels = the translation and EOS; pads after them."""

    def __init__(self, traffic: Dict, vocab: int, seed: int):
        self.buckets = [int(p) for p in traffic["buckets"]]
        self.n_langs = int(traffic["n_langs"])
        self.seed = int(seed)
        dist = LogNormalLengths(traffic["length"])
        budget, mult = int(traffic["tokens_per_side"]), int(traffic.get("row_multiple", 8))
        self.rows = [max(budget // p // mult, 1) * mult for p in self.buckets]
        edges = [1] + [p - 2 for p in self.buckets]
        if dist.lo <= edges[0] or dist.hi > edges[-1]:
            raise ValueError("the buckets must hold every sentence length")
        self.lengths = [np.asarray(dist.between(r, a, c), np.int64)
                        for r, a, c in zip(self.rows, edges[:-1], edges[1:])]
        mass = np.asarray([dist.cdf(c) - dist.cdf(a) for a, c in zip(edges[:-1], edges[1:])])
        need = mass / np.asarray(self.rows)           # steps a sentence of each bucket needs
        self.share = need / need.sum()
        self.first_content = 3 + self.n_langs
        self.n_content = vocab - self.first_content
        root = np.random.default_rng([self.seed, 0])
        self.perms = np.stack([root.permutation(self.n_content)
                               for _ in range(self.n_langs)])
        n_low = max(1, int(self.n_langs * traffic["low_resource_frac"]))
        w = np.ones(self.n_langs)
        w[-n_low:] = traffic["low_resource_weight"]
        self.lang_p = w / w.sum()
        ranks = np.arange(1, self.n_content + 1)
        zipf = 1.0 / ranks ** traffic["zipf"]
        self.content_p = zipf / zipf.sum()
        order = np.random.default_rng([self.seed, 2])
        self._order = [int(b) for b in order.permutation(len(self.buckets))]
        self._credit = order.random(len(self.buckets))
        self._lock = threading.Lock()

    def bucket(self, step: int) -> int:
        """The bucket (an index of ``buckets``) of ``step``: every bucket
        once in the first steps, then in proportion to ``share``, each
        step taking the bucket furthest behind its share."""
        with self._lock:
            while len(self._order) <= step:
                self._credit += self.share
                b = int(np.argmax(self._credit))
                self._credit[b] -= 1.0
                self._order.append(b)
            return self._order[step]

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        bi = self.bucket(step)
        rng = np.random.default_rng([self.seed, 1, int(step)])
        b, L = self.rows[bi], self.buckets[bi]
        n_max = L - 2
        langs = rng.choice(self.n_langs, size=b, p=self.lang_p)
        n = rng.permutation(self.lengths[bi])
        content = rng.choice(self.n_content, size=(b, n_max), p=self.content_p)
        pos = np.arange(n_max)[None, :]
        valid = pos < n[:, None]
        fc = self.first_content
        enc = np.full((b, L), PAD, np.int64)
        enc[:, 0] = 3 + langs
        enc[:, 1:1 + n_max] = np.where(valid, content + fc, PAD)
        enc[np.arange(b), 1 + n] = EOS
        t_fwd = self.perms[langs[:, None], content]
        tgt = np.take_along_axis(t_fwd, np.maximum(n[:, None] - 1 - pos, 0), axis=1)
        body = np.where(valid, tgt + fc, PAD)
        dec = np.full((b, L), PAD, np.int64)
        dec[:, 0] = BOS
        dec[:, 1:1 + n_max] = body
        lab = np.full((b, L), PAD, np.int64)
        lab[:, :n_max] = body
        lab[np.arange(b), n] = EOS
        msk = (np.arange(L)[None, :] < (n + 1)[:, None]).astype(np.float32)
        return {"enc_tokens": enc, "tokens": dec, "labels": lab, "loss_mask": msk}

    @staticmethod
    def lengths_of(batch: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """Each row's source and target tokens, pads excluded."""
        return ((batch["enc_tokens"] != PAD).sum(1).astype(np.int64),
                batch["loss_mask"].sum(1).astype(np.int64))

    @staticmethod
    def tokens(batch: Dict[str, np.ndarray]) -> int:
        """Source plus target tokens of a batch, pads excluded."""
        s, t = MTBatches.lengths_of(batch)
        return int(s.sum() + t.sum())


class OpenLoop:
    """The request stream of independent users at ``rate`` requests a
    second: request j is due ``due(j)`` seconds after the stream starts
    (the sum of the gaps before it and its own)
    and is (prompt tokens, output budget). Gaps are the quantiles of the
    exponential of that rate, prompt and output lengths those of their
    log-normals, ``block`` of each to a block, each block in its own
    seeded order (three independent orders): every seed sends the same
    sizes at the same gaps, in another order."""

    def __init__(self, traffic: Dict, vocab: int, seed: int):
        self.vocab = vocab
        self.rate = float(traffic["rate"])
        self.block = int(traffic["block"])
        self.prompt_q = np.asarray([LogNormalLengths(traffic["prompt"]).inv((i + 0.5) / self.block)
                                    for i in range(self.block)], np.int64)
        self.output_q = np.asarray([LogNormalLengths(traffic["output"]).inv((i + 0.5) / self.block)
                                    for i in range(self.block)], np.int64)
        self.gap_q = np.asarray([-math.log(1.0 - (i + 0.5) / self.block) / self.rate
                                 for i in range(self.block)])
        self.seed = int(seed)
        self._orders: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._due: List[float] = []

    def _order(self, b: int):
        if b not in self._orders:
            rng = np.random.default_rng([self.seed, 5, b])
            self._orders[b] = tuple(rng.permutation(self.block) for _ in range(3))
        return self._orders[b]

    def sizes(self, j: int) -> Tuple[int, int]:
        """(prompt length, output budget) of request j."""
        b, i = divmod(j, self.block)
        po, oo, _ = self._order(b)
        return int(self.prompt_q[po[i]]), int(self.output_q[oo[i]])

    def due(self, j: int) -> float:
        """Seconds from the stream's start to request j's send."""
        while len(self._due) <= j:
            b, i = divmod(len(self._due), self.block)
            gap = float(self.gap_q[self._order(b)[2][i]])
            self._due.append((self._due[-1] if self._due else 0.0) + gap)
        return self._due[j]

    def request(self, j: int) -> Tuple[np.ndarray, int]:
        n, budget = self.sizes(j)
        rng = np.random.default_rng([self.seed, 3, j])
        return rng.integers(3, self.vocab, size=n, dtype=np.int64), budget
