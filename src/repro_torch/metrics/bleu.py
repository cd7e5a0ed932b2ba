"""Corpus BLEU over token ids and basic metrics (port of
``repro/metrics/bleu.py``, the same arithmetic, so the same id lists give
the same float).

The paper reports sacreBLEU on detokenized text; with synthetic token data
corpus BLEU is computed directly on id sequences, the quantity playing the
same role (n-gram overlap with the reference).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence

import numpy as np


def _ngrams(seq: Sequence[int], n: int) -> Counter:
    return Counter(tuple(seq[i:i + n]) for i in range(len(seq) - n + 1))


def corpus_bleu(hyps: List[Sequence[int]], refs: List[Sequence[int]],
                max_n: int = 4) -> float:
    if len(hyps) != len(refs):
        raise ValueError(f"{len(hyps)} hypotheses for {len(refs)} references")
    log_p = 0.0
    hyp_len = sum(len(h) for h in hyps)
    ref_len = sum(len(r) for r in refs)
    if hyp_len == 0:
        return 0.0
    for n in range(1, max_n + 1):
        match, total = 0, 0
        for h, r in zip(hyps, refs):
            hng, rng_ = _ngrams(h, n), _ngrams(r, n)
            match += sum(min(c, rng_[g]) for g, c in hng.items())
            total += max(len(h) - n + 1, 0)
        if total == 0:
            return 0.0
        # smoothed (add-eps) precision
        log_p += math.log((match + 1e-9) / (total + 1e-9))
    # sacreBLEU semantics: the brevity penalty applies only to hypotheses
    # strictly shorter than the reference
    bp = 1.0 if hyp_len >= ref_len else math.exp(1 - ref_len / hyp_len)
    return 100.0 * bp * math.exp(log_p / max_n)


def strip_special(seq: Sequence[int], eos: int = 2, pad: int = 0) -> List[int]:
    """Ids up to the first ``eos``, without ``pad``."""
    out = []
    for t in seq:
        if t == eos:
            break
        if t != pad:
            out.append(int(t))
    return out


def token_accuracy(pred: np.ndarray, labels: np.ndarray,
                   mask: np.ndarray) -> float:
    ok = (pred == labels) * mask
    return float(ok.sum() / max(mask.sum(), 1))
