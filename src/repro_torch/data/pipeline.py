"""Deterministic synthetic data pipelines (a copy of
``repro/data/pipeline.py``, which imports only numpy: the port keeps its
own so that it imports nothing of the reference; the tests hold the two
to the same batches, bit for bit).

The paper's task (multilingual MT on WMT-10 / Web-50) is not
redistributable, so the reference generates a *structured* synthetic
analogue that preserves the property Gating Dropout exploits:
per-language structure that experts can specialize on.

Multilingual MT task: each "language" l has a seeded token permutation
pi_l. A sample for direction (l_src -> l_tgt) is
    source  = [tag(l_tgt)] s_1..s_n [EOS]
    target  = reverse(pi_{l_tgt}(s))               (so the model must learn
                                                    a per-language mapping +
                                                    a global reordering rule)
Low-resource languages appear with small sampling weight. Everything is a
pure function of (seed, step, shard), so the pipeline is reproducible and
shards are disjoint by construction.

Batch synthesis is vectorized: each task draws all of a batch's
randomness up-front in a fixed order, then assembles the rows with numpy
array ops. The loop-based assembly survives as ``sample_batch_loop`` (the
readable reference consuming the exact same draws).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

PAD, BOS, EOS = 0, 1, 2


@dataclass(frozen=True)
class MTTaskConfig:
    vocab: int = 512
    n_langs: int = 8
    low_resource_frac: float = 0.25   # last quarter of langs are low-resource
    low_resource_weight: float = 0.05
    src_len: Tuple[int, int] = (8, 24)
    max_len: int = 32
    seed: int = 1234
    dae_frac: float = 0.0             # fraction of DAE (denoising) samples


class MultilingualMT:
    """Deterministic multilingual translation generator."""

    def __init__(self, cfg: MTTaskConfig):
        self.cfg = cfg
        self.first_content = 3 + cfg.n_langs
        self.n_content = cfg.vocab - self.first_content
        assert self.n_content > 10, "vocab too small"
        root = np.random.default_rng(cfg.seed)
        self.perms = [root.permutation(self.n_content)
                      for _ in range(cfg.n_langs)]
        n_low = max(1, int(cfg.n_langs * cfg.low_resource_frac))
        w = np.ones(cfg.n_langs)
        w[-n_low:] = cfg.low_resource_weight
        self.lang_weights = w / w.sum()
        self.low_langs = list(range(cfg.n_langs - n_low, cfg.n_langs))
        # Zipf-ish content distribution
        ranks = np.arange(1, self.n_content + 1)
        zipf = 1.0 / ranks ** 1.1
        self.content_p = zipf / zipf.sum()

    def lang_tag(self, lang: int) -> int:
        return 3 + lang

    def train_batches(self, batch: int, **kw):
        """step -> model-ready batch: ``sample_batch`` minus the ``lang``
        key (per-sample metadata the jitted train step must not see).
        THE batch_fn adapter for Trainer/launcher/benchmark use."""
        def fn(step: int) -> Dict[str, np.ndarray]:
            return {k: v for k, v in self.sample_batch(step, batch,
                                                       **kw).items()
                    if k != "lang"}
        return fn

    def translate(self, src_content: np.ndarray, lang: int) -> np.ndarray:
        return self.perms[lang][src_content][::-1]

    def _draws(self, step: int, batch: int, *, shard: int, n_shards: int,
               lang: Optional[int]) -> Dict[str, np.ndarray]:
        """All of the batch's randomness, drawn up-front in a fixed order.

        Both assembly paths (vectorized / loop reference) consume exactly
        this dict, so they are equal by construction; the draw ORDER here
        is the data-stream contract behind --resume."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + shard)
        b = batch // n_shards
        n_max = cfg.src_len[1]
        langs = (np.full((b,), lang, np.int64) if lang is not None
                 else rng.choice(cfg.n_langs, size=b, p=self.lang_weights
                                 ).astype(np.int64))
        n = rng.integers(cfg.src_len[0], cfg.src_len[1] + 1, size=b)
        content = rng.choice(self.n_content, size=(b, n_max), p=self.content_p)
        d = {"langs": langs, "n": n, "content": content}
        if cfg.dae_frac > 0:
            d["dae_u"] = rng.random(b)
            d["keep_u"] = rng.random((b, n_max))
        return d

    def sample_batch(self, step: int, batch: int, *, shard: int = 0,
                     n_shards: int = 1, lang: Optional[int] = None,
                     ) -> Dict[str, np.ndarray]:
        """One global batch, pure numpy array ops; shards draw disjoint
        sub-batches. Equal to ``sample_batch_loop`` element-for-element."""
        cfg = self.cfg
        d = self._draws(step, batch, shard=shard, n_shards=n_shards, lang=lang)
        langs, n, content = d["langs"], d["n"], d["content"]
        b, n_max = content.shape
        L = cfg.max_len
        fc = self.first_content
        pos = np.arange(n_max)[None, :]
        valid = pos < n[:, None]                       # (b, n_max)

        if cfg.dae_frac > 0:
            is_dae = d["dae_u"] < cfg.dae_frac
            keep = valid & (d["keep_u"] > 0.15)
            # DAE rows where everything was corrupted keep the first token
            keep[is_dae & ~keep.any(1), 0] = True
        else:
            is_dae = np.zeros(b, bool)
            keep = valid

        # source: DAE rows compact the surviving tokens (stable order), MT
        # rows take the first n as-is
        src_mask = np.where(is_dae[:, None], keep, valid)
        order = np.argsort(~src_mask, axis=1, kind="stable")
        src = np.take_along_axis(content, order, axis=1)
        src_len = src_mask.sum(1)

        # target: DAE reconstructs the clean source; MT applies the
        # per-language permutation then reverses the first n tokens
        perm = np.stack(self.perms)                    # (n_langs, n_content)
        t_fwd = perm[langs[:, None], content]
        rev = np.take_along_axis(t_fwd, np.maximum(n[:, None] - 1 - pos, 0),
                                 axis=1)
        tgt = np.where(is_dae[:, None], content, rev)

        rows = np.arange(b)
        W = max(L, n_max + 2)
        enc = np.full((b, W), PAD, np.int64)
        enc[:, 0] = 3 + langs
        enc[:, 1:1 + n_max] = np.where(pos < src_len[:, None], src + fc, PAD)
        enc[rows, 1 + src_len] = EOS
        enc = np.ascontiguousarray(enc[:, :L])

        m = np.minimum(n, L - 1)
        body = np.where(pos < m[:, None], tgt + fc, PAD)[:, :L - 1]
        dec = np.full((b, L), PAD, np.int64)
        dec[:, 0] = BOS
        dec[:, 1:1 + body.shape[1]] = body
        lab = np.full((b, L), PAD, np.int64)
        lab[:, :body.shape[1]] = body
        lab[rows, m] = EOS
        msk = (np.arange(L)[None, :] < (m + 1)[:, None]).astype(np.float32)
        return {"enc_tokens": enc, "tokens": dec, "labels": lab,
                "loss_mask": msk, "lang": langs}

    def sample_batch_loop(self, step: int, batch: int, *, shard: int = 0,
                          n_shards: int = 1, lang: Optional[int] = None,
                          ) -> Dict[str, np.ndarray]:
        """Per-sample loop assembly over the same draws — the readable
        reference the vectorized path is tested against."""
        cfg = self.cfg
        d = self._draws(step, batch, shard=shard, n_shards=n_shards, lang=lang)
        b = d["content"].shape[0]
        L = cfg.max_len
        enc = np.full((b, L), PAD, np.int64)
        dec = np.full((b, L), PAD, np.int64)
        lab = np.full((b, L), PAD, np.int64)
        msk = np.zeros((b, L), np.float32)
        for i in range(b):
            l = int(d["langs"][i])
            n = int(d["n"][i])
            s = d["content"][i, :n]
            is_dae = cfg.dae_frac > 0 and d["dae_u"][i] < cfg.dae_frac
            if is_dae:
                # denoising auto-encoding: corrupt source, reconstruct it
                keep = d["keep_u"][i, :n] > 0.15
                src_tokens = s[keep] if keep.any() else s[:1]
                tgt = s
            else:
                src_tokens = s
                tgt = self.translate(s, l)
            enc_row = np.concatenate([[self.lang_tag(l)],
                                      src_tokens + self.first_content, [EOS]])
            tgt_row = tgt + self.first_content
            enc[i, :len(enc_row)] = enc_row[:L]
            dec[i, 0] = BOS
            m = min(len(tgt_row), L - 1)
            dec[i, 1:1 + m] = tgt_row[:m]
            lab[i, :m] = tgt_row[:m]
            lab[i, m] = EOS
            msk[i, :m + 1] = 1.0
        return {"enc_tokens": enc, "tokens": dec, "labels": lab,
                "loss_mask": msk, "lang": d["langs"]}


@dataclass(frozen=True)
class LMTaskConfig:
    vocab: int = 512
    seq_len: int = 128
    order: int = 2                   # Markov order of the synthetic source
    seed: int = 99


class SyntheticLM:
    """Deterministic Markov-chain LM data (decoder-only archs)."""

    def __init__(self, cfg: LMTaskConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # sparse-ish transition: each context maps to ~8 likely next tokens
        self.a = int(rng.integers(3, 97)) * 2 + 1
        self.b = int(rng.integers(1, cfg.vocab))
        self.noise_p = 0.1

    def _draws(self, step: int, batch: int, *, shard: int, n_shards: int
               ) -> Dict[str, np.ndarray]:
        """Up-front draws in a fixed order (the --resume stream contract):
        initial tokens, then per-step noise uniforms, then noise values."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 999_983 + step) * 4096 + shard)
        b = batch // n_shards
        L = cfg.seq_len
        return {"init": rng.integers(3, cfg.vocab, size=b),
                "noise_u": rng.random((L, b)),
                "noise_v": rng.integers(3, cfg.vocab, size=(L, b))}

    def sample_batch(self, step: int, batch: int, *, shard: int = 0,
                     n_shards: int = 1) -> Dict[str, np.ndarray]:
        """Vectorized over BOTH batch and time: the affine chain map
        g(x) = (a*x + b) mod m + 3 composes in closed form
        (g^k(x) = (A_k*x + B_k) mod m + 3), so every position is computed
        directly from its most recent noise reset — no sequential loop.
        Equal to ``sample_batch_loop`` element-for-element."""
        cfg = self.cfg
        d = self._draws(step, batch, shard=shard, n_shards=n_shards)
        b = d["init"].shape[0]
        L = cfg.seq_len
        m = cfg.vocab - 3
        # iterated-map coefficients: A_{k+1} = a*A_k, B_{k+1} = a*(B_k+3) + b
        # (mod m), with A_0 = 1, B_0 = -3 so that g^0 is the identity on
        # the +3-shifted domain
        A = np.zeros(L + 1, np.int64)
        B = np.zeros(L + 1, np.int64)
        A[0], B[0] = 1, -3 % m
        for k in range(L):
            A[k + 1] = (self.a * A[k]) % m
            B[k + 1] = (self.a * (B[k] + 3) + self.b) % m
        cols = np.arange(L + 1)[None, :]
        noise = d["noise_u"] < self.noise_p              # (L, b)
        # column j>0 is a reset iff noise fired at step j-1; column 0 always
        reset = np.concatenate([np.ones((b, 1), bool), noise.T], axis=1)
        last = np.maximum.accumulate(np.where(reset, cols, 0), axis=1)
        seed_vals = np.concatenate([d["init"][:, None], d["noise_v"].T], axis=1)
        base = np.take_along_axis(np.where(reset, seed_vals, 0), last, axis=1)
        k = cols - last
        toks = (A[k] * base + B[k]) % m + 3
        return {"tokens": toks[:, :L], "labels": toks[:, 1:],
                "loss_mask": np.ones((b, L), np.float32)}

    def sample_batch_loop(self, step: int, batch: int, *, shard: int = 0,
                          n_shards: int = 1) -> Dict[str, np.ndarray]:
        """Sequential-chain assembly over the same draws — the readable
        reference the closed-form path is tested against."""
        cfg = self.cfg
        d = self._draws(step, batch, shard=shard, n_shards=n_shards)
        b = d["init"].shape[0]
        L = cfg.seq_len
        toks = np.zeros((b, L + 1), np.int64)
        toks[:, 0] = d["init"]
        for t in range(L):
            nxt = (self.a * toks[:, t] + self.b) % (cfg.vocab - 3) + 3
            noise = d["noise_u"][t] < self.noise_p
            toks[:, t + 1] = np.where(noise, d["noise_v"][t], nxt)
        return {"tokens": toks[:, :L], "labels": toks[:, 1:],
                "loss_mask": np.ones((b, L), np.float32)}
