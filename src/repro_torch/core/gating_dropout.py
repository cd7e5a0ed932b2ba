"""Gating Dropout's per-step consensus bit (port of
``repro/core/gating_dropout.py``).

At each training step, with probability ``rate``, every machine skips the
MoE all-to-all and routes tokens to its local experts (Gate-Drop) or skips
the MoE sub-layer (Gate-Expert-Drop). The reference reaches consensus
without communication: every host folds the step into one PRNG key,

  bit(seed, step) = bernoulli(fold_in(PRNGKey(seed ^ 0x6A7ED0), step), rate)

The card has no JAX, so this module computes JAX's draw itself, bit for
bit, in numpy uint32 arithmetic: the Threefry-2x32 block cipher (20
rounds), ``PRNGKey`` and ``fold_in`` as ``jax.random`` builds them on the
threefry implementation, and ``uniform`` -> ``bernoulli`` as drawn with
``jax_threefry_partitionable=True`` (the default of the JAX the reference
runs on): the 32 random bits of a scalar draw are the XOR of the two
output words of Threefry applied to the counter (0, 0). The decision is a
host bool, vectorised over a range of steps.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import GatingDropoutConfig

_SEED_XOR = 0x6A7ED0
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << np.uint32(d)) | (v >> np.uint32(32 - d))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds: key words (k0, k1) and counter words
    (x0, x1), uint32 scalars or arrays that broadcast -> the two output
    words."""
    k0, k1 = np.asarray(k0, np.uint32), np.asarray(k1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):       # uint32 sums wrap, as intended
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (threefry, 32-bit seeds): (0, seed)."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for uint32 ``data``, a scalar or
    an array: keys of shape data.shape + (2,)."""
    data = np.asarray(data, np.uint32)
    y0, y1 = threefry2x32(key[0], key[1], np.zeros_like(data), data)
    return np.stack([y0, y1], axis=-1)


def random_bits32(keys: np.ndarray) -> np.ndarray:
    """32 random bits of a scalar draw from each key (partitionable
    threefry): threefry(key, (0, 0)), words XORed."""
    keys = np.asarray(keys, np.uint32)
    zero = np.zeros(keys.shape[:-1], np.uint32)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], zero, zero)
    return y0 ^ y1


def uniform(keys: np.ndarray) -> np.ndarray:
    """``jax.random.uniform(key, (), float32)`` for each key: the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits32(keys)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def decision_key(seed: int, step) -> np.ndarray:
    """The consensus key of a step (or of an array of steps)."""
    return fold_in(prng_key(seed ^ _SEED_XOR), step)


def drop_decisions_host(cfg: GatingDropoutConfig, seed: int, start: int,
                        stop: int, *, is_training: bool = True) -> np.ndarray:
    """The bits of steps [start, stop) as a bool array, bitwise the
    reference's ``drop_decisions_host``."""
    n = max(stop - start, 0)
    if not is_training or not cfg.enabled or n == 0:
        return np.zeros(n, bool)
    keys = decision_key(seed, np.arange(start, stop, dtype=np.int64))
    return uniform(keys) < np.float32(cfg.rate)


def drop_decision_host(cfg: GatingDropoutConfig, seed: int, step: int, *,
                       is_training: bool = True) -> bool:
    """The bit of one step: True drops the all-to-all."""
    return bool(drop_decisions_host(cfg, seed, step, step + 1,
                                    is_training=is_training).any())


def expected_alltoall_fraction(cfg: GatingDropoutConfig) -> float:
    """Fraction of steps that still pay the all-to-all: 1 - p (both modes)."""
    return 1.0 - (cfg.rate if cfg.enabled else 0.0)


def expected_expert_flop_fraction(cfg: GatingDropoutConfig) -> float:
    """Fraction of expert FLOPs still paid. Gate-Expert-Drop also skips the
    expert computation on dropped steps (paper §3.1)."""
    if cfg.mode == "gate_expert_drop" and cfg.enabled:
        return 1.0 - cfg.rate
    return 1.0
