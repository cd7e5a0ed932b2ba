"""Model FLOPs from a configuration's shapes (the benchmark's
``configs/<name>.json``): what the model's matrix products need, with no
recomputation, counted from the shapes alone.

A product of an (m, k) by a (k, n) matrix is 2 m k n operations; a
training step is the forward and twice it for the backward. Per token and
layer: the attention projections, the attention itself (scores and
values, 4 x keys x heads x head_dim: in training every real key of the
row, in serving the causal prefix), the dense FFN, or the router and the top-k experts'
FFN (an MoE layer's capacity padding is not model work); the head on every
position whose logits the step uses. Pads are not model work either: a
training step is counted over each row's real tokens."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _moe_on(m: Dict, i: int) -> bool:
    if i < m.get("first_dense_layers", 0):
        return False
    return (i - m.get("first_dense_layers", 0)) % m["moe_layer_period"] == 0


def _ffn(c: Dict, moe_layer: bool) -> float:
    d = c["d_model"]
    mats = 3 if c["gated_mlp"] else 2
    if moe_layer:
        m = c["moe"]
        f = m.get("d_ff_expert") or c["d_ff"]
        return 2.0 * d * m["n_experts"] + m["top_k"] * 2.0 * mats * d * f
    return 2.0 * mats * d * c["d_ff"]


def _heads(c: Dict):
    hd = c.get("head_dim") or c["d_model"] // c["n_heads"]
    return c["n_heads"], c["n_kv_heads"], hd


def _attn_proj(c: Dict) -> float:
    d = c["d_model"]
    h, kv, hd = _heads(c)
    return 2.0 * (d * hd * (h + 2 * kv) + h * hd * d)


def _attn(c: Dict, keys: float) -> float:
    h, _, hd = _heads(c)
    return 4.0 * keys * h * hd


def train_batch(c: Dict, src_lens: Sequence[int], tgt_lens: Sequence[int]) -> float:
    """An encoder-decoder training step on rows of ``src_lens[i]`` source
    and ``tgt_lens[i]`` target tokens, pads excluded: each real token's
    products, its queries against its row's real keys, and the head on
    every real target position."""
    d = c["d_model"]
    s = np.asarray(src_lens, np.float64)
    t = np.asarray(tgt_lens, np.float64)
    a1 = _attn(c, 1.0)                                       # a query against one key
    fwd = 0.0
    for i in range(c["encoder"]["n_layers"]):
        fwd += s.sum() * (_attn_proj(c) + _ffn(c, _moe_on(c["moe"], i))) + a1 * (s * s).sum()
    for i in range(c["n_layers"]):
        fwd += (t.sum() * (_attn_proj(c) + 4.0 * d * d + _ffn(c, _moe_on(c["moe"], i)))
                + a1 * (t * t).sum() + a1 * (t * s).sum()    # self, cross read
                + s.sum() * 4.0 * d * d)                     # cross k, v
    fwd += t.sum() * 2.0 * d * c["vocab"]
    return 3.0 * float(fwd)


def serve_request(c: Dict, prompt: int, generated: int) -> float:
    """A decoder-only request: its prompt's prefill (logits at its last
    position) and ``generated - 1`` decode steps (the first token comes
    from the prefill)."""
    d = c["d_model"]
    body = sum(_attn_proj(c) + _ffn(c, _moe_on(c["moe"], i))
               for i in range(c["n_layers"]))
    n = prompt + generated - 1                   # positions run through the body
    keys = n * (n + 1) / 2.0                     # causal: position i reads i + 1 keys
    return (n * body + c["n_layers"] * _attn(c, keys)
            + generated * 2.0 * d * c["vocab"])
