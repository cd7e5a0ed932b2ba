"""The two configurations' forward passes in plain PyTorch, in float32.

Written from the model's definition, not from the program: layer norm
(eps 1e-6), token embeddings, the encoder's sinusoidal positions, RoPE
(rotate halves) in self-attention, grouped-query heads, cross-attention
onto the encoder, a dense FFN (tanh-GELU) or an MoE layer (softmax router
with multiplicative input jitter in training, top-k by a stable sort,
top-k weights renormalised for k > 1, per-expert capacity filled in token
order with the rest dropped, the switch balance loss), and the output
head. Weights come as ``{path: tensor}`` in the program's layout
(``segments``, ``layer``).

``r`` is where the program rounds to its activation type: identity in the
reference, a lower precision in the control (``rounder``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Rounder = Callable[[torch.Tensor], torch.Tensor]
FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (its largest
    magnitude at the type's largest value)."""
    s = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class _Round(torch.autograd.Function):
    """Rounds the value and, on the way back, its gradient, as a cast to a
    narrower type and back does."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def rounder(kind: Optional[str]) -> Optional[Rounder]:
    """None (float32 throughout), "fp8" or "bf16"."""
    if kind is None:
        return None
    fn = {"fp8": _fp8,
          "bf16": lambda x: x.to(torch.bfloat16).to(x.dtype)}[kind]
    return lambda x: _Round.apply(x, fn)


def weight_rounder(kind: Optional[str]) -> Optional[Rounder]:
    """The weights of a matrix product in ``kind`` (no gradient: served
    weights); None keeps them."""
    if kind is None:
        return None
    fn = {"fp8": _fp8, "bf16": lambda x: x.to(torch.bfloat16).to(x.dtype)}[kind]
    return lambda w: fn(w) if w.dim() >= 2 else w


def _r(r: Optional[Rounder], x: torch.Tensor) -> torch.Tensor:
    return x if r is None else r(x)


def segments(kinds) -> list:
    """The weights' grouping of a stack whose layers are of ``kinds``: the
    whole stack as one repeated pattern where one of period <= 8 repeats
    at least twice, else runs of equal layers. [(pattern length, repeats)]."""
    n = len(kinds)
    for p in range(1, 9):
        if n % p == 0 and n // p > 1 and all(kinds[i] == kinds[i % p] for i in range(n)):
            return [(p, n // p)]
    out, i = [], 0
    while i < n:
        j = i
        while j < n and kinds[j] == kinds[i]:
            j += 1
        out.append((1, j - i))
        i = j
    return out


def layer(flat: Dict[str, torch.Tensor], stack: str, i: int, kinds, w=None) -> Dict:
    """Layer ``i`` of ``stack`` (its layers of ``kinds``) as {sub-path:
    tensor} in float32: leaf ``<stack>/<segment>/p<i in pattern>/...``,
    row = repeat; ``w`` rounds each weight matrix (the control)."""
    for si, (p, reps) in enumerate(segments(kinds)):
        if i < p * reps:
            break
        i -= p * reps
    prefix = f"{stack}/{si}/p{i % p}/"
    out = {k[len(prefix):]: v[i // p].float() for k, v in flat.items()
           if k.startswith(prefix)}
    if not out:
        raise KeyError(prefix)
    return out if w is None else {k: w(v) for k, v in out.items()}


def norm(p: Dict, name: str, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * p[f"{name}/scale"]
    return y + p[f"{name}/bias"] if f"{name}/bias" in p else y


def sinusoidal(n: int, d: int, device) -> torch.Tensor:
    """sin(pos * w_j) at column 2j, cos at 2j + 1; w_j = 10000^(-2j/d)
    (the exponent's scale taken in float32)."""
    pos = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    scale = float(torch.tensor(-math.log(10000.0), dtype=torch.float32)
                  / torch.tensor(float(d), dtype=torch.float32))
    w = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float32) * scale)
    pe = torch.zeros((n, d), device=device)
    pe[:, 0::2] = torch.sin(pos * w)
    pe[:, 1::2] = torch.cos(pos * w[: d - d // 2])
    return pe


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, L, H, hd) at positions 0..L-1; the halves rotated."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x.chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def attend(q, k, v, causal: bool) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v; k, v heads repeated to q's."""
    h, kv = q.shape[2], k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _proj(x, w):
    return torch.einsum("bld,dhk->blhk", x, w)


def self_attention(p, name, h, c, causal, r):
    q, k, v = (_proj(h, p[f"{name}/{w}"]) for w in ("wq", "wk", "wv"))
    q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    k, v = _r(r, k), _r(r, v)
    o = attend(q, k, v, causal)
    return torch.einsum("blhk,hkd->bld", o, p[f"{name}/wo"])


def cross_attention(p, h, src):
    q = _proj(h, p["cross/wq"])
    k, v = _proj(src, p["cross/wk"]), _proj(src, p["cross/wv"])
    return torch.einsum("blhk,hkd->bld", attend(q, k, v, False), p["cross/wo"])


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) if name == "silu" else F.gelu(x, approximate="tanh")


def ffn(p, prefix, x, c, e=None):
    """The FFN of ``prefix`` (an expert's rows ``e`` of stacked weights)."""
    w = (lambda n: p[f"{prefix}/{n}"]) if e is None else (lambda n: p[f"{prefix}/{n}"][e])
    h = x @ w("w_in")
    h = act(c["act"], x @ w("w_gate")) * h if c["gated_mlp"] else act(c["act"], h)
    return h @ w("w_out")


def moe(p, x, c, *, noise: Optional[Callable], training: bool, local: bool,
        shard: int = 0, shards: int = 1, r=None, isolated: bool = False):
    """The MoE layer on the tokens x (T, d) of expert shard ``shard`` of
    ``shards`` (a rank's rows: routed and filled to capacity on their own);
    ``local`` routes them to the shard's own experts only (Gate-Drop's
    dropped step). ``noise(shard, shape)`` is the router jitter in
    training. ``isolated`` is a fault: the exchange between shards left
    out, so only the shard's own experts' outputs come back. Returns (y,
    the shard's balance loss, 0 on a local step)."""
    m = c["moe"]
    E, k = m["n_experts"], m["top_k"]
    cf = m["capacity_factor"] if training else m["eval_capacity_factor"]
    T, d = x.shape
    xr = x
    if training and m["jitter_eps"] > 0 and noise is not None:
        xr = _r(r, x * noise(shard, (T, d)))
    logits = xr @ p["moe/router/w"]
    e_n = E // shards if local else E
    if local:
        ids = torch.arange(E, device=x.device)
        lo = shard * e_n
        logits = logits.masked_fill(~((ids >= lo) & (ids < lo + e_n))[None], -math.inf)
    probs = torch.softmax(logits, dim=-1)
    _, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    idx = order[:, :k]
    w = probs.gather(1, idx)
    if k > 1:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = min(math.ceil(cf * T * k / e_n), T)
    flat = idx.reshape(-1)
    pos = torch.empty_like(flat)
    for e in torch.unique(flat).tolist():
        sel = (flat == e).nonzero()[:, 0]
        pos[sel] = torch.arange(sel.numel(), device=x.device)
    keep = pos < cap
    if local:
        keep = keep & (w.reshape(-1) > 0)
    if isolated:
        keep = keep & (flat // (E // shards) == shard)
    y = torch.zeros_like(x)
    for e in torch.unique(flat[keep]).tolist():
        sel = ((flat == e) & keep).nonzero()[:, 0]
        tok = sel // k
        out = _r(r, ffn(p, "moe/experts", x[tok], c, e))
        y = y.index_add(0, tok, w.reshape(-1)[sel][:, None] * out)
    bal = x.new_zeros(())
    if not local and m["router_type"] != "hash":
        f = torch.zeros(E, device=x.device).index_add_(
            0, idx[:, 0], torch.ones(T, device=x.device)) / T
        bal = E * torch.sum(f.detach() * probs.mean(0))
    return _r(r, y), bal


def block(p, x, c, *, causal: bool, cross=None, moe_layer: bool, noise=None,
          training: bool = False, local: bool = False, shard: int = 0, shards: int = 1,
          r=None, isolated: bool = False):
    """One pre-norm layer: self-attention, cross-attention onto ``cross``
    where given, then the FFN or MoE layer, each added to the residual."""
    x = _r(r, x + _r(r, self_attention(p, "attn", _r(r, norm(p, "ln1", x)), c, causal, r)))
    if cross is not None:
        x = _r(r, x + _r(r, cross_attention(p, _r(r, norm(p, "ln_cross", x)), cross)))
    h = _r(r, norm(p, "ln2", x))
    b, l, d = h.shape
    if moe_layer:
        y, bal = moe(p, h.reshape(b * l, d), c, noise=noise, training=training,
                     local=local, shard=shard, shards=shards, r=r, isolated=isolated)
        y = y.reshape(b, l, d)
    else:
        y, bal = _r(r, ffn(p, "ffn", h, c)), h.new_zeros(())
    return _r(r, x + y), bal


def _is_moe(c, i):
    m = c["moe"]
    return i >= m["first_dense_layers"] and \
        (i - m["first_dense_layers"]) % m["moe_layer_period"] == 0


def encdec_hidden(flat, c, batch, *, noise_of=None, local=False, shard=0, shards=1,
                  r=None, isolated=False, checkpoint=False):
    """The encoder-decoder's final-norm decoder states (B, L, d) and the
    balance losses summed over its MoE layers, on the rows of expert shard
    ``shard`` of ``shards``. ``noise_of(stack, layer)`` gives a layer's
    jitter (None: no jitter). ``checkpoint`` keeps only each layer's input
    for the backward pass and computes the layer again there (the same
    values: the jitter is drawn again from its seed)."""
    def run(*args, **kw):
        if not checkpoint:
            return block(*args, **kw)
        return torch.utils.checkpoint.checkpoint(
            lambda *a: block(*a, **kw), *args, use_reentrant=False)

    kinds_e = [_is_moe(c, i) for i in range(c["encoder"]["n_layers"])]
    kinds_d = [_is_moe(c, i) for i in range(c["n_layers"])]
    training = noise_of is not None
    emb = flat["embed"]
    src = batch["enc_tokens"]
    x = _r(r, emb[src])
    x = _r(r, x + _r(r, sinusoidal(src.shape[1], c["d_model"], x.device)[None]))
    bal = x.new_zeros(())
    for i in range(c["encoder"]["n_layers"]):
        x, b = run(layer(flat, "encoder", i, kinds_e), x, c, causal=c["encoder"]["causal"],
                   moe_layer=_is_moe(c, i), noise=noise_of and noise_of("encoder", i),
                   training=training, local=local, shard=shard, shards=shards, r=r,
                   isolated=isolated)
        bal = bal + b
    enc = _r(r, norm({"n/scale": flat["enc_final_norm/scale"],
                      "n/bias": flat["enc_final_norm/bias"]}, "n", x))
    x = _r(r, emb[batch["tokens"]])
    for i in range(c["n_layers"]):
        x, b = run(layer(flat, "decoder", i, kinds_d), x, c, causal=True, cross=enc,
                   moe_layer=_is_moe(c, i), noise=noise_of and noise_of("decoder", i),
                   training=training, local=local, shard=shard, shards=shards, r=r,
                   isolated=isolated)
        bal = bal + b
    return _r(r, _final_norm(flat, x)), bal


def _final_norm(flat, x):
    p = {"n/scale": flat["final_norm/scale"]}
    if "final_norm/bias" in flat:
        p["n/bias"] = flat["final_norm/bias"]
    return norm(p, "n", x)


def n_moe_layers(c) -> int:
    n = sum(_is_moe(c, i) for i in range(c["n_layers"]))
    n += sum(_is_moe(c, i) for i in range(c.get("encoder", {}).get("n_layers", 0)))
    return max(n, 1)


def decoder_logits(flat, c, tokens: torch.Tensor, r=None, w=None) -> torch.Tensor:
    """A decoder-only model's logits (n, V) at every position of one
    sequence ``tokens`` (n,), as served (no jitter, serving capacity), in
    float32 whatever the weights' type; ``r`` rounds the activations and
    ``w`` the weight matrices (the control)."""
    kinds = [_is_moe(c, i) for i in range(c["n_layers"])]
    w = w or (lambda t: t)
    x = _r(r, w(flat["embed"][tokens].float())[None])
    for i in range(c["n_layers"]):
        x, _ = block(layer(flat, "decoder", i, kinds, w), x, c, causal=True,
                     moe_layer=_is_moe(c, i), r=r)
    h = _r(r, _final_norm({k: v.float() for k, v in flat.items() if k.startswith("final_norm")}, x))
    return (h @ w(flat["lm_head"].float()))[0]
