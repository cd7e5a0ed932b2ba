"""Basic layers: norms, embeddings, RoPE, dense FFN (port of
``repro/models/layers.py``). Functional style: ``init_*`` builds a param
dict, ``*_apply`` consumes it. ``lead`` on the init functions prepends
stacking axes (the layers of one segment share one tensor)."""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]


class MetaGenerator:
    """Stands in for a generator on the meta device, which torch refuses
    (``torch.Generator(device="meta")`` raises): the init functions draw
    nothing from it and give meta tensors of the real init's shapes and
    dtypes (``models/model.py::init_model_meta``)."""
    device = torch.device("meta")


def normal(gen: torch.Generator, shape: Tuple[int, ...], std: float,
           dtype: torch.dtype) -> torch.Tensor:
    """N(0, std^2) drawn from ``gen`` on the generator's device (an empty
    meta tensor from a ``MetaGenerator``)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device).mul_(std)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(gen: torch.Generator, cfg: ModelConfig, d: int, dtype,
              lead: Tuple[int, ...] = ()) -> Params:
    p = {"scale": torch.ones(lead + (d,), dtype=dtype, device=gen.device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=dtype, device=gen.device)
    return p


def norm_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm / RMSNorm computed in f32, returned in x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return normal(gen, (vocab, d), d ** -0.5, dtype)


def embed_apply(embed: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, embed)


def sinusoidal_pos(seq: int, d: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Sine at even columns, cosine at odd. As in the reference, the cosine
    half takes ``div[: d - d // 2]``, which fits the odd columns only for
    even d."""
    pos = torch.arange(seq, device=device, dtype=torch.float32)[:, None]
    # the exponent's scale rounded to f32 first, as the reference's f32 math
    scale = float(-np.float32(math.log(10000.0)) / np.float32(d))
    div = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float32)
                    * scale)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: (d - d // 2)])
    return pe.to(dtype)


# ---------------------------------------------------------------------------
# RoPE (rotate halves, not interleaved pairs)
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., L, H, hd); positions: (L,) or (..., L)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    ang = positions[..., :, None].float() * freqs              # (..., L, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                      # (..., L, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense FFN (the non-MoE sub-layer)
# ---------------------------------------------------------------------------

def init_ffn(gen: torch.Generator, d: int, dff: int, cfg: ModelConfig, dtype,
             out_scale: float = 1.0, lead: Tuple[int, ...] = ()) -> Params:
    p = {
        "w_in": normal(gen, lead + (d, dff), d ** -0.5, dtype),
        "w_out": normal(gen, lead + (dff, d), dff ** -0.5 * out_scale, dtype),
    }
    if cfg.gated_mlp:
        p["w_gate"] = normal(gen, lead + (d, dff), d ** -0.5, dtype)
    return p


def _act(h: torch.Tensor, name: str) -> torch.Tensor:
    return F.silu(h) if name == "silu" else F.gelu(h, approximate="tanh")


def ffn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xc = x.to(p["w_in"].dtype)
    h = xc @ p["w_in"]
    if cfg.gated_mlp:
        h = _act(xc @ p["w_gate"], cfg.act) * h
    else:
        h = _act(h, cfg.act)
    return (h @ p["w_out"]).to(x.dtype)
