"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060; port of
``repro/models/ssm.py``).

The chunked SSD forward (an intra-chunk quadratic part, the chunks' states
and an inter-chunk linear recurrence) for training and prefill, and the
O(1)-state recurrence for decode. Plain PyTorch, as the reference is jnp:
no kernel runs here.

Against the reference:
  * ``jnp.repeat(..., axis)`` of B and C over the heads of a group is
    ``repeat_interleave`` (each group's row repeated in place);
  * ``jax.nn.softplus`` is ``logaddexp(x, 0)``: ``softplus`` below is its
    formula, not ``torch.nn.functional.softplus`` (which returns ``x``
    past a threshold);
  * the inter-chunk ``lax.scan`` is a loop over the chunks;
  * the intra-chunk decay is ``exp`` of its exponent masked to ``-inf``
    above the diagonal, where the reference masks ``exp``'s result. The
    masked exponent is a positive sum that overflows f32 to ``inf`` at
    long chunks (mamba2-1.3b: 128 positions, |a| up to 16), and ``where``'s
    backward multiplies that ``inf`` by 0 (NaN). The forward keeps the
    reference's bits wherever they are finite;
  * the three-operand einsums are two contractions whose intermediates
    stay at (B, chunks, Q, H, N): no per-position (P, N) product;
  * ``ssm_decode`` writes the new conv window and state INTO its cache (the
    reference returns an updated copy) and returns that cache.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import normal

Params = Dict[str, Any]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, n_groups * d_state)."""
    s = cfg.ssm
    din = s.d_inner(cfg.d_model)
    return din, din // s.head_dim, s.n_groups * s.d_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype,
             out_scale: float = 1.0, lead: Tuple[int, ...] = ()) -> Params:
    """The reference's leaves and distributions (its bits differ), stacked
    over ``lead``."""
    s = cfg.ssm
    d = cfg.d_model
    din, h, gn = _dims(cfg)
    conv_ch = din + 2 * gn
    dev = gen.device
    sd = d ** -0.5

    def const(v: torch.Tensor) -> torch.Tensor:
        return v.to(dtype).expand(lead + tuple(v.shape)).clone()

    return {
        "w_z": normal(gen, lead + (d, din), sd, dtype),
        "w_x": normal(gen, lead + (d, din), sd, dtype),
        "w_B": normal(gen, lead + (d, gn), sd, dtype),
        "w_C": normal(gen, lead + (d, gn), sd, dtype),
        "w_dt": normal(gen, lead + (d, h), sd, dtype),
        "dt_bias": const(torch.full((h,), math.log(math.expm1(0.01)), device=dev)),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, h, device=dev))),
        "D": const(torch.ones((h,), device=dev)),
        "conv_w": normal(gen, lead + (s.conv_kernel, conv_ch), 0.2, dtype),
        "conv_b": const(torch.zeros((conv_ch,), device=dev)),
        "out_norm": const(torch.ones((din,), device=dev)),
        "w_out": normal(gen, lead + (din, d), din ** -0.5 * out_scale, dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, C), w: (K, C)."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:l] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + l] * w[i]
    return out + b


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    yf = (y * F.silu(z)).float()
    return (yf * torch.rsqrt((yf ** 2).mean(-1, keepdim=True) + eps)
            * scale.float()).to(y.dtype)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bs: torch.Tensor, cs: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. xh: (B,L,H,P); dt: (B,L,H); a: (H,) negative; bs, cs:
    (B,L,G,N). Returns y (B,L,H,P) in xh's dtype and the final state
    (B,H,P,N) in f32."""
    b, l, h, p = xh.shape
    g, n = bs.shape[2], bs.shape[3]
    rep = h // g
    if l % chunk:
        raise ValueError(f"length {l} is not a multiple of the chunk {chunk}")
    nc = l // chunk
    xc = xh.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    bc = bs.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()
    cc = cs.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()
    cum = torch.cumsum(dtc * a.float(), dim=2)                # (B,nc,Q,H)
    # ---- intra-chunk (quadratic within the chunk) ----
    scores = torch.einsum("bcihn,bcjhn->bcijh", cc, bc)         # (B,nc,Q,Q,H)
    ii = torch.arange(chunk, device=xh.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.exp(torch.where(causal, diff, float("-inf")))
    att = torch.where(causal, scores * decay, 0.0) * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", att, xc)
    # ---- chunk states ----
    last = cum[:, :, -1:, :]                                    # (B,nc,1,H)
    w_state = torch.exp(last - cum) * dtc                       # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjhn,bcjhp->bchpn", bc * w_state[..., None], xc)
    # ---- inter-chunk recurrence ----
    chunk_decay = torch.exp(last[:, :, 0, :])                   # (B,nc,H)
    hprev = (xh.new_zeros((b, h, p, n), dtype=torch.float32) if h0 is None
             else h0.float())
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_in = torch.stack(h_in, 1)                                 # (B,nc,H,P,N) entering
    y_inter = torch.einsum("bcihn,bchpn->bcihp", cc * torch.exp(cum)[..., None], h_in)
    y = (y_diag + y_inter).reshape(b, l, h, p)
    return y.to(xh.dtype), hprev


def _projections(prm: Params, x: torch.Tensor):
    """(x in the parameters' dtype, the conv's input xBC before the conv)."""
    xc = x.to(prm["w_z"].dtype)
    xbc = torch.cat([xc @ prm["w_x"], xc @ prm["w_B"], xc @ prm["w_C"]], -1)
    return xc, xbc


def _scan_inputs(prm: Params, xc: torch.Tensor, xbc: torch.Tensor,
                 cfg: ModelConfig):
    """(xs, bs, cs, dt, a) of a full sequence, padded to whole chunks."""
    s = cfg.ssm
    b, l, _ = xc.shape
    din, h, gn = _dims(cfg)
    xbc = F.silu(_causal_conv(xbc, prm["conv_w"], prm["conv_b"]))
    xs = xbc[..., :din].reshape(b, l, h, s.head_dim)
    bs = xbc[..., din:din + gn].reshape(b, l, s.n_groups, s.d_state)
    cs = xbc[..., din + gn:].reshape(b, l, s.n_groups, s.d_state)
    dt = softplus((xc @ prm["w_dt"]).float() + prm["dt_bias"].float())
    a = -torch.exp(prm["A_log"].float())
    pad = (-l) % s.chunk
    if pad:
        xs, bs, cs = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs, bs, cs))
        dt = F.pad(dt, (0, 0, 0, pad))
    return xs, bs, cs, dt, a


def conv_tail(xbc: torch.Tensor, k: int) -> torch.Tensor:
    """The decode cache's conv window: the last ``k - 1`` rows of xBC,
    zero rows before a prompt shorter than that."""
    l = xbc.shape[1]
    if l < k - 1:
        return F.pad(xbc, (0, 0, k - 1 - l, 0))
    return xbc[:, l - (k - 1):]


def ssm_apply(prm: Params, x: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False):
    """Full-sequence Mamba-2 mixer (train / prefill). With
    ``return_state``, also the decode cache the sequence leaves: its conv
    window (in the parameters' dtype, as the reference's prefill leaves
    it) and the final state ``h`` (f32)."""
    s = cfg.ssm
    b, l, _ = x.shape
    din, _, _ = _dims(cfg)
    xc, xbc = _projections(prm, x)
    z = xc @ prm["w_z"]
    xs, bs, cs, dt, a = _scan_inputs(prm, xc, xbc, cfg)
    y, hfin = ssd_chunked(xs, dt, a, bs, cs, s.chunk)
    y = y[:, :l]
    y = y + prm["D"].to(y.dtype)[None, None, :, None] * xs[:, :l].to(y.dtype)
    y = _gated_norm(y.reshape(b, l, din), z, prm["out_norm"])
    out = (y @ prm["w_out"]).to(x.dtype)
    if return_state:
        return out, {"conv": conv_tail(xbc, s.conv_kernel), "h": hfin}
    return out


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None,
                   lead: Tuple[int, ...] = ()) -> Params:
    """The conv window in the cache's dtype, the state always f32."""
    s = cfg.ssm
    din, h, gn = _dims(cfg)
    return {
        "conv": torch.zeros(lead + (batch, s.conv_kernel - 1, din + 2 * gn),
                            dtype=dtype, device=device),
        "h": torch.zeros(lead + (batch, h, s.head_dim, s.d_state),
                         dtype=torch.float32, device=device),
    }


def ssm_decode(prm: Params, x: torch.Tensor, cache: Params,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One-token recurrent step, x: (B, 1, d). Every row is independent of
    its position. The shifted conv window and the new state are written
    into ``cache`` in place."""
    s = cfg.ssm
    b = x.shape[0]
    din, h, gn = _dims(cfg)
    rep = h // s.n_groups
    xc, xbc_new = _projections(prm, x[:, 0])
    z = xc @ prm["w_z"]
    conv = cache["conv"]
    win = torch.cat([conv, xbc_new[:, None].to(conv.dtype)], 1)           # (B,K,C)
    wdt = torch.promote_types(win.dtype, prm["conv_w"].dtype)
    conv_out = torch.einsum("bkc,kc->bc", win.to(wdt), prm["conv_w"].to(wdt)) \
        + prm["conv_b"]
    xbc = F.silu(conv_out)
    xs = xbc[:, :din].reshape(b, h, s.head_dim).float()
    bs = xbc[:, din:din + gn].reshape(b, s.n_groups, s.d_state) \
        .repeat_interleave(rep, dim=1).float()
    cs = xbc[:, din + gn:].reshape(b, s.n_groups, s.d_state) \
        .repeat_interleave(rep, dim=1).float()
    dt = softplus((xc @ prm["w_dt"]).float() + prm["dt_bias"].float())    # (B,H)
    a = -torch.exp(prm["A_log"].float())
    hn = (cache["h"] * torch.exp(dt * a)[..., None, None]
          + (dt[..., None] * xs)[..., None] * bs[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", cs, hn)
    y = y + prm["D"].float()[None, :, None] * xs
    y = _gated_norm(y.reshape(b, din).to(x.dtype), z, prm["out_norm"])
    wdt = torch.promote_types(y.dtype, prm["w_out"].dtype)
    out = (y.to(wdt) @ prm["w_out"].to(wdt)).to(x.dtype)[:, None]
    conv.copy_(win[:, 1:])
    cache["h"].copy_(hn.to(cache["h"].dtype))
    return out, cache
