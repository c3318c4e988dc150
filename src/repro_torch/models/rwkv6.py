"""RWKV-6 "Finch" block: time-mix with data-dependent per-channel decay and
channel-mix (the port of the reference's ``models/rwkv6.py``).

The full-sequence time-mix sends r, k, v and the log decays (f32) through
the WKV kernel (``kernels/wkv_chunk.py``) with the reference's chunk:
``cfg.rwkv_chunk``, shrunk until it divides the sequence. Per-step log
decay is clamped to ``[-DECAY_CLAMP, 0)`` so the chunk normalizer
``e^(bex - btot)`` stays within f32 range (``(L - 1) * 1.5`` at most).
Decode is the exact single-step recurrence.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import wkv_chunk
from . import layers

DECAY_CLAMP = 1.5   # max |log w| per step


class RWKV(nn.Module):
    """The reference's RWKV6 parameters (time-mix and channel-mix)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0", "ln_x",
                     "mu_ck", "mu_cr"):
            setattr(self, name, layers.param(d, device=device))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o", "c_r"):
            setattr(self, name, layers.Dense(d, d, device=device))
        self.dec_a = layers.param(d, cfg.decay_lora, device=device)
        self.dec_b = layers.param(cfg.decay_lora, d, device=device)
        self.u = layers.param(cfg.n_rwkv_heads, cfg.rwkv_head_dim,
                              device=device)
        self.c_k = layers.Dense(d, ff, device=device)
        self.c_v = layers.Dense(ff, d, device=device)

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck",
                         "mu_cr"):
                getattr(self, name).fill_(0.5)
            self.w0.fill_(-1.0)
            self.ln_x.fill_(1.0)
        for lin in (self.w_r, self.w_k, self.w_v, self.w_g, self.w_o,
                    self.c_k, self.c_v, self.c_r):
            lin.init_(generator)
        layers.normal_(self.dec_a, generator, 0.02)
        layers.normal_(self.dec_b, generator, 0.02)
        layers.normal_(self.u, generator, 0.1)


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros, or ``last``, at t = 0). x ``[b, s, d]``."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _lerp(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _log_decay(p: RWKV, xw):
    """Per-channel log-decay in ``[-DECAY_CLAMP, 0)``. xw ``[b, s, d]`` f32."""
    lora = torch.tanh(xw @ p.dec_a) @ p.dec_b
    return -torch.clamp(torch.exp(p.w0 + lora), 1e-4, DECAY_CLAMP)


def _groupnorm(x, gain, h: int, eps: float = 64e-5):
    """Per-head group norm in f32, returned in bf16."""
    b, s, d = x.shape
    xg = x.reshape(b, s, h, d // h).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, unbiased=False, keepdim=True)
    xn = (xg - mu) * torch.rsqrt(var + eps)
    return (xn.reshape(b, s, d) * gain.float()).to(torch.bfloat16)


def time_mix(p: RWKV, cfg: ArchConfig, x):
    """WKV time-mix over a full sequence from a zero state, x ``[b, s, d]``;
    one WKV kernel launch. Returns the block's output (the reference also
    returns the final state, which its callers drop)."""
    b, s, d = x.shape
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    xx = _shift(x)
    r = p.w_r(_lerp(x, xx, p.mu_r))
    k = p.w_k(_lerp(x, xx, p.mu_k))
    v = p.w_v(_lerp(x, xx, p.mu_v))
    g = F.silu(p.w_g(_lerp(x, xx, p.mu_g)))
    logw = _log_decay(p, _lerp(x, xx, p.mu_w).float())

    def heads(t):
        return t.float().reshape(b, s, h, hd)

    # the wrapper shrinks the chunk until it divides s, as the reference
    o = wkv_chunk.wkv_chunked(heads(r), heads(k), heads(v), heads(logw),
                              p.u.float(), chunk=cfg.rwkv_chunk)
    o = _groupnorm(o.reshape(b, s, d), p.ln_x, h)
    return p.w_o(o * g.to(o.dtype))



def channel_mix(p: RWKV, cfg: ArchConfig, x, last=None):
    xx = _shift(x, last)
    k = torch.square(F.relu(p.c_k(_lerp(x, xx, p.mu_ck))))
    r = torch.sigmoid(p.c_r(_lerp(x, xx, p.mu_cr)))
    return r * p.c_v(k)


# ------------------------------ decode path ---------------------------------


def init_cache(cfg: ArchConfig, batch: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    h, hd, d = cfg.n_rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    return {
        "S": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                         device=device),
        # last inputs of the time-mix and the channel-mix
        "x_tm": torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
        "x_cm": torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
    }


def decode_time_mix(p: RWKV, cfg: ArchConfig, cache, x):
    """Exact single-step recurrence. x ``[b, 1, d]``."""
    b, _, d = x.shape
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    xx = cache["x_tm"][:, None].to(x.dtype)
    r = p.w_r(_lerp(x, xx, p.mu_r))[:, 0]
    k = p.w_k(_lerp(x, xx, p.mu_k))[:, 0]
    v = p.w_v(_lerp(x, xx, p.mu_v))[:, 0]
    g = F.silu(p.w_g(_lerp(x, xx, p.mu_g)))[:, 0]
    logw = _log_decay(p, _lerp(x, xx, p.mu_w).float())[:, 0]   # [b, d]

    rh = r.reshape(b, h, hd).float()
    kh = k.reshape(b, h, hd).float()
    vh = v.reshape(b, h, hd).float()
    wh = torch.exp(logw.reshape(b, h, hd))
    S = cache["S"]
    cur = S + (p.u.float()[None] * kh)[..., None] * vh[:, :, None, :]
    o = torch.einsum("bhi,bhiv->bhv", rh, cur).reshape(b, 1, h * hd)
    S_new = wh[..., None] * S + kh[..., None] * vh[:, :, None, :]
    o = _groupnorm(o, p.ln_x, h)
    out = p.w_o(o * g[:, None].to(o.dtype))
    return out, dict(cache, S=S_new, x_tm=x[:, 0].to(torch.bfloat16))


def decode_channel_mix(p: RWKV, cfg: ArchConfig, cache, x):
    out = channel_mix(p, cfg, x, last=cache["x_cm"].to(x.dtype))
    return out, dict(cache, x_cm=x[:, 0].to(torch.bfloat16))
