"""GQA attention with RoPE and optional qk-norm (the port of the
reference's ``models/attention.py``; global attention only, ``local``
windows wait).

The full-sequence (prefill) path sends sequences of at least
``FLASH_MIN_SEQ`` tokens through the flash-attention kernel and shorter
ones through the plain f32 path; the decode path attends over a
``[B, cache_len, kv, hd]`` bf16 cache in plain PyTorch, as the reference
does outside any kernel.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import flash, layers

NEG = -1e30  # large-negative instead of -inf: keeps softmax NaN-free
FLASH_MIN_SEQ = 2048  # below this the full-matrix path is cheaper


class Attention(nn.Module):
    """The reference's attention parameters: wq, wk, wv, wo (and q_norm,
    k_norm with qk-norm)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, bias = cfg.d_model, cfg.use_bias
        self.wq = layers.Dense(d, cfg.q_dim, bias=bias, device=device)
        self.wk = layers.Dense(d, cfg.kv_dim, bias=bias, device=device)
        self.wv = layers.Dense(d, cfg.kv_dim, bias=bias, device=device)
        self.wo = layers.Dense(cfg.q_dim, d, bias=bias, device=device)
        if cfg.qk_norm:
            self.q_norm = layers.param(cfg.head_dim, device=device)
            self.k_norm = layers.param(cfg.head_dim, device=device)
        else:
            self.q_norm = self.k_norm = None

    def init_(self, generator: torch.Generator) -> None:
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.init_(generator)
        for g in (self.q_norm, self.k_norm):
            if g is not None:
                nn.init.ones_(g)


def _qkv(p: Attention, cfg: ArchConfig, x, positions):
    b, s, _ = x.shape
    q = p.wq(x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = p.wk(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = p.wv(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = layers.rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = layers.rmsnorm(p.k_norm, k, cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q, k, v, mask, n_kv: int):
    """q ``[b, sq, hq, hd]``; k, v ``[b, sk, kv, hd]``; mask
    ``[b, 1, sq, sk]`` bool. f32 scores and probabilities."""
    b, sq, hq, hd = q.shape
    group = hq // n_kv
    qg = q.reshape(b, sq, n_kv, group, hd)
    logits = torch.einsum("bsngh,btnh->bngst", qg.float(),
                          k.float()) * hd ** -0.5
    logits = logits.masked_fill(~mask[:, :, None], NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", probs, v.float())
    return out.reshape(b, sq, hq * hd).to(q.dtype)


def forward(p: Attention, cfg: ArchConfig, x, positions, *,
            window: Optional[int] = None):
    """Full-sequence (prefill) attention. Sequences of at least
    ``FLASH_MIN_SEQ`` tokens go through the flash kernel, which reads the
    grouped kv heads in place (the reference repeats them to flat heads
    first); shorter ones through the plain causal path."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if s >= FLASH_MIN_SEQ:
        out = flash.flash_attend(q, k, v, window=window)
        out = out.reshape(b, s, cfg.q_dim).to(x.dtype)
    else:
        pos_q = positions[:, :, None]
        pos_k = positions[:, None, :]
        mask = pos_k <= pos_q
        if window is not None:
            mask = mask & (pos_k > pos_q - window)
        out = _attend(q, k, v, mask[:, None], cfg.n_kv_heads)
    return p.wo(out)


# ------------------------------ decode path ---------------------------------


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        # absolute position stored in each slot (-1 = empty)
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def decode_step(p: Attention, cfg: ArchConfig, cache, x, pos):
    """One-token decode. x ``[b, 1, d]``; pos ``[b]`` absolute positions,
    written to slot ``pos % cache_len``. The cache is updated in place (the
    reference returns a new one) and returned."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    slot = (pos % cache["k"].shape[1]).long()
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = pos.to(torch.int32)
    cpos = cache["pos"]
    mask = (cpos[:, None, :] >= 0) & (cpos[:, None, :] <= pos[:, None, None])
    out = _attend(q, cache["k"], cache["v"], mask[:, None], cfg.n_kv_heads)
    return p.wo(out), cache
