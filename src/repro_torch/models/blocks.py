"""Decoder blocks and the layer stack (the port of the reference's
``models/blocks.py``, kinds ``attn`` and ``rwkv``).

The reference stacks identical layers along a leading axis and walks them
with ``lax.scan``; here the layers are an ``nn.ModuleList`` walked in a
Python loop, layer ``i`` of kind ``cfg.block_pattern[i % len(pattern)]``.
Block kinds:
  attn   pre-norm GQA attention + pre-norm swiglu FFN
  rwkv   RWKV6 time-mix + channel-mix, each pre-norm
``local`` and ``rec`` blocks and MoE FFNs are not ported yet and raise.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import attention, layers, rwkv6

KINDS = ("attn", "rwkv")


def layer_kinds(cfg: ArchConfig) -> List[str]:
    pattern = cfg.block_pattern
    return [pattern[i % len(pattern)] for i in range(cfg.n_layers)]


class Block(nn.Module):
    """One decoder layer with the reference's parameter names: ``norm1``,
    ``mix``, ``norm2``, ``ffn`` for ``attn``; ``norm1``, ``norm2``, ``rwkv``
    for ``rwkv``."""

    def __init__(self, cfg: ArchConfig, kind: str, device=None):
        super().__init__()
        if kind not in KINDS:
            raise NotImplementedError(f"block kind {kind!r} is not ported yet")
        if cfg.moe is not None:
            raise NotImplementedError("MoE FFNs are not ported yet")
        self.cfg, self.kind = cfg, kind
        self.norm1 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.norm2 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if kind == "rwkv":
            self.rwkv = rwkv6.RWKV(cfg, device)
        else:
            self.mix = attention.Attention(cfg, device)
            self.ffn = layers.MLP(cfg.d_model, cfg.d_ff, cfg.mlp,
                                  bias=cfg.use_bias, device=device)

    def init_(self, generator: torch.Generator) -> None:
        for child in self.children():
            child.init_(generator)

    def forward(self, x, positions):
        """Full-sequence path."""
        cfg = self.cfg
        h = self.norm1(x)
        if self.kind == "rwkv":
            x = x + rwkv6.time_mix(self.rwkv, cfg, h)
            return x + rwkv6.channel_mix(self.rwkv, cfg, self.norm2(x))
        x = x + attention.forward(self.mix, cfg, h, positions)
        return x + self.ffn(self.norm2(x))

    def init_cache(self, batch: int, cache_len: int) -> Dict[str, torch.Tensor]:
        device = self.norm1.g.device
        if self.kind == "rwkv":
            return rwkv6.init_cache(self.cfg, batch, device=device)
        return attention.init_cache(self.cfg, batch, cache_len, device=device)

    def decode(self, cache, x, pos):
        """One-token decode. Returns ``(x, cache)``."""
        cfg = self.cfg
        h = self.norm1(x)
        if self.kind == "rwkv":
            o, cache = rwkv6.decode_time_mix(self.rwkv, cfg, cache, h)
            x = x + o
            o2, cache = rwkv6.decode_channel_mix(self.rwkv, cfg, cache,
                                                 self.norm2(x))
            return x + o2, cache
        o, cache = attention.decode_step(self.mix, cfg, cache, h, pos)
        x = x + o
        return x + self.ffn(self.norm2(x)), cache


def stack_apply(blocks: nn.ModuleList, x, positions):
    """Apply every layer (full-sequence path)."""
    for block in blocks:
        x = block(x, positions)
    return x


def stack_decode(blocks: nn.ModuleList, caches: list, x, pos):
    """One-token decode through every layer; ``caches`` (one dict a layer)
    is updated in place and returned."""
    for i, block in enumerate(blocks):
        x, caches[i] = block.decode(caches[i], x, pos)
    return x, caches


def reset_cache_rows(caches: list, row: int) -> None:
    """Empty one batch row of every layer's cache, in place: attention
    slots back to position -1, recurrent state and token shifts to 0. A
    serving slot does this when it takes a new request."""
    for cache in caches:
        for name, t in cache.items():
            t[row] = -1 if name == "pos" else 0
