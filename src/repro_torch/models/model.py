"""The decoder-only model over the ported block kinds (the port of the
reference's ``models/model.py``; serving only, ``loss`` waits).

    m = Model(cfg, device="cuda").init(torch.Generator("cuda").manual_seed(0))
    logits = m.forward(tokens)                       # [b, s, vocab] bf16
    cache = m.init_cache(batch, cache_len)
    logits, cache = m.decode_step(cache, tokens, pos)

Parameters carry the reference's names (``embed.table``,
``layers.<i>.<block params>``, ``final_norm.g``, ``lm_head.w``);
``interop.lm_params`` maps the reference's stacked pytree onto them.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from . import blocks, layers


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        if cfg.frontend is not None:
            raise NotImplementedError(
                f"the {cfg.frontend} frontend is not ported yet")
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = layers.Embed(cfg.vocab, cfg.d_model, dev)
        self.layers = nn.ModuleList(
            blocks.Block(cfg, kind, dev) for kind in blocks.layer_kinds(cfg))
        self.final_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        self.lm_head = (None if cfg.tie_embeddings else
                        layers.Dense(cfg.d_model, cfg.vocab, device=dev))

    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter from the reference's init distributions,
        drawn from ``generator`` (on the model's device). Returns self."""
        for child in (self.embed, *self.layers, self.final_norm,
                      self.lm_head):
            if child is not None:
                child.init_(generator)
        return self

    def embed_inputs(self, tokens: torch.Tensor):
        x = self.embed(tokens)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        return x, positions

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the (tied or separate) output head, bf16."""
        x = self.final_norm(x)
        if self.lm_head is None:
            return self.embed.unembed(x)
        return self.lm_head(x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits ``[b, s, vocab]`` (bf16) of a ``[b, s]`` token batch."""
        x, positions = self.embed_inputs(tokens)
        return self.logits(blocks.stack_apply(self.layers, x, positions))

    # ------------------------------ decode ---------------------------------

    def init_cache(self, batch: int, cache_len: int) -> list:
        return [block.init_cache(batch, cache_len) for block in self.layers]

    def decode_step(self, cache: list, tokens: torch.Tensor,
                    pos: torch.Tensor):
        """tokens ``[b]`` (next token ids); pos ``[b]`` absolute positions.
        Returns ``(logits [b, vocab], cache)``; the cache is updated in
        place."""
        x = self.embed(tokens[:, None])
        x, cache = blocks.stack_decode(self.layers, cache, x, pos)
        return self.logits(x)[:, 0], cache
