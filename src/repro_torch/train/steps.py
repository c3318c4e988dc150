"""Prefill and serve step builders (the port of the reference's
``train/steps.py``; ``make_train_step`` waits for the loss and the
optimizer)."""
from __future__ import annotations

from typing import Callable

from ..models import blocks
from ..models.model import Model


def make_prefill_step(model: Model) -> Callable:
    """Forward over the prompt; returns the last position's logits
    ``[b, vocab]`` (the next-token distribution). The output head runs on
    the final position only: full-sequence logits are never made."""

    def prefill_step(tokens):
        x, positions = model.embed_inputs(tokens)
        x = blocks.stack_apply(model.layers, x, positions)
        return model.logits(x[:, -1:])[:, 0]

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One batched decode step: ``(cache, tokens, pos) -> (next-token
    logits, cache)``. That is ``model.decode_step`` itself; the builder
    keeps the reference's name, where it wraps the step for ``jax.jit``."""
    return model.decode_step
