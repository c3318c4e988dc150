"""Full-sequence attention for long prompts (the port of the reference's
``models/flash.py``, forward only).

:func:`flash_attend` routes to the flash-attention kernel
(``kernels/flash_attention.py``, the port of the Pallas kernel the
reference's docstring names as the one used on real hardware). Its
arithmetic is the Pallas kernel's: f32 dots and an f32 P V product, where
the reference's XLA twin feeds P V in bf16, so the two agree to bf16
rounding, not bit for bit. :func:`attend_reference` is the plain oracle.
The backward pass waits for a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import flash_attention as fa

NEG = fa.NEG


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """Causal attention of q ``[b, s, h, hd]`` over k, v ``[b, s, hk, hd]``
    (grouped kv heads are read in place, not repeated), causal by index:
    the full-sequence path's positions are ``0 .. s-1``."""
    if window is not None:
        raise NotImplementedError(
            "a window (local attention) is not ported yet: the flash kernel "
            "has none")
    return fa.flash_attention(q, k, v, causal=True)


def attend_reference(q, k, v, pos_q, pos_k):
    """Plain full-matrix causal attention (oracle), without the reference's
    window: :func:`flash_attend` takes none. Flat heads: q, k, v
    ``[b, s, h, hd]``; positions ``[b, s]``."""
    hd = q.shape[-1]
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * hd ** -0.5
    mask = pos_k[:, None, None, :] <= pos_q[:, None, :, None]
    p = torch.softmax(logits.masked_fill(~mask, NEG), dim=-1)
    p = p.masked_fill(~mask, 0.0)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)
