"""Shared layers of the language models (the port of the reference's
``models/layers.py``).

Conventions, as the reference's: activations bf16, parameters f32 cast at
use, reductions f32. Each weight is an ``nn.Parameter`` under the
reference's name (``Dense.w``, ``RMSNorm.g``, ``Embed.table``), filled by
``init_(generator)`` from the reference's distributions (not its numbers:
a ``torch.Generator`` is not a JAX key) or loaded from the reference's
arrays with ``interop.lm_params``. This slice serves and does not train, so
parameters do not require gradients. ``Dense`` casts its f32 weight to
bf16 at every call and keeps no bf16 copy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def param(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                        requires_grad=False)


def normal_(p: nn.Parameter, generator: torch.Generator, scale: float) -> None:
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device)
                * scale)


class Dense(nn.Module):
    """``y = x @ w (+ b)`` in bf16 from the f32 parameters (``dense``)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 device=None):
        super().__init__()
        self.w = param(d_in, d_out, device=device)
        self.b = param(d_out, device=device) if bias else None

    def init_(self, generator: torch.Generator) -> None:
        normal_(self.w, generator, self.w.shape[0] ** -0.5)
        if self.b is not None:
            nn.init.zeros_(self.b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(torch.bfloat16) @ self.w.to(torch.bfloat16)
        if self.b is not None:
            y = y + self.b.to(torch.bfloat16)
        return y


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    """RMS norm over the last axis in f32, returned in x's dtype (also the
    reference's ``head_rmsnorm``, the qk-norm over the head_dim of
    ``[*, heads, head_dim]``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g.float()).to(x.dtype)



class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.g = param(d, device=device)

    def init_(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.g, x, self.eps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x ``[..., seq, heads, head_dim]``; positions ``[..., seq]``; f32
    angles, the rotated halves concatenated, returned in x's dtype."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """The swiglu feed-forward: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, d: int, ff: int, kind: str = "swiglu", *,
                 bias: bool = False, device=None):
        super().__init__()
        if kind != "swiglu":
            raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
        self.gate = Dense(d, ff, bias=bias, device=device)
        self.up = Dense(d, ff, bias=bias, device=device)
        self.down = Dense(ff, d, bias=bias, device=device)

    def init_(self, generator: torch.Generator) -> None:
        for lin in (self.gate, self.up, self.down):
            lin.init_(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Embed(nn.Module):
    """Token embedding ``table [vocab, d]``; also the tied unembedding."""

    def __init__(self, vocab: int, d: int, device=None):
        super().__init__()
        self.table = param(vocab, d, device=device)

    def init_(self, generator: torch.Generator) -> None:
        normal_(self.table, generator, 0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        # gather then cast: the same numbers as the reference's cast then
        # gather, without a bf16 copy of the whole table
        return self.table[tokens].to(torch.bfloat16)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16) @ self.table.to(torch.bfloat16).T
