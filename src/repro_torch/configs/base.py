"""Architecture configuration schema (the port's copy of the reference's
``configs/base.py``: the same fields, defaults and properties)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_softmax_order: str = "softmax_topk"  # softmax then top-k renorm


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # block structure: cycled over layers. attn | local | rec | rwkv
    block_pattern: Tuple[str, ...] = ("attn",)
    mlp: str = "swiglu"               # swiglu | gelu (musicgen)
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    window: Optional[int] = None      # local attention window
    conv_width: int = 4               # temporal conv for rec blocks
    rnn_width: Optional[int] = None   # RG-LRU state width (default d_model)
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 32              # chunked-WKV block length
    decay_lora: int = 64              # rank of the data-dependent decay lora
    frontend: Optional[str] = None    # None | audio | vision
    n_patches: int = 0                # vision stub prefix length
    d_patch: int = 0                  # vision stub patch-embedding dim
    d_frame: int = 0                  # audio stub frame-embedding dim
    sub_quadratic: bool = False       # may run long_500k
    source: str = ""                  # public-literature citation

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def total_params(self) -> int:
        return n_params(self)


def n_params(cfg: ArchConfig) -> int:
    """Parameter count (the reference's ``_n_params``)."""
    d, ff = cfg.d_model, cfg.d_ff
    total = cfg.vocab * d  # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab * d
    for li in range(cfg.n_layers):
        kind = cfg.block_pattern[li % len(cfg.block_pattern)]
        if kind in ("attn", "local"):
            total += d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
        elif kind == "rec":
            r = cfg.rnn_dim
            total += 2 * d * r + r * d + 2 * r + cfg.conv_width * r
        elif kind == "rwkv":
            h = cfg.n_rwkv_heads
            total += 4 * d * d + 2 * cfg.decay_lora * d + h * cfg.rwkv_head_dim
        if kind == "rwkv":
            total += 2 * d * ff  # channel-mix (k, v) + receptance d*d
            total += d * d
        elif cfg.moe is not None:
            m = cfg.moe
            total += d * m.n_experts
            total += (m.n_experts + m.n_shared) * 3 * d * ff
        else:
            nf = 3 if cfg.mlp == "swiglu" else 2
            total += nf * d * ff
        total += 2 * d
    total += d  # final norm
    return total
