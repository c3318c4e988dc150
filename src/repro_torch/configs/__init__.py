"""Architecture registry of the port: the archs whose block kinds are
ported (``attn`` and ``rwkv``). The reference's other archs raise
``KeyError`` until their blocks are ported."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from . import qwen3_0_6b, rwkv6_3b
from .base import ArchConfig, MoECfg, n_params

REGISTRY: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen3_0_6b, rwkv6_3b)}


def list_archs() -> List[str]:
    return sorted(REGISTRY)


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key not in REGISTRY:
        raise KeyError(f"arch {name!r} is not ported yet (or unknown); "
                       f"ported: {list_archs()}")
    return REGISTRY[key]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Same-family small config for CPU smoke tests: few layers, small
    width/experts/vocab, one forward/train step must run on one CPU."""
    kv = 2 if cfg.n_kv_heads < cfg.n_heads else 4
    moe = None
    if cfg.moe is not None:
        moe = MoECfg(
            n_experts=min(8, cfg.moe.n_experts),
            top_k=min(2, cfg.moe.top_k),
            n_shared=min(1, cfg.moe.n_shared),
            capacity_factor=2.0,
        )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=2 * len(cfg.block_pattern),
        d_model=128,
        n_heads=4,
        n_kv_heads=kv,
        head_dim=32,
        d_ff=256,
        vocab=512,
        moe=moe,
        window=(32 if cfg.window else None),
        rnn_width=(128 if cfg.rnn_width else None),
        rwkv_head_dim=32,
        decay_lora=8,
        n_patches=(4 if cfg.n_patches else 0),
        d_patch=(16 if cfg.d_patch else 0),
    )


__all__ = ["ArchConfig", "MoECfg", "REGISTRY", "get_config", "list_archs",
           "n_params", "reduced"]
