"""Hand-written Hopper kernels of the port (``csrc/``), their wrappers and
plain PyTorch versions: episode_track (the single-launch count pipeline),
ops (its public wrapper plus the reference's tile math), flash_attention
and wkv_chunk (the language models' attention and RWKV6 recurrence)."""
from . import episode_track, flash_attention, ops, wkv_chunk

__all__ = ["episode_track", "flash_attention", "ops", "wkv_chunk"]
