"""PyTorch/CUDA port of the episode miner (the JAX package ``repro`` is the
reference it is held to).

Device policy: every entry point runs on the CUDA card unless the caller
asks for the CPU with ``device="cpu"``. A missing card is an error, never a
quiet switch to the CPU. Functions that take tensors run on the tensors'
device; on a CUDA tensor a kernel wrapper launches its kernel or raises.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``device`` as given (default the
    card). Raises when the card is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
