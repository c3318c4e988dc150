"""Hand-written Hopper kernels of the port (``csrc/``), their wrappers and
plain PyTorch versions: episode_track (the single-launch count pipeline)
and ops (its public wrapper plus the reference's tile math)."""
from . import episode_track, ops

__all__ = ["episode_track", "ops"]
