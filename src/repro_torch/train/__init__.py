"""Step builders of the language models (prefill and serve; training waits)."""
from .steps import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
