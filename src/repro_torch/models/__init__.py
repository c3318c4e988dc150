"""The language models of the port: the decoder-only ``Model`` over the
ported block kinds (``attn``, ``rwkv``), serving only (forward, prefill and
decode; the loss and training wait)."""
from .model import Model

__all__ = ["Model"]
