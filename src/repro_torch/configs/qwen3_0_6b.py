"""qwen3-0.6b [dense] — qk_norm, GQA, tied embeddings. head_dim=128 is
decoupled from d_model (16*128 != 1024), per the Qwen3 family.
[hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab=151936, qk_norm=True, tie_embeddings=True,
    block_pattern=("attn",),
    source="hf:Qwen/Qwen3-8B; hf",
)
