"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay time-mix +
channel-mix; head_size 64 => 40 heads. Sub-quadratic: runs long_500k.
[arXiv:2404.05892; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab=65536,
    block_pattern=("rwkv",), rwkv_head_dim=64, decay_lora=64,
    sub_quadratic=True,
    source="arXiv:2404.05892; hf",
)
