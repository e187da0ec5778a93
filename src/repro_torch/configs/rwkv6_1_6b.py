"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # wkv heads of dim 64
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65_536,
    mixer="rwkv6",
    act="rwkv",          # relu^2 channel mix with receptance gate
    norm="ln",
    sub_quadratic=True,
)
