"""starcoder2-3b — dense, GQA kv=2, RoPE [arXiv:2402.19173]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49_152,
    qkv_bias=True,
    act="gelu",
    norm="ln",
)
