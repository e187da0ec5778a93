"""qwen1.5-32b — dense, QKV bias [hf:Qwen/Qwen1.5-*]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152_064,
    qkv_bias=True,
    act="swiglu",
    norm="rms",
)
