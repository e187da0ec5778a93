"""hymba-1.5b — parallel attention + mamba heads, ssm_state=16 [arXiv:2411.13676].

Sliding-window attention (1024) runs in parallel with an SSM branch in every
layer; decode keeps a ring-buffer KV cache of the window size plus O(1) SSM
state, making the arch sub-quadratic (long_500k eligible).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    mixer="hymba",
    ssm_state=16,
    ssm_expand=2,
    sliding_window=1024,
    act="swiglu",
    norm="rms",
    sub_quadratic=True,
)
