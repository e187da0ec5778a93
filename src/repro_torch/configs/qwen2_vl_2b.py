"""qwen2-vl-2b — VLM backbone, M-RoPE [arXiv:2409.12191].

Backbone only per the assignment: the vision patch frontend is a stub —
input_specs() provides precomputed patch embeddings prepended to the token
stream. M-RoPE uses sections (16, 24, 24) over (temporal, h, w) position
streams; in the text-only stub all three streams coincide.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    n_vision_tokens=64,
    mrope_sections=(16, 24, 24),
    act="swiglu",
    norm="rms",
)
