"""whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356].

Backbone only per the assignment: the conv frontend is a stub —
input_specs() provides precomputed frame embeddings (batch, 1500, d_model).
Sinusoidal positions are used for both stacks (the real decoder uses learned
absolute positions; sinusoidal keeps parameter shapes independent of the
assigned sequence lengths — recorded in DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    n_encoder_layers=32,
    encoder_seq=1500,
    qkv_bias=True,
    act="gelu",
    norm="ln",
)
