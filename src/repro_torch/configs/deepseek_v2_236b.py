"""deepseek-v2-236b — MoE 160e top-6, MLA kv_lora=512 [arXiv:2405.04434].

Per-expert d_ff = 1536; 2 shared + 160 routed experts, top-6. MLA with
kv_lora_rank 512, q_lora_rank 1536, decoupled RoPE head dim 64,
per-head dim 128. All layers MoE (the real model's dense first layer is a
constant-factor simplification recorded in DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102_400,
    mixer="mla",
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    act="swiglu",
    norm="rms",
)
