"""Model and shape configuration (the JAX package's `configs/base.py`:
`ModelConfig` field for field, `ShapeSpec`, `SHAPES` and
`shape_applicable`).

`param_count` and `reduced` give the JAX package's numbers for every
preset.  The shape specs name the JAX package's benchmark cells; only the
sub-quadratic families (RWKV6, hymba) take ``long_500k``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | audio | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mixer: str = "attention"          # attention | mla | rwkv6 | hymba
    norm: str = "rms"                 # rms | ln
    act: str = "swiglu"               # swiglu | gelu
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    sliding_window: int = 0           # 0 = full attention
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0              # precomputed frame embeddings length
    # VLM
    n_vision_tokens: int = 0
    mrope_sections: Tuple[int, ...] = ()
    # numerics
    dtype: str = "bfloat16"
    # capability flags
    sub_quadratic: bool = False       # eligible for long_500k
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    # -- parameter counts (for MODEL_FLOPS = 6 N D in §Roofline) -------------
    def param_count(self, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count of the backbone."""
        d, hd = self.d_model, self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = 0
        if self.mixer == "mla":
            r_kv, r_q, r_rope = self.kv_lora_rank, self.q_lora_rank, self.rope_head_dim
            attn += d * r_q + r_q * n_q * (hd + r_rope)       # q down+up
            attn += d * (r_kv + r_rope)                        # kv down + k_rope
            attn += r_kv * n_q * 2 * hd                        # k_up, v_up
            attn += n_q * hd * d                               # out
        elif self.mixer == "rwkv6":
            attn += 6 * d * d                                  # r,k,v,g,w,out
        else:
            attn += d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
            if self.mixer == "hymba":
                d_in = self.ssm_expand * d
                attn += d * 2 * d_in + d_in * d                # ssm in/out proj
                attn += d_in * (2 * self.ssm_state + 2)        # B,C,dt,A approx
        ffn_mult = 3 if self.act == "swiglu" else 2
        if self.n_experts > 0:
            experts = self.n_experts if not active_only else (
                self.top_k + self.n_shared_experts
            )
            total_experts = experts + (0 if active_only else self.n_shared_experts)
            ffn = total_experts * ffn_mult * d * self.d_ff + d * self.n_experts
        else:
            ffn = ffn_mult * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        total = self.n_layers * per_layer
        if self.is_encoder_decoder:
            enc_attn = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
            cross = enc_attn
            total += self.n_encoder_layers * (enc_attn + ffn + 2 * d)
            total += self.n_layers * cross
        total += self.vocab_size * d * 2  # embed + lm head
        return int(total)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            q_lora_rank=32 if self.q_lora_rank else 0,
            rope_head_dim=8 if self.mixer == "mla" else self.rope_head_dim,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            encoder_seq=24 if self.encoder_seq else 0,
            n_vision_tokens=8 if self.n_vision_tokens else 0,
            mrope_sections=(2, 3, 3) if self.mrope_sections else (),  # hd//2 = 8
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and the reason when it does not."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention at 524k decode — skipped per "
                       "assignment; see DESIGN.md §Arch-applicability")
    return True, ""
