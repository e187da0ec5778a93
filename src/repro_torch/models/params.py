"""Parameter metadata of the dense LM: one source of truth for the shapes,
logical axes and initialisation of every tensor (the JAX package's
`models/params.py`, restricted to the dense attention, FFN and norm
metas).

`abstract_params(cfg)` builds a nested dict of `ParamMeta`; `init_params`
materialises it.  Every per-layer tensor is stacked with a leading
``layers`` axis of length L, under the same keys as the JAX package, so a
parameter tree of either package carries across key by key
(`repro_torch.convert.lm_params_from_numpy`).  The logical axes are the
JAX package's sharding metadata, kept so the trees stay alike; the port
runs on one device and does not read them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..tree import leaves, tree_map

#: Where the model families the port does not run yet stand in ROADMAP.md.
NOT_PORTED_ITEM = "ROADMAP.md, queue 1 item 11"


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a configuration the port's forward
    and decode do not run (they run the dense family and the VLM
    backbone), naming its ROADMAP item."""
    what = None
    if cfg.mixer != "attention":
        what = f"the {cfg.mixer} mixer"
    elif cfg.n_experts > 0:
        what = "the MoE FFN"
    elif cfg.is_encoder_decoder:
        what = "the encoder-decoder (whisper) stack"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported to PyTorch yet "
            f"({NOT_PORTED_ITEM}: MoE, MLA, RWKV, hymba and whisper)")


def _attn_metas(cfg: ModelConfig, L: int) -> Dict[str, ParamMeta]:
    d, hd = cfg.d_model, cfg.hd
    fused = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    m = {
        "wqkv": ParamMeta((L, d, fused), ("layers", "embed", "heads")),
        "wo": ParamMeta((L, cfg.n_heads * hd, d),
                        ("layers", "heads", "embed")),
    }
    if cfg.qkv_bias:
        m["bqkv"] = ParamMeta((L, fused), ("layers", "heads"), "zeros")
    return m


def _ffn_metas(cfg: ModelConfig, L: int) -> Dict[str, ParamMeta]:
    d, F = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gu": ParamMeta((L, d, 2 * F), ("layers", "embed", "ffn")),
            "w_down": ParamMeta((L, F, d), ("layers", "ffn", "embed")),
        }
    return {
        "w_in": ParamMeta((L, d, F), ("layers", "embed", "ffn")),
        "b_in": ParamMeta((L, F), ("layers", "ffn"), "zeros"),
        "w_out": ParamMeta((L, F, d), ("layers", "ffn", "embed")),
        "b_out": ParamMeta((L, d), ("layers", "embed"), "zeros"),
    }


def _norm_metas(cfg: ModelConfig, L: int, names) -> Dict[str, ParamMeta]:
    m = {}
    for nm in names:
        m[nm] = ParamMeta((L, cfg.d_model), ("layers", "embed"), "ones")
        if cfg.norm == "ln":
            m[nm + "_bias"] = ParamMeta((L, cfg.d_model), ("layers", "embed"),
                                        "zeros")
    return m


def abstract_params(cfg: ModelConfig) -> Dict:
    """The nested ParamMeta tree of a dense decoder-only LM."""
    check_supported(cfg)
    L, d = cfg.n_layers, cfg.d_model
    layers: Dict[str, ParamMeta] = {}
    layers.update(_attn_metas(cfg, L))
    layers.update(_ffn_metas(cfg, L))
    layers.update(_norm_metas(cfg, L, ["norm1", "norm2"]))
    tree: Dict = {
        "embed": ParamMeta((cfg.vocab_size, d), ("vocab", "embed")),
        "lm_head": ParamMeta((cfg.vocab_size, d), ("vocab", "embed")),
        "final_norm": ParamMeta((d,), ("embed",), "ones"),
        "layers": layers,
    }
    if cfg.norm == "ln":
        tree["final_norm_bias"] = ParamMeta((d,), ("embed",), "zeros")
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype: Optional[torch.dtype] = None) -> Dict:
    """Materialise the parameter tree on `device` (None: the card).

    The JAX package's rule: zeros, ones, or a normal draw of std 0.02 in
    f32 cast to `dtype` (default ``cfg.torch_dtype``).  The leaves are
    drawn in sorted key order from `generator`, which must live on the
    target device; the values differ from the JAX package's, whose PRNG
    the port cannot reproduce (tests carry its tree across with
    `convert.lm_params_from_numpy`).
    """
    from ..dist.backends import resolve_device

    dev = resolve_device(device)
    dtype = dtype or cfg.torch_dtype

    def draw(meta: ParamMeta) -> torch.Tensor:
        if meta.init == "zeros":
            return torch.zeros(meta.shape, dtype=dtype, device=dev)
        if meta.init == "ones":
            return torch.ones(meta.shape, dtype=dtype, device=dev)
        leaf = torch.randn(meta.shape, generator=generator,
                           dtype=torch.float32, device=dev)
        return leaf.mul_(meta.scale).to(dtype)

    return tree_map(draw, abstract_params(cfg))


def count_params(cfg: ModelConfig) -> int:
    """Number of parameters in the tree (biases and norms included)."""
    return sum(math.prod(m.shape) for m in leaves(abstract_params(cfg)))
