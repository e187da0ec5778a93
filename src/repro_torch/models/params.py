"""Parameter metadata of the LM: one source of truth for the shapes,
logical axes and initialisation of every tensor of every family (the JAX
package's `models/params.py`): attention (fused QKV, and the separate
cross-attention projections of the encoder-decoder), MLA, RWKV6, the
mamba branch of hymba, the dense and MoE FFNs, the norms and whisper's
`encoder` subtree.

`abstract_params(cfg)` builds a nested dict of `ParamMeta`; `init_params`
materialises it.  Every per-layer tensor is stacked with a leading
``layers`` axis of length L, under the same keys as the JAX package, so a
parameter tree of either package carries across key by key
(`repro_torch.convert.lm_params_from_numpy`).  The logical axes lay the
tree out on a mesh: `param_pspecs` gives each leaf's PartitionSpec under
a `dist.sharding.ShardingRules`, `param_shardings` its (mesh, spec,
placements), and `distribute_params` makes a tree of full tensors DTensors
laid out so (the counterpart of ``device_put(params, param_shardings)``).
`param_shapes` holds meta tensors of the leaves' shapes and dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..dist import sharding
from ..dist.sharding import ShardingRules
from ..tree import leaves, map_with_path, tree_map

#: A normal leaf of more elements than this (8 GiB of f32) is drawn one
#: slice of its leading axis at a time: drawn whole, its f32 temporary
#: would not fit on the card beside the tree (qwen3-moe-30b-a3b's expert
#: leaves hold 9.66e9 elements).  Every smaller leaf is drawn whole.
WHOLE_DRAW_ELEMENTS = 2**31


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


def _attn_metas(cfg: ModelConfig, L: int,
                cross: bool = False) -> Dict[str, ParamMeta]:
    """Self-attention: one fused QKV projection.  Cross-attention (the
    ``_x`` keys): separate q, k and v projections (k and v read another
    stream)."""
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    if cross:
        m = {
            "wq_x": ParamMeta((L, d, nq * hd), ("layers", "embed", "heads")),
            "wk_x": ParamMeta((L, d, nkv * hd),
                              ("layers", "embed", "kv_heads")),
            "wv_x": ParamMeta((L, d, nkv * hd),
                              ("layers", "embed", "kv_heads")),
            "wo_x": ParamMeta((L, nq * hd, d), ("layers", "heads", "embed")),
        }
        if cfg.qkv_bias:
            m["bq_x"] = ParamMeta((L, nq * hd), ("layers", "heads"), "zeros")
            m["bk_x"] = ParamMeta((L, nkv * hd), ("layers", "kv_heads"),
                                  "zeros")
            m["bv_x"] = ParamMeta((L, nkv * hd), ("layers", "kv_heads"),
                                  "zeros")
        return m
    fused = (nq + 2 * nkv) * hd
    m = {
        "wqkv": ParamMeta((L, d, fused), ("layers", "embed", "heads")),
        "wo": ParamMeta((L, nq * hd, d), ("layers", "heads", "embed")),
    }
    if cfg.qkv_bias:
        m["bqkv"] = ParamMeta((L, fused), ("layers", "heads"), "zeros")
    return m


def _mla_metas(cfg: ModelConfig, L: int) -> Dict[str, ParamMeta]:
    d, hd, nq = cfg.d_model, cfg.hd, cfg.n_heads
    r_kv, r_q, r_rope = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.rope_head_dim
    return {
        "wdq": ParamMeta((L, d, r_q), ("layers", "embed", "kv_lora")),
        "q_norm": ParamMeta((L, r_q), ("layers", "kv_lora"), "ones"),
        "wuq": ParamMeta((L, r_q, nq * hd), ("layers", "kv_lora", "heads")),
        "wq_rope": ParamMeta((L, r_q, nq * r_rope),
                             ("layers", "kv_lora", "heads")),
        "wdkv": ParamMeta((L, d, r_kv), ("layers", "embed", "kv_lora")),
        "kv_norm": ParamMeta((L, r_kv), ("layers", "kv_lora"), "ones"),
        "wk_rope": ParamMeta((L, d, r_rope), ("layers", "embed", "head_dim")),
        "wuk": ParamMeta((L, r_kv, nq * hd), ("layers", "kv_lora", "heads")),
        "wuv": ParamMeta((L, r_kv, nq * hd), ("layers", "kv_lora", "heads")),
        "wo": ParamMeta((L, nq * hd, d), ("layers", "heads", "embed")),
    }


def _rwkv_metas(cfg: ModelConfig, L: int) -> Dict[str, ParamMeta]:
    d, F, H, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.hd
    lora = 64
    sq = ("layers", "embed", "heads")
    vec = ("layers", "embed")
    return {
        # time mix
        "w_r": ParamMeta((L, d, d), sq),
        "w_k": ParamMeta((L, d, d), sq),
        "w_v": ParamMeta((L, d, d), sq),
        "w_g": ParamMeta((L, d, d), sq),
        "w_o": ParamMeta((L, d, d), ("layers", "heads", "embed")),
        "mu_r": ParamMeta((L, d), vec, "zeros"),
        "mu_k": ParamMeta((L, d), vec, "zeros"),
        "mu_v": ParamMeta((L, d), vec, "zeros"),
        "mu_g": ParamMeta((L, d), vec, "zeros"),
        "mu_w": ParamMeta((L, d), vec, "zeros"),
        "decay_base": ParamMeta((L, d), vec, "zeros"),
        "w_dd1": ParamMeta((L, d, lora), ("layers", "embed", None)),
        "w_dd2": ParamMeta((L, lora, d), ("layers", None, "embed")),
        "bonus": ParamMeta((L, H, hd), ("layers", "heads", None), "zeros"),
        "ln_x": ParamMeta((L, H, hd), ("layers", "heads", None), "ones"),
        # channel mix
        "w_ck": ParamMeta((L, d, F), ("layers", "embed", "ffn")),
        "w_cv": ParamMeta((L, F, d), ("layers", "ffn", "embed")),
        "w_cr": ParamMeta((L, d, d), ("layers", "embed", None)),
        "mu_ck": ParamMeta((L, d), vec, "zeros"),
        "mu_cr": ParamMeta((L, d), vec, "zeros"),
    }


def _mamba_metas(cfg: ModelConfig, L: int) -> Dict[str, ParamMeta]:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    st = cfg.ssm_state
    dt_rank = max(1, d // 16)
    return {
        "w_in": ParamMeta((L, d, 2 * d_in), ("layers", "embed", "ffn")),
        "conv_w": ParamMeta((L, cfg.conv_width, d_in),
                            ("layers", None, "ffn")),
        "conv_b": ParamMeta((L, d_in), ("layers", "ffn"), "zeros"),
        "w_bcdt": ParamMeta((L, d_in, 2 * st + dt_rank),
                            ("layers", "ffn", None)),
        "w_dt": ParamMeta((L, dt_rank, d_in), ("layers", None, "ffn")),
        "dt_bias": ParamMeta((L, d_in), ("layers", "ffn"), "zeros"),
        "A_log": ParamMeta((L, d_in, st), ("layers", "ffn", "state"), "ones"),
        "D_skip": ParamMeta((L, d_in), ("layers", "ffn"), "ones"),
        "w_ssm_out": ParamMeta((L, d_in, d), ("layers", "ffn", "embed")),
    }


def _ffn_metas(cfg: ModelConfig, L: int) -> Dict[str, ParamMeta]:
    d, F = cfg.d_model, cfg.d_ff
    if cfg.n_experts > 0:
        E = cfg.n_experts
        m = {
            "router": ParamMeta((L, d, E), ("layers", "embed", "expert")),
            "we_gate": ParamMeta((L, E, d, F),
                                 ("layers", "expert", "embed", "ffn")),
            "we_up": ParamMeta((L, E, d, F),
                               ("layers", "expert", "embed", "ffn")),
            "we_down": ParamMeta((L, E, F, d),
                                 ("layers", "expert", "ffn", "embed")),
        }
        if cfg.n_shared_experts > 0:
            Fs = F * cfg.n_shared_experts
            m.update({
                "ws_gate": ParamMeta((L, d, Fs), ("layers", "embed", "ffn")),
                "ws_up": ParamMeta((L, d, Fs), ("layers", "embed", "ffn")),
                "ws_down": ParamMeta((L, Fs, d), ("layers", "ffn", "embed")),
            })
        return m
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


def _final_norm(cfg: ModelConfig, tree: Dict) -> Dict:
    d = cfg.d_model
    tree["final_norm"] = ParamMeta((d,), ("embed",), "ones")
    if cfg.norm == "ln":
        tree["final_norm_bias"] = ParamMeta((d,), ("embed",), "zeros")
    return tree


def abstract_params(cfg: ModelConfig) -> Dict:
    """The nested ParamMeta tree of `cfg`'s family."""
    L, d = cfg.n_layers, cfg.d_model
    layers: Dict[str, ParamMeta] = {}
    if cfg.mixer == "mla":
        layers.update(_mla_metas(cfg, L))
    elif cfg.mixer == "rwkv6":
        layers.update(_rwkv_metas(cfg, L))
    else:
        layers.update(_attn_metas(cfg, L))
        if cfg.mixer == "hymba":
            layers.update(_mamba_metas(cfg, L))
    if cfg.mixer != "rwkv6":  # RWKV's channel mix is its FFN
        layers.update(_ffn_metas(cfg, L))
    norm_names = ["norm1", "norm2"]
    if cfg.is_encoder_decoder:
        layers.update(_attn_metas(cfg, L, cross=True))
        norm_names.append("norm3")
    layers.update(_norm_metas(cfg, L, norm_names))
    tree: Dict = _final_norm(cfg, {
        "embed": ParamMeta((cfg.vocab_size, d), ("vocab", "embed")),
        "lm_head": ParamMeta((cfg.vocab_size, d), ("vocab", "embed")),
        "layers": layers,
    })
    if cfg.is_encoder_decoder:
        E = cfg.n_encoder_layers
        enc: Dict[str, ParamMeta] = {}
        enc.update(_attn_metas(cfg, E))
        enc.update(_ffn_metas(cfg, E))
        enc.update(_norm_metas(cfg, E, ["norm1", "norm2"]))
        tree["encoder"] = _final_norm(cfg, {"layers": enc})
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype: Optional[torch.dtype] = None) -> Dict:
    """Materialise the parameter tree on `device` (None: the card).

    The JAX package's rule: zeros, ones, or a normal draw of std 0.02 in
    f32 cast to `dtype` (default ``cfg.torch_dtype``).  The leaves are
    drawn in sorted key order from `generator`, which must live on the
    target device; a leaf of more than `WHOLE_DRAW_ELEMENTS` elements is
    drawn one slice of its leading axis after another into the leaf, so
    that its f32 temporary is one slice.  The values differ from the JAX
    package's, whose PRNG the port cannot reproduce (tests carry its tree
    across with `convert.lm_params_from_numpy`).
    """
    from ..dist.backends import resolve_device

    dev = resolve_device(device)
    dtype = dtype or cfg.torch_dtype

    def normal(shape, scale: float) -> torch.Tensor:
        leaf = torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev)
        return leaf.mul_(scale).to(dtype)

    def draw(meta: ParamMeta) -> torch.Tensor:
        if meta.init == "zeros":
            return torch.zeros(meta.shape, dtype=dtype, device=dev)
        if meta.init == "ones":
            return torch.ones(meta.shape, dtype=dtype, device=dev)
        if math.prod(meta.shape) <= WHOLE_DRAW_ELEMENTS:
            return normal(meta.shape, meta.scale)
        leaf = torch.empty(meta.shape, dtype=dtype, device=dev)
        for part in leaf:
            part.copy_(normal(part.shape, meta.scale))
        return leaf

    return tree_map(draw, abstract_params(cfg))


def param_shapes(cfg: ModelConfig, dtype: Optional[torch.dtype] = None
                 ) -> Dict:
    """Meta tensors of every leaf's shape, in `dtype` (default
    ``cfg.torch_dtype``): the counterpart of the JAX ShapeDtypeStruct
    tree.  No memory is allocated."""
    dtype = dtype or cfg.torch_dtype
    return tree_map(lambda m: torch.empty(m.shape, dtype=dtype,
                                          device="meta"),
                    abstract_params(cfg))


def param_pspecs(cfg: ModelConfig, rules: ShardingRules) -> Dict:
    """The PartitionSpec of every leaf under `rules`."""
    return tree_map(lambda m: rules.spec(*m.axes), abstract_params(cfg))


def param_shardings(cfg: ModelConfig, rules: ShardingRules) -> Dict:
    """(mesh, spec, placements) of every leaf under `rules`: the
    counterpart of the JAX NamedSharding tree."""
    def one(m: ParamMeta):
        spec = rules.spec(*m.axes)
        return rules.mesh, spec, sharding.placements(spec, rules.mesh)

    return tree_map(one, abstract_params(cfg))


def distribute_params(tree: Dict, specs: Dict, mesh) -> Dict:
    """`tree` (full tensors, alike on every rank) as DTensors on `mesh`
    laid out leaf by leaf by `specs` (e.g. `param_pspecs`); each rank
    keeps its own shards.  Works for any tree whose leaves `specs`
    matches, the AdamW moments too."""
    flat = dict(spec_leaves(specs))
    return map_with_path(
        lambda path, t: sharding.distribute(t, mesh, flat[path]), tree)


def spec_leaves(specs: Dict, prefix=()):
    """(path, spec) of every leaf of a tree of specs (e.g. `param_pspecs`)
    in the tree walker's order.  A PartitionSpec is a tuple, which
    `repro_torch.tree` would walk into: this walks the dicts only."""
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            yield from spec_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def count_params(cfg: ModelConfig) -> int:
    """Number of parameters in the tree (biases and norms included)."""
    return sum(math.prod(m.shape) for m in leaves(abstract_params(cfg)))
