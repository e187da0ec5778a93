"""Inputs shared by the tests of the MoE, MLA, RWKV6, hymba and whisper
families: JAX weights with their zero and one leaves perturbed, the same
weights in the port, and encoder frames from a numpy seed.

At the JAX init the token-shift mixes (`mu_*`), RWKV's `bonus` and
`decay_base`, `ln_x`, mamba's `dt_bias`, `A_log`, `D_skip` and `conv_b`,
every bias and every norm are zeros or ones, so a wrong token shift,
bonus term or bias would pass unseen; seeded noise of std 0.1 is added to
each before the tree crosses to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import init_params as jinit_params
from repro.models.params import ParamMeta, abstract_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy

#: The families this slice ports (every preset but the dense ones and the
#: VLM backbone).
FAMILIES = [a for a in ARCH_IDS
            if get_config(a).family not in ("dense", "vlm")]


def perturbed_params(jcfg, seed: int, std: float = 0.1):
    """(JAX tree, port tree) of `jcfg` drawn from PRNGKey(seed), every
    zeros / ones leaf plus N(0, std) noise from numpy seed `seed`."""
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)

    def leaf(meta, x):
        x = np.asarray(x)
        if meta.init != "normal":
            x = x + std * rs.randn(*x.shape).astype(x.dtype)
        return x

    tree = jax.tree_util.tree_map(
        leaf, abstract_params(jcfg), jp,
        is_leaf=lambda m: isinstance(m, ParamMeta))
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree)


def frames(cfg, seed: int, batch: int, seq: int = 0):
    """(JAX kwargs, port kwargs) holding whisper's encoder frames
    (batch, seq or encoder_seq, D) from numpy seed `seed`; empty for the
    other families."""
    if not cfg.is_encoder_decoder:
        return {}, {}
    f = np.random.RandomState(seed).randn(
        batch, seq or cfg.encoder_seq, cfg.d_model).astype(np.float32)
    return ({"encoder_frames": jnp.asarray(f)},
            {"encoder_frames": torch.from_numpy(f)})
