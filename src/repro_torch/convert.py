"""Carry state across from numpy arrays.

The JAX package's operators hand out their state as arrays (P, the
(eta, K+1) coefficient table, the Block-ELL structure), and its LM its
parameter tree, KV cache and optimizer state.  These functions build the
port's objects from exactly that state, so that both packages can be fed
identical inputs: the coefficients are taken as given, never recomputed,
and the weights, caches and moments are carried key by key.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .ckpt.checkpoint import tensor_from_numpy
from .core.graph import BlockELL
from .dist.operator import GraphOperator
from .optim.adamw import AdamWState


def _no_multiplier(lam):
    raise ValueError("this operator was built from a coefficient table and "
                     "has no multiplier functions")


def operator_from_reference(P, coeffs, lmax: float, K: int,
                            multipliers: Optional[Sequence[Callable]] = None
                            ) -> GraphOperator:
    """A GraphOperator over P that uses exactly `coeffs` ((eta, K+1)).

    `multipliers` (the g_j) are needed only by the multiplier-level
    methods (`exact_apply`, `error_bound`); without them those raise.
    """
    c = np.array(coeffs, dtype=np.float64)
    if c.ndim != 2 or c.shape[1] != K + 1:
        raise ValueError(f"coeffs must be (eta, K+1) = (eta, {K + 1}), "
                         f"got {c.shape}")
    mults = (tuple(multipliers) if multipliers is not None
             else (_no_multiplier,) * c.shape[0])
    if len(mults) != c.shape[0]:
        raise ValueError(f"{len(mults)} multipliers for {c.shape[0]} "
                         f"coefficient rows")
    op = GraphOperator(P=torch.from_numpy(np.array(P)), multipliers=mults,
                       lmax=float(lmax), K=int(K))
    op.__dict__["coeffs"] = c  # seeds the cached_property: never recomputed
    return op


def block_ell_from_numpy(blocks, indices, mask, n: int) -> BlockELL:
    """A BlockELL holding the given structure arrays (host tensors)."""
    blocks = torch.from_numpy(np.array(blocks))
    indices = torch.from_numpy(np.array(indices, dtype=np.int32))
    mask = torch.from_numpy(np.array(mask, dtype=bool))
    if blocks.ndim != 4 or indices.shape != blocks.shape[:2] \
            or mask.shape != indices.shape:
        raise ValueError(f"not a Block-ELL structure: blocks "
                         f"{tuple(blocks.shape)}, indices "
                         f"{tuple(indices.shape)}, mask {tuple(mask.shape)}")
    ncb = blocks.shape[0] * blocks.shape[2] // blocks.shape[3]
    if indices.numel() and (int(indices.min()) < 0
                            or int(indices.max()) >= ncb):
        raise ValueError(f"column-block indices outside [0, {ncb})")
    return BlockELL(blocks=blocks, indices=indices, mask=mask, n=int(n))


def lm_params_from_numpy(tree: Mapping) -> Dict:
    """The port's LM parameter dict from a nested mapping of numpy arrays
    (the JAX package's `init_params` tree after ``np.asarray``), key by
    key, as host tensors of the same dtype; the JAX package's stacked
    ``(L, ...)`` layout and key names are the port's own
    (`models.params.abstract_params`)."""
    return {key: (lm_params_from_numpy(val) if isinstance(val, Mapping)
                  else tensor_from_numpy(val))
            for key, val in tree.items()}


def lm_cache_from_numpy(tree: Mapping) -> Dict:
    """The port's KV cache (`models.decode.init_cache`'s dict) from the JAX
    package's cache after ``np.asarray``, key by key, as host tensors of
    every family: K / V, MLA's latents and whisper's cross K / V keep
    their bf16 or f8 bits, RWKV's ``wkv`` and hymba's ``ssm_h`` stay f32,
    the shifts and convolution tails keep the model dtype, ``idx``
    becomes a 0-d integer tensor.  Decode state then crosses over as the
    weights do."""
    return {key: tensor_from_numpy(val) for key, val in tree.items()}


def adamw_state_from_numpy(state) -> AdamWState:
    """The port's `optim.adamw.AdamWState` from the JAX package's
    ``AdamWState(step, m, v)`` after ``np.asarray`` (anything with those
    three attributes): step a 0-d int32 host tensor, m and v host trees
    of the same keys and dtypes (float32)."""
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        m=lm_params_from_numpy(state.m), v=lm_params_from_numpy(state.v))
