"""Atomic checkpoints (the JAX package's `ckpt/checkpoint.py`), in its
file layout, so that either package reads what the other wrote.

Layout: ``<dir>/step_<N:08d>/`` holding ``arrays.npz`` (path-keyed leaves:
``params/layers/wqkv``, ``opt_state/step``, ``opt_state/m/...``) and
``manifest.json`` (``{"step", "trees": {name: {key: {"shape", "dtype"}}},
"extra"}``).  A write goes to a tmp directory, then ``os.replace``: a
crashed writer never leaves a half checkpoint visible.  ``keep_last``
checkpoints are kept.  Async saves copy every leaf to the host before
their thread starts (the trainer updates its tensors in place), and
`wait_pending` joins them.

A tree is nested dicts, named tuples (e.g. `optim.adamw.AdamWState`) and
lists or tuples, with tensors as leaves, walked by `repro_torch.tree`: the
JAX package's leaf paths.  bfloat16 and float8 leaves are
stored as raw 2- and 1-byte ``V`` arrays, as numpy stores the JAX
package's, with the dtype's name in the manifest; `load_checkpoint`
decodes them by that name (the JAX package's `restore_arrays` cannot
cast such an array back).

Checkpoints are reshardable: a save gathers each DTensor leaf (every rank
of its mesh calls `save_checkpoint` together) and only rank 0 of the
default group writes; `restore_arrays` lays each leaf out as its target
leaf, whatever mesh that one is on (or none).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dist.sharding import full, is_dtensor
from ..tree import leaves_with_paths, map_with_path

Tensor = torch.Tensor

_PENDING: List[threading.Thread] = []

#: Floats numpy has no type for (the JAX package's ml_dtypes names): the
#: torch dtype and the unsigned integer of the same width that carries
#: their bits.
NARROW_DTYPES = {"bfloat16": (torch.bfloat16, np.uint16),
                 "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
                 "float8_e5m2": (torch.float8_e5m2, np.uint8)}
_NARROW_NAMES = {tdt: name for name, (tdt, _) in NARROW_DTYPES.items()}
_SIGNED = {1: torch.int8, 2: torch.int16}


def tensor_to_numpy(t: Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of `t` as numpy and its dtype's name; a narrow float
    becomes a raw ``V<bytes>`` array of the same bits."""
    t = torch.as_tensor(t).detach().to("cpu", copy=True)
    name = _NARROW_NAMES.get(t.dtype)
    if name is None:
        a = t.numpy()
        return a, str(a.dtype)
    size = t.element_size()
    return t.view(_SIGNED[size]).numpy().view(f"V{size}"), name


def tensor_from_numpy(a, dtype: Optional[str] = None) -> Tensor:
    """A host tensor from numpy array `a`, whose dtype is named `dtype`
    (default: its own name): a narrow float (its bits in a ``V`` array or
    an ml_dtypes array) keeps its bits."""
    a = np.asarray(a)
    name = dtype or a.dtype.name
    if name in NARROW_DTYPES:
        tdt, carrier = NARROW_DTYPES[name]
        return torch.from_numpy(
            np.ascontiguousarray(a).view(carrier).copy()).view(tdt)
    if a.dtype.kind == "V":
        raise TypeError(f"a raw {a.dtype} array needs its dtype's name "
                        "(the manifest's)")
    return torch.from_numpy(np.array(a))


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def save_checkpoint(
    directory: str,
    step: int,
    trees: Dict[str, Any],
    keep_last: int = 3,
    async_save: bool = False,
    extra: Optional[Dict] = None,
) -> str:
    """trees: named trees, e.g. {'params': ..., 'opt_state': ...}.  Every
    leaf is copied to the host before this returns; DTensor leaves are
    gathered whole first, and then only rank 0 writes."""
    arrays: Dict[str, np.ndarray] = {}
    manifest = {"step": int(step), "trees": {}, "extra": extra or {}}
    sharded = False
    for name, tree in trees.items():
        leaves = manifest["trees"][name] = {}
        for path, leaf in leaves_with_paths(tree):
            sharded = sharded or is_dtensor(leaf)
            a, dtype = tensor_to_numpy(full(leaf))
            leaves[_key(path)] = {"shape": list(a.shape), "dtype": dtype}
            arrays[f"{name}/{_key(path)}"] = a

    final = os.path.join(directory, f"step_{step:08d}")
    if sharded and torch.distributed.get_rank() != 0:
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = f"{final}.tmp{os.getpid()}_{threading.get_ident()}_{id(trees)}"

    def write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        _gc(directory, keep_last)

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _PENDING.append(t)
    else:
        write()
    return final


def wait_pending() -> None:
    while _PENDING:
        _PENDING.pop().join()


def _gc(directory: str, keep_last: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and ".tmp" not in d
    )
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and ".tmp" not in d
        and os.path.exists(os.path.join(directory, d, "manifest.json"))
    )
    return os.path.join(directory, steps[-1]) if steps else None


def load_checkpoint(path: str) -> Tuple[int, Dict[str, Dict[str, Tensor]],
                                        Dict]:
    """Returns (step, {tree_name: {leaf_path: host tensor}}, extra); each
    leaf is decoded by its manifest dtype (bfloat16 and float8 too)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    trees: Dict[str, Dict[str, Tensor]] = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for name, leaves in manifest["trees"].items():
            trees[name] = {k: tensor_from_numpy(data[f"{name}/{k}"],
                                                meta["dtype"])
                           for k, meta in leaves.items()}
    return manifest["step"], trees, manifest.get("extra", {})


def restore_arrays(flat: Dict[str, Any], target_tree):
    """Rebuild a tree like `target_tree` from path-keyed leaves (tensors,
    or numpy arrays of a dtype numpy names): each cast to its target
    leaf's dtype and put on that leaf's device; a DTensor target's leaf
    is laid out as it is, on its mesh (each rank keeps its shards)."""

    def leaf(path, target):
        src = flat[_key(path)]
        src = src if isinstance(src, Tensor) else tensor_from_numpy(src)
        src = src.to(device=target.device, dtype=target.dtype)
        if is_dtensor(target):
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(src, target.device_mesh,
                                     target.placements, src_data_rank=None)
        return src

    return map_with_path(leaf, target_tree)
