"""Logical-axis sharding rules on a `torch.distributed` device mesh (the JAX
package's `dist/sharding.py`).

A :class:`ShardingRules` turns logical axis names ("batch", "embed",
"heads", ...) into :class:`PartitionSpec` entries against a mesh, and a
spec into DTensor placements (`placements`).  The mapping is the JAX
package's, scheme by scheme: ``_BASE`` holds the tensor-parallel default
and ``_SCHEMES`` the named overrides (fsdp, ...).  `spec` drops mesh axes
the mesh does not have and a mesh axis an earlier dimension already used,
so one mapping serves 1-D, 2-D and 3-D meshes.

The mesh is read duck-typed: a `torch.distributed.device_mesh.DeviceMesh`
(``mesh_dim_names``), or any object with ``axis_names`` (metadata only:
specs and placements, no tensors).

Usage::

    rules = make_rules(mesh, scheme="fsdp")
    w_spec = rules.spec("embed", "ffn")          # PartitionSpec of a weight
    x = rules.constrain(x, "batch", None, "embed")   # x.redistribute(...)

Under a mesh every operand of an op is a DTensor: `lift` makes a tensor
built inside a step (RoPE angles, masks, recurrent state) a replicated
DTensor on its operand's mesh.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

AxisTarget = Union[str, Tuple[str, ...], None]

# Scheme-independent logical-axis vocabulary with the tensor-parallel
# (megatron-style) defaults: batch over the data axes, weight matrices
# column/row split over 'model', everything else replicated.
_BASE: Dict[str, AxisTarget] = {
    # graph signals (dist backends: one contiguous vertex block per device
    # on the 1-D "graph" mesh; see repro.dist.backends.halo / pallas_halo)
    "vertex": "graph",
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "frames": None,
    "moe_group": "data",
    # weights
    "layers": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "kv_lora": None,
    "ffn": "model",
    "state": None,
    "expert": "model",
    "vocab": "model",
}

# Named scheme overrides applied on top of _BASE.
_SCHEMES: Dict[str, Dict[str, AxisTarget]] = {
    # tensor parallel (the _BASE defaults)
    "default": {},
    "tp": {},
    # fully-sharded data parallel: weights sharded over every mesh axis on
    # their embed dimension, activations batch-sharded over every axis, no
    # tensor parallelism on heads/ffn/vocab; MoE keeps expert parallelism.
    "fsdp": {
        "batch": ("pod", "data", "model"),
        "embed": ("data", "model"),
        "heads": None,
        "kv_heads": None,
        "ffn": None,
        "vocab": None,
        "expert": "model",
        "moe_group": "data",
    },
    # fsdp without expert parallelism (dense-expert debugging scheme)
    "fsdp_noep": {
        "batch": ("pod", "data", "model"),
        "embed": ("data", "model"),
        "heads": None,
        "kv_heads": None,
        "ffn": None,
        "vocab": None,
        "expert": None,
        "moe_group": "data",
    },
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of names
    (sharded over their product, the first outermost) or None
    (replicated).  Equal to ``tuple(jax_spec)`` of the same layout."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Tuple[str, ...]:
    """The axis names of `mesh` (a DeviceMesh or a duck-typed mesh)."""
    if mesh is None:
        return ()
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    return tuple(names or ())


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> Tuple:
    """DTensor placements of `spec` on `mesh`: ``Shard(d)`` on every mesh
    dimension that the spec puts on tensor dim d, ``Replicate()`` on the
    others.  A dim over several axes is sharded in mesh order (the first
    axis outermost, as the JAX package's tuple entry); another order has
    no placement and raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in the order of "
                             f"the mesh axes {names}")
        for i in order:
            out[i] = Shard(d)
    return tuple(out)


def shard_range(size: int, placements, mesh, dim: int) -> Tuple[int, int]:
    """(first index, length) of this rank's shard of a tensor dim of
    `size` laid out by `placements` on `mesh` along `dim`: DTensor's
    chunks (ceil(size / n), the last ones short or empty), nested in mesh
    order where several mesh dims shard it."""
    lo, n = 0, size
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            chunk = -(-n // mesh.size(i))
            start = min(n, chunk * mesh.get_local_rank(i))
            lo, n = lo + start, min(chunk, n - start)
    return lo, n


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def lift(t, like):
    """`t` as a replicated DTensor on `like`'s mesh when `like` is a
    DTensor and `t` a plain tensor (a constant built inside a step);
    otherwise `t` itself."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


@dataclasses.dataclass
class ShardingRules:
    """Logical-axis -> mesh-axis mapping bound to a mesh (or to None = no-op).

    ``mapping`` values may be a mesh axis name, a tuple of mesh axis names
    (sharded over their product), or None (replicated).  Mesh axes absent
    from the bound mesh are dropped, and a mesh axis already consumed by an
    earlier dimension of the same spec is dropped too (a mesh axis can shard
    at most one dimension of a tensor).
    """

    mapping: Mapping[str, AxisTarget]
    mesh: Any = None

    @classmethod
    def null(cls) -> "ShardingRules":
        """Rules that replicate everything and make `constrain` a no-op."""
        return cls(mapping={}, mesh=None)

    def _mesh_axes(self) -> Tuple[str, ...]:
        return mesh_axes(self.mesh)

    def spec(self, *logical_axes: Optional[str]) -> PartitionSpec:
        """PartitionSpec for a tensor whose dims carry these logical names."""
        available = self._mesh_axes()
        used: set = set()
        entries = []
        for name in logical_axes:
            target = self.mapping.get(name) if name is not None else None
            if target is None:
                entries.append(None)
                continue
            if isinstance(target, str):
                target = (target,)
            live = [ax for ax in target if ax in available and ax not in used]
            used.update(live)
            if not live:
                entries.append(None)
            elif len(live) == 1:
                entries.append(live[0])
            else:
                entries.append(tuple(live))
        return PartitionSpec(*entries)

    def placements(self, *logical_axes: Optional[str]) -> Tuple:
        """The DTensor placements of `spec(*logical_axes)` on the mesh."""
        return placements(self.spec(*logical_axes), self.mesh)

    def constrain(self, x, *logical_axes: Optional[str]):
        """``x.redistribute`` to the spec's placements under the bound
        mesh (the counterpart of with_sharding_constraint); the identity
        without one."""
        if self.mesh is None or not self._mesh_axes():
            return x
        if not is_dtensor(x):
            raise TypeError("under a mesh every constrained tensor is a "
                            f"DTensor, not {type(x).__name__}")
        return x.redistribute(self.mesh, self.placements(*logical_axes))

    def distribute(self, t: torch.Tensor, *logical_axes: Optional[str]):
        """The full tensor `t`, held alike by every rank, as a DTensor laid
        out by `spec(*logical_axes)`: each rank keeps its own shard (no
        collective).  The identity without a mesh."""
        if self.mesh is None or not self._mesh_axes():
            return t
        return distribute(t, self.mesh, self.spec(*logical_axes))


def distribute(t: torch.Tensor, mesh, spec):
    """`t` (the same full tensor on every rank) as a DTensor on `mesh`
    laid out by `spec`, each rank cutting its own shard."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def replicate(x):
    """A DTensor redistributed to Replicate on every mesh dim (a pending
    sum is reduced); a plain tensor as it is."""
    if not is_dtensor(x) or all(p.is_replicate() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def like(x, ref):
    """DTensor `x` redistributed to the placements of `ref` (a gradient to
    its parameter's layout); a plain tensor as it is."""
    if not is_dtensor(x) or x.placements == ref.placements:
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def unshard(x, *dims: int):
    """DTensor `x` gathered along `dims` and along every dim its mesh
    shards unevenly (those mesh dims made Replicate); a plain tensor as
    it is.  DTensor's argmax over a sharded dim, or over uneven shards (a
    batch of 1 over 16 ranks), fails on a large mesh."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    mesh, lay = x.device_mesh, list(x.placements)
    for d in range(x.ndim):
        n = math.prod(mesh.size(i) for i, p in enumerate(lay)
                      if p.is_shard(d))
        if x.shape[d] % n or d in [e % x.ndim for e in dims]:
            lay = [Replicate() if p.is_shard(d) else p for p in lay]
    if lay == list(x.placements):
        return x
    return x.redistribute(mesh, lay)


def _cut(x, dim: int) -> int:
    """The number of pieces DTensor `x`'s mesh cuts `dim` into."""
    mesh = x.device_mesh
    return math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                     if p.is_shard(dim))


def reshape(x, shape):
    """``x.reshape(shape)``; for a DTensor whose sharded dims keep their
    place (the dims before them unchanged, or the outer part of the one
    split or merged dim), on each rank's shard in x's placements, that
    dim gathered first when the mesh cannot cut it evenly.  DTensor's own
    view refuses to split a sharded dim on some torches, cannot cut a
    head count unevenly, and its gradient's view back reads the global
    strides; a pending sum's gradient comes back replicated."""
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import DTensor, Replicate

    shape = tuple(shape)
    k = 0
    while k < min(x.ndim, len(shape)) and x.shape[k] == shape[k]:
        k += 1
    if any(p.is_shard() and p.dim > k for p in x.placements):
        return x.reshape(shape)
    if k < len(shape) and (shape[k] % _cut(x, k) or x.shape[k] % _cut(x, k)):
        x = unshard(x, k)
    lay = x.placements
    local = x.to_local(grad_placements=[Replicate() if p.is_partial()
                                        else p for p in lay])
    y = local.reshape(tuple(local.shape[:k]) + tuple(
        n // _cut(x, d) for d, n in enumerate(shape) if d >= k))
    return DTensor.from_local(
        y, x.device_mesh, lay, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def full(x):
    """The whole tensor of a DTensor (an all-gather); a plain tensor as
    it is.  Every rank of the mesh calls it together."""
    return x.full_tensor() if is_dtensor(x) else x


@functools.lru_cache(maxsize=None)
def make_rules(mesh, scheme: str = "default") -> ShardingRules:
    """Build the rules for a named scheme bound to `mesh` (cached)."""
    try:
        overrides = _SCHEMES[scheme]
    except KeyError:
        raise KeyError(
            f"unknown sharding scheme {scheme!r}; "
            f"available: {sorted(_SCHEMES)}") from None
    mapping = dict(_BASE)
    mapping.update(overrides)
    return ShardingRules(mapping=mapping, mesh=mesh)
