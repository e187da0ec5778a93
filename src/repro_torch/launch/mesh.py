"""Device meshes of the port (the JAX package's `launch/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the default process group, which the caller initialises (gloo on the
CPU, NCCL with one card per rank, or the ``fake`` backend of the
dry-run).  Building one only names the ranks' layout; no tensor moves.
"""
from __future__ import annotations

import math


def _mesh(shape, axes, device=None):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n, world = math.prod(shape), dist.get_world_size()
    if world != n:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                           f"ranks, the default group has {world}")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: 2 pods x
    256, ("pod", "data", "model").

    The 'pod' axis is the slow dimension: only batch is sharded over it,
    so cross-pod traffic is gradient all-reduce only.  The default group
    holds 256 (512) ranks: the dry-run's is a ``fake`` group of this one
    process (`dryrun.run_cell` makes it), whose mesh lays out meta
    tensors (device type "meta": no card, no memory, and DTensor lowers a
    shard-to-shard move to the all-to-all it runs on cards, where on a
    CPU mesh it would all-gather)."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    device = "meta" if dist.get_backend() == "fake" else None
    return _mesh(shape, axes, device)


def make_test_mesh(shape=(2, 2), axes=("data", "model")):
    """A mesh of `shape` named `axes` over the ranks of the default group,
    which holds prod(shape) ranks, on the group's device type ("cuda"
    under NCCL, else "cpu")."""
    return _mesh(shape, axes)
