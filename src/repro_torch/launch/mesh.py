"""Device meshes of the port (the JAX package's `launch/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the default process group, which the caller initialises (gloo on the
CPU, NCCL with one card per rank).  Building one only names the ranks'
layout; no tensor moves.
"""
from __future__ import annotations

import math


def make_test_mesh(shape=(2, 2), axes=("data", "model")):
    """A mesh of `shape` named `axes` over the ranks of the default group,
    which holds prod(shape) ranks, on the group's device type ("cuda"
    under NCCL, else "cpu")."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n, world = math.prod(shape), dist.get_world_size()
    if world != n:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                           f"ranks, the default group has {world}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))
