"""The paper's experiments end to end on the port, run with ``python -m``:

* `quickstart` — Section IV-D: Tikhonov denoising of a smooth field on
  the SENSOR500 sensor network (Chebyshev apply or a Section-V solve;
  ``--drop-prob`` injects link faults into a sharded exchange);
* `distributed_lasso` — Section VI: wavelet-lasso denoising of a
  piecewise-smooth field (Algorithm 3), on one device or sharded over
  gloo ranks;
* `semi_supervised` — Section III-D: label propagation on a two-cluster
  graph with four RKHS kernels.

The counterparts of the JAX package's `examples/` scripts.  Each runs on
the card by default and takes ``--device cpu``; each `main` returns what
it printed, and each `run` takes its inputs explicitly, so that the same
numpy inputs can go through the JAX package's functions.
"""
from __future__ import annotations

import math
import os
import tempfile
from datetime import timedelta
from typing import Any, Callable, Tuple

import numpy as np
import torch

from ..configs.sensor500 import CONFIG as SENSOR500


def sensor_graph(n: int = SENSOR500.n_vertices, seed: int = 0):
    """The SENSOR500 network drawn from ``RandomState(seed)`` (connected,
    paper footnote 5).  At another n than the paper's 500 the radius and
    the kernel width scale by sqrt(500 / n), which keeps the mean degree
    (~8.8) of the paper's graph."""
    from ..core import graph

    s = math.sqrt(SENSOR500.n_vertices / n)
    return graph.connected_sensor_graph(np.random.RandomState(seed), n=n,
                                        theta=SENSOR500.theta * s,
                                        kappa=SENSOR500.kappa * s)


def mse(a, b) -> float:
    """Mean squared error of two signals, in float64 on `a`'s device."""
    a = torch.as_tensor(a).double()
    d = a - torch.as_tensor(b).double().to(a.device)
    return float(torch.mean(d * d))


def _rank(rank: int, world: int, tmp: str, fn: Callable, args: Tuple):
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(out, os.path.join(tmp, "result.pt"))


def spawn(fn: Callable, world: int, *args) -> Any:
    """``fn(*args)`` on `world` gloo ranks of one default group (file
    store in a temporary directory); returns rank 0's result.  `fn` is a
    module-level function; every rank calls it with the same args."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(world, tmp, fn, args), nprocs=world,
                 join=True)
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)
