"""The paper's experiments end to end on the port, run with ``python -m``:

* `quickstart` — Section IV-D: Tikhonov denoising of a smooth field on
  the SENSOR500 sensor network (Chebyshev apply or a Section-V solve;
  ``--drop-prob`` injects link faults into a sharded exchange);
* `distributed_lasso` — Section VI: wavelet-lasso denoising of a
  piecewise-smooth field (Algorithm 3), on one device or sharded over
  gloo ranks;
* `semi_supervised` — Section III-D: label propagation on a two-cluster
  graph with four RKHS kernels;
* `serve_lm` and `train_lm` — the LM scaffold: batched KV-cache serving
  of a reduced hymba-1.5b, and training of a reduced deepseek-7b with
  checkpoints, ``--gossip`` averaging its gradients by the paper's
  Algorithm 1 on 4 gloo ranks.

The counterparts of the JAX package's `examples/` scripts.  Each runs on
the card by default and takes ``--device cpu``.  The graph examples'
`main` returns what it printed and their `run` takes its inputs
explicitly, so that the same numpy inputs can go through the JAX
package's functions; the LM examples' `main` returns the launcher's exit
code, and `launcher_argv` gives the arguments they pass it.
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


def _rank(rank: int, world: int, tmp: str, fn: Callable, args: Tuple,
          backend: str = "gloo"):
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(out, os.path.join(tmp, "result.pt"))


def spawn(fn: Callable, world: int, *args, backend: str = "gloo") -> Any:
    """``fn(*args)`` on `world` ranks of one default group (file store in
    a temporary directory); returns rank 0's result.  `fn` is a
    module-level function; every rank calls it with the same args.
    `backend` "gloo" (CPU tensors; CUDA ones staged by the callers) or
    "nccl" (rank r on card r)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(world, tmp, fn, args, backend), nprocs=world,
                 join=True)
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)
