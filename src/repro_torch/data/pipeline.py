"""The graph signals of the paper's experiments (the JAX package's
`data/pipeline.py::graph_signal_batch`)."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

Tensor = torch.Tensor


def graph_signal_batch(coords: Union[Tensor, np.ndarray],
                       kind: str = "smooth", *,
                       generator: Optional[torch.Generator] = None
                       ) -> Tensor:
    """Signals from the paper's experiments, one per vertex of `coords`
    ((N, 2) sensor positions).

    'smooth'    — Section IV-D: h_n = n_x^2 + n_y^2 - 1.
    'piecewise' — Section VI: two smooth pieces split along n_y = 1 - n_x.
    'uniform'   — Section V-E: iid Uniform[-10, 10], drawn from
                  `generator` (on the coordinates' device), which this
                  kind needs: the JAX package draws from a jax PRNG key.
    """
    coords = torch.as_tensor(coords)
    nx, ny = coords[:, 0], coords[:, 1]
    if kind == "smooth":
        return nx ** 2 + ny ** 2 - 1.0
    if kind == "piecewise":
        upper = -2.0 * nx + 0.5
        lower = nx ** 2 + ny ** 2 + 0.5
        return torch.where(ny >= 1.0 - nx, upper, lower)
    if kind == "uniform":
        if generator is None:
            raise ValueError("kind='uniform' draws from generator=")
        u = torch.rand(coords.shape[0], generator=generator,
                       dtype=coords.dtype, device=coords.device)
        return 20.0 * u - 10.0
    raise ValueError(kind)
