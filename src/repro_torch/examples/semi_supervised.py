"""Distributed semi-supervised classification (paper Section III-D).

Two-cluster graph, 4 labeled nodes, labels propagated by applying the
optimal multiplier g(lambda) = tau / (tau + h(lambda)) to each class
indicator column — all classes share the same K communication rounds —
for four RKHS kernels h.

    python -m repro_torch.examples.semi_supervised [--device cpu]
        [--backend cuda|dense]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

N_PER, P_IN, P_OUT = 25, 0.85, 0.06
LABELED = (0, 1, 25, 26)
TAU, K = 0.5, 20


def kernels() -> dict:
    """The four kernels of the example, by name."""
    from ..core import filters

    return {
        "tikhonov L_norm  (S = L_norm)": filters.power_kernel(1),
        "tikhonov L_norm^2": filters.power_kernel(2),
        "diffusion (Smola-Kondor)": filters.diffusion_kernel(1.0),
        "2-step random walk": filters.random_walk_kernel(2.0, 2),
    }


def inputs(seed: int = 3) -> dict:
    """The two-cluster graph (numpy draws), its labels and the mask of
    the labeled nodes."""
    from ..core import graph

    g, labels = graph.two_cluster_graph(
        N_PER, P_IN, P_OUT, generator=np.random.default_rng(seed))
    mask = np.zeros(2 * N_PER, dtype=bool)
    mask[list(LABELED)] = True
    return dict(W=g.W, labels=labels, mask=mask)


def run(W, labels, mask, *, backend: str = "cuda", device=None,
        dtype: torch.dtype = torch.float32) -> dict:
    """Classify with each kernel on L_norm of the graph of weights `W`:
    per kernel, the scores and the accuracy on the unlabeled nodes."""
    from ..core import graph, ssl

    Ln = graph.Graph(W=torch.as_tensor(W).to(dtype)).laplacian("normalized")
    out = {}
    for name, h in kernels().items():
        res = ssl.semi_supervised_classify(Ln, labels, mask, 2, h=h,
                                           tau=TAU, lmax=2.0, K=K,
                                           backend=backend, device=device)
        out[name] = dict(scores=res.scores,
                         accuracy=ssl.accuracy(res, labels, mask))
    return out


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "semi_supervised")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "dense"),
                    help="execution backend for the label propagation")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    x = inputs(args.seed)
    print(f"two-cluster graph: N={2 * N_PER}, labeled={int(x['mask'].sum())}")
    res = run(x["W"], x["labels"], x["mask"], backend=args.backend,
              device=None if args.device == "cuda" else "cpu")
    for name, r in res.items():
        print(f"  {name:34s} accuracy on unlabeled: {r['accuracy']:.3f}")
    return res


if __name__ == "__main__":
    main()
