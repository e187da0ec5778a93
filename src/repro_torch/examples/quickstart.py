"""Quickstart: the paper's Section IV-D experiment end to end.

Builds the 500-sensor random network (SENSOR500), observes a noisy
smooth field, and denoises it with the Chebyshev approximation of the
Tikhonov multiplier g(lambda) = tau / (tau + 2 lambda^r).

    python -m repro_torch.examples.quickstart [--device cpu]
        [--backend cuda|dense|halo|cuda_halo|allgather]
        [--method chebyshev|jacobi|cheb_jacobi|arma]

``--method`` other than chebyshev serves the same multiplier by a
Section-V solver (`plan.solve`, with the divergence guard
``check_every``).  A sharded backend runs on ``--ranks`` gloo ranks
spawned here (default 8); ``--drop-prob 0.1 --backend halo`` injects
seeded link faults into its exchange (`FaultSpec`) and prints the
degradation policy, the fault key and the MSE reached.
"""
from __future__ import annotations

import argparse
import functools
from typing import Optional

import numpy as np
import torch

from ..configs.sensor500 import CONFIG as SENSOR500
from . import mse, sensor_graph, spawn

SHARDED = ("halo", "cuda_halo", "allgather")
RING = ("halo", "cuda_halo")
METHODS = ("chebyshev", "jacobi", "cheb_jacobi", "arma")


def inputs(n: int = SENSOR500.n_vertices, seed: int = 0) -> dict:
    """The sensor network, the smooth field h = n_x^2 + n_y^2 - 1 and its
    noisy observation (sigma = SENSOR500.noise_sigma, numpy draws)."""
    from ..data import graph_signal_batch

    g = sensor_graph(n, seed)
    f0 = graph_signal_batch(g.coords, "smooth")
    noise = np.random.RandomState(seed + 1).standard_normal(n)
    y = f0 + SENSOR500.noise_sigma * torch.from_numpy(noise).float()
    return dict(W=g.W, coords=g.coords, f0=f0, y=y)


def run(W, coords, f0, y, *, backend: str = "cuda",
        method: str = "chebyshev", device=None,
        dtype: torch.dtype = torch.float32, fault_spec=None,
        degradation: str = "zero_fill") -> dict:
    """Denoise `y` on the graph of weights `W` (coordinates `coords`):
    the denoised signal, both MSEs against `f0`, and the plan's numbers.
    A ring backend sorts the graph into a band first and undoes the sort
    on the way out.  `dtype` is P's (float64 on the dense backend gives
    the float64 reference)."""
    from ..core import filters, graph
    from ..dist import GraphOperator

    p = SENSOR500
    g = graph.Graph(W=torch.as_tensor(W).to(dtype),
                    coords=torch.as_tensor(coords))
    y = torch.as_tensor(y)
    order = None
    if backend in RING:
        g, order = graph.spatial_sort(g)
        y = y[torch.from_numpy(order)]
    lmax = g.lambda_max_bound()
    R = GraphOperator(P=g.laplacian(),
                      multipliers=[filters.tikhonov(p.tau, p.r)],
                      lmax=lmax, K=p.K)
    opts = {}
    if fault_spec is not None:
        opts = dict(fault_spec=fault_spec, degradation=degradation)
    plan = R.plan(backend, device=device, **opts)
    solve = None
    if method == "chebyshev":
        denoised = plan.apply(y)[..., 0, :]
    else:
        # the Prop. 2 filter tau / (tau + 2 lambda^r) as the rational
        # problem den(L) f = tau y, den = tau + 2 lambda^r; check_every
        # arms the divergence guard
        res = plan.solve(y, method, tau=p.tau, r=p.r, h_scale=2.0,
                         n_iters=p.K, check_every=max(1, p.K // 2))
        denoised = res.x
        solve = dict(n_iters=res.n_iters,
                     matvecs_per_round=res.info["matvecs_per_round"],
                     exchange_rounds=res.info["exchange_rounds"],
                     residual=float(res.info["residual"]),
                     diverged=bool(res.info["diverged"]))
    if order is not None:  # undo the sort so the MSE lines up with f0
        inv = torch.from_numpy(np.argsort(order))
        denoised, y = denoised[inv.to(denoised.device)], y[inv]
    return dict(denoised=denoised, mse_noisy=mse(y, f0),
                mse_denoised=mse(denoised, f0), n=g.n_vertices,
                n_edges=g.n_edges, lmax=lmax, K=p.K, backend=plan.backend,
                n_shards=plan.info.get("n_shards", 1),
                error_bound=R.error_bound(),
                messages=plan.message_counts(g.n_edges)["apply_messages"],
                fault_key=plan.info.get("fault_key", "none"), solve=solve)


def main(argv: Optional[list] = None) -> dict:
    from ..dist import DEGRADATIONS, FaultSpec, available_backends

    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--backend", default="cuda",
                    choices=available_backends(),
                    help="execution backend for the multiplier")
    ap.add_argument("--method", default="chebyshev", choices=METHODS,
                    help="the Chebyshev approximation (Section IV) or an "
                    "iterative solve of (tau I + 2 L^r) f = tau y "
                    "(Eqs. (24)/(25)/(29)-(30))")
    ap.add_argument("--drop-prob", type=float, default=0.0,
                    help="per-(round, link) probability of dropping a "
                    "tile (seeded faults; needs halo or cuda_halo)")
    ap.add_argument("--degradation", default="zero_fill",
                    choices=DEGRADATIONS,
                    help="receiver-side substitute for dropped tiles")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=8,
                    help="gloo ranks of a sharded backend")
    ap.add_argument("--n", type=int, default=SENSOR500.n_vertices,
                    help="sensors (the radius keeps the paper's degree)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.drop_prob > 0 and args.backend not in RING:
        ap.error("--drop-prob needs a halo-exchange backend (--backend "
                 "halo or cuda_halo): link faults need links")

    x = inputs(args.n, args.seed)
    print(f"sensor network: N={args.n}")
    fault = (FaultSpec(drop_prob=args.drop_prob, seed=0)
             if args.drop_prob > 0 else None)
    fn = functools.partial(run, backend=args.backend, method=args.method,
                           device=None if args.device == "cuda" else "cpu",
                           fault_spec=fault, degradation=args.degradation)
    xs = (x["W"], x["coords"], x["f0"], x["y"])
    res = (spawn(fn, args.ranks, *xs) if args.backend in SHARDED
           else fn(*xs))
    print(f"lambda_max bound (Anderson-Morley): {res['lmax']:.2f}; "
          f"|E|={res['n_edges']}")
    if fault is not None:
        print(f"fault injection: drop_prob={args.drop_prob:g}, "
              f"degradation={args.degradation}, "
              f"fault_key={res['fault_key']}")
    if res["solve"] is not None:
        s = res["solve"]
        print(f"plan.solve[{args.method}]: {s['n_iters']} iterations x "
              f"{s['matvecs_per_round']} matvec(s)/round = "
              f"{s['exchange_rounds']} exchange rounds; residual "
              f"{s['residual']:.3e}, diverged={s['diverged']}")
    print(f"Chebyshev order K={res['K']}; backend={res['backend']} on "
          f"{res['n_shards']} shard(s); error bound B(K)*sqrt(eta) = "
          f"{res['error_bound']:.2e}")
    print(f"MSE noisy    : {res['mse_noisy']:.4f}   (paper avg: 0.250)")
    print(f"MSE denoised : {res['mse_denoised']:.4f}   (paper avg: 0.013)")
    print(f"communication: {res['messages']} length-1 messages (= 2K|E|)")
    return res


if __name__ == "__main__":
    main()
