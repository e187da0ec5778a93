"""Distributed wavelet-lasso denoising (paper Section VI, Algorithm 3).

Piecewise-smooth field on the 500-sensor network (SENSOR500), SGWT with
6 wavelet scales at order SENSOR500.lasso_K, iterative soft thresholding
over the Chebyshev-approximate frame, beside the Tikhonov denoiser.  With
``--sharded`` the whole ISTA loop runs on every rank of a gloo group
spawned here (``--ranks``, default 8): per iteration the only
communication is the exchange rounds of Phi~ Phi~*, and the counted
rounds and bytes of one apply are printed next to the paper's 2K|E|.

    python -m repro_torch.examples.distributed_lasso [--device cpu]
    python -m repro_torch.examples.distributed_lasso --sharded \\
        [--backend halo|cuda_halo|allgather] [--ranks 8]
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


def inputs(n: int = SENSOR500.n_vertices, seed: int = 11) -> dict:
    """The sensor network, the piecewise-smooth field of Section VI and
    its noisy observation (numpy draws)."""
    from ..data import graph_signal_batch

    g = sensor_graph(n, seed)
    f0 = graph_signal_batch(g.coords, "piecewise")
    noise = np.random.RandomState(seed + 1).standard_normal(n)
    y = f0 + SENSOR500.noise_sigma * torch.from_numpy(noise).float()
    return dict(W=g.W, coords=g.coords, f0=f0, y=y)


def mu_weights() -> list:
    """The paper's per-scale weights: mu_scaling on the scaling function,
    mu_wavelet on each of the wavelet scales."""
    p = SENSOR500
    return [p.lasso_mu_scaling] + [p.lasso_mu_wavelet] * p.n_wavelet_scales


def run(W, coords, f0, y, *, backend: str = "cuda",
        n_iters: int = SENSOR500.lasso_iters, device=None,
        dtype: torch.dtype = torch.float32) -> dict:
    """Algorithm 3 on `y` over the graph of weights `W` under `backend`,
    and the Tikhonov denoiser beside it: both signals, the three MSEs
    against `f0`, the lasso's coefficients and the plan's counts.  A ring
    backend sorts the graph into a band first and undoes the sort on the
    way out."""
    from ..core import filters, graph, wavelets
    from ..core.multiplier import graph_multiplier
    from ..dist import plan_comm_stats

    p = SENSOR500
    g = graph.Graph(W=torch.as_tensor(W).to(dtype),
                    coords=torch.as_tensor(coords))
    y = torch.as_tensor(y)
    order = None
    if backend in RING:
        g, order = graph.spatial_sort(g)
        y = y[torch.from_numpy(order)]
    lmax = g.lambda_max_bound()
    L = g.laplacian()
    op = wavelets.sgwt_operator(L, lmax, J=p.n_wavelet_scales,
                                K=p.lasso_K)
    plan = op.plan(backend, device=device)
    tik = graph_multiplier(L, filters.tikhonov(p.tau, p.r), lmax,
                           K=p.K).union.plan(backend, device=device
                                             ).apply(y)[..., 0, :]
    counted = None
    if backend in SHARDED:
        st = plan_comm_stats(plan)["apply"]
        counted = dict(rounds=st.exchange_rounds,
                       total_bytes=st.total_bytes)
    res = plan.solve_lasso(y, mu_weights(), gamma=p.lasso_gamma,
                           n_iters=n_iters)
    signal, coeffs = res.signal, res.coeffs
    if order is not None:  # undo the sort so the MSEs line up with f0
        inv = torch.from_numpy(np.argsort(order))
        on = inv.to(signal.device)
        signal, tik, coeffs, y = signal[on], tik[on], coeffs[..., on], y[inv]
    mc = op.message_counts(g.n_edges)
    return dict(signal=signal, tikhonov=tik, coeffs=coeffs,
                mse_noisy=mse(y, f0), mse_tikhonov=mse(tik, f0),
                mse_lasso=mse(signal, f0), n=g.n_vertices,
                n_edges=g.n_edges, backend=plan.backend,
                n_shards=plan.info.get("n_shards", 1), fused=res.fused,
                n_iters=n_iters, counted=counted,
                apply_messages=mc["apply_messages"],
                messages_per_iteration=(mc["gram_messages"]
                                        + mc["adjoint_messages"] * op.eta))


def main(argv: Optional[list] = None) -> dict:
    from ..dist import available_backends

    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "distributed_lasso")
    ap.add_argument("--sharded", action="store_true",
                    help="run on --ranks gloo ranks (default backend halo)")
    ap.add_argument("--backend", default=None, choices=available_backends(),
                    help="execution backend (default: cuda, or halo with "
                    "--sharded)")
    ap.add_argument("--iters", type=int, default=SENSOR500.lasso_iters)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--n", type=int, default=SENSOR500.n_vertices,
                    help="sensors (the radius keeps the paper's degree)")
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)
    backend = args.backend or ("halo" if args.sharded else "cuda")
    if backend in SHARDED and not args.sharded:
        ap.error(f"backend {backend!r} is sharded: pass --sharded")

    x = inputs(args.n, args.seed)
    fn = functools.partial(run, backend=backend, n_iters=args.iters,
                           device=None if args.device == "cuda" else "cpu")
    xs = (x["W"], x["coords"], x["f0"], x["y"])
    res = spawn(fn, args.ranks, *xs) if args.sharded else fn(*xs)
    print(f"backend={res['backend']} on {res['n_shards']} shard(s); "
          f"{res['n_iters']} ISTA iterations, fused={res['fused']}")
    if res["counted"] is not None:
        c = res["counted"]
        print(f"counted per apply: {c['rounds']} exchange rounds, "
              f"{c['total_bytes']} bytes over the group (paper model: "
              f"{res['apply_messages']} scalar messages)")
    print(f"MSE noisy    : {res['mse_noisy']:.4f}  (paper 0.250)")
    print(f"MSE tikhonov : {res['mse_tikhonov']:.4f}  (paper 0.098)")
    print(f"MSE lasso    : {res['mse_lasso']:.4f}  (paper 0.079)")
    print(f"communication per ISTA iteration ~ "
          f"{res['messages_per_iteration']} scalar messages (scales with "
          f"|E|={res['n_edges']}, independent of N beyond that)")
    return res


if __name__ == "__main__":
    main()
