"""The SGWT union of Section IV-D on the combinatorial Laplacian.

The program's side: its Laplacian L = D - W and the Anderson-Morley bound
on lambda_max (`repro_torch.core.graph`), the union [h, g(t_1 .), ...,
g(t_J .)] (`repro_torch.core.wavelets.sgwt_multipliers`) in a
`GraphOperator` of order K, planned on the card (``plan("cuda")``).  What
its set-up derived and the comparison reads: lambda_max and the
Chebyshev coefficients of every multiplier (``plan.lmax``,
``plan.coeffs``).
"""
import numpy as np

from portbench.reference import spectral


def sizes(cfg: dict) -> dict:
    return {"eta": cfg["J"] + 1, "K": cfg["K"], "r": 1}


def build(W, cfg: dict, device, **plan_options):
    from repro_torch.core import graph, wavelets
    from repro_torch.dist import GraphOperator

    L = graph.laplacian(W, "combinatorial")
    lmax = graph.lambda_max_bound(W, "combinatorial")
    op = GraphOperator(
        P=L, multipliers=wavelets.sgwt_multipliers(lmax, cfg["J"],
                                                   cfg["lpfactor"]),
        lmax=lmax, K=cfg["K"], coeff_points=cfg["coeff_points"])
    return op.plan("cuda", device=device, **plan_options)


def derived(plan, cfg: dict) -> dict:
    return {"lmax": float(plan.lmax),
            "coeffs": np.asarray(plan.coeffs, dtype=np.float64)}


def reference(graph, cfg: dict, prec):
    return spectral.sgwt_operator(graph, cfg["J"], cfg["K"],
                                  cfg["lpfactor"], cfg["coeff_points"], prec)


def reference_derived(ref) -> dict:
    return {"lmax": ref.lmax, "coeffs": ref.coeffs}


def gaps(derived: dict, ref) -> dict:
    """lmax_gap: |lambda_max - reference| / reference; coeff_gap: the
    widest coefficient gap over the largest reference coefficient."""
    c = np.asarray(derived["coeffs"], dtype=np.float64)
    return {"lmax_gap": abs(derived["lmax"] - ref.lmax) / ref.lmax,
            "coeff_gap": float(np.abs(c - ref.coeffs).max()
                               / np.abs(ref.coeffs).max())
            if c.shape == ref.coeffs.shape else float("inf")}
