"""The Tikhonov filter tau / (tau + lambda^r) of Section V, solved by
Jacobi (Fig. 2).

The program's side: its Laplacian (``cfg["P"]``: "normalized" is
L_norm, whose lambda_max is 2) and the filter as the multiplier
`repro_torch.core.filters.ssl_multiplier(power_kernel(r), tau)` in a
`GraphOperator` of order K, planned on the card (``plan("cuda")``); the
kinds call its solver with ``tau`` and ``r``.  What its set-up derived
and the comparison reads: D^-1 of the Jacobi split of den(P) = tau +
P^r, as the program applies it.  One Jacobi round from x = 0 gives x =
D^-1 num(P) y = tau D^-1 y, so one round of the program's own solve on
y = 1 reads D^-1 through its public entry, whatever holds it inside.
"""
import torch

from portbench.reference import spectral


def sizes(cfg: dict) -> dict:
    return {"eta": 1, "K": cfg["K"], "r": cfg["r"]}


def build(W, cfg: dict, device, **plan_options):
    from repro_torch.core import filters, graph
    from repro_torch.dist import GraphOperator

    P = graph.laplacian(W, cfg["P"])
    lmax = graph.lambda_max_bound(W, cfg["P"])
    g = filters.ssl_multiplier(filters.power_kernel(cfg["r"]), cfg["tau"])
    op = GraphOperator(P=P, multipliers=[g], lmax=lmax, K=cfg["K"],
                       coeff_points=cfg["coeff_points"])
    return op.plan("cuda", device=device, **plan_options)


def derived(plan, cfg: dict) -> dict:
    n = plan.op.P.shape[-1]
    y = torch.ones((1, n), dtype=torch.float32, device=plan.device)
    x = plan.solve(y, "jacobi", tau=cfg["tau"], r=cfg["r"], n_iters=1).x
    return {"inv_d": x[0].double() / cfg["tau"]}


def reference(graph, cfg: dict, prec):
    return spectral.tikhonov_operator(graph, cfg["P"], cfg["tau"], cfg["r"],
                                      cfg["K"], cfg["coeff_points"], prec)


def reference_derived(ref) -> dict:
    return {"inv_d": ref.inv_d().double()}


def gaps(derived: dict, ref) -> dict:
    """split_gap: the widest gap of D^-1 over its largest reference
    entry."""
    want = ref.inv_d().double()
    got = derived["inv_d"].to(want.device, torch.float64)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return {"split_gap": float("inf")}
    return {"split_gap": float((got - want).abs().max() / want.abs().max())}
