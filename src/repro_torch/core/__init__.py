"""Paper math of the PyTorch port: graphs, Chebyshev machinery,
multipliers, the Section-V Jacobi / ARMA iterations, the Section-VI lasso
and Section III-D semi-supervised classification.

The package-level names are the JAX package's `repro.core.__all__`, less
its deprecated `distributed` shim."""
from . import (arma, chebyshev, filters, graph, jacobi, lasso, multiplier,
               ssl, wavelets)
from .chebyshev import (cheb_apply, cheb_apply_adjoint, cheb_apply_gram,
                        cheb_coeffs, cheb_coeffs_stack, cheb_eval,
                        gram_coeffs)
from .graph import Graph, lambda_max_bound, laplacian, sensor_graph
from .multiplier import ScalarMultiplier, UnionMultiplier, graph_multiplier
from .wavelets import sgwt_multipliers, sgwt_operator

__all__ = [
    "arma", "chebyshev", "filters", "graph", "jacobi", "lasso",
    "multiplier", "ssl", "wavelets",
    "cheb_apply", "cheb_apply_adjoint", "cheb_apply_gram", "cheb_coeffs",
    "cheb_coeffs_stack", "cheb_eval", "gram_coeffs",
    "Graph", "laplacian", "lambda_max_bound", "sensor_graph",
    "ScalarMultiplier", "UnionMultiplier", "graph_multiplier",
    "sgwt_multipliers", "sgwt_operator",
]
