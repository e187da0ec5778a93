"""Paper math of the PyTorch port: graphs, Chebyshev machinery,
multipliers, the Section-V Jacobi / ARMA iterations, the Section-VI lasso
and Section III-D semi-supervised classification."""
from . import (arma, chebyshev, filters, graph, jacobi, lasso, multiplier,
               ssl, wavelets)

__all__ = ["arma", "chebyshev", "filters", "graph", "jacobi", "lasso",
           "multiplier", "ssl", "wavelets"]
