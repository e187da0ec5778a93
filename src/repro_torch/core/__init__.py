"""Paper math of the PyTorch port: graphs, Chebyshev machinery, multipliers."""
from . import chebyshev, filters, graph, multiplier, wavelets

__all__ = ["chebyshev", "filters", "graph", "multiplier", "wavelets"]
