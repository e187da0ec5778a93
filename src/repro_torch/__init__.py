"""PyTorch / CUDA port of `repro`: distributed graph signal processing via
Chebyshev polynomial approximation, on an NVIDIA H100.

The package imports only `torch` and `numpy`.  Its CUDA kernels are built
from ``csrc/`` at their first launch (`repro_torch.kernels._build`).
"""
