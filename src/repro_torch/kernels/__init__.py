"""Hand-written Hopper kernels (CUDA C++, built lazily) with their plain
PyTorch versions, and the dispatch layer above them."""
from . import ops
from .bcsr_spmv import block_ell_spmv
from .cheb_step import cheb_step
from .cheb_sweep import cheb_sweep

__all__ = ["ops", "block_ell_spmv", "cheb_step", "cheb_sweep"]
