"""Hand-written Hopper kernels (CUDA C++, built lazily) with their plain
PyTorch versions, and the dispatch layer above them."""
from . import ops
from .bcsr_spmv import sliced_ell_spmv
from .cheb_step import cheb_step
from .cheb_sweep import cheb_sweep, jacobi_sweep
from .flash_attention import flash_attention
from .jacobi_step import jacobi_step
from .soft_threshold import ista_shrink

__all__ = ["ops", "cheb_step", "cheb_sweep", "flash_attention",
           "ista_shrink", "jacobi_step", "jacobi_sweep", "sliced_ell_spmv"]
