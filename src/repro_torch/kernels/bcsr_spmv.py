"""Block-ELL sparse matvec — the Algorithm 1 hot loop — for Hopper.

The paper's per-order cost is one sparse matvec with P (Section IV-A).  P
is stored in Block-ELL (`core.graph.BlockELL`): every row block keeps a
fixed number of (br, bc) column-block slots.  `block_ell_spmv` is one
wrapper for any batch: Y = A X^T on (..., ncb * bc) signals, every block
read once per tile of up to 64 signals by the hand-written CUDA kernel
``csrc/block_ell_spmv.cu`` (which replaces both `block_ell_spmv` and
`block_ell_spmv_batched` of the JAX package).

Dispatch: a tensor on the CPU takes the plain PyTorch version
(`block_ell_spmv_plain`); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

Tensor = torch.Tensor

#: Shared memory one thread block of the kernel may use without opting in.
SMEM_LIMIT = 48 * 1024
#: Threads per block of the Block-ELL kernels (csrc/block_ell_tile.cuh).
THREADS = 256


def block_ell_spmv_plain(blocks: Tensor, indices: Tensor, x: Tensor) -> Tensor:
    """y = A @ x in plain PyTorch; blocks (nrb, slots, br, bc), indices
    (nrb, slots), x (..., ncb * bc) with any leading batch dims.  Padded
    slots must hold zero blocks."""
    nrb, slots, br, bc = blocks.shape
    lead = x.shape[:-1]
    xb = x.reshape(lead + (-1, bc))
    gathered = xb.index_select(-2, indices.reshape(-1).long())
    gathered = gathered.reshape(lead + (nrb, slots, bc))
    y = torch.einsum("rsij,...rsj->...ri", blocks, gathered)
    return y.reshape(lead + (nrb * br,))


def tile_smem_bytes(br: int, bc: int, batch: int) -> int:
    """Shared memory of one thread block of the Block-ELL kernels: the
    (br, bc) matrix block and the iterate tile, rows padded to bc + 1."""
    per_pass = THREADS // br
    tb = (2 if batch > per_pass else 1) * per_pass
    return 4 * (br + tb) * (bc + 1)


def check_block_ell(blocks: Tensor, indices: Tensor, x: Tensor) -> None:
    """Raise on anything the Block-ELL kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"Block-ELL kernels run on CUDA tensors, got "
                         f"{x.device}")
    if blocks.device != x.device or indices.device != x.device:
        raise ValueError("blocks, indices and x must share one device")
    if blocks.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("Block-ELL kernels take float32 blocks and signals")
    if indices.dtype != torch.int32:
        raise TypeError("Block-ELL column indices must be int32")
    if blocks.ndim != 4 or indices.shape != blocks.shape[:2]:
        raise ValueError(f"blocks {tuple(blocks.shape)} / indices "
                         f"{tuple(indices.shape)} are not Block-ELL")
    if not (blocks.is_contiguous() and indices.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("Block-ELL kernels take contiguous tensors")
    _, _, br, bc = blocks.shape
    if THREADS % br:
        raise ValueError(f"row block {br} must divide {THREADS}")
    if x.shape[-1] % bc:
        raise ValueError(f"signal length {x.shape[-1]} is not a multiple of "
                         f"the column block {bc}")
    batch = math.prod(x.shape[:-1])
    if tile_smem_bytes(br, bc, batch) > SMEM_LIMIT:
        raise ValueError(f"block shape ({br}, {bc}) needs more than "
                         f"{SMEM_LIMIT} B of shared memory")


def _lib() -> ctypes.CDLL:
    lib = _build.library("block_ell_spmv")
    fn = lib.block_ell_spmv_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong, ctypes.c_void_p])
    return lib


def block_ell_spmv(blocks: Tensor, indices: Tensor, x: Tensor) -> Tensor:
    """Y = A @ X^T for Block-ELL A and signals x (..., ncb * bc).

    Returns (..., nrb * br).  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/block_ell_spmv.cu`` (counted in
    ``block_ell_spmv.launches``).
    """
    if x.device.type == "cpu":
        return block_ell_spmv_plain(blocks, indices, x)
    check_block_ell(blocks, indices, x)
    nrb, slots, br, bc = blocks.shape
    lead = x.shape[:-1]
    B = math.prod(lead)
    y = torch.empty(lead + (nrb * br,), dtype=x.dtype, device=x.device)
    if B == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.block_ell_spmv_f32(
            blocks.data_ptr(), indices.data_ptr(), x.data_ptr(),
            y.data_ptr(), nrb, slots, br, bc, B, x.shape[-1], stream)
    _build.check(lib, err, "block_ell_spmv")
    block_ell_spmv.launches += 1
    return y


block_ell_spmv.launches = 0
