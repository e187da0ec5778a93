"""Flash attention for Hopper: causal or full online-softmax attention with
grouped-query heads, forward only.

``csrc/flash_attention.cu`` replaces the JAX package's
`kernels/flash_attention.py::flash_attention` (its only caller is the LM's
full-sequence forward, `models.layers.attention` with
``RunConfig(attn_impl="flash")``) with two kernels: a bf16 tensor-core
kernel (`wgmma`, TMA) for D = 64 and 128, which serves the LM, and an
f32 FFMA kernel for f32 and every other head dim.  The JAX kernel has no
backward, so neither has this one.

    q (B, Hq, Sq, D), k / v (B, Hkv, Sk, D), Hq % Hkv == 0: q head h reads
    KV head h // (Hq / Hkv); the causal mask is top-left aligned
    (col <= row); scale defaults to 1 / sqrt(D); the output has q's shape
    and dtype.

Both take any Sq and Sk (the TPU kernel asked for multiples of its
128-row blocks) and read q, k and v through their strides (last axis
contiguous), so the head-split views of the fused QKV projection reach
them without a copy.  The FFMA kernel computes in f32 from bf16 or f32
inputs (no TF32) at any head dim the JAX kernel takes up to 256
(:func:`ffma_width`).  The tensor-core kernel keeps
m, l and O in f32 but rounds the probabilities P to bf16 before P V (the
JAX kernel keeps P in f32; ROADMAP section 3 records the difference).

Dispatch: a tensor on the CPU takes the plain PyTorch version
(`flash_attention_plain`, the counterpart of the JAX package's
`kernels/ref.py::attention_ref`); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

Tensor = torch.Tensor

#: Widths the f32 FFMA kernel is instantiated for (:func:`ffma_width`).
FFMA_WIDTHS = (16, 32, 64, 128, 256)
#: Head dimensions of the bf16 tensor-core kernel.
WGMMA_HEAD_DIMS = (64, 128)
#: The score of a masked (row, column) pair, as in the TPU kernel.
NEG_INF = -1e30


def ffma_width(d: int) -> int:
    """The instantiated width the FFMA kernel runs head dim `d` on: the
    smallest of :data:`FFMA_WIDTHS` that holds it (its columns past `d`
    are zeros in shared memory and are not written out).  Raises
    ValueError outside 1 <= d <= 256."""
    if not 1 <= d <= FFMA_WIDTHS[-1]:
        raise ValueError(f"the FFMA flash kernel takes head dims 1 to "
                         f"{FFMA_WIDTHS[-1]}, got {d}")
    return next(w for w in FFMA_WIDTHS if w >= d)


def _check_shapes(q: Tensor, k: Tensor, v: Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    bk, hkv, sk, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} and {hkv}")
    if sk == 0:
        raise ValueError("attention needs at least one key")


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True,
                          scale: Optional[float] = None) -> Tensor:
    """Naive softmax attention with GQA in f32 (masked scores -1e30), cast
    to q's dtype: the plain version beside the kernel."""
    _check_shapes(q, k, v)
    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        fn = lib.flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 3)
        fn = lib.flash_attention_fwd_split
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_longlong)])
        fn = lib.flash_attention_wgmma_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn = lib.flash_attention_ffma_info
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
    return lib


def _check_cuda(q: Tensor, k: Tensor, v: Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors, got "
                         f"{q.device}")
    _check_shapes(q, k, v)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share one device")


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return t.data_ptr() if t is not None else None


def _strides(*ts: Tensor):
    return (ctypes.c_longlong * (3 * len(ts)))(
        *(s for t in ts for s in t.stride()[:3]))


def takes_tensor_cores(q: Tensor, k: Tensor, v: Tensor,
                       scale: Optional[float] = None) -> bool:
    """Whether :func:`flash_attention` sends these inputs to the bf16
    tensor-core kernel: bf16 q, k, v with D in :data:`WGMMA_HEAD_DIMS` and
    a positive scale; everything else goes to the f32 FFMA kernel."""
    return (q.dtype == torch.bfloat16 and k.dtype == q.dtype
            and v.dtype == q.dtype and q.shape[-1] in WGMMA_HEAD_DIMS
            and (scale is None or scale > 0))


def _tma_ready(t: Tensor) -> bool:
    """TMA reads a (batch, head, seq, D) bf16 view in place, its strides
    in any order, when it starts on 16 bytes, D is contiguous and its
    (batch, head, seq) strides are positive multiples of 8 elements."""
    sb, sh, ss, sd = t.stride()
    return (sd == 1 and t.data_ptr() % 16 == 0
            and all(x > 0 and x % 8 == 0 for x in (sb, sh, ss)))


def flash_attention_wgmma(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True,
                          scale: Optional[float] = None) -> Tensor:
    """The bf16 tensor-core kernel (``flash_attention_wgmma_fwd``): q
    (B, Hq, Sq, D), k / v (B, Hkv, Sk, D), D in (64, 128).  Returns
    (B, Hq, Sq, D) bf16.  A view TMA cannot read in place is copied
    contiguous first.  CPU tensors take the plain version; counted in
    ``flash_attention_wgmma.launches``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _check_cuda(q, k, v)
    if not takes_tensor_cores(q, k, v, scale):
        raise TypeError(f"the tensor-core kernel takes bf16 q, k, v with D "
                        f"in {WGMMA_HEAD_DIMS} and a positive scale; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, D = "
                        f"{q.shape[-1]}, scale {scale}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    q, k, v = (t if _tma_ready(t) else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b == 0 or hq == 0 or sq == 0:
        return out
    if b * hq * math.ceil(sq / 128) >= 2**31:
        raise ValueError("too many (batch, head, q tile) blocks for one "
                         "launch")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_wgmma_fwd(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _strides(q, k, v, out), b, hq, hkv, sq, sk, float(scale),
            int(bool(causal)), stream)
    _build.check(lib, err, "flash_attention_wgmma")
    flash_attention_wgmma.launches += 1
    return out


def flash_attention_ffma(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True,
                         scale: Optional[float] = None) -> Tensor:
    """The f32 FFMA kernel (``flash_attention_fwd``): f32 or bf16 q, k, v,
    any head dim D from 1 to 256 (:func:`ffma_width`), f32 arithmetic on
    the CUDA cores (no TF32).  Returns q's shape and dtype.  Views whose
    rows do not start on 16 bytes are read element by element; a last axis
    that is not contiguous is copied first.  When the grid would load the
    card's SMs unevenly, the kernel splits the K range of the longest q
    tiles over several blocks and merges them in the same launch (scratch
    sized by ``flash_attention_fwd_split``).  CPU tensors take the plain
    version; counted in ``flash_attention_ffma.launches``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _check_cuda(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    ffma_width(d)   # raises past 256
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b == 0 or hq == 0 or sq == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    bf16, causal = int(q.dtype == torch.bfloat16), int(bool(causal))
    lib = _lib()
    with torch.cuda.device(q.device):
        chunk, blocks, n_counters, n_partials = _split(
            q.device.index, bf16, d, b, hq, sq, sk, causal)
        if blocks >= 2**31:
            raise ValueError("too many blocks for one launch")
        counters = partials = None
        if n_counters:
            counters = torch.zeros(n_counters, dtype=torch.int32,
                                   device=q.device)
            partials = torch.empty(n_partials, dtype=torch.float32,
                                   device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            bf16, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), _strides(q, k, v, out), b, hq, hkv, sq, sk,
            float(scale), causal, chunk, _ptr(counters), _ptr(partials),
            stream)
    _build.check(lib, err, "flash_attention_ffma")
    flash_attention_ffma.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def _split(device: int, bf16: int, d: int, b: int, hq: int, sq: int,
           sk: int, causal: int) -> tuple:
    lib = _lib()
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        err = lib.flash_attention_fwd_split(bf16, d, b, hq, sq, sk, causal,
                                            out)
    _build.check(lib, err, "flash_attention_ffma (split)")
    return tuple(out)


def ffma_split(dtype: torch.dtype, d: int, b: int, hq: int, sq: int,
               sk: int, causal: bool = True) -> dict:
    """How the FFMA kernel splits a call's work on the current card
    (``flash_attention_fwd_split``, memoised per shape): ``chunk`` K tiles
    a block, the ``blocks`` it launches, and the ``counters`` (int32,
    zeroed) and ``partials`` (f32) of scratch through which split q tiles
    merge (0 when none is split).  A grid too small or too uneven for the
    card's SMs splits the K range of its longest q tiles."""
    out = _split(torch.cuda.current_device(), int(dtype == torch.bfloat16),
                 d, b, hq, sq, sk, int(bool(causal)))
    return dict(zip(("chunk", "blocks", "counters", "partials"), out))


def ffma_kernel_info(dtype: torch.dtype, d: int) -> dict:
    """The FFMA kernel instance that serves head dim `d` for f32 or bf16
    inputs, as the CUDA runtime reports it (cudaFuncGetAttributes and the
    occupancy calculator, on the current card): registers per thread,
    shared memory bytes, resident blocks per SM, q rows per block and keys
    per K / V tile."""
    width = ffma_width(d)
    lib = _lib()
    out = (ctypes.c_int * 5)()
    err = lib.flash_attention_ffma_info(int(dtype == torch.bfloat16), d, out)
    _build.check(lib, err, "flash_attention_ffma_info")
    return dict(width=width, registers=out[0], smem_bytes=out[1],
                blocks_per_sm=out[2], q_rows=out[3], k_rows=out[4])


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    scale: Optional[float] = None) -> Tensor:
    """Online-softmax attention; q (B, Hq, Sq, D), k / v (B, Hkv, Sk, D).

    Returns (B, Hq, Sq, D) in q's dtype.  CPU tensors take the plain
    version.  CUDA tensors launch one of the two kernels of
    ``csrc/flash_attention.cu``: bf16 at D = 64 or 128 the tensor-core
    kernel (:func:`flash_attention_wgmma`), everything else the f32 FFMA
    kernel (:func:`flash_attention_ffma`); each counts its own launches.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if takes_tensor_cores(q, k, v, scale):
        return flash_attention_wgmma(q, k, v, causal=causal, scale=scale)
    return flash_attention_ffma(q, k, v, causal=causal, scale=scale)


flash_attention_wgmma.launches = 0
flash_attention_ffma.launches = 0
