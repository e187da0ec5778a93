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
inputs (no TF32), D in {16, 32, 64, 128}.  The tensor-core kernel keeps
m, l and O in f32 but rounds the probabilities P to bf16 before P V (the
JAX kernel keeps P in f32; ROADMAP section 3 records the difference).

Dispatch: a tensor on the CPU takes the plain PyTorch version
(`flash_attention_plain`, the counterpart of the JAX package's
`kernels/ref.py::attention_ref`); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

Tensor = torch.Tensor

#: Head dimensions the f32 FFMA kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 128)
#: Head dimensions of the bf16 tensor-core kernel.
WGMMA_HEAD_DIMS = (64, 128)
#: The score of a masked (row, column) pair, as in the TPU kernel.
NEG_INF = -1e30


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
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn = lib.flash_attention_wgmma_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def _check_cuda(q: Tensor, k: Tensor, v: Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors, got "
                         f"{q.device}")
    _check_shapes(q, k, v)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share one device")


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
    D in :data:`HEAD_DIMS`, f32 arithmetic on the CUDA cores (no TF32).
    Returns q's shape and dtype.  CPU tensors take the plain version;
    counted in ``flash_attention_ffma.launches``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _check_cuda(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b == 0 or hq == 0 or sq == 0:
        return out
    if b * hq * math.ceil(sq / 64) >= 2**31:
        raise ValueError("too many (batch, head, q tile) blocks for one "
                         "launch")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            int(q.dtype == torch.bfloat16), d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), _strides(q, k, v, out), b, hq,
            hkv, sq, sk, float(scale), int(bool(causal)), stream)
    _build.check(lib, err, "flash_attention_ffma")
    flash_attention_ffma.launches += 1
    return out


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
