"""Execution-backend registry for :class:`repro_torch.dist.GraphOperator`.

A backend is a builder ``build(op, *, mesh=None, partition=None,
device=None, **options) -> ExecutionPlan``:

    from repro_torch.dist.backends import register_backend

    @register_backend("my-backend")
    def build(op, *, mesh=None, partition=None, device=None, **options):
        ...
        return ExecutionPlan(op=op, backend="my-backend", ...)

Built-in backends (imported at the bottom so their decorators run):
  dense     — matvec against P as given (a dense product, no kernel)
  cuda      — Block-ELL SpMV, fused Chebyshev-step and whole-recurrence
              sweep kernels written for Hopper
  halo      — sharded over a torch.distributed group: a banded P split by
              rows, dense per-shard products, ring exchange of the boundary
              tiles per order
  cuda_halo — the same exchange around the per-shard sliced-ELL SpMV and
              Chebyshev-step kernels (the sweeps on one shard)
  allgather — sharded rows of any P, one gather of the iterate per order
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.distributed as dist

_REGISTRY: Dict[str, Callable] = {}


def register_backend(name: str) -> Callable:
    """Decorator: register an ExecutionPlan builder under `name`."""

    def deco(build: Callable) -> Callable:
        _REGISTRY[name] = build
        return build

    return deco


def get_backend(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown execution backend {name!r}; "
            f"available: {available_backends()}") from None


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


def resolve_device(device) -> torch.device:
    """The device a plan runs on: ``None`` means the CUDA card
    ``cuda:<rank % device_count>``, the rank being this process's rank in
    the default `torch.distributed` group (0 without one).

    Raises `RuntimeError` when a CUDA device is asked for (or implied) and
    there is none: a plan never falls back to the CPU.  On a CUDA device
    float32 products are pinned to full precision:
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` (no quiet TF32).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: plans run on the card unless the caller "
                "passes device='cpu'")
        if device is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


from . import dense      # noqa: E402,F401
from . import cuda       # noqa: E402,F401
from . import halo       # noqa: E402,F401
from . import cuda_halo  # noqa: E402,F401
from . import allgather  # noqa: E402,F401
