"""repro_torch.serve — continuous-batching serving over the port's plans
(the JAX package's `repro.serve`, with its `__all__`).

The production face of the paper's batch-amortization result: B requests
that share a compatibility key ride ONE padded (B, N) launch and hence
one set of 2K|E| Chebyshev exchange rounds, instead of B sets.

* :mod:`repro_torch.serve.engine`   — :class:`ServeEngine`: per-key FIFO
  admission, batch-full/deadline flushing, bucket padding, dispatch onto
  the plan's memoized entries (one CUDA graph per (label, bucket) on the
  card, `repro_torch.dist.capture`), per-request futures.
* :mod:`repro_torch.serve.request`  — :class:`CompatKey` /
  :func:`compat_key` (grouping = the `compiled_solve` memo key),
  :class:`Response`, :class:`ServeFuture`.
* :mod:`repro_torch.serve.batching` — pad-to-bucket packing and its lossless
  inverse (:func:`pack_batch` / :func:`unpack_batch`,
  :func:`bucket_for`).
* :mod:`repro_torch.serve.clock`    — injectable time (:class:`VirtualClock`
  for deterministic tests, :class:`WallClock` for production).
* :mod:`repro_torch.serve.metrics`  — :class:`LatencyAccounter` (p50/p99,
  signals/sec, batch occupancy, padding waste).
* :mod:`repro_torch.serve.loadgen`  — seeded Poisson/burst arrival streams +
  :func:`replay_virtual`.

Usage: API.md ("Serving") describes the JAX engine, whose calls these
are; README.md ("PyTorch / H100 port") says how the port's is run.
"""
from .batching import bucket_for, pack_batch, unpack_batch
from .clock import VirtualClock, WallClock
from .engine import DEFAULT_BUCKETS, ServeEngine
from .loadgen import (ArrivalEvent, RetryPolicy, burst_arrivals,
                      poisson_arrivals, replay_virtual, signal_for)
from .metrics import BatchRecord, LatencyAccounter
from .request import (CompatKey, PendingError, RequestFailed, Response,
                      ServeFuture, compat_key)

__all__ = [
    "ArrivalEvent",
    "BatchRecord",
    "CompatKey",
    "DEFAULT_BUCKETS",
    "LatencyAccounter",
    "PendingError",
    "RequestFailed",
    "Response",
    "RetryPolicy",
    "ServeEngine",
    "ServeFuture",
    "VirtualClock",
    "WallClock",
    "bucket_for",
    "burst_arrivals",
    "compat_key",
    "pack_batch",
    "poisson_arrivals",
    "replay_virtual",
    "signal_for",
    "unpack_batch",
]
