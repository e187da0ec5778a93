"""Latency and batch-efficiency accounting for the serving engine (the
JAX package's `repro/serve/metrics.py`, copied: numpy only).

Every timestamp the accounter sees comes from the engine's injected
clock, so under a :class:`repro_torch.serve.clock.VirtualClock` the whole
summary — p50/p99 latency, signals/sec, batch occupancy, padding waste —
is a deterministic function of the arrival schedule, and equals the JAX
engine's on the same stream.  The schema is the JAX package's
``BENCH_serving.json`` schema (API.md, "Serving").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from .request import CompatKey


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """One dispatched batch: which key, how full, how long."""

    key: CompatKey
    bucket: int
    occupancy: int          # real requests (the rest is zero padding)
    t_dispatch: float
    t_complete: float

    @property
    def padding(self) -> int:
        return self.bucket - self.occupancy


class LatencyAccounter:
    """Collects per-request and per-batch records; summarizes on demand.

    `record_served` / `record_failed` / `record_expired` enforce the
    exactly-once contract: every admitted request is *answered* exactly
    once — a result, a dispatch failure, or a deadline expiry; a second
    answer for the same id raises immediately (the bench's ``--check``
    gate also re-asserts it from the counts).  Admission rejections never
    enter the admitted set; they are counted separately.
    """

    def __init__(self):
        self._arrivals: Dict[int, float] = {}
        self._served: Dict[int, float] = {}
        self._failed: Dict[int, float] = {}
        self._expired: Dict[int, float] = {}
        self._rejected: Dict[int, float] = {}
        self._latencies: List[float] = []
        self._queue_delays: List[float] = []
        self.batches: List[BatchRecord] = []

    # -- recording (called by the engine) ----------------------------------
    def record_arrival(self, request_id: int, t: float) -> None:
        if request_id in self._arrivals:
            raise RuntimeError(f"request {request_id} submitted twice")
        self._arrivals[request_id] = t

    def _check_unanswered(self, request_id: int, what: str) -> None:
        if (request_id in self._served or request_id in self._failed
                or request_id in self._expired):
            raise RuntimeError(
                f"request {request_id} {what} after being answered — "
                "exactly-once violated")

    def record_served(self, request_id: int, t_dispatch: float,
                      t_complete: float) -> None:
        self._check_unanswered(request_id, "served")
        t_arr = self._arrivals[request_id]
        self._served[request_id] = t_complete
        self._latencies.append(t_complete - t_arr)
        self._queue_delays.append(t_dispatch - t_arr)

    def record_failed(self, request_id: int, t_complete: float) -> None:
        """A dispatch failure answered this request with an error
        Response; it counts toward exactly-once but not latency."""
        self._check_unanswered(request_id, "failed")
        self._failed[request_id] = t_complete

    def record_expired(self, request_id: int, t: float) -> None:
        """The request's deadline passed before dispatch."""
        self._check_unanswered(request_id, "expired")
        self._expired[request_id] = t

    def record_rejected(self, request_id: int, t: float) -> None:
        """Admission refused (full queue) — never entered the queue."""
        self._rejected[request_id] = t

    def record_batch(self, record: BatchRecord) -> None:
        self.batches.append(record)

    # -- views --------------------------------------------------------------
    @property
    def n_submitted(self) -> int:
        return len(self._arrivals)

    @property
    def n_served(self) -> int:
        return len(self._served)

    @property
    def n_failed(self) -> int:
        return len(self._failed)

    @property
    def n_expired(self) -> int:
        return len(self._expired)

    @property
    def n_rejected(self) -> int:
        return len(self._rejected)

    @property
    def n_pending(self) -> int:
        return (self.n_submitted - self.n_served - self.n_failed
                - self.n_expired)

    def summary(self) -> Dict[str, Any]:
        """The serving metrics schema (all times from the engine clock).

        latency_ms/queue_delay_ms: p50/p99/mean/max over served requests;
        signals_per_sec: served / (last completion - first arrival) — the
        *goodput* (error answers don't count); mean_batch_occupancy: mean
        real-requests-per-dispatch; padding_waste: padded rows /
        dispatched rows (0 = every slot did real work);
        served_exactly_once: every admitted id answered exactly once
        (result, failure, or expiry — no request lost, none answered
        twice); n_failed/n_expired/n_rejected: the error-outcome tallies.
        """
        lat = np.asarray(self._latencies, dtype=np.float64)
        qd = np.asarray(self._queue_delays, dtype=np.float64)
        occ = np.asarray([b.occupancy for b in self.batches], np.float64)
        buckets = np.asarray([b.bucket for b in self.batches], np.float64)
        span = 0.0
        if self._served:
            span = max(self._served.values()) - min(self._arrivals.values())
        total_rows = float(buckets.sum()) if len(buckets) else 0.0
        answered = (set(self._served) | set(self._failed)
                    | set(self._expired))
        return {
            "n_submitted": self.n_submitted,
            "n_served": self.n_served,
            "n_failed": self.n_failed,
            "n_expired": self.n_expired,
            "n_rejected": self.n_rejected,
            "served_exactly_once": (
                len(answered) == (self.n_served + self.n_failed
                                  + self.n_expired)
                and answered == set(self._arrivals)),
            "latency_ms": _dist_ms(lat),
            "queue_delay_ms": _dist_ms(qd),
            "span_s": span,
            "signals_per_sec": (self.n_served / span) if span > 0 else 0.0,
            "n_batches": len(self.batches),
            "mean_batch_occupancy": (
                float(occ.mean()) if len(occ) else 0.0),
            "padding_waste": (
                float((buckets - occ).sum() / total_rows)
                if total_rows else 0.0),
        }

    def per_key_counts(self) -> Dict[str, Dict[str, int]]:
        """{key label: {n_batches, n_requests}} — the isolation view."""
        out: Dict[str, Dict[str, int]] = {}
        for b in self.batches:
            d = out.setdefault(b.key.label(),
                               {"n_batches": 0, "n_requests": 0})
            d["n_batches"] += 1
            d["n_requests"] += b.occupancy
        return out


def _dist_ms(samples: np.ndarray) -> Dict[str, Optional[float]]:
    if not len(samples):
        return {"p50": None, "p99": None, "mean": None, "max": None}
    ms = samples * 1e3
    return {
        "p50": float(np.percentile(ms, 50)),
        "p99": float(np.percentile(ms, 99)),
        "mean": float(ms.mean()),
        "max": float(ms.max()),
    }
