"""Seeded arrival-stream generators + a deterministic replay driver (the
JAX package's `repro/serve/loadgen.py`, copied: numpy only, the same
`np.random.RandomState` draws, so a stream equals the reference's event
for event).

Both generators return plain sorted lists of :class:`ArrivalEvent` — no
clock, no randomness at replay time — so the SAME stream can be replayed
against a :class:`~repro_torch.serve.clock.VirtualClock` in tests (zero
wall-clock sleeps, bit-reproducible scheduling) and against a wall clock
(honest latency under offered load, as ``chip_smoke.py`` replays it).
Per-request signals are derived from the event's own seed
(:func:`signal_for`), so a stream is fully described by
``(generator args, seed)``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: A workload mix entry: (weight, kind, method, solve_kwargs).
MixEntry = Tuple[float, str, Optional[str], Dict[str, Any]]

#: Default mix: mostly filter applications, some Section-V solves —
#: exercises compatibility-key isolation under load.
DEFAULT_MIX: Sequence[MixEntry] = (
    (0.8, "apply", None, {}),
    (0.2, "solve", "jacobi", {"tau": 0.5, "n_iters": 8}),
)


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One scheduled request: when it arrives and what it asks for."""

    t: float                    # seconds from stream start
    kind: str
    method: Optional[str]
    solve_kwargs: Tuple[Tuple[str, Any], ...]  # hashable kwargs items
    seed: int                   # per-request signal seed
    op: str = "default"

    def kwargs(self) -> Dict[str, Any]:
        return dict(self.solve_kwargs)


def _normalize_mix(mix: Optional[Sequence[MixEntry]]):
    mix = list(mix if mix is not None else DEFAULT_MIX)
    weights = np.asarray([m[0] for m in mix], np.float64)
    if not len(mix) or weights.sum() <= 0:
        raise ValueError("mix needs at least one positive-weight entry")
    return mix, weights / weights.sum()


def _events(times: np.ndarray, mix, probs, rng,
            op: str) -> List[ArrivalEvent]:
    events = []
    picks = rng.choice(len(mix), size=len(times), p=probs)
    seeds = rng.randint(0, 2**31 - 1, size=len(times))
    for t, pick, seed in zip(times, picks, seeds):
        _, kind, method, kwargs = mix[pick]
        events.append(ArrivalEvent(
            t=float(t), kind=kind, method=method,
            solve_kwargs=tuple(sorted(kwargs.items())), seed=int(seed),
            op=op))
    return events


def poisson_arrivals(rate: float, n_requests: int, seed: int = 0,
                     mix: Optional[Sequence[MixEntry]] = None,
                     op: str = "default") -> List[ArrivalEvent]:
    """`n_requests` Poisson arrivals at `rate` req/s (exponential gaps).

    Deterministic per ``(rate, n_requests, seed, mix)``; times start at
    the first gap (never 0.0), sorted ascending.
    """
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    mix, probs = _normalize_mix(mix)
    rng = np.random.RandomState(seed)
    times = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    return _events(times, mix, probs, rng, op)


def burst_arrivals(n_bursts: int, burst_size: int, period: float,
                   seed: int = 0,
                   mix: Optional[Sequence[MixEntry]] = None,
                   op: str = "default") -> List[ArrivalEvent]:
    """`n_bursts` simultaneous bursts of `burst_size` requests, one
    burst every `period` seconds — the adversarial coalescing load (a
    full burst should ride one bucket)."""
    if period <= 0:
        raise ValueError(f"period must be > 0, got {period}")
    mix, probs = _normalize_mix(mix)
    rng = np.random.RandomState(seed)
    times = np.repeat(np.arange(n_bursts, dtype=np.float64) * period,
                      burst_size)
    return _events(times, mix, probs, rng, op)


def signal_for(event: ArrivalEvent, n: int,
               eta: Optional[int] = None) -> np.ndarray:
    """The event's deterministic request signal: ``(n,)`` float32 from
    its seed (``(eta, n)`` for adjoint-kind events)."""
    rng = np.random.RandomState(event.seed)
    shape = (eta, n) if event.kind == "apply_adjoint" else (n,)
    return rng.standard_normal(shape).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff hook for admission-rejected submissions.

    When the engine's bounded queue refuses a request ("rejected" error
    Response), :func:`replay_virtual` resubmits it up to `max_retries`
    times, waiting ``backoff * factor**attempt`` seconds before attempt
    `attempt + 1`.  Purely client-side: the engine itself never retries
    (exactly-once stays with the caller)."""

    max_retries: int = 3
    backoff: float = 0.002
    factor: float = 2.0

    def delay(self, attempt: int) -> float:
        """Seconds to wait after rejected attempt number `attempt`
        (0-based) before resubmitting."""
        return self.backoff * (self.factor ** attempt)


def replay_virtual(engine, events: Sequence[ArrivalEvent], n: int,
                   eta: Optional[int] = None,
                   deadline: Optional[float] = None,
                   retry: Optional[RetryPolicy] = None) -> Dict[int, Any]:
    """Replay a stream against a virtual-clock engine, deterministically.

    Advances the engine's clock event-to-event (flushing any deadlines
    that fall inside each hop), submits every event's seeded signal,
    drains with :meth:`run_until_idle`, and returns
    ``{event index: future}``.  Zero sleeps; identical streams produce
    identical scheduling decisions and metrics.

    `deadline` (relative seconds, applied to every submit) forwards to
    ``engine.submit(deadline=...)``.  `retry` enables the client-side
    backoff hook: an admission-rejected submit is re-queued at
    ``t + retry.delay(attempt)`` and the returned future for that event
    index is the LAST attempt's (so a stream can absorb transient
    queue-full windows without losing exactly-once accounting — every
    attempt is its own request id in the metrics).
    """
    heap = []
    for i, ev in enumerate(sorted(events, key=lambda e: e.t)):
        heap.append((ev.t, i, 0, ev))
    heapq.heapify(heap)
    futures: Dict[int, Any] = {}
    while heap:
        t, i, attempt, ev = heapq.heappop(heap)
        while True:
            due = engine.next_deadline()
            if due is None or due > t:
                break
            engine.clock.advance_to(due)
            engine.poll()
        engine.clock.advance_to(t)
        engine.poll()
        fut = engine.submit(
            signal_for(ev, n, eta), op=ev.op, kind=ev.kind,
            method=ev.method, deadline=deadline, **ev.kwargs())
        futures[i] = fut
        if (retry is not None and fut.done() and fut.response.rejected
                and attempt < retry.max_retries):
            heapq.heappush(
                heap, (t + retry.delay(attempt), i, attempt + 1, ev))
    engine.run_until_idle()
    return futures
