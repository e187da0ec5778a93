"""Injectable time sources for the serving engine (the JAX package's
`repro/serve/clock.py`, copied: the port imports nothing of it).

The scheduler never reads wall time directly — every timestamp comes from
a ``Clock`` passed at construction, so the same engine runs under:

* :class:`VirtualClock` — tests and discrete-event replays.  Time moves
  only when the driver calls :meth:`VirtualClock.advance` /
  :meth:`VirtualClock.advance_to`, so every scheduling decision (bucket
  choice, flush-on-timeout, starvation bound) is a pure function of the
  submitted arrival times: reproducible, assertable, and free of sleeps
  and timing flakes.
* :class:`WallClock` — production loops and ``chip_smoke.py``'s
  wall-clock replays.
  ``time.monotonic()`` so latency accounting survives NTP steps.

Anything with a ``now() -> float`` (seconds) method satisfies the
protocol; only virtual-style clocks need ``advance_to`` (required by
:meth:`repro_torch.serve.engine.ServeEngine.run_until_idle`).  Over a
plan of more than one rank the clock also picks the engine's mode: with
``advance_to`` every rank's engine batches alike in lockstep; without,
rank 0 leads and the other ranks follow (`repro_torch.serve.engine`).
"""
from __future__ import annotations

import time


class VirtualClock:
    """Deterministic manually-advanced clock (seconds, monotonic)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        """Move time forward by `dt` seconds; returns the new time."""
        if dt < 0:
            raise ValueError(f"cannot advance by negative dt {dt!r}")
        self._t += float(dt)
        return self._t

    def advance_to(self, t: float) -> float:
        """Move time forward to absolute `t` (no-op if already past it —
        the engine may ask for a deadline that batch-full dispatch
        already serviced)."""
        if t > self._t:
            self._t = float(t)
        return self._t

    def __repr__(self) -> str:  # pragma: no cover - debug sugar
        return f"VirtualClock(t={self._t:.6f})"


class WallClock:
    """Monotonic wall time for real serving loops and benchmarks."""

    def now(self) -> float:
        return time.monotonic()

    def __repr__(self) -> str:  # pragma: no cover - debug sugar
        return "WallClock()"
