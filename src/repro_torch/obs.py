"""Spans and counters of the port, on the device trace's clock.

A span is a named interval of the host's work: its start and end in
Unix-time nanoseconds (`time.time_ns`, the clock that `torch.profiler`
converts its own timestamps to, so a span lands in an exported trace at
``(ns - baseTimeNanoseconds) / 1000`` microseconds: :func:`trace_us`)
and the index of the span open around it (its cause).  Spans are kept in
memory, in the order they opened; counters are a flat ``{name: int}``.
Nothing is written out: the benchmark's per-layer metrics and the tests
read :func:`spans` and :func:`counters`.

Two kinds of span:

* set-up spans (``plan.pack``, ``entry.capture``, ``solver.setup``) are
  always recorded: a handful a process, each around seconds of work;
* per-call spans (``entry.call``, ``entry.replay``) are recorded only
  while a `torch.profiler` session records
  (``torch.autograd.profiler._is_profiler_enabled``, the module global
  that the profiler sets when its trace starts, for any activities), so a
  call outside one pays one attribute read for them.

The per-call counters (``entry.replays``, ``kernels.replayed_launches``)
move with the per-call spans, over the traced window.  The kernels' own
launch counters live on their wrappers; this module is their one
registry (:func:`kernel_counters`, :func:`launch_counts`,
:func:`launch_delta`).  Spans nest on one thread: the port calls its
entries from one.
"""
from __future__ import annotations

import contextlib
import time
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Tuple)


class Span(NamedTuple):
    """One closed span, as the readers see it."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


# Each span as a plain tuple (name, start_ns, parent index) and its end
# in a list beside them (None while open): the garbage collector
# stops tracking a tuple of numbers and a string at its first pass, so a
# traced window's thousands of spans never grow the generations it walks
# (an object a span cost a traced call about 2 us more in collections on
# the H100 machine's host), and closing a span writes one number.
_SPANS: List[tuple] = []
_ENDS: List[Optional[int]] = []
#: Indices of the open spans, innermost last.
_OPEN: List[int] = []
_COUNTERS: Dict[str, int] = {}
_now = time.time_ns


def begin(name: str) -> int:
    """Open a span inside the innermost open one; returns its index."""
    t = _now()
    i = len(_SPANS)
    _SPANS.append((name, t, _OPEN[-1] if _OPEN else None))
    _ENDS.append(None)
    _OPEN.append(i)
    return i


def end(i: int) -> None:
    """Close span `i`.  Spans still open inside it (left open by an
    error between a :func:`begin` and its :func:`end`) stay unclosed and
    stop being parents."""
    _ENDS[i] = _now()
    while _OPEN.pop() != i:
        pass


@contextlib.contextmanager
def span(name: str) -> Iterator[int]:
    i = begin(name)
    try:
        yield i
    finally:
        end(i)


def get(i: int) -> Span:
    """Span `i` (closed)."""
    name, start, parent = _SPANS[i]
    return Span(name, start, _ENDS[i], parent)


def spans(name: Optional[str] = None) -> List[Span]:
    """The closed spans called `name` (every closed span for None), in
    the order they opened."""
    return [get(i) for i, t in enumerate(_SPANS)
            if _ENDS[i] is not None and (name is None or t[0] == name)]


def add(name: str, n: int = 1) -> None:
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    return dict(_COUNTERS)


def reset() -> None:
    """Forget every span and counter (tests)."""
    _SPANS.clear()
    _ENDS.clear()
    _OPEN.clear()
    _COUNTERS.clear()


def trace_us(s: Span, base_ns: int) -> Tuple[float, float]:
    """`s` as (start, end) in the microseconds of an exported trace whose
    ``baseTimeNanoseconds`` is `base_ns`."""
    return (s.start_ns - base_ns) / 1e3, (s.end_ns - base_ns) / 1e3


# ---------------------------------------------------------------------------
# The kernels' launch counters
# ---------------------------------------------------------------------------
def kernel_counters() -> Tuple[Callable, ...]:
    """Every kernel wrapper of the port that counts its launches (its
    ``launches`` attribute; it moves on a card only)."""
    from .kernels.bcsr_spmv import sliced_ell_spmv, sliced_ell_spmv_accumulate
    from .kernels.cheb_step import cheb_order, cheb_step
    from .kernels.cheb_sweep import cheb_sweep, jacobi_sweep
    from .kernels.flash_attention import (flash_attention_ffma,
                                          flash_attention_wgmma)
    from .kernels.jacobi_step import jacobi_round, jacobi_step
    from .kernels.soft_threshold import ista_shrink

    return (sliced_ell_spmv, sliced_ell_spmv_accumulate, cheb_step,
            cheb_order, cheb_sweep, jacobi_step, jacobi_round, jacobi_sweep,
            ista_shrink, flash_attention_wgmma, flash_attention_ffma)


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches so far}."""
    return {k.__name__: k.launches for k in kernel_counters()}


def launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    """The launches made since `before` (:func:`launch_counts`), by kernel,
    leaving out the kernels that made none."""
    after = launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}
