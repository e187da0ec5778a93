"""Continuous-batching serving engine over memoized ExecutionPlan entries
(the JAX package's `repro/serve/engine.py`, on the port's plans).

Arriving filter/solve requests are admitted into per-:class:`CompatKey`
FIFO queues, coalesced into dynamic batches, padded to a fixed set of
bucket sizes, dispatched onto the plan's memoized
``compiled()/compiled_solve()`` entries (one (B, N) call — B signals
share one set of the paper's 2K|E| exchange rounds; on a `cuda` plan on
the card, one replay of the bucket's captured CUDA graph,
`repro_torch.dist.capture`), and unpacked back to per-request futures.
The card only ever sees the fixed bucket signatures; the dynamic part
(who rides which batch) lives entirely on the host side of the queue.

Scheduling policy (deterministic, single-threaded, clock-injected):

* **batch-full flush** — a key whose queue reaches the largest bucket
  dispatches immediately at :meth:`submit` time.
* **deadline flush** — :meth:`poll` dispatches every key whose OLDEST
  request has waited ``max_wait`` seconds; due keys go in
  oldest-request-first order and a flushed key drains completely (in
  largest-bucket chunks), so no admitted request ever waits more than
  ``max_wait`` past its arrival before dispatch — the starvation bound
  `tests/test_serving.py` asserts.
* **bucket choice** — smallest bucket >= group size; zero-padded slots
  are counted as ``padding_waste`` by the accounter.

Time comes exclusively from the injected :mod:`~repro_torch.serve.clock`:
virtual in tests (every decision reproducible without sleeping), wall in
production loops and ``chip_smoke.py``'s wall-clock replays.

**Plans over more than one rank.**  The JAX package is one
controller program over all shards; a sharded plan of the port runs one
process per rank, each with its own engine, and every rank must run the
same batches in the same order, or the ranks post different exchanges
and hang.  The clock decides how they agree:

* **lockstep** — a clock with ``advance_to`` (a :class:`VirtualClock`
  that every rank drives the same way): every rank submits the same
  requests and its own engine makes the same decisions.
* **leader and followers** — any other clock (:class:`WallClock` by
  default).  Rank 0 of the plans' group is the leader: the only rank
  that takes :meth:`submit`, :meth:`poll` and :meth:`flush`, and the
  owner of the queues, the clock, the metrics and the futures.  At each
  dispatch, once expiry and packing have succeeded, it broadcasts one
  header (op, kind, method, solve kwargs, bucket, occupancy) and the
  packed batch over the group (`dist.comm.broadcast_dispatch`), then
  calls the entry as every rank does.  Every other rank is a follower
  and calls :meth:`follow`, which runs the same entry on each batch it
  receives, drops the output (a sharded plan returns the global result
  on every rank, so the leader's output is what it serves) and returns
  the number of batches it ran once the leader calls :meth:`close`.
  The scheduling policy above stays the leader's alone; a dispatch on a
  one-rank plan is not broadcast.  The broadcasts are not exchange
  rounds: `dist.comm.counting` counts a served batch's K rounds and
  byte model as in lockstep.  A follower logs an exception of its own
  entry and goes on with the next header; recovering a group whose
  exchange broke off (a rank gone mid-round) is out of scope.

All of an engine's multi-rank plans share one group (else construction
raises ValueError), and in either mode every rank calls :meth:`warm`
together when it is called at all.
"""
from __future__ import annotations

import itertools
import logging
import time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from ..dist import comm
from .batching import bucket_for, pack_batch, unpack_batch
from .clock import WallClock
from .metrics import BatchRecord, LatencyAccounter
from .request import (CompatKey, Request, Response, ServeFuture, compat_key)

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 8, 64)


class _Group:
    """Per-CompatKey admission queue + the kwargs to rebuild its callable."""

    __slots__ = ("queue", "method", "solve_kwargs")

    def __init__(self, method: Optional[str],
                 solve_kwargs: Optional[Dict[str, Any]]):
        self.queue: Deque[Request] = deque()
        self.method = method
        self.solve_kwargs = dict(solve_kwargs or {})


def _serving_group(plans: Mapping[str, Any]):
    """The one process group of the multi-rank plans among `plans` (None
    if there is none); raises ValueError if they span two groups."""
    groups = []
    for p in plans.values():
        g = getattr(p, "group", None)
        if g is not None and all(g is not h for h in groups):
            groups.append(g)
    if len(groups) > 1:
        raise ValueError(
            f"the multi-rank plans of one engine must share one process "
            f"group; these span {len(groups)}")
    return groups[0] if groups else None


class ServeEngine:
    """Coalesces compatible requests onto shared bucketed launches.

    plans: one :class:`~repro_torch.dist.operator.ExecutionPlan` or a mapping
    ``{name: plan}`` (requests address operators by name; the default
    single-plan form registers under ``"default"``).  buckets: the
    batch sizes the entries serve (sorted, deduped).  max_wait: seconds a
    request may queue before a deadline flush.  clock: any ``now()``
    provider (default :class:`WallClock`; over a plan of more than one
    rank it picks lockstep or leader and followers, see the module
    docstring, and `role` says which: ``"single"``, ``"lockstep"``,
    ``"leader"`` or ``"follower"``).  sync_results=True waits on each
    dispatched batch's output stream so ``t_complete`` is an honest
    latency sample (the one deliberate host sync, at the queue boundary:
    the counterpart of ``jax.block_until_ready``); False leaves results
    in flight on the card, which is the right mode under a virtual clock
    where execution time is modelled as zero anyway.

    Failure containment (every admitted request is answered exactly
    once, as a result or an error Response — see
    :class:`~repro.serve.request.Response`):

    * ``max_queue_depth`` bounds total admitted-but-undispatched
      requests; at the bound, :meth:`submit` returns a future already
      resolved with a ``"rejected"`` error Response (the
      `loadgen.RetryPolicy` backoff hook's trigger) instead of growing
      the queue without bound.
    * ``submit(..., deadline=d)`` gives one request d seconds (engine
      clock, from arrival) to dispatch; past it the request completes
      with an ``"expired"`` error Response — at the next :meth:`poll`
      sweep or at dispatch time, whichever comes first.
    * an exception inside one batch's plan entry fails ONLY that
      batch: each rider completes with a ``"dispatch"`` error Response,
      the exception does not propagate out of submit()/poll(), and the
      engine keeps serving subsequent batches.
    """

    def __init__(self, plans, *, buckets=DEFAULT_BUCKETS,
                 max_wait: float = 0.005, clock=None,
                 sync_results: bool = True,
                 accounter: Optional[LatencyAccounter] = None,
                 max_queue_depth: Optional[int] = None):
        if not isinstance(plans, Mapping):
            plans = {"default": plans}
        if not plans:
            raise ValueError("ServeEngine needs at least one plan")
        self.plans = dict(plans)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(
                f"buckets must be positive ints, got {buckets!r}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.max_wait = float(max_wait)
        if max_queue_depth is not None and int(max_queue_depth) < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}")
        self.max_queue_depth = (int(max_queue_depth)
                                if max_queue_depth is not None else None)
        self.clock = clock if clock is not None else WallClock()
        self.group = _serving_group(self.plans)
        if self.group is None:
            self.role = "single"
        elif getattr(self.clock, "advance_to", None) is not None:
            self.role = "lockstep"
        else:
            self.role = ("leader" if dist.get_rank(self.group) == 0
                         else "follower")
        self.sync_results = bool(sync_results)
        self.metrics = accounter if accounter is not None \
            else LatencyAccounter()
        self._groups: "OrderedDict[CompatKey, _Group]" = OrderedDict()
        self._ids = itertools.count()
        self._closed = False
        #: the leader's broadcasts: how many, and their host seconds
        self.n_broadcasts = 0
        self.broadcast_s = 0.0

    def _serves(self, call: str) -> None:
        if self.role == "follower":
            raise RuntimeError(
                f"{call}() on rank {dist.get_rank(self.group)} of the "
                "plans' group: rank 0 serves under a clock without "
                "advance_to(); this rank calls follow()")
        if self._closed:
            raise RuntimeError(f"{call}() on a closed engine")

    # -- admission -----------------------------------------------------------
    def submit(self, signal, *, op: str = "default", kind: str = "apply",
               method: Optional[str] = None, deadline: Optional[float] = None,
               **solve_kwargs) -> ServeFuture:
        """Admit one request; returns its (cooperative) future.

        `signal` is ONE unbatched request — ``(N,)`` for
        apply/apply_gram/solve, ``(eta, N)`` for apply_adjoint; the batch
        axis belongs to the engine.  Compatible requests (same
        :func:`compat_key`) coalesce; a full largest bucket dispatches
        inline before returning.

        ``deadline`` (seconds from now, engine clock) bounds this
        request's queue wait — expired requests complete with an error
        Response.  At a full queue (``max_queue_depth``) the returned
        future is already resolved with a ``"rejected"`` error Response.
        """
        self._serves("submit")
        if op not in self.plans:
            raise KeyError(
                f"unknown operator {op!r}; registered: "
                f"{sorted(self.plans)}")
        if deadline is not None and deadline < 0:
            raise ValueError(f"deadline must be >= 0, got {deadline}")
        plan = self.plans[op]
        key = compat_key(op, plan, kind, method, solve_kwargs)
        signal = torch.as_tensor(signal)
        self._validate_shape(plan, kind, signal)
        now = self.clock.now()
        rid = next(self._ids)
        future = ServeFuture(rid)
        if (self.max_queue_depth is not None
                and self.pending_count >= self.max_queue_depth):
            self.metrics.record_rejected(rid, now)
            future._resolve(Response(
                id=rid, key=key, value=None, t_arrival=now, t_dispatch=now,
                t_complete=now, bucket=0, occupancy=0,
                error=f"rejected: queue depth {self.pending_count} at "
                      f"max_queue_depth={self.max_queue_depth}"))
            logger.debug("serve reject %s: queue full", key.label())
            return future
        group = self._groups.get(key)
        if group is None:
            group = self._groups.setdefault(
                key, _Group(method, solve_kwargs))
        req = Request(id=rid, key=key, signal=signal, t_arrival=now,
                      future=future,
                      deadline=(now + deadline if deadline is not None
                                else None))
        self.metrics.record_arrival(req.id, now)
        group.queue.append(req)
        while len(group.queue) >= self.buckets[-1]:
            self._dispatch_chunk(key, group)
        return req.future

    def _validate_shape(self, plan, kind: str, signal) -> None:
        n = self._plan_n(plan)
        want_ndim = 2 if kind == "apply_adjoint" else 1
        if signal.ndim != want_ndim:
            raise ValueError(
                f"kind {kind!r} serves ONE unbatched request of rank "
                f"{want_ndim} (the engine owns the batch axis); got "
                f"shape {tuple(signal.shape)}")
        if n is not None and signal.shape[-1] != n:
            raise ValueError(
                f"signal has N={signal.shape[-1]}, plan expects N={n}")
        if kind == "apply_adjoint" and signal.shape[0] != plan.eta:
            raise ValueError(
                f"adjoint request must be (eta, N) = ({plan.eta}, {n}); "
                f"got {tuple(signal.shape)}")

    @staticmethod
    def _plan_n(plan) -> Optional[int]:
        """N of the plan's P (a tensor or an array); None for a matvec
        closure (a CSR graph's), whose requests are not checked."""
        if callable(plan.op.P):
            return None
        return int(plan.op.P.shape[0])

    # -- scheduling ----------------------------------------------------------
    @property
    def pending_count(self) -> int:
        return sum(len(g.queue) for g in self._groups.values())

    def next_deadline(self) -> Optional[float]:
        """Earliest instant any queued group becomes due (None if idle)."""
        heads = [g.queue[0].t_arrival for g in self._groups.values()
                 if g.queue]
        return min(heads) + self.max_wait if heads else None

    def _expire(self, req, now: float) -> None:
        """Answer one deadline-passed request with an error Response."""
        req.future._resolve(Response(
            id=req.id, key=req.key, value=None, t_arrival=req.t_arrival,
            t_dispatch=now, t_complete=now, bucket=0, occupancy=0,
            error=f"expired: deadline {req.deadline:.6f} passed at "
                  f"{now:.6f} before dispatch"))
        self.metrics.record_expired(req.id, now)
        logger.debug("serve expire request %d (%s)", req.id,
                     req.key.label())

    def _sweep_expired(self, now: float) -> int:
        """Resolve every queued request whose deadline has passed."""
        expired = 0
        for group in self._groups.values():
            if not group.queue:
                continue
            live = deque()
            dropped = 0
            for req in group.queue:
                if req.deadline is not None and now > req.deadline:
                    self._expire(req, now)
                    dropped += 1
                else:
                    live.append(req)
            if dropped:
                group.queue = live
                expired += dropped
        return expired

    def poll(self) -> int:
        """Deadline flush: dispatch every due group; returns #requests
        served.  Due groups drain oldest-request-first (FIFO fairness
        across keys), each in largest-bucket chunks.  Queued requests
        whose per-request deadline has passed are answered with an
        ``"expired"`` error Response first — they never ride a batch."""
        self._serves("poll")
        now = self.clock.now()
        self._sweep_expired(now)
        # dueness is `now >= arrival + max_wait` — the SAME float
        # expression next_deadline() returns, so advancing a virtual
        # clock exactly to a reported deadline always flushes it
        # ((now - arrival) >= max_wait can round the other way and
        # livelock the deadline-hopping drivers)
        due = [(g.queue[0].t_arrival, key) for key, g in
               self._groups.items()
               if g.queue and now >= g.queue[0].t_arrival + self.max_wait]
        served = 0
        for _, key in sorted(due, key=lambda p: p[0]):
            group = self._groups[key]
            while group.queue:
                served += self._dispatch_chunk(key, group)
        return served

    def flush(self) -> int:
        """Dispatch everything pending regardless of deadlines."""
        self._serves("flush")
        served = 0
        for key in list(self._groups):
            group = self._groups[key]
            while group.queue:
                served += self._dispatch_chunk(key, group)
        return served

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        """Virtual-clock driver: hop the clock deadline-to-deadline until
        every admitted request is answered.  Requires a clock with
        ``advance_to`` (the virtual one); wall-clock loops call
        :meth:`poll` on their own cadence instead."""
        advance_to = getattr(self.clock, "advance_to", None)
        if advance_to is None:
            raise TypeError(
                "run_until_idle needs a clock with advance_to() (e.g. "
                "VirtualClock); wall-clock serving loops drive poll()")
        served = 0
        for _ in range(max_steps):
            deadline = self.next_deadline()
            if deadline is None:
                return served
            advance_to(deadline)
            served += self.poll()
        raise RuntimeError(
            f"run_until_idle did not drain in {max_steps} steps")

    # -- leader and followers ------------------------------------------------
    def follow(self) -> int:
        """A follower's loop: run every batch the leader broadcasts, in
        order, through the same entry, until the leader's :meth:`close`;
        returns the number of batches run.  An exception of an entry is
        logged and the loop goes on with the next header."""
        if self.role != "follower":
            raise RuntimeError(
                f"follow() is for the ranks other than 0 of a multi-rank "
                f"group under a clock without advance_to(); this engine "
                f"is {self.role!r}")
        ran = 0
        device = next(p.device for p in self.plans.values()
                      if p.group is not None)
        while True:
            header, batch = comm.receive_dispatch(self.group, device)
            if batch is None:
                return ran
            ran += 1
            op, kind = header["op"], header["kind"]
            try:
                key = compat_key(op, self.plans[op], kind,
                                 header["method"], header["solve_kwargs"])
                self._callable(key, _Group(header["method"],
                                           header["solve_kwargs"]))(batch)
            except Exception:  # noqa: BLE001 — contained by design
                logger.exception(
                    "follower rank %d: batch %d (%s:%s, bucket=%d) failed; "
                    "waiting for the next header",
                    dist.get_rank(self.group), ran, op, kind,
                    header["bucket"])

    def close(self) -> int:
        """On the leader: dispatch what is still queued, then send the
        followers the stop that ends their :meth:`follow`; returns the
        number of requests the last flush answered.  Later calls do
        nothing; so does close() on any other engine."""
        if self.role != "leader" or self._closed:
            return 0
        served = self.flush()
        self._closed = True
        comm.broadcast_dispatch({"stop": True}, None, self.group)
        return served

    def _broadcast(self, key: CompatKey, group: _Group, bucket: int,
                   n_valid: int, batch) -> None:
        t0 = time.perf_counter()
        comm.broadcast_dispatch(
            {"op": key.op, "kind": key.kind, "method": group.method,
             "solve_kwargs": group.solve_kwargs, "bucket": bucket,
             "n_valid": n_valid}, batch, self.group)
        self.broadcast_s += time.perf_counter() - t0
        self.n_broadcasts += 1

    # -- dispatch ------------------------------------------------------------
    def _callable(self, key: CompatKey, group: _Group):
        plan = self.plans[key.op]
        if key.kind == "solve":
            return plan.compiled_solve(group.method, **group.solve_kwargs)
        return plan.compiled(key.kind)

    def _dispatch_chunk(self, key: CompatKey, group: _Group) -> int:
        """Pack, launch and unpack the oldest largest-bucket-or-fewer
        requests of one group; resolves their futures.

        Deadline-passed riders are expired (error Response) instead of
        packed.  An exception from the plan entry fails exactly
        this batch: every rider completes with a ``"dispatch"`` error
        Response and the exception is contained — submit()/poll() keep
        working and later batches (same group included) dispatch
        normally.  Returns the number of requests answered."""
        take = min(len(group.queue), self.buckets[-1])
        now = self.clock.now()
        reqs = []
        expired = 0
        for _ in range(take):
            req = group.queue.popleft()
            if req.deadline is not None and now > req.deadline:
                self._expire(req, now)
                expired += 1
            else:
                reqs.append(req)
        if not reqs:
            return expired
        bucket = bucket_for(len(reqs), self.buckets)
        batch, n_valid = pack_batch([r.signal for r in reqs], bucket,
                                    device=self.plans[key.op].device)
        t_dispatch = now
        try:
            if (self.role == "leader"
                    and self.plans[key.op].group is not None):
                self._broadcast(key, group, bucket, n_valid, batch)
            fn = self._callable(key, group)
            out = fn(batch)
            if self.sync_results and out.is_cuda:
                # The one deliberate host sync, at the queue boundary: a
                # batch's completion instant IS the latency sample every
                # response in it reports.
                torch.cuda.current_stream(out.device).synchronize()
            t_complete = self.clock.now()
            rows = unpack_batch(out, n_valid)
        except Exception as exc:  # noqa: BLE001 — contained by design
            t_complete = self.clock.now()
            msg = f"dispatch: {type(exc).__name__}: {exc}"
            logger.exception(
                "serve dispatch %s failed (bucket=%d, occupancy=%d); "
                "failing this batch's %d request(s), engine stays up",
                key.label(), bucket, n_valid, len(reqs))
            for req in reqs:
                req.future._resolve(Response(
                    id=req.id, key=key, value=None,
                    t_arrival=req.t_arrival, t_dispatch=t_dispatch,
                    t_complete=t_complete, bucket=bucket,
                    occupancy=n_valid, error=msg))
                self.metrics.record_failed(req.id, t_complete)
            return expired + len(reqs)
        for req, row in zip(reqs, rows):
            resp = Response(id=req.id, key=key, value=row,
                            t_arrival=req.t_arrival,
                            t_dispatch=t_dispatch,
                            t_complete=t_complete, bucket=bucket,
                            occupancy=n_valid)
            req.future._resolve(resp)
            self.metrics.record_served(req.id, t_dispatch, t_complete)
        self.metrics.record_batch(BatchRecord(
            key=key, bucket=bucket, occupancy=n_valid,
            t_dispatch=t_dispatch, t_complete=t_complete))
        logger.debug("serve dispatch %s: bucket=%d occupancy=%d",
                     key.label(), bucket, n_valid)
        return expired + n_valid

    # -- warmup --------------------------------------------------------------
    def warm(self) -> int:
        """Capture (or first-call) every (registered kind, bucket)
        signature of every plan so first requests are served at
        steady-state latency.  Apply kinds only (solve signatures appear
        with their kwargs at first dispatch); returns the number of
        warmed entries."""
        n = 0
        for plan in self.plans.values():
            n += len(plan.bucketed_callables(self.buckets,
                                             kinds=("apply",), warm=True))
        return n
