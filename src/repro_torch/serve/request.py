"""Request/response datatypes and the batching compatibility key (the
JAX package's `repro/serve/request.py`, on the port's plans).

Two requests may share one padded batch — and therefore one set of the
paper's 2K|E| exchange rounds — only when they would run the *same*
memoized plan entry (one CUDA graph per bucket on the card).
:func:`compat_key` captures that as a frozen :class:`CompatKey` over
``(operator, kind, method, K/n_iters, tau)`` plus the remaining solver
kwargs, canonicalized by the SAME function the
`ExecutionPlan.compiled_solve` memo key uses
(:func:`repro_torch.dist.operator.canonical_solve_items`), so
"compatible" in the queue and "one memoized entry" in the plan cache can
never drift apart.  A jacobi solve never rides a chebyshev apply batch
because their keys differ in `kind`/`method`; two jacobi solves at
different `tau` differ in `tau`; same story for `n_iters`, `l2_budget`,
array-valued kwargs, everything.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ..dist.operator import canonical_solve_items

#: Plan kinds the engine serves.  "solve" additionally needs a method.
APPLY_KINDS = ("apply", "apply_adjoint", "apply_gram")
KINDS = APPLY_KINDS + ("solve",)


@dataclasses.dataclass(frozen=True)
class CompatKey:
    """Batching compatibility: requests coalesce iff their keys are equal.

    op: name of the ExecutionPlan in the engine's registry;
    kind: one of :data:`KINDS`; method: Section-V solver method (None for
    the apply kinds); order: the shared round count — the plan's K for
    apply kinds, n_iters (or the plan's K default) for solves; tau: the
    rational-filter sugar (None when not passed); extra: the remaining
    solver kwargs as `canonical_solve_items` tuples.
    """

    op: str
    kind: str
    method: Optional[str] = None
    order: int = 0
    tau: Optional[float] = None
    #: Halo-exchange wire precision of the plan ("f32" | "bf16" | "int8").
    #: Mixed-precision requests must never coalesce with f32 ones — they
    #: run different exchanges AND answer with different accuracy.
    exchange: str = "f32"
    #: Partition identity: "banded" for the ring plans, the
    #: GeneralPartition content fingerprint otherwise.  Plans sharded by
    #: different partitions run different exchanges and must never
    #: coalesce.
    partition: str = "banded"
    #: Fault-injection identity (`repro_torch.dist.faults.fault_key`):
    #: "none" for clean plans.  A fault-injected plan runs a different
    #: exchange AND answers with degraded accuracy, so its requests must
    #: never coalesce with (or share memoized entries with) clean ones.
    faults: str = "none"
    extra: Tuple[Tuple[str, Any], ...] = ()

    def label(self) -> str:
        """Compact human-readable form for metrics/log output."""
        parts = [self.op, self.kind]
        if self.method:
            parts.append(self.method)
        parts.append(f"order={self.order}")
        if self.exchange != "f32":
            parts.append(f"exchange={self.exchange}")
        if self.partition != "banded":
            parts.append(f"partition={self.partition}")
        if self.faults != "none":
            parts.append(f"faults={self.faults}")
        if self.tau is not None:
            parts.append(f"tau={self.tau}")
        parts += [f"{k}={v}" for k, v in self.extra]
        return ":".join(parts)


def _plan_partition(plan) -> str:
    """Partition identity for the compat key: the GeneralPartition content
    fingerprint when present, else the plan's partition family name."""
    return str(plan.info.get("partition_fingerprint")
               or plan.info.get("partition", "banded"))


def compat_key(op_name: str, plan, kind: str, method: Optional[str],
               solve_kwargs: Optional[Dict[str, Any]] = None) -> CompatKey:
    """Build the :class:`CompatKey` for one request against `plan`.

    Validation lives here so `ServeEngine.submit` rejects malformed
    requests at admission (unknown kind, solve without a method, method
    on a non-solve kind, `history=` which has no per-request unpacking).
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; available: {KINDS}")
    kwargs = dict(solve_kwargs or {})
    if kind != "solve":
        if method is not None or kwargs:
            raise ValueError(
                f"kind {kind!r} takes no method/solver kwargs "
                f"(got method={method!r}, kwargs={sorted(kwargs)})")
        return CompatKey(op=op_name, kind=kind, order=int(plan.K),
                         exchange=plan.info.get("exchange_dtype", "f32"),
                         partition=_plan_partition(plan),
                         faults=plan.info.get("fault_key", "none"))
    if method is None:
        raise ValueError("kind='solve' requires method=")
    if kwargs.get("history"):
        raise ValueError(
            "history=True is not servable: iterate histories have no "
            "per-request unpacking — call plan.solve directly")
    order = kwargs.get("n_iters")
    order = int(order) if order is not None else int(plan.K)
    tau = kwargs.get("tau")
    tau = float(tau) if tau is not None else None
    extra = canonical_solve_items(
        {k: v for k, v in kwargs.items() if k not in ("n_iters", "tau")})
    return CompatKey(op=op_name, kind=kind, method=method, order=order,
                     tau=tau, extra=extra,
                     exchange=plan.info.get("exchange_dtype", "f32"),
                     partition=_plan_partition(plan),
                     faults=plan.info.get("fault_key", "none"))


@dataclasses.dataclass(frozen=True)
class Response:
    """One answered request: the unpacked result row + its timeline.

    Every admitted request completes with exactly one Response — either a
    result (``error is None``) or an error outcome: ``"rejected: ..."``
    (admission refused at a full queue), ``"expired: ..."`` (per-request
    deadline passed before dispatch) or ``"dispatch: ..."`` (the batch's
    plan entry raised; only that batch fails, the engine stays
    serviceable).  ``value`` is None on error responses.
    """

    id: int
    key: CompatKey
    value: Any                 # tensor, the request's row of the batch
    t_arrival: float
    t_dispatch: float
    t_complete: float
    bucket: int                # padded batch size it rode
    occupancy: int             # real requests in that batch
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def rejected(self) -> bool:
        """Admission-rejected (the retry/backoff hook's trigger)."""
        return self.error is not None and self.error.startswith("rejected")

    @property
    def latency(self) -> float:
        return self.t_complete - self.t_arrival

    @property
    def queue_delay(self) -> float:
        return self.t_dispatch - self.t_arrival


class PendingError(RuntimeError):
    """`ServeFuture.result()` before the engine dispatched the batch."""


class RequestFailed(RuntimeError):
    """`ServeFuture.result()` on a request that completed with an error
    Response (rejected / expired / dispatch failure).  The full error
    Response stays readable via `ServeFuture.response`."""


class ServeFuture:
    """Single-threaded future resolved by the engine's dispatch.

    The engine is cooperative (no threads): a pending future never
    blocks — drive the engine (`poll` / `run_until_idle` / `flush`)
    until :meth:`done`, then read :meth:`result`.
    """

    __slots__ = ("request_id", "_response")

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._response: Optional[Response] = None

    def done(self) -> bool:
        return self._response is not None

    def _resolve(self, response: Response) -> None:
        if self._response is not None:
            raise RuntimeError(
                f"request {self.request_id} resolved twice — a batch "
                "unpacking bug (each request must be answered exactly "
                "once)")
        self._response = response

    @property
    def response(self) -> Response:
        if self._response is None:
            raise PendingError(
                f"request {self.request_id} is still queued; drive the "
                "engine (poll()/run_until_idle()/flush()) before reading")
        return self._response

    def result(self) -> Any:
        resp = self.response
        if resp.error is not None:
            raise RequestFailed(
                f"request {self.request_id} failed: {resp.error}")
        return resp.value


@dataclasses.dataclass
class Request:
    """Internal queue entry (one submit).

    `deadline` is the ABSOLUTE completion deadline (engine-clock seconds;
    None = wait forever): a request still queued past it completes with
    an ``"expired"`` error Response instead of riding a batch."""

    id: int
    key: CompatKey
    signal: Any
    t_arrival: float
    future: ServeFuture
    deadline: Optional[float] = None
