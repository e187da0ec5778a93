"""Communication of the sharded plans, and its count (Section IV-B/C made
measurable).

The paper's systems claim is that one distributed application of a union
of graph multipliers of order K costs ``2K|E|`` messages: per Chebyshev
order every vertex sends one scalar to every neighbour (4K|E| for the Gram
operator, length-eta messages for the adjoint).  The JAX package measures
this by walking a plan's jaxpr.  The port has no jaxpr, so it counts where
the messages are sent: every send, receive and gather of a sharded plan
goes through this module, which tallies what really ran while a
:func:`counting` context is open on the rank.

* :func:`offset_exchange` — one exchange round: for each ring offset d,
  rank s sends a tile to s + d and receives one from s − d, always over
  the full ring (a rank with nothing to send at an offset sends a tile
  that meets zero couplings, as the JAX package's ``ppermute`` perms
  do).  Every send and receive of the round is posted at once and
  returned pending, so the caller can launch its interior product before
  it waits.  Counted as one ``ppermute`` per offset, which the plans
  declare as ``exchange_collectives_per_round``, as in the JAX package.
  The banded plans' round is the offsets (1, −1), i.e. (1, S − 1): the
  tail tile to s + 1, the head tile to s − 1
  (:data:`DIRECTIONS_PER_ROUND` tiles).
* :func:`all_gather` — one round of the ``allgather`` backend.
* :func:`assemble` — gathers a plan's output rows onto every rank.  It is
  the counterpart of shard_map's in and out specs, which the JAX
  package's measurement never sees, so it is tallied apart (``assembly``,
  with its own host time) and kept out of the rounds and the byte counts.

Transport: with an NCCL group tensors go card to card.  Gloo sends and
receives only host tensors, so with a gloo group and CUDA tensors every
tile is copied to pinned host memory and back, explicitly and on every
call; a plan reports it as ``info["transport"] == "gloo-host-staged"``
(:func:`transport`).

:class:`CommStats` keeps the data model of the JAX package's
``repro.dist.commstats.CommStats``; :func:`plan_comm_stats`,
:func:`solve_comm_stats` and :func:`verify_message_scaling` run a plan's
methods under :func:`counting` instead of tracing them.  They run the
plan, so every rank of its group must call them together.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor

#: Tiles of a banded plan's round: offsets (1, −1), one ``ppermute``
#: each.
DIRECTIONS_PER_ROUND = 2


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One communication site, aggregated over its executions.

    count: executions per plan call (per rank); elems / nbytes: payload
    this rank sends per execution; perm: for ``ppermute`` (one direction
    of the ring exchange), the (src, dst) pairs — distinct perms are
    distinct exchange directions.
    """

    primitive: str
    count: int
    elems: int
    nbytes: int
    perm: Optional[Tuple] = None


@dataclasses.dataclass(frozen=True)
class CommStats:
    """Counted communication of one plan call on one rank.

    `collectives` are the exchange calls (``ppermute``, ``all_gather``);
    `assembly` the calls that gathered the output rows, which are neither
    rounds nor exchange bytes.  `batch` is the number of signals the call
    carried: rounds are batch-invariant (B signals share the K rounds), and
    the per-signal accessors divide by it.
    """

    collectives: Tuple[CollectiveCall, ...]
    n_shards: int
    batch: int = 1
    ppermutes_per_round: int = DIRECTIONS_PER_ROUND
    assembly: Tuple[CollectiveCall, ...] = ()

    @property
    def n_collectives(self) -> int:
        """Exchange executions per call (per rank)."""
        return sum(c.count for c in self.collectives)

    @property
    def exchange_rounds(self) -> int:
        """Neighbour-exchange rounds == matvec applications of P.

        The ring backends send one ``ppermute`` per offset per matvec
        and ``allgather`` one ``all_gather``: the ``ppermute`` tally over
        the plan-declared divisor (`ppermutes_per_round`, from plan.info's
        ``exchange_collectives_per_round``), plus the gathers.  The
        counter tallies every offset of every round at the call site, at
        two shards too, where the banded plan's two tiles go to one peer;
        so the JAX package's fallbacks for a plan that declares no divisor
        (grouping its jaxpr's perms) have nothing to do here.
        """
        pp = sum(c.count for c in self.collectives
                 if c.primitive == "ppermute")
        ag = sum(c.count for c in self.collectives
                 if c.primitive == "all_gather")
        return (pp // self.ppermutes_per_round if pp else 0) + ag

    @property
    def bytes_per_shard(self) -> int:
        """Exchange payload bytes this rank sends per call."""
        return sum(c.count * c.nbytes for c in self.collectives)

    @property
    def bytes_per_round(self) -> float:
        """Average exchange bytes per round: ``4 * sum(h_k)`` in f32 at
        B = 1, the tiles of every offset (``2 * h * 4`` for a banded
        plan)."""
        r = self.exchange_rounds
        return self.bytes_per_shard / r if r else 0.0

    @property
    def total_bytes(self) -> int:
        """Exchange bytes per call over all shards."""
        return self.bytes_per_shard * self.n_shards

    def paper_messages(self, n_edges: int) -> int:
        """Sensor-network message count: counted rounds x 2|E|, the 2K|E|
        of `op.message_counts` for a faithful Algorithm 1."""
        return self.exchange_rounds * 2 * n_edges

    def paper_messages_per_signal(self, n_edges: int) -> float:
        """Amortized message count per signal: 2K|E| / batch."""
        return self.paper_messages(n_edges) / self.batch

    def summary(self) -> Dict[str, Any]:
        return {
            "n_shards": self.n_shards,
            "batch": self.batch,
            "n_collectives": self.n_collectives,
            "exchange_rounds": self.exchange_rounds,
            "bytes_per_shard": self.bytes_per_shard,
            "total_bytes": self.total_bytes,
            "collectives": [dataclasses.asdict(c) for c in self.collectives],
            "assembly": [dataclasses.asdict(c) for c in self.assembly],
        }


@dataclasses.dataclass(frozen=True)
class Event:
    """One communication call as it ran on this rank, in call order.

    perm: for ``ppermute``, the (src, dst) pairs of the whole group, as
    every rank posts them; sends: the pairs this rank itself sent, in
    group ranks (what `repro_torch.analysis.checks` gathers over the
    ranks to hold each exchange to a complete bijection); group: the
    process group it ran in.
    """

    primitive: str
    perm: Optional[Tuple]
    sends: Tuple[Tuple[int, int], ...]
    group: Any = dataclasses.field(default=None, compare=False, repr=False)


class Recorder:
    """What ran on this rank while a :func:`counting` context was open:
    the tally of calls, the calls in order (`events`), and the host
    seconds spent posting the exchange (`post_s`: staging the tiles and
    posting the sends and receives), waiting for it (`wait_s`: receives
    and gathers, and copying back) and assembling the outputs
    (`assembly_s`)."""

    def __init__(self):
        self.tally: Dict[Tuple, int] = {}
        self.events: List[Event] = []
        self.post_s = 0.0
        self.wait_s = 0.0
        self.assembly_s = 0.0

    def add(self, primitive: str, t: Tensor, perm=None, sends=(),
            group=None) -> None:
        key = (primitive, t.numel(), t.numel() * t.element_size(), perm)
        self.tally[key] = self.tally.get(key, 0) + 1
        self.events.append(Event(primitive, perm, tuple(sends), group))

    def stats(self, n_shards: int, batch: int = 1,
              ppermutes_per_round: int = DIRECTIONS_PER_ROUND) -> CommStats:
        calls = [CollectiveCall(primitive=k[0], count=v, elems=k[1],
                                nbytes=k[2], perm=k[3])
                 for k, v in sorted(self.tally.items(),
                                    key=lambda kv: repr(kv[0]))]
        return CommStats(
            collectives=tuple(c for c in calls if c.primitive != "assembly"),
            assembly=tuple(c for c in calls if c.primitive == "assembly"),
            n_shards=n_shards, batch=batch,
            ppermutes_per_round=ppermutes_per_round)


_recorders: List[Recorder] = []


@contextlib.contextmanager
def counting() -> Iterator[Recorder]:
    """Count every exchange, gather and assembly this rank runs inside
    the block (nested contexts each count)."""
    rec = Recorder()
    _recorders.append(rec)
    try:
        yield rec
    finally:
        _recorders.remove(rec)


def _record(primitive: str, t: Tensor, perm=None, sends=(),
            group=None) -> None:
    for rec in _recorders:
        rec.add(primitive, t, perm, sends, group)


def _timed(field: str, t0: float) -> None:
    dt = time.perf_counter() - t0
    for rec in _recorders:
        setattr(rec, field, getattr(rec, field) + dt)


# ---------------------------------------------------------------------------
# Groups and transport
# ---------------------------------------------------------------------------
def resolve_group(mesh) -> Tuple[Optional[dist.ProcessGroup], int, int]:
    """(group, n_shards, rank) of a plan's ``mesh=``.

    `mesh` is a `torch.distributed` process group; None means the default
    group when one is initialized, and a 1-shard plan otherwise.  A group
    of one rank is a 1-shard plan too: the returned group is None whenever
    there is nothing to exchange.
    """
    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None, 1, 0
        mesh = dist.group.WORLD
    if not isinstance(mesh, dist.ProcessGroup):
        raise TypeError(f"mesh= takes a torch.distributed process group, "
                        f"got {type(mesh).__name__}")
    size, rank = dist.get_world_size(mesh), dist.get_rank(mesh)
    if rank < 0:
        raise ValueError("this process is not a member of the mesh group")
    return (mesh if size > 1 else None), size, rank


def transport(group: Optional[dist.ProcessGroup],
              device: torch.device) -> Optional[str]:
    """How the tiles travel: None (one shard), ``"nccl"`` (card to
    card), ``"gloo"`` (host tensors) or ``"gloo-host-staged"`` (CUDA
    tensors copied through pinned host memory on every call)."""
    if group is None:
        return None
    backend = str(dist.get_backend(group))
    if backend == "gloo" and device.type == "cuda":
        return "gloo-host-staged"
    return backend


def _staged(group, t: Tensor) -> bool:
    return t.is_cuda and str(dist.get_backend(group)) == "gloo"


def _host(*tiles: Tensor) -> List[Tensor]:
    """Pinned host copies of CUDA tiles; returns once the copies are done
    (one wait for all of them), so the tiles can be sent."""
    out = []
    for t in tiles:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
    torch.cuda.current_stream(tiles[0].device).synchronize()
    return out


def _peer(group, group_rank: int) -> int:
    return dist.get_global_rank(group, group_rank)


# ---------------------------------------------------------------------------
# The three communication calls
# ---------------------------------------------------------------------------
class PendingExchange:
    """A posted exchange round; :meth:`wait` returns the received tiles,
    one per offset in the order posted, on the tiles' device."""

    def __init__(self, works, sent, received, device):
        self._works = works
        self._sent = sent            # keeps the send buffers alive
        self._received = received
        self._device = device

    def wait(self) -> Tuple[Tensor, ...]:
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        out = tuple(r.to(self._device, non_blocking=True)
                    for r in self._received)
        self._works = self._sent = self._received = None
        _timed("wait_s", t0)
        return out


def offset_exchange(tiles: Sequence[Tensor], offsets: Sequence[int],
                    group: dist.ProcessGroup) -> PendingExchange:
    """Post one exchange round: for each k, `tiles[k]` to group rank
    s + offsets[k] and a tile of the same shape from s − offsets[k]
    (modulo the group size).  Every rank passes tiles of the same shapes.
    Nothing waits here; call ``.wait()`` on the result."""
    t0 = time.perf_counter()
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    staged = _staged(group, tiles[0])
    sent = (_host(*tiles) if staged else [t.contiguous() for t in tiles])
    received = [torch.empty(t.shape, dtype=t.dtype, pin_memory=staged,
                            device=None if staged else t.device)
                for t in sent]
    # the same order on every rank, one tag per offset: NCCL matches a
    # pair's sends and receives in order, gloo by tag (a pair can share
    # two offsets, as the banded plan's (1, 1) at two shards does)
    works = dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, t, _peer(group, (rank + d) % size), group,
                    k + 1)
         for k, (t, d) in enumerate(zip(sent, offsets))]
        + [dist.P2POp(dist.irecv, t, _peer(group, (rank - d) % size), group,
                      k + 1)
           for k, (t, d) in enumerate(zip(received, offsets))])
    for t, d in zip(tiles, offsets):
        _record("ppermute", t, tuple((i, (i + d) % size)
                                     for i in range(size)),
                sends=((rank, (rank + d) % size),), group=group)
    _timed("post_s", t0)
    return PendingExchange(works, sent, received, tiles[0].device)


def _gather_last(x: Tensor, group: dist.ProcessGroup) -> Tensor:
    """Every rank's `x` (same shape on every rank) concatenated along the
    last axis in rank order.  The parts land in one (S, ...) buffer
    (pinned when staged), which moves to x's device before the one
    reordering copy."""
    size = dist.get_world_size(group)
    staged = _staged(group, x)
    src = _host(x)[0] if staged else x.contiguous()
    buf = torch.empty((size,) + tuple(x.shape), dtype=x.dtype,
                      pin_memory=staged, device=src.device)
    dist.all_gather(list(buf.unbind(0)), src, group=group)
    buf = buf.to(x.device, non_blocking=True)
    return buf.movedim(0, -2).reshape(x.shape[:-1] + (size * x.shape[-1],))


def all_gather(x: Tensor, group: dist.ProcessGroup) -> Tensor:
    """One ``allgather`` round: (..., nl) on every rank -> (..., S * nl)."""
    t0 = time.perf_counter()
    out = _gather_last(x, group)
    _record("all_gather", x, group=group)
    _timed("wait_s", t0)
    return out


def assemble(y: Tensor, group: Optional[dist.ProcessGroup]) -> Tensor:
    """A plan's output rows (..., nl) from every rank -> (..., S * nl) on
    every rank; `y` itself when there is one shard."""
    if group is None:
        return y
    t0 = time.perf_counter()
    out = _gather_last(y, group)
    _record("assembly", y, group=group)
    _timed("assembly_s", t0)
    return out


# ---------------------------------------------------------------------------
# Counting a plan's methods
# ---------------------------------------------------------------------------
def _logical_n(plan, n: Optional[int]) -> int:
    if n is not None:
        return int(n)
    if callable(plan.op.P):
        raise ValueError("n= is needed for a closure P")
    return int(plan.op.P.shape[0])


def _count(plan, fn, batch: int) -> CommStats:
    with counting() as rec:
        fn()
    return rec.stats(int(plan.info.get("n_shards", 1)), batch,
                     plan.info.get("exchange_collectives_per_round",
                                   DIRECTIONS_PER_ROUND))


def plan_comm_stats(plan, n: Optional[int] = None,
                    batch: Optional[int] = None) -> Dict[str, CommStats]:
    """Count a plan's apply / apply_adjoint / apply_gram communication.

    Runs each method once on zero float32 signals: (n,) / (eta, n) with
    ``batch=None``, (B, n) / (B, eta, n) with ``batch=B``, which is then
    stamped on the stats (`paper_messages_per_signal`).  Every rank of
    the plan's group must call it together.
    """
    n = _logical_n(plan, n)
    lead = () if batch is None else (int(batch),)
    b = 1 if batch is None else int(batch)
    f = torch.zeros(lead + (n,), dtype=torch.float32, device=plan.device)
    a = torch.zeros(lead + (plan.op.eta, n), dtype=torch.float32,
                    device=plan.device)
    return {
        "apply": _count(plan, lambda: plan.apply(f), b),
        "apply_adjoint": _count(plan, lambda: plan.apply_adjoint(a), b),
        "apply_gram": _count(plan, lambda: plan.apply_gram(f), b),
    }


def solve_comm_stats(plan, method: str = "chebyshev",
                     n: Optional[int] = None, batch: Optional[int] = None,
                     **solve_kwargs) -> CommStats:
    """Count one ``plan.solve(y, method, **solve_kwargs)`` on a zero
    float32 signal: a Jacobi round on den(P) x = num(P) y costs deg(den)
    exchange rounds, and `SolveResult.info["exchange_rounds"]` is the
    closed form this lands on."""
    n = _logical_n(plan, n)
    lead = () if batch is None else (int(batch),)
    y = torch.zeros(lead + (n,), dtype=torch.float32, device=plan.device)
    return _count(plan, lambda: plan.solve(y, method, **solve_kwargs),
                  1 if batch is None else int(batch))


def verify_message_scaling(plan, n_edges: int, n: Optional[int] = None,
                           batch: Optional[int] = None) -> Dict[str, Any]:
    """Counted against predicted message counts for one plan.

    Compares :meth:`CommStats.paper_messages` of each method with the
    closed forms of `op.message_counts(n_edges)` (2K|E| apply and adjoint,
    4K|E| Gram) and returns both with the largest relative deviation.
    With ``batch=B`` the batched calls are counted too, and their rounds
    must equal the unbatched ones (B signals share the K rounds); the
    result then carries ``measured_batched`` and ``per_signal_messages``.
    """
    stats = plan_comm_stats(plan, n=n)
    predicted = plan.op.message_counts(n_edges)
    pred = {"apply": predicted["apply_messages"],
            "apply_adjoint": predicted["adjoint_messages"],
            "apply_gram": predicted["gram_messages"]}
    meas = {k: s.paper_messages(n_edges) for k, s in stats.items()}
    rel = {k: (abs(meas[k] - pred[k]) / pred[k]) if pred[k] else 0.0
           for k in pred}
    out = {"measured": meas, "predicted": pred, "rel_dev": rel,
           "max_rel_dev": max(rel.values()),
           "stats": {k: s.summary() for k, s in stats.items()}}
    if batch is not None:
        bstats = plan_comm_stats(plan, n=n, batch=batch)
        for k in stats:
            r1, rb = stats[k].exchange_rounds, bstats[k].exchange_rounds
            if r1 != rb:
                raise AssertionError(
                    f"{plan.backend}.{k}: exchange rounds are not batch-"
                    f"invariant ({r1} at B=1 vs {rb} at B={batch})")
        out["batch"] = int(batch)
        out["measured_batched"] = {k: s.paper_messages(n_edges)
                                   for k, s in bstats.items()}
        out["per_signal_messages"] = {
            k: s.paper_messages_per_signal(n_edges)
            for k, s in bstats.items()}
        out["stats_batched"] = {k: s.summary() for k, s in bstats.items()}
    return out
