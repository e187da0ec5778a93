"""What every sharded backend shares: the option and leak checks, the
exchange matvec of the ring backends (banded and general partitions, with
the wire codec and the fault injector), and the per-rank plan.

A sharded plan runs on one rank of a `torch.distributed` group and owns
the rows [rank * nl, (rank + 1) * nl) of the signal (in partition order
for a general partition).  Every rank passes the same global (..., N)
signal and gets the same global result: it runs the recurrence on its own
rows with a per-shard matvec and gathers the output rows onto every rank
at the end (`comm.assemble`).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import chebyshev as cheb
from ..core import graph as graphmod
from ..kernels import ops
from . import comm, faults, quantize
from .partition import GeneralPartition, general_bytes_per_apply

Tensor = torch.Tensor


def check_partition_name(partition) -> None:
    """Raise `ValueError` for an unknown partition name."""
    if isinstance(partition, str) and partition not in ("banded", "general"):
        raise ValueError(f"unknown partition {partition!r}; use 'banded', "
                         "'general', or a partition instance")


def wire_options(exchange_dtype: str = "f32", error_feedback: bool = True,
                 fault_spec=None, degradation: str = "zero_fill") -> dict:
    """The validated wire options of a ring backend, as the keyword
    arguments of :func:`offset_matvec`: an unknown dtype or degradation
    raises `ValueError` (at p = 0 too), a spec that is not None, a
    `FaultSpec`, a dict or a float raises `TypeError` (the JAX package's
    `pallas_halo.build`)."""
    quantize.validate_exchange_dtype(exchange_dtype)
    faults.validate_degradation(degradation)
    return dict(exchange_dtype=exchange_dtype,
                error_feedback=bool(error_feedback),
                fault_spec=faults.resolve_fault_spec(fault_spec),
                degradation=degradation)


def wire_info(wire: dict) -> dict:
    """plan.info keys of the wire options (`pallas_halo.py:435-439`)."""
    return {"exchange_dtype": wire["exchange_dtype"],
            "error_feedback": wire["error_feedback"],
            "fault_spec": faults.spec_info(wire["fault_spec"]),
            "degradation": wire["degradation"],
            "fault_key": faults.fault_key(wire["fault_spec"],
                                          wire["degradation"])}


def check_leak(leak: float, n_shards: int, allow_leak: bool) -> None:
    if leak > 1e-10 and not allow_leak:
        raise ValueError(
            f"P is not block-tridiagonal under {n_shards} shards "
            f"(leak={leak:.3e}); spatial_sort the graph first, pass "
            "allow_leak=True, or use backend='allgather'")


def offset_matvec(interior: Callable[[Tensor], Tensor],
                  sends: Sequence[Tuple[object, int]],
                  couple: Callable[[Tensor, Tuple[Tensor, ...]], Tensor],
                  group, *, exchange_dtype: str = "f32",
                  error_feedback: bool = True, fault_spec=None,
                  degradation: str = "zero_fill"):
    """Interior/boundary-split matvec over an exchange plan of ring
    offsets, along the last axis of x (..., m) (the shard's domain), in
    the order of the JAX package's `make_exchange_matvec`:

    1. every boundary tile ``x[..., index]`` of `sends` (``(index, d)``
       pairs: a slice or a long tensor, and the ring offset d) is gathered,
       encoded to `exchange_dtype` (`quantize`; with error feedback under
       int8) and goes on the wire to rank s + d, all in one posted round
       (Algorithm 1 lines 6-7);
    2. `interior` (the shard's own block), which reads no remote data,
       runs while the exchange is in flight;
    3. on arrival every wire takes the injector's bit noise, is decoded to
       x's dtype and takes its stale and drop faults (`faults`; link id:
       the offset index); then ``couple(y, received)`` adds the couplings
       of the received tiles (one per offset, from rank s - d) into y.

    With one shard (`group` None), or no cut edge, there is nothing to
    send and the matvec is `interior` itself.  Without error feedback and
    an active `fault_spec` it is stateless; the f32 wire's encode and
    decode return the tile itself, so the clean f32 matvec makes only the
    calls of steps 1-3 without codec and faults.  With error feedback (int8) or an active spec it
    follows the dual-signature stateful protocol of
    `core.chebyshev._stateful_matvec`: ``mv(x, state) -> (y, state)``
    and ``mv.init_state(x)``, the state being (round, carried tiles,
    residuals) with faults and the residuals alone without; a stateless
    call under faults starts from a fresh round-0 state.
    """
    if group is None or not sends:
        return interior
    offsets = tuple(d for _, d in sends)
    dt = quantize.validate_exchange_dtype(exchange_dtype)
    inj = faults.make_injector(fault_spec, degradation,
                               dist.get_rank(group), True)

    use_ef = dt == "int8" and error_feedback

    def _run(x: Tensor, state):
        if inj is not None:
            k, carried, ef_state = state
        else:
            ef_state = state
        tiles = [x[..., idx] for idx, _ in sends]
        if ef_state is None:
            wires, new_ef = [quantize.encode(t, dt) for t in tiles], None
        else:
            pairs = [quantize.ef_encode(t, r, dt)
                     for t, r in zip(tiles, ef_state)]
            wires = [w for w, _ in pairs]
            new_ef = tuple(r for _, r in pairs)
        pending = comm.offset_exchange(wires, offsets, group)
        y = interior(x)
        recvs = pending.wait()
        if inj is not None:
            recvs = [inj.wire(rv, k, j, dt) for j, rv in enumerate(recvs)]
        recvs = [quantize.decode(rv, dt, x.dtype) for rv in recvs]
        if inj is None:
            return couple(y, tuple(recvs)), new_ef
        delivered = [inj.recv(rv, c, k, j)
                     for j, (rv, c) in enumerate(zip(recvs, carried))]
        return (couple(y, tuple(t for t, _ in delivered)),
                (k + 1, tuple(c for _, c in delivered), new_ef))

    if inj is None and not use_ef:
        def mv(x: Tensor) -> Tensor:
            return _run(x, None)[0]

        return mv

    def init_state(x: Tensor):
        tiles = [x[..., idx] for idx, _ in sends]
        ef0 = tuple(quantize.ef_init(t) for t in tiles) if use_ef else None
        if inj is None:
            return ef0
        return inj.init_round(), inj.init_carried(tiles), ef0

    def mv(x: Tensor, state=None):
        if state is None:
            # a one-shot call: plain encoding, faults from a fresh round 0
            return _run(x, None if inj is None else init_state(x))[0]
        return _run(x, state)

    mv.init_state = init_state
    return mv


def ring_matvec(interior: Callable[[Tensor], Tensor], left: Tensor,
                right: Tensor, nl: int, h: int, group, **wire):
    """The banded partition's matvec, along the last axis of x (..., m),
    m >= nl (the shard's domain, padded or not):

        y_s = D_s x_s  +  L_s x_{s-1}[-h:]  +  R_s x_{s+1}[:h]

    `offset_matvec` at offsets (1, −1), with the wire options `wire`
    (:func:`wire_options`): rank s sends its last h logical entries to
    s + 1 (link 0 of the receiver) and its first h to s − 1 (link 1), and
    applies the two (m, h) coupling products `left` and `right` on
    arrival.  The ring wraps; the first and last shard's wrapped tiles
    meet zero couplings.
    """
    def couple(y: Tensor, received: Tuple[Tensor, ...]) -> Tensor:
        from_prev, from_next = received
        return (y + torch.matmul(from_prev, left.mT)
                + torch.matmul(from_next, right.mT))

    return offset_matvec(interior, ((slice(nl - h, nl), 1), (slice(0, h), -1)),
                         couple, group, **wire)


def general_sends(parts: GeneralPartition, rank: int,
                  device: torch.device) -> Tuple[Tuple[Tensor, int], ...]:
    """Shard `rank`'s boundary gathers, one ``(rows, d)`` per offset of a
    general partition: the (h_k,) local rows it ships to rank + d (padded
    with row 0, which its receivers' couplings never read)."""
    return tuple((parts.send_idx[k][rank].long().to(device), d)
                 for k, d in enumerate(parts.offsets))


def coupling_layout(parts: GeneralPartition, rank: int, n_rows: int,
                    device: torch.device) -> graphmod.SlicedELL:
    """Shard `rank`'s couplings of every offset packed into one row-sorted
    sliced-ELL matrix C of `n_rows` rows and sum(h_k) columns, packed on
    `device`: C r adds every cut edge's term, where r is the received
    tiles concatenated in offset order.  The zero-valued padding of the
    JAX package's scatters is dropped; nothing is densified."""
    base = np.concatenate(([0], np.cumsum(parts.tile_widths)))
    rows, cols, vals = [], [], []
    for k in range(len(parts.offsets)):
        v = parts.cpl_vals[k][rank]
        real = v != 0
        rows.append(parts.cpl_rows[k][rank][real].long())
        cols.append(parts.cpl_cols[k][rank][real].long() + int(base[k]))
        vals.append(v[real])
    rows, cols, vals = (torch.cat(t) for t in (rows, cols, vals))
    n_cols = int(base[-1])
    order = torch.argsort(rows * n_cols + cols, stable=True)
    return graphmod.sliced_ell_from_coo(
        rows[order].to(device), cols[order].to(device),
        vals[order].to(device), parts.n_local, n_rows, n_cols=n_cols)


def general_info(op, parts: GeneralPartition, rank: int,
                 wire: dict) -> dict:
    """plan.info keys of a general partition (the JAX package's
    `build_general_plan` info, less its mesh axis), the byte models at the
    wire dtype of `wire` (:func:`wire_options`)."""
    S = parts.n_shards
    dt = wire["exchange_dtype"]
    return {
        "n_shards": S,
        "rank": rank,
        "n_local": parts.n_local,
        "halo_width": parts.halo,
        "partition": "general",
        "partition_method": parts.method,
        "partition_fingerprint": parts.fingerprint,
        "partition_offsets": parts.offsets,
        "partition_tile_widths": parts.tile_widths,
        "edge_cut": parts.edge_cut,
        **wire_info(wire),
        "exchange_collectives_per_round": (len(parts.offsets)
                                           if S > 1 else 0),
        "halo_bytes_per_apply": (general_bytes_per_apply(
            parts, op.K, exchange_dtype=dt) if S > 1 else 0),
        "halo_bytes_per_adjoint": (general_bytes_per_apply(
            parts, op.K, op.eta, exchange_dtype=dt) if S > 1 else 0),
    }


def ista_loop(mv, recurrence, yl: Tensor, coeffs, lmax: float,
              thresh: Tensor, gamma: float, n_iters: int
              ) -> Tuple[Tensor, Tensor]:
    """Algorithm 3 on this rank's rows yl (..., m) against the sharded
    matvec `mv`: (a_*, y_*) on the rank's rows.  Per iteration the only
    communication is the exchange rounds of Phi~ Phi~* (Section VI).
    `recurrence` runs the forward recurrence (`cheb.cheb_apply` or
    `ops.fused_cheb_recurrence`); thresh is mu * gamma (`_mu_threshold`).
    """
    from ..core.lasso import soft_threshold

    phi_y = recurrence(mv, yl, coeffs, lmax)
    a = torch.zeros_like(phi_y)
    for _ in range(n_iters):
        synth = cheb.cheb_apply_adjoint(mv, a, coeffs, lmax)
        gram_a = recurrence(mv, synth, coeffs, lmax)
        a = soft_threshold(a + gamma * (phi_y - gram_a), thresh)
    return a, cheb.cheb_apply_adjoint(mv, a, coeffs, lmax)


def sharded_plan(op, backend: str, mv, *, group, rank: int, nl: int,
                 pnl: int, device: torch.device, dtype: torch.dtype,
                 recurrence, info: dict,
                 parts: Optional[GeneralPartition] = None):
    """An ExecutionPlan whose methods run on this rank's rows with the
    per-shard matvec `mv` and gather the output rows onto every rank.

    `mv` works on the shard's padded domain of `pnl` >= nl entries
    (padded once on the way in, cropped once on the way out).  Every
    signal is cast to `dtype` at the boundary.  A general partition
    `parts` makes the rank's rows those of its partition slots, and the
    assembled outputs are permuted back (`from_partition_order`); every
    vertex-indexed signal, solver state such as Jacobi's 1/diag included,
    goes through the same permutation.
    `recurrence(mv, x, coeffs, lmax)` runs the forward Chebyshev
    recurrence: `cheb.cheb_apply` (plain) or `ops.fused_cheb_recurrence`
    (the Hopper kernels).  Solver and lasso outputs are assembled before
    anything takes a norm over them.
    """
    from ..core.lasso import LassoResult, _mu_threshold
    from .operator import ExecutionPlan

    lo = rank * nl
    coeffs, lmax = op.coeffs, op.lmax
    if parts is None:
        n = op.P.shape[0]
        mine = slice(lo, lo + nl)
    else:
        n = parts.n
        mine = parts.order_on(device)[0][lo:lo + nl]

    def _local(x) -> Tensor:
        x = torch.as_tensor(x, dtype=dtype, device=device)
        x = x[..., mine] if parts is None else x.index_select(-1, mine)
        return ops.pad_trailing(x, pnl).contiguous()

    def _global(y: Tensor) -> Tensor:
        out = comm.assemble(y[..., :nl].contiguous(), group)[..., :n]
        return out if parts is None else parts.from_partition_order(out)

    def apply(f) -> Tensor:
        return _global(recurrence(mv, _local(f), np.atleast_2d(coeffs),
                                  lmax))

    def apply_adjoint(a) -> Tensor:
        return _global(cheb.cheb_apply_adjoint(mv, _local(a), coeffs, lmax))

    def apply_gram(f) -> Tensor:
        d = cheb.gram_coeffs(coeffs)[None]
        return _global(recurrence(mv, _local(f), d, lmax)[..., 0, :])

    def solve_lasso(y, mu, gamma, n_iters):
        thresh = _mu_threshold(mu, op.eta, dtype, gamma, device=device)
        a, y_star = ista_loop(mv, recurrence, _local(y), coeffs, lmax,
                              thresh, gamma, n_iters)
        return LassoResult(coeffs=_global(a), signal=_global(y_star),
                           objective=torch.full((n_iters,), float("nan"),
                                                dtype=dtype, device=device),
                           n_iters=n_iters, fused=True)

    def matvec_runner(fn, signals, consts=()):
        # the solver bodies run on this rank's rows against the sharded
        # matvec; every output is assembled to the logical n
        outs = fn(mv, *(_local(s) for s in signals), *consts)
        if isinstance(outs, (tuple, list)):
            return type(outs)(_global(o) for o in outs)
        return _global(outs)

    return ExecutionPlan(
        op=op, backend=backend, device=device,
        apply=apply, apply_adjoint=apply_adjoint, apply_gram=apply_gram,
        solve_lasso_fn=solve_lasso, matvec_runner=matvec_runner, info=info,
        group=group)
