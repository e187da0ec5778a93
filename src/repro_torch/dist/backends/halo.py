"""'halo' execution backend: sharded Algorithm 1/2/3 over a
`torch.distributed` group with ring halo exchange.

The paper's distributed model with one rank holding a contiguous block of
vertices instead of one sensor holding one vertex.  A spatially sorted
sensor graph is banded, so a shard couples only with its two ring
neighbours; per Chebyshev order each rank exchanges its boundary tile —
the h = coupling-bandwidth rows a neighbour reads — with both:

    y_s = D_s x_s  +  L_s x_{s-1}[-h:]  +  R_s x_{s+1}[:h]

The per-order matvec (`sharded.ring_matvec`) posts the exchange first,
computes the interior product D_s x_s while it is in flight, and applies
the two (nl, h) couplings on arrival.  The products are plain
`torch.matmul`, as the JAX package computes them with einsum outside any
kernel; `cuda_halo` is the same exchange around the Hopper kernels.

``exchange_dtype=`` ("f32", "bf16", "int8") sets the wire of the boundary
tiles (`dist.quantize`; ``error_feedback`` threads int8's residual across
the orders) and ``fault_spec=`` / ``degradation=`` inject seeded link
faults on the receive side (`dist.faults`); both live in the one exchange
matvec, so the rounds stay K.

``partition="general"`` (or a `GeneralPartition`) shards an arbitrary
sparse P by an edge-cut order instead (`dist.partition`): one tile per
ring offset per order (`sharded.offset_matvec`), the interior the
shard's dense diagonal block (`dense_diag`, small n only) and the
couplings one sparse sliced-ELL matrix applied by the plain version of
the SpMV (`sliced_ell_spmv_plain`; its sums on a card run in
`index_add_`'s atomic order, so `cuda_halo` is the backend that gives
the same bits on every call).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ...core import chebyshev as cheb
from ...kernels import ops
from ...kernels.bcsr_spmv import sliced_ell_spmv_plain
from .. import comm
from ..partition import GeneralPartition, resolve_partition_arg
from ..quantize import tile_wire_bytes
from ..sharded import (check_leak, check_partition_name, coupling_layout,
                       general_info, general_sends, offset_matvec,
                       ring_matvec, sharded_plan, wire_info, wire_options)
from . import register_backend, resolve_device

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Banded partition of P
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BandedPartition:
    """P split into per-shard block-tridiagonal structure (host tensors).

    diag:  (S, nl, nl)  coupling within shard s
    left:  (S, nl, nl)  coupling of shard s's rows to shard s-1's columns
    right: (S, nl, nl)  coupling of shard s's rows to shard s+1's columns
    n:     logical size (before padding); S * nl >= n
    """

    diag: Tensor
    left: Tensor
    right: Tensor
    n: int

    @property
    def n_shards(self) -> int:
        return self.diag.shape[0]

    @property
    def n_local(self) -> int:
        return self.diag.shape[1]

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.n_local

    @property
    def halo(self) -> int:
        """Coupling bandwidth h: the boundary rows a neighbour reads (the
        per-order exchange tile), computed once and memoized."""
        h = self.__dict__.get("_halo")
        if h is None:
            h = _coupling_bandwidth(self.left.numpy(), self.right.numpy())
            self.__dict__["_halo"] = h
        return h

    def boundary_couplings(self) -> Tuple[Tensor, Tensor]:
        """(left, right) trimmed to the h columns they read: left
        (S, nl, h) against shard s-1's last h rows, right (S, nl, h)
        against shard s+1's first h rows."""
        h, nl = self.halo, self.n_local
        return self.left[:, :, nl - h:], self.right[:, :, :h]


def _coupling_bandwidth(left: np.ndarray, right: np.ndarray) -> int:
    """Halo width h: how many boundary rows a neighbour reads — the widest
    band of `left` (trailing columns of shard s-1) and `right` (leading
    columns of shard s+1) over all shards, at least 1."""
    nl = left.shape[1]
    h = 1
    lc = np.nonzero(np.any(left != 0, axis=(0, 1)))[0]
    if lc.size:
        h = max(h, nl - int(lc.min()))
    rc = np.nonzero(np.any(right != 0, axis=(0, 1)))[0]
    if rc.size:
        h = max(h, int(rc.max()) + 1)
    return min(h, nl)


def partition_banded(P_dense, n_shards: int) -> Tuple[BandedPartition, float]:
    """Split P into block-tridiagonal shard structure.

    Returns (partition, leak), `leak` being the Frobenius norm of the
    entries outside the block-tridiagonal band (~0 for the halo plans to
    be exact: `graph.spatial_sort` a sensor graph first, or use the
    'allgather' backend).  Dense numpy, as in the JAX package.
    """
    P_dense = (P_dense.numpy(force=True) if isinstance(P_dense, Tensor)
               else np.asarray(P_dense))
    n = P_dense.shape[0]
    nl = -(-n // n_shards)
    pad = n_shards * nl - n
    Pp = np.pad(P_dense, ((0, pad), (0, pad)))
    diag = np.zeros((n_shards, nl, nl), P_dense.dtype)
    left = np.zeros((n_shards, nl, nl), P_dense.dtype)
    right = np.zeros((n_shards, nl, nl), P_dense.dtype)
    covered = np.zeros_like(Pp, dtype=bool)
    for s in range(n_shards):
        r = slice(s * nl, (s + 1) * nl)
        diag[s] = Pp[r, r]
        covered[r, r] = True
        if s > 0:
            c = slice((s - 1) * nl, s * nl)
            left[s] = Pp[r, c]
            covered[r, c] = True
        if s < n_shards - 1:
            c = slice((s + 1) * nl, (s + 2) * nl)
            right[s] = Pp[r, c]
            covered[r, c] = True
    leak = float(np.linalg.norm(Pp[~covered]))
    return (BandedPartition(diag=torch.from_numpy(diag),
                            left=torch.from_numpy(left),
                            right=torch.from_numpy(right), n=n),
            leak)


def pad_signal(x, parts) -> Tensor:
    """Zero-pad the trailing (vertex) axis up to the partition's padded
    size; leading batch / eta axes pass through untouched."""
    return ops.pad_trailing(torch.as_tensor(x), parts.n_padded)


def halo_bytes_per_apply(parts, K: int, eta: int = 1,
                         dtype_bytes: int = 4,
                         exchange_dtype: Optional[str] = None) -> int:
    """Exchange bytes of one sharded application over all shards: per
    order each shard sends its h-row boundary tile left and right, K
    orders, S shards (`parts`: a `BandedPartition` or a
    `cuda_halo.ShardedBlockELL`).  A row is `exchange_dtype`'s wire row
    (`quantize.tile_wire_bytes`: 4h, 2h or h + 4 bytes); without it, h
    elements of `dtype_bytes`."""
    if exchange_dtype is not None:
        row = tile_wire_bytes(parts.halo, exchange_dtype)
    else:
        row = parts.halo * dtype_bytes
    return 2 * K * parts.n_shards * eta * row


# ---------------------------------------------------------------------------
# Building the plan
# ---------------------------------------------------------------------------
@register_backend("halo")
def build(op, *, mesh=None, partition=None, device=None,
          allow_leak: bool = False, exchange_dtype: str = "f32",
          error_feedback: bool = True, fault_spec=None,
          degradation: str = "zero_fill",
          partition_method: Optional[str] = None, **options):
    """Build the ring-halo plan of this rank over the process group
    `mesh` (None: the default group when one is initialized, else one
    shard).

    ``partition=`` takes None / ``"banded"`` (split a dense P into the
    block-tridiagonal ring plan here; P must be leak-free under the
    contiguous split unless ``allow_leak=True``), a precomputed
    `BandedPartition`, ``"general"`` (edge-cut sharding of a dense P of
    any sparsity, ordered by ``partition_method``: "bfs", the default, or
    "spectral"; with any other partition it raises `TypeError`)
    or a precomputed `GeneralPartition` (which a callable P needs).  The
    rank keeps only its own diagonal block and couplings on `device`
    (None: ``cuda:<rank % device_count>``), at P's dtype (float32 for a
    general partition).

    ``exchange_dtype`` ("f32" | "bf16" | "int8") is the wire of the
    boundary tiles and ``error_feedback`` (int8 only) threads the
    quantization residual across the orders (`dist.quantize`);
    ``fault_spec`` (None, a `FaultSpec`, a dict or a drop probability)
    and ``degradation`` ("zero_fill" | "hold_last") inject seeded link
    faults (`dist.faults`).
    """
    wire = wire_options(exchange_dtype, error_feedback, fault_spec,
                        degradation)
    check_partition_name(partition)
    if options:
        raise TypeError(f"halo backend takes no options {sorted(options)}")
    group, n_shards, rank = comm.resolve_group(mesh)
    dev = resolve_device(device)
    general = resolve_partition_arg(op, partition, n_shards,
                                    method=partition_method)
    if general is not None:
        return _general_plan(op, general, group, rank, dev, wire)
    leak = 0.0
    if isinstance(partition, BandedPartition):
        parts = partition
    elif partition in (None, "banded"):
        if callable(op.P):
            raise ValueError("halo backend needs a dense P or partition=")
        parts, leak = partition_banded(op.P, n_shards)
        check_leak(leak, n_shards, allow_leak)
    else:
        raise TypeError(f"halo backend takes a BandedPartition or a "
                        f"GeneralPartition, got {type(partition).__name__}")
    if parts.n_shards != n_shards:
        raise ValueError(f"partition has {parts.n_shards} shards but the "
                         f"group has {n_shards}")
    nl, h = parts.n_local, parts.halo
    left_h, right_h = parts.boundary_couplings()
    diag = parts.diag[rank].to(dev)
    wire_dt = None if exchange_dtype == "f32" else exchange_dtype
    mv = ring_matvec(lambda x: torch.matmul(x, diag.mT),
                     left_h[rank].to(dev), right_h[rank].to(dev), nl, h, group,
                     **wire)
    info = {
        "n_shards": n_shards,
        "rank": rank,
        "n_local": nl,
        "halo_width": h,
        "partition": "banded",
        "partition_leak": leak,
        "exchange_collectives_per_round": comm.DIRECTIONS_PER_ROUND,
        **wire_info(wire),
        "transport": comm.transport(group, dev),
        # forward and Gram ship an (..., h) tile per order; the adjoint's
        # iterate carries the eta streams.  The f32 wire is the identity
        # and carries P's own dtype (8 bytes for a float64 P).
        "halo_bytes_per_apply": halo_bytes_per_apply(
            parts, op.K, dtype_bytes=diag.element_size(),
            exchange_dtype=wire_dt),
        "halo_bytes_per_adjoint": halo_bytes_per_apply(
            parts, op.K, op.eta, dtype_bytes=diag.element_size(),
            exchange_dtype=wire_dt),
    }
    return sharded_plan(op, "halo", mv, group=group, rank=rank, nl=nl,
                        pnl=nl, device=dev, dtype=diag.dtype,
                        recurrence=cheb.cheb_apply, info=info)


def _general_plan(op, parts: GeneralPartition, group, rank: int,
                  dev: torch.device, wire: dict):
    """This rank's plan over a general partition: its dense diagonal
    block, one tile per offset, its couplings as one sparse layout."""
    nl = parts.n_local
    diag = parts.shard(rank).todense().to(dev)
    sends = general_sends(parts, rank, dev)
    C = coupling_layout(parts, rank, nl, dev) if sends else None

    def couple(y: Tensor, received) -> Tensor:
        return sliced_ell_spmv_plain(C, torch.cat(received, -1), out=y)

    mv = offset_matvec(lambda x: torch.matmul(x, diag.mT), sends, couple,
                       group, **wire)
    info = dict(general_info(op, parts, rank, wire),
                transport=comm.transport(group, dev))
    return sharded_plan(op, "halo", mv, group=group, rank=rank, nl=nl,
                        pnl=nl, device=dev, dtype=diag.dtype,
                        recurrence=cheb.cheb_apply, info=info,
                        parts=parts)
