"""'cuda_halo' execution backend: per-shard Hopper kernels with
boundary-row ("halo") exchange over a `torch.distributed` group.

The counterpart of the JAX package's 'pallas_halo', as `cuda` is that of
'pallas': the `halo` backend's distribution (a block-tridiagonal split of
a banded P, ring exchange of the h boundary rows per order) around the
`cuda` backend's kernels.  Per shard s (rows [s nl, (s+1) nl)):

    y_s = D_s x_s  +  L_s x_{s-1}[-h:]  +  R_s x_{s+1}[:h]

D_s is packed into Block-ELL on the host and moved to the rank's device,
where its sliced-ELL layout is packed (`BlockELL.sliced_ell`, as `cuda`
packs it); the interior product is the sliced-ELL SpMV kernel
(`ops.spmv`, ``csrc/sliced_ell_spmv.cu``).  L_s and R_s are (pnl, h)
couplings, applied as two small `torch.matmul` on arrival.  Each rank
keeps only its own shard on its device.

Per order the matvec (`sharded.ring_matvec`) posts the exchange of the
boundary tiles, launches the interior SpMV, then waits: with a gloo group
the host exchanges while the card computes.  The recurrence runs on the shard's Block-ELL padded
domain pnl, padded once on the way in and cropped once on the way out,
through `ops.fused_cheb_recurrence`: one SpMV and one `cheb_step` launch
per order.  On one shard there is nothing to exchange and the matvec is
tagged with its Block-ELL (``mv.block_ell``), so `apply` is one
`cheb_sweep` launch and a Jacobi solve one `jacobi_sweep` launch, as in
the `cuda` backend (whose options, such as ``sweep_dtype``, stay with
``plan("cuda")``).

``partition="general"`` (or a `GeneralPartition`) shards an arbitrary
sparse P by an edge-cut order (`dist.partition`), the counterpart of the
JAX package's `build_general_plan` with the Block-ELL interior.  Each
rank takes its own shard of the partition's Block-ELL to its device and
packs the sliced layout there; per order it posts one tile per ring
offset (`sharded.offset_matvec`), launches the interior SpMV, and on
arrival adds its couplings — every offset's packed into one row-sorted
rectangular sliced-ELL matrix at plan build, never densified, and
compacted there to the rows that hold an entry
(`bcsr_spmv.compact_coupling`) — with one launch of the same source's
coupling kernel (`sliced_ell_spmv_accumulate`), which reads the received
tiles where they arrived (no join; one launch per 32 offsets past 32);
then `cheb_step`.  Both kernels sum each row in a fixed order, so two
calls give the same bits.  A 1-shard general plan is tagged like the
banded one: one `cheb_sweep` launch per `apply`.

``exchange_dtype=``, ``error_feedback=``, ``fault_spec=`` and
``degradation=`` are the `halo` backend's: the wire codec and the link
faults live in the one exchange matvec (`sharded.offset_matvec`), between
the posted round and the couplings, so the coupling launch of a general
plan reads the decoded (and faulted) tiles.  On one shard they are inert
and the sweeps still take the whole iteration.

On a CUDA device every kernel launches (or raises); with
``device="cpu"`` the same code runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ...core import graph as graphmod
from ...kernels import ops
from ...kernels.bcsr_spmv import compact_coupling, sliced_ell_spmv_accumulate
from .. import comm
from ..partition import (GeneralPartition, OverfullSlotsError,
                         resolve_partition_arg)
from ..sharded import (check_leak, check_partition_name, coupling_layout,
                       general_info, general_sends, offset_matvec,
                       ring_matvec, sharded_plan, wire_info, wire_options)
from . import register_backend, resolve_device
from .halo import halo_bytes_per_apply, partition_banded

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Sharded Block-ELL partition
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardedBlockELL:
    """Per-shard Block-ELL diagonal blocks + dense boundary couplings
    (host tensors).

    blocks:  (S, nrb, slots, br, bc) per-shard Block-ELL values of D_s
    indices: (S, nrb, slots) int32 column-block index per slot
    mask:    (S, nrb, slots) bool slot validity
    left:    (S, nl, h) coupling of shard s's rows to the last h columns
             of shard s-1 (zero for s = 0)
    right:   (S, nl, h) coupling of shard s's rows to the first h columns
             of shard s+1 (zero for s = S-1)
    n:       logical (unpadded) global size; S * nl >= n
    n_local: rows per shard (nl)
    halo:    boundary bandwidth h (rows exchanged per direction per order)
    """

    blocks: Tensor
    indices: Tensor
    mask: Tensor
    left: Tensor
    right: Tensor
    n: int
    n_local: int
    halo: int

    @property
    def n_shards(self) -> int:
        return self.blocks.shape[0]

    @property
    def n_padded(self) -> int:
        """Global padded signal size (S * nl)."""
        return self.n_shards * self.n_local

    @property
    def nnz_blocks(self) -> int:
        return int(self.mask.sum())

    def shard(self, s: int) -> graphmod.BlockELL:
        """D_s as a Block-ELL matrix of logical size nl."""
        return graphmod.BlockELL(blocks=self.blocks[s],
                                 indices=self.indices[s],
                                 mask=self.mask[s], n=self.n_local)


def partition_block_ell(
    P_dense,
    n_shards: int,
    block: Tuple[int, int] = (8, 128),
    max_slots: Optional[int] = None,
) -> Tuple[ShardedBlockELL, float]:
    """Split P into per-shard Block-ELL diagonals + boundary couplings.

    Returns (partition, leak); `leak` is the Frobenius norm of the entries
    outside the block-tridiagonal band (see `halo.partition_banded`).
    ``max_slots`` bounds the uniform slot count and raises
    `OverfullSlotsError` when a row block needs more — it never truncates.
    """
    banded, leak = partition_banded(P_dense, n_shards)
    nl, h = banded.n_local, banded.halo
    cells = [graphmod.to_block_ell(banded.diag[s].numpy(), block)
             for s in range(n_shards)]
    slots = max(c.blocks.shape[1] for c in cells)
    if max_slots is not None and slots > max_slots:
        raise OverfullSlotsError(
            f"a row block couples {slots} column blocks but the uniform "
            f"slot budget is {max_slots} — refusing to truncate (silently "
            "dropped blocks = silently wrong matvecs); raise max_slots or "
            "shrink the column block")
    blocks, indices, mask = [], [], []
    for c in cells:
        pad = slots - c.blocks.shape[1]
        blocks.append(torch.nn.functional.pad(c.blocks, (0, 0, 0, 0, 0, pad)))
        indices.append(torch.nn.functional.pad(c.indices, (0, pad)))
        mask.append(torch.nn.functional.pad(c.mask, (0, pad)))
    left_h, right_h = banded.boundary_couplings()
    return (ShardedBlockELL(blocks=torch.stack(blocks),
                            indices=torch.stack(indices),
                            mask=torch.stack(mask),
                            left=left_h.contiguous(),
                            right=right_h.contiguous(),
                            n=banded.n, n_local=nl, halo=h),
            leak)


# ---------------------------------------------------------------------------
# Building the plan
# ---------------------------------------------------------------------------
@register_backend("cuda_halo")
def build(op, *, mesh=None, partition=None, device=None,
          allow_leak: bool = False, exchange_dtype: str = "f32",
          error_feedback: bool = True, fault_spec=None,
          degradation: str = "zero_fill",
          partition_method: Optional[str] = None, **options):
    """Build this rank's plan: the per-shard Hopper kernels with
    boundary-row exchange over the process group `mesh` (None: the
    default group when one is initialized, else one shard).

    ``partition=`` takes None / ``"banded"`` (a dense, banded P: a
    spatially sorted sensor graph), a precomputed `ShardedBlockELL`
    (another column block than the default (8, 128) comes from
    `partition_block_ell`), ``"general"`` (edge-cut sharding of a dense P
    of any sparsity, ordered by ``partition_method``: "bfs", the default,
    or "spectral", in (8, 128) blocks; with any other partition it
    raises `TypeError`) or a precomputed `GeneralPartition`
    (which a callable P needs).  The rank keeps its own D_s (Block-ELL
    and the sliced layout packed from it) and its couplings on `device`
    (None: ``cuda:<rank % device_count>``), in float32.  The wire
    options are the `halo` backend's.
    """
    wire = wire_options(exchange_dtype, error_feedback, fault_spec,
                        degradation)
    check_partition_name(partition)
    if options:
        raise TypeError(f"cuda_halo backend takes no options "
                        f"{sorted(options)}")
    group, n_shards, rank = comm.resolve_group(mesh)
    dev = resolve_device(device)
    general = resolve_partition_arg(op, partition, n_shards,
                                    method=partition_method)
    if general is not None:
        return _general_plan(op, general, group, rank, dev, wire)
    leak = 0.0
    if isinstance(partition, ShardedBlockELL):
        parts = partition
    elif partition in (None, "banded"):
        if callable(op.P):
            raise ValueError("cuda_halo backend needs a dense P or "
                             "partition=")
        P32 = torch.as_tensor(op.P).to(torch.float32)
        parts, leak = partition_block_ell(P32, n_shards)
        check_leak(leak, n_shards, allow_leak)
    else:
        raise TypeError(f"cuda_halo backend takes a ShardedBlockELL or a "
                        f"GeneralPartition, got {type(partition).__name__}")
    if parts.n_shards != n_shards:
        raise ValueError(f"partition has {parts.n_shards} shards but the "
                         f"group has {n_shards}")
    nl, h = parts.n_local, parts.halo
    local_A = parts.shard(rank).to(dev)
    pnl = local_A.padded_n
    layout = local_A.sliced_ell()     # packed on the device, kept on local_A

    def interior(x: Tensor) -> Tensor:
        return ops.spmv(local_A, x.contiguous())

    def _rows(c: Tensor) -> Tensor:   # (nl, h) -> (pnl, h) on the device
        return torch.nn.functional.pad(c, (0, 0, 0, pnl - nl)).to(dev)

    mv = ring_matvec(interior, _rows(parts.left[rank]),
                     _rows(parts.right[rank]), nl, h, group, **wire)
    if group is None:
        # one shard: y = D x, and the Block-ELL tag lets
        # `ops.fused_cheb_recurrence` and the Section-V solvers collapse
        # the whole iteration into one sweep launch
        mv.block_ell = local_A
    info = {
        "n_shards": n_shards,
        "rank": rank,
        "n_local": nl,
        "n_local_padded": pnl,
        "halo_width": h,
        "partition": "banded",
        "partition_leak": leak,
        "exchange_collectives_per_round": comm.DIRECTIONS_PER_ROUND,
        "block": tuple(parts.blocks.shape[-2:]),
        "nnz_blocks": parts.nnz_blocks,
        "nnz": layout.nnz,
        "stored_per_nnz": layout.stored_per_nnz,
        **wire_info(wire),
        "transport": comm.transport(group, dev),
        # what the 1-shard sweeps hold in L2, and the guard they apply
        # (a solve's l2_budget= overrides it per call)
        "sweep_l2_bytes": ops.cheb_sweep_l2_bytes(pnl),
        "sweep_l2_budget": ops.DEFAULT_SWEEP_L2_BUDGET,
        "halo_bytes_per_apply": halo_bytes_per_apply(
            parts, op.K, exchange_dtype=exchange_dtype),
        "halo_bytes_per_adjoint": halo_bytes_per_apply(
            parts, op.K, op.eta, exchange_dtype=exchange_dtype),
        "block_ell": local_A,
    }
    return sharded_plan(op, "cuda_halo", mv, group=group, rank=rank, nl=nl,
                        pnl=pnl, device=dev, dtype=torch.float32,
                        recurrence=ops.fused_cheb_recurrence, info=info)


def _general_plan(op, parts: GeneralPartition, group, rank: int,
                  dev: torch.device, wire: dict):
    """This rank's plan over a general partition: its Block-ELL shard and
    the sliced layouts of its interior and couplings, on `dev`."""
    nl = parts.n_local
    local_A = parts.shard(rank).to(dev)
    pnl = local_A.padded_n
    layout = local_A.sliced_ell()     # packed on the device, kept on local_A
    sends = general_sends(parts, rank, dev)
    C = coupling_layout(parts, rank, pnl, dev) if sends else None
    # compacted once for the coupling kernel: the rows with an entry, and
    # the launches over the tiles' table (one while the offsets fit it)
    coupling = (compact_coupling(C, parts.tile_widths) if C is not None
                else None)

    def interior(x: Tensor) -> Tensor:
        return ops.spmv(local_A, x.contiguous())

    def couple(y: Tensor, received) -> Tensor:
        return sliced_ell_spmv_accumulate(coupling, received, y)

    mv = offset_matvec(interior, sends, couple, group, **wire)
    if group is None:
        # one shard: no cut edge, and the sweeps take the whole iteration
        mv.block_ell = local_A
    info = dict(
        general_info(op, parts, rank, wire),
        n_local_padded=pnl,
        block=tuple(parts.blocks.shape[-2:]),
        nnz_blocks=parts.nnz_blocks,
        nnz=layout.nnz,
        stored_per_nnz=layout.stored_per_nnz,
        coupling_nnz=0 if C is None else C.nnz,
        coupling_rows=0 if C is None else coupling.n_entry_rows,
        coupling_slices=0 if C is None else coupling.n_slices,
        coupling_launches_per_round=0 if C is None else len(coupling.groups),
        transport=comm.transport(group, dev),
        sweep_l2_bytes=ops.cheb_sweep_l2_bytes(pnl),
        sweep_l2_budget=ops.DEFAULT_SWEEP_L2_BUDGET,
        block_ell=local_A)
    return sharded_plan(op, "cuda_halo", mv, group=group, rank=rank, nl=nl,
                        pnl=pnl, device=dev, dtype=torch.float32,
                        recurrence=ops.fused_cheb_recurrence, info=info,
                        parts=parts)
