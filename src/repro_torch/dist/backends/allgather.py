"""'allgather' execution backend: row-block sharded P with one gather of
the iterate per Chebyshev order (general, non-banded graphs).

Exact for any sparsity pattern; the trade is bandwidth: each order moves
the whole iterate (`comm.all_gather`) instead of the boundary tiles, so
prefer 'halo' / 'cuda_halo' whenever the graph is (or can be sorted to
be) banded.  The row block is a dense `torch.matmul`, as the JAX package
computes it with einsum outside any kernel.
"""
from __future__ import annotations

import torch

from ...core import chebyshev as cheb
from .. import comm, faults
from ..partition import GeneralPartition
from ..sharded import check_partition_name, sharded_plan
from . import register_backend, resolve_device

Tensor = torch.Tensor


def _allgather_matvec(rows: Tensor, group):
    """rows: (nl, N_padded) local row block; x: (..., nl).  One gather
    moves every leading batch / eta stream in the same round; with one
    shard (`group` None) x is already whole."""
    def mv(x: Tensor) -> Tensor:
        x_full = x if group is None else comm.all_gather(x, group)
        return torch.matmul(x_full, rows.mT)

    return mv


def _local_rows(x: Tensor, rank: int, nl: int) -> Tensor:
    return x[..., rank * nl:(rank + 1) * nl].contiguous()


def dist_cheb_apply_allgather(group, rank: int, rows: Tensor, x: Tensor,
                              coeffs, lmax: float) -> Tensor:
    """Sharded Phi_tilde x for general P, on every rank of `group`: rows
    (nl, N_padded) this rank's rows of P, x (..., N_padded) the global
    signal -> (..., eta, N_padded) ((..., N_padded) for 1-D coeffs)."""
    mv = _allgather_matvec(rows, group)
    out = cheb.cheb_apply(mv, _local_rows(x, rank, rows.shape[0]), coeffs,
                          lmax)
    return comm.assemble(out.contiguous(), group)


def dist_cheb_apply_adjoint_allgather(group, rank: int, rows: Tensor,
                                      a: Tensor, coeffs,
                                      lmax: float) -> Tensor:
    """Sharded Phi_tilde^* a (Algorithm 2): a (..., eta, N_padded) ->
    (..., N_padded); one gather moves all eta streams per order."""
    mv = _allgather_matvec(rows, group)
    out = cheb.cheb_apply_adjoint(mv, _local_rows(a, rank, rows.shape[0]),
                                  coeffs, lmax)
    return comm.assemble(out, group)


def dist_cheb_apply_gram_allgather(group, rank: int, rows: Tensor,
                                   x: Tensor, coeffs, lmax: float) -> Tensor:
    """Sharded Phi~* Phi~ x via the product coefficients (Section IV-C):
    (..., N_padded) -> (..., N_padded)."""
    return dist_cheb_apply_allgather(group, rank, rows, x,
                                     cheb.gram_coeffs(coeffs), lmax)


@register_backend("allgather")
def build(op, *, mesh=None, partition=None, device=None,
          exchange_dtype: str = "f32", fault_spec=None, **options):
    """This rank's plan for an arbitrary dense P over the process group
    `mesh` (None: the default group when one is initialized, else one
    shard): the rank keeps its nl rows of P on `device` (None:
    ``cuda:<rank % device_count>``), at P's dtype.

    The gather has no compressed wire and no links to fail: another
    ``exchange_dtype`` than "f32", or an active ``fault_spec``, raises
    `ValueError` (the JAX package's allgather ignores them); a malformed
    spec raises `TypeError` as on the ring backends."""
    spec = faults.resolve_fault_spec(fault_spec)
    if exchange_dtype != "f32" or (spec is not None and spec.active):
        raise ValueError(
            "allgather gathers whole iterates and has no compressed "
            "exchange or link faults; use 'halo' or 'cuda_halo' for "
            "exchange_dtype= and fault_spec=")
    check_partition_name(partition)
    if partition == "general" or isinstance(partition, GeneralPartition):
        raise ValueError("the allgather backend shards the rows of a dense "
                         "P and takes no general partition; use 'halo' or "
                         "'cuda_halo'")
    if options:
        raise TypeError(f"allgather backend takes no options "
                        f"{sorted(options)}")
    if callable(op.P):
        raise ValueError("allgather backend needs a dense P")
    group, n_shards, rank = comm.resolve_group(mesh)
    dev = resolve_device(device)
    P = torch.as_tensor(op.P)
    n = P.shape[0]
    nl = -(-n // n_shards)
    total = n_shards * nl
    # this rank's rows, zero-padded to (nl, total)
    mine = P[rank * nl:(rank + 1) * nl]
    rows = torch.nn.functional.pad(
        mine, (0, total - n, 0, nl - mine.shape[0])).to(dev)
    info = {
        "n_shards": n_shards,
        "rank": rank,
        "n_local": nl,
        "exchange_dtype": exchange_dtype,
        "transport": comm.transport(group, dev),
        # what the K gathers of one apply carry, summed over the shards:
        # each rank contributes its (nl,) iterate per order (as counted
        # by `comm.all_gather`)
        "gather_bytes_per_apply": op.K * total * rows.element_size(),
    }
    return sharded_plan(op, "allgather", _allgather_matvec(rows, group),
                        group=group, rank=rank, nl=nl, pnl=nl, device=dev,
                        dtype=rows.dtype, recurrence=cheb.cheb_apply,
                        info=info)

