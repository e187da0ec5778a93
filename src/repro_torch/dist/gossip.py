"""Chebyshev gossip consensus on the rank ring (the paper's Algorithm 1
with P the ring-graph Laplacian and the ranks as vertices), the JAX
package's `repro.dist.gossip` over a `torch.distributed` group.

The n-rank ring Laplacian L_ring has eigenvalues ``2 - 2 cos(2 pi k /
n)``, the constant vector spanning its nullspace.  A polynomial p with
``p(0) = 1`` and ``p(lambda_k) = 0`` on every distinct non-zero eigenvalue
gives ``p(L_ring) = (1/n) 11^T``: average consensus after ``K =
ceil(n/2)`` neighbour-exchange rounds, each round one exchange of
Algorithm 1.  For ``K < ceil(n/2)`` the coefficients solve the
constrained least-squares problem (p(0) = 1, the residual on the non-zero
spectrum minimised): approximate consensus.

Degradations (the reference's):

* ``quantize=True``: messages cross as int8 wires (`dist.quantize`, the
  row's f32 scale packed into the row: h + 4 bytes per h-element row for
  4h in f32); the consensus error grows to the quantization floor;
* ``fault_spec=`` / ``degradation=``: the seeded link faults of the
  sharded plans (`dist.faults`), with the banded plan's link ids (0 = from
  the left, 1 = from the right), so one `FaultSpec` replays the same trace
  on a filter plan and on the gossip ring;
* ``drop_left`` / ``drop_right``: a rank ignores that incoming link and
  substitutes its own state (the ring degrades to a path graph).

Every exchange is the sharded plans' `sharded.offset_matvec` (one
`comm.offset_exchange` at offsets (1, -1), the same codec and injector),
so gossip's rounds are counted like the plans' (K per leaf).  On a card the
recurrence runs the `cheb_step` kernel per order
(`ops.fused_cheb_recurrence`); on the CPU `core.chebyshev.cheb_apply`.

Usage (gradient averaging without an all-reduce)::

    coeffs = consensus_coeffs(dist.get_world_size(group))   # host, once
    grads = gossip_mean_tree(grads, group, coeffs)          # ~ the mean

``consensus_error(n, coeffs)`` bounds the distance from the true mean.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core import chebyshev as cheb
from ..kernels import ops
from ..tree import tree_map
from . import faults, sharded
from . import quantize as q

Tensor = torch.Tensor

#: The ring Laplacian spectrum lives in [0, 4] for every n.
RING_LMAX = 4.0


# ---------------------------------------------------------------------------
# Coefficients (host numpy, the reference's arithmetic)
# ---------------------------------------------------------------------------
def ring_eigenvalues(n: int) -> np.ndarray:
    """Distinct eigenvalues of the n-ring Laplacian, ascending (0 first)."""
    ks = np.arange(n // 2 + 1)
    return 2.0 - 2.0 * np.cos(2.0 * np.pi * ks / n)


def _cheb_rows(lam: np.ndarray, K: int) -> np.ndarray:
    """Rows of shifted-Chebyshev basis values (half-c0 convention) at lam."""
    alpha = RING_LMAX / 2.0
    y = (np.asarray(lam, np.float64) - alpha) / alpha
    rows = np.zeros((len(y), K + 1))
    t_km2 = np.ones_like(y)
    rows[:, 0] = 0.5 * t_km2
    if K >= 1:
        t_km1 = y.copy()
        rows[:, 1] = t_km1
        for k in range(2, K + 1):
            t_k = 2.0 * y * t_km1 - t_km2
            rows[:, k] = t_k
            t_km2, t_km1 = t_km1, t_k
    return rows


def consensus_coeffs(n: int, K: Optional[int] = None) -> np.ndarray:
    """Chebyshev coefficients of the degree-K ring-consensus polynomial,
    shape (K+1,), float64, half-c0 convention.  The default ``K =
    ceil(n/2)`` is exact consensus; a smaller K the constrained
    least-squares polynomial (p(0) = 1 exactly)."""
    if K is None:
        K = int(np.ceil(n / 2))
    lam = ring_eigenvalues(n)
    rows = _cheb_rows(lam, K)
    t0, t_nz = rows[0], rows[1:]
    # constrained LS via the nullspace of the p(0)=1 constraint row
    c_part = t0 / float(t0 @ t0)
    _, _, vt = np.linalg.svd(t0[None, :])
    null = vt[1:].T  # (K+1, K)
    z, *_ = np.linalg.lstsq(t_nz @ null, -t_nz @ c_part, rcond=None)
    return c_part + null @ z


def consensus_error(n: int,
                    coeffs: Union[np.ndarray, Sequence[float]]) -> float:
    """``max(|p(0) - 1|, max_{k != 0} |p(lambda_k)|)``: the operator-norm
    distance between p(L_ring) and the averaging projector."""
    coeffs = np.asarray(coeffs, np.float64)
    lam = ring_eigenvalues(n)
    vals = _cheb_rows(lam, len(coeffs) - 1) @ coeffs
    err0 = abs(vals[0] - 1.0)
    err_nz = float(np.max(np.abs(vals[1:]))) if len(lam) > 1 else 0.0
    return float(max(err0, err_nz))


# ---------------------------------------------------------------------------
# The ring exchange
# ---------------------------------------------------------------------------
def quantize_message(x: Tensor, bits: int = 8) -> Tensor:
    """A gossip message as an int8 wire (`quantize.encode`): (..., h + 4)
    int8, the row's f32 scale in its last four lanes; all-zero rows pass
    through.  Only ``bits=8`` exists."""
    if bits != 8:
        raise ValueError(f"only bits=8 (int8 wire) is supported, got {bits}")
    return q.encode(x, "int8")


def dequantize_message(wire: Tensor,
                       out_dtype: torch.dtype = torch.float32) -> Tensor:
    """Decode an int8 wire from :func:`quantize_message`."""
    return q.decode(wire, "int8", out_dtype)


def _ring_matvec(group, *, quantize: bool = False, drop_left=False,
                 drop_right=False, fault_spec=None,
                 degradation: str = "zero_fill"):
    """L_ring x: one exchange with both ring neighbours per call.

    The sharded plans' exchange matvec (`sharded.offset_matvec`) with the
    whole x as the tile at offsets (1, -1): it holds the codec (int8
    without error feedback under `quantize`) and the injector (links 0 =
    from the left, 1 = from the right), and is stateful only under an
    active `fault_spec`.  A dropped link (`drop_left` / `drop_right`)
    substitutes the local state, so the interior is ``(2 - dropped) x``
    and the coupling subtracts the links that are kept (the ring degrades
    to a path graph, still consensus-preserving on the constant part).
    """
    size = 1 if group is None else dist.get_world_size(group)
    keep_left, keep_right = not bool(drop_left), not bool(drop_right)
    if size == 1:
        # no link to exchange over: both neighbours are this rank's own
        # message, so the clean ring gives 2x - x - x = 0; the spec and
        # degradation are still validated, as the reference does
        faults.make_injector(fault_spec, degradation, 0, exchanging=False)

        def mv(x: Tensor) -> Tensor:
            msg = dequantize_message(quantize_message(x), x.dtype) \
                if quantize else x
            from_left = msg if keep_left else x
            from_right = msg if keep_right else x
            return 2.0 * x - from_left - from_right

        return mv

    self_weight = 2.0 - (not keep_left) - (not keep_right)

    def interior(x: Tensor) -> Tensor:
        return self_weight * x

    def couple(y: Tensor, received) -> Tensor:
        from_left, from_right = received
        if keep_left:
            y = y - from_left
        if keep_right:
            y = y - from_right
        return y

    whole = slice(None)
    return sharded.offset_matvec(
        interior, ((whole, 1), (whole, -1)), couple, group,
        exchange_dtype="int8" if quantize else "f32", error_feedback=False,
        fault_spec=fault_spec, degradation=degradation)


def gossip_mean(x: Tensor, group, coeffs, *, quantize: bool = False,
                drop_left=False, drop_right=False, fault_spec=None,
                degradation: str = "zero_fill") -> Tensor:
    """Approximate per-entry mean of `x` over the ranks of `group` (None:
    one rank).  Every rank calls it with its own `x` of one shape; each
    gets that shape back, every entry replaced by (approximately) the
    mean over the ranks.  With the default full-order coefficients the
    consensus is exact to the dtype's rounding.  `fault_spec` /
    `degradation` inject the link faults of `dist.faults` (None or an
    all-zero spec: the clean path)."""
    mv = _ring_matvec(group, quantize=quantize, drop_left=drop_left,
                      drop_right=drop_right, fault_spec=fault_spec,
                      degradation=degradation)
    c = np.asarray(coeffs, np.float64)
    scalar = x.ndim == 0
    # the recurrence's (..., N) contract needs a trailing axis; the ring
    # "graph" lives on the rank axis, so a scalar leaf is a 1-vector
    xv = x[None] if scalar else x
    if xv.is_cuda:
        out = ops.fused_cheb_recurrence(mv, xv, c, RING_LMAX)[..., 0, :]
    else:
        out = cheb.cheb_apply(mv, xv, c, RING_LMAX)
    return out[0] if scalar else out


def gossip_mean_tree(tree, group, coeffs, *, quantize: bool = False,
                     fault_spec=None, degradation: str = "zero_fill"):
    """:func:`gossip_mean` mapped over a tree of tensors (nested dicts,
    lists and tuples): every leaf is averaged over the ring on its own,
    one recurrence of K rounds per leaf, in `repro_torch.tree` order."""
    return tree_map(lambda x: gossip_mean(x, group, coeffs, quantize=quantize,
                                          fault_spec=fault_spec,
                                          degradation=degradation), tree)
