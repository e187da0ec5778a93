"""Jacobi iteration and Chebyshev-accelerated Jacobi (Section V-A / V-B),
PyTorch port.

Computing R y for a multiplier with g(lambda) != 0 is equivalent to solving
Q x = y with Q = g(P)^{-1} (Eq. (23)-(24)).  With Q = Q_D - Q_O (diagonal /
off-diagonal split) the Jacobi iteration is

    x^{(t+1)} = Q_D^{-1} Q_O x^{(t)} + Q_D^{-1} y,            (24)

and the Chebyshev-accelerated variant (Saad / Demmel [51, Alg. 6.7]) is
Eq. (25).  Note (paper, Section V-B): the "Chebyshev" here reweights Jacobi
iterates; it is *not* the polynomial approximation of Section IV.

Both solvers follow the (..., N) signal contract — `q_matvec` applies Q
along the *last* axis of its argument and broadcasts over leading batch
dims, so a (B, N) stack of right-hand sides rides the same rounds as one
signal.  The update is written as

    x^{(t+1)} = x^{(t)} + Q_D^{-1} (y - Q x^{(t)})

(algebraically identical to (24)) so that only the *reciprocal* diagonal
appears: padded rows carrying ``inv_diag == 0`` stay exactly zero.  Each
round's elementwise update is one `kernels.ops.jacobi_update` (the
`jacobi_step` kernel on a CUDA tensor).  The round loop is a Python loop;
the (w_t, s_t) weight tables stay host numpy, bitwise the JAX package's.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
MatVec = Callable[[Tensor], Tensor]


def jacobi_weights(n_iters: int) -> np.ndarray:
    """The (w_t, s_t) schedule of the plain Jacobi sweep: every round of
    Eq. (24) is the update with w = 1, s = 0.  Returned as an
    (n_iters, 2) host array — the single-launch `jacobi_sweep` kernel
    (`kernels.ops.fused_jacobi_sweep`) consumes it directly."""
    return np.tile(np.array([1.0, 0.0]), (n_iters, 1))


def cheb_jacobi_weights(rho: float, n_iters: int) -> np.ndarray:
    """Host-side (w_t, s_t) schedule of Chebyshev-accelerated Jacobi.

    Row 0 is the plain bootstrap step x^{(1)}; rows t >= 1 replay the
    xi-recurrence of Eq. (25) exactly as :func:`jacobi_chebyshev_solve`
    computes it, so the single-launch `jacobi_sweep` kernel takes the whole
    schedule as one (n_iters, 2) table.
    """
    rho = float(rho)
    ws = np.zeros((n_iters, 2))
    ws[0] = (1.0, 0.0)
    xi_prev, xi = 1.0, rho
    for t in range(1, n_iters):
        xi_next = 1.0 / (2.0 / (rho * xi) - 1.0 / xi_prev)
        ws[t] = (2.0 * xi_next / (rho * xi), xi_next / xi_prev)
        xi_prev, xi = xi, xi_next
    return ws


def _resolve_inv_diag(q_diag, inv_diag, like: Tensor) -> Tensor:
    if inv_diag is not None:
        return torch.as_tensor(inv_diag, device=like.device)
    if q_diag is None:
        raise ValueError("pass q_diag or inv_diag")
    return 1.0 / torch.as_tensor(q_diag, device=like.device)


def jacobi_solve(
    q_matvec: MatVec,
    q_diag: Optional[Tensor],
    y: Tensor,
    n_iters: int,
    x0: Optional[Tensor] = None,
    return_history: bool = False,
    inv_diag: Optional[Tensor] = None,
):
    """Jacobi iteration (24) for Q x = y.

    q_matvec: applies the full Q along the last axis ((..., N) contract).
    q_diag: diagonal of Q (length N); alternatively pass `inv_diag`
    (= 1/q_diag) directly — the solver path does, with zeros on padded
    rows.  y: (..., N) batched right-hand sides.  Convergence iff
    spectral_radius(Q_D^{-1} Q_O) < 1 [50, Thm 4.1].

    With `return_history=True` also returns the (n_iters, ..., N) stack of
    iterates (the Fig. 2 error-vs-budget hook).
    """
    from ..kernels import ops  # lazy: core stays importable without kernels
    from .chebyshev import _stateful_matvec

    inv_d = _resolve_inv_diag(q_diag, inv_diag, y)
    x = torch.zeros_like(y) if x0 is None else x0
    # stateful-matvec protocol: a matvec carrying cross-round state (an
    # error-feedback exchange) threads it through the rounds; plain
    # matvecs ride a shim
    mv2, st = _stateful_matvec(q_matvec, x)
    hist = []
    for _ in range(n_iters):
        qx, st = mv2(x, st)
        x = ops.jacobi_update(qx, x, x, y, inv_d, w=1.0, s=0.0)
        if return_history:
            hist.append(x)
    if return_history:
        return x, torch.stack(hist) if hist else y.new_empty((0,) + y.shape)
    return x


def jacobi_chebyshev_solve(
    q_matvec: MatVec,
    q_diag: Optional[Tensor],
    y: Tensor,
    rho: float,
    n_iters: int,
    x0: Optional[Tensor] = None,
    return_history: bool = False,
    inv_diag: Optional[Tensor] = None,
):
    """Chebyshev-accelerated Jacobi, Eq. (25).

    rho: upper bound on the spectral radius of Q_D^{-1} Q_O (must be < 1).
    Same (..., N) batched contract and `inv_diag` escape hatch as
    :func:`jacobi_solve`; each iteration costs exactly one `q_matvec`.
    """
    from ..kernels import ops
    from .chebyshev import _stateful_matvec

    inv_d = _resolve_inv_diag(q_diag, inv_diag, y)
    x_prev = torch.zeros_like(y) if x0 is None else x0
    mv2, st = _stateful_matvec(q_matvec, x_prev)
    qx, st = mv2(x_prev, st)
    x = ops.jacobi_update(qx, x_prev, x_prev, y, inv_d, w=1.0, s=0.0)  # x^(1)
    hist = [x]
    xi_prev, xi = 1.0, float(rho)
    for _ in range(max(n_iters - 1, 0)):
        xi_next = 1.0 / (2.0 / (rho * xi) - 1.0 / xi_prev)
        w = 2.0 * xi_next / (rho * xi)
        s = xi_next / xi_prev
        qx, st = mv2(x, st)
        # x_next = w * (x + inv_d (y - Q x)) - s * x_prev    (Eq. (25))
        x, x_prev = ops.jacobi_update(qx, x, x_prev, y, inv_d, w=w, s=s), x
        xi_prev, xi = xi, xi_next
        if return_history:
            hist.append(x)
    if return_history:
        # the full (n_iters, ..., N) stack, x^(1) first, like jacobi_solve's
        return x, torch.stack(hist)
    return x


def tikhonov_q(P_matvec: MatVec, P_diag: Tensor,
               tau: float) -> Tuple[MatVec, Tensor]:
    """Q = g(P)^{-1} = (tau I + P)/tau for the SSL multiplier tau/(tau+lambda)
    (the Zhou et al. iteration (22) is Jacobi on exactly this Q)."""

    def q_mv(x):
        return (tau * x + P_matvec(x)) / tau

    return q_mv, (tau + P_diag) / tau


def power_q(P_matvec: MatVec, P: Tensor, tau: float,
            r: int) -> Tuple[MatVec, Tensor]:
    """Q = (tau I + P^r)/tau for g(lambda)=tau/(tau+lambda^r).  Needs the
    diagonal of P^r; communication per iteration is r matvecs (Section V-E:
    'computing W x requires twice the communication' for r = 2)."""
    Pr = torch.linalg.matrix_power(torch.as_tensor(P), r)

    def q_mv(x):
        z = x
        for _ in range(r):
            z = P_matvec(z)
        return (tau * x + z) / tau

    return q_mv, (tau + torch.diagonal(Pr)) / tau
