"""Distributed lasso / wavelet denoising — Section VI, Algorithm 3
(PyTorch port).

Iterative soft thresholding (ISTA, Eq. (32)) over the Chebyshev-approximated
spectral graph wavelet frame Phi_tilde:

    argmin_a  (1/2) || y - Phi~* a ||_2^2 + || a ||_{1, mu}        (33)

Each iteration needs Phi~ y (computed once, Algorithm 1) and
Phi~ Phi~* a^{(beta-1)} (Algorithm 2 then Algorithm 1).  The step size must
satisfy gamma < 2 / ||Phi~||_2^2 for convergence [58].  The update and the
shrinkage of lines 5-7 are one fused update per iteration
(`kernels.ops.ista_launcher`) — the `ista_shrink` kernel on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from .multiplier import UnionMultiplier

Tensor = torch.Tensor


def soft_threshold(z: Tensor, thresh) -> Tensor:
    """S_t(z) = 0 if |z| <= t else z - sgn(z) t   (shrinkage operator)."""
    return torch.sign(z) * torch.clamp_min(torch.abs(z) - thresh, 0.0)


def lasso_objective(op: UnionMultiplier, y: Tensor, a: Tensor,
                    mu) -> Tensor:
    """Eq. (33) objective; for batched y/a the objectives are summed over
    the batch (each signal's problem is separable, so the sum is what the
    batched ISTA minimizes)."""
    resid = y - op.apply_adjoint(a)
    return 0.5 * torch.sum(resid * resid) + torch.sum(mu * torch.abs(a))


@dataclasses.dataclass
class LassoResult:
    coeffs: Tensor      # a_*, shape (..., eta, N) — leading batch dims of y
    signal: Tensor      # Phi~* a_*, shape (..., N)
    objective: Tensor   # objective value per recorded iteration
    n_iters: int
    fused: bool = False  # True iff a backend's fused ISTA ran


def _mu_threshold(mu, eta: int, dtype, gamma: float,
                  n: Optional[int] = None, device=None) -> Tensor:
    """Shrinkage threshold mu*gamma broadcastable against a (..., eta, N).

    mu: scalar (shared), (eta,) per-scale (the paper's 0.01 / 0.75 split),
    (..., eta) per-signal-per-scale for batched solves, or — when the
    vertex count `n` is given — (..., eta, N) per-vertex weights.  When
    ``n == eta`` an (eta, n)-shaped mu is read as per-vertex.  The result
    is (..., eta, 1) for the per-scale forms — never expanded to N.
    """
    mu_arr = torch.as_tensor(mu, device=device).to(dtype)
    if mu_arr.ndim == 0:
        mu_arr = mu_arr.expand(eta)
    if (n is not None and mu_arr.ndim >= 2
            and mu_arr.shape[-1] == n and mu_arr.shape[-2] == eta):
        return mu_arr * gamma  # per-vertex: already (..., eta, N)
    if mu_arr.shape[-1] != eta:
        per_vertex_hint = (
            f", or (..., eta, N) with N={n} for per-vertex weights"
            if n is not None else
            "; per-vertex (..., eta, N) weights need the vertex count")
        raise ValueError(
            f"mu trailing axis must be eta={eta}{per_vertex_hint}; "
            f"got shape {tuple(mu_arr.shape)}")
    return mu_arr[..., None] * gamma


def _signal_device(op):
    """The device an operator (or plan) computes on, None for an operator
    whose P decides it."""
    return getattr(op, "device", None)


def distributed_lasso(
    op: UnionMultiplier,
    y,
    mu,
    gamma: float = 0.2,
    n_iters: int = 300,
    a0: Optional[Tensor] = None,
    record_objective: bool = False,
    soft_threshold_fn: Callable = soft_threshold,
    backend: Optional[str] = None,
    mesh=None,
    device=None,
) -> LassoResult:
    """Algorithm 3.  `y` may be a single (N,) signal or a batched (..., N)
    stack — every signal rides the same Chebyshev rounds (the recurrence
    is linear).  `mu` may be a scalar, an (eta,)-vector (per-scale
    weights, as in the paper: 0.01 for scaling coefficients, 0.75 for
    wavelets), a per-signal (..., eta) array for batched y, or a
    per-vertex (..., eta, N) array.

    `op` may be a UnionMultiplier/GraphOperator or an already-built
    ExecutionPlan; passing `backend=` (and `device=`; None is the card)
    plans the operator here.

    Lines 5-7 of every iteration — the update with the Gram product
    Phi~ Phi~* a (Algorithms 2 then 1) and the shrinkage — run as one
    fused update (`kernels.ops.ista_launcher`, checked once per solve:
    the `ista_shrink` kernel on a CUDA tensor) when `soft_threshold_fn`
    is the default, written over the loop's own iterate (never over
    `a0` or phi_y); a custom shrinkage runs as given.  Both compute
    ``soft_threshold(a + gamma (phi_y - gram_a), mu gamma)``, the JAX
    package's loop.
    """
    from ..kernels import ops

    if backend is not None:
        plan = op.plan(backend, mesh=mesh, device=device)
        # the fused path supports none of the loop knobs — fall through to
        # the generic ISTA over the plan if any is set
        if (plan.solve_lasso_fn is not None and a0 is None
                and not record_objective
                and soft_threshold_fn is soft_threshold):
            return plan.solve_lasso(y, mu, gamma=gamma, n_iters=n_iters)
        op = plan
    y = torch.as_tensor(y, device=_signal_device(op))
    thresh = _mu_threshold(mu, op.eta, y.dtype, gamma, n=y.shape[-1],
                           device=y.device)

    phi_y = op.apply(y)  # Algorithm 3 line 3 (stored); (..., eta, N)
    # the loop owns a once it has written it, never the caller's a0
    owned = a0 is None
    a = torch.zeros_like(phi_y) if owned else torch.as_tensor(
        a0, device=phi_y.device)
    update = (ops.ista_launcher(phi_y, thresh, gamma)
              if soft_threshold_fn is soft_threshold else None)
    objs = []
    for _ in range(n_iters):
        # line 5: Phi~ Phi~* a    (Algorithm 2 then Algorithm 1)
        gram_a = op.apply(op.apply_adjoint(a))
        if update is not None:
            a = update(a, gram_a, out=a if owned else None)
            owned = True
        else:
            a = soft_threshold_fn(a + gamma * (phi_y - gram_a), thresh)
        if record_objective:
            objs.append(lasso_objective(op, y, a, thresh / gamma))
    objective = (torch.stack(objs) if record_objective and objs
                 else torch.full((n_iters,), float("nan"), dtype=y.dtype,
                                 device=y.device))
    signal = op.apply_adjoint(a)  # line 14
    return LassoResult(coeffs=a, signal=signal, objective=objective,
                       n_iters=n_iters)


def distributed_lasso_masked(
    op: UnionMultiplier,
    y,
    mask,
    mu,
    gamma: float = 0.2,
    n_iters: int = 150,
) -> LassoResult:
    """Algorithm 3 with a vertex observation mask M (data term
    ||M(y - Phi~* a)||^2/2): the ISTA gradient picks up M elementwise —
    still fully local, used by the cross-validation below.  The update and
    shrinkage run as one fused update (`kernels.ops.ista_launcher`) over
    the loop's own iterate."""
    from ..kernels import ops

    y = torch.as_tensor(y, device=_signal_device(op))
    thresh = _mu_threshold(mu, op.eta, y.dtype, gamma, n=y.shape[-1],
                           device=y.device)
    m = torch.as_tensor(mask, device=y.device).to(y.dtype)
    phi_my = op.apply(m * y)
    a = torch.zeros_like(phi_my)
    update = ops.ista_launcher(phi_my, thresh, gamma)
    for _ in range(n_iters):
        resid = m * op.apply_adjoint(a)
        update(a, op.apply(resid), out=a)
    return LassoResult(coeffs=a, signal=op.apply_adjoint(a),
                       objective=torch.tensor(float("nan")),
                       n_iters=n_iters)


def lasso_cross_validate(
    op: UnionMultiplier,
    y,
    mu_grid,
    generator: torch.Generator,
    holdout_frac: float = 0.2,
    n_folds: int = 3,
    gamma: float = 0.2,
    n_iters: int = 120,
):
    """Distributed cross-validation of the lasso weights mu (the optional
    extension the paper points to in Section VI / refs [29,30]).

    Random vertex subsets, drawn from `generator` (the counterpart of the
    JAX package's PRNG key), are held out; each candidate mu is fit on the
    observed vertices (masked ISTA) and scored by MSE on the held-out ones.
    Returns (best_mu, scores).
    """
    y = torch.as_tensor(y, device=_signal_device(op))
    n = y.shape[0]
    scores = []
    for mu in mu_grid:
        fold_mse = []
        for _ in range(n_folds):
            held = (torch.rand(n, generator=generator,
                               device=generator.device)
                    < holdout_frac).to(y.device)
            res = distributed_lasso_masked(op, y, ~held, mu, gamma=gamma,
                                           n_iters=n_iters)
            err = (res.signal - y) * held.to(y.dtype)
            fold_mse.append(float(torch.sum(err * err)
                                  / max(int(held.sum()), 1)))
        scores.append(sum(fold_mse) / n_folds)
    best = int(np.argmin(scores))
    return mu_grid[best], scores


def ista_step_size(op: UnionMultiplier, safety: float = 0.9) -> float:
    """gamma < 2/||Phi~||^2; we bound ||Phi~||^2 <= max_lambda sum_j
    p_j(lambda)^2 on a dense grid (B(K)-style estimate, host numpy)."""
    from .chebyshev import cheb_eval

    lam = np.linspace(0.0, op.lmax, 4000)
    vals = np.asarray(cheb_eval(np.asarray(op.coeffs), lam, op.lmax))
    frame = np.max(np.sum(vals**2, axis=0))
    return float(safety * 2.0 / max(frame, 1e-12))
