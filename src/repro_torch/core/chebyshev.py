"""Shifted Chebyshev polynomial machinery (Section IV of the paper), PyTorch
port.

Host numpy (bitwise the JAX package's arithmetic):
  * truncated shifted-Chebyshev coefficients c_{j,k} of Eq. (14) by
    Chebyshev-Gauss quadrature (`cheb_coeffs`, `cheb_coeffs_stack`);
  * scalar series evaluation and the B(K) bound of Prop. 4;
  * product / Gram coefficients of Section IV-C.

Torch over a matvec callable (applies P along the last axis of a tensor,
broadcasting over leading batch axes):
  * union application   f -> Phi_tilde f          (Algorithm 1, Eq. (17));
  * adjoint application a -> Phi_tilde^* a        (Algorithm 2, Eq. (19));
  * Gram application    f -> Phi_tilde^* Phi_tilde f with 2K matvecs.

Conventions follow the paper: a series is (c_0, ..., c_K) with
g(x) ~= c_0/2 + sum_{k>=1} c_k Tbar_k(x), Tbar_k(x) = T_k((x - alpha)/alpha),
alpha = lmax/2, on x in [0, lmax].
"""
from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch

Tensor = torch.Tensor
MatVec = Callable[[Tensor], Tensor]


def _stateful_matvec(matvec: MatVec, x: Tensor):
    """Adapt `matvec` to the dual-signature stateful protocol.

    Matvecs that carry cross-order state (the int8 error-feedback exchange)
    expose an ``init_state(x)`` attribute and accept ``matvec(x, state) ->
    (y, state)``.  Plain matvecs keep their stateless signature and get an
    empty-state shim, so every recurrence threads state uniformly.

    Returns ``(mv2, state0)`` with ``mv2(v, s) -> (y, s')``.
    """
    init_state = getattr(matvec, "init_state", None)
    if init_state is None:
        return (lambda v, s: (matvec(v), s)), ()
    return matvec, init_state(x)


# ---------------------------------------------------------------------------
# Coefficients — Eq. (14)
# ---------------------------------------------------------------------------
def cheb_coeffs(
    g: Callable[[np.ndarray], np.ndarray],
    K: int,
    lmax: float,
    n_points: int = 1000,
    dtype=np.float64,
) -> np.ndarray:
    """Truncated shifted-Chebyshev coefficients of `g` on [0, lmax].

    c_k = (2/pi) * integral_0^pi cos(k phi) g(alpha (cos phi + 1)) dphi,
    evaluated with the midpoint rule at Chebyshev angles (Chebyshev-Gauss
    quadrature).  Returns shape (K+1,) in the paper's half-c0 convention.
    """
    alpha = lmax / 2.0
    m = np.arange(n_points, dtype=dtype)
    phi = np.pi * (m + 0.5) / n_points
    vals = np.asarray(g(alpha * (np.cos(phi) + 1.0)), dtype=dtype)
    ks = np.arange(K + 1, dtype=dtype)[:, None]
    c = (2.0 / n_points) * np.sum(np.cos(ks * phi[None, :]) * vals[None, :],
                                  axis=1)
    return c.astype(dtype)


def cheb_coeffs_stack(
    gs: Sequence[Callable[[np.ndarray], np.ndarray]],
    K: int,
    lmax: float,
    n_points: int = 1000,
) -> np.ndarray:
    """Coefficients for a union of multipliers; shape (eta, K+1)."""
    return np.stack([cheb_coeffs(g, K, lmax, n_points) for g in gs], axis=0)


# ---------------------------------------------------------------------------
# Scalar polynomial evaluation (for bounds / tests)
# ---------------------------------------------------------------------------
def cheb_eval(coeffs: np.ndarray, x, lmax: float) -> np.ndarray:
    """Evaluate the truncated series at abscissae x in [0, lmax] (float64).

    coeffs: (K+1,) or (eta, K+1).  Returns x.shape or (eta,) + x.shape.
    """
    coeffs = np.asarray(coeffs, dtype=np.float64)
    c = np.atleast_2d(coeffs)
    x = np.asarray(x, dtype=np.float64)
    alpha = lmax / 2.0
    y = (x - alpha) / alpha
    K = c.shape[1] - 1
    col = (...,) + (None,) * y.ndim
    t_km2 = np.ones_like(y)
    acc = 0.5 * c[:, 0][col] * t_km2
    if K >= 1:
        t_km1 = y
        acc = acc + c[:, 1][col] * t_km1
        for k in range(2, K + 1):
            t_k = 2.0 * y * t_km1 - t_km2
            acc = acc + c[:, k][col] * t_k
            t_km2, t_km1 = t_km1, t_k
    return acc[0] if coeffs.ndim == 1 else acc


def approx_error_bound(
    gs: Sequence[Callable],
    coeffs: np.ndarray,
    lmax: float,
    n_grid: int = 4000,
) -> float:
    """B(K) of Prop. 4 Eq. (20): max_j sup_{lambda in [0,lmax]} |g_j - p_j^K|,
    estimated on a dense grid."""
    lam = np.linspace(0.0, lmax, n_grid)
    approx = np.atleast_2d(cheb_eval(coeffs, lam, lmax))
    worst = 0.0
    for j, g in enumerate(gs):
        exact = np.asarray(g(lam))
        worst = max(worst, float(np.max(np.abs(exact - approx[j]))))
    return worst


# ---------------------------------------------------------------------------
# Operator application — Algorithm 1 / Eq. (17)
# ---------------------------------------------------------------------------
def _coeff_tensor(coeffs, like: Tensor) -> Tensor:
    """`coeffs` in `like`'s dtype on its device: a table already there is
    returned as it is (no copy), so a plan that keeps its tables on the
    card makes no host-to-device copy per call."""
    if isinstance(coeffs, Tensor):
        return coeffs.to(dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(coeffs), dtype=like.dtype,
                           device=like.device)


def _outer(c: Tensor, t: Tensor) -> Tensor:
    """(eta,) x (..., N) -> (..., eta, N): per-multiplier scaled copies."""
    return c[:, None] * t[..., None, :]


def cheb_apply(
    matvec: MatVec,
    x: Tensor,
    coeffs: Union[Tensor, np.ndarray],
    lmax: float,
) -> Tensor:
    """Compute Phi_tilde x for a union of multipliers given by `coeffs`.

    x: (..., N) — leading axes are batch signals riding the same recurrence.
    coeffs: (K+1,) single multiplier or (eta, K+1) union.
    Returns (..., N) (single) or (..., eta, N) (union).  One matvec per
    Chebyshev order, as in Algorithm 1 lines 6-10.
    """
    c = _coeff_tensor(coeffs, x)
    single = c.ndim == 1
    c = torch.atleast_2d(c)
    K = c.shape[1] - 1
    alpha = lmax / 2.0

    t0 = x
    acc = _outer(0.5 * c[:, 0], t0)
    if K >= 1:
        mv2, st = _stateful_matvec(matvec, x)
        # Tbar_1(P) x = (P x)/alpha - x     (Algorithm 1 line 5)
        px, st = mv2(x, st)
        t1 = px / alpha - x
        acc = acc + _outer(c[:, 1], t1)
        t_km1, t_km2 = t1, t0
        for k in range(2, K + 1):
            # Tbar_k = (2/alpha) P t_{k-1} - 2 t_{k-1} - t_{k-2}   (line 9)
            pt, st = mv2(t_km1, st)
            t_k = (2.0 / alpha) * pt - 2.0 * t_km1 - t_km2
            acc = acc + _outer(c[:, k], t_k)
            t_km1, t_km2 = t_k, t_km1
    return acc[..., 0, :] if single else acc


def cheb_apply_adjoint(
    matvec: MatVec,
    a: Tensor,
    coeffs: Union[Tensor, np.ndarray],
    lmax: float,
) -> Tensor:
    """Compute Phi_tilde^* a per Eq. (19) / Algorithm 2.

    a: (..., eta, N) stacked coefficient signals; coeffs: (eta, K+1).
    Returns (..., N).  Each order applies P to all eta streams (and all
    batch signals) at once — the paper's length-eta messages.
    """
    c = _coeff_tensor(coeffs, a)
    if c.ndim != 2 or a.shape[-2] != c.shape[0]:
        raise ValueError(f"eta mismatch: a {tuple(a.shape)}, "
                         f"coeffs {tuple(c.shape)}")
    K = c.shape[1] - 1
    alpha = lmax / 2.0

    def combine(ck: Tensor, t: Tensor) -> Tensor:
        # sum_j ck[j] * t[..., j, :]
        return torch.einsum("j,...jn->...n", ck, t)

    t0 = a
    acc = combine(0.5 * c[:, 0], t0)
    if K >= 1:
        mv2, st = _stateful_matvec(matvec, a)
        pa, st = mv2(a, st)
        t1 = pa / alpha - a
        acc = acc + combine(c[:, 1], t1)
        t_km1, t_km2 = t1, t0
        for k in range(2, K + 1):
            pt, st = mv2(t_km1, st)
            t_k = (2.0 / alpha) * pt - 2.0 * t_km1 - t_km2
            acc = acc + combine(c[:, k], t_k)
            t_km1, t_km2 = t_k, t_km1
    return acc


# ---------------------------------------------------------------------------
# Product / Gram coefficients — Section IV-C
# ---------------------------------------------------------------------------
def cheb_product_coeffs(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Coefficients of the product of two truncated series (paper convention).

    Uses T_j T_k = (T_{j+k} + T_{|j-k|}) / 2.  Degrees K1 and K2 give a
    product of degree K1+K2, shape (K1+K2+1,).
    """
    a = np.array(c1, dtype=np.float64).copy()
    b = np.array(c2, dtype=np.float64).copy()
    a[0] *= 0.5  # half-c0 convention -> plain coefficients
    b[0] *= 0.5
    K1, K2 = len(a) - 1, len(b) - 1
    out = np.zeros(K1 + K2 + 1, dtype=np.float64)
    for j in range(K1 + 1):
        if a[j] == 0.0:
            continue
        for k in range(K2 + 1):
            v = 0.5 * a[j] * b[k]
            if v == 0.0:
                continue
            out[j + k] += v
            out[abs(j - k)] += v
    out[0] *= 2.0  # back to half-c0 convention
    return out


def gram_coeffs(coeffs: np.ndarray) -> np.ndarray:
    """d_k such that Phi_tilde^* Phi_tilde = d0/2 + sum_k d_k Tbar_k(P).

    coeffs: (eta, K+1).  Returns (2K+1,): Phi^*Phi f costs 2K matvecs.
    """
    coeffs = np.atleast_2d(np.asarray(coeffs, dtype=np.float64))
    K = coeffs.shape[1] - 1
    d = np.zeros(2 * K + 1, dtype=np.float64)
    for j in range(coeffs.shape[0]):
        d += cheb_product_coeffs(coeffs[j], coeffs[j])
    return d


def cheb_apply_gram(
    matvec: MatVec,
    x: Tensor,
    coeffs: np.ndarray,
    lmax: float,
) -> Tensor:
    """Phi_tilde^* Phi_tilde x via the product coefficients (Section IV-C).

    x: (..., N) -> (..., N); batch signals share the 2K rounds."""
    return cheb_apply(matvec, x, gram_coeffs(coeffs), lmax)
