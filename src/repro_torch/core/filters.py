"""Multiplier (graph spectral filter) families from Section III of the paper.

Every function here returns a scalar callable g(lambda) suitable for
`UnionMultiplier` / `cheb_coeffs`. All are vectorized over numpy arrays;
the module is host numpy, a copy of the JAX package's own so that the
port imports nothing of it.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


# -- Section III-A: distributed Tikhonov denoising ---------------------------
def tikhonov(tau: float, r: int = 1) -> Callable:
    """Prop. 2: solution of argmin (tau/2)||f-y||^2 + f^T L^r f  is R y with
    g(lambda) = tau / (tau + 2 lambda^r)."""

    def g(lam):
        lam = np.asarray(lam, dtype=np.float64)
        return tau / (tau + 2.0 * np.power(np.maximum(lam, 0.0), r))

    return g


# -- Section III-B: distributed smoothing ------------------------------------
def heat(t: float) -> Callable:
    """Heat kernel lowpass g(lambda) = exp(-t lambda)."""

    def g(lam):
        return np.exp(-t * np.asarray(lam, dtype=np.float64))

    return g


# -- Section III-C: distributed inverse filtering -----------------------------
def inverse_filter(g_psi: Callable, tau: float, r: int = 1) -> Callable:
    """Prop. 3: regularized deconvolution multiplier
    h(lambda) = tau g_psi(lambda) / (tau g_psi(lambda)^2 + 2 lambda^r)."""

    def h(lam):
        lam = np.asarray(lam, dtype=np.float64)
        gp = np.asarray(g_psi(lam), dtype=np.float64)
        return tau * gp / (tau * gp * gp + 2.0 * np.power(np.maximum(lam, 0.0), r))

    return h


# -- Section III-D: semi-supervised classification kernels -------------------
def ssl_multiplier(h: Callable, tau: float) -> Callable:
    """Optimal multiplier for argmin tau||f - Y_j||^2 + f^T h(P) f:
    g(lambda) = tau / (tau + h(lambda))."""

    def g(lam):
        return tau / (tau + np.asarray(h(lam), dtype=np.float64))

    return g


def power_kernel(r: int = 1) -> Callable:
    """h(lambda) = lambda^r — Tikhonov RKHS (S = L^r or L_norm^r)."""

    def h(lam):
        return np.power(np.maximum(np.asarray(lam, dtype=np.float64), 0.0), r)

    return h


def diffusion_kernel(beta: float) -> Callable:
    """Smola-Kondor diffusion: S = [exp(-(beta^2/2) L_norm)]^{-1}, i.e.
    h(lambda) = exp((beta^2/2) lambda)."""

    def h(lam):
        return np.exp(0.5 * beta * beta * np.asarray(lam, dtype=np.float64))

    return h


def inverse_cosine_kernel() -> Callable:
    """Smola-Kondor inverse cosine: S = [cos(pi lambda / 4)]^{-1} on L_norm,
    i.e. h(lambda) = 1 / cos(pi lambda / 4) (finite on [0, 2])."""

    def h(lam):
        return 1.0 / np.cos(np.pi * np.asarray(lam, dtype=np.float64) / 4.0)

    return h


def random_walk_kernel(beta: float, r: int) -> Callable:
    """r-step random walk: S = (beta I - L_norm)^{-r}, beta >= 2,
    i.e. h(lambda) = (beta - lambda)^{-r}."""

    def h(lam):
        return np.power(beta - np.asarray(lam, dtype=np.float64), -float(r))

    return h


def identity_multiplier() -> Callable:
    return lambda lam: np.ones_like(np.asarray(lam, dtype=np.float64))


# -- Section V rational (num/den) solve specs ---------------------------------
# Monomial-coefficient forms (low-degree-first tuples) of the filters whose
# application the Section-V solvers frame as Q x = y: the solvers consume
# these as num=/den= and derive the Jacobi split, the accelerated weights
# and the ARMA pole/residue recursion from one spec (docs/PAPER_MAP.md
# Eqs. (23)-(30)).
def power_rational(tau: float, r: int = 1, scale: float = 1.0):
    """(num, den) of g(lambda) = tau / (tau + scale * lambda^r).

    scale=1 is the Section V-E / SSL family tau/(tau + lambda^r)
    (`ssl_multiplier(power_kernel(r), tau)`); scale=2 is Prop. 2's
    Tikhonov multiplier (see :func:`tikhonov_rational`)."""
    if r < 1:
        raise ValueError(f"r must be >= 1, got {r}")
    den = [float(tau)] + [0.0] * (r - 1) + [float(scale)]
    return (float(tau),), tuple(den)


def tikhonov_rational(tau: float, r: int = 1):
    """(num, den) of the Prop. 2 denoising multiplier tau/(tau + 2 lambda^r)
    — the rational form of :func:`tikhonov`, i.e. the exact-solver route to
    the Section IV-D denoising experiment (quickstart `--method jacobi`)."""
    return power_rational(tau, r, scale=2.0)


def inverse_filter_rational(psi_coeffs, tau: float, r: int = 1):
    """(num, den) of Prop. 3's regularized deconvolution multiplier for a
    *polynomial* blur g_psi(lambda) = sum_m psi_m lambda^m:

        h = tau g_psi / (tau g_psi^2 + 2 lambda^r),

    the rational form of :func:`inverse_filter`.  Computing h(P) y then
    solves (tau Psi^2 + 2 P^r) f = tau Psi y — `plan.solve` runs exactly
    that system distributed (numerator matvecs for the right-hand side,
    Jacobi/ARMA rounds for the solve)."""
    psi = np.asarray(psi_coeffs, dtype=np.float64)
    num = tau * psi
    den = tau * np.convolve(psi, psi)
    if len(den) < r + 1:
        den = np.concatenate([den, np.zeros(r + 1 - len(den))])
    den[r] += 2.0
    return tuple(float(c) for c in num), tuple(float(c) for c in den)


def random_walk_rational(tau: float, beta: float = 2.0, r: int = 3):
    """(num, den) of g = tau/(tau + (beta - lambda)^{-r}), the Fig. 2(c)
    random-walk setting (S = (beta I - L_norm)^{-r}): multiplying through by
    (beta - lambda)^r gives the biproper rational form
    tau (beta-l)^r / (tau (beta-l)^r + 1) whose partial fractions are the
    third-order ARMA recursion (`arma_random_walk_3` for tau=0.5, r=3)."""
    from numpy.polynomial import polynomial as npoly

    base = npoly.polypow([float(beta), -1.0], r)  # (beta - lambda)^r, low-first
    num = tau * np.asarray(base)
    den = num.copy()
    den[0] += 1.0
    return tuple(float(c) for c in num), tuple(float(c) for c in den)


# -- Section V-E experiment filters -------------------------------------------
def fig2_target(h: Callable, tau: float) -> Callable:
    """The Section V-E forward operator g(lambda) = (tau + h(lambda))/tau,
    whose inverse g^{-1} = tau/(tau+h) is what the methods compete to apply."""

    def g(lam):
        return (tau + np.asarray(h(lam), dtype=np.float64)) / tau

    return g
