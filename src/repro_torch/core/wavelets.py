"""Spectral graph wavelet transform multipliers (Hammond et al. [23]).

The distributed lasso of Section VI uses Phi = [h(L); g(t_1 L); ...; g(t_J L)]
— one lowpass scaling multiplier plus J bandpass wavelet multipliers. This
module reproduces the standard SGWT design (cubic-spline bandpass kernel,
log-spaced scales, Gaussian-like scaling function), matching the GSPBox
defaults the paper's experiments use.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


def wavelet_kernel(
    alpha: float = 2.0, beta: float = 2.0, x1: float = 1.0, x2: float = 2.0
) -> Callable:
    """Bandpass kernel g: monic power ascent, cubic-spline belly, power decay.

    g(x) = x1^{-alpha} x^alpha            for x <  x1
           cubic spline s(x)              for x1 <= x <= x2
           x2^{beta} x^{-beta}            for x >  x2

    With the default (2, 2, 1, 2) the spline is s(x) = -5 + 11x - 6x^2 + x^3
    (the SGWT toolbox default), giving a C^1 kernel with g(x1)=g(x2)=1.
    """
    # Solve for cubic s(x)=a0+a1 x+a2 x^2+a3 x^3 matching value+slope at x1,x2.
    v1, v2 = 1.0, 1.0
    d1 = alpha / x1  # slope of x1^{-a} x^a at x1 is a/x1
    d2 = -beta / x2
    A = np.array(
        [
            [1, x1, x1**2, x1**3],
            [1, x2, x2**2, x2**3],
            [0, 1, 2 * x1, 3 * x1**2],
            [0, 1, 2 * x2, 3 * x2**2],
        ],
        dtype=np.float64,
    )
    a = np.linalg.solve(A, np.array([v1, v2, d1, d2], dtype=np.float64))

    def g(x):
        x = np.asarray(x, dtype=np.float64)
        x = np.maximum(x, 0.0)
        lo = (x / x1) ** alpha
        mid = a[0] + a[1] * x + a[2] * x**2 + a[3] * x**3
        hi = np.where(x > 0, (x2 / np.maximum(x, 1e-30)) ** beta, 0.0)
        out = np.where(x < x1, lo, np.where(x <= x2, mid, hi))
        return out

    return g


def set_scales(lmax: float, J: int, lpfactor: float = 20.0,
               x1: float = 1.0, x2: float = 2.0) -> np.ndarray:
    """Log-spaced wavelet scales t_1 > ... > t_J (SGWT sgwt_setscales)."""
    lmin = lmax / lpfactor
    smin = x1 / lmax
    smax = x2 / lmin
    return np.exp(np.linspace(np.log(smax), np.log(smin), J))


def sgwt_multipliers(
    lmax: float,
    J: int = 6,
    lpfactor: float = 20.0,
    kernel: Callable = None,
) -> List[Callable]:
    """[h, g(t_1 .), ..., g(t_J .)] — the union of Section VI, eta = J+1."""
    g = kernel or wavelet_kernel()
    scales = set_scales(lmax, J, lpfactor)
    lmin = lmax / lpfactor
    # Scaling function: gamma * exp(-(x / (0.6 lmin))^4), gamma = max_t g.
    grid = np.linspace(0.0, lmax, 4000)
    gamma = float(max(np.max(g(t * grid)) for t in scales))

    def h(x, _gamma=gamma, _l=0.6 * lmin):
        x = np.asarray(x, dtype=np.float64)
        return _gamma * np.exp(-((x / _l) ** 4))

    mults: List[Callable] = [h]
    for t in scales:
        mults.append(lambda x, _t=t: g(_t * np.asarray(x, dtype=np.float64)))
    return mults


def sgwt_operator(P, lmax: float, J: int = 6, K: int = 20,
                  lpfactor: float = 20.0):
    """The Chebyshev-approximate spectral graph wavelet frame Phi_tilde.

    Returns a :class:`repro_torch.dist.GraphOperator` — a UnionMultiplier
    whose execution strategy is bound later via ``.plan(backend=...,
    device=...)``.  P is a dense (N, N) tensor or array.
    """
    from ..dist.operator import GraphOperator

    return GraphOperator(
        P=P, multipliers=sgwt_multipliers(lmax, J, lpfactor), lmax=lmax, K=K
    )


def frame_bounds(mults: Sequence[Callable], lmax: float, n_grid: int = 4000):
    """(A, B) frame bounds: A <= sum_j g_j(lambda)^2 <= B on [0, lmax]."""
    lam = np.linspace(0.0, lmax, n_grid)
    s = np.zeros_like(lam)
    for g in mults:
        s = s + np.asarray(g(lam)) ** 2
    return float(np.min(s)), float(np.max(s))
