"""Parallel ARMA (rational / IIR) graph filters — Section V-D, Eqs. (29)-(30),
PyTorch port.

A rational filter written in pole/residue form

    g~(lambda) = const + sum_k 2 r_k / (lmax - lmin - 2 lambda - 2 p_k)   (29)

is applied by iterating, for each k in parallel,

    x_k^{(t+1)} = (1/p_k) [ ((lmax - lmin)/2) I - P ] x_k^{(t)} - (r_k/p_k) y
                                                                          (30)
and summing x = const*y + sum_k x_k.  Convergence requires
|p_k| > (lmax - lmin)/2 for all k (Loukas et al. [35]).

The pole/residue algebra is host numpy, as in the JAX package.  Poles and
residues may be complex (conjugate pairs for real filters): the iterates
are complex (complex64 for float32 signals, complex128 for float64), and
the complex iterate is carried through the matvec as a real [Re, Im] stack
on the leading axes — so one iteration issues exactly ONE matvec, and the
matvec (the Block-ELL SpMV kernel on the card) only ever sees real data.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
MatVec = Callable[[Tensor], Tensor]


def arma_from_partial_fractions(
    poles: Sequence[complex],
    residues: Sequence[complex],
    lmax: float,
    lmin: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Convert g(lambda) = sum_i rho_i/(lambda - lambda_i) to ARMA (r, p).

    2 r/(lmax - lmin - 2 lambda - 2 p) = -r/(lambda - ((lmax-lmin)/2 - p)),
    so p_i = (lmax-lmin)/2 - lambda_i and r_i = -rho_i.
    """
    mid = (lmax - lmin) / 2.0
    p = np.array([mid - li for li in poles], dtype=np.complex128)
    r = np.array([-ri for ri in residues], dtype=np.complex128)
    return r, p


def arma_from_rational(
    num: Sequence[float],
    den: Sequence[float],
    lmax: float,
    lmin: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """ARMA (r, p, const) for an arbitrary rational g = num(lambda)/den(lambda).

    `num` / `den` are monomial coefficients low-degree-first (index m is the
    lambda^m coefficient).  Requires deg(num) <= deg(den) and simple
    (pairwise-distinct) denominator roots; the partial-fraction residues are
    rho_i = rem(lambda_i) / den'(lambda_i) with `rem` the polynomial-division
    remainder, and the poles map through
    :func:`arma_from_partial_fractions`.  Generalizes the ready-made
    Section V-E presets below — e.g. `arma_from_rational((tau,), (tau, 1.0),
    lmax)` reproduces :func:`arma_tikhonov_first_order`.
    """
    num_hi = np.trim_zeros(np.asarray(num, dtype=np.float64)[::-1], "f")
    den_hi = np.trim_zeros(np.asarray(den, dtype=np.float64)[::-1], "f")
    if den_hi.size == 0:
        raise ValueError("den must be a nonzero polynomial")
    if num_hi.size > den_hi.size:
        raise ValueError(
            f"deg(num)={num_hi.size - 1} > deg(den)={den_hi.size - 1}: "
            "g must be proper (or at most biproper) for the ARMA form (29)")
    if den_hi.size == 1:
        raise ValueError("den is constant — g is polynomial, use Chebyshev")
    if num_hi.size == 0:
        num_hi = np.zeros(1)
    # deg(num) <= deg(den), so the quotient is the constant term of g
    quo, rem = np.polydiv(num_hi, den_hi)
    const = float(quo[-1])
    roots = np.roots(den_hi)
    if roots.size > 1:
        dist = np.abs(roots[:, None] - roots[None, :])
        np.fill_diagonal(dist, np.inf)
        scale = max(float(np.abs(roots).max()), 1.0)
        if float(dist.min()) < 1e-8 * scale:
            raise ValueError(
                "den has (numerically) repeated roots — the simple-pole "
                "partial-fraction form (29) does not apply")
    dden = np.polyder(den_hi)
    residues = [np.polyval(rem, li) / np.polyval(dden, li) for li in roots]
    r, p = arma_from_partial_fractions(list(roots), residues, lmax, lmin)
    return r, p, const


def arma_stable(p: np.ndarray, lmax: float, lmin: float = 0.0) -> bool:
    """Convergence check |p_k| > (lmax - lmin)/2 (Section V-D)."""
    return bool(np.all(np.abs(p) > (lmax - lmin) / 2.0))


def arma_eval(r: np.ndarray, p: np.ndarray, lam, lmax: float,
              lmin: float = 0.0, const: float = 0.0):
    """Evaluate the rational filter (29) at scalar abscissae (for tests)."""
    lam = np.asarray(lam, dtype=np.float64)
    out = np.full(lam.shape, const, dtype=np.complex128)
    for rk, pk in zip(r, p):
        out = out + 2.0 * rk / (lmax - lmin - 2.0 * lam - 2.0 * pk)
    return out.real


def _complex_matvec(matvec: MatVec) -> Callable[[Tensor], Tensor]:
    """Apply a real matvec to a complex iterate as one [Re, Im] stack.

    The stack rides the matvec's leading batch dims ((..., N) contract), so
    the complex application still costs ONE matvec — and the matvec only
    ever sees real tensors (splitting into `.real` / `.imag` and rebuilding
    with `torch.complex` is exact)."""

    def mv(z: Tensor) -> Tensor:
        st = torch.stack([z.real, z.imag])
        out = matvec(st)
        return torch.complex(out[0], out[1])

    return mv


def arma_apply(
    matvec: MatVec,
    y: Tensor,
    r: np.ndarray,
    p: np.ndarray,
    lmax: float,
    lmin: float = 0.0,
    n_iters: int = 50,
    const: float = 0.0,
    return_history: bool = False,
):
    """Iterate (30) for each (r_k, p_k) in parallel; return const*y + sum_k x_k.

    y: (..., N) batched signals; `matvec` must follow the (..., N) contract
    (contract the LAST axis, broadcast over leading dims).  The poles are
    stacked on a leading axis and the complex iterate is carried as a real
    [Re, Im] stack, so each iteration costs exactly one matvec for the
    whole batch.  With `return_history=True` also returns the
    (n_iters, ..., N) real iterate history.
    """
    cdt = torch.complex128 if y.dtype == torch.float64 else torch.complex64
    rj = torch.as_tensor(np.asarray(r), device=y.device).to(cdt)
    pj = torch.as_tensor(np.asarray(p), device=y.device).to(cdt)
    mid = (lmax - lmin) / 2.0
    yc = y.to(cdt)
    Kp = rj.shape[0]
    x = torch.zeros((Kp,) + tuple(y.shape), dtype=cdt, device=y.device)
    mv = _complex_matvec(matvec)
    shape = (Kp,) + (1,) * y.ndim
    inv_p = (1.0 / pj).reshape(shape)
    r_over_p = (rj / pj).reshape(shape)
    hist = []
    for _ in range(n_iters):
        # (1/p_k)(mid I - P) x_k - (r_k/p_k) y
        Mx = mid * x - mv(x)
        x = inv_p * Mx - r_over_p * yc[None]
        if return_history:
            hist.append((const * yc + torch.sum(x, dim=0)).real)
    result = (const * yc + torch.sum(x, dim=0)).real.to(y.dtype)
    if return_history:
        h = (torch.stack(hist) if hist
             else y.new_empty((0,) + tuple(y.shape)))
        return result, h.to(y.dtype)
    return result


# -- Ready-made pole/residue sets used in Section V-E -------------------------
def arma_tikhonov_first_order(tau: float, lmax: float):
    """g(lambda) = tau/(tau + lambda): single real pole at -tau.
    g = tau/(lambda+tau) => rho = tau at pole lambda = -tau."""
    r, p = arma_from_partial_fractions([-tau], [tau], lmax)
    return r, p, 0.0


def arma_tikhonov_second_order(tau: float, lmax: float):
    """g(lambda) = tau/(tau + lambda^2) (Section V-E, P = L, S = L^2).

    Poles at lambda = +- i sqrt(tau); g = tau/((l - i s)(l + i s)), s=sqrt(tau)
    residues rho = tau / (2 lambda_pole) = -+ i sqrt(tau)/2.
    Matches the paper's p_{1,2} = +-sqrt(tau) i + lmax/2, r_{1,2} = -+ sqrt(tau) i / 2.
    """
    s = np.sqrt(tau)
    poles = [1j * s, -1j * s]
    residues = [tau / (2j * s), -tau / (2j * s)]
    r, p = arma_from_partial_fractions(poles, residues, lmax)
    return r, p, 0.0


def arma_random_walk_3(tau: float, lmax: float):
    """g(lambda) = 1 - 2/((2-lambda)^3 + 2)  (Section V-E third setting,
    S = (2 I - L_norm)^{-3}, tau = 0.5 gives the paper's filter; here we keep
    tau general: g = tau/(tau + (2-lambda)^{-3}) = 1 - tau'/( (2-l)^3 + tau')
    with tau' = 1/tau).

    Partial fractions computed numerically from the cubic's roots.
    """
    tp = 1.0 / tau
    # Poles where (2 - lambda)^3 = -tp:  2 - lambda = tp^{1/3} e^{i pi (2m+1)/3}.
    cbrt = tp ** (1.0 / 3.0)
    poles = [2.0 - cbrt * np.exp(1j * np.pi * (2 * m + 1) / 3.0) for m in range(3)]
    # f(l) = -tp / D(l) with D(l) = (2-l)^3 + tp, D'(l) = -3 (2-l)^2;
    # residue of f at pole li is -tp / D'(li).
    residues = [-tp / (-3.0 * (2.0 - li) ** 2) for li in poles]
    r, p = arma_from_partial_fractions(poles, residues, lmax)
    return r, p, 1.0
