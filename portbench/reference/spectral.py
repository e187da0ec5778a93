"""The plain reference of what the benchmark's cells compute.

Worked out from the graph alone (`reference.graph.SensorGraph`), in plain
PyTorch and numpy, imports nothing of the program and takes nothing the
program made: the Laplacian and its bound, the SGWT multipliers of
Hammond et al. (the GSPBox defaults the paper uses), the shifted-Chebyshev
coefficients of Eq. (14), Algorithm 1 (Phi~ f), its adjoint (Phi~* a)
and the Jacobi iteration of Eq. (24) on den(P) x = num(P) y.

Every operator is built at a `Precision`: `FLOAT64`, the reference that
decides `correct`, or `BFLOAT16`, the control that takes the program's
place one precision below the float32 the configurations state: every
value it keeps (weights, degrees, P's entries, lambda_max, the
coefficients, D^-1, the signals and every iterate) is rounded to
bfloat16, and each product and sum is formed in float32 first.

Signals are (B, n) (the adjoint's (B, eta, n)); inside, the vertex axis
comes first, so that one sparse product serves every column.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Precision:
    """The dtype a reference keeps its values in, and the one it forms
    each product and sum in."""

    name: str
    store: torch.dtype
    compute: torch.dtype

    def r(self, t: Tensor) -> Tensor:
        """`t` rounded to the kept precision, in the compute dtype."""
        t = t.to(self.compute)
        if self.store == self.compute:
            return t
        return t.to(self.store).to(self.compute)

    def s(self, v: float) -> float:
        """A host scalar rounded to the kept precision."""
        return float(torch.tensor(v, dtype=self.store))


FLOAT64 = Precision("float64", torch.float64, torch.float64)
BFLOAT16 = Precision("bfloat16", torch.bfloat16, torch.float32)


# ---------------------------------------------------------------------------
# Multipliers and coefficients (host, float64)
# ---------------------------------------------------------------------------
def wavelet_kernel(alpha: float = 2.0, beta: float = 2.0, x1: float = 1.0,
                   x2: float = 2.0) -> Callable:
    """The SGWT bandpass kernel: x^alpha below x1, the cubic spline that
    matches value and slope at x1 and x2, x^-beta above x2."""
    A = np.array([[1, x1, x1 ** 2, x1 ** 3], [1, x2, x2 ** 2, x2 ** 3],
                  [0, 1, 2 * x1, 3 * x1 ** 2], [0, 1, 2 * x2, 3 * x2 ** 2]],
                 dtype=np.float64)
    a = np.linalg.solve(A, np.array([1.0, 1.0, alpha / x1, -beta / x2]))

    def g(x):
        x = np.maximum(np.asarray(x, dtype=np.float64), 0.0)
        lo = (x / x1) ** alpha
        mid = a[0] + a[1] * x + a[2] * x ** 2 + a[3] * x ** 3
        hi = np.where(x > 0, (x2 / np.maximum(x, 1e-30)) ** beta, 0.0)
        return np.where(x < x1, lo, np.where(x <= x2, mid, hi))

    return g


def sgwt_multipliers(lmax: float, J: int, lpfactor: float = 20.0
                     ) -> List[Callable]:
    """[h, g(t_1 .), ..., g(t_J .)]: the scaling function and J wavelets
    at log-spaced scales (the SGWT toolbox's sgwt_setscales)."""
    g = wavelet_kernel()
    lmin = lmax / lpfactor
    scales = np.exp(np.linspace(np.log(2.0 / lmin), np.log(1.0 / lmax), J))
    grid = np.linspace(0.0, lmax, 4000)
    gamma = float(max(np.max(g(t * grid)) for t in scales))
    width = 0.6 * lmin

    def h(x):
        return gamma * np.exp(-((np.asarray(x, dtype=np.float64) / width)
                                ** 4))

    return [h] + [lambda x, t=t: g(t * np.asarray(x, dtype=np.float64))
                  for t in scales]


def tikhonov_multiplier(tau: float, r: int) -> Callable:
    """g(lambda) = tau / (tau + lambda^r)."""
    return lambda x: tau / (tau + np.maximum(np.asarray(x, np.float64),
                                             0.0) ** r)


def cheb_coeffs(gs: Sequence[Callable], K: int, lmax: float,
                points: int) -> np.ndarray:
    """(eta, K+1) coefficients of Eq. (14), half-c0 convention:
    c_k = (2/pi) int_0^pi cos(k phi) g(alpha (cos phi + 1)) dphi by the
    midpoint rule at `points` Chebyshev angles, alpha = lmax / 2."""
    phi = np.pi * (np.arange(points, dtype=np.float64) + 0.5) / points
    cos = np.cos(np.arange(K + 1, dtype=np.float64)[:, None] * phi[None])
    x = lmax / 2.0 * (np.cos(phi) + 1.0)
    return np.stack([(2.0 / points) * (cos * np.asarray(g(x))[None]).sum(1)
                     for g in gs])


# ---------------------------------------------------------------------------
# P and the operators
# ---------------------------------------------------------------------------
class SparseP:
    """A symmetric P in CSR, its entries kept at `prec`; ``P(X)`` for X
    (n, m) returns P X rounded to `prec`.  degrees: the graph's weighted
    degrees at `prec`, which P was made from."""

    def __init__(self, n: int, rows: Tensor, cols: Tensor, vals: Tensor,
                 prec: Precision, degrees: Tensor):
        self.degrees = degrees
        order = torch.argsort(rows * n + cols)
        rows, cols = rows[order], cols[order]
        self.vals = prec.r(vals[order])
        self.rows, self.cols, self.n, self.prec = rows, cols, n, prec
        crow = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
        crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support")
            self.A = torch.sparse_csr_tensor(crow, cols, self.vals, (n, n),
                                             check_invariants=True)

    def __call__(self, X: Tensor) -> Tensor:
        return self.prec.r(torch.sparse.mm(self.A, X))

    def diag_power(self, r: int) -> Tensor:
        """diag(P^r) for r = 1 or 2 (P symmetric)."""
        if r == 1:
            d = torch.zeros(self.n, dtype=self.vals.dtype,
                            device=self.vals.device)
            on = self.rows == self.cols
            return d.index_add_(0, self.rows[on], self.vals[on])
        if r == 2:
            sq = self.prec.r(self.vals * self.vals)
            d = torch.zeros(self.n, dtype=sq.dtype, device=sq.device)
            return self.prec.r(d.index_add_(0, self.rows, sq))
        raise ValueError(f"diag(P^{r}) is not in the reference")


def laplacian(graph, kind: str, prec: Precision) -> SparseP:
    """L = D - W ("combinatorial") or D^-1/2 L D^-1/2 ("normalized")."""
    w = prec.r(graph.w)
    d = prec.r(torch.zeros(graph.n, dtype=w.dtype,
                           device=w.device).index_add_(0, graph.rows, w))
    own = torch.arange(graph.n, device=w.device)
    if kind == "combinatorial":
        off, diag = -w, d
    elif kind == "normalized":
        inv = prec.r(1.0 / prec.r(torch.sqrt(d)))
        off = -prec.r(prec.r(inv[graph.rows] * w) * inv[graph.cols])
        diag = prec.r(prec.r(inv * d) * inv)
    else:
        raise ValueError(f"unknown Laplacian {kind!r}")
    return SparseP(graph.n, torch.cat([graph.rows, own]),
                   torch.cat([graph.cols, own]), torch.cat([off, diag]), prec,
                   degrees=d)


def lmax_bound(graph, P: SparseP, kind: str) -> float:
    """The Anderson-Morley bound max{d(m) + d(n) : m ~ n} (Section IV-B)
    for L; 2 for L_norm."""
    if kind == "normalized":
        return 2.0
    d = P.degrees
    pair = P.prec.r(d[graph.rows] + d[graph.cols])
    return P.prec.s(float(torch.maximum(pair.max(), d.max())))


@dataclasses.dataclass
class Operator:
    """The reference of one configuration at one precision."""

    P: SparseP
    lmax: float
    coeffs: Optional[np.ndarray]
    prec: Precision
    den: tuple = ()
    num: tuple = ()

    def _table(self) -> Tensor:
        return torch.as_tensor(self.coeffs, device=self.P.vals.device).to(
            self.prec.compute)

    def _orders(self, X: Tensor):
        """Yield T_k(P~) X for k = 0..K: T_1 = P X / alpha - X and
        T_k = (2 / alpha) P T_{k-1} - 2 T_{k-1} - T_{k-2}, alpha =
        lmax / 2 (Algorithm 1, lines 5 and 9)."""
        r = self.prec.r
        alpha = self.prec.s(self.lmax / 2.0)
        K = self.coeffs.shape[1] - 1
        t_km2 = X
        yield t_km2
        t_km1 = r(r(self.P(X) / alpha) - X)
        yield t_km1
        for _ in range(2, K + 1):
            t_k = r(r(r((2.0 / alpha) * self.P(t_km1)) - r(2.0 * t_km1))
                    - t_km2)
            yield t_k
            t_km2, t_km1 = t_km1, t_k

    def apply(self, x: Tensor) -> Tensor:
        """Phi~ x: (B, n) -> (B, eta, n), float64."""
        r = self.prec.r
        c = self._table()
        acc = None
        for k, t in enumerate(self._orders(r(x.t()).contiguous())):
            ck = 0.5 * c[:, k] if k == 0 else c[:, k]
            term = r(ck[:, None, None] * t[None])
            acc = term if acc is None else r(acc + term)
        return acc.permute(2, 0, 1).to(torch.float64)

    def adjoint(self, a: Tensor) -> Tensor:
        """Phi~* a = sum_j p_j(P) a_j: (B, eta, n) -> (B, n), float64."""
        r = self.prec.r
        B, eta, n = a.shape
        c = self._table()
        acc = None
        cols = r(a.reshape(B * eta, n).t()).contiguous()
        for k, t in enumerate(self._orders(cols)):
            ck = 0.5 * c[:, k] if k == 0 else c[:, k]
            term = r((t.view(n, B, eta) * ck).sum(-1))
            acc = term if acc is None else r(acc + term)
        return acc.t().to(torch.float64)

    def inv_d(self) -> Tensor:
        """D^-1 of the Jacobi split: 1 / diag(den(P)), den low degree
        first (the terms den[k] P^k with k <= 2)."""
        r = self.prec.r
        d = torch.full((self.P.n,), float(self.den[0]),
                       dtype=self.prec.compute, device=self.P.vals.device)
        for k, c in enumerate(self.den[1:], start=1):
            if c != 0.0:
                d = r(d + r(c * self.P.diag_power(k)))
        return r(1.0 / d)

    def _poly(self, coeffs, X: Tensor) -> Tensor:
        """p(P) X by Horner, coefficients low degree first."""
        r = self.prec.r
        acc = r(coeffs[-1] * X)
        for c in reversed(coeffs[:-1]):
            acc = r(self.P(acc) + r(c * X))
        return acc

    def jacobi(self, y: Tensor, rounds: int) -> Tensor:
        """`rounds` Jacobi rounds of Eq. (24) from x = 0 on den(P) x =
        num(P) y: x <- x + D^-1 (num(P) y - den(P) x).  (B, n) -> (B, n),
        float64."""
        r = self.prec.r
        b = self._poly(self.num, r(y.t()).contiguous())
        inv_d = self.inv_d()[:, None]
        x = torch.zeros_like(b)
        for _ in range(rounds):
            x = r(x + r(inv_d * r(b - self._poly(self.den, x))))
        return x.t().to(torch.float64)


def _kept(c: np.ndarray, prec: Precision) -> np.ndarray:
    """A coefficient table as `prec` keeps it, in float64."""
    return prec.r(torch.as_tensor(c)).to(torch.float64).numpy()


def sgwt_operator(graph, J: int, K: int, lpfactor: float, points: int,
                  prec: Precision) -> Operator:
    """The SGWT union on P = L, lambda_max the Anderson-Morley bound."""
    P = laplacian(graph, "combinatorial", prec)
    lmax = lmax_bound(graph, P, "combinatorial")
    c = cheb_coeffs(sgwt_multipliers(lmax, J, lpfactor), K, lmax, points)
    return Operator(P=P, lmax=lmax, coeffs=_kept(c, prec), prec=prec)


def tikhonov_operator(graph, kind: str, tau: float, r: int, K: int,
                      points: int, prec: Precision) -> Operator:
    """The Tikhonov filter tau / (tau + lambda^r) on P = L or L_norm:
    its Chebyshev series and its rational form num = (tau,), den = (tau,
    0, ..., 0, 1)."""
    P = laplacian(graph, kind, prec)
    lmax = lmax_bound(graph, P, kind)
    c = _kept(cheb_coeffs([tikhonov_multiplier(tau, r)], K, lmax, points),
              prec)
    den = (prec.s(tau),) + (0.0,) * (r - 1) + (1.0,)
    return Operator(P=P, lmax=lmax, coeffs=c, prec=prec, den=den,
                    num=(prec.s(tau),))
