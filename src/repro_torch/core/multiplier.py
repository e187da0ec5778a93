"""Graph multiplier operators and unions thereof (Section II, Definition 1),
PyTorch port.

`UnionMultiplier` is built from a PSD matrix P (a dense tensor or a matvec
closure), a list of multiplier functions g_j, an upper bound on lambda_max
and an approximation order K.  It exposes

  .apply(f)         ~ Phi f        (Chebyshev, Algorithm 1)
  .apply_adjoint(a) ~ Phi^* a      (Chebyshev, Algorithm 2)
  .apply_gram(f)    ~ Phi^*Phi f   (product coefficients, Section IV-C)
  .exact_apply(f)   = Phi f        (dense eigendecomposition oracle, Eq. (3))
  .error_bound()    = B(K) sqrt(eta)  (Prop. 4)

These run on whatever device P and the signal lie on; `.plan(...)` binds
an execution backend and a device.  The exact oracle is O(N^3) and exists
for validation only.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Callable, Sequence, Union

import numpy as np
import torch

from . import chebyshev as cheb

Tensor = torch.Tensor


def _as_matvec(P: Union[Tensor, np.ndarray, Callable[[Tensor], Tensor]]):
    """P as a map along the *last* axis of its argument, broadcasting over
    leading batch axes (the repo-wide (..., N) signal contract)."""
    if callable(P):
        return P
    Pm = torch.as_tensor(P)

    def mv(x: Tensor) -> Tensor:
        return torch.matmul(x, Pm.mT)

    return mv


@dataclasses.dataclass(frozen=True)
class UnionMultiplier:
    """Union of eta graph multiplier operators w.r.t. a PSD matrix P."""

    P: Union[Tensor, np.ndarray, Callable[[Tensor], Tensor]]
    multipliers: Sequence[Callable]
    lmax: float
    K: int = 20
    coeff_points: int = 1000

    @property
    def eta(self) -> int:
        return len(self.multipliers)

    @cached_property
    def coeffs(self) -> np.ndarray:
        return cheb.cheb_coeffs_stack(
            self.multipliers, self.K, self.lmax, self.coeff_points)

    @cached_property
    def matvec(self):
        return _as_matvec(self.P)

    # -- Chebyshev-approximate applications ---------------------------------
    def apply(self, f: Tensor) -> Tensor:
        """Phi_tilde f; f: (..., N) -> (..., eta, N)."""
        return cheb.cheb_apply(self.matvec, f, self.coeffs, self.lmax)

    def apply_adjoint(self, a: Tensor) -> Tensor:
        """Phi_tilde^* a; a: (..., eta, N) -> (..., N)."""
        return cheb.cheb_apply_adjoint(self.matvec, a, self.coeffs, self.lmax)

    def apply_gram(self, f: Tensor) -> Tensor:
        """Phi_tilde^* Phi_tilde f; f: (..., N) -> (..., N)."""
        return cheb.cheb_apply_gram(self.matvec, f, self.coeffs, self.lmax)

    # -- Exact oracle ---------------------------------------------------------
    @cached_property
    def _eig(self):
        if callable(self.P):
            raise ValueError("exact oracle needs a dense P")
        return torch.linalg.eigh(torch.as_tensor(self.P))

    def exact_apply(self, f: Tensor) -> Tensor:
        """Phi f by Eq. (3) — dense eigendecomposition, validation only.

        f: (..., N) -> (..., eta, N), matching the Chebyshev `apply`."""
        lam, U = self._eig
        U = U.to(f.dtype)
        fhat = f @ U                                   # U^T f along last axis
        lam_np = lam.numpy(force=True)
        outs = []
        for g in self.multipliers:
            glam = torch.as_tensor(np.asarray(g(lam_np)), dtype=f.dtype,
                                   device=f.device)
            outs.append((glam * fhat) @ U.mT)
        return torch.stack(outs, dim=-2)

    def exact_apply_adjoint(self, a: Tensor) -> Tensor:
        """a: (..., eta, N) -> (..., N)."""
        lam, U = self._eig
        U = U.to(a.dtype)
        lam_np = lam.numpy(force=True)
        acc = None
        for j, g in enumerate(self.multipliers):
            glam = torch.as_tensor(np.asarray(g(lam_np)), dtype=a.dtype,
                                   device=a.device)
            term = (glam * (a[..., j, :] @ U)) @ U.mT
            acc = term if acc is None else acc + term
        return acc

    # -- Error bound (Prop. 4) -------------------------------------------------
    def B(self) -> float:
        return cheb.approx_error_bound(self.multipliers, self.coeffs,
                                       self.lmax)

    def error_bound(self) -> float:
        """Prop. 4: ||Phi - Phi_tilde||_2 <= B(K) sqrt(eta)."""
        return self.B() * float(np.sqrt(self.eta))

    # -- Execution planning (see repro_torch.dist.operator) -------------------
    def plan(self, backend: str = "dense", *, mesh=None, partition=None,
             device=None, **options):
        """Bind an execution strategy from the backend registry.

        Returns an ExecutionPlan with uniform `apply / apply_adjoint /
        apply_gram`.  `backend` is one of
        `repro_torch.dist.available_backends()` ("dense", "cuda"; sharded:
        "halo", "cuda_halo", "allgather").  The sharded backends take
        ``mesh=``, a `torch.distributed` process group (None: the default
        group when one is initialized, else one shard); every rank passes
        the same global signal and gets the same global result.
        `device=None` means the CUDA card ``cuda:<rank % device_count>``;
        the plan raises `RuntimeError` when there is none and never falls
        back to the CPU.  Pass ``device="cpu"`` to run the plain PyTorch
        versions on the host.
        """
        from ..dist.backends import get_backend

        return get_backend(backend)(self, mesh=mesh, partition=partition,
                                    device=device, **options)

    # -- Communication model (Section IV-B/C) ---------------------------------
    def message_counts(self, n_edges: int) -> dict:
        """The paper's communication accounting for one application."""
        return {
            "apply_messages": 2 * self.K * n_edges,
            "apply_message_len": 1,
            "adjoint_messages": 2 * self.K * n_edges,
            "adjoint_message_len": self.eta,
            "gram_messages": 4 * self.K * n_edges,
            "gram_message_len": 1,
        }


def graph_multiplier(
    P: Union[Tensor, np.ndarray, Callable],
    g: Callable,
    lmax: float,
    K: int = 20,
    coeff_points: int = 1000,
) -> "ScalarMultiplier":
    return ScalarMultiplier(
        UnionMultiplier(P=P, multipliers=[g], lmax=lmax, K=K,
                        coeff_points=coeff_points))


@dataclasses.dataclass(frozen=True)
class ScalarMultiplier:
    """Single graph multiplier operator — squeezes the union axis."""

    union: UnionMultiplier

    def apply(self, f: Tensor) -> Tensor:
        return self.union.apply(f)[..., 0, :]

    def exact_apply(self, f: Tensor) -> Tensor:
        return self.union.exact_apply(f)[..., 0, :]

    def error_bound(self) -> float:
        return self.union.error_bound()

    @property
    def coeffs(self) -> np.ndarray:
        return self.union.coeffs[0]

    @property
    def K(self) -> int:
        return self.union.K

    @property
    def lmax(self) -> float:
        return self.union.lmax
