"""Distributed semi-supervised / transductive classification (Section III-D),
PyTorch port.

Implements the 4-step recipe at the end of Section III-D: build the label
matrix Y, apply the optimal multiplier R (g(lambda) = tau/(tau + h(lambda)))
to each class column — one batched application on the (N, kappa) matrix:
the Chebyshev recurrence is linear, so all classes share the K rounds
(on the `cuda` backend, one sweep launch) — then argmax per node.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from . import filters

Tensor = torch.Tensor


def label_matrix(labels, mask, n_classes: int) -> Tensor:
    """Y in R^{N x kappa}: Y_ij = 1 iff node i is labeled (mask) with class j."""
    labels = torch.as_tensor(labels)
    mask = torch.as_tensor(mask, device=labels.device)
    onehot = torch.nn.functional.one_hot(labels.long(), n_classes)
    return onehot.float() * mask[:, None].float()


@dataclasses.dataclass
class SSLResult:
    scores: Tensor       # F^opt, (N, kappa)
    predictions: Tensor  # argmax_j F^opt_{nj}, (N,)


def _plan_dtype(plan) -> torch.dtype:
    """The dtype the plan's operator computes in: the kernel backend's
    Block-ELL blocks, else the dense P's floating dtype."""
    A = plan.info.get("block_ell")
    if A is not None:
        return A.blocks.dtype
    P = plan.op.P
    if isinstance(P, Tensor) and P.is_floating_point():
        return P.dtype
    return torch.float32


def semi_supervised_classify(
    P,
    labels,
    labeled_mask,
    n_classes: int,
    h: Optional[Callable] = None,
    tau: float = 1.0,
    lmax: Optional[float] = None,
    K: int = 20,
    backend: str = "dense",
    mesh=None,
    device=None,
) -> SSLResult:
    """Steps 1-4 of Section III-D.

    P: PSD matrix with the graph's sparsity pattern (L, L_norm, or
    K-scaling).  h: RKHS kernel spectral function (default: identity,
    i.e. S = P).  backend / device: execution strategy and device of the
    multiplier application (any registered repro_torch.dist backend;
    ``device=None`` is the card, as for every plan).  The label matrix and
    the scores take the plan's dtype (float32 on the kernel backend, P's
    own on the dense one).
    """
    from ..dist.operator import GraphOperator

    if lmax is None:
        lam = torch.linalg.eigvalsh(torch.as_tensor(P))
        lmax = float(lam[-1]) * 1.01
    h = h or filters.power_kernel(1)
    g = filters.ssl_multiplier(h, tau)
    R = GraphOperator(P=P, multipliers=[g], lmax=lmax, K=K)
    plan = R.plan(backend, mesh=mesh, device=device)
    labels = torch.as_tensor(labels, device=plan.device)
    Y = label_matrix(labels, labeled_mask, n_classes).to(_plan_dtype(plan))
    # One batched application on the class columns: the kappa columns
    # ride the K rounds together — no per-column loop.
    F = plan.apply(Y.T)[..., 0, :].T  # (kappa, N) batch -> (N, kappa) scores
    return SSLResult(scores=F, predictions=torch.argmax(F, dim=1))


def accuracy(result: SSLResult, labels, labeled_mask) -> float:
    """Accuracy over the unlabeled nodes."""
    pred = result.predictions
    labels = torch.as_tensor(labels, device=pred.device)
    unl = ~torch.as_tensor(labeled_mask, device=pred.device)
    correct = (pred == labels) & unl
    return float(correct.sum()) / max(int(unl.sum()), 1)
