"""AdamW with global-norm clipping (the JAX package's `optim/adamw.py`).

The state mirrors the parameter tree (nested dicts of tensors): the first
and second moments m and v are float32 whatever the parameter dtype, and
the update ``p32 - lr * (mhat / (sqrt(vhat) + eps) + wd * p32)`` is
computed in float32 and rounded once to the parameter's dtype.  The
bias corrections ``1 - b ** step`` are float32 tensors on the device, so
an update reads nothing on the host.  ``torch.optim.AdamW`` is not the
counterpart: it keeps its moments in the parameter's dtype and decays the
weights before the step.

At full width a stacked leaf holds ~1e9 elements, so nothing here makes a
float32 copy of a whole leaf: `adamw_update` walks each leaf in slices of
its leading axis (the update is elementwise, so this changes no bit),
updates m, v and the parameters in place, and takes the clip scale as
`grad_scale` instead of a clipped float32 gradient tree.

Sharded trees (DTensor leaves, `dist.sharding`): the moments take their
parameter's placements, the update runs on each rank's local shards (p,
g, m and v share placements, and the update is elementwise: no
collective), and `global_norm` sums each rank's shards and reduces that
one scalar over the mesh.
"""
from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from ..dist.sharding import is_dtensor
from ..tree import leaves, tree_map

Tensor = torch.Tensor

#: Elements of one slice the update and the norm work on at a time (a
#: float32 temporary of 256 MiB).
CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: Tensor        # 0-d int32
    m: Dict
    v: Dict


def _chunks(t: Tensor) -> Iterator[Tensor]:
    """Views of `t` along its leading axis, each of at most CHUNK elements
    (one row at least)."""
    if t.ndim == 0 or t.numel() <= CHUNK:
        yield t
        return
    rows = max(1, CHUNK // (t.numel() // t.shape[0]))
    yield from t.split(rows)


def adamw_init(params: Dict) -> AdamWState:
    """Zero float32 moments shaped like `params`, each on its leaf's
    device (a DTensor leaf's in its placements); step 0 (int32) on the
    device of the first leaf."""
    def zeros(p):
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _owned_local(g) -> Optional[Tensor]:
    """The local shard of DTensor `g` if this rank counts it in a sum over
    the mesh (it sits at coordinate 0 of every mesh dim that replicates
    `g`), else None."""
    coord = g.device_mesh.get_coordinate()
    if any(not p.is_shard() and c != 0
           for p, c in zip(g.placements, coord)):
        return None
    return g.to_local()


def global_norm(grads: Dict) -> Tensor:
    """sqrt of the float32 sum of squares over every leaf (0-d float32).
    DTensor leaves: each rank sums the shards it owns, and that one
    scalar is summed over the mesh (every rank calls it together); the
    norm is a plain tensor, alike on every rank."""
    total, mesh = None, None
    for g in leaves(grads):
        if is_dtensor(g):
            mesh = g.device_mesh
            g = _owned_local(g)
            if g is None:
                continue
        for c in _chunks(g):
            s = c.float().square().sum()
            total = s if total is None else total + s
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Partial

        if total is None:
            total = torch.zeros((), dtype=torch.float32,
                                device=mesh.device_type)
        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                                   run_check=False).full_tensor()
    return torch.sqrt(total)


def clip_scale(gn: Tensor, max_norm: float) -> Tensor:
    """``min(1, max_norm / (gn + 1e-9))`` in float32 (a true division: a
    Python scalar over a tensor would multiply by a reciprocal)."""
    return torch.clamp(torch.full_like(gn, max_norm) / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads: Dict, max_norm: float) -> Tuple[Dict, Tensor]:
    """(grads * scale, global norm): the clipped tree is float32, as the
    JAX package's (a bf16 gradient times its float32 scale widens there).
    The trainer does not build this tree: it passes the scale to
    `adamw_update` as `grad_scale`."""
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def _update_slice(p, g, m, v, bc1, bc2, scale, lr, b1, b2, eps, wd):
    # the JAX package's operations in its order: the same float32 bits
    g = g.float() * scale if scale is not None else g.float()
    m.mul_(b1).add_(g * (1.0 - b1))
    v.mul_(b2).add_(torch.square(g).mul_(1.0 - b2))
    delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
    p32 = p.float()
    delta.add_(p32 * wd)
    p.copy_(p32 - delta.mul_(lr))


@torch.no_grad()
def adamw_update(
    grads: Dict,
    state: AdamWState,
    params: Dict,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    *,
    grad_scale: Optional[Tensor] = None,
) -> Tuple[Dict, AdamWState]:
    """One AdamW step, in place: returns `params` and a state holding the
    same m and v dicts, each updated, and step + 1.  `grad_scale` (0-d
    float32, e.g. `clip_scale`) multiplies each float32-widened gradient
    first, as the JAX package's clipped tree is."""
    step = state.step + 1
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v), strict=True):
        if is_dtensor(p):
            p, g, m, v = _local_shards(p, g, m, v)
        for ps, gs, ms, vs in zip(_chunks(p), _chunks(g), _chunks(m),
                                  _chunks(v)):
            _update_slice(ps, gs, ms, vs, bc1, bc2, grad_scale, lr, b1, b2,
                          eps, weight_decay)
    return params, AdamWState(step=step, m=state.m, v=state.v)


def _local_shards(*ts):
    """The local shards of DTensors laid out alike (a parameter, its
    gradient and its moments)."""
    lay = ts[0].placements
    for t in ts[1:]:
        if t.placements != lay:
            raise ValueError(f"AdamW needs one layout: {t.placements} "
                             f"beside {lay}")
    return [t.to_local() for t in ts]
