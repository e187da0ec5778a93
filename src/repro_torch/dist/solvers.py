"""Section-V solvers behind one entry point: `plan.solve()` (PyTorch port).

The paper's Section V frames *exact* inverse filtering as solving

    Q x = y,   Q = g(P)^{-1}                                     (Eq. (23))

by iterations that cost one-or-a-few matvecs per round — Jacobi (Eq. (24)),
Chebyshev-accelerated Jacobi (Eq. (25)) and the parallel ARMA recursion
(Eqs. (29)-(30)).  This module runs all of them (plus the Section-IV
truncated-Chebyshev approximation itself) under every registered
execution backend:

    plan = op.plan("cuda")
    res  = plan.solve(y, method="jacobi", tau=0.5, r=2, n_iters=20)
    res.x           # (..., N) solutions, batched signals share the rounds
    res.history     # optional (n_iters, ..., N) iterate history
    res.info        # matvecs/round, rho, ARMA stability, ...

The solver problem is a *rational* filter g(lambda) = num(lambda)/den(lambda)
given by monomial coefficients (low-degree-first; see
`repro_torch.core.filters.power_rational` & friends):

  * ``chebyshev``  — truncated shifted-Chebyshev approximation of g
    (Section IV; n_iters = order K, one matvec per round);
  * ``jacobi``     — Jacobi on den(P) x = num(P) y (Eq. (24); deg(den)
    matvecs per round);
  * ``cheb_jacobi``— Chebyshev-accelerated Jacobi (Eq. (25); needs a
    spectral-radius bound rho < 1, estimated by power iteration if omitted);
  * ``arma``       — pole/residue parallel recursion (Eqs. (29)-(30);
    converges iff |p_k| > (lmax - lmin)/2, checked and recorded).

Backends participate through the plan's ``matvec_runner``, which runs an
iteration body against the backend's matvec on its padded domain.
Backends without a runner fall back to the reference matvec, logged at
INFO.

Single-launch fast path: a runner matvec tagged with ``mv.block_ell`` (the
`cuda` backend's Block-ELL product) collapses a whole Jacobi /
accelerated-Jacobi solve into ONE `jacobi_sweep` kernel launch (the
Chebyshev method rides the same upgrade inside `ops.fused_cheb_recurrence`),
guarded by the L2 footprint model with a logged per-round fallback (one
fused `jacobi_round` launch per round at deg(den) = 1), which a solve
with ``history=True`` takes too; a
plan built with ``sweep_dtype="bf16"`` runs it in the sweep's bf16 mode,
as the JAX package's `solve` passes its matvec's ``sweep_dtype``.  The
JAX package also fell back when rounds x deg(den) exceeded 256 SpMVs,
because its TPU kernel unrolled the Horner chain at trace time; the CUDA
kernel loops at run time, so the port has no such unroll budget.

Setup at full width: diag(den(P)) and the spectral-radius estimate need a
dense P; the port computes both on the plan's device in float64 (the JAX
package did it in host numpy), with numpy's ``default_rng(0)`` start
vector and the same 2% safety factor.  The set-up that misses the
operator's memo (diag(den(P)), rho, each device table) runs in a
``solver.setup`` span (`repro_torch.obs`); a hit records nothing.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core import arma as _arma
from ..core import chebyshev as cheb
from ..core import jacobi as _jacobi

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

#: The `plan.solve` method vocabulary.
METHODS = ("chebyshev", "jacobi", "cheb_jacobi", "arma")


def _np(a) -> np.ndarray:
    return a.numpy(force=True) if isinstance(a, Tensor) else np.asarray(a)


@dataclasses.dataclass
class SolveResult:
    """Result of one `plan.solve` call.

    x: (..., N) solutions (same leading batch dims as the input y).
    history: (n_iters, ..., N) iterate stack when `history=True` — the
    error-vs-communication-budget hook Fig. 2 plots; `history_errors`
    converts it to per-round errors against a reference.
    info: method/backend diagnostics — `matvecs_per_round`,
    `exchange_rounds` (the closed-form matvec count), `rho` /
    `arma_stable` convergence data.
    """

    x: Tensor
    method: str
    backend: str
    n_iters: int
    history: Optional[Tensor] = None
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def history_errors(self, target) -> np.ndarray:
        """Per-iterate l2 errors ||x^{(t)} - target|| (summed over batch).

        Pairs with `info["matvecs_per_round"]` to plot error against
        communication budget in matvec-equivalents (Fig. 2's axes)."""
        if self.history is None:
            raise ValueError("solve(..., history=True) to record iterates")
        h = _np(self.history)
        t = _np(target)
        diff = h - t[None]
        return np.sqrt((diff * diff).reshape(h.shape[0], -1).sum(axis=1))


# ---------------------------------------------------------------------------
# Rational-spec plumbing
# ---------------------------------------------------------------------------
def _resolve_rational(num, den, tau, r, h_scale):
    """(num, den) monomial coefficients (low-first) or (None, None)."""
    if den is not None:
        num = (1.0,) if num is None else num
        return (tuple(float(c) for c in num), tuple(float(c) for c in den))
    if num is not None:
        raise ValueError("num= given without den=")
    if tau is not None:
        from ..core.filters import power_rational

        return power_rational(tau, r, h_scale)
    return None, None


def _rational_callable(num, den):
    nh = np.asarray(num, dtype=np.float64)[::-1]
    dh = np.asarray(den, dtype=np.float64)[::-1]

    def g(lam):
        lam = np.asarray(lam, dtype=np.float64)
        return np.polyval(nh, lam) / np.polyval(dh, lam)

    return g


def poly_matvec(mv, coeffs: Tuple[float, ...], x: Tensor) -> Tensor:
    """p(P) x by Horner — exactly deg(p) matvecs (= exchange rounds)."""
    acc = coeffs[-1] * x
    for c in reversed(coeffs[:-1]):
        acc = mv(acc) + c * x
    return acc


def _poly_matvec_protocol(mv, coeffs: Tuple[float, ...]):
    """:func:`poly_matvec` as a stateful-protocol matvec.

    When `mv` carries the dual-signature stateful protocol
    (``mv.init_state``; see `repro_torch.core.chebyshev._stateful_matvec`),
    the returned ``p(P)``-matvec forwards it so the iteration loops can
    thread the state through every Horner step.  Plain matvecs come back
    as the plain closure.
    """
    init = getattr(mv, "init_state", None)
    if init is None:
        def pmv(x):
            return poly_matvec(mv, coeffs, x)
        return pmv

    def pmv2(x, state=None):
        if state is None:
            return poly_matvec(mv, coeffs, x)
        acc = coeffs[-1] * x
        for c in reversed(coeffs[:-1]):
            h, state = mv(acc, state)
            acc = h + c * x
        return acc, state

    pmv2.init_state = init
    return pmv2


def _dense_p64(op, device) -> Tensor:
    """The operator's dense P in float64 on `device` (solve setup only)."""
    return torch.as_tensor(op.P).to(device=device, dtype=torch.float64)


def _poly_diag(P64: Tensor, coeffs: Sequence[float]) -> np.ndarray:
    """diag(p(P)) for the Jacobi split, computed once at solve setup.

    diag(P^0) = 1 and diag(P^1) = diag(P) are free; diag(P^2) is one
    O(N^2) pass over the rows (sum_j P_ij P_ji); higher powers accumulate
    dense matrix powers (pass `den_diag=` to skip).  P64: float64 tensor
    on the plan's device."""
    n = P64.shape[0]
    d = torch.full((n,), float(coeffs[0]), dtype=torch.float64,
                   device=P64.device)
    if len(coeffs) > 1 and coeffs[1] != 0.0:
        d = d + coeffs[1] * torch.diagonal(P64)
    if len(coeffs) > 2 and coeffs[2] != 0.0:
        d = d + coeffs[2] * torch.einsum("ij,ji->i", P64, P64)
    for m in range(3, len(coeffs)):
        if coeffs[m] == 0.0:
            continue
        d = d + coeffs[m] * torch.diagonal(torch.linalg.matrix_power(P64, m))
    return d.numpy(force=True)


def _estimate_rho(op, den: Tuple[float, ...], inv_d: np.ndarray,
                  n_iters: int = 100, device=None) -> float:
    """Spectral radius of M = I - D^{-1} den(P) by power iteration.

    A setup-time scalar, not part of the hot loop, computed in float64 on
    the plan's device from numpy's ``default_rng(0)`` start vector.
    D^{-1} den(P) is similar to a symmetric matrix for symmetric P, so the
    dominant eigenvalue is real and plain power iteration converges.  The
    returned value carries a 2% safety factor — pass `rho=` for the exact
    bound.  Needs a dense P; closure-P operators must pass `rho=`.
    """
    if callable(op.P):
        raise ValueError(
            "cheb_jacobi needs a spectral-radius bound; P is a matvec "
            "closure — pass rho= explicitly")
    Pm = _dense_p64(op, device)

    def mv(v):
        return Pm @ v

    inv_dt = torch.as_tensor(inv_d, dtype=torch.float64, device=Pm.device)
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal(Pm.shape[0]), device=Pm.device)
    v = v / torch.linalg.norm(v)
    nrm = 0.0
    for _ in range(n_iters):
        w = v - inv_dt * poly_matvec(mv, den, v)
        nrm_t = torch.linalg.norm(w)
        v = w / nrm_t
        nrm = nrm_t
    return float(nrm) * 1.02


def _fallback_runner(plan):
    mv = plan.op.matvec

    def runner(fn, signals, consts=()):
        return fn(mv, *signals, *consts)

    return runner


def _with_budget(mv, l2_budget):
    """Re-tag a runner matvec with a per-solve sweep L2 budget.

    The single-launch paths read the ``mv.block_ell`` / ``mv.l2_budget``
    / ``mv.sweep_dtype`` tags (see `kernels.ops.fused_cheb_recurrence`); a per-call
    ``l2_budget=`` must reach them *without* mutating the backend's shared
    matvec object, so wrap the callable and stamp the override on the
    wrapper.  No-op for untagged matvecs.
    """
    if l2_budget is None or getattr(mv, "block_ell", None) is None:
        return mv

    def wrapped(x):
        return mv(x)

    wrapped.block_ell = mv.block_ell
    wrapped.l2_budget = int(l2_budget)
    wrapped.sweep_dtype = getattr(mv, "sweep_dtype", None)
    return wrapped


def _op_solver_cache(op) -> Dict[Any, Any]:
    """Per-operator memo for the dense solve setup (diag(den(P)), rho),
    stored in the instance __dict__ like the cached coefficients and keyed
    by the den tuple."""
    return op.__dict__.setdefault("_solver_cache", {})


def _device_table(op, key, make, device, dtype) -> Tensor:
    """A setup table made by ``make()`` on the host, copied once per
    operator to `device` and cast to `dtype`: a solve that runs again, or
    is captured in a CUDA graph, reads it without a copy."""
    cache = _op_solver_cache(op)
    full = key + (device, dtype)
    if full not in cache:
        with obs.span("solver.setup"):
            cache[full] = torch.as_tensor(make(), device=device).to(dtype)
    return cache[full]


def _resolve_den_diag(op, den, den_diag, device):
    if den_diag is not None:
        return _np(den_diag)
    if callable(op.P):
        raise ValueError(
            "the Jacobi split needs diag(den(P)); P is a matvec closure — "
            "pass den_diag= explicitly")
    cache = _op_solver_cache(op)
    key = ("den_diag", den)
    if key not in cache:
        with obs.span("solver.setup"):
            cache[key] = _poly_diag(_dense_p64(op, device), den)
    return cache[key]


# ---------------------------------------------------------------------------
# The entry point behind ExecutionPlan.solve
# ---------------------------------------------------------------------------
def solve_plan(
    plan,
    y,
    method: str = "chebyshev",
    *,
    num: Optional[Sequence[float]] = None,
    den: Optional[Sequence[float]] = None,
    tau: Optional[float] = None,
    r: int = 1,
    h_scale: float = 1.0,
    n_iters: Optional[int] = None,
    rho: Optional[float] = None,
    den_diag=None,
    poles: Optional[Sequence[complex]] = None,
    residues: Optional[Sequence[complex]] = None,
    const: Optional[float] = None,
    x0=None,
    history: bool = False,
    l2_budget: Optional[int] = None,
    check_every: int = 0,
) -> SolveResult:
    """Apply x = g(P) y by the Section-V method of choice.

    See :meth:`repro_torch.dist.operator.ExecutionPlan.solve` for the
    user-facing reference; this is the implementation shared by every
    backend.

    ``l2_budget=`` overrides the single-launch sweep's L2 guard for this
    call only (bytes; default `kernels.ops.DEFAULT_SWEEP_L2_BUDGET`) —
    tightening it forces the logged per-round fallback.

    ``check_every=r`` (default 0 = off) arms the **divergence guard**: the
    solve evaluates the relative residual ``||num(P) y - den(P) x|| /
    ||num(P) y||`` under the plan's own matvec and reports it in
    ``info["residual"]`` / ``info["diverged"]``, with
    ``info["exchange_rounds"]`` counting the residual evaluations' extra
    matvecs.  Plain ``method="jacobi"`` (a stationary iteration, so
    restarting from the current iterate reproduces the trajectory) runs in
    chunks of r rounds with a residual/NaN check between chunks and exits
    early once the iteration has demonstrably diverged (non-finite, or
    growing past ``2 x max(best, 1)``); the other methods run to
    completion and take a single post-solve check."""
    if method not in METHODS:
        raise ValueError(
            f"unknown solve method {method!r}; available: {METHODS}")
    op = plan.op
    num, den = _resolve_rational(num, den, tau, r, h_scale)
    K = int(n_iters) if n_iters is not None else op.K
    if K < 1:
        raise ValueError("n_iters must be >= 1")

    runner = plan.matvec_runner
    if runner is None:
        logger.info(
            "solve[%s]: backend provides no matvec_runner; falling back to "
            "the single-device reference matvec (results are exact, but the "
            "iteration does not run under the backend's execution strategy)",
            plan.backend)
        runner = _fallback_runner(plan)

    y = torch.as_tensor(y, device=plan.device)
    if x0 is not None:
        x0 = torch.as_tensor(x0, device=plan.device)
    info: Dict[str, Any] = {"num": num, "den": den}
    check_every = int(check_every)
    if check_every < 0:
        raise ValueError("check_every must be >= 0")

    if method == "chebyshev":
        res = _solve_chebyshev(plan, runner, y, num, den, K, history,
                               l2_budget, info)
        if check_every > 0:
            _post_solve_check(res, runner, y, num, den, l2_budget,
                              check_every)
        return res
    if den is None and not (method == "arma" and poles is not None):
        raise ValueError(
            f"method {method!r} needs the rational filter spec: pass "
            "tau= (+ r=, h_scale=) or num=/den= monomial coefficients "
            "(see repro_torch.core.filters.power_rational / "
            "tikhonov_rational / inverse_filter_rational)" + (
                "; arma also accepts an explicit poles=/residues= form"
                if method == "arma" else ""))
    if method == "jacobi" and check_every > 0 and not history:
        return _solve_jacobi_guarded(plan, runner, y, num, den, K, rho,
                                     den_diag, x0, l2_budget, check_every,
                                     info)
    if method in ("jacobi", "cheb_jacobi"):
        res = _solve_jacobi(plan, runner, y, num, den, K, method, rho,
                            den_diag, x0, history, l2_budget, info)
    else:
        res = _solve_arma(plan, runner, y, num, den, K, poles, residues,
                          const, x0, history, info)
    if check_every > 0:
        _post_solve_check(res, runner, y, num, den, l2_budget, check_every)
    return res


# ---------------------------------------------------------------------------
# Divergence guard (check_every=r)
# ---------------------------------------------------------------------------
#: A checked residual counts as divergence once it exceeds this factor
#: times max(best residual so far, 1.0) — 1.0 being the zero iterate's
#: relative residual.
_DIVERGENCE_FACTOR = 2.0


def _solve_residual(runner, y, x, num, den, l2_budget):
    """Relative residual ||num(P) y - den(P) x|| / ||num(P) y|| evaluated
    through the plan's own matvec.  Costs deg(num) + deg(den) matvecs;
    callers account for them."""

    def fn(mv, yl, xl):
        mv = _with_budget(mv, l2_budget)
        return poly_matvec(mv, num, yl), poly_matvec(mv, den, xl)

    b, ax = runner(fn, (y, x))
    bn = float(torch.linalg.norm(b))
    rn = float(torch.linalg.norm(b - ax))
    return rn / max(bn, 1e-30)


def _post_solve_check(res, runner, y, num, den, l2_budget, check_every):
    """Single residual/NaN check after a completed solve (methods whose
    trajectory cannot restart mid-run: chebyshev, cheb_jacobi, arma, and
    any history-recording run).  Mutates ``res.info`` in place."""
    finite = bool(torch.isfinite(res.x).all())
    residual = None
    if den is not None:
        residual = _solve_residual(runner, y, res.x, num, den, l2_budget)
        res.info["exchange_rounds"] = (
            res.info.get("exchange_rounds", 0)
            + (len(num) - 1) + (len(den) - 1))
    diverged = (not finite) or (residual is not None
                                and not np.isfinite(residual))
    if residual is not None and np.isfinite(residual):
        diverged = diverged or residual > _DIVERGENCE_FACTOR
    res.info.update(check_every=check_every, residual=residual,
                    diverged=bool(diverged))


def _solve_jacobi_guarded(plan, runner, y, num, den, K, rho, den_diag, x0,
                          l2_budget, check_every, info):
    """Plain Jacobi in chunks of `check_every` rounds with a residual/NaN
    check between chunks and early exit on divergence.

    Jacobi (Eq. (24)) is stationary, so restarting from the current iterate
    reproduces the unchunked trajectory.  ``exchange_rounds`` reports what
    ran: per chunk, deg(num) for the right-hand side + iters x deg(den) for
    the sweep + deg(num) + deg(den) for the residual evaluation.
    """
    deg_den = len(den) - 1
    deg_num = len(num) - 1
    x = x0
    rounds = 0
    done = 0
    residuals = []
    best = 1.0  # the zero iterate's relative residual
    diverged = False
    while done < K:
        iters = min(check_every, K - done)
        sub = _solve_jacobi(plan, runner, y, num, den, iters, "jacobi",
                            rho, den_diag, x, False, l2_budget, dict(info))
        x = sub.x
        done += iters
        rounds += iters * deg_den + deg_num
        res = _solve_residual(runner, y, x, num, den, l2_budget)
        rounds += deg_den + deg_num
        residuals.append(res)
        if not np.isfinite(res) or res > _DIVERGENCE_FACTOR * max(best, 1.0):
            diverged = True
            logger.warning(
                "solve[jacobi]: diverged at round %d/%d "
                "(residual %.3e, best %.3e) — stopping early", done, K, res,
                best)
            break
        best = min(best, res)
    info.update(matvecs_per_round=deg_den, exchange_rounds=rounds,
                check_every=check_every, residual=residuals[-1],
                residual_history=tuple(residuals), diverged=diverged,
                rounds_run=done)
    return SolveResult(x=x, method="jacobi", backend=plan.backend,
                       n_iters=done, info=info)


# ---------------------------------------------------------------------------
# Method implementations (each runs inside the backend's matvec_runner)
# ---------------------------------------------------------------------------
def _cheb_partial_sums(mv, x, c, alpha):
    """Chebyshev recurrence recording the order-k partial sums (history)."""
    t0 = x
    acc = 0.5 * c[0] * t0
    t1 = mv(x) / alpha - x
    acc = acc + c[1] * t1
    hist = [acc]
    t_km1, t_km2 = t1, t0
    for k in range(2, c.shape[0]):
        t_k = (2.0 / alpha) * mv(t_km1) - 2.0 * t_km1 - t_km2
        acc = acc + c[k] * t_k
        hist.append(acc)
        t_km1, t_km2 = t_k, t_km1
    return acc, torch.stack(hist)


def _solve_chebyshev(plan, runner, y, num, den, K, history, l2_budget,
                     info):
    """Section-IV truncated Chebyshev approximation of g at order K."""
    from ..kernels import ops as kops

    op = plan.op
    lmax = op.lmax
    if den is not None:
        coeffs = cheb.cheb_coeffs(_rational_callable(num, den), K, lmax)
    else:
        # no rational spec: approximate the plan's own (scalar) multiplier
        if op.eta != 1:
            raise ValueError(
                "solve(method='chebyshev') without a rational spec needs a "
                f"scalar operator (eta == 1); this one has eta={op.eta}. "
                "Pass tau=/num=/den= or use plan.apply for the union.")
        coeffs = (np.asarray(op.coeffs)[0] if K == op.K
                  else cheb.cheb_coeffs(op.multipliers[0], K, lmax,
                                        op.coeff_points))
    alpha = lmax / 2.0

    def fn(mv, yl, c):
        mv = _with_budget(mv, l2_budget)
        ct = _device_table(op, ("cheb_coeffs", num, den, K), lambda: c,
                           yl.device, yl.dtype)
        if history:
            return _cheb_partial_sums(mv, yl, ct, alpha)
        return kops.fused_cheb_recurrence(mv, yl, ct, lmax)[..., 0, :]

    info.update(matvecs_per_round=1, exchange_rounds=K, order=K)
    out = runner(fn, (y,), (coeffs,))
    if history:
        x, hist = out
        return SolveResult(x=x, method="chebyshev", backend=plan.backend,
                           n_iters=K, history=hist, info=info)
    return SolveResult(x=out, method="chebyshev", backend=plan.backend,
                       n_iters=K, info=info)


def _solve_jacobi(plan, runner, y, num, den, K, method, rho, den_diag, x0,
                  history, l2_budget, info):
    """Jacobi (Eq. (24)) / Chebyshev-accelerated Jacobi (Eq. (25)) on
    den(P) x = num(P) y; deg(den) matvecs per round, deg(num) once for the
    right-hand side."""
    op = plan.op
    dd = _resolve_den_diag(op, den, den_diag, plan.device)
    if den_diag is None:
        inv_d = _device_table(op, ("inv_d", den), lambda: 1.0 / dd,
                              plan.device, y.dtype)
    else:
        inv_d = torch.as_tensor(1.0 / dd, device=plan.device).to(y.dtype)
    deg_den = len(den) - 1
    deg_num = len(num) - 1
    if method == "cheb_jacobi":
        if rho is None:
            cache = _op_solver_cache(op)
            key = ("rho", den)
            if key not in cache:
                with obs.span("solver.setup"):
                    cache[key] = _estimate_rho(op, den, 1.0 / dd,
                                               device=plan.device)
            rho = cache[key]
            info["rho_estimated"] = True
        rho = float(rho)
        if not 0.0 < rho < 1.0:
            raise ValueError(
                f"cheb_jacobi needs a spectral-radius bound 0 < rho < 1 "
                f"(got {rho:.4f}): the Jacobi split of den(P) diverges — "
                "use method='arma' (Fig. 2(c)'s regime) or a different "
                "splitting")
        info["rho"] = rho
    else:
        # recorded for diagnostics; plain Jacobi runs regardless (and
        # diverges when rho >= 1, as Fig. 2(c) shows)
        info["rho"] = float(rho) if rho is not None else None

    info.update(matvecs_per_round=deg_den,
                exchange_rounds=K * deg_den + deg_num)

    signals = [y, inv_d] + ([x0] if x0 is not None else [])

    def fn(mv, yl, inv_dl, *rest):
        from ..kernels import ops as kops
        from ..kernels.cheb_sweep import jacobi_table

        mv = _with_budget(mv, l2_budget)
        x0l = rest[0] if rest else None
        b = poly_matvec(mv, num, yl)
        # Single-launch upgrade: a matvec tagged with its Block-ELL
        # structure runs the whole Eq. (24)/(25) iteration — deg(den)
        # in-kernel SpMVs + the fused update per round — in ONE
        # jacobi_sweep launch, the weight schedule computed on the host.
        # History recording needs every round's iterate, so it takes the
        # per-round path on the same layout: one fused round launch per
        # round at deg(den) = 1, each iterate written into the stack.
        A_local = getattr(mv, "block_ell", None)
        if A_local is not None:
            ws = (_jacobi.cheb_jacobi_weights(rho, K)
                  if method == "cheb_jacobi" else _jacobi.jacobi_weights(K))
            if history:
                return kops.fused_jacobi_history(A_local, b, inv_dl, den, ws,
                                                 x0=x0l)
            table = _device_table(
                op, ("jacobi_table", den, ws.tobytes()),
                lambda: jacobi_table(den, ws, "cpu"), b.device,
                torch.float32)
            return kops.fused_jacobi_sweep(
                A_local, b, inv_dl, den, ws, x0=x0l,
                l2_budget=getattr(mv, "l2_budget", None),
                scratch_dtype=getattr(mv, "sweep_dtype", None), table=table)

        a_mv = _poly_matvec_protocol(mv, den)
        if method == "jacobi":
            return _jacobi.jacobi_solve(
                a_mv, None, b, K, x0=x0l, return_history=history,
                inv_diag=inv_dl)
        return _jacobi.jacobi_chebyshev_solve(
            a_mv, None, b, rho, K, x0=x0l, return_history=history,
            inv_diag=inv_dl)

    out = runner(fn, tuple(signals))
    if history:
        x, hist = out
        return SolveResult(x=x, method=method, backend=plan.backend,
                           n_iters=K, history=hist, info=info)
    return SolveResult(x=out, method=method, backend=plan.backend,
                       n_iters=K, info=info)


def _solve_arma(plan, runner, y, num, den, K, poles, residues, const, x0,
                history, info):
    """Parallel ARMA recursion (Eqs. (29)-(30)): poles stacked on a leading
    axis, complex iterate carried as a real [Re, Im] stack — one matvec
    per round."""
    op = plan.op
    lmax = op.lmax
    if x0 is not None:
        raise ValueError(
            "method='arma' carries per-pole internal state; a warm-start "
            "x0 in signal space has no (29)-(30) analog")
    if poles is not None:
        if residues is None:
            raise ValueError("poles= given without residues=")
        p_arr = np.asarray(poles, dtype=np.complex128)
        r_arr = np.asarray(residues, dtype=np.complex128)
        c0 = float(const) if const is not None else 0.0
    else:
        r_arr, p_arr, c0 = _arma.arma_from_rational(num, den, lmax)
        if const is not None:
            c0 = float(const)
    stable = _arma.arma_stable(p_arr, lmax)
    if not stable:
        logger.warning(
            "solve[arma]: |p_k| > lmax/2 fails for some pole "
            "(min |p_k| = %.4f vs lmax/2 = %.4f) — the recursion (30) "
            "will diverge (Section V-D)", float(np.abs(p_arr).min()),
            lmax / 2.0)
    info.update(matvecs_per_round=1, exchange_rounds=K,
                n_poles=int(p_arr.shape[0]), arma_stable=stable,
                arma_const=c0)

    def fn(mv, yl, rl, pl):
        return _arma.arma_apply(mv, yl, rl, pl, lmax, n_iters=K,
                                const=c0, return_history=history)

    out = runner(fn, (y,), (r_arr, p_arr))
    if history:
        x, hist = out
        return SolveResult(x=x, method="arma", backend=plan.backend,
                           n_iters=K, history=hist, info=info)
    return SolveResult(x=out, method="arma", backend=plan.backend,
                       n_iters=K, info=info)
