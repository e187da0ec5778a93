"""The port's Section-V solvers — `plan.solve`, `core.jacobi`, `core.arma`
and the Jacobi kernels' plain versions — held against the JAX package on
the same inputs.

Inputs are built once with numpy or the reference's generators and handed
to both packages as numpy arrays.  The operator is the `solver_setup` of
tests/test_solvers.py:22 (n = 120, P = L_norm, tau = 0.5; n is not a
multiple of 128, so the cuda plan's padding runs).  The port runs with
device="cpu", i.e. through the kernels' plain PyTorch versions.

Tolerances are those of the reference's own tests: atol 2e-4 against the
direct solution and 1e-5 against the reference's solve
(tests/test_solvers.py:70,104), 1e-6 for the guarded-vs-unguarded solve
(:198), atol 1e-5 for the Jacobi step against the interpret-mode kernel
(:306), 2e-5 for the sweep against `ref.jacobi_sweep_ref`
(tests/test_sweep.py:66); the weight tables are host numpy in both
packages and must be bitwise equal.  The reference's own `jacobi_sweep`
kernel does not run on this jax (`pl.load` is gone), so the port's sweep
is held against `ref.jacobi_sweep_ref` and `plan("dense").solve`.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arma as jarma
from repro.core import filters as jfilters
from repro.core import graph as jgraph
from repro.core import jacobi as jjacobi
from repro.dist import GraphOperator as JOp
from repro.dist import solvers as jsolvers
from repro.kernels import ref as jref
from repro.kernels.jacobi_step import jacobi_step as jjacobi_step
from repro_torch.convert import block_ell_from_numpy
from repro_torch.core import arma as tarma
from repro_torch.core import filters as tfilters
from repro_torch.core import jacobi as tjacobi
from repro_torch.dist import METHODS, GraphOperator
from repro_torch.dist import solvers as tsolvers
from repro_torch.kernels import ops
from repro_torch.kernels.cheb_sweep import jacobi_sweep, jacobi_sweep_plain
from repro_torch.kernels.jacobi_step import jacobi_step, jacobi_step_plain

TAU = 0.5
BACKENDS = ["dense", "cuda"]
BATCH_SHAPES = [(), (5,), (64,), (2, 3)]


@pytest.fixture(scope="module")
def solver_setup():
    """(L_norm, reference op, port op, y, direct solution, exact rho)."""
    g, _ = jgraph.connected_sensor_graph(
        jax.random.PRNGKey(0), n=120, theta=0.2, kappa=0.25)
    Ln = np.asarray(g.laplacian("normalized"))
    jop = JOp(P=jnp.asarray(Ln),
              multipliers=[jfilters.ssl_multiplier(jfilters.power_kernel(1),
                                                   TAU)],
              lmax=2.0, K=12)
    top = GraphOperator(
        P=torch.from_numpy(Ln.copy()),
        multipliers=[tfilters.ssl_multiplier(tfilters.power_kernel(1), TAU)],
        lmax=2.0, K=12)
    y = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (120,)))
    Q = (TAU * np.eye(120) + Ln) / TAU
    direct = np.linalg.solve(Q, y)
    QD = np.diag(np.diag(Q))
    rho = float(np.abs(np.linalg.eigvals(np.linalg.solve(QD, QD - Q))).max())
    return Ln, jop, top, y, direct, rho


def _method_kwargs(method, rho):
    """The iteration budgets of tests/test_solvers.py:50."""
    if method == "chebyshev":
        return dict(n_iters=40)
    if method == "jacobi":
        return dict(n_iters=250)
    if method == "cheb_jacobi":
        return dict(n_iters=50, rho=rho * 1.0001)
    return dict(n_iters=250)  # arma


def _randn(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _assert_info_matches(got, want):
    """Key for key; the relative residuals — f32 rounding at ~1e-6 once a
    solve has converged — to the solution's own atol 1e-5."""
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "rho" and value is not None:
            assert got[key] == pytest.approx(value, rel=1e-9), key
        elif key == "residual" and value is not None:
            assert got[key] == pytest.approx(value, rel=1e-4, abs=1e-5)
        elif key == "residual_history":
            np.testing.assert_allclose(got[key], value, rtol=1e-4,
                                       atol=1e-5)
        else:
            assert got[key] == value, key


# -- weight tables and the kernels' plain versions ---------------------------
@pytest.mark.parametrize("n_iters", [1, 5, 40])
def test_weight_tables_bitwise(n_iters):
    assert np.array_equal(tjacobi.jacobi_weights(n_iters),
                          jjacobi.jacobi_weights(n_iters))
    for rho in (0.3, 0.7, 0.95):
        assert np.array_equal(tjacobi.cheb_jacobi_weights(rho, n_iters),
                              jjacobi.cheb_jacobi_weights(rho, n_iters))


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
@pytest.mark.parametrize("batch_shape", BATCH_SHAPES)
def test_jacobi_step_plain_matches_reference_kernel(batch_shape, shared):
    """n = 300 is not a multiple of the 128 lanes the TPU kernel pads to."""
    n = 300
    qx, x, xp = (_randn(s, batch_shape + (n,)) for s in (1, 2, 3))
    rows = (n,) if shared else batch_shape + (n,)
    y, invd = _randn(4, rows), _randn(5, rows)
    want = np.asarray(jjacobi_step(*(jnp.asarray(a)
                                     for a in (qx, x, xp, y, invd)),
                                   w=1.7, s=0.3, interpret=True))
    args = [torch.from_numpy(a) for a in (qx, x, xp, y, invd)]
    got = jacobi_step_plain(*args, w=1.7, s=0.3)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # on CPU tensors the wrapper and the dispatch take the plain version
    assert torch.equal(jacobi_step(*args, w=1.7, s=0.3), got)
    assert torch.equal(ops.jacobi_update(*args, w=1.7, s=0.3), got)


@pytest.fixture(scope="module")
def block_ell_norm500():
    """The n = 500 multi-row-block structure of tests/test_sweep.py:35, on
    L_norm (in both packages) with its dense form."""
    g, _ = jgraph.connected_sensor_graph(
        jax.random.PRNGKey(1), n=500, theta=0.075, kappa=0.075)
    Ln = np.asarray(g.laplacian("normalized"))
    A = jgraph.to_block_ell(Ln, (8, 128))
    At = block_ell_from_numpy(np.asarray(A.blocks), np.asarray(A.indices),
                              np.asarray(A.mask), A.n)
    return A, At, Ln


def _den_diag(P, den):
    return sum(c * np.diag(np.linalg.matrix_power(P.astype(np.float64), m))
               for m, c in enumerate(den))


@pytest.mark.parametrize("weights", ["jacobi", "cheb_jacobi"])
@pytest.mark.parametrize("den", [(TAU,), (TAU, 1.0), (TAU, 0.0, 1.0)],
                         ids=["deg0", "deg1", "deg2"])
def test_jacobi_sweep_plain_matches_reference(block_ell_norm500, den,
                                              weights):
    """The port's sweep on the sliced-ELL layout packed from the
    reference's Block-ELL against ref.jacobi_sweep_ref, deg(den) = 0, 1
    and 2."""
    A, At, Ln = block_ell_norm500
    n_iters = 12
    ws = (jjacobi.jacobi_weights(n_iters) if weights == "jacobi"
          else jjacobi.cheb_jacobi_weights(0.8, n_iters))
    n = A.padded_n
    inv_d = np.zeros(n, np.float32)
    inv_d[:500] = 1.0 / _den_diag(Ln, den)
    b = np.zeros((5, n), np.float32)
    b[:, :500] = _randn(6, (5, 500))
    x0 = np.zeros((5, n), np.float32)
    x0[:, :500] = _randn(7, (5, 500))
    want = np.asarray(jref.jacobi_sweep_ref(
        A.blocks, A.indices, jnp.asarray(b), jnp.asarray(inv_d), ws,
        jnp.asarray(x0), den=den))
    tb, tinv, tx0 = (torch.from_numpy(a) for a in (b, inv_d, x0))
    S = At.sliced_ell()
    got = jacobi_sweep_plain(S, tb, tinv, ws, tx0, den=den)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert torch.equal(jacobi_sweep(S, tb, tinv, ws, tx0, den=den), got)
    # the dispatch pads a logical-n problem itself and crops the result
    fused = ops.fused_jacobi_sweep(At, tb[:, :500], tinv[:500], den, ws,
                                   x0=tx0[:, :500])
    np.testing.assert_allclose(fused.numpy(), want[:, :500], atol=2e-5)


def test_fused_jacobi_sweep_guard_falls_back_logged(block_ell_norm500,
                                                    caplog):
    """Over the L2 budget the dispatch takes the per-round path (SpMV and
    jacobi_step), logged at INFO, with the same numbers."""
    _, At, Ln = block_ell_norm500
    den = (TAU, 1.0)
    ws = tjacobi.cheb_jacobi_weights(0.8, 10)
    b = torch.from_numpy(_randn(8, (3, 500)))
    inv_d = torch.from_numpy((1.0 / _den_diag(Ln, den)).astype(np.float32))
    sweep = ops.fused_jacobi_sweep(At, b, inv_d, den, ws)
    with caplog.at_level(logging.INFO, logger="repro_torch.kernels.ops"):
        per_round = ops.fused_jacobi_sweep(At, b, inv_d, den, ws,
                                           l2_budget=64)
    assert any("per-round jacobi_step" in r.message for r in caplog.records)
    np.testing.assert_allclose(per_round.numpy(), sweep.numpy(), atol=2e-5)
    assert ops.jacobi_sweep_l2_bytes(At.padded_n, 3) == 6 * 3 * 512 * 4


# -- plan.solve against the direct solution and the reference ---------------
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", METHODS)
def test_solve_matches_direct_solution(solver_setup, backend, method):
    Ln, _, top, y, direct, rho = solver_setup
    res = top.plan(backend, device="cpu").solve(
        y.astype(np.float32), method, tau=TAU, r=1,
        **_method_kwargs(method, rho))
    assert res.method == method and res.backend == backend
    assert res.x.shape == y.shape and res.x.device.type == "cpu"
    np.testing.assert_allclose(res.x.numpy(), direct, atol=2e-4)


@pytest.mark.parametrize("batch", [(), (64,)])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", METHODS)
def test_solve_matches_reference_solve(solver_setup, backend, method, batch):
    """Same x and the same info, key for key (rho estimated by both from
    numpy's default_rng(0) start vector)."""
    _, jop, top, _, _, _ = solver_setup
    Y = _randn(11, batch + (120,))
    kw = dict(tau=TAU, r=1, n_iters=30)
    want = jop.plan("dense").solve(jnp.asarray(Y), method, **kw)
    got = top.plan(backend, device="cpu").solve(Y, method, **kw)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5)
    _assert_info_matches(got.info, want.info)
    assert (got.n_iters, got.method) == (want.n_iters, want.method)


def test_estimated_rho_matches_reference(solver_setup):
    Ln, jop, top, _, _, rho = solver_setup
    den = (TAU, 1.0)
    inv_d = 1.0 / _den_diag(Ln, den)
    want = jsolvers._estimate_rho(jop, den, inv_d)
    got = tsolvers._estimate_rho(top, den, inv_d, device="cpu")
    assert got == pytest.approx(want, rel=1e-9)
    assert rho < got < 1.0
    # diag(den(P)): the reference's numpy runs in P's float32 from P^2 on,
    # the port in float64 on the plan's device
    np.testing.assert_allclose(
        tsolvers._poly_diag(torch.from_numpy(Ln.copy()).double(),
                            (TAU, 0.3, 1.0, 0.2)),
        jsolvers._poly_diag(Ln, (TAU, 0.3, 1.0, 0.2)), rtol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", METHODS)
def test_solve_history_matches_reference(solver_setup, backend, method):
    _, jop, top, y, direct, rho = solver_setup
    extra = {"rho": rho * 1.0001} if method == "cheb_jacobi" else {}
    kw = dict(tau=TAU, n_iters=30, history=True, **extra)
    want = jop.plan("dense").solve(jnp.asarray(y), method, **kw)
    got = top.plan(backend, device="cpu").solve(y.astype(np.float32), method,
                                               **kw)
    assert tuple(got.history.shape) == (30, 120)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history),
                               atol=1e-5)
    np.testing.assert_allclose(got.history[-1].numpy(), got.x.numpy(),
                               atol=1e-6)
    errs = got.history_errors(direct)
    np.testing.assert_allclose(errs, want.history_errors(direct), atol=1e-4)
    if method == "jacobi":
        assert errs[-1] < errs[0] * 0.1


@pytest.mark.parametrize("backend", BACKENDS)
def test_guarded_jacobi_matches_unguarded_and_reference(solver_setup,
                                                        backend):
    _, jop, top, y, _, _ = solver_setup
    plan = top.plan(backend, device="cpu")
    y32 = y.astype(np.float32)
    base = plan.solve(y32, "jacobi", tau=TAU, n_iters=20)
    res = plan.solve(y32, "jacobi", tau=TAU, n_iters=20, check_every=7)
    np.testing.assert_allclose(res.x.numpy(), base.x.numpy(), atol=1e-6)
    want = jop.plan("dense").solve(jnp.asarray(y), "jacobi", tau=TAU,
                                   n_iters=20, check_every=7)
    _assert_info_matches(res.info, want.info)
    assert res.info["rounds_run"] == 20 and not res.info["diverged"]
    assert len(res.info["residual_history"]) == 3
    assert "diverged" not in base.info and "residual" not in base.info


@pytest.mark.parametrize("backend", BACKENDS)
def test_guarded_jacobi_stops_early_like_reference(solver_setup, backend,
                                                   caplog):
    _, jop, top, y, _, _ = solver_setup
    kw = dict(num=(1.0,), den=(1.0, -5.0, 1.0), n_iters=60, check_every=5)
    want = jop.plan("dense").solve(jnp.asarray(y), "jacobi", **kw)
    with caplog.at_level(logging.WARNING, logger="repro_torch.dist.solvers"):
        got = top.plan(backend, device="cpu").solve(y.astype(np.float32),
                                                    "jacobi", **kw)
    assert got.info["diverged"] and want.info["diverged"]
    assert got.info["rounds_run"] == want.info["rounds_run"] < 60
    assert got.n_iters == want.n_iters
    assert got.info["exchange_rounds"] == want.info["exchange_rounds"]
    assert any("diverged" in r.message for r in caplog.records)


@pytest.mark.parametrize("method", ["cheb_jacobi", "chebyshev", "arma"])
def test_post_solve_check_matches_reference(solver_setup, method):
    _, jop, top, y, _, rho = solver_setup
    kw = dict(tau=TAU, r=1, n_iters=24, check_every=8)
    if method == "cheb_jacobi":
        kw["rho"] = rho
    want = jop.plan("dense").solve(jnp.asarray(y), method, **kw)
    got = top.plan("cuda", device="cpu").solve(y.astype(np.float32), method,
                                               **kw)
    _assert_info_matches(got.info, want.info)
    assert got.info["diverged"] is False


@pytest.mark.parametrize("kwargs,match", [
    (dict(), "rational filter spec"),
    (dict(method="gauss_seidel"), "unknown solve method"),
    (dict(method="cheb_jacobi", tau=TAU, n_iters=10, rho=1.3),
     "spectral-radius"),
    (dict(method="arma", tau=TAU, x0=np.zeros(120, np.float32)),
     "warm-start"),
    (dict(tau=TAU, check_every=-1), "check_every"),
    (dict(tau=TAU, n_iters=0), "n_iters"),
    (dict(method="arma", poles=(1.5,)), "residues"),
    (dict(num=(1.0,)), "without den"),
], ids=["no-spec", "method", "rho", "arma-x0", "check_every", "n_iters",
        "poles", "num"])
def test_solve_errors_match_reference(solver_setup, kwargs, match):
    _, jop, top, y, _, _ = solver_setup
    kwargs = dict(kwargs)
    method = kwargs.pop("method", "jacobi")
    with pytest.raises(ValueError, match=match):
        jop.plan("dense").solve(jnp.asarray(y), method, **kwargs)
    for backend in BACKENDS:
        with pytest.raises(ValueError, match=match):
            top.plan(backend, device="cpu").solve(y.astype(np.float32),
                                                  method, **kwargs)


def test_solve_chebyshev_defaults_to_op_multiplier(solver_setup):
    _, _, top, y, _, _ = solver_setup
    plan = top.plan("cuda", device="cpu")
    y32 = torch.from_numpy(y.astype(np.float32))
    res = plan.solve(y32, "chebyshev")
    np.testing.assert_allclose(res.x.numpy(), plan.apply(y32)[0].numpy(),
                               atol=1e-6)
    assert res.n_iters == top.K


def test_inverse_filter_solved(solver_setup):
    """Prop. 3 deconvolution for a polynomial blur (deg(den) = 2): the
    dense direct solve of (tau Psi^2 + 2 L) f = tau Psi y."""
    Ln, _, top, y, _, _ = solver_setup
    psi, tau = (1.0, -0.3), 1.0
    num, den = tfilters.inverse_filter_rational(psi, tau, 1)
    assert (num, den) == jfilters.inverse_filter_rational(psi, tau, 1)
    Psi = psi[0] * np.eye(120) + psi[1] * Ln
    direct = np.linalg.solve(tau * Psi @ Psi + 2.0 * Ln, tau * Psi @ y)
    for backend in BACKENDS:
        res = top.plan(backend, device="cpu").solve(
            y.astype(np.float32), "jacobi", num=num, den=den, n_iters=400)
        np.testing.assert_allclose(res.x.numpy(), direct, atol=5e-4)
        assert res.info["matvecs_per_round"] == 2


def test_cuda_plan_routes_solves_through_the_kernels(solver_setup,
                                                     monkeypatch):
    """On the cuda plan a Jacobi solve is one jacobi_sweep call, a history
    solve one fused jacobi_round launch per round (after deg(den) - 1
    SpMVs), an ARMA solve one SpMV per round."""
    _, _, top, y, _, rho = solver_setup
    calls = {"jacobi_sweep": 0, "jacobi_step": 0, "sliced_ell_spmv": 0,
             "jacobi_round": 0}
    for name in ("jacobi_sweep", "jacobi_step", "sliced_ell_spmv"):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    real_launcher = ops.round_launcher

    def launcher(*a, **k):
        launch = real_launcher(*a, **k)

        def counted_launch(*la):
            calls["jacobi_round"] += 1
            return launch(*la)

        return counted_launch

    monkeypatch.setattr(ops, "round_launcher", launcher)
    plan = top.plan("cuda", device="cpu")
    y32 = y.astype(np.float32)
    plan.solve(y32, "jacobi", tau=TAU, n_iters=9)
    plan.solve(y32, "cheb_jacobi", tau=TAU, n_iters=9, rho=rho * 1.0001)
    assert calls == {"jacobi_sweep": 2, "jacobi_step": 0,
                     "sliced_ell_spmv": 0, "jacobi_round": 0}
    plan.solve(y32, "jacobi", tau=TAU, r=2, n_iters=9, history=True)
    assert calls == {"jacobi_sweep": 2, "jacobi_step": 0,
                     "sliced_ell_spmv": 9, "jacobi_round": 9}
    plan.solve(y32, "arma", tau=TAU, n_iters=9)
    assert calls["sliced_ell_spmv"] == 9 + 9


def test_solve_l2_budget_forces_logged_fallback(solver_setup, caplog):
    _, _, top, y, _, _ = solver_setup
    plan = top.plan("cuda", device="cpu")
    y32 = y.astype(np.float32)
    base = plan.solve(y32, "jacobi", tau=TAU, n_iters=20)
    with caplog.at_level(logging.INFO, logger="repro_torch.kernels.ops"):
        small = plan.solve(y32, "jacobi", tau=TAU, n_iters=20, l2_budget=64)
    assert any("per-round jacobi_step" in r.message for r in caplog.records)
    np.testing.assert_allclose(small.x.numpy(), base.x.numpy(), atol=2e-5)


def test_solve_falls_back_without_runner(solver_setup, caplog):
    _, _, top, y, direct, _ = solver_setup
    plan = dataclasses.replace(top.plan("dense", device="cpu"),
                               backend="norunner", matvec_runner=None)
    with caplog.at_level(logging.INFO, logger="repro_torch.dist.solvers"):
        res = plan.solve(y.astype(np.float32), "jacobi", tau=TAU,
                         n_iters=250)
    assert any("no matvec_runner" in r.message for r in caplog.records)
    np.testing.assert_allclose(res.x.numpy(), direct, atol=2e-4)


# -- core/jacobi.py and core/arma.py ---------------------------------------
def test_core_solvers_match_reference(solver_setup):
    Ln, _, _, y, _, rho = solver_setup
    Lj, Lt = jnp.asarray(Ln), torch.from_numpy(Ln.copy())
    y32 = y.astype(np.float32)
    yj, yt = jnp.asarray(y32), torch.from_numpy(y32)

    def jmv(v):
        return jnp.einsum("ij,...j->...i", Lj, v)

    def tmv(v):
        return v @ Lt.T

    jq, jd = jjacobi.tikhonov_q(jmv, jnp.diag(Lj), TAU)
    tq, td = tjacobi.tikhonov_q(tmv, torch.diagonal(Lt), TAU)
    np.testing.assert_allclose(
        tjacobi.jacobi_solve(tq, td, yt, 40).numpy(),
        np.asarray(jjacobi.jacobi_solve(jq, jd, yj, 40)), atol=1e-5)
    np.testing.assert_allclose(
        tjacobi.jacobi_chebyshev_solve(tq, td, yt, rho * 1.0001, 25).numpy(),
        np.asarray(jjacobi.jacobi_chebyshev_solve(jq, jd, yj, rho * 1.0001,
                                                  25)), atol=1e-5)
    jq2, jd2 = jjacobi.power_q(jmv, Lj, TAU, 2)
    tq2, td2 = tjacobi.power_q(tmv, Lt, TAU, 2)
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-6)
    np.testing.assert_allclose(tq2(yt).numpy(), np.asarray(jq2(yj)),
                               atol=1e-5)
    x, hist = tjacobi.jacobi_solve(tq, td, yt, 7, return_history=True)
    assert tuple(hist.shape) == (7, 120) and torch.equal(hist[-1], x)
    with pytest.raises(ValueError, match="q_diag or inv_diag"):
        tjacobi.jacobi_solve(tq, None, yt, 3)
    for preset in ("arma_tikhonov_first_order", "arma_tikhonov_second_order",
                   "arma_random_walk_3"):
        r0, p0, c0 = getattr(jarma, preset)(TAU, 2.0)
        r1, p1, c1 = getattr(tarma, preset)(TAU, 2.0)
        assert np.array_equal(r0, r1) and np.array_equal(p0, p1)
        assert c0 == c1
        Y = _randn(12, (3, 120))
        want = jarma.arma_apply(jmv, jnp.asarray(Y), r0, p0, 2.0,
                                n_iters=40, const=c0)
        got = tarma.arma_apply(tmv, torch.from_numpy(Y), r1, p1, 2.0,
                               n_iters=40, const=c1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("spec", ["power1", "power2", "random_walk",
                                  "inverse"])
def test_arma_from_rational_matches_reference(spec):
    tau, lmax = 0.5, 2.0
    num, den = {"power1": tfilters.power_rational(tau, 1),
                "power2": tfilters.power_rational(tau, 2),
                "random_walk": tfilters.random_walk_rational(tau, 2.0, 3),
                "inverse": tfilters.inverse_filter_rational((1.0, -0.3), tau,
                                                            1)}[spec]
    r0, p0, c0 = jarma.arma_from_rational(num, den, lmax)
    r1, p1, c1 = tarma.arma_from_rational(num, den, lmax)
    assert np.array_equal(r0, r1) and np.array_equal(p0, p1) and c0 == c1
    assert tarma.arma_stable(p1, lmax) == jarma.arma_stable(p0, lmax)
    lam = np.linspace(0.0, 1.9, 40)
    assert np.array_equal(tarma.arma_eval(r1, p1, lam, lmax, const=c1),
                          jarma.arma_eval(r0, p0, lam, lmax, const=c0))
    with pytest.raises(ValueError, match="repeated roots"):
        tarma.arma_from_rational((1.0,), (1.0, 2.0, 1.0), lmax)
