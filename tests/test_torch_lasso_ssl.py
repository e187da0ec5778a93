"""The port's Algorithm 3 (`core.lasso`, `plan.solve_lasso`), its ISTA
kernel's plain version, and the Section III-D classifier (`core.ssl`)
held against the JAX package on the same inputs.

Inputs come from numpy or the reference's generators (`sensor120` of
tests/conftest.py, `two_cluster_graph`, `graph_signal_batch`) and reach
both packages as numpy arrays; the port runs with device="cpu", i.e.
through the kernels' plain PyTorch versions.

Tolerances: atol 1e-6 for the ISTA shrink against the interpret-mode
kernel (one elementwise pass in f32); atol 1e-4 for whole lasso and SSL
runs (the reference's cross-backend lasso / SSL tolerance,
tests/test_batched.py:150,188 — f32 in another summation order through
2K matvecs per ISTA iteration); SSL predictions must agree wherever the
top two scores differ by more than 1e-3.  Mask and threshold tables are
exact.  The properties of tests/test_wavelets_lasso.py and
tests/test_ssl.py (decreasing objective, denoising, regularization path,
classification accuracy) are asserted of the port too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filters as jfilters
from repro.core import graph as jgraph
from repro.core import lasso as jlasso
from repro.core import ssl as jssl
from repro.core import wavelets as jwav
from repro.core.multiplier import UnionMultiplier as JUnion
from repro.data.pipeline import graph_signal_batch
from repro.dist import GraphOperator as JOp
from repro.kernels import ref as jref
from repro.kernels.soft_threshold import ista_shrink as jista_shrink
from repro_torch.core import filters as tfilters
from repro_torch.core import lasso as tlasso
from repro_torch.core import ssl as tssl
from repro_torch.core import wavelets as twav
from repro_torch.dist import GraphOperator
from repro_torch.kernels import ops
from repro_torch.kernels.soft_threshold import (ista_shrink,
                                                ista_shrink_plain)

GAMMA = 0.2


def _randn(seed, shape):
    return np.asarray(np.random.RandomState(seed).randn(*shape),
                      dtype=np.float32)


# -- the ISTA kernel's plain version ------------------------------------------
@pytest.mark.parametrize("eta,n", [(3, 256), (7, 1024)])
def test_ista_shrink_plain_matches_reference_kernel(eta, n):
    a, phi_y, gram = (_randn(s, (eta, n)) for s in (1, 2, 3))
    thresh = np.abs(_randn(4, (eta, 1)))
    want = np.asarray(jista_shrink(*(jnp.asarray(v)
                                     for v in (a, phi_y, gram, thresh)),
                                   gamma=0.3, interpret=True))
    args = [torch.from_numpy(v) for v in (a, phi_y, gram, thresh)]
    got = ista_shrink_plain(*args, gamma=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert torch.equal(ista_shrink(*args, gamma=0.3), got)
    assert torch.equal(ops.ista_update(*args[:3], args[3][:, 0], 0.3), got)


@pytest.mark.parametrize("form", ["scale", "signal_scale", "vertex",
                                  "shared_vertex", "scalar"])
def test_ista_shrink_threshold_forms_match_reference(form):
    """Every mu form of `_mu_threshold` at any n and batch (the TPU kernel
    took only (eta, n % 128 == 0) with an (eta, 1) threshold)."""
    B, eta, n = 4, 5, 300
    a, phi_y, gram = (_randn(s, (B, eta, n)) for s in (5, 6, 7))
    shape = {"scale": (eta, 1), "signal_scale": (B, eta, 1),
             "vertex": (B, eta, n), "shared_vertex": (eta, n),
             "scalar": ()}[form]
    thresh = np.abs(_randn(8, shape)).astype(np.float32)
    want = np.asarray(jref.ista_shrink_ref(
        *(jnp.asarray(v) for v in (a, phi_y, gram, thresh)), gamma=0.3))
    got = ops.ista_update(*(torch.from_numpy(np.asarray(v))
                            for v in (a, phi_y, gram, thresh)), 0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_soft_threshold_matches_reference():
    z = np.linspace(-3, 3, 101).astype(np.float32)
    got = tlasso.soft_threshold(torch.from_numpy(z), 0.5)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jlasso.soft_threshold(jnp.asarray(z), 0.5)))
    assert float(got.abs().max()) <= 2.5 + 1e-6
    assert bool((got.abs() <= torch.from_numpy(z).abs()).all())
    assert bool((got[torch.from_numpy(np.abs(z) <= 0.5)] == 0).all())


@pytest.mark.parametrize("mu_form", ["scalar", "scale", "signal_scale",
                                     "vertex", "signal_vertex"])
def test_mu_threshold_matches_reference(mu_form):
    eta, n = 3, 40
    mu = {"scalar": 0.1, "scale": [0.01, 0.75, 0.75],
          "signal_scale": _randn(1, (2, eta)),
          "vertex": np.abs(_randn(2, (eta, n))),
          "signal_vertex": np.abs(_randn(3, (2, eta, n)))}[mu_form]
    want = np.asarray(jlasso._mu_threshold(mu, eta, jnp.float32, GAMMA, n=n))
    got = tlasso._mu_threshold(mu, eta, torch.float32, GAMMA, n=n)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="trailing axis"):
        tlasso._mu_threshold(np.ones(eta + 1), eta, torch.float32, GAMMA,
                             n=n)


# -- Algorithm 3 -------------------------------------------------------------
@pytest.fixture(scope="module")
def lasso_ops(sensor120):
    """The J = 4, K = 20 SGWT operator of tests/test_wavelets_lasso.py:13
    in both packages."""
    lmax = sensor120.lambda_max_bound()
    L = np.asarray(sensor120.laplacian())
    jop = JOp(P=jnp.asarray(L), multipliers=jwav.sgwt_multipliers(lmax, J=4),
              lmax=lmax, K=20)
    top = GraphOperator(P=torch.from_numpy(L.copy()),
                        multipliers=twav.sgwt_multipliers(lmax, J=4),
                        lmax=lmax, K=20)
    return jop, top


MU_FORMS = {
    "scalar": lambda eta, n, b: 0.1,
    "scale": lambda eta, n, b: np.array([0.01] + [0.75] * (eta - 1),
                                        np.float32),
    "signal_scale": lambda eta, n, b: np.abs(_randn(9, b + (eta,))),
    "vertex": lambda eta, n, b: np.abs(_randn(10, b + (eta, n))) * 0.2,
}


# (mu form, batch): a per-signal mu needs a batch of signals
LASSO_CASES = [(form, batch) for form in sorted(MU_FORMS)
               for batch in ((), (3,))
               if batch or form != "signal_scale"]


@pytest.mark.parametrize("mu_form,batch", LASSO_CASES,
                         ids=[f"{f}-{len(b)}d" for f, b in LASSO_CASES])
@pytest.mark.parametrize("target", ["operator", "dense", "cuda"])
def test_distributed_lasso_matches_reference(lasso_ops, target, mu_form,
                                             batch):
    jop, top = lasso_ops
    n = 120
    y = _randn(13, batch + (n,))
    mu = MU_FORMS[mu_form](top.eta, n, batch)
    want = jlasso.distributed_lasso(jop, jnp.asarray(y), mu=mu, gamma=GAMMA,
                                    n_iters=40)
    op = top if target == "operator" else top.plan(target, device="cpu")
    got = tlasso.distributed_lasso(op, y, mu=mu, gamma=GAMMA, n_iters=40)
    assert tuple(got.coeffs.shape) == batch + (top.eta, n)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs),
                               atol=1e-4)
    np.testing.assert_allclose(got.signal.numpy(), np.asarray(want.signal),
                               atol=1e-4)
    assert got.n_iters == 40 and not got.fused


def test_lasso_objective_recorded_like_reference(lasso_ops, sensor120):
    """tests/test_wavelets_lasso.py:37 on the port: the recorded objective
    decreases, and equals the reference's."""
    jop, top = lasso_ops
    y = np.array(jax.random.normal(jax.random.PRNGKey(8), (120,)))
    gamma = tlasso.ista_step_size(top)
    assert gamma == pytest.approx(jlasso.ista_step_size(jop), rel=1e-5)
    want = jlasso.distributed_lasso(jop, jnp.asarray(y), mu=0.1, gamma=gamma,
                                    n_iters=40, record_objective=True)
    got = tlasso.distributed_lasso(top.plan("cuda", device="cpu"), y,
                                   mu=0.1, gamma=gamma, n_iters=40,
                                   record_objective=True)
    obj = got.objective.numpy()
    np.testing.assert_allclose(obj, np.asarray(want.objective), rtol=1e-4)
    assert obj[-1] <= obj[0] and np.all(np.diff(obj) < 1e-3)
    # without recording, the objective is NaN per iteration, as in the
    # reference's scan
    plain = tlasso.distributed_lasso(top, y, mu=0.1, gamma=gamma, n_iters=5)
    assert plain.objective.shape == (5,)
    assert bool(torch.isnan(plain.objective).all())


def test_custom_shrinkage_runs_as_given(lasso_ops):
    """A custom soft_threshold_fn takes the unfused update; the default
    shrinkage through `ops.ista_update` computes the same values."""
    _, top = lasso_ops
    y = _randn(14, (2, 120))
    mu = [0.01] + [0.75] * 4
    calls = []

    def shrink(z, t):
        calls.append(1)
        return tlasso.soft_threshold(z, t)

    fused = tlasso.distributed_lasso(top, y, mu=mu, gamma=GAMMA, n_iters=10)
    custom = tlasso.distributed_lasso(top, y, mu=mu, gamma=GAMMA,
                                      n_iters=10, soft_threshold_fn=shrink)
    assert len(calls) == 10
    np.testing.assert_allclose(custom.coeffs.numpy(), fused.coeffs.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_solve_lasso_matches_reference(lasso_ops, backend):
    jop, top = lasso_ops
    Y = _randn(15, (3, 120))
    mu = np.array([0.01] + [0.75] * 4, np.float32)
    want = jop.plan("dense").solve_lasso(jnp.asarray(Y), mu, n_iters=30)
    plan = top.plan(backend, device="cpu")
    assert plan.solve_lasso_fn is None
    got = plan.solve_lasso(Y, mu, n_iters=30)
    assert not got.fused and got.n_iters == 30
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs),
                               atol=1e-4)
    np.testing.assert_allclose(got.signal.numpy(), np.asarray(want.signal),
                               atol=1e-4)
    # the backend= route plans the operator itself
    via = tlasso.distributed_lasso(top, Y, mu=mu, gamma=GAMMA, n_iters=5,
                                   backend=backend, device="cpu")
    ref = plan.solve_lasso(Y, mu, gamma=GAMMA, n_iters=5)
    assert torch.equal(via.coeffs, ref.coeffs)


def test_lasso_denoises_piecewise_signal(sensor120):
    """tests/test_wavelets_lasso.py:47 on the port (its f0 and noise)."""
    key = jax.random.PRNGKey(9)
    f0 = np.asarray(graph_signal_batch(key, sensor120.coords, "piecewise"))
    y = f0 + 0.5 * np.asarray(jax.random.normal(key, f0.shape))
    lmax = sensor120.lambda_max_bound()
    op = GraphOperator(P=torch.from_numpy(np.array(sensor120.laplacian())),
                       multipliers=twav.sgwt_multipliers(lmax, J=4),
                       lmax=lmax, K=15)
    mu = [0.01] + [0.75] * 4
    res = tlasso.distributed_lasso(op.plan("cuda", device="cpu"), y, mu=mu,
                                   gamma=tlasso.ista_step_size(op),
                                   n_iters=100)
    mse_noisy = float(np.mean((y - f0) ** 2))
    mse_lasso = float(((res.signal.numpy() - f0) ** 2).mean())
    assert mse_lasso < mse_noisy


def test_masked_lasso_matches_reference(lasso_ops):
    jop, top = lasso_ops
    y = _randn(16, (120,))
    mask = np.random.default_rng(0).random(120) > 0.2
    mu = [0.01] + [0.75] * 4
    want = jlasso.distributed_lasso_masked(jop, jnp.asarray(y),
                                           jnp.asarray(mask), mu,
                                           gamma=GAMMA, n_iters=50)
    for op in (top, top.plan("cuda", device="cpu")):
        got = tlasso.distributed_lasso_masked(op, y, mask, mu, gamma=GAMMA,
                                              n_iters=50)
        np.testing.assert_allclose(got.coeffs.numpy(),
                                   np.asarray(want.coeffs), atol=1e-4)
        np.testing.assert_allclose(got.signal.numpy(),
                                   np.asarray(want.signal), atol=1e-4)


def test_lasso_cv_scores_and_regularization_path(sensor120):
    """tests/test_wavelets_lasso.py:73 on the port: the holdouts come from
    a torch.Generator (the JAX package's come from its PRNG key, so the
    scores are not compared), the regularization path is."""
    key = jax.random.PRNGKey(10)
    f0 = np.asarray(graph_signal_batch(key, sensor120.coords, "piecewise"))
    y = (f0 + 0.5 * np.asarray(jax.random.normal(key, f0.shape))).astype(
        np.float32)
    lmax = sensor120.lambda_max_bound()
    op = GraphOperator(P=torch.from_numpy(np.array(sensor120.laplacian())),
                       multipliers=twav.sgwt_multipliers(lmax, J=3),
                       lmax=lmax, K=12)
    gamma = tlasso.ista_step_size(op)
    grid = [0.0, 0.5, 50.0]
    best, scores = tlasso.lasso_cross_validate(
        op, y, grid, torch.Generator().manual_seed(1), n_folds=2,
        gamma=gamma, n_iters=60)
    assert len(scores) == 3 and all(np.isfinite(scores))
    assert best in grid
    norms = [float(tlasso.distributed_lasso(op, y, mu=mu, gamma=gamma,
                                            n_iters=60).coeffs.abs().sum())
             for mu in grid]
    assert norms[0] > norms[1] > norms[2] and norms[1] > 1.0
    assert norms[2] < 1e-6


# -- Section III-D semi-supervised classification ----------------------------
def _assert_ssl_matches(got, want):
    scores = np.asarray(want.scores)
    np.testing.assert_allclose(got.scores.numpy(), scores, atol=1e-4)
    top2 = np.sort(scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-3
    np.testing.assert_array_equal(got.predictions.numpy()[clear],
                                  np.asarray(want.predictions)[clear])


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_ssl_two_clusters_matches_reference(backend):
    """tests/test_ssl.py:9 on the port."""
    g, labels = jgraph.two_cluster_graph(jax.random.PRNGKey(3), n_per=25)
    mask = np.zeros(50, bool)
    mask[[0, 1, 25, 26]] = True
    Ln = np.asarray(g.laplacian("normalized"))
    labels = np.asarray(labels)
    want = jssl.semi_supervised_classify(jnp.asarray(Ln), jnp.asarray(labels),
                                         jnp.asarray(mask), 2, tau=0.5,
                                         lmax=2.0)
    got = tssl.semi_supervised_classify(torch.from_numpy(Ln.copy()), labels,
                                        mask, 2, tau=0.5, lmax=2.0,
                                        backend=backend, device="cpu")
    _assert_ssl_matches(got, want)
    assert tssl.accuracy(got, labels, mask) > 0.95
    assert tssl.accuracy(got, labels, mask) == pytest.approx(
        jssl.accuracy(want, jnp.asarray(labels), jnp.asarray(mask)))


@pytest.mark.parametrize("kernel", ["power1", "power2", "diffusion",
                                    "inverse_cosine", "random_walk"])
def test_ssl_kernel_variants_match_reference(kernel):
    """tests/test_ssl.py:18 on the port, every RKHS kernel."""
    g, labels = jgraph.two_cluster_graph(jax.random.PRNGKey(4), n_per=20)
    mask = np.zeros(40, bool)
    mask[[0, 20]] = True
    Ln = np.asarray(g.laplacian("normalized"))
    labels = np.asarray(labels)
    make = {"power1": ("power_kernel", 1), "power2": ("power_kernel", 2),
            "diffusion": ("diffusion_kernel", 1.0),
            "inverse_cosine": ("inverse_cosine_kernel",),
            "random_walk": ("random_walk_kernel", 2.0, 2)}[kernel]
    jh = getattr(jfilters, make[0])(*make[1:])
    th = getattr(tfilters, make[0])(*make[1:])
    want = jssl.semi_supervised_classify(jnp.asarray(Ln), jnp.asarray(labels),
                                         jnp.asarray(mask), 2, h=jh, tau=0.5,
                                         lmax=2.0)
    got = tssl.semi_supervised_classify(torch.from_numpy(Ln.copy()), labels,
                                        mask, 2, h=th, tau=0.5, lmax=2.0,
                                        backend="cuda", device="cpu")
    _assert_ssl_matches(got, want)
    assert tssl.accuracy(got, labels, mask) > 0.8


def test_ssl_sensor_quadrants_match_reference(sensor120):
    """Four quadrant classes on sensor120, 20% labeled, the default lmax
    (eigvalsh of P) and tau = 1."""
    coords = np.asarray(sensor120.coords)
    labels = ((coords[:, 0] > 0.5).astype(np.int64)
              + 2 * (coords[:, 1] > 0.5).astype(np.int64))
    mask = np.zeros(120, bool)
    mask[np.random.default_rng(0).choice(120, 24, replace=False)] = True
    Ln = np.asarray(sensor120.laplacian("normalized"))
    want = jssl.semi_supervised_classify(jnp.asarray(Ln), jnp.asarray(labels),
                                         jnp.asarray(mask), 4)
    for backend in ("dense", "cuda"):
        got = tssl.semi_supervised_classify(torch.from_numpy(Ln.copy()),
                                            labels, mask, 4, backend=backend,
                                            device="cpu")
        _assert_ssl_matches(got, want)
        assert got.scores.dtype == torch.float32


def test_label_matrix_matches_reference():
    labels = np.array([0, 1, 2, 1])
    mask = np.array([True, True, False, False])
    want = np.asarray(jssl.label_matrix(jnp.asarray(labels),
                                        jnp.asarray(mask), 3))
    np.testing.assert_array_equal(
        tssl.label_matrix(labels, mask, 3).numpy(), want)


def test_ssl_float64_dense_plan_keeps_float64():
    """A float64 P on the dense plan gives float64 scores (the reference
    `chip_smoke.py` holds the card's scores against)."""
    Ln = jgraph.two_cluster_graph(jax.random.PRNGKey(3), n_per=10)[0]
    Ln = torch.from_numpy(np.array(Ln.laplacian("normalized"))).double()
    res = tssl.semi_supervised_classify(Ln, np.arange(20) % 2,
                                        np.arange(20) < 4, 2, lmax=2.0,
                                        device="cpu")
    assert res.scores.dtype == torch.float64


def test_lasso_union_operator_accepts_reference_unions(sensor120):
    """A JAX UnionMultiplier's coefficient table through the port's
    converted operator gives the same lasso (shared state, not shared
    multiplier functions)."""
    from repro_torch.convert import operator_from_reference

    lmax = sensor120.lambda_max_bound()
    jop = JUnion(P=sensor120.laplacian(),
                 multipliers=jwav.sgwt_multipliers(lmax, J=2), lmax=lmax,
                 K=10)
    top = operator_from_reference(np.asarray(jop.P), jop.coeffs, lmax, 10)
    y = _randn(17, (120,))
    want = jlasso.distributed_lasso(jop, jnp.asarray(y), mu=0.2, gamma=GAMMA,
                                    n_iters=20)
    got = tlasso.distributed_lasso(top, y, mu=0.2, gamma=GAMMA, n_iters=20)
    np.testing.assert_allclose(got.signal.numpy(), np.asarray(want.signal),
                               atol=1e-4)


def test_entry_points_need_a_card(lasso_ops):
    """device=None is the card: without one the lasso and SSL entry
    points raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    _, top = lasso_ops
    y = _randn(18, (120,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlasso.distributed_lasso(top, y, mu=0.1, n_iters=2, backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tssl.semi_supervised_classify(np.asarray(top.P), np.zeros(120, int),
                                      np.ones(120, bool), 2, lmax=2.0,
                                      backend="cuda")
