"""The port's examples (`repro_torch.examples`) at --device cpu, in a
reduced form, against the JAX package's examples on the same numpy inputs.

The JAX scripts draw their graphs and noise from jax PRNG keys, which the
port cannot reproduce; each case here builds its inputs once with numpy
(the `sensor120` fixture's graph, a numpy noise draw; the port's
numpy-drawn two-cluster graph) and runs them through the port example's
`run` and through the JAX functions each JAX example calls, in its
order.  Tolerances are those of the reference's own tests of the
functions: 1e-5 relative for the Chebyshev applies and the solves, atol
1e-4 for the lasso (tests/test_batched.py:150) and for the SSL scores,
accuracies equal.  The sharded mains spawn 2 gloo ranks at n = 120 and
are held against the single-process run on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SENSOR500
from repro.core import filters as jfilters
from repro.core import graph as jgraph
from repro.core import ssl as jssl
from repro.core import wavelets as jwav
from repro.core.multiplier import graph_multiplier as jgraph_multiplier
from repro.dist import GraphOperator as JOp
from repro_torch.examples import distributed_lasso, quickstart
from repro_torch.examples import semi_supervised

TOL_APPLY = 1e-5
TOL_LASSO = 1e-4
LASSO_ITERS = 10


def _rel(got, want) -> float:
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def sensor_inputs(sensor120):
    """sensor120's graph, the smooth and piecewise fields on it, their
    noisy observations (numpy noise)."""
    from repro.data.pipeline import graph_signal_batch

    W = np.asarray(sensor120.W).copy()
    coords = np.asarray(sensor120.coords).copy()
    noise = np.random.RandomState(5).standard_normal(120)
    out = {"W": W, "coords": coords}
    for kind in ("smooth", "piecewise"):
        f0 = np.array(graph_signal_batch(None, jnp.asarray(coords), kind))
        out[kind] = (f0, (f0 + SENSOR500.noise_sigma * noise
                          ).astype(np.float32))
    return out


@pytest.mark.parametrize("method", ["chebyshev", "jacobi"])
def test_quickstart_matches_jax_example(sensor_inputs, method):
    """examples/quickstart.py's denoising (dense backend there) against
    the port's cuda plan, in its plain versions."""
    W, coords = sensor_inputs["W"], sensor_inputs["coords"]
    f0, y = sensor_inputs["smooth"]
    got = quickstart.run(torch.from_numpy(W), torch.from_numpy(coords),
                         torch.from_numpy(f0), torch.from_numpy(y),
                         backend="cuda", method=method, device="cpu")
    p = SENSOR500
    g = jgraph.Graph(W=jnp.asarray(W), coords=jnp.asarray(coords))
    lmax = g.lambda_max_bound()
    R = JOp(P=g.laplacian(), multipliers=[jfilters.tikhonov(p.tau, p.r)],
            lmax=lmax, K=p.K)
    plan = R.plan("dense")
    if method == "chebyshev":
        want = np.asarray(plan.apply(jnp.asarray(y))[0])
    else:
        res = plan.solve(jnp.asarray(y), method, tau=p.tau, r=p.r,
                         h_scale=2.0, n_iters=p.K,
                         check_every=max(1, p.K // 2))
        want = np.asarray(res.x)
        assert got["solve"]["exchange_rounds"] == int(
            res.info["exchange_rounds"])
        assert got["solve"]["diverged"] is False
    assert _rel(got["denoised"], want) <= TOL_APPLY
    assert got["lmax"] == pytest.approx(lmax)
    mse_den = float(np.mean((want.astype(np.float64) - f0) ** 2))
    assert got["mse_denoised"] == pytest.approx(mse_den, rel=1e-4)
    assert got["mse_denoised"] < got["mse_noisy"]
    assert got["messages"] == 2 * p.K * g.n_edges


def test_quickstart_sharded_faults_main():
    """The --drop-prob path: 2 gloo ranks of the halo plan with the
    port's FaultSpec; the faults change the output, not the schedule's
    message count, and it still denoises."""
    x = quickstart.inputs(120)
    clean = quickstart.run(x["W"], x["coords"], x["f0"], x["y"],
                           backend="halo", device="cpu")
    got = quickstart.main(["--device", "cpu", "--backend", "halo",
                           "--drop-prob", "0.2", "--ranks", "2", "--n",
                           "120"])
    assert got["n_shards"] == 2 and got["backend"] == "halo"
    assert got["fault_key"].startswith("drop0.2")
    assert clean["fault_key"] == "none"
    assert got["messages"] == clean["messages"]
    assert _rel(got["denoised"], clean["denoised"].numpy()) > 1e-3
    assert np.isfinite(got["mse_denoised"])
    assert got["mse_denoised"] < got["mse_noisy"]


def test_distributed_lasso_matches_jax_example(sensor_inputs):
    """examples/distributed_lasso.py's dense path (Tikhonov apply and
    `solve_lasso` at SENSOR500's lasso_K, gamma and both mu) against the
    port's cuda plan, reduced to 10 ISTA iterations."""
    W, coords = sensor_inputs["W"], sensor_inputs["coords"]
    f0, y = sensor_inputs["piecewise"]
    got = distributed_lasso.run(torch.from_numpy(W),
                                torch.from_numpy(coords),
                                torch.from_numpy(f0), torch.from_numpy(y),
                                backend="cuda", n_iters=LASSO_ITERS,
                                device="cpu")
    p = SENSOR500
    g = jgraph.Graph(W=jnp.asarray(W), coords=jnp.asarray(coords))
    lmax = g.lambda_max_bound()
    mu = jnp.array([p.lasso_mu_scaling]
                   + [p.lasso_mu_wavelet] * p.n_wavelet_scales)
    op = jwav.sgwt_operator(g.laplacian(), lmax, J=p.n_wavelet_scales,
                            K=p.lasso_K)
    tik = jgraph_multiplier(g.laplacian(), jfilters.tikhonov(p.tau, p.r),
                            lmax, K=p.K).apply(jnp.asarray(y))
    res = op.plan("dense").solve_lasso(jnp.asarray(y), mu,
                                       gamma=p.lasso_gamma,
                                       n_iters=LASSO_ITERS)
    assert _rel(got["tikhonov"], tik) <= TOL_APPLY
    np.testing.assert_allclose(got["signal"].numpy(),
                               np.asarray(res.signal), atol=TOL_LASSO)
    np.testing.assert_allclose(got["coeffs"].numpy(),
                               np.asarray(res.coeffs), atol=TOL_LASSO)
    np.testing.assert_allclose(distributed_lasso.mu_weights(),
                               np.asarray(mu), rtol=1e-7)
    assert got["mse_lasso"] < got["mse_noisy"]


def test_distributed_lasso_sharded_main_matches_one_process():
    """--sharded on 2 gloo ranks (the fused ISTA loop on each rank's
    rows) against the one-process run on the same inputs."""
    x = distributed_lasso.inputs(120)
    want = distributed_lasso.run(x["W"], x["coords"], x["f0"], x["y"],
                                 backend="dense", n_iters=5, device="cpu")
    got = distributed_lasso.main(["--device", "cpu", "--sharded",
                                  "--ranks", "2", "--n", "120", "--iters",
                                  "5"])
    assert got["n_shards"] == 2 and got["fused"] is True
    assert got["counted"]["rounds"] == SENSOR500.lasso_K
    np.testing.assert_allclose(got["signal"].numpy(),
                               want["signal"].numpy(), atol=TOL_LASSO)
    np.testing.assert_allclose(got["tikhonov"].numpy(),
                               want["tikhonov"].numpy(), atol=TOL_LASSO)


def test_semi_supervised_matches_jax_example():
    """examples/semi_supervised.py's four kernels on one two-cluster graph
    (drawn once with numpy) through both packages."""
    x = semi_supervised.inputs(3)
    got = semi_supervised.run(x["W"], x["labels"], x["mask"],
                              backend="cuda", device="cpu")
    W = x["W"].numpy()
    labels = x["labels"].numpy()
    Ln = jgraph.laplacian(jnp.asarray(W), "normalized")
    jkernels = [jfilters.power_kernel(1), jfilters.power_kernel(2),
                jfilters.diffusion_kernel(1.0),
                jfilters.random_walk_kernel(2.0, 2)]
    assert len(got) == len(jkernels)
    for (name, r), h in zip(got.items(), jkernels):
        want = jssl.semi_supervised_classify(
            Ln, jnp.asarray(labels), jnp.asarray(x["mask"]), 2, h=h,
            tau=0.5, lmax=2.0, K=20)
        np.testing.assert_allclose(r["scores"].numpy(),
                                   np.asarray(want.scores), atol=1e-4)
        assert r["accuracy"] == pytest.approx(jssl.accuracy(
            want, jnp.asarray(labels), jnp.asarray(x["mask"]))), name
    assert got["tikhonov L_norm  (S = L_norm)"]["accuracy"] > 0.9
