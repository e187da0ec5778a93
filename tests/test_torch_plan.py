"""The port's main path as a whole — GraphOperator.plan(...).apply /
apply_adjoint / apply_gram — held against the JAX package's plans on the
same operator and signals.

The operator is the n = 120, eta = 3, K = 12 one of tests/test_sweep.py:22-32
(n is not a multiple of 128, so every padding path runs).  References:
the reference's plan("dense") and plan("pallas", use_pallas=False) (its
jnp oracles; its Pallas sweep does not run on this jax).  Tolerance: atol
1e-4, that of the reference's own backend-equivalence test
(tests/test_sweep.py:307).  Here the port runs with device="cpu", i.e.
through the kernels' plain PyTorch versions.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import wavelets as jwav
from repro.dist import GraphOperator as JOp
from repro_torch.convert import block_ell_from_numpy, operator_from_reference
from repro_torch.core import wavelets as twav
from repro_torch.dist import (GraphOperator, available_backends,
                              canonical_kwarg, get_backend)

BACKENDS = ["cuda", "dense"]
KINDS = ["apply", "apply_adjoint", "apply_gram"]


@pytest.fixture(scope="module")
def ops120():
    """(reference operator, port operator) on the same P and multipliers."""
    g, _ = jgraph.connected_sensor_graph(
        jax.random.PRNGKey(0), n=120, theta=0.2, kappa=0.25)
    lmax = g.lambda_max_bound()
    L = np.asarray(g.laplacian())
    jop = JOp(P=jnp.asarray(L), multipliers=jwav.sgwt_multipliers(lmax, J=2),
              lmax=lmax, K=12)
    top = GraphOperator(P=torch.from_numpy(L.copy()),
                        multipliers=twav.sgwt_multipliers(lmax, J=2),
                        lmax=lmax, K=12)
    return jop, top


@pytest.fixture(scope="module")
def ref_plans(ops120):
    jop, _ = ops120
    return {"dense": jop.plan("dense"),
            "pallas_ref": jop.plan("pallas", use_pallas=False)}


def _signal(kind, batch, eta, n, seed):
    shape = batch + ((eta, n) if kind == "apply_adjoint" else (n,))
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("batch", [(64,), ()])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_plan_matches_reference_plans(ops120, ref_plans, backend, kind,
                                      batch):
    jop, top = ops120
    x = _signal(kind, batch, jop.eta, 120, seed=len(batch) + 3)
    got = getattr(top.plan(backend, device="cpu"), kind)(x)
    assert got.device.type == "cpu"
    for name, plan in ref_plans.items():
        want = np.asarray(getattr(plan, kind)(jnp.asarray(x)))
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("kind", KINDS + ["solve"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_float64_signal_cast_to_plan_dtype(ops120, ref_plans, backend, kind):
    """A float64 numpy signal is cast to the plan's dtype at its boundary
    (float32 here: P's own for dense, the packed P's for cuda) and meets
    the reference, which takes it to float32 under jax's default x64-off
    (ROADMAP.md, fault 3.1)."""
    jop, top = ops120
    rs = np.random.RandomState(0)
    x = rs.randn(4, jop.eta, 120) if kind == "apply_adjoint" else rs.randn(4, 120)
    assert x.dtype == np.float64
    plan = top.plan(backend, device="cpu")
    if kind == "solve":
        got = plan.solve(x, "jacobi", tau=0.5, n_iters=20).x
        want = ref_plans["dense"].solve(x, "jacobi", tau=0.5, n_iters=20).x
    else:
        got = getattr(plan, kind)(x)
        want = getattr(ref_plans["dense"], kind)(x)
    assert got.dtype == torch.float32
    assert np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("batch", [(64,), ()])
@pytest.mark.parametrize("kind", ["apply", "apply_gram"])
def test_per_order_plan_matches_reference(ops120, ref_plans, kind, batch):
    """plan("cuda", sweep=False): one fused order launch per order."""
    jop, top = ops120
    x = _signal(kind, batch, jop.eta, 120, seed=9)
    got = getattr(top.plan("cuda", device="cpu", sweep=False), kind)(x)
    want = np.asarray(getattr(ref_plans["dense"], kind)(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_plan_guard_falls_back_logged_same_numbers(ops120, caplog):
    jop, top = ops120
    x = _signal("apply", (4,), jop.eta, 120, seed=5)
    with caplog.at_level(logging.INFO, logger="repro_torch.kernels.ops"):
        small = top.plan("cuda", device="cpu", l2_budget=64).apply(x)
    assert any("falling back to the per-order" in r.message
               for r in caplog.records)
    big = top.plan("cuda", device="cpu").apply(x)
    np.testing.assert_allclose(small.numpy(), big.numpy(), atol=2e-5)


def test_no_cpu_fallback_without_a_card(ops120):
    """The default device is the card; with none, plans raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    _, top = ops120
    for backend in BACKENDS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            top.plan(backend)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            top.plan(backend, device="cuda")


def test_options_not_ported_raise(ops120):
    _, top = ops120
    # the bf16 sweep mode is ported (tests/test_torch_bf16_sweep.py)
    assert top.plan("cuda", device="cpu",
                    sweep_dtype="bf16").info["sweep_dtype"] == "bf16"
    plan = top.plan("cuda", device="cpu")
    # solve and solve_lasso are ported (tests/test_torch_solvers.py,
    # tests/test_torch_lasso_ssl.py), and so is the serving surface
    # (tests/test_torch_plan_cache.py, tests/test_torch_serving.py): on the
    # CPU its entries call the plan (eager)
    assert plan.compiled("apply").mode == "eager"
    assert plan.compiled_solve("jacobi").mode == "eager"
    assert set(plan.bucketed_callables((1, 2))) == {("apply", 1),
                                                   ("apply", 2)}
    with pytest.raises(TypeError):
        top.plan("cuda", device="cpu", use_pallas=True)


def test_plan_info_and_metadata(ops120):
    """The reference's pallas info keys, the VMEM budget renamed for L2."""
    jop, top = ops120
    jinfo = jop.plan("pallas", use_pallas=False).info
    plan = top.plan("cuda", device="cpu")
    info = plan.info
    renamed = {"sweep_vmem_bytes": "sweep_l2_bytes",
               "sweep_vmem_budget": "sweep_l2_budget"}
    for key in jinfo:
        assert renamed.get(key, key) in info, key
    for key in ("block", "padded_n", "nnz_blocks", "sweep_dtype"):
        assert info[key] == jinfo[key], key
    # the port's SpMV multiplies the stored sliced-ELL entries, not the
    # Block-ELL tiles the reference's flops_per_matvec counts
    S = info["block_ell"].sliced_ell()
    assert info["flops_per_matvec"] == 2 * S.stored
    assert info["stored_per_nnz"] == S.stored / S.nnz
    assert info["nnz"] == S.nnz == int(np.count_nonzero(np.asarray(
        top.P)))
    assert info["sweep_l2_bytes"] == 3 * 128 * 4
    assert plan.backend == "cuda" and plan.device == torch.device("cpu")
    assert (plan.eta, plan.K, plan.lmax) == (jop.eta, jop.K, jop.lmax)
    assert np.array_equal(plan.coeffs, jop.coeffs)
    assert plan.error_bound() == pytest.approx(jop.error_bound(), rel=1e-3)
    assert plan.message_counts(10) == jop.message_counts(10)
    assert available_backends() == ["allgather", "cuda", "cuda_halo",
                                    "dense", "halo"]
    with pytest.raises(KeyError):
        get_backend("pallas")


@pytest.mark.parametrize("backend", BACKENDS)
def test_matvec_runner_crops_to_logical_n(ops120, backend):
    jop, top = ops120
    x = _signal("apply", (2,), jop.eta, 120, seed=1)
    plan = top.plan(backend, device="cpu")
    out = plan.matvec_runner(lambda mv, v: (mv(v), v), (x,))
    L = np.asarray(jop.P)
    assert out[0].shape == (2, 120) and out[1].shape == (2, 120)
    np.testing.assert_allclose(out[0].numpy(), x @ L.T, atol=1e-4)


def test_operator_from_reference_state(ops120):
    """The converted operator uses exactly the reference's coefficients
    and gives the same plans; Block-ELL arrays carry across unchanged."""
    jop, top = ops120
    P = np.asarray(jop.P)
    conv = operator_from_reference(P, jop.coeffs, jop.lmax, jop.K)
    assert np.array_equal(conv.coeffs, jop.coeffs) and conv.eta == jop.eta
    x = _signal("apply", (3,), jop.eta, 120, seed=2)
    assert torch.equal(conv.plan("cuda", device="cpu").apply(x),
                       top.plan("cuda", device="cpu").apply(x))
    with pytest.raises(ValueError):
        conv.error_bound()
    with pytest.raises(ValueError):
        operator_from_reference(P, jop.coeffs, jop.lmax, jop.K + 1)
    A = jgraph.to_block_ell(P, (8, 128))
    At = block_ell_from_numpy(np.asarray(A.blocks), np.asarray(A.indices),
                              np.asarray(A.mask), A.n)
    assert At.padded_n == A.padded_n and At.indices.dtype == torch.int32
    bad = np.asarray(A.indices).copy()
    bad[0, 0] = 99
    with pytest.raises(ValueError, match="outside"):
        block_ell_from_numpy(np.asarray(A.blocks), bad, np.asarray(A.mask),
                             A.n)


def test_canonical_kwarg_keys():
    assert canonical_kwarg(True) != canonical_kwarg(1)
    a = np.arange(4.0)
    assert canonical_kwarg(a) == canonical_kwarg(torch.arange(4.0,
                                                              dtype=torch.float64))
    assert canonical_kwarg((1, [a])) == (1, (canonical_kwarg(a),))
    assert canonical_kwarg("x") == "x"
