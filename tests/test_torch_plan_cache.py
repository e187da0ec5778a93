"""The port's ExecutionPlan.compiled() / compiled_solve() memo audit: the
counterpart of each test of tests/test_plan_cache.py, over the port's
plan("dense") and plan("cuda", device="cpu"), plus the memo keys held
character for character to the JAX package's and the static capture rule
of `repro_torch.dist.capture`.

Every kwarg that changes what a solve runs must be part of the memo key,
and repeat lookups with identical kwargs must return the SAME entry.  An
entry counts its captures per (shape, dtype) (`entry.captures`: on the
card, one CUDA graph each; here, on the CPU, where every entry is eager,
its first calls), the counterpart of the JAX test's trace counter: a
serving loop's interleaved buckets hold it at one per bucket.

The operator is the reference test's: the n = 48 sensor graph of
PRNGKey(0), SGWT J = 2, K = 6.  Solve results are held to each other
within the reference test's tolerances (1e-5, 1e-6 / 1e-7).
"""
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import wavelets as jwav
from repro.dist import GraphOperator as JOp
from repro_torch.core import wavelets as twav
from repro_torch.dist import GraphOperator
from repro_torch.dist.capture import capture_mode
from repro_torch.dist.operator import canonical_kwarg, canonical_solve_items

BACKENDS = ["dense", "cuda"]


@pytest.fixture(scope="module")
def ops():
    """(JAX operator, port operator) on the reference test's graph."""
    g, _ = jgraph.connected_sensor_graph(jax.random.PRNGKey(0), n=48,
                                         theta=0.3, kappa=0.35)
    lmax = g.lambda_max_bound()
    L = np.asarray(g.laplacian())
    jop = JOp(P=jnp.asarray(L), multipliers=jwav.sgwt_multipliers(lmax, J=2),
              lmax=lmax, K=6)
    top = GraphOperator(P=torch.from_numpy(L.copy()),
                        multipliers=twav.sgwt_multipliers(lmax, J=2),
                        lmax=lmax, K=6)
    return jop, top


@pytest.fixture(scope="module")
def op(ops):
    return ops[1]


@pytest.fixture(scope="module")
def y(op):
    return torch.from_numpy(
        np.random.RandomState(1).randn(op.P.shape[0]).astype(np.float32))


def _plan(op, backend):
    return op.plan(backend, device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_compiled_memo_identity(op, backend):
    plan = _plan(op, backend)
    assert plan.compiled("apply") is plan.compiled("apply")
    assert plan.compiled("apply") is not plan.compiled("apply_gram")
    with pytest.raises(KeyError):
        plan.compiled("nope")


@pytest.mark.parametrize("backend", BACKENDS)
def test_compiled_solve_memo_identity(op, backend):
    plan = _plan(op, backend)
    a = plan.compiled_solve("jacobi", tau=0.5)
    assert plan.compiled_solve("jacobi", tau=0.5) is a


@pytest.mark.parametrize("backend", BACKENDS)
def test_compiled_solve_distinct_kwargs_distinct_entries(op, y, backend):
    """Two calls differing ONLY in a kwarg that changes the solve must not
    collide in the memo (the port's sweep budget is `l2_budget=`)."""
    plan = _plan(op, backend)
    base = plan.compiled_solve("jacobi", tau=0.5)
    assert plan.compiled_solve("cheb_jacobi", tau=0.5, rho=0.5) is not base
    assert plan.compiled_solve("jacobi", tau=0.25) is not base
    assert plan.compiled_solve("jacobi", tau=0.5, n_iters=3) is not base
    assert plan.compiled_solve("jacobi", tau=0.5, l2_budget=4096) \
        is not base
    x6 = np.asarray(base(y))
    x3 = np.asarray(plan.compiled_solve("jacobi", tau=0.5, n_iters=3)(y))
    assert not np.allclose(x6, x3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_compiled_solve_array_kwargs_key_by_value(op, y, backend):
    plan = _plan(op, backend)
    n = y.shape[0]
    d1 = np.full((n,), 2.0, np.float32)
    d2 = np.full((n,), 4.0, np.float32)
    f1 = plan.compiled_solve("jacobi", tau=0.5, den_diag=d1)
    f2 = plan.compiled_solve("jacobi", tau=0.5, den_diag=d2)
    assert f1 is not f2
    assert f1 is plan.compiled_solve("jacobi", tau=0.5, den_diag=d1.copy())
    # a tensor of the same values keys like the array
    assert f1 is plan.compiled_solve("jacobi", tau=0.5,
                                     den_diag=torch.from_numpy(d1.copy()))
    assert not np.allclose(np.asarray(f1(y)), np.asarray(f2(y)))


def test_canonical_kwarg_bool_int_no_alias():
    """True == 1 in Python (and hashes equal): without the bool tag the
    memo would hand the int-keyed caller the bool entry."""
    assert canonical_kwarg(True) != canonical_kwarg(1)
    assert canonical_kwarg(False) != canonical_kwarg(0)
    assert canonical_kwarg(True) == canonical_kwarg(True)
    assert canonical_solve_items({"a": 1, "b": True}) \
        != canonical_solve_items({"a": True, "b": 1})


# ---------------------------------------------------------------------------
# Serving safety: the engine's bucketed call pattern
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_bucketed_callables_distinct_buckets_no_retrace(op, y, backend):
    """The engine's exact call pattern: warm the bucket set, then serve
    interleaved bucket sizes repeatedly — each bucket is captured (here:
    first-called) exactly once, repeats reuse it."""
    plan = _plan(op, backend)
    n = y.shape[0]
    fns = plan.bucketed_callables((1, 8), kinds=("apply",), warm=True)
    assert set(fns) == {("apply", 1), ("apply", 8)}
    # one memoized entry, one capture per bucket
    assert fns[("apply", 1)] is fns[("apply", 8)]
    entry = fns[("apply", 1)]
    assert entry is plan.compiled("apply")
    keys = {((1, n), torch.float32), ((8, n), torch.float32)}
    assert set(entry.captures) == keys
    assert all(v == 1 for v in entry.captures.values())
    f1 = torch.zeros((1, n))
    f8 = torch.zeros((8, n))
    for _ in range(5):                            # serving steady state
        entry(f1)
        entry(f8)
    assert set(entry.captures) == keys            # zero recaptures
    assert all(v == 1 for v in entry.captures.values())
    assert entry(f1).shape[0] == 1
    assert entry(f8).shape[0] == 8


@pytest.mark.parametrize("backend", BACKENDS)
def test_bucketed_callables_solve_specs_and_validation(op, y, backend):
    plan = _plan(op, backend)
    fns = plan.bucketed_callables(
        (1, 4), kinds=(), solve_specs=[("jacobi", {"tau": 0.5})],
        warm=True)
    label = ("solve", "jacobi") + canonical_solve_items({"tau": 0.5})
    assert set(fns) == {(label, 1), (label, 4)}
    assert fns[(label, 1)] is plan.compiled_solve("jacobi", tau=0.5)
    out = fns[(label, 4)](torch.stack([y] * 4))
    np.testing.assert_allclose(
        np.asarray(out[0]),
        np.asarray(plan.solve(y, "jacobi", tau=0.5).x), atol=1e-5)
    with pytest.raises(ValueError, match="buckets"):
        plan.bucketed_callables((0, 4))
    with pytest.raises(KeyError, match="unknown kind"):
        plan.bucketed_callables((1,), kinds=("nope",))


@pytest.mark.parametrize("backend", BACKENDS)
def test_vmem_budget_times_bucket_no_collision(op, y, backend):
    """Two buckets of two budget variants at once: four distinct captures,
    no cross-contamination — the budget is part of the memo key, the
    bucket part of the entry's shape key."""
    plan = _plan(op, backend)
    fa = plan.compiled_solve("jacobi", tau=0.5)
    fb = plan.compiled_solve("jacobi", tau=0.5, l2_budget=4096)
    assert fa is not fb
    y1 = y[None]
    y8 = torch.stack([y] * 8)
    outs = [fa(y1), fb(y1), fa(y8), fb(y8)]       # interleaved buckets
    assert [o.shape[0] for o in outs] == [1, 1, 8, 8]
    np.testing.assert_allclose(np.asarray(outs[0]), np.asarray(outs[1]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(outs[2][7]),
                               np.asarray(outs[0][0]), rtol=1e-6, atol=1e-7)
    assert plan.compiled_solve("jacobi", tau=0.5) is fa
    assert plan.compiled_solve("jacobi", tau=0.5, l2_budget=4096) is fb
    assert len(fa.captures) == len(fb.captures) == 2


def test_solve_vmem_budget_forces_logged_fallback(op, y, caplog):
    """l2_budget= reaches the single-launch sweep guard: a starved budget
    takes the logged per-round path and matches the default-budget result
    (the knob changes the execution, never the math)."""
    plan = _plan(op, "cuda")
    ref = np.asarray(plan.solve(y, "jacobi", tau=0.5).x)
    with caplog.at_level(logging.INFO, logger="repro_torch.kernels.ops"):
        out = np.asarray(plan.compiled_solve("jacobi", tau=0.5,
                                             l2_budget=64)(y))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert any("exceeds budget" in r.getMessage()
               for r in caplog.records), caplog.records


# ---------------------------------------------------------------------------
# The memo keys are the JAX package's, and the capture rule is static
# ---------------------------------------------------------------------------
SOLVE_CALLS = [("jacobi", {"tau": 0.5}), ("jacobi", {"tau": 0.5,
                                                      "n_iters": 3}),
               ("cheb_jacobi", {"tau": 0.5, "rho": 0.5}),
               ("chebyshev", {"tau": 0.25, "use_pallas": True}),
               ("jacobi", {"tau": 0.5, "den_diag": np.arange(3.0)})]


@pytest.mark.parametrize("backend", BACKENDS)
def test_memo_keys_equal_reference(ops, backend):
    """The same lookups on the JAX dense plan and the port's plan leave
    the same memo keys, character for character."""
    jop, top = ops
    jplan = jop.plan("dense")
    tplan = _plan(top, backend)
    for kind in ("apply", "apply_adjoint", "apply_gram"):
        jplan.compiled(kind)
        tplan.compiled(kind)
    for method, kw in SOLVE_CALLS:
        jplan.compiled_solve(method, **kw)
        tplan.compiled_solve(method, **kw)
    jkeys = [repr(k) for k in jplan._jit_cache()]
    tkeys = [repr(k) for k in tplan._entry_cache()]
    assert tkeys == jkeys


def test_capture_mode_static_rule(op):
    """The rule reads the plan and the kwargs only: every CPU plan is
    eager; a `cuda` plan on the card captures the apply kinds and the
    solves that read nothing on the host."""
    for backend in BACKENDS:
        plan = _plan(op, backend)
        assert plan.compiled("apply").mode == "eager"
        assert plan.compiled_solve("jacobi", tau=0.5).mode == "eager"
    card = types.SimpleNamespace(backend="cuda",
                                 device=torch.device("cuda", 0))
    for kind in ("apply", "apply_adjoint", "apply_gram"):
        assert capture_mode(card, kind) == "graph"
    for method in ("jacobi", "cheb_jacobi", "chebyshev"):
        assert capture_mode(card, "solve", method, {"tau": 0.5}) == "graph"
    assert capture_mode(card, "solve", "jacobi",
                        {"tau": 0.5, "l2_budget": 64}) == "graph"
    for method, kw in [("arma", {"tau": 0.5}),
                       ("jacobi", {"tau": 0.5, "check_every": 4}),
                       ("jacobi", {"tau": 0.5, "history": True}),
                       ("jacobi", {"tau": 0.5, "x0": np.zeros(3)}),
                       ("jacobi", {"tau": 0.5, "den_diag": np.ones(3)})]:
        assert capture_mode(card, "solve", method, kw) == "eager", kw
    for backend in ("dense", "halo", "cuda_halo", "allgather"):
        sharded = types.SimpleNamespace(backend=backend,
                                        device=torch.device("cuda", 0))
        assert capture_mode(sharded, "apply") == "eager"
