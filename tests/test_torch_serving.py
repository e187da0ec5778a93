"""The port's continuous-batching engine (`repro_torch.serve`) against the
JAX package's (`repro.serve`).

1. A counterpart of each of the 20 tests of tests/test_serving.py, over
   the port's plan("dense") and plan("cuda", device="cpu") (eager entries:
   the kernels' plain versions), under a virtual clock: flush triggers,
   chunking, the starvation bound, FIFO across keys, compat-key isolation,
   routing, served == direct bit for bit, admission checks, deadlines,
   the bounded queue, the retry policy, dispatch containment and the
   summary schema; the 8-device payload's counterpart runs 8 gloo ranks.
2. The serving properties of tests/test_property.py (the vendored
   hypothesis stub): pack / unpack is bitwise, and routing is a bijection.
3. Parity: the same seeded `poisson_arrivals` / `burst_arrivals` stream
   (event for event the JAX generator's) replayed through the JAX engine
   over the JAX dense plan and through the port's over the port's plans
   gives identical batch records and `summary()` dicts, and every served
   value within 1e-5 (relative max) of the JAX engine's; the straggler leg
   of benchmarks/bench_faults.py `serving_leg` gives the reference's
   summaries (and the tracked BENCH_faults.json's); the compat labels of
   the port's `halo` plans at every wire and under a FaultSpec are the
   reference's strings.
4. 8 gloo ranks (one spawn): a virtual-clock engine per rank over
   ``cuda_halo`` and ``halo`` (device="cpu") coalesces B = 32 submits into
   one batch whose counted exchange is K rounds and the byte model at
   B = 32; its rows equal the rank's direct ``compiled("apply")`` call
   bit for bit and the JAX dense plan within 1e-4 (the reference backend
   test's tolerance); a faulted plan registered beside the clean one never
   coalesces with it.  Under a clock without ``advance_to`` rank 0 leads
   and the others follow: a `WallClock` leader serves B = 32 submits
   once; under a scripted clock the leader's batch records and summary
   for a seeded Poisson stream are the JAX engine's over the JAX dense
   plan, every served batch equals the direct call on every rank bit for
   bit with the same counted exchange, and every follower runs the
   leader's batch count; a follower's submit raises, and plans over two
   groups cannot share an engine.

The JAX package is imported inside the fixtures and tests only: the
spawned ranks import this module to find their entry point.
"""
import dataclasses
import json
import os
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

from repro_torch.core import wavelets as twav
from repro_torch.dist import FaultSpec, GraphOperator, comm
from repro_torch.serve import (PendingError, RequestFailed, RetryPolicy,
                               ServeEngine, VirtualClock, WallClock,
                               burst_arrivals, pack_batch, poisson_arrivals,
                               replay_virtual, signal_for, unpack_batch)
from repro_torch.serve.loadgen import DEFAULT_MIX
import repro_torch.serve as tserve

MAX_WAIT = 0.005
BACKENDS = ["dense", "cuda"]
TOL_JAX = 1e-5          # served values vs the JAX engine's (relative max)
TOL_DENSE = 1e-4        # sharded rows vs the JAX dense plan (atol)
WORLD, B_SHARD, K_SHARD = 8, 32, 10


# ---------------------------------------------------------------------------
# Fixtures: the reference test's n = 48 operator, in both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def op48():
    """(graph size, JAX operator, port operator): the sensor graph of
    PRNGKey(0), n = 48, SGWT J = 2, K = 6 (tests/test_serving.py)."""
    import jax
    import jax.numpy as jnp

    from repro.core import graph as jgraph
    from repro.core import wavelets as jwav
    from repro.dist import GraphOperator as JOp

    g, _ = jgraph.connected_sensor_graph(jax.random.PRNGKey(0), n=48,
                                         theta=0.3, kappa=0.35)
    lmax = g.lambda_max_bound()
    L = np.asarray(g.laplacian())
    jop = JOp(P=jnp.asarray(L), multipliers=jwav.sgwt_multipliers(lmax, J=2),
              lmax=lmax, K=6)
    top = GraphOperator(P=torch.from_numpy(L.copy()),
                        multipliers=twav.sgwt_multipliers(lmax, J=2),
                        lmax=lmax, K=6)
    return g.n_vertices, jop, top


@pytest.fixture(scope="module", params=BACKENDS)
def plan(request, op48):
    return op48[2].plan(request.param, device="cpu")


@pytest.fixture(scope="module")
def n(op48):
    return op48[0]


def make_engine(plans, buckets=(1, 4, 8), max_wait=MAX_WAIT):
    clock = VirtualClock()
    eng = ServeEngine(plans, buckets=buckets, max_wait=max_wait,
                      clock=clock, sync_results=False)
    return eng, clock


def sig(n, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).standard_normal(n).astype(np.float32))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# Flush triggers
# ---------------------------------------------------------------------------
def test_flush_on_batch_full(n, plan):
    """A full largest bucket dispatches inline at submit — zero delay."""
    eng, clock = make_engine(plan)
    futs = [eng.submit(sig(n, i)) for i in range(8)]
    assert all(f.done() for f in futs)
    assert eng.pending_count == 0
    assert clock.now() == 0.0
    [batch] = eng.metrics.batches
    assert (batch.bucket, batch.occupancy, batch.padding) == (8, 8, 0)
    assert all(f.response.latency == 0.0 for f in futs)


def test_flush_on_deadline(n, plan):
    """A partial group waits exactly max_wait, then pads to its bucket."""
    eng, clock = make_engine(plan)
    futs = [eng.submit(sig(n, i)) for i in range(3)]
    assert not any(f.done() for f in futs)
    with pytest.raises(PendingError):
        futs[0].result()
    clock.advance(MAX_WAIT * 0.8)
    assert eng.poll() == 0
    assert eng.next_deadline() == pytest.approx(MAX_WAIT)
    clock.advance_to(MAX_WAIT)
    assert eng.poll() == 3
    [batch] = eng.metrics.batches
    assert (batch.bucket, batch.occupancy, batch.padding) == (4, 3, 1)
    assert all(f.response.latency == pytest.approx(MAX_WAIT) for f in futs)


def test_oversized_group_chunks_then_drains(n, plan):
    """batch-full flushes take largest-bucket chunks; the remainder rides
    the deadline flush — nothing is lost, nothing is double-served."""
    eng, _ = make_engine(plan)
    futs = [eng.submit(sig(n, i)) for i in range(11)]
    assert sum(f.done() for f in futs) == 8
    assert eng.pending_count == 3
    eng.run_until_idle()
    assert all(f.done() for f in futs)
    assert [(b.bucket, b.occupancy) for b in eng.metrics.batches] == \
        [(8, 8), (4, 3)]
    s = eng.metrics.summary()
    assert s["served_exactly_once"] and s["n_served"] == 11


def test_burst_rides_one_bucket(n, plan):
    """A simultaneous burst of exactly bucket size coalesces into ONE
    dispatch per burst."""
    eng, _ = make_engine(plan, buckets=(1, 8))
    events = burst_arrivals(n_bursts=3, burst_size=8, period=0.1, seed=5,
                            mix=[(1.0, "apply", None, {})])
    replay_virtual(eng, events, n=n)
    assert [b.occupancy for b in eng.metrics.batches] == [8, 8, 8]
    assert eng.metrics.summary()["padding_waste"] == 0.0


# ---------------------------------------------------------------------------
# Fairness / starvation bound
# ---------------------------------------------------------------------------
def test_starvation_bound_and_fifo(n, plan):
    """No admitted request queues longer than max_wait before dispatch,
    and batches of one key take requests strictly in arrival order."""
    eng, _ = make_engine(plan)
    events = poisson_arrivals(rate=700.0, n_requests=60, seed=11)
    futs = replay_virtual(eng, events, n=n)
    assert eng.metrics.summary()["served_exactly_once"]
    by_key = {}
    for f in futs.values():
        r = f.response
        assert r.queue_delay <= MAX_WAIT + 1e-12
        by_key.setdefault(r.key, []).append(r)
    for rs in by_key.values():
        dispatch_ts = [r.t_dispatch for r in sorted(rs, key=lambda r: r.id)]
        assert dispatch_ts == sorted(dispatch_ts)


def test_due_groups_flush_oldest_first(n, plan):
    """When several keys are due in one poll, the key with the oldest
    waiting request dispatches first (FIFO fairness across keys)."""
    eng, clock = make_engine(plan)
    f_solve = eng.submit(sig(n, 0), kind="solve", method="jacobi", tau=0.5)
    clock.advance(0.001)
    f_apply = eng.submit(sig(n, 1))
    clock.advance(MAX_WAIT)
    eng.poll()
    assert f_solve.done() and f_apply.done()
    assert [b.key.kind for b in eng.metrics.batches] == ["solve", "apply"]


# ---------------------------------------------------------------------------
# Compatibility-key isolation
# ---------------------------------------------------------------------------
def test_compat_key_isolation(n, plan):
    """A jacobi solve never rides a chebyshev (or apply) batch: every
    dispatched batch is homogeneous in (kind, method, n_iters, tau)."""
    eng, _ = make_engine(plan)
    specs = [
        dict(kind="apply"),
        dict(kind="apply_gram"),
        dict(kind="solve", method="jacobi", tau=0.5, n_iters=4),
        dict(kind="solve", method="jacobi", tau=0.25, n_iters=4),
        dict(kind="solve", method="jacobi", tau=0.5, n_iters=6),
        dict(kind="solve", method="chebyshev", tau=0.5, n_iters=4),
    ]
    futs = []
    for i in range(24):
        futs.append((i % len(specs),
                     eng.submit(sig(n, i), **specs[i % len(specs)])))
    eng.run_until_idle()
    assert eng.metrics.summary()["served_exactly_once"]
    keys = {b.key for b in eng.metrics.batches}
    assert len(keys) == len(specs)
    for spec_idx, f in futs:
        r = f.response
        want = specs[spec_idx]
        assert r.key.kind == want["kind"]
        assert r.key.method == want.get("method")
        if "tau" in want:
            assert r.key.tau == want["tau"]
        if "n_iters" in want:
            assert r.key.order == want["n_iters"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_operator_routing(n, op48, backend):
    """Two registered operators: requests land on the plan they named and
    never co-batch across operators."""
    op = op48[2]
    op_wide = GraphOperator(P=op.P, multipliers=op.multipliers,
                            lmax=op.lmax, K=12)
    plans = {"k6": op.plan(backend, device="cpu"),
             "k12": op_wide.plan(backend, device="cpu")}
    eng, _ = make_engine(plans)
    f = sig(n, 42)
    fut6 = eng.submit(f, op="k6")
    fut12 = eng.submit(f, op="k12")
    eng.run_until_idle()
    assert {b.key.op for b in eng.metrics.batches} == {"k6", "k12"}
    np.testing.assert_array_equal(
        _np(fut6.result()), _np(plans["k6"].compiled("apply")(f[None])[0]))
    np.testing.assert_array_equal(
        _np(fut12.result()),
        _np(plans["k12"].compiled("apply")(f[None])[0]))
    assert not np.allclose(_np(fut6.result()), _np(fut12.result()))


# ---------------------------------------------------------------------------
# End-to-end correctness: served == direct, bitwise on the same bucket
# ---------------------------------------------------------------------------
def test_served_apply_bitwise_equals_direct(n, plan):
    eng, _ = make_engine(plan, buckets=(8,))
    signals = [sig(n, 100 + i) for i in range(8)]
    futs = [eng.submit(s) for s in signals]
    direct = plan.compiled("apply")(torch.stack(signals))
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(_np(f.result()), _np(direct[i]))


def test_served_solve_bitwise_equals_direct(n, plan):
    eng, _ = make_engine(plan, buckets=(4,))
    signals = [sig(n, 200 + i) for i in range(4)]
    futs = [eng.submit(s, kind="solve", method="jacobi", tau=0.5,
                       n_iters=6) for s in signals]
    direct = plan.compiled_solve("jacobi", tau=0.5, n_iters=6)(
        torch.stack(signals))
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(_np(f.result()), _np(direct[i]))


def test_adjoint_requests_roundtrip(n, plan):
    eng, _ = make_engine(plan, buckets=(2,))
    a = torch.from_numpy(np.random.RandomState(7).standard_normal(
        (2, plan.eta, n)).astype(np.float32))
    futs = [eng.submit(a[0], kind="apply_adjoint"),
            eng.submit(a[1], kind="apply_adjoint")]
    direct = plan.compiled("apply_adjoint")(a)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(_np(f.result()), _np(direct[i]))


# ---------------------------------------------------------------------------
# Admission validation + driver contracts
# ---------------------------------------------------------------------------
def test_admission_rejects_malformed(n, plan):
    eng, _ = make_engine(plan)
    f = sig(n, 0)
    with pytest.raises(ValueError, match="unknown kind"):
        eng.submit(f, kind="nope")
    with pytest.raises(ValueError, match="requires method"):
        eng.submit(f, kind="solve")
    with pytest.raises(ValueError, match="no method"):
        eng.submit(f, method="jacobi")
    with pytest.raises(ValueError, match="history"):
        eng.submit(f, kind="solve", method="jacobi", tau=0.5, history=True)
    with pytest.raises(ValueError, match="batch axis"):
        eng.submit(torch.stack([f, f]))
    with pytest.raises(ValueError, match="plan expects"):
        eng.submit(f[:-1])
    with pytest.raises(KeyError, match="unknown operator"):
        eng.submit(f, op="nope")
    assert eng.pending_count == 0


def test_run_until_idle_needs_virtual_clock(plan):
    eng = ServeEngine(plan, clock=WallClock())
    with pytest.raises(TypeError, match="advance_to"):
        eng.run_until_idle()


def test_summary_schema(n, plan):
    eng, _ = make_engine(plan)
    replay_virtual(eng, poisson_arrivals(rate=900.0, n_requests=30, seed=2),
                   n=n)
    s = eng.metrics.summary()
    assert s["n_submitted"] == s["n_served"] == 30
    assert s["served_exactly_once"]
    assert np.isfinite(s["latency_ms"]["p99"])
    assert s["latency_ms"]["p50"] <= s["latency_ms"]["p99"]
    assert s["queue_delay_ms"]["max"] <= MAX_WAIT * 1e3 + 1e-9
    assert s["signals_per_sec"] > 0
    assert s["mean_batch_occupancy"] >= 1.0
    assert 0.0 <= s["padding_waste"] < 1.0


# ---------------------------------------------------------------------------
# Hardening: dispatch-failure containment, deadlines, bounded queue, retry
# ---------------------------------------------------------------------------
def test_dispatch_failure_fails_only_that_batch(n, plan, monkeypatch):
    """A poisoned entry fails exactly its batch: every rider gets a
    ``dispatch:`` error Response and the engine keeps serving."""
    eng, _ = make_engine(plan, buckets=(1, 4))
    orig = eng._callable
    armed = {"on": True}

    def poisoned(key, group):
        if armed["on"]:
            def bad(batch):
                raise RuntimeError("poisoned kernel")
            return bad
        return orig(key, group)

    monkeypatch.setattr(eng, "_callable", poisoned)
    bad_futs = [eng.submit(sig(n, i)) for i in range(4)]
    for fut in bad_futs:
        assert fut.done() and not fut.response.ok
        assert fut.response.error.startswith("dispatch: RuntimeError")
        assert fut.response.value is None
        with pytest.raises(RequestFailed, match="poisoned"):
            fut.result()
    armed["on"] = False
    good_futs = [eng.submit(sig(n, i + 10)) for i in range(4)]
    for i, fut in enumerate(good_futs):
        want = _np(plan.apply(sig(n, i + 10)))
        np.testing.assert_allclose(_np(fut.result()), want, rtol=1e-5,
                                   atol=1e-5)
    s = eng.metrics.summary()
    assert s["n_failed"] == 4 and s["n_served"] == 4
    assert s["served_exactly_once"] and eng.pending_count == 0


def test_deadline_expires_queued_request(n, plan):
    eng, clock = make_engine(plan, buckets=(4,), max_wait=0.05)
    doomed = eng.submit(sig(n, 0), deadline=0.002)
    alive = eng.submit(sig(n, 1))
    clock.advance(0.003)
    eng.poll()
    assert doomed.done() and doomed.response.error.startswith("expired:")
    assert not alive.done()
    eng.run_until_idle()
    np.testing.assert_allclose(_np(alive.result()),
                               _np(plan.apply(sig(n, 1))), rtol=1e-5,
                               atol=1e-5)
    s = eng.metrics.summary()
    assert s["n_expired"] == 1 and s["n_served"] == 1
    assert s["served_exactly_once"]
    with pytest.raises(ValueError, match="deadline"):
        eng.submit(sig(n, 2), deadline=-0.1)


def test_deadline_expiry_at_dispatch_time(n, plan):
    eng, clock = make_engine(plan, buckets=(2,), max_wait=0.05)
    doomed = eng.submit(sig(n, 0), deadline=0.001)
    clock.advance(0.002)
    live = eng.submit(sig(n, 1))
    eng.run_until_idle()
    assert doomed.response.error.startswith("expired:")
    assert live.response.ok
    assert eng.metrics.summary()["served_exactly_once"]


def test_bounded_queue_rejects_at_admission(n, plan):
    eng, _ = make_engine(plan, buckets=(8,), max_wait=0.05)
    eng.max_queue_depth = 2
    admitted = [eng.submit(sig(n, i)) for i in range(2)]
    bounced = eng.submit(sig(n, 9))
    assert bounced.done() and bounced.response.rejected
    assert "max_queue_depth=2" in bounced.response.error
    assert eng.pending_count == 2
    eng.run_until_idle()
    assert all(f.response.ok for f in admitted)
    s = eng.metrics.summary()
    assert s["n_rejected"] == 1 and s["n_served"] == 2
    assert s["n_submitted"] == 2
    assert s["served_exactly_once"]
    with pytest.raises(ValueError, match="max_queue_depth"):
        ServeEngine(plan, clock=VirtualClock(), max_queue_depth=0)


def test_retry_policy_absorbs_queue_full_windows(n, plan):
    clock = VirtualClock()
    eng = ServeEngine(plan, buckets=(1, 4), max_wait=0.001, clock=clock,
                      sync_results=False, max_queue_depth=2)
    events = burst_arrivals(n_bursts=2, burst_size=6, period=0.05, seed=0,
                            mix=((1.0, "apply", None, {}),))
    futs = replay_virtual(eng, events, n=n,
                          retry=RetryPolicy(max_retries=4, backoff=0.002))
    assert set(futs) == set(range(len(events)))
    assert all(f.response.ok for f in futs.values())
    s = eng.metrics.summary()
    assert s["n_rejected"] > 0
    assert s["n_served"] == len(events)
    assert s["served_exactly_once"]
    assert RetryPolicy().delay(2) == pytest.approx(0.002 * 4.0)


# ---------------------------------------------------------------------------
# The serving properties of tests/test_property.py
# ---------------------------------------------------------------------------
_REQUEST_SPECS = (
    dict(kind="apply"),
    dict(kind="apply_gram"),
    dict(kind="solve", method="jacobi", tau=0.3, n_iters=3),
    dict(kind="solve", method="jacobi", tau=0.7, n_iters=5),
    dict(kind="solve", method="chebyshev", tau=0.5, n_iters=4),
)
_PROP = {}


def _prop_plan():
    """A module-lazy (n, plan) for the property tests: the port's cuda
    plan (device="cpu") on tests/test_property.py's n = 40 graph."""
    if not _PROP:
        import jax

        from repro.core import graph as jgraph

        g, _ = jgraph.connected_sensor_graph(jax.random.PRNGKey(5), n=40,
                                             theta=0.3, kappa=0.45)
        lmax = g.lambda_max_bound()
        op = GraphOperator(P=torch.from_numpy(np.array(g.laplacian())),
                           multipliers=twav.sgwt_multipliers(lmax, J=2),
                           lmax=lmax, K=5)
        _PROP["n"] = g.n_vertices
        _PROP["plan"] = op.plan("cuda", device="cpu")
    return _PROP["n"], _PROP["plan"]


def _direct(plan, spec, signal):
    if spec["kind"] == "solve":
        kw = {k: v for k, v in spec.items() if k not in ("kind", "method")}
        return plan.solve(signal, spec["method"], **kw).x
    return getattr(plan, spec["kind"])(signal)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000), n_rows=st.integers(1, 8),
       headroom=st.integers(0, 4))
def test_pack_unpack_lossless_roundtrip(seed, n_rows, headroom):
    """unpack(pack(rows, bucket)) returns the rows BITWISE."""
    rng = np.random.RandomState(seed)
    rows = [rng.standard_normal(7).astype(np.float32)
            for _ in range(n_rows)]
    bucket = n_rows + headroom
    batch, n_valid = pack_batch(rows, bucket)
    assert tuple(batch.shape) == (bucket, 7) and n_valid == n_rows
    back = unpack_batch(batch, n_valid)
    for orig, row in zip(rows, back):
        assert np.array_equal(_np(row), orig)
    assert not np.any(_np(batch)[n_rows:])


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 500), order=st.permutations(list(range(8))))
def test_serving_random_mix_routes_every_response(seed, order):
    """Seeded random request mixes: every future resolves with ITS
    request's answer, exactly once, under any arrival permutation."""
    n, plan = _prop_plan()
    rng = np.random.RandomState(seed)
    specs = [_REQUEST_SPECS[rng.randint(len(_REQUEST_SPECS))]
             for _ in range(len(order))]
    signals = [rng.standard_normal(n).astype(np.float32)
               for _ in range(len(order))]
    eng = ServeEngine(plan, buckets=(1, 2, 8), max_wait=0.004,
                      clock=VirtualClock(), sync_results=False)
    futs = {}
    for i in order:
        eng.clock.advance(float(rng.uniform(0.0, 0.003)))
        eng.poll()
        futs[i] = eng.submit(signals[i], **specs[i])
    eng.run_until_idle()
    s = eng.metrics.summary()
    assert s["served_exactly_once"] and s["n_served"] == len(order)
    assert len({f.response.id for f in futs.values()}) == len(order)
    for i, fut in futs.items():
        want = _np(_direct(plan, specs[i], torch.from_numpy(signals[i])))
        np.testing.assert_allclose(_np(fut.result()), want, rtol=1e-5,
                                   atol=1e-5)
        assert fut.response.key.kind == specs[i]["kind"]
        assert fut.response.key.method == specs[i].get("method")


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 200), n_req=st.integers(1, 12))
def test_serving_batch_partition_covers_requests(seed, n_req):
    """The dispatched batches partition the admitted requests."""
    n, plan = _prop_plan()
    rng = np.random.RandomState(seed)
    eng = ServeEngine(plan, buckets=(1, 4), max_wait=0.002,
                      clock=VirtualClock(), sync_results=False)
    for _ in range(n_req):
        eng.clock.advance(float(rng.uniform(0.0, 0.004)))
        eng.poll()
        eng.submit(rng.standard_normal(n).astype(np.float32))
    eng.run_until_idle()
    batches = eng.metrics.batches
    assert sum(b.occupancy for b in batches) == n_req
    assert all(b.bucket in (1, 4) for b in batches)
    assert all(0 <= b.padding < b.bucket for b in batches)
    assert eng.pending_count == 0


# ---------------------------------------------------------------------------
# Parity with the JAX engine
# ---------------------------------------------------------------------------
def test_all_is_reference():
    from repro import serve as jserve

    assert tserve.__all__ == jserve.__all__
    assert tserve.DEFAULT_BUCKETS == jserve.DEFAULT_BUCKETS == (1, 8, 64)
    assert tuple(DEFAULT_MIX) == tuple(jserve.loadgen.DEFAULT_MIX)


STREAMS = {
    "poisson": dict(fn="poisson_arrivals", kw=dict(rate=700.0,
                                                   n_requests=80, seed=11)),
    "burst": dict(fn="burst_arrivals", kw=dict(n_bursts=3, burst_size=11,
                                               period=0.004, seed=5)),
}


def _stream(mod, name):
    spec = STREAMS[name]
    return getattr(mod, spec["fn"])(**spec["kw"])


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_loadgen_streams_equal_reference(name, n):
    from repro import serve as jserve

    jev, tev = _stream(jserve, name), _stream(tserve, name)
    assert [dataclasses.astuple(e) for e in tev] == \
        [dataclasses.astuple(e) for e in jev]
    for je, te in zip(jev[:5], tev[:5]):
        assert np.array_equal(signal_for(te, n),
                              jserve.signal_for(je, n))


def _records(eng):
    return [(b.key.label(), b.bucket, b.occupancy, b.t_dispatch,
             b.t_complete) for b in eng.metrics.batches]


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_replay_parity_with_jax_engine(op48, name, backend):
    """The same stream (DEFAULT_MIX: 80% apply, 20% Jacobi solves) through
    the JAX engine over the JAX dense plan and through the port's engine
    over the port's plan: identical schedule, identical summary, values
    within 1e-5."""
    from repro import serve as jserve

    n, jop, top = op48
    buckets = (1, 4, 8)
    jeng = jserve.ServeEngine(jop.plan("dense"), buckets=buckets,
                              max_wait=MAX_WAIT,
                              clock=jserve.VirtualClock(),
                              sync_results=False)
    teng, _ = make_engine(top.plan(backend, device="cpu"), buckets=buckets)
    jfut = jserve.replay_virtual(jeng, _stream(jserve, name), n=n)
    tfut = replay_virtual(teng, _stream(tserve, name), n=n)
    assert _records(teng) == _records(jeng)
    assert teng.metrics.summary() == jeng.metrics.summary()
    assert teng.metrics.per_key_counts() == jeng.metrics.per_key_counts()
    assert set(tfut) == set(jfut)
    worst = 0.0
    for i, jf in jfut.items():
        want = np.asarray(jf.result())
        got = _np(tfut[i].result())
        assert got.shape == want.shape and got.dtype == np.float32
        worst = max(worst, float(np.abs(got - want).max()
                                 / max(np.abs(want).max(), 1e-30)))
    assert worst <= TOL_JAX, worst


def _banded_operator_P(n, bw, seed=0):
    """benchmarks/bench_comm.py:128 `_banded_operator` (a numpy copy)."""
    rng = np.random.default_rng(seed)
    B = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        B[i, lo:hi] = rng.standard_normal(hi - lo) * 0.1
    B = np.abs(B + B.T) / 2
    L = np.diag(B.sum(1)) - B
    return L, float(2 * B.sum(1).max())


def _serving_leg(serve, plan, n, n_requests=200, rate=2000.0,
                 deadline=0.05, max_queue_depth=32, straggle_every=5,
                 straggle_s=0.06, seed=0):
    """benchmarks/bench_faults.py:128 `serving_leg`, over either package's
    serve module and plan: clean vs straggler-injected virtual replay."""
    events = serve.poisson_arrivals(rate=rate, n_requests=n_requests,
                                    seed=seed)
    out = {}
    for label, straggle in (("clean", False), ("stragglers", True)):
        eng = serve.ServeEngine(plan, buckets=(1, 8, 32), max_wait=0.002,
                                clock=serve.VirtualClock(),
                                sync_results=False,
                                max_queue_depth=max_queue_depth)
        if straggle:
            orig, count = eng._callable, {"i": 0}

            def straggling(key, group, _orig=orig, _count=count,
                           _clock=eng.clock):
                fn = _orig(key, group)

                def wrapped(batch):
                    _count["i"] += 1
                    if _count["i"] % straggle_every == 0:
                        _clock.advance(straggle_s)
                    return fn(batch)

                return wrapped

            eng._callable = straggling
        futures = serve.replay_virtual(eng, events, n=n, deadline=deadline,
                                       retry=serve.RetryPolicy())
        s = eng.metrics.summary()
        out[label] = {
            "n_events": len(events),
            "all_futures_answered": all(f.done() for f in futures.values()),
            "p99_latency_ms": s["latency_ms"]["p99"],
            "goodput_signals_per_sec": s["signals_per_sec"],
            "n_served": s["n_served"], "n_failed": s["n_failed"],
            "n_expired": s["n_expired"], "n_rejected": s["n_rejected"],
            "served_exactly_once": s["served_exactly_once"],
            "summary": s,
        }
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_straggler_leg_equals_reference(backend):
    """bench_faults' serving leg (n = 256, half-band 8, K = 10): exactly
    once under stragglers, straggler goodput no higher than clean, and the
    reference engine's summaries (and the tracked BENCH_faults.json's)."""
    import jax.numpy as jnp

    from repro import serve as jserve
    from repro.dist import GraphOperator as JOp

    n, bw, K = 256, 8, 10
    L, lmax = _banded_operator_P(n, bw)
    jplan = JOp(P=jnp.asarray(L), multipliers=[lambda lam: jnp.exp(-lam)],
                lmax=lmax, K=K).plan("dense")
    tplan = GraphOperator(P=torch.from_numpy(L),
                          multipliers=[lambda lam: np.exp(-lam)],
                          lmax=lmax, K=K).plan(backend, device="cpu")
    ref = _serving_leg(jserve, jplan, n)
    got = _serving_leg(tserve, tplan, n)
    assert got == ref
    clean, strag = got["clean"], got["stragglers"]
    assert clean["served_exactly_once"] and strag["served_exactly_once"]
    assert clean["all_futures_answered"] and strag["all_futures_answered"]
    assert strag["goodput_signals_per_sec"] <= \
        clean["goodput_signals_per_sec"] + 1e-9
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "BENCH_faults.json")) as f:
        tracked = json.load(f)["serving"]["runs"]
    for label in ("clean", "stragglers"):
        mine = {k: v for k, v in got[label].items() if k != "summary"}
        assert mine == pytest.approx(tracked[label], rel=1e-12), label


WIRE_SPECS = [dict(exchange_dtype="f32"), dict(exchange_dtype="bf16"),
              dict(exchange_dtype="int8"),
              dict(exchange_dtype="int8", error_feedback=True),
              dict(fault_spec=dict(drop_prob=0.2, stale_prob=0.1,
                                   noise_prob=0.05, seed=3)),
              dict(exchange_dtype="bf16",
                   fault_spec=dict(drop_prob=0.05, seed=7),
                   degradation="hold_last")]


@pytest.mark.parametrize("spec", WIRE_SPECS, ids=lambda s: repr(s))
def test_compat_labels_equal_reference(spec):
    """On one device, the JAX `halo` plan and the port's `halo` plan under
    the same wire and fault spec give the same compat keys and labels for
    every kind, and a solve's."""
    import jax
    import jax.numpy as jnp

    from repro.dist import GraphOperator as JOp
    from repro.dist import faults as jfaults
    from repro.serve import compat_key as jkey

    n, bw, K = 64, 4, 6
    L, lmax = _banded_operator_P(n, bw)
    kw = dict(spec)
    jkw, tkw = dict(kw), dict(kw)
    if "fault_spec" in kw:
        jkw["fault_spec"] = jfaults.FaultSpec(**kw["fault_spec"])
        tkw["fault_spec"] = FaultSpec(**kw["fault_spec"])
    mesh = jax.make_mesh((1,), ("graph",))
    jplan = JOp(P=jnp.asarray(L), multipliers=[lambda lam: jnp.exp(-lam)],
                lmax=lmax, K=K).plan("halo", mesh=mesh, **jkw)
    tplan = GraphOperator(P=torch.from_numpy(L),
                          multipliers=[lambda lam: np.exp(-lam)],
                          lmax=lmax, K=K).plan("halo", device="cpu", **tkw)
    calls = [("apply", None, {}), ("apply_gram", None, {}),
             ("apply_adjoint", None, {}),
             ("solve", "jacobi", {"tau": 0.5, "n_iters": 8})]
    for kind, method, skw in calls:
        jk = jkey("default", jplan, kind, method, skw)
        tk = tserve.compat_key("default", tplan, kind, method, skw)
        assert tk.label() == jk.label()
        assert dataclasses.astuple(tk) == dataclasses.astuple(jk)
    if "fault_spec" in kw:
        assert "faults=" in tk.label()


# ---------------------------------------------------------------------------
# 8 gloo ranks: the engine realizes the batch amortization on the port
# ---------------------------------------------------------------------------
LEAD_STREAM = dict(rate=700.0, n_requests=40, seed=11)
LEAD_BUCKETS = (1, 4, 8)


class ScriptedClock:
    """A clock with ``now()`` and no ``advance_to``: the replay sets `t`.
    Over a multi-rank plan the engine then leads (rank 0) or follows."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t


def replay_scripted(engine, clock, events, n, signal_fn):
    """`replay_virtual`'s schedule under a :class:`ScriptedClock`: hop to
    each due deadline before the next arrival, submit, then drain by
    deadlines; {event index: future}.  Either package's engine."""
    def drain(until):
        due = engine.next_deadline()
        while due is not None and due <= until:
            clock.t = max(clock.t, due)
            engine.poll()
            due = engine.next_deadline()

    futures = {}
    for i, ev in enumerate(events):
        drain(ev.t)
        clock.t = max(clock.t, ev.t)
        engine.poll()
        futures[i] = engine.submit(signal_fn(ev, n), op=ev.op, kind=ev.kind,
                                   method=ev.method, **ev.kwargs())
    drain(float("inf"))
    return futures


def _direct_entry(plan, kind, method, solve_kwargs):
    if kind == "solve":
        return plan.compiled_solve(method, **solve_kwargs)
    return plan.compiled(kind)


def _leader_case(rank, plan, n, per_round):
    """The scripted-clock leader (rank 0) or a follower over `plan`; then
    every batch the leader served run again directly on every rank, its
    output and its counted exchange held against the served one."""
    eng = ServeEngine(plan, buckets=LEAD_BUCKETS, max_wait=MAX_WAIT,
                      clock=ScriptedClock(), sync_results=False)
    out = {"role": eng.role}
    if eng.role == "leader":
        saved, orig = [], eng._callable

        def recording(key, group):
            fn = orig(key, group)

            def run(batch):
                with comm.counting() as rec:
                    y = fn(batch)
                st_ = rec.stats(WORLD, batch.shape[0], per_round)
                saved.append(dict(kind=key.kind, method=group.method,
                                  solve_kwargs=group.solve_kwargs,
                                  batch=batch.clone(), out=y.clone(),
                                  rounds=st_.exchange_rounds,
                                  total_bytes=st_.total_bytes))
                return y

            return run

        eng._callable = recording
        futs = replay_scripted(eng, eng.clock,
                               poisson_arrivals(**LEAD_STREAM), n,
                               signal_for)
        eng.close()
        try:
            eng.follow()
        except RuntimeError as exc:
            out["leader_follow"] = str(exc)
        try:
            eng.run_until_idle()
        except TypeError as exc:
            out["leader_run_until_idle"] = str(exc)
        out.update(records=_records(eng), summary=eng.metrics.summary(),
                   n_batches=len(eng.metrics.batches),
                   n_broadcasts=eng.n_broadcasts,
                   values={i: f.result() for i, f in futs.items()})
        calls = [{k: v for k, v in d.items() if k != "out"} for d in saved]
    else:
        with comm.counting() as rec:
            out["followed"] = eng.follow()
        out["follower_rounds"] = rec.stats(WORLD, 1,
                                           per_round).exchange_rounds
        calls = None
    box = [calls]
    dist.broadcast_object_list(box, src=0)
    bitwise, counts = [], []
    for i, d in enumerate(box[0]):
        fn = _direct_entry(plan, d["kind"], d["method"], d["solve_kwargs"])
        with comm.counting() as rec:
            y = fn(d["batch"])
        st_ = rec.stats(WORLD, d["batch"].shape[0], per_round)
        if rank == 0:
            s = saved[i]
            bitwise.append(bool(torch.equal(y, s["out"])))
            counts.append((d["kind"], d["batch"].shape[0], s["rounds"],
                           st_.exchange_rounds, s["total_bytes"],
                           st_.total_bytes))
    out.update(bitwise=bitwise, counts=counts,
               served_rounds=sum(c[2] for c in counts))
    return out


def _wall_case(rank, plan, x):
    """A WallClock leader serving B_SHARD submits (one batch-full
    dispatch) while the followers follow; a follower's submit, poll and
    flush raise."""
    eng = ServeEngine(plan, buckets=(1, B_SHARD), max_wait=MAX_WAIT,
                      clock=WallClock())
    if eng.role == "follower":
        refused = []
        for call in (lambda: eng.submit(x[0]), eng.poll, eng.flush):
            try:
                call()
                refused.append("no error")
            except RuntimeError as exc:
                refused.append(str(exc))
        return {"role": eng.role, "followed": eng.follow(),
                "refused": refused}
    futs = [eng.submit(s) for s in x]
    eng.close()
    s_ = eng.metrics.summary()
    return {"role": eng.role, "n_served": s_["n_served"],
            "exactly_once": s_["served_exactly_once"],
            "all_ok": all(f.response.ok for f in futs),
            "batches": [(b.bucket, b.occupancy)
                        for b in eng.metrics.batches]}


def _rank_serving(rank, setup):
    """One rank: virtual-clock (lockstep) engines over cuda_halo and halo,
    then the leader-and-followers engines under clocks without
    advance_to, and the refusals."""
    from repro_torch.serve import compat_key

    lmax, K = setup["lmax"], K_SHARD
    op = GraphOperator(P=torch.from_numpy(setup["L"]),
                       multipliers=twav.sgwt_multipliers(lmax, J=2),
                       lmax=lmax, K=K)
    x = torch.from_numpy(setup["x"])
    n = x.shape[1]
    out, values = {}, {}
    for backend in ("cuda_halo", "halo"):
        plan = op.plan(backend, device="cpu")
        eng = ServeEngine(plan, buckets=(1, B_SHARD), max_wait=MAX_WAIT,
                          clock=VirtualClock(), sync_results=False)
        per_round = plan.info.get("exchange_collectives_per_round",
                                  comm.DIRECTIONS_PER_ROUND)
        with comm.counting() as rec:
            futs = [eng.submit(s) for s in x]
        st_ = rec.stats(WORLD, B_SHARD, per_round)
        direct = plan.compiled("apply")(x)
        rows = [f.result() for f in futs]
        wall = _wall_case(rank, plan, x)
        faulty = op.plan(backend, device="cpu", fault_spec=FaultSpec(
            drop_prob=0.2, stale_prob=0.1, noise_prob=0.05, seed=3))
        both = ServeEngine({"clean": plan, "faulty": faulty},
                           buckets=(1, 4), max_wait=MAX_WAIT,
                           clock=VirtualClock(), sync_results=False)
        mixed = [both.submit(s, op=("clean", "faulty")[i % 2])
                 for i, s in enumerate(x[:8])]
        both.run_until_idle()
        lead = _leader_case(rank, plan, n, per_round)
        values[backend] = lead.pop("values", None)
        out[backend] = {
            "role": eng.role,
            "all_done": all(f.done() for f in futs),
            "batches": [(b.bucket, b.occupancy) for b in eng.metrics.batches],
            "rounds": st_.exchange_rounds,
            "total_bytes": st_.total_bytes,
            "bytes_b1": plan.info["halo_bytes_per_apply"],
            "bitwise": all(torch.equal(r, direct[i])
                           for i, r in enumerate(rows)),
            "err": float(np.abs(torch.stack(rows).numpy()
                                - setup["ref"]).max()),
            "wall": wall,
            "lead": lead,
            "mixed_batches": [(b.key.label(), b.occupancy)
                              for b in both.metrics.batches],
            "mixed_ok": all(f.response.ok for f in mixed),
            "fault_label": compat_key("faulty", faulty, "apply",
                                      None).label(),
        }
    # two plans over two groups (the same ranks) cannot share an engine
    other = dist.new_group(list(range(WORLD)))
    try:
        ServeEngine({"a": op.plan("halo", device="cpu"),
                     "b": op.plan("halo", device="cpu", mesh=other)},
                    clock=VirtualClock())
        out["two_groups"] = "no error"
    except ValueError as exc:
        out["two_groups"] = str(exc)
    return out, values


def _serve_worker(rank, world, tmp, setup):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        out, values = _rank_serving(rank, setup)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if rank == 0:
        torch.save(values, os.path.join(tmp, "values.pt"))


def _jax_leader_reference(jop, n):
    """The JAX engine over the JAX dense plan under the scripted clock and
    the leader's stream: batch records, summary, served values."""
    from repro import serve as jserve

    eng = jserve.ServeEngine(jop.plan("dense"), buckets=LEAD_BUCKETS,
                             max_wait=MAX_WAIT, clock=ScriptedClock(),
                             sync_results=False)
    futs = replay_scripted(eng, eng.clock,
                           jserve.poisson_arrivals(**LEAD_STREAM), n,
                           jserve.signal_for)
    return {"records": _records(eng), "summary": eng.metrics.summary(),
            "values": {i: np.asarray(f.result()) for i, f in futs.items()}}


@pytest.fixture(scope="module")
def serve_ranks(sensor_banded, tmp_path_factory):
    """The banded n = 600 sensor graph of tests/test_serving.py's payload
    (J = 2, K = 10), B = 32 signals and the JAX dense plan's outputs; one
    spawn of 8 gloo ranks; every rank's record, rank 0's served values of
    the leader's stream, and the JAX engine's run of that stream."""
    import jax.numpy as jnp
    import torch.multiprocessing as mp

    from repro.core import wavelets as jwav
    from repro.dist import GraphOperator as JOp

    lmax = sensor_banded.lambda_max_bound()
    L = np.asarray(sensor_banded.laplacian())
    x = np.random.RandomState(100).standard_normal(
        (B_SHARD, L.shape[0])).astype(np.float32)
    jop = JOp(P=jnp.asarray(L), multipliers=jwav.sgwt_multipliers(lmax, J=2),
              lmax=lmax, K=K_SHARD)
    setup = {"L": L, "lmax": float(lmax), "x": x,
             "ref": np.asarray(jop.plan("dense").apply(jnp.asarray(x)))}
    tmp = tmp_path_factory.mktemp("serve8")
    mp.spawn(_serve_worker, args=(WORLD, str(tmp), setup), nprocs=WORLD,
             join=True)
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            out.append(json.load(f))
    return {"ranks": out, "values": torch.load(tmp / "values.pt"),
            "jax": _jax_leader_reference(jop, L.shape[0])}


@pytest.mark.parametrize("backend", ["cuda_halo", "halo"])
def test_engine_coalesces_to_one_batch_traffic_8shards(serve_ranks,
                                                       backend):
    """B requests served by each rank's engine ride one (B, N) call whose
    counted exchange is K rounds and the plan's byte model at B — one
    B-batch's 2K|E|, not B of them — bit for bit the direct call.  Under
    a wall clock the same plan is served by rank 0 alone, the other
    ranks following: B submits, one batch, each answered once."""
    for rank, rec in enumerate(serve_ranks["ranks"]):
        r = rec[backend]
        assert r["role"] == "lockstep", rank
        assert r["all_done"], rank
        assert r["batches"] == [[B_SHARD, B_SHARD]], (rank, r["batches"])
        assert r["rounds"] == K_SHARD, (rank, r["rounds"])
        assert r["total_bytes"] == B_SHARD * r["bytes_b1"], rank
        assert r["bitwise"], rank
        assert r["err"] <= TOL_DENSE, (rank, r["err"])
        wall = r["wall"]
        if rank == 0:
            assert wall["role"] == "leader"
            assert wall["n_served"] == B_SHARD and wall["exactly_once"]
            assert wall["all_ok"]
            assert wall["batches"] == [[B_SHARD, B_SHARD]]
        else:
            assert wall["role"] == "follower", rank
            assert wall["followed"] == 1, (rank, wall)


@pytest.mark.parametrize("backend", ["cuda_halo", "halo"])
def test_faulted_plan_never_coalesces_8shards(serve_ranks, backend):
    """A plan under FaultSpec(0.2, 0.1, 0.05, seed=3) registered beside
    the clean one: separate batches, labels carrying the fault key, the
    same on every rank."""
    recs = [rec[backend] for rec in serve_ranks["ranks"]]
    for r in recs:
        assert r["mixed_ok"]
        labels = {label for label, _ in r["mixed_batches"]}
        assert labels == {f"clean:apply:order={K_SHARD}",
                          r["fault_label"]}
        assert "faults=" in r["fault_label"]
        assert sum(occ for _, occ in r["mixed_batches"]) == 8
        assert r["mixed_batches"] == recs[0]["mixed_batches"]


@pytest.mark.parametrize("backend", ["cuda_halo", "halo"])
def test_leader_schedule_equals_jax_engine_8shards(serve_ranks, backend):
    """Under a clock without advance_to, rank 0 leads a seeded Poisson
    stream (DEFAULT_MIX) over the sharded plan: its batch records and
    summary are the JAX engine's over the JAX dense plan under the same
    clock and stream, and every batch was broadcast once."""
    jref = serve_ranks["jax"]
    lead = serve_ranks["ranks"][0][backend]["lead"]
    assert lead["role"] == "leader"
    assert [tuple(r) for r in lead["records"]] == jref["records"]
    assert lead["summary"] == jref["summary"]
    assert lead["summary"]["served_exactly_once"]
    assert lead["n_broadcasts"] == lead["n_batches"] == len(jref["records"])
    assert "follow" in lead["leader_follow"]
    assert "advance_to" in lead["leader_run_until_idle"]


@pytest.mark.parametrize("backend", ["cuda_halo", "halo"])
def test_leader_rows_bitwise_and_counted_8shards(serve_ranks, backend):
    """Every batch the leader served equals the rank's direct call of the
    same entry on the same packed batch, bit for bit, and counted the
    same exchange: K rounds and the byte model for an apply.  Served
    values are within 1e-4 of the JAX dense plan's.  Every follower's
    follow() returns the leader's batch count and ran its rounds."""
    ranks = serve_ranks["ranks"]
    lead = ranks[0][backend]["lead"]
    bytes_b1 = ranks[0][backend]["bytes_b1"]
    assert lead["bitwise"] and all(lead["bitwise"])
    for kind, bucket, served, direct, sb, db in lead["counts"]:
        assert served == direct and sb == db, (kind, bucket)
        if kind == "apply":
            assert served == K_SHARD and sb == bucket * bytes_b1
    for rank in range(1, WORLD):
        f = ranks[rank][backend]["lead"]
        assert f["role"] == "follower", rank
        assert f["followed"] == lead["n_batches"], (rank, f["followed"])
        assert f["follower_rounds"] == lead["served_rounds"], rank
    got = serve_ranks["values"][backend]
    want = serve_ranks["jax"]["values"]
    assert set(got) == set(want)
    err = max(float(np.abs(got[i].numpy() - want[i]).max()) for i in want)
    assert err <= TOL_DENSE, err


def test_follower_refuses_and_groups_must_match_8shards(serve_ranks):
    """A follower's submit, poll and flush raise (rank 0 serves), and an
    engine over plans of two process groups raises at construction."""
    for rank, rec in enumerate(serve_ranks["ranks"]):
        assert "share one process group" in rec["two_groups"], rank
        if rank == 0:
            continue
        for backend in ("cuda_halo", "halo"):
            refused = rec[backend]["wall"]["refused"]
            assert len(refused) == 3
            assert all("rank 0 serves" in m for m in refused), refused
