"""The port's spans and counters (`repro_torch.obs`): spans nest with
their parents; the plan's packing, the entry's capture and the solver's
set-up are always recorded, an entry call and its replay, with the
counters, only while a `torch.profiler` session records.

The last test needs the card (marker `gpu`): a captured entry called
under the harness's CUDA-only profiler, each ``entry.replay`` span
holding exactly one ``cudaGraphLaunch`` of the trace on the shared clock.
This file imports no JAX, so it runs on the card as well:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_obs.py
"""
import json
import tempfile
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.core import filters as tfilters
from repro_torch.core import graph as tgraph
from repro_torch.core import wavelets as twav
from repro_torch.dist import GraphOperator
from repro_torch.dist.capture import PlanEntry

N = 120


@pytest.fixture(autouse=True)
def clean():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module")
def graph():
    return tgraph.connected_sensor_graph(np.random.RandomState(2), n=N,
                                         theta=0.2, kappa=0.25)


def _sgwt(graph):
    lmax = graph.lambda_max_bound()
    return GraphOperator(P=graph.laplacian(),
                         multipliers=twav.sgwt_multipliers(lmax, J=2),
                         lmax=lmax, K=8)


def _tikhonov(graph):
    g = tfilters.ssl_multiplier(tfilters.power_kernel(1), 0.5)
    return GraphOperator(P=graph.laplacian(), multipliers=[g],
                         lmax=graph.lambda_max_bound(), K=8)


def _exported(prof) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def _recording() -> bool:
    """Whether a profiler records: the flag the entries read."""
    return autograd_profiler._is_profiler_enabled


def _signals(B=3):
    return torch.from_numpy(
        np.random.RandomState(5).randn(B, N).astype(np.float32))


def test_spans_nest_with_parents():
    with obs.span("outer") as ia:
        with obs.span("inner") as ib:
            with obs.span("deep") as ic:
                pass
        opened = obs.begin("open")
        assert [s.name for s in obs.spans()] == ["inner", "deep"]
        obs.end(opened)
    with obs.span("loose") as d:
        pass
    with obs.span("next") as e:
        pass
    a, b, c, opened, d, e = (obs.get(i)
                             for i in (ia, ib, ic, opened, d, e))
    assert (a.parent, b.parent, c.parent) == (None, ia, ib)
    assert opened.parent == ia
    assert d.parent is None and e.parent is None
    assert obs.get(b.parent) == a
    assert [s.name for s in obs.spans()] == ["outer", "inner", "deep",
                                             "open", "loose", "next"]
    assert obs.spans("inner") == [b]
    for s in obs.spans():
        assert 0 <= s.start_ns <= s.end_ns
        assert s.seconds == (s.end_ns - s.start_ns) * 1e-9
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= a.end_ns


def test_span_closes_on_an_error_and_counters_add():
    with pytest.raises(RuntimeError):
        with obs.span("failing"):
            raise RuntimeError("boom")
    with obs.span("after") as s:
        pass
    assert obs.get(s).parent is None and len(obs.spans("failing")) == 1
    obs.add("x")
    obs.add("x", 4)
    obs.add("y", 2)
    assert obs.counters() == {"x": 5, "y": 2}
    got = obs.counters()
    got["x"] = 0
    assert obs.counters()["x"] == 5
    obs.reset()
    assert obs.counters() == {} and obs.spans() == []


def test_end_drops_spans_left_open_inside():
    """An error between a `begin` and its `end` leaves a span open inside
    the one closed next: it stays unclosed and is no later span's
    parent."""
    outer = obs.begin("outer")
    obs.begin("left_open")
    obs.end(outer)
    with obs.span("after") as s:
        pass
    assert obs.get(s).parent is None
    assert [x.name for x in obs.spans()] == ["outer", "after"]


def test_spans_land_in_the_trace_by_its_base_time():
    """A profiler's event inside a span lies inside the span mapped into
    the exported trace by its ``baseTimeNanoseconds``."""
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert _recording()
        outer = []
        for i in range(3):
            with obs.span("probe") as s:
                with record_function(f"obs_probe_{i}"):
                    x @ x
            outer.append(obs.get(s))
            time.sleep(0.001)
    assert not _recording()
    trace = _exported(prof)
    base = int(trace["baseTimeNanoseconds"])
    evs = {e["name"]: e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e["name"].startswith("obs_probe_")}
    for i, s in enumerate(outer):
        t0, t1 = obs.trace_us(s, base)
        e = evs[f"obs_probe_{i}"]
        assert t0 - 50 <= e["ts"] and e["ts"] + e["dur"] <= t1 + 50


def test_eager_entry_records_no_call_span_without_a_profiler(graph):
    entry = _sgwt(graph).plan("cuda", device="cpu").compiled("apply")
    assert entry.mode == "eager" and not _recording()
    for _ in range(3):
        entry(_signals())
    assert obs.spans("entry.call") == []
    assert len(obs.spans("entry.capture")) == 1
    assert obs.counters() == {}


def test_eager_entry_records_one_call_span_per_call_under_a_profiler(graph):
    entry = _sgwt(graph).plan("cuda", device="cpu").compiled("apply")
    x = _signals()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            entry(x)
    entry(x)
    calls = obs.spans("entry.call")
    assert len(calls) == 4
    (cap,) = obs.spans("entry.capture")
    assert obs.get(cap.parent) == calls[0]
    # eager entries launch no graph
    assert obs.spans("entry.replay") == []


def test_plan_cuda_records_one_pack_span(graph):
    op = _sgwt(graph)
    op.plan("dense", device="cpu")
    assert obs.spans("plan.pack") == []
    t0 = time.time_ns()
    plan = op.plan("cuda", device="cpu")
    t1 = time.time_ns()
    (pack,) = obs.spans("plan.pack")
    assert t0 <= pack.start_ns <= pack.end_ns <= t1
    assert pack.parent is None
    assert plan.info["block_ell"].sliced is not None


def test_jacobi_solver_setup_spans_once_per_operator(graph):
    op = _tikhonov(graph)
    entry = op.plan("cuda", device="cpu").compiled_solve(
        "jacobi", tau=0.5, n_iters=6)
    y = _signals()
    entry(y)
    entry(y)
    setups = obs.spans("solver.setup")
    (cap,) = obs.spans("entry.capture")
    # diag(den(P)), inv(D) and the sweep's weight table: three misses of
    # the operator's memo, all inside the capture
    assert len(setups) == 3
    assert all(obs.get(s.parent) == cap for s in setups)
    assert sum(s.seconds for s in setups) <= cap.seconds
    # a second entry of the same operator finds the memo filled
    other = op.plan("cuda", device="cpu").compiled_solve(
        "jacobi", tau=0.5, n_iters=6)
    other(y)
    assert len(obs.spans("entry.capture")) == 2
    assert len(obs.spans("solver.setup")) == 3
    # a plain solve after the capture (the benchmark's check of D^-1 at
    # one round) misses the memo outside every capture
    op.plan("cuda", device="cpu").solve(y, "jacobi", tau=0.5, n_iters=1)
    (late,) = obs.spans("solver.setup")[3:]
    assert late.parent is None
    # an SGWT apply runs no solver
    obs.reset()
    _sgwt(graph).plan("cuda", device="cpu").compiled("apply")(y)
    assert obs.spans("solver.setup") == []


def test_cheb_jacobi_rho_is_solver_setup(graph):
    op = _tikhonov(graph)
    op.plan("dense", device="cpu").solve(_signals(), "cheb_jacobi", tau=0.5,
                                         n_iters=4)
    # diag(den(P)), inv(D) and rho
    assert len(obs.spans("solver.setup")) == 3
    op.plan("dense", device="cpu").solve(_signals(), "cheb_jacobi", tau=0.5,
                                         n_iters=4)
    assert len(obs.spans("solver.setup")) == 3


@pytest.mark.parametrize("kind", ["apply", "apply_adjoint", "solve"])
def test_capture_ms_is_the_capture_span(graph, kind):
    op = _tikhonov(graph) if kind == "solve" else _sgwt(graph)
    plan = op.plan("cuda", device="cpu")
    if kind == "solve":
        entry = plan.compiled_solve("jacobi", tau=0.5, n_iters=4)
        x = _signals()
    else:
        entry = plan.compiled(kind)
        x = _signals() if kind == "apply" else \
            torch.randn(3, plan.eta, N)
    entry(x)
    (cap,) = obs.spans("entry.capture")
    key = (tuple(x.shape), x.dtype)
    assert entry.capture_ms[key] == cap.seconds * 1e3
    assert entry.capture_ms[key] > 0


class _Graph:
    """Stands in for a captured CUDA graph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_graph_path_counts_replays_and_records_replay_spans():
    """The graph mode's call path with a stand-in graph: under a profiler
    each call's ``entry.replay`` span nests in its ``entry.call`` and its
    replay adds 1 and the capture's launches to the counters; outside
    one a call records nothing."""
    entry = PlanEntry(lambda x: x, "graph", "cpu", label="stub")
    x = torch.ones(2, 5)
    key = (tuple(x.shape), x.dtype)
    g, static_out = _Graph(), torch.zeros(2, 5)
    entry._graphs[key] = (g, x.clone(), static_out, 3)
    entry.replays[key] = 0
    for _ in range(2):
        entry(x)
    assert obs.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            out = entry(x)
    assert g.replays == entry.replays[key] == 7
    assert obs.counters() == {"entry.replays": 5,
                              "kernels.replayed_launches": 15}
    assert out.data_ptr() != static_out.data_ptr()
    calls, replays = obs.spans("entry.call"), obs.spans("entry.replay")
    assert len(calls) == len(replays) == 5
    for c, r in zip(calls, replays):
        assert obs.get(r.parent) == c
        assert c.start_ns <= r.start_ns <= r.end_ns <= c.end_ns


def test_one_launch_registry():
    names = [k.__name__ for k in obs.kernel_counters()]
    assert len(set(names)) == len(names) == 11
    assert set(obs.launch_counts()) == set(names)
    assert obs.launch_delta(obs.launch_counts()) == {}


@pytest.mark.gpu
def test_replays_on_the_card_count_and_hold_one_graph_launch(graph):
    """50 calls of a captured entry under the harness's CUDA-only
    profiler: the counters move by 50 x the captured launches, and each
    ``entry.replay`` span holds exactly one ``cudaGraphLaunch`` of the
    trace (to 20 us), matched by the trace's base time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the entry captures a CUDA graph")

    op = _sgwt(graph)
    entry = op.plan("cuda", device="cuda").compiled("apply")
    assert entry.mode == "graph"
    x = torch.randn(8, N, device="cuda")
    entry(x)
    torch.cuda.synchronize()
    key = (tuple(x.shape), x.dtype)
    launched = sum(entry.launches[key].values())
    assert launched >= 1
    assert obs.counters() == {}
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    assert _recording()
    for _ in range(50):
        entry(x)
    torch.cuda.synchronize()
    prof.stop()
    assert obs.counters() == {"entry.replays": 50,
                              "kernels.replayed_launches": 50 * launched}
    trace = _exported(prof)
    base = int(trace["baseTimeNanoseconds"])
    launches = sorted(float(e["ts"]) for e in trace["traceEvents"]
                      if e.get("ph") == "X"
                      and e.get("name") == "cudaGraphLaunch")
    replays = obs.spans("entry.replay")
    assert len(replays) == 50
    for s in replays:
        t0, t1 = obs.trace_us(s, base)
        inside = [t for t in launches if t0 - 20 <= t <= t1 + 20]
        assert len(inside) == 1, (t0, t1, inside)
