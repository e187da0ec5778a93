"""The readers of the program's own spans and counters
(`repro_torch.obs`) on a stub context and a seeded span state: each
reads what it is for, and nothing where its span or counter is absent,
where the window's calls and the spans disagree, without a device trace,
or where the program has no `obs` module (a checkout before it)."""
import sys
from pathlib import Path

import pytest

from portbench import cells, devtrace, harness
from repro_torch import obs

METRICS = Path(__file__).resolve().parents[1] / "metrics"
NAMES = ("plan.pack_s", "entry.solver_setup_s", "entry.replay_ms_per_call",
         "dispatch.glue_ops_per_call")


def _readers():
    return {n: cells.load_module(METRICS / f"{n}.py", "metric") for n in NAMES}


def _ctx(calls=3, summary=True):
    s = devtrace.Summary(busy_s=0.9, ops=30, op_s=0.9, by_name={}, gaps=[])
    return harness.Context(build_s=2.0, capture_s=0.5, host=[1e-4] * calls,
                           calls=calls, window_s=1.0, work=(1, 1),
                           summary=s if summary else None)


def _span(name, seconds, t0=1_000_000_000):
    """A closed span of `seconds` inside the innermost open one."""
    i = obs.begin(name)
    obs._OPEN.pop()
    name, _, parent = obs._SPANS[i]
    obs._SPANS[i] = (name, t0, parent)
    obs._ENDS[i] = t0 + round(seconds * 1e9)


@pytest.fixture(autouse=True)
def clean():
    obs.reset()
    yield
    obs.reset()


def _seed():
    _span("plan.pack", 1.25)
    with obs.span("entry.capture"):
        _span("solver.setup", 0.25)
        with obs.span("inner"):
            _span("solver.setup", 0.125)
    for ms in (0.02, 0.04, 0.06):
        with obs.span("entry.call"):
            _span("entry.replay", ms * 1e-3)
    obs.add("entry.replays", 10)
    obs.add("kernels.replayed_launches", 20)


def test_each_reader_reads_its_span_or_counter():
    _seed()
    read = {n: r.read(_ctx()) for n, r in _readers().items()}
    assert read["plan.pack_s"] == pytest.approx(1.25)
    assert read["entry.solver_setup_s"] == pytest.approx(0.375)
    assert read["entry.replay_ms_per_call"] == pytest.approx(0.04)
    # 30 operations over 3 calls, less 20 launches over 10 replays
    assert read["dispatch.glue_ops_per_call"] == pytest.approx(8.0)


def test_solver_setup_outside_a_capture_is_left_out():
    """A solve after the window (the harness's check of what the set-up
    derived) misses the memo once more: its ``solver.setup`` span opens
    outside every ``entry.capture`` and is not the entry's set-up."""
    _seed()
    _span("solver.setup", 0.5)
    with obs.span("plan.solve"):
        _span("solver.setup", 2.0)
    r = _readers()["entry.solver_setup_s"]
    assert r.read(_ctx()) == pytest.approx(0.375)


def test_a_capture_without_a_solver_reads_zero():
    with obs.span("entry.capture"):
        pass
    assert _readers()["entry.solver_setup_s"].read(_ctx()) == 0.0


def test_readers_read_nothing_where_their_spans_are_absent():
    assert all(r.read(_ctx()) is None for r in _readers().values())
    obs.add("kernels.replayed_launches", 5)
    assert _readers()["dispatch.glue_ops_per_call"].read(_ctx()) is None


def test_replay_reader_needs_one_span_a_call():
    _seed()
    r = _readers()["entry.replay_ms_per_call"]
    assert r.read(_ctx(calls=3)) == pytest.approx(0.04)
    assert r.read(_ctx(calls=4)) is None
    assert r.read(_ctx(calls=2)) is None


def test_readers_read_nothing_without_a_device_trace():
    _seed()
    assert all(r.read(_ctx(summary=False)) is None
               for r in _readers().values())
    assert _readers()["dispatch.glue_ops_per_call"].read(_ctx(calls=0)) \
        is None


def test_readers_read_nothing_from_a_program_without_obs(monkeypatch):
    _seed()
    # a checkout before the program had spans: its import fails
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs", raising=False)
    assert all(r.read(_ctx()) is None for r in _readers().values())
