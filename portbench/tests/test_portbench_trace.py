"""The device trace's reduction and the per-layer readers on a trace
written by hand (times in microseconds)."""
from pathlib import Path

import pytest

from portbench import cells, devtrace, harness

METRICS = Path(__file__).resolve().parents[1] / "metrics"

EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
     "cheb_sweep_kernel<float, 8>(float const*, int)", "ts": 100.0,
     "dur": 400.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
     "ts": 500.0, "dur": 10.0},
    # overlaps the copy: the union counts it once
    {"ph": "X", "cat": "kernel", "name": "void fill_kernel<float>(int)",
     "ts": 505.0, "dur": 15.0},
    {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
     "cheb_sweep_kernel<float, 8>(float const*, int)", "ts": 600.0,
     "dur": 400.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
     "ts": 530.0, "dur": 50.0},
    {"ph": "X", "cat": "user_annotation", "name": "PyTorch Profiler (0)",
     "ts": 0.0, "dur": 2000.0},
    {"ph": "X", "cat": "kernel", "name": "void tail_kernel()", "ts": 1100.0,
     "dur": 100.0},
]


def test_reduce_unions_names_and_gaps():
    s = devtrace.reduce(EVENTS)
    assert s.ops == 5
    assert s.busy_s == pytest.approx((420 + 400 + 100) * 1e-6)
    assert s.op_s == pytest.approx((400 + 10 + 15 + 400 + 100) * 1e-6)
    assert s.by_name["cheb_sweep_kernel_float__8_"] == pytest.approx(800e-6)
    # gaps 520-600 (80: mostly inside cudaGraphLaunch), 1000-1100 (100:
    # the host in no CUDA call; the profiler's own range does not count)
    assert s.gaps == [("host", pytest.approx(100e-6)),
                      ("cudaGraphLaunch", pytest.approx(80e-6))]
    b = s.breakdown()
    assert b["device_ops"][0] == ["cheb_sweep_kernel_float__8_",
                                  pytest.approx(800e-6)]
    assert len(b["device_ops"]) <= devtrace.TOP


def test_readers_on_the_trace():
    s = devtrace.reduce(EVENTS)
    ctx = harness.Context(build_s=1.5, capture_s=0.25,
                          host=[1e-4, 3e-4], calls=2, window_s=2000e-6,
                          work=(67e6, 3.35e5), summary=s)
    read = {p.stem: cells.load_module(p, "metric").read(ctx)
            for p in METRICS.glob("*.py")}
    assert read["plan.build_s"] == 1.5
    assert read["entry.capture_s"] == 0.25
    assert read["entry.host_ms_per_call"] == pytest.approx(0.2)
    assert read["dispatch.kernels_per_call"] == 2.5
    # least time of a call: max(3.35e5 / 3.35e12, 67e6 / 67e12) = 1 us
    assert read["kernels.roofline_pct"] == pytest.approx(
        100 * 2 * 1e-6 / 925e-6)
    assert read["device.idle_pct"] == pytest.approx(100 * (1 - 920 / 2000))


def test_readers_read_nothing_without_a_trace():
    ctx = harness.Context(build_s=1.0, capture_s=0.1, host=[], calls=0,
                          window_s=1.0, work=(1, 1), summary=None)
    for p in METRICS.glob("*.py"):
        value = cells.load_module(p, "metric").read(ctx)
        assert value is None or p.stem in ("plan.build_s",
                                           "entry.capture_s"), p.stem
