"""BENCHMARK.json against the contract it is checked by, and cells
resolved from files alone."""
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import cells, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_names_and_lengths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names), names
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert (ROOT / c["file"]).is_file()
    assert len({c["source"] for c in BENCH["configs"]}) == len(
        BENCH["configs"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and layers
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = cells.resolve(ROOT, workload)
    assert cell.chips == 1 and cell.mix["in_flight"] == 2
    assert {n for n, _ in cell.end_to_end} == {
        "signals_per_s", "latency_ms_p95", "setup_s"}
    assert [n for n, _, _ in cell.per_layer] == [
        m["name"] for m in BENCH["per_layer"]]
    assert all(hasattr(r, "read") for _, _, r in cell.per_layer)
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_a_new_mix_is_new_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pkg = tmp_path / "portbench"
    (pkg / "traffic" / "analysis.b32.json").write_text(json.dumps(
        {"kind": "apply", "batch": 32, "in_flight": 3}))
    shutil.copy(pkg / "limits" / "sgwt16k.analysis.b64.json",
                pkg / "limits" / "sgwt16k.analysis.b32.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sgwt16k.analysis.b32",
                               "config": "sensor16k_sgwt",
                               "traffic": "analysis.b32", "chips": 1,
                               "why": "a new mix"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.resolve(tmp_path, "sgwt16k.analysis.b32")
    assert cell.mix == {"kind": "apply", "batch": 32, "in_flight": 3}
    assert cell.config["name"] == "sensor16k_sgwt"
    assert Path(cell.kind.__file__).parent == pkg / "kinds"


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        cells.resolve(ROOT, "no.such.cell")


@pytest.mark.parametrize("workload", ["tiny.analysis", "tiny.jacobi"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_added_by_files_runs_on_the_cpu(tiny_root, workload,
                                                     trace):
    cell = cells.resolve(tiny_root, workload)
    r = harness.run(cell, 2 ** 33 + 1, 0.2, bool(trace), "cpu", 0.0)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(cell.limits)
    if trace:
        # no device trace on the CPU: the trace's readers read nothing
        assert set(r["metrics"]) == {"plan.build_s", "entry.capture_s",
                                     "entry.host_ms_per_call"}
    else:
        assert set(r["metrics"]) == {"signals_per_s", "latency_ms_p95",
                                     "setup_s"}
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_the_window_keeps_a_sample_drawn_from_the_seed():
    import random

    pool = [torch.full((2,), float(i)) for i in range(3)]
    win = harness.closed_loop(lambda x: x + 1, pool, 0.05, 2,
                              torch.device("cpu"), keep=4,
                              rng=random.Random(9))
    assert win.calls == len(win.latencies) == len(win.host)
    assert len(win.kept) == min(4, win.calls)
    for k, out in win.kept:
        assert torch.equal(out, pool[k % 3] + 1)
