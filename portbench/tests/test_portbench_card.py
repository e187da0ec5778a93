"""Every cell once, briefly, on the card (marker `gpu`; it skips without
one): the entry is a captured graph, the run is correct and its result
line carries every metric the cell reports."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         workload, "--seed", str(2 ** 32 + 5), "--seconds", "1",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    want = ([m["name"] for m in BENCH["per_layer"]] if trace else
            [m["name"] for m in BENCH["end_to_end"]])
    assert sorted(r["metrics"]) == sorted(want)
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
