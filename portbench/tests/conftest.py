"""Fixtures of the benchmark's CPU tests: the checkout and the program's
sources on the path, and a copy of the benchmark with tiny cells added by
files alone."""
import json
import math
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: Tiny stand-ins of the chip cells: (workload, config, mix) -> the cell
#: whose limits they take.
TINY = {
    "tiny.analysis": ("tiny_sgwt", "tiny.analysis", "sgwt16k.analysis.b64"),
    "tiny.synthesis": ("tiny_sgwt", "tiny.synthesis",
                       "sgwt16k.synthesis.b128"),
    "tiny.jacobi": ("tiny_tikhonov", "tiny.jacobi",
                    "tikhonov16k.jacobi.b64"),
}
TINY_N = 384


def add_tiny_cells(root: Path) -> None:
    """Add the tiny configurations, mixes, limits and cells to the copy
    of the benchmark at `root`: new files and new entries only."""
    pkg = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    scale = math.sqrt(500.0 / TINY_N)
    for name, base in (("tiny_sgwt", "sensor16k_sgwt"),
                       ("tiny_tikhonov", "sensor16k_tikhonov")):
        cfg = json.loads((pkg / "configs" / f"{base}.json").read_text())
        cfg.update(name=name, n=TINY_N, kappa=0.075 * scale,
                   theta=0.074 * scale)
        (pkg / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "tests",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": ["n"], "why": "tests"})
    mixes = {"tiny.analysis": {"kind": "apply", "batch": 4, "in_flight": 2},
             "tiny.synthesis": {"kind": "apply_adjoint", "batch": 3,
                                "in_flight": 2},
             "tiny.jacobi": {"kind": "jacobi", "batch": 4, "in_flight": 2,
                             "rounds": 20}}
    for workload, (config, mix, limits) in TINY.items():
        (pkg / "traffic" / f"{mix}.json").write_text(json.dumps(mixes[mix]))
        shutil.copy(pkg / "limits" / f"{limits}.json",
                    pkg / "limits" / f"{workload}.json")
        bench["workloads"].append({"name": workload, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` with the tiny cells
    added."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_cells(root)
    return root
