"""Resolve a cell of ``BENCHMARK.json`` into the files that make it.

A cell names a configuration and a traffic mix; everything else is found
by name, so that a later cell, mix, configuration, call kind, operator or
per-layer metric is new files and never an edit:

* ``BENCHMARK.json``'s ``configs[].file``: the configuration (the graph
  and the operator, with its source);
* ``portbench/traffic/<traffic>.json``: the mix (the call kind, B, the
  calls in flight, the kind's own arguments);
* ``portbench/kinds/<kind>.py``: how the window calls the program, the
  kind's reference and its work for the roofline;
* ``portbench/operators/<operator>.py``: how the program builds the
  configuration's operator, and what its set-up derived;
* ``portbench/limits/<workload>.json``: the limit of each number that
  decides `correct`, with the readings it was set from;
* ``portbench/metrics/<metric>.py``: a per-layer metric's reader.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

PACKAGE = "portbench"


def load_module(path: Path, tag: str) -> ModuleType:
    """Import the Python file `path` under a private module name."""
    name = f"_{PACKAGE}_{tag}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell, resolved.  kind and operator are modules; per_layer
    holds (name, unit, reader module) for each per-layer metric, and
    end_to_end (name, unit) for each end-to-end one: every cell reports
    every metric."""

    name: str
    chips: int
    config: dict
    mix: dict
    kind: ModuleType
    operator: ModuleType
    limits: Dict[str, float]
    end_to_end: List[Tuple[str, str]]
    per_layer: List[Tuple[str, str, ModuleType]]


def resolve(root: Path, workload: str) -> Cell:
    """The cell `workload` of ``<root>/BENCHMARK.json``."""
    root = Path(root)
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    pkg = root / PACKAGE
    mix = _read_json(pkg / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(pkg / "limits" / f"{workload}.json")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, mix=mix,
        kind=load_module(pkg / "kinds" / f"{mix['kind']}.py", "kind"),
        operator=load_module(pkg / "operators" / f"{config['operator']}.py",
                             "operator"),
        limits={k: float(v["limit"]) for k, v in limits["checks"].items()},
        end_to_end=[(m["name"], m["unit"]) for m in bench["end_to_end"]],
        per_layer=[(m["name"], m["unit"],
                    load_module(pkg / "metrics" / f"{m['name']}.py",
                                "metric"))
                   for m in bench["per_layer"]])
