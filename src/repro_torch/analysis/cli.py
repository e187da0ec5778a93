"""The port's lint entry point: ``python -m repro_torch.analysis``.

Runs up to two layers and applies `lint_allowlist.txt` beside this file:

* ``ast``     — the AST rules of :mod:`repro_torch.analysis.astlint`
  (``RP-*``) over `src/repro_torch` and `chip_smoke.py`;
* ``runtime`` — the run-time checks of :mod:`repro_torch.analysis.checks`
  (``RT-*``) over every registered backend on a bandwidth-1 path graph
  (n 64, K 10, J 2, the JAX package's lint operator), at B = 1 and 64,
  with the Chebyshev, Jacobi and Chebyshev-Jacobi solves; the sharded
  backends also on a small community graph's general partition, and
  the fault schedule of `halo` and `cuda_halo` (int8, with and without
  a `FaultSpec`).  ``--ranks 1,8`` runs it on one process and then on 8
  gloo ranks, spawned here (each extra rank count is one spawn).

``--check`` exits nonzero on any finding that is not allowlisted.  Stale
allowlist entries (of a layer that ran, matching nothing) are reported as
warnings.  The runtime layer builds its plans on the card (every rank on
``cuda:<rank % device_count>``) unless ``--device cpu`` asks for the CPU;
without a card it stops with an error.  The ``ast`` layer needs no
device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path
from typing import List

from .astlint import AST_RULES, lint_tree
from .checks import RUNTIME_RULES, check_fault_schedule, check_plan
from .findings import Allowlist, AllowlistError, Finding

ROOT = Path(__file__).resolve().parents[3]
ALLOWLIST = Path(__file__).resolve().parent / "lint_allowlist.txt"

#: The graph the runtime layer checks every backend on: a path graph is
#: banded with coupling bandwidth exactly 1, so every backend builds on
#: any contiguous split, and the 2K|E| schedule is known in closed form.
LINT_N, LINT_K, LINT_J = 64, 10, 2
LINT_BATCHES = (1, 64)
LINT_SOLVES = ("chebyshev", "jacobi", "cheb_jacobi")
SHARDED_BACKENDS = ("halo", "cuda_halo", "allgather")
RING_BACKENDS = ("halo", "cuda_halo")
#: The fault configuration of the fault-schedule check: all three channels
#: firing, hold_last for the carried tiles — the configuration with the
#: most machinery that could add rounds.
LINT_FAULT_SPEC = {"drop_prob": 0.1, "stale_prob": 0.1, "noise_prob": 0.1,
                   "seed": 0}


def ast_findings(allowlist: Allowlist) -> List[Finding]:
    """The AST layer over the port and the smoke (paths repo-relative:
    run from the repo root)."""
    return lint_tree("src/repro_torch", src_root="src",
                     scaffold_globs=allowlist.scaffold_globs,
                     extra_files=("chip_smoke.py",))


def lint_operator():
    """The path-graph operator of the runtime layer."""
    from ..core import graph, wavelets
    from ..dist import GraphOperator

    g = graph.path_graph(LINT_N)
    lmax = g.lambda_max_bound()
    return GraphOperator(P=g.laplacian(),
                         multipliers=wavelets.sgwt_multipliers(lmax,
                                                               J=LINT_J),
                         lmax=lmax, K=LINT_K)


def community_operator():
    """A small non-banded community graph's operator, for the general
    partition (the banded path graph would give the ring plan)."""
    import torch

    from ..core import wavelets
    from ..dist import GraphOperator
    from ..dist.partition import community_graph_csr

    csr, meta = community_graph_csr(LINT_N, n_communities=8, seed=0)
    lmax = meta["lmax"]
    return GraphOperator(P=torch.from_numpy(csr.to_dense()),
                         multipliers=wavelets.sgwt_multipliers(lmax,
                                                               J=LINT_J),
                         lmax=lmax, K=LINT_K)


def runtime_findings(n_ranks: int, device=None,
                     report=None) -> List[Finding]:
    """The runtime layer on this process: every registered backend when
    it is the only rank, the sharded ones on every rank of the default
    group otherwise (all ranks call it together)."""
    from ..dist.backends import available_backends

    op = lint_operator()
    findings: List[Finding] = []
    for backend in available_backends():
        if n_ranks > 1 and backend not in SHARDED_BACKENDS:
            continue  # the single-device backends run at one rank
        plan = op.plan(backend, device=device)
        findings += check_plan(plan, batches=LINT_BATCHES,
                               solve_methods=LINT_SOLVES, report=report)
    for backend in RING_BACKENDS:
        clean = op.plan(backend, device=device, exchange_dtype="int8")
        faulted = op.plan(backend, device=device, exchange_dtype="int8",
                          fault_spec=LINT_FAULT_SPEC,
                          degradation="hold_last")
        findings += check_fault_schedule(clean, faulted,
                                         solve_methods=("jacobi",))
    cop = community_operator()
    for backend in RING_BACKENDS:
        plan = cop.plan(backend, device=device, partition="general")
        findings += check_plan(plan, batches=LINT_BATCHES,
                               solve_methods=("jacobi",), report=report)
        findings += check_fault_schedule(
            plan, cop.plan(backend, device=device, partition="general",
                           fault_spec=LINT_FAULT_SPEC,
                           degradation="hold_last"),
            solve_methods=("jacobi",))
    return findings


def _as_json(f: Finding) -> dict:
    return dict(rule=f.rule, path=f.path, message=f.message, line=f.line,
                symbol=f.symbol)


def _rank_main(rank: int, world: int, tmp: str, device) -> None:
    """One spawned rank of the runtime layer (gloo, file store in `tmp`);
    writes its findings to ``<tmp>/rank<rank>.json``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        found = runtime_findings(world, device=device)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump([_as_json(f) for f in found], fh)


def spawn_runtime(world: int, device=None) -> List[Finding]:
    """The runtime layer on `world` gloo ranks, spawned from here: the
    findings of every rank (duplicates across ranks merged)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(world, tmp, device), nprocs=world,
                 join=True)
        seen, out = set(), []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                for d in json.load(fh):
                    f = Finding(**d)
                    if f not in seen:
                        seen.add(f)
                        out.append(f)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's lint: AST rules and run-time invariant "
                    "checks")
    parser.add_argument("--check", action="store_true",
                        help="exit nonzero on findings not allowlisted")
    parser.add_argument("--layers", default="ast,runtime",
                        help="comma-set of ast|runtime (default: both)")
    parser.add_argument("--ranks", default="1",
                        help="comma-list of rank counts for the runtime "
                             "layer; counts > 1 spawn gloo ranks "
                             "(default: 1)")
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                        help="where the runtime layer builds its plans "
                             "(default: the card)")
    parser.add_argument("--allowlist", default=str(ALLOWLIST))
    args = parser.parse_args(argv)
    layers = [l.strip() for l in args.layers.split(",") if l.strip()]
    unknown = set(layers) - {"ast", "runtime"}
    if unknown:
        parser.error(f"unknown layers: {sorted(unknown)}")
    os.chdir(ROOT)
    try:
        allowlist = Allowlist.load(args.allowlist)
    except AllowlistError as e:
        print(f"allowlist error: {e}", file=sys.stderr)
        return 2
    device = None if args.device == "cuda" else "cpu"
    if "runtime" in layers and device is None:
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device for the runtime layer: pass --device cpu "
                  "to run it on the CPU", file=sys.stderr)
            return 2
    ranks = sorted({int(r) for r in args.ranks.split(",")})

    findings: List[Finding] = []
    rules: List[str] = []
    if "ast" in layers:
        findings += ast_findings(allowlist)
        rules += AST_RULES
    if "runtime" in layers:
        rules += RUNTIME_RULES
        for world in ranks:
            findings += (runtime_findings(1, device=device) if world == 1
                         else spawn_runtime(world, device=device))

    kept, suppressed = allowlist.split(findings)
    for f in kept:
        print(str(f), file=sys.stderr)
    for entry in allowlist.unused_entries(findings):
        if entry.rule in rules:
            print(f"warning: stale allowlist entry matches nothing: "
                  f"{entry.rule} {entry.path_glob}"
                  + (f"::{entry.symbol}" if entry.symbol else ""),
                  file=sys.stderr)
    scope = f"layers={','.join(layers)}"
    if "runtime" in layers:
        scope += f" ranks={','.join(map(str, ranks))} device={args.device}"
    print(f"repro_torch.analysis [{scope}]: {len(kept)} finding(s), "
          f"{len(suppressed)} allowlisted")
    return 1 if kept and args.check else 0
