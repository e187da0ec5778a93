"""One run of one cell: set-up, the measured window, and `correct`.

Set-up (counted in ``setup_s``): the configuration's graph is drawn on
the device from its own seed (`reference.graph`: the same graph in every
run of a cell), handed to the program as a dense float32 W,
and the configuration's operator builds the program's plan from it
(`operators/<name>.py`, timed as ``plan.build_s``); the cell's kind
takes the plan's memoized entry (`kinds/<kind>.py`), which on the card
must be a captured CUDA graph; a pool of distinct input batches is drawn
from the run's seed; the first call captures the entry and a short loop
warms it.

The window is a closed loop with ``in_flight`` calls outstanding: the
next call is enqueued before the one ahead of it has finished, as a
caller streaming batches does.  A call's latency runs from its enqueue,
on the host clock, to the moment the host sees its completion event.
The window runs from the first enqueue to the last completion, and every
call in it counts.  A sample of the calls' outputs, drawn from the seed
by reservoir sampling over every call of the window, is kept.

After the window the program's set-up values are read from the plan
(`operators/<name>.py`: ``derived``), the peak memory is read, and the
program is freed; then the float64 reference (`reference.spectral`) is
worked out from the graph alone and each number of the comparison is
held against its limit (``limits/<workload>.json``).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import random
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import devtrace
from .reference import graph as refgraph
from .reference import spectral

#: Distinct input batches that a window cycles through.
POOL = 8
#: Outputs of the window kept for the comparison.
SAMPLE = 6
#: Seconds of calls after the capture, in set-up.
WARM_S = 0.5


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Inputs:
    """What a run draws from its seed, the same for the program and the
    reference: the graph, a pool of distinct input batches, and the work's
    sizes (`kinds/*.py: work`) from the graph and the shapes alone."""

    graph: refgraph.SensorGraph
    pool: List[torch.Tensor]
    counts: Dict[str, int]


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) % 2 ** 64)
    return gen


def draw_inputs(cell, seed: int, device) -> Inputs:
    """The configuration's graph, drawn on `device` from its own
    ``graph_seed``, and the pool of input batches drawn from `seed`.  The
    graph is the work's size, so every seed of a cell runs the same work
    on other signals."""
    cfg, mix = cell.config, cell.mix
    graph = refgraph.draw(_generator(cfg["graph_seed"], device), cfg["n"],
                          cfg["kappa"], cfg["theta"])
    gen = _generator(seed, device)
    counts = dict(cell.operator.sizes(cfg), n=graph.n, B=int(mix["batch"]),
                  nnz=2 * graph.n_edges + graph.n,
                  rounds=int(mix.get("rounds", 0)))
    return Inputs(graph=graph,
                  pool=cell.kind.inputs(gen, counts, POOL, device),
                  counts=counts)


@dataclasses.dataclass
class Program:
    """The program's side of a run: its plan and entry on the run's
    inputs, and what the set-up measured: the entry's capture and the
    seconds of each stage ("plan" is ``plan.build_s``)."""

    inputs: Inputs
    plan: object
    entry: object
    capture_s: float
    stages: Dict[str, float]


def set_up(cell, seed: int, device, plan_options: Optional[dict] = None,
           kind=None) -> Program:
    """Draw the inputs from `seed`, build the program's plan and entry on
    them, capture and warm it.  `kind` stands in for ``cell.kind`` (a
    test plants a broken entry that way)."""
    dev = torch.device(device)
    kind = kind or cell.kind
    stages = {}
    t0 = time.perf_counter()
    inp = draw_inputs(cell, seed, dev)
    W = inp.graph.dense(torch.float32)
    sync(dev)
    t1 = time.perf_counter()
    stages["inputs"] = t1 - t0
    plan = cell.operator.build(W, cell.config, dev, **(plan_options or {}))
    sync(dev)
    t2 = time.perf_counter()
    del W
    entry = kind.entry(plan, cell.config, cell.mix)
    if dev.type == "cuda" and entry.mode != "graph":
        raise RuntimeError(f"the entry of {cell.name} runs in mode "
                           f"{entry.mode!r}; the window drives a captured "
                           "CUDA graph")
    x = inp.pool[0]
    entry(x)
    sync(dev)
    t3 = time.perf_counter()
    capture_s = entry.capture_ms[(tuple(x.shape), x.dtype)] / 1e3
    # the warm calls keep a sample too, so that the allocator holds the
    # blocks the window's kept outputs take: no cudaMalloc in the window
    closed_loop(entry, inp.pool, WARM_S, int(cell.mix["in_flight"]), dev,
                keep=SAMPLE, rng=random.Random(seed))
    stages.update(plan=t2 - t1, first_call=t3 - t2,
                  warm=time.perf_counter() - t3)
    return Program(inputs=inp, plan=plan, entry=entry, capture_s=capture_s,
                   stages=stages)


@dataclasses.dataclass
class Window:
    """calls: completed in the window; seconds: first enqueue to last
    completion; latencies and host (the host's time inside each call into
    the entry) in seconds; kept: [(call index, output)]."""

    calls: int
    seconds: float
    latencies: List[float]
    host: List[float]
    kept: list


def closed_loop(entry, pool, seconds: float, in_flight: int,
                device: torch.device, keep: int = 0,
                rng: Optional[random.Random] = None) -> Window:
    """Call `entry` on the pool's batches in turn for `seconds`, with
    `in_flight` calls outstanding, and wait for the last."""
    cuda = device.type == "cuda"
    ring = ([torch.cuda.Event() for _ in range(in_flight + 1)]
            if cuda else None)
    pending = collections.deque()
    lat, host, kept = [], [], []
    done = 0

    def finish() -> float:
        nonlocal done
        k, t_enq, ev, out = pending.popleft()
        if ev is not None:
            ev.synchronize()
        t = time.perf_counter()
        lat.append(t - t_enq)
        if keep:
            if len(kept) < keep:
                kept.append((k, out))
            else:
                j = rng.randrange(done + 1)
                if j < keep:
                    kept[j] = (k, out)
        done += 1
        return t

    k = 0
    t0 = t_last = time.perf_counter()
    t_end = t0 + seconds
    while True:
        t_enq = time.perf_counter()
        if t_enq >= t_end:
            break
        out = entry(pool[k % len(pool)])
        host.append(time.perf_counter() - t_enq)
        ev = None
        if cuda:
            ev = ring[k % len(ring)]
            ev.record()
        pending.append((k, t_enq, ev, out))
        k += 1
        while len(pending) >= in_flight:
            t_last = finish()
    while pending:
        t_last = finish()
    return Window(calls=k, seconds=t_last - t0, latencies=lat, host=host,
                  kept=kept)


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|; inf where `got` is not finite."""
    got = got.to(want.device, torch.float64)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max() / want.abs().max())


def judge(cell, inp: Inputs, kept, derived: dict,
          outputs=None) -> Dict[str, float]:
    """Every number of the comparison: the operator's set-up gaps
    between `derived` and the float64 reference, and out_gap, the widest
    relative gap of a kept output.  `outputs` (index -> tensor) stands in
    for the kept outputs' producer where a control takes the program's
    place."""
    ref = cell.operator.reference(inp.graph, cell.config, spectral.FLOAT64)
    pool = inp.pool
    numbers = cell.operator.gaps(derived, ref)
    want = {}
    gap = 0.0
    for k, out in kept:
        i = k % len(pool)
        if i not in want:
            want[i] = cell.kind.reference(ref, pool[i], cell.config,
                                          cell.mix)
        got = out if outputs is None else outputs(i)
        gap = max(gap, rel_gap(got, want[i]))
    numbers["out_gap"] = gap
    return numbers


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} for every number; a number without a
    limit, or a limit without a number, is an error of the cell's
    files."""
    if set(numbers) != set(limits):
        raise KeyError(f"numbers {sorted(numbers)} against limits "
                       f"{sorted(limits)}")
    return {k: {"value": numbers[k], "limit": limits[k]}
            for k in sorted(numbers)}


def release(prog: Program, device: torch.device) -> None:
    """Free the program's state (its plan, entry and graphs)."""
    prog.plan = prog.entry = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads (`metrics/*.py`).
    work: (FLOPs, bytes) of one call (`kinds/*.py: work`); summary: the
    device trace (`devtrace.Summary`), None without one."""

    build_s: float
    capture_s: float
    host: List[float]
    calls: int
    window_s: float
    work: tuple
    summary: Optional[devtrace.Summary]


def card() -> str:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err}"


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, kind=None) -> dict:
    """One run of `cell`; returns the result line's object.  t_start:
    the process's start on `time.perf_counter`'s clock."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    before = time.perf_counter() - t_start
    prog = set_up(cell, seed, dev, kind=kind)
    setup_s = time.perf_counter() - t_start
    prof = devtrace.profiler() if trace and cuda else None
    if prof is not None:
        prof.start()
    win = closed_loop(prog.entry, prog.inputs.pool, seconds,
                      int(cell.mix["in_flight"]), dev, keep=SAMPLE,
                      rng=random.Random(seed))
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    derived = cell.operator.derived(prog.plan, cell.config)
    release(prog, dev)
    summary = devtrace.reduce(devtrace.events(prof)) if prof else None
    checks = held(judge(cell, prog.inputs, win.kept, derived), cell.limits)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    B = prog.inputs.counts["B"]
    if trace:
        ctx = Context(build_s=prog.stages["plan"], capture_s=prog.capture_s,
                      host=win.host, calls=win.calls,
                      window_s=win.seconds,
                      work=cell.kind.work(prog.inputs.counts),
                      summary=summary)
        values = {name: reader.read(ctx)
                  for name, _, reader in cell.per_layer}
        units = {name: unit for name, unit, _ in cell.per_layer}
    else:
        values = {"signals_per_s": win.calls * B / win.seconds,
                  "latency_ms_p95": float(np.percentile(win.latencies, 95))
                  * 1e3,
                  "setup_s": setup_s}
        units = dict(cell.end_to_end)
        values = {name: values[name] for name in units}
    metrics = {name: {"value": float(v), "unit": units[name]}
               for name, v in values.items() if v is not None}
    result = {
        "correct": bool(correct), "attempted": win.calls, "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"].update(busy_s=summary.busy_s if summary else 0.0,
                                window_s=win.seconds)
        if summary is not None:
            result["breakdown"] = summary.breakdown()
    result["setup_stages_s"] = dict(start=before, **prog.stages)
    result["card"] = card() if cuda else "cpu"
    result["checks"] = checks
    return result
