"""The device trace of a run's window, and what it reduces to.

`torch.profiler` records the device's own activity (CUPTI: kernels,
copies and fills, the CUDA runtime calls that the host made) over the
window of a ``--trace 1`` run; it records no CPU operator, so the host
pays little for the trace.  The trace is written to a temporary file,
read back as JSON and deleted.  `reduce` turns its events into what the
per-layer metrics and the result's ``breakdown`` read: the device's busy
time (the union of its operations), the operations by name, and the
longest idle gaps named by the host call they fall in ("host" where the
host was in none: Python).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
from typing import Dict, List, Tuple

#: Chrome-trace categories of operations that run on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Categories of the host's calls that an idle gap is named by (the CUDA
#: API's calls, and the tracer's own buffer requests); the profiler's own
#: range over the whole window is none of them.
HOST_CATS = ("cuda_runtime", "cuda_driver", "overhead")
#: Entries kept in each list of the breakdown.
TOP = 10


def profiler():
    """A profiler over the device's activity, not yet started."""
    import torch

    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def events(prof) -> List[dict]:
    """The complete ("X") events of a stopped profiler's trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments, in the
    characters a metric name may hold."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name).split("(")[0]
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64] or "_"


@dataclasses.dataclass
class Summary:
    """busy_s: union of the device's operations; ops: their count; op_s:
    their summed time; by_name: {name: seconds}; gaps: the longest idle
    gaps, [(host call, seconds)], longest first."""

    busy_s: float
    ops: int
    op_s: float
    by_name: Dict[str, float]
    gaps: List[Tuple[str, float]]

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, s] for k, s in top],
                "idle_gaps": [[k, s] for k, s in self.gaps]}


def reduce(evs: List[dict]) -> Summary:
    """Reduce a trace's events (times in microseconds) to a `Summary`."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e.get("name", "")) for e in evs
                 if e.get("cat") in DEVICE_CATS)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "")) for e in evs
                  if e.get("cat") in HOST_CATS)
    by_name: Dict[str, float] = {}
    for t0, t1, name in dev:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (t1 - t0) * 1e-6
    busy, gaps = 0.0, []
    cur0 = cur1 = None
    for t0, t1, _ in dev:
        if cur1 is None:
            cur0, cur1 = t0, t1
        elif t0 > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        busy += cur1 - cur0
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = [h[0] for h in host]
    longest = max((h[1] - h[0] for h in host), default=0.0)
    named = []
    for g0, g1 in gaps[:TOP]:
        best, best_len = "host", 0.0
        i = bisect.bisect_left(starts, g0 - longest)
        while i < len(host) and host[i][0] < g1:
            over = min(g1, host[i][1]) - max(g0, host[i][0])
            if over > best_len:
                best, best_len = short_name(host[i][2]), over
            i += 1
        named.append((best, (g1 - g0) * 1e-6))
    return Summary(busy_s=busy * 1e-6, ops=len(dev),
                   op_s=sum(by_name.values()),
                   by_name=by_name, gaps=named)
