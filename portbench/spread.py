#!/usr/bin/env python3
"""Runs of one cell in a row, and how far they spread.

    python3 portbench/spread.py --workload <name> --seeds 1,2,3,4,5,6 \\
        [--seconds 10] [--trace 0] [--out runs.jsonl]

Runs ``portbench/run.py`` once per seed, one process after another, as
the benchmark's check does, and prints each run's result line, then per
metric the median and the spread: the distance between the first and
the third quartile (`statistics.quantiles(values, n=4)`) as a share of
the median.  A bound is set from the wider spread of two such sets on
the same seeds.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    rows = []
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "portbench" / "run.py"),
             "--workload", args.workload, "--seed", str(seed),
             "--seconds", str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        row = {"workload": args.workload, "seed": seed, "rc": proc.returncode,
               "wall_s": time.perf_counter() - t0,
               "result": json.loads(lines[-1]) if proc.returncode == 0
               and lines else None,
               "stderr_tail": proc.stderr[-2000:]}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    ok = [r["result"] for r in rows if r["result"]]
    names = sorted({m for r in ok for m in r["metrics"]})
    stats = {}
    for name in names:
        vals = [r["metrics"][name]["value"] for r in ok
                if name in r["metrics"]]
        stats[name] = {"median": statistics.median(vals),
                       "spread": spread(vals) if len(vals) > 1 else None,
                       "values": vals}
    line = json.dumps({"workload": args.workload, "runs": len(rows),
                       "correct": sum(bool(r["correct"]) for r in ok),
                       "stats": stats})
    print(line)
    if out:
        out.write(line + "\n")
        out.close()
    return 0 if len(ok) == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
