#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card.

    python3 portbench/control.py --workload <name> --seeds 1,2,...,12 \\
        --control-seeds 101,102,103 [--seconds 1] [--out readings.jsonl]

For every seed of ``--seeds``, the program's sound run: set-up as the
benchmark's run makes it, a short window of the cell's own load
(``--seconds``), and every number of the comparison against the float64
reference.  For every seed of ``--control-seeds``, the two controls one
precision below the float32 that the configurations state:

* ``reference_bf16``: the reference computed in bfloat16
  (`reference.spectral.BFLOAT16`) put in the program's place, its set-up
  values and its outputs on the same inputs judged as the program's are;
* ``program_bf16``: the program with its own bfloat16 mode switched on
  (``plan("cuda", sweep_dtype="bf16")``), run as a sound run is.  Where
  the cell's path has no such mode (past the sweep's L2 budget, or the
  adjoint) it runs in float32 and is no control;
* ``short``: a fault, the float64 reference one step short put in the
  program's place: one Jacobi round fewer, or the Chebyshev series
  without its last order (K - 1).

Each reading is one JSON line; the last line sums them up per number:
the lower reading (the largest over the program's seeds) and, per
control and fault, the smallest.  All seeds run in this one process;
the benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def program_numbers(cell, seed, seconds, device, plan_options=None) -> dict:
    from portbench import harness

    prog = harness.set_up(cell, seed, device, plan_options=plan_options)
    win = harness.closed_loop(prog.entry, prog.inputs.pool, seconds,
                              int(cell.mix["in_flight"]), device,
                              keep=harness.SAMPLE, rng=random.Random(seed))
    derived = cell.operator.derived(prog.plan, cell.config)
    harness.release(prog, device)
    return harness.judge(cell, prog.inputs, win.kept, derived)


def _judged(cell, inp, derived: dict, ctl, mix: dict) -> dict:
    """`ctl` (a reference operator) in the program's place on `inp`,
    judged on as many outputs as a run keeps, `derived` as its set-up
    values."""
    from portbench import harness

    kept = [(i, None) for i in range(harness.SAMPLE)]
    return harness.judge(
        cell, inp, kept, derived,
        outputs=lambda i: cell.kind.reference(ctl, inp.pool[i],
                                              cell.config, mix))


def reference_numbers(cell, seed, device, prec) -> dict:
    """The reference at `prec` in the program's place, on the inputs of
    `seed`."""
    from portbench import harness

    inp = harness.draw_inputs(cell, seed, device)
    ctl = cell.operator.reference(inp.graph, cell.config, prec)
    return _judged(cell, inp, cell.operator.reference_derived(ctl), ctl,
                   cell.mix)


def short_numbers(cell, seed, device) -> dict:
    """The float64 reference one step short in the program's place: one
    Jacobi round fewer where the mix has rounds, else the Chebyshev series
    without its last order; its set-up values exact."""
    from portbench import harness
    from portbench.reference import spectral

    inp = harness.draw_inputs(cell, seed, device)
    ref = cell.operator.reference(inp.graph, cell.config, spectral.FLOAT64)
    mix, ctl = cell.mix, ref
    if "rounds" in mix:
        mix = dict(mix, rounds=int(mix["rounds"]) - 1)
    else:
        ctl = dataclasses.replace(ref, coeffs=ref.coeffs[:, :-1])
    return _judged(cell, inp, cell.operator.reference_derived(ref), ctl, mix)


def summary(rows: list) -> dict:
    out = {}
    for row in rows:
        for name, v in row["numbers"].items():
            d = out.setdefault(name, {})
            if row["role"] == "program":
                d["lower"] = max(d.get("lower", 0.0), v)
            else:
                d[row["role"]] = min(d.get(row["role"], float("inf")), v)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import torch

    from portbench import cells
    from portbench.reference import spectral

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = cells.resolve(ROOT, args.workload)
    rows = []
    out = open(args.out, "a") if args.out else None

    def emit(role, seed, numbers):
        row = {"workload": cell.name, "role": role, "seed": seed,
               "numbers": numbers}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for s in [int(v) for v in args.seeds.split(",")]:
        emit("program", s, program_numbers(cell, s, args.seconds, dev))
    for s in [int(v) for v in args.control_seeds.split(",")]:
        emit("reference_bf16", s,
             reference_numbers(cell, s, dev, spectral.BFLOAT16))
        emit("program_bf16", s,
             program_numbers(cell, s, args.seconds, dev,
                             plan_options={"sweep_dtype": "bf16"}))
        emit("short", s, short_numbers(cell, s, dev))
    line = json.dumps({"workload": cell.name, "summary": summary(rows),
                       "seconds": time.perf_counter() - T_START})
    print(line)
    if out:
        out.write(line + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
