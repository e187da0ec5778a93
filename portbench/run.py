#!/usr/bin/env python3
"""Run one cell of the benchmark of `repro_torch` once, on the card.

    python3 portbench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card.  The cell
is resolved from ``BENCHMARK.json`` and the files under ``portbench/``
(`portbench.cells`) and run by `portbench.harness`.  The last line of
standard output is the result, one JSON object: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a device trace of the window.  The last lines of standard error give
each number that decided ``correct`` beside its limit.

It exits with 2, and prints no result, without a CUDA card (or with
fewer than the cell asks for), and with 3 if the process has loaded the
JAX package or JAX.  The program's kernels are built into ``build/``
inside the checkout at the first run there, and found there afterwards;
every other cache of the process (Python's bytecode among them) is kept
under ``build/portbench``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Top-level names in `sys.modules` that are forbidden, compared
    whole (`repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # the checkout's root (not this file's folder) and the program's
    # sources; every cache inside the checkout, at a fixed path, Python's
    # compiled bytecode (of torch, numpy and the program) too: only the
    # first run compiles it
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    cache = ROOT / "build" / "portbench"
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")

    from portbench import cells

    cell = cells.resolve(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from portbench import harness

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"run.py: the process holds {found}; the benchmark runs "
              "without JAX and the JAX package", file=sys.stderr)
        return 3
    print(f"card: {result['card']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
