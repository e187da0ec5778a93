"""Batched serving example: prefill + greedy decode with KV caches (the JAX
package's `examples/serve_lm.py` on the port).

Runs the hybrid (attention + SSM) arch, reduced, to show the
sub-quadratic cache path: hymba-1.5b's window of attention beside its
mamba branch, B 4, 16 prompt tokens, 24 generated.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

On the card by default; ``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

#: The launcher's arguments, the JAX example's.
ARGV = ["--arch", "hymba-1.5b", "--smoke", "--batch", "4",
        "--prompt-len", "16", "--gen", "24"]


def launcher_argv(device: Optional[str] = None) -> List[str]:
    """What this example passes `repro_torch.launch.serve.main`."""
    return ARGV + ([] if device is None else ["--device", device])


def main(argv: Optional[list] = None) -> int:
    from ..launch import serve

    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "serve_lm")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    return serve.main(launcher_argv(args.device))


if __name__ == "__main__":
    sys.exit(main())
