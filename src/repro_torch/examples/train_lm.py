"""End-to-end training example (the JAX package's
`examples/train_lm.py` on the port).

Trains a ~10M-parameter reduced deepseek-7b (B 8, S 64, lr 1e-3) with a
checkpoint every 50 steps, then shows the paper's integration:
data-parallel training whose gradient average is Chebyshev-polynomial
gossip on the rank ring (Algorithm 1 with P = L(ring)) instead of an
all-reduce.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --gossip \
        [--device cpu]                     # 4 gloo ranks, spawned here

On the card by default; ``--device cpu`` runs it on the CPU.  Where the
JAX example takes its ranks from the forced host devices, ``--gossip``
here passes the launcher ``--dp-mode gossip --mesh 4x1``: 4 gloo ranks
(on one card, all on it).  The checkpoints go to ``--ckpt-dir``, by
default ``repro_train_lm`` in the temporary directory.  The same launcher
at full width is ``python -m repro_torch.launch.train --arch deepseek-7b
--steps ...``.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

#: Ranks of ``--gossip``.
GOSSIP_RANKS = 4


def launcher_argv(steps: int = 200, gossip: bool = False,
                  ckpt_dir: Optional[str] = None,
                  device: Optional[str] = None) -> List[str]:
    """What this example passes `repro_torch.launch.train.main`: the JAX
    example's arguments."""
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_train_lm")
    argv = ["--arch", "deepseek-7b", "--smoke", "--steps", str(steps),
            "--batch", "8", "--seq", "64", "--lr", "1e-3",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "50"]
    if gossip:
        argv += ["--dp-mode", "gossip", "--mesh", f"{GOSSIP_RANKS}x1"]
    return argv + ([] if device is None else ["--device", device])


def main(argv: Optional[list] = None) -> int:
    from ..launch import train

    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_lm")
    ap.add_argument("--gossip", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    return train.main(launcher_argv(args.steps, args.gossip, args.ckpt_dir,
                                    args.device))


if __name__ == "__main__":
    sys.exit(main())
