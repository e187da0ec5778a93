"""Each kind's work for the roofline, from the graph and the shapes
alone, against values worked by hand."""
from pathlib import Path

import pytest

from portbench import cells

KINDS = Path(__file__).resolve().parents[1] / "kinds"

# A path graph of 4 vertices: |E| = 3, so P = L holds nnz = 2 * 3 + 4 = 10
# entries; B = 2 signals, eta = 2 multipliers, K = 3 orders, 3 rounds, r 1.
SMALL = {"n": 4, "nnz": 10, "B": 2, "eta": 2, "K": 3, "rounds": 3, "r": 1}

# apply: per signal 2 K nnz = 60 (products with P), n (2 + 4 (K - 1)) = 40
# (the recurrence), 2 eta (K + 1) n = 64 (the outputs): 164, x 2 = 328.
# Bytes: P 8 nnz = 80, the signals 4 B n = 32, the outputs 4 B eta n = 64,
# the coefficients 4 eta (K + 1) = 32: 208.
# apply_adjoint: per signal 2 K nnz eta = 120, eta n (2 + 4 (K - 1)) = 80,
# 2 eta (K + 1) n = 64: 264, x 2 = 528.  Bytes: 80 + 64 (inputs) + 32
# (outputs) + 32 (coefficients) = 208.
# jacobi: per signal n = 4 (num(P) y), rounds (2 r nnz + 5 n) = 3 x 40 =
# 120: 124, x 2 = 248.  Bytes: 80 + 32 (y) + 16 (D^-1) + 32 (x) = 160.
HAND = {"apply": (328, 208), "apply_adjoint": (528, 208),
        "jacobi": (248, 160)}


@pytest.mark.parametrize("kind", sorted(HAND))
def test_work_worked_by_hand(kind):
    module = cells.load_module(KINDS / f"{kind}.py", "kind")
    assert module.work(dict(SMALL)) == HAND[kind]


@pytest.mark.parametrize("kind", sorted(HAND))
def test_flops_grow_linearly_in_b(kind):
    module = cells.load_module(KINDS / f"{kind}.py", "kind")
    one = module.work(dict(SMALL, B=1))[0]
    for B in (2, 3, 64, 512):
        assert module.work(dict(SMALL, B=B))[0] == B * one


def test_the_chip_cells_work_from_the_graph():
    # the graph drawn on the card: 16375 of 16384 sensors, 71522 edges,
    # mean degree 8.74
    n, nnz = 16375, 2 * 71522 + 16375
    apply = cells.load_module(KINDS / "apply.py", "kind")
    flops, nbytes = apply.work({"n": n, "nnz": nnz, "B": 64, "eta": 7,
                                "K": 20})
    assert flops / 67e12 == pytest.approx(11.91e-6, rel=0.01)
    assert nbytes / 3.35e12 < flops / 67e12
