"""`correct` on tiny cells on the CPU: a sound run passes; the control
(the reference in bfloat16 in the program's place) and each fault that
these one-card cells can have fail.

The faults break the timed path underneath the harness, which runs as a
benchmark run does: a call that returns the state of the call before
(its outputs not moved on), half of the batch left out with the mean of
the rest in its place, and one answer altered where it is produced.  The
exchange between chips is no fault of these cells: each runs on one
card.  A second witness holds the reference itself: the port's float64
dense plan computes the same outputs."""
import numpy as np
import pytest
import torch

from portbench import cells, control, harness
from portbench.reference import spectral

WORKLOADS = ["tiny.analysis", "tiny.synthesis", "tiny.jacobi"]


class _FaultyEntry:
    def __init__(self, inner, fault):
        self._inner, self._fault, self._last = inner, fault, None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __call__(self, x):
        if self._fault == "unchanged":
            out = self._inner(x)
            last = self._last if self._last is not None else torch.zeros_like(
                out)
            self._last = out
            return last
        out = self._inner(x).clone()
        if self._fault == "half_batch":
            h = x.shape[0] // 2
            out[h:] = out[:h].mean(0, keepdim=True)
            return out
        out.view(-1)[0] += 0.01 * out.abs().max()
        return out


class _BrokenKind:
    def __init__(self, kind, fault):
        self._kind, self._fault = kind, fault

    def __getattr__(self, name):
        return getattr(self._kind, name)

    def entry(self, plan, cfg, mix):
        return _FaultyEntry(self._kind.entry(plan, cfg, mix), self._fault)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(tiny_root, workload):
    cell = cells.resolve(tiny_root, workload)
    r = harness.run(cell, 21, 0.2, False, "cpu", 0.0)
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(tiny_root, workload, fault):
    cell = cells.resolve(tiny_root, workload)
    r = harness.run(cell, 22, 0.2, False, "cpu", 0.0,
                    kind=_BrokenKind(cell.kind, fault))
    assert r["correct"] is False
    assert r["checks"]["out_gap"]["value"] > r["checks"]["out_gap"]["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_the_control_is_not_correct(tiny_root, workload, seed):
    cell = cells.resolve(tiny_root, workload)
    numbers = control.reference_numbers(cell, seed, torch.device("cpu"),
                                        spectral.BFLOAT16)
    checks = harness.held(numbers, cell.limits)
    failed = [k for k, c in checks.items() if c["value"] > c["limit"]]
    assert failed, checks
    assert "out_gap" in failed


@pytest.mark.parametrize("workload", WORKLOADS)
def test_one_step_short_is_not_correct(tiny_root, workload):
    # one Jacobi round fewer, or the series without its last order
    cell = cells.resolve(tiny_root, workload)
    numbers = control.short_numbers(cell, 34, torch.device("cpu"))
    checks = harness.held(numbers, cell.limits)
    assert checks["out_gap"]["value"] > checks["out_gap"]["limit"], checks
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k != "out_gap"), checks


def test_the_reference_agrees_with_the_port_in_float64(tiny_root):
    from repro_torch.core import filters, graph, wavelets
    from repro_torch.dist import GraphOperator

    sg = cells.resolve(tiny_root, "tiny.analysis")
    cfg = sg.config
    inp = harness.draw_inputs(sg, 41, "cpu")
    W = inp.graph.dense(torch.float64)
    ref = spectral.sgwt_operator(inp.graph, cfg["J"], cfg["K"],
                                 cfg["lpfactor"], cfg["coeff_points"],
                                 spectral.FLOAT64)
    lmax = graph.lambda_max_bound(W)
    assert lmax == pytest.approx(ref.lmax, rel=1e-14)
    op = GraphOperator(P=graph.laplacian(W), multipliers=(
        wavelets.sgwt_multipliers(lmax, cfg["J"], cfg["lpfactor"])),
        lmax=lmax, K=cfg["K"], coeff_points=cfg["coeff_points"])
    np.testing.assert_allclose(op.coeffs, ref.coeffs, rtol=0, atol=1e-13)
    plan = op.plan("dense", device="cpu")
    x = inp.pool[0].double()
    assert harness.rel_gap(plan.apply(x), ref.apply(x)) < 1e-12
    a = torch.randn((3, cfg["J"] + 1, x.shape[-1]), dtype=torch.float64)
    assert harness.rel_gap(plan.apply_adjoint(a), ref.adjoint(a)) < 1e-12

    tk = cells.resolve(tiny_root, "tiny.jacobi").config
    ref = spectral.tikhonov_operator(inp.graph, tk["P"], tk["tau"], tk["r"],
                                     tk["K"], tk["coeff_points"],
                                     spectral.FLOAT64)
    P = graph.laplacian(W, tk["P"])
    op = GraphOperator(P=P, multipliers=[filters.ssl_multiplier(
        filters.power_kernel(tk["r"]), tk["tau"])], lmax=2.0, K=tk["K"])
    got = op.plan("dense", device="cpu").solve(
        x, "jacobi", tau=tk["tau"], r=tk["r"], n_iters=20).x
    assert harness.rel_gap(got, ref.jacobi(x, 20)) < 1e-12
    inv_d = 1.0 / (tk["tau"] + torch.diagonal(P))
    assert harness.rel_gap(inv_d, ref.inv_d()) < 1e-14
