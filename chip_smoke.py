#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It

1. builds every CUDA kernel of the port from ``src/repro_torch/csrc``;
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes of the main path, and times both (plus one PyTorch library
   call computing the same product, where there is one);
3. drives the main path — ``GraphOperator(...).plan("cuda")`` `apply`,
   `apply_adjoint`, `apply_gram` and the ``sweep=False`` apply — on the
   Section IV-D random sensor network at n = 16384 sensors, the SGWT union
   with J = 6 (eta = 7), K = 20, on a batch of 64 signals, and holds every
   output against the port's float64 ``plan("dense")`` on the card;
4. shows through the kernels' launch counters that the main path ran
   through the kernels;
5. times the whole-recurrence sweep against the per-order path on both
   sides of the sweep's L2 budget.

It prints the card's name and power limit, one JSON line ``{"kernels":
[...]}`` and, last, ``{"ok": true, "device": {...}}``.  Any failed check
raises and exits non-zero without the last line.  It needs no network,
imports nothing of JAX, and has no CPU fallback: without a card (or
outside a checkout) it exits with code 2.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N = 16384                  # sensors
J, K, BATCH = 6, 20, 64    # SGWT scales (eta = J + 1), order, signals
# Section IV-D draws n = 500 sensors with kappa = 0.075, theta = 0.074.
# At n = 16384 that radius gives ~290 neighbours per sensor; the radius is
# the one reduction: kappa = sqrt(20 / (pi n)) keeps ~20 neighbours and a
# connected graph, theta keeps the paper's theta / kappa ratio.
KAPPA = math.sqrt(20.0 / (math.pi * N))
THETA = KAPPA * 0.074 / 0.075
# H100 SXM published peaks: f32 outside the tensor cores, HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Tolerances.  Kernel vs plain version: the same f32 arithmetic in another
# summation order (SpMV: up to slots * bc terms per output; sweep: 20
# orders of the recurrence).  Main path vs float64 dense: f32 rounding
# over 20 (apply, adjoint) to 40 (Gram) orders.
TOL_SPMV = 1e-5
TOL_STEP = 1e-6
TOL_SWEEP = 1e-4
TOL_PATH = 1e-4

ROOT = Path(__file__).resolve().parent


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, that over max |ref|), in float64."""
    got, ref = got.double(), ref.double()
    check(bool(torch.isfinite(got).all()), "non-finite output")
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import graph, wavelets
    from repro_torch.dist import GraphOperator
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.bcsr_spmv import (block_ell_spmv,
                                               block_ell_spmv_plain)
    from repro_torch.kernels.cheb_step import cheb_step, cheb_step_plain
    from repro_torch.kernels.cheb_sweep import cheb_sweep, cheb_sweep_plain

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.SOURCES)})")

    # -- the graph and the operator ------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    g = graph.connected_sensor_graph(rng, n=N, theta=THETA, kappa=KAPPA)
    g, _ = graph.spatial_sort(g)
    L = g.laplacian()
    lmax = g.lambda_max_bound()
    n_edges = g.n_edges
    del g
    op = wavelets.sgwt_operator(L, lmax, J=J, K=K)
    plan = op.plan("cuda")
    plan_po = op.plan("cuda", sweep=False)
    A = plan.info["block_ell"]
    eta = op.eta
    nrb, slots, br, bc = A.blocks.shape
    nnz = int((A.blocks != 0).sum())
    fill = nnz / A.blocks.numel()
    print(f"graph: n={N} kappa={KAPPA:.6f} theta={THETA:.6f} |E|={n_edges} "
          f"mean degree={2 * n_edges / N:.2f} lmax_bound={lmax:.4f} "
          f"({time.perf_counter() - t0:.1f} s to build and plan)")
    print(f"block-ell: {nrb} row blocks x {slots} slots of ({br}, {bc}), "
          f"{A.blocks.numel() * 4 / 2**20:.1f} MiB of blocks, "
          f"nnz={nnz}, fill={fill:.4f}")
    check(op.K == K and eta == J + 1, "operator shape")
    check(plan.info["sweep_l2_bytes"] * BATCH <= plan.info["sweep_l2_budget"],
          "the smoke shape must take the sweep")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # -- kernel phases: each kernel against its plain version ----------------
    L_csr = L.to(dev).to_sparse_csr()
    spmv_rows = {}
    for B in (1, BATCH):
        x = randn(B, N)
        xt = x.t().contiguous()
        got = block_ell_spmv(A.blocks, A.indices, x)
        want = block_ell_spmv_plain(A.blocks, A.indices, x)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        check(rel <= TOL_SPMV, f"block_ell_spmv B={B}: rel err {rel:.3e}")
        ms = time_ms(lambda: block_ell_spmv(A.blocks, A.indices, x), 20)
        plain_ms = time_ms(
            lambda: block_ell_spmv_plain(A.blocks, A.indices, x), 5)
        lib_ms = time_ms(lambda: torch.sparse.mm(L_csr, xt), 20)
        b_ms, b_by = bound(nnz * 8 + 2 * B * N * 4, 2 * nnz * B)
        spmv_rows[B] = dict(max_abs_err=err, rel_err=rel, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by)
        print(f"kernel block_ell_spmv B={B}: max_abs_err={err:.3e} "
              f"rel={rel:.3e} (tol {TOL_SPMV}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms(torch.sparse.mm CSR)="
              f"{lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by})")
    del L_csr

    pt, t1, t2 = randn(BATCH, N), randn(BATCH, N), randn(BATCH, N)
    acc = randn(BATCH, eta, N)
    coef = randn(eta)
    alpha = lmax / 2.0
    got = cheb_step(pt, t1, t2, acc, coef, alpha=alpha)
    want = cheb_step_plain(pt, t1, t2, acc, coef, alpha=alpha)
    torch.cuda.synchronize()
    err_tk, rel_tk = rel_err(got[0], want[0])
    err_acc, rel_acc = rel_err(got[1], want[1])
    check(max(rel_tk, rel_acc) <= TOL_STEP,
          f"cheb_step: rel err {max(rel_tk, rel_acc):.3e}")
    step_ms = time_ms(lambda: cheb_step(pt, t1, t2, acc, coef, alpha=alpha), 20)
    step_plain = time_ms(
        lambda: cheb_step_plain(pt, t1, t2, acc, coef, alpha=alpha), 20)
    step_b = bound(4 * (4 * BATCH * N + 2 * BATCH * eta * N + eta),
                   4 * BATCH * N + 2 * BATCH * eta * N)
    print(f"kernel cheb_step B={BATCH} eta={eta}: max_abs_err="
          f"{max(err_tk, err_acc):.3e} rel={max(rel_tk, rel_acc):.3e} "
          f"(tol {TOL_STEP}) ms={step_ms:.4f} plain_ms={step_plain:.4f} "
          f"bound_ms={step_b[0]:.5f} ({step_b[1]})")

    x = randn(BATCH, N)
    c = op.coeffs
    got = cheb_sweep(A.blocks, A.indices, x, c, alpha=alpha)
    want = cheb_sweep_plain(A.blocks, A.indices, x, c, alpha=alpha)
    torch.cuda.synchronize()
    err_sw, rel_sw = rel_err(got, want)
    check(rel_sw <= TOL_SWEEP, f"cheb_sweep: rel err {rel_sw:.3e}")
    sweep_ms = time_ms(lambda: cheb_sweep(A.blocks, A.indices, x, c,
                                          alpha=alpha), 5)
    sweep_plain = time_ms(lambda: cheb_sweep_plain(A.blocks, A.indices, x, c,
                                                   alpha=alpha), 2, warmup=1)
    sweep_b = bound(nnz * 8 + 4 * BATCH * N + 4 * BATCH * eta * N
                    + 4 * (K + 1) * eta,
                    K * (2 * nnz * BATCH + 4 * BATCH * N)
                    + 2 * (K + 1) * BATCH * eta * N)
    print(f"kernel cheb_sweep B={BATCH} eta={eta} K={K}: max_abs_err="
          f"{err_sw:.3e} rel={rel_sw:.3e} (tol {TOL_SWEEP}) ms={sweep_ms:.4f} "
          f"plain_ms={sweep_plain:.4f} bound_ms={sweep_b[0]:.5f} "
          f"({sweep_b[1]}) grid={cheb_sweep.last_grid} blocks")
    del pt, t1, t2, acc, got, want

    # -- the main path, counted ----------------------------------------------
    F = randn(BATCH, N)
    a = randn(BATCH, eta, N)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (block_ell_spmv, cheb_step, cheb_sweep)
    for fn in counters:
        fn.launches = 0
    outs, calls = {}, {}
    for name, fn, arg in (("apply", plan.apply, F),
                          ("apply_adjoint", plan.apply_adjoint, a),
                          ("apply_gram", plan.apply_gram, F),
                          ("apply[sweep=False]", plan_po.apply, F)):
        before = [k.launches for k in counters]
        t0 = time.perf_counter()
        outs[name] = fn(arg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        calls[name] = [k.launches - b for k, b in zip(counters, before)]
        print(f"path {name}: {wall:.2f} ms host clock (first call) "
              f"launches spmv/step/sweep={calls[name]}")
    launches = {k.__name__: k.launches for k in counters}
    peak = torch.cuda.max_memory_allocated()
    print(f"path launches: {launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    check(calls["apply"] == [0, 0, 1], "apply must be one sweep launch")
    check(calls["apply_gram"] == [0, 0, 1], "apply_gram must be one sweep")
    check(calls["apply_adjoint"] == [K, 0, 0],
          "apply_adjoint must be K SpMV launches")
    check(calls["apply[sweep=False]"] == [K, K - 1, 0],
          "the per-order apply must be K SpMV and K-1 step launches")
    check(all(v > 0 for v in launches.values()),
          "every kernel of the path must launch")

    # -- the main path against float64 dense --------------------------------
    op64 = GraphOperator(P=L.double(), multipliers=op.multipliers, lmax=lmax,
                         K=K)
    check(np.array_equal(op64.coeffs, op.coeffs), "coefficient tables")
    dense = op64.plan("dense")
    refs = {"apply": dense.apply(F.double()),
            "apply_adjoint": dense.apply_adjoint(a.double()),
            "apply_gram": dense.apply_gram(F.double())}
    refs["apply[sweep=False]"] = refs["apply"]
    shapes = {"apply": (BATCH, eta, N), "apply_adjoint": (BATCH, N),
              "apply_gram": (BATCH, N), "apply[sweep=False]": (BATCH, eta, N)}
    for name, out in outs.items():
        check(tuple(out.shape) == shapes[name], f"{name} shape {out.shape}")
        err, rel = rel_err(out, refs[name])
        print(f"path {name} vs float64 dense: max_abs_err={err:.3e} "
              f"rel={rel:.3e} (tol {TOL_PATH})")
        check(rel <= TOL_PATH, f"{name}: rel err {rel:.3e} vs dense f64")
    steady = {name: time_ms(lambda fn=fn, arg=arg: fn(arg), 3, warmup=1)
              for name, fn, arg in (("apply", plan.apply, F),
                                    ("apply_adjoint", plan.apply_adjoint, a),
                                    ("apply_gram", plan.apply_gram, F),
                                    ("apply[sweep=False]", plan_po.apply, F))}
    print("path steady ms (CUDA events): "
          + " ".join(f"{k}={v:.3f}" for k, v in steady.items()))
    del dense, refs, op64

    # -- the guard: sweep vs per-order on both sides of the L2 budget --------
    for B in (BATCH, 2 * BATCH):
        xg = randn(B, N)
        need = ops.cheb_sweep_l2_bytes(N, eta, B)
        sw = time_ms(lambda: ops.fused_cheb_apply(
            A, xg, c, lmax, l2_budget=2**62), 3, warmup=1)
        po = time_ms(lambda: ops.fused_cheb_apply(
            A, xg, c, lmax, sweep=False), 3, warmup=1)
        side = "within" if need <= ops.DEFAULT_SWEEP_L2_BUDGET else "above"
        print(f"guard B={B}: L2 working set {need} B {side} budget "
              f"{ops.DEFAULT_SWEEP_L2_BUDGET} B; sweep_ms={sw:.3f} "
              f"per_order_ms={po:.3f}")

    # -- the records ----------------------------------------------------------
    s64 = spmv_rows[BATCH]
    s1 = spmv_rows[1]
    kernels = [
        {"name": "block_ell_spmv", "route": "cuda",
         "source": "src/repro_torch/csrc/block_ell_spmv.cu",
         "replaces": "src/repro/kernels/bcsr_spmv.py:106",
         "also_replaces": "src/repro/kernels/bcsr_spmv.py:56",
         "launches": launches["block_ell_spmv"],
         "max_abs_err": s64["max_abs_err"], "ms": s64["ms"],
         "plain_ms": s64["plain_ms"], "bound_ms": s64["bound_ms"],
         "bound_by": s64["bound_by"], "library_ms": s64["library_ms"],
         "batch": BATCH, "b1": s1},
        {"name": "cheb_step", "route": "cuda",
         "source": "src/repro_torch/csrc/cheb_step.cu",
         "replaces": "src/repro/kernels/cheb_step.py:66",
         "launches": launches["cheb_step"],
         "max_abs_err": max(err_tk, err_acc), "ms": step_ms,
         "plain_ms": step_plain, "bound_ms": step_b[0],
         "bound_by": step_b[1], "library_ms": None},
        {"name": "cheb_sweep", "route": "cuda",
         "source": "src/repro_torch/csrc/cheb_sweep.cu",
         "replaces": "src/repro/kernels/cheb_sweep.py:121",
         "launches": launches["cheb_sweep"],
         "max_abs_err": err_sw, "ms": sweep_ms, "plain_ms": sweep_plain,
         "bound_ms": sweep_b[0], "bound_by": sweep_b[1], "library_ms": None},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
