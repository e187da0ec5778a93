#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It

1. builds every CUDA kernel of the port from ``src/repro_torch/csrc``;
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes of the paths below, and times both (plus one PyTorch library
   call computing the same product, where there is one): the sliced-ELL
   SpMV at B = 1, 64 and 448 (also against the Block-ELL plain version on
   the same P), the Chebyshev and Jacobi steps, both sweeps (which read
   the same sliced-ELL layout as the SpMV), the ISTA shrink and both
   flash-attention kernels;
3. drives the main path — ``GraphOperator(...).plan("cuda")`` `apply`,
   `apply_adjoint`, `apply_gram` and the ``sweep=False`` apply — on the
   Section IV-D random sensor network at n = 16384 sensors, the SGWT union
   with J = 6 (eta = 7), K = 20, on a batch of 64 signals, and holds every
   output against the port's float64 ``plan("dense")`` on the card;
4. times the whole-recurrence sweep against the per-order path on both
   sides of the sweep's L2 budget;
5. drives the Section-V solvers (`plan.solve`, all four methods, in the
   Fig. 2 settings (a) P = L_norm, r = 1, 20 rounds and (b) P = L, r = 2,
   10 rounds of Jacobi), the per-round path (``history=True``) and the
   divergence guard (``check_every=7``), the wavelet lasso
   (`plan.solve_lasso`, 20 ISTA iterations, mu 0.01 / 0.75) and the
   Section III-D classifier (`semi_supervised_classify` with 4 quadrant
   classes, 10% labeled) at the same n and batch, each against float64
   dense on the card;
6. holds the bf16 mode of both sweeps (``plan("cuda",
   sweep_dtype="bf16")``: `apply` and the Jacobi `solve` in setting (a))
   against float64 dense, and each bf16 sweep kernel against its plain
   bf16 version;
7. drives the dense LM forward of starcoder2-3b at its full width and
   depth (30 layers, d_model 3072, 24 query and 2 KV heads of 128) on
   B = 2 sequences of S = 4096 tokens in bf16, weights drawn from a
   seeded torch.Generator, with ``RunConfig(attn_impl="flash")``: one
   launch of the bf16 tensor-core flash kernel per layer.  Its logits and
   loss are held against the same forward whose attention is the plain
   f32 version; a reduced f32 forward (two layers, S = 1000) takes the
   FFMA flash kernel and is held against the materialised attention.
   The tensor-core kernel is held against its plain version at the layer
   shape and a ragged S = 1000, the FFMA kernel at a small and a ragged
   f32 shape and at head dims 80 and 256 (B 1, 8 / 2 heads, S = 1000, f32),
   and the FFMA kernel's ragged shape is read for what holds it (registers,
   shared memory and blocks per SM, its grid against the SMs, its time at
   S = 4096, the SM clock while it runs);
   `scaled_dot_product_attention` is timed beside each as the
   library yardstick (the port never calls it);
8. drives the sharded apply (``plan("cuda_halo")`` and friends) at the
   same n, K and batch: a 1-shard ``cuda_halo`` plan without a process
   group (`apply`, one `cheb_sweep` launch; a Jacobi solve, one
   `jacobi_sweep` launch), then 4 ranks on the one card, spawned from this
   script, in a gloo group whose tiles are staged through pinned host
   memory: ``cuda_halo`` `apply`, `apply_adjoint`, `apply_gram` and a
   Jacobi `solve` (the per-order `sliced_ell_spmv` and `cheb_step` /
   `jacobi_step` launches around the ring exchange), ``halo`` and
   ``allgather`` `apply`.  Every rank holds its outputs against float64
   dense, its counted rounds against K and 2K (the paper messages,
   2|E| per round, follow from them), and its counted bytes against the
   byte models in ``plan.info`` (``halo_bytes_per_apply`` and
   ``_per_adjoint``, ``gather_bytes_per_apply``);
9. drives the general partitions (edge-cut sharding of an arbitrary sparse
   graph, one tile per ring offset per order, the couplings added by the
   SpMV kernel's rectangular, accumulating launch): (a) on one shard in
   this process, ``plan("cuda_halo", partition=partition_general(L, 1))``
   `apply` (one sweep launch) and a Jacobi solve (one `jacobi_sweep`
   launch); (b) in the 4-rank group, ``partition="general"`` (BFS order)
   on ``cuda_halo`` `apply` and Jacobi solve and on ``halo`` `apply`;
   (c) in the same group, the million-vertex community graph of the JAX
   package's ``bench_scaling.py --graph community`` (P never densified),
   partitioned once here by spectral bisection and read by every rank:
   ``cuda_halo`` `apply`, `apply_gram` and `apply_adjoint` on B = 16
   signals, each rank checking more than two offsets, K / 2K rounds, the
   partition's bytes, its launches and the float64 oracle (the ``dense``
   plan over the CSR's matvec) on the first 4 signals; rank 0 holds the
   coupling launch against its plain version at that shape;
10. drives the compressed exchange, the link faults and gossip in the
   same 4-rank group: (1) in this process, the wire codec
   (`dist.quantize`) on the card against the port on the CPU, byte for
   byte, on a (64, 327) and a (16, 22086) tile (the banded h and the
   community graph's widest offset), its round-trip error and its time;
   (2) ``cuda_halo`` `apply` at the f32, bf16 and int8 wires on the banded
   and the BFS general partition of the sensor graph, against float64 dense
   at the reference's gates, with K (2K Gram) rounds, the byte models at
   the wire dtype and the f32 launches, and a bf16-wire Jacobi solve (a)
   against the f32 one; (3) the community graph's `apply` at every wire
   against its oracle, its bytes per round at B = 1 (243672, 121836,
   60930) and the exchange alone per round on each wire; (4) link faults
   (`fault_spec=`): an inactive spec is the clean plan bit for bit, the
   active spec repeats its bits on fresh plans and changes them for
   another seed or hold_last at the clean plan's rounds and bytes, the
   faulted `cuda_halo` output on the card equals the `halo` plan's on the
   CPU of the same ranks, and the ladder of benchmarks/bench_faults.py
   (means over 8 seeds) keeps its shape; (5) `gossip_mean_tree` over one
   layer of starcoder2-3b's parameter shapes (~96 M f32 values per rank)
   against all_reduce, clean, quantized and under the mild spec, its
   rounds and `cheb_step` launches, and `cheb_step` at the largest leaf
   against its plain version;
11. serves the main path (`repro_torch.serve`): (a) in this process, a
   `ServeEngine` over the cuda plan above with the default buckets
   (1, 8, 64), max_wait 5 ms and the reference's DEFAULT_MIX (80%
   `apply`, 20% Jacobi `solve`, tau 0.5, 8 rounds); every entry
   (`apply`, `apply_adjoint`, `apply_gram`, the solve) is captured as
   one CUDA graph per bucket (`dist.capture`), each replay equal to the
   eager call bit for bit and timed beside it and under the profiler
   (three replays: the hand-written kernels, no host-to-device copy); a
   virtual-clock
   replay of 512 Poisson requests at 20000 /s (every row its bucket's
   direct call bit for bit, float64 dense within 1e-4, exactly once)
   and wall-clock replays at 1000, 10000 and 50000 requests /s (p50 /
   p99, signals /s, occupancy, padding; exactly once, occupancy >= 2 at
   the top rate); (b) in the 4-rank group, one engine per rank over
   ``cuda_halo`` (eager: its exchange runs through the host): 64
   submits make one batch of K counted rounds and 64 x
   ``halo_bytes_per_apply`` bytes, bit for bit the direct call, float64
   dense within 1e-4, a faulted plan beside the clean one never sharing
   a batch, and a wall-clock engine over the group refused;
12. checks the invariants (`repro_torch.analysis`): `check_plan` over
   the cuda and dense plans above (apply, adjoint, Gram, the Chebyshev,
   Jacobi and Chebyshev-Jacobi solves, at B = 1 and 64: exchange
   bijection and schedule, sweep launches under the L2 model, no float64
   or width mix on a steady call, no TF32), the same over the sharded
   plans on the 4 ranks (banded and BFS general, the Jacobi solve) with
   the fault schedule of cuda_halo int8 under the active spec, and the
   AST lint over the tree; one `invariants` line, every finding
   allowlisted;
13. runs the paper's own workload, SENSOR500 (n = 500), through the
   port's three examples' `main` on the card — the Section IV-D Tikhonov
   denoising, the Section VI wavelet lasso (lasso_K, lasso_iters, both
   mu) and the Section III-D classifier on a two-cluster graph — each
   held against float64 dense on the card;
14. shows through the kernels' launch counters that every path ran through
   its kernels: each path is driven once with the counts set to 0 just
   before it and read just after (a replayed graph launches without its
   wrappers: the served launches are each capture's launches times its
   replays, `served_launches`).

Kernel times are CUDA events around back-to-back calls of each wrapper
(``ms``) and, where torch.profiler traces the card, the device time per
launch (``device_ms``; for a library call, ``library_device_ms``, the
device time of all its kernels).  It prints one JSON line
``{"paths": [...]}``, the card's name and power limit, one JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
Any failed check raises and exits non-zero without the last line.  It needs no network,
imports nothing of JAX, and has no CPU fallback: without a card (or
outside a checkout) it exits with code 2.  Every process it starts is
waited for (the spawn's resource tracker too), and it checks that none
is left before it prints its results.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional
from unittest import mock

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
# Section-V settings (Fig. 2): tau, rounds; the lasso weights of Section VI
# (0.01 on the scaling function, 0.75 on the wavelets); the SSL classes.
TAU = 0.5
ROUNDS_A, ROUNDS_B, LASSO_ITERS = 20, 10, 20
MU = [0.01] + [0.75] * J
N_CLASSES, LABELED = 4, 0.10
# The bf16 sweep mode: kernel vs its plain bf16 version and every bf16
# path vs float64 dense, at the JAX package's bf16 sweep tolerance
# (tests/test_sweep.py:120,141): 8-bit mantissas over 20 orders / rounds.
TOL_BF16 = 3e-2
# The LM forward: starcoder2-3b at full width and depth, B x S tokens.
LM_ARCH, LM_B, LM_S = "starcoder2-3b", 2, 4096
# Flash kernel vs plain version: the JAX package's kernel tolerances
# (tests/test_kernels.py:69), atol = rtol; bf16 outputs round to 8 bits.
TOL_FLASH = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The bf16 tensor-core kernel is also held row by row, where atol = 2e-2
# cannot see a fault: a late row of causal attention over random inputs
# averages thousands of values, so its outputs are ~0.8 sqrt(e / (i + 1))
# (0.02 at row 4095).  Against the plain version in f32 from the same
# bf16 inputs, each element's error less its output rounding (2^-8 of
# |ref|) over its row's rms must stay under TOL_FLASH_ROW: rounding P to
# bf16 moves single elements by up to ~1e-2 of the rms.  Dropping one K
# tile of 128 keys from the last 128 rows at S = 4096 moves them by ~0.2
# of the rms (single elements by more); the script checks that the
# statistic sees that at FLASH_FAULT_MARGIN times the limit.
TOL_FLASH_ROW = 2e-2
FLASH_FAULT_MARGIN = 10
# Device ms of the FFMA flash kernel at the ragged f32 shape before its
# redesign, printed beside this run's time (not measured here: PERF.md's
# kernel table, NVIDIA H100 80GB HBM3, 700 W).
FLASH_EARLIER_DEVICE_MS = {"ragged_f32": 0.2942}
# LM logits / loss against the same bf16 forward through the plain f32
# attention: the two attentions round their outputs to bf16 after summing
# in other orders, so single elements differ by a bf16 ulp, and 30
# residual layers of bf16 products carry those differences to the logits.
# A mask or head-mapping fault moves the logits by O(1).
TOL_LM_LOGITS = 5e-2     # max |d logits| / max |logits|
TOL_LM_LOSS = 1e-2       # |d loss| (the loss is ~ln 49152 = 10.8)
# The reduced f32 forward against the same forward through the
# materialised attention: f32 sums in another order over two layers.
TOL_LM_F32 = 1e-4
# H100 SXM bf16 tensor-core peak (dense): the bound of bf16 work.
PEAK_BF16_FLOPS = 989e12
# Per-round final iterate vs the sweep's (the same f32 arithmetic, P h
# products in another grouping); the guarded solve vs the unguarded one
# (the same kernel launches in chunks); SSL predictions are compared where
# the top two float64 scores differ by more than PRED_MARGIN.
TOL_ROUNDS = 1e-5
TOL_GUARD = 1e-6
PRED_MARGIN = 1e-3

# The sweeps' device ms per launch when they multiplied the (8, 128)
# Block-ELL tile, as PERF.md records them for an H100 80GB HBM3 at 700 W.
# Printed as quoted text on a line of its own, never in the kernels line:
# this run does not measure them.
EARLIER_SWEEPS = ("quoted from PERF.md, not measured in this run: the "
                  "Block-ELL tile sweeps took, in device ms per launch, "
                  "cheb_sweep 8.5809, cheb_sweep bf16 8.6630, jacobi_sweep "
                  "8.0820 in setting (a) and 8.0662 in (b), jacobi_sweep "
                  "bf16 7.9574 (H100 80GB HBM3, 700 W)")

# The sharded phase: ranks on the one card, gloo with host-staged tiles;
# every line it prints carries this label (these are not NCCL numbers).
SHARDS = 4
SHARD_LABEL = f"gloo, host-staged, {SHARDS} ranks on one card"
# Its general-partition phase at full size: the top point of the JAX
# package's `benchmarks/bench_scaling.py --graph community` (1e6 vertices,
# seed 0), partitioned once by spectral bisection in (8, 8) blocks (what
# `bench_scaling.py:_auto_block` picks above n = 20000); the SGWT union
# at J and K as above on B = 16 signals, and a float64 oracle on the first
# ORACLE_SIGNALS of them.
COMMUNITY_N = 1_000_000
COMMUNITY_BLOCK = (8, 8)
COMMUNITY_B = 16
ORACLE_SIGNALS = 4
# The compressed exchange (`exchange_dtype=`): every wire against float64
# dense, f32 at TOL_PATH and bf16 within 5e-3 (the reference's gate,
# tests/test_exchange_dtype.py:132-135); a bf16 Jacobi solve within 5e-2
# of the f32 one (:196-202).  int8 (with error feedback) within 10x
# bf16's error, the reference's gate on its BENCH_comm.json setup, but
# on the sensor graph's BFS general partition within 12x: the first run
# on an H100 read 10.58x there and the gate was loosened after that
# failure.  On this script's own signals (saved with
# ``--save-wire-signal``) the reference reads 10.58x too
# (tests/test_torch_wire_ratio.py, slow): the ratio is the graph's and
# the draw's.  Cut to n = 2048 the port's ratio is the reference's within
# 1% (tests/test_torch_quantize.py).  The codec on the
# card against the port on the CPU, byte for byte, at the banded h and the
# community graph's widest offset; its round trip within half an int8
# level of the row's max-abs, and 2e-2 for bf16 (:39-62).
WIRES = ("f32", "bf16", "int8")
TOL_WIRE_BF16 = 5e-3
INT8_OVER_BF16 = 10
INT8_OVER_BF16_SENSOR_GENERAL = 12
TOL_WIRE_SOLVE = 5e-2
CODEC_TILES = ((BATCH, 327), (COMMUNITY_B, 22086))
# At B = 1 one round of the community plan ships sum(h_k) = 60918 entries:
# 4 bytes each (f32), 2 (bf16), 1 + a 4-byte scale per offset (int8).
COMMUNITY_WIRE_BYTES = {"f32": 243672, "bf16": 121836, "int8": 60930}
# Link faults (`fault_spec=`): the active spec of tests/test_faults.py:171,
# its mild one (:237, bounded gossip), the card against the CPU on the
# BENCH_faults.json setup (n = 256, half-band 8, K = 10) to 1e-5 at both
# wires; the ladder of benchmarks/bench_faults.py with the means over
# LADDER_SEEDS seeds.
FAULT_ARGS = dict(drop_prob=0.2, stale_prob=0.1, noise_prob=0.05, seed=3)
MILD_ARGS = dict(drop_prob=0.05, stale_prob=0.05, noise_prob=0.05, seed=3)
SMALL_N, SMALL_BW, SMALL_K = 256, 8, 10
TOL_FAULT_CPU = 1e-5
LADDER_PROBS = (0.0, 0.01, 0.05, 0.2)
LADDER_SEEDS = 8
LADDER_SOLVE_ROUNDS = 12
# Gossip over one layer of starcoder2-3b's parameters in f32 per rank
# (~96 M values, the leaves `--dp-mode gossip` averages), against
# all_reduce / world; quantized within 5e-2 (tests/test_gossip.py:51); the
# mild spec bounded under 1.0 of the mean's max (tests/test_faults.py:240).
TOL_GOSSIP = 1e-5
TOL_GOSSIP_Q = 5e-2
GOSSIP_MILD_BOUND = 1.0
# Serving (`repro_torch.serve`) over the main path's cuda plan: the
# engine's default buckets (1, 8, 64) and max_wait, the reference's
# DEFAULT_MIX (80% apply, 20% Jacobi solve at tau 0.5, 8 rounds); a
# virtual-clock replay of SERVE_VIRTUAL Poisson requests at
# SERVE_VIRTUAL_RATE; wall-clock replays at SERVE_RATES, SERVE_WALL
# requests each (the protocol of the JAX package's
# benchmarks/bench_serving.py, its rates 200 / 1000 / 4000 scaled to the
# card), held to its --check-occupancy default at the top rate.
SERVE_MAX_WAIT = 0.005
SERVE_VIRTUAL, SERVE_VIRTUAL_RATE = 512, 20000.0
SERVE_RATES, SERVE_WALL = (1000.0, 10000.0, 50000.0), 2000
SERVE_MIN_OCCUPANCY = 2.0
TRACE_REPLAYS = 3
# The invariants phase (`repro_torch.analysis`): the run-time checks of
# `check_plan` over the graph smoke shape's cuda and dense plans at B = 1
# and 64 with three solves, on the 4 ranks over cuda_halo, halo and
# allgather (banded) and cuda_halo and halo (BFS general) with the Jacobi
# solve, and `check_fault_schedule` on cuda_halo int8 under FAULT_ARGS;
# then the AST layer over the tree.  Every finding must be allowlisted
# (src/repro_torch/analysis/lint_allowlist.txt).
INV_BATCHES = (1, BATCH)
INV_SOLVES = ("chebyshev", "jacobi", "cheb_jacobi")
INV_SHARDED_SOLVES = ("jacobi",)

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


def device_ms(fn, iters: int, kernel: str):
    """Mean device time per launch of the CUDA kernels whose name contains
    `kernel`, from a torch.profiler trace of `iters` calls (the events of
    `time_ms` also hold the host's enqueue gaps between back-to-back
    calls).  None when the trace holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if kernel in e.key]
    except (RuntimeError, AssertionError) as exc:  # cannot trace the card
        print(f"profiler: no trace for {kernel}: {exc}")
        return None
    total = sum(getattr(e, "device_time_total", 0.0) for e in rows)
    count = sum(e.count for e in rows)
    return total / count / 1e3 if count and total > 0 else None


def all_device_ms(fn, iters: int):
    """Mean device time per call of every CUDA kernel that `fn` launches,
    from a torch.profiler trace of `iters` calls: the library yardsticks,
    whose kernels' names are the library's.  None when the trace holds no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    except (RuntimeError, AssertionError) as exc:  # cannot trace the card
        print(f"profiler: no trace: {exc}")
        return None
    return total / iters / 1e3 if total > 0 else None


def device_breakdown(fn, groups):
    """One call of `fn` under torch.profiler: the device time of its
    kernels by group (the first of `groups`, name -> substrings, that
    matches a kernel's name, else "other"), their sum and its share of
    the call's wall time.  None when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = dict.fromkeys(list(groups) + ["other"], 0.0)
    for e in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        if ms <= 0:
            continue
        key = e.key.lower()
        out[next((g for g, subs in groups.items()
                  if any(x in key for x in subs)), "other")] += ms
    busy = sum(out.values())
    if busy <= 0:
        return None
    return dict(out, device_ms=busy, wall_ms=wall_ms, busy_share=busy / wall_ms)


def flash_row_err(got, ref32, rms) -> float:
    """max over elements of (|got - ref32| - 2^-8 |ref32|) / the rms of
    ref32's row: bf16 output error beyond its own rounding, on the scale
    of its row."""
    err = (got.float() - ref32).abs() - 2.0**-8 * ref32.abs()
    return float((err / rms).max())


def attention_dropping_a_tile(q, k, v):
    """Causal attention (f32, 1 / sqrt(D)) for the last 128 q rows that
    skips the K tile of keys S - 256 .. S - 129, rounded to bf16: the
    output of a kernel that drops one tile for late rows."""
    S, d = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, -128:].float(), kk)
    rows = torch.arange(S - 128, S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    skip = (cols > rows) | ((cols >= S - 256) & (cols < S - 128))
    p = torch.softmax((s / math.sqrt(d)).masked_fill(skip, -1e30), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations over `peak` (default the f32 peak)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _stop_resource_tracker() -> None:
    """Stop and reap the resource tracker that a spawn starts: the
    multiprocessing module keeps one per parent, running until the parent
    exits, so without this it would outlive the script by a moment."""
    from multiprocessing import resource_tracker
    resource_tracker._resource_tracker._stop()


def _children() -> list:
    """The command lines of this process's children that are not reaped
    yet, running or not."""
    pids = [pid for f in Path("/proc/self/task").glob("*/children")
            for pid in f.read_text().split()]
    out = []
    for pid in pids:
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
        except OSError:
            cmd = b""
        out.append(pid + ": " + cmd.replace(b"\0", b" ").decode().strip())
    return out


def rel_check(got, ref, tol: float, what: str):
    """Print and check max |got - ref| / max |ref| <= tol."""
    check(tuple(got.shape) == tuple(ref.shape),
          f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    err, rel = rel_err(got, ref)
    print(f"  {what}: max_abs_err={err:.3e} rel={rel:.3e} (tol {tol})")
    check(rel <= tol, f"{what}: rel err {rel:.3e} > {tol}")
    return err, rel


def _sharded_rank(rank: int, world: int, tmp: str,
                  save_wire_signal: Optional[str] = None) -> None:
    """One rank of the sharded phase, spawned by :func:`main`.  It builds
    the smoke graph from the seed, keeps its own shard, runs every sharded
    path with the others, then the community graph's general plan from
    the partition the parent left in `tmp`; it checks what it saw and
    writes it to ``<tmp>/rank<rank>.json``.  A failed check raises, which
    fails the spawn and the script.  With `save_wire_signal`, rank 0 also
    saves the signals of the compressed-exchange phase there (.npy)."""
    import os
    from datetime import timedelta

    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    try:
        out = _sharded_checks(rank, world, save_wire_signal)
        torch.cuda.empty_cache()
        out["community"] = _community_checks(rank, world, tmp)
        torch.cuda.empty_cache()
        out["small_faults"] = _small_fault_checks(rank, world)
        out["gossip"] = _gossip_checks(rank, world)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _sharded_checks(rank: int, world: int,
                    save_wire_signal: Optional[str] = None) -> dict:
    import torch.distributed as dist

    from repro_torch.core import filters, graph, wavelets
    from repro_torch.dist import GraphOperator, comm, plan_comm_stats

    counters = _graph_counters()
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    g = graph.connected_sensor_graph(rng, n=N, theta=THETA, kappa=KAPPA)
    g, _ = graph.spatial_sort(g)
    L, L_norm = g.laplacian(), g.laplacian("normalized")
    lmax, n_edges = g.lambda_max_bound(), g.n_edges
    del g
    op = wavelets.sgwt_operator(L, lmax, J=J, K=K)
    ssl_mult = [filters.ssl_multiplier(filters.power_kernel(1), TAU)]
    op_n = GraphOperator(P=L_norm, multipliers=ssl_mult, lmax=2.0, K=K)
    plans = {b: op.plan(b) for b in ("cuda_halo", "halo", "allgather")}
    plan_n = op_n.plan("cuda_halo")
    # (b) the general partition in its string form: each rank orders the
    # graph by BFS and keeps its own shard and couplings
    gen_plans = {b: op.plan(b, partition="general")
                 for b in ("cuda_halo", "halo")}
    gen_n = op_n.plan("cuda_halo", partition="general")
    for p in (*plans.values(), plan_n, *gen_plans.values(), gen_n):
        check(p.info["n_shards"] == world and p.info["rank"] == rank
              and p.info["transport"] == "gloo-host-staged",
              f"{p.backend} plan info {p.info}")
    h = plans["cuda_halo"].info["halo_width"]
    check(plans["halo"].info["halo_width"] == h
          and plans["cuda_halo"].info["partition_leak"] == 0.0,
          "the strip-sorted graph must be leak-free under the split")
    # B = 1: the boundary tile both ways per round (eta streams in the
    # adjoint), K rounds, every shard; allgather: each rank's (nl,)
    # iterate per round.  The byte models in plan.info are the counts.
    for name in ("cuda_halo", "halo"):
        st = plan_comm_stats(plans[name])
        info = plans[name].info
        check(st["apply"].exchange_rounds == K
              and st["apply"].bytes_per_round == 2 * h * 4
              and st["apply"].total_bytes == info["halo_bytes_per_apply"]
              and st["apply_adjoint"].total_bytes
              == info["halo_bytes_per_adjoint"],
              f"{name} bytes at B=1: {st['apply'].summary()}, "
              f"{st['apply_adjoint'].summary()}")
    st = plan_comm_stats(plans["allgather"])["apply"]
    check(st.exchange_rounds == K and st.total_bytes
          == plans["allgather"].info["gather_bytes_per_apply"],
          f"allgather bytes at B=1: {st.summary()}")
    # the general plans: one tile per offset per round, 4 sum(h_k) bytes
    # at B = 1, the partition's byte model in plan.info
    ginfo = gen_plans["cuda_halo"].info
    offsets = ginfo["partition_offsets"]
    for name, p in gen_plans.items():
        _check_general_bytes(f"{name}[general]", plan_comm_stats(p), p.info,
                             K)
    check(gen_plans["halo"].info["partition_fingerprint"]
          == ginfo["partition_fingerprint"],
          "halo and cuda_halo must take the same general partition")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    F = torch.randn(BATCH, N, generator=gen, device=dev)
    if save_wire_signal and rank == 0:
        np.save(save_wire_signal, F.cpu().numpy())
    a = torch.randn(BATCH, J + 1, N, generator=gen, device=dev)
    Y = torch.randn(BATCH, N, generator=gen, device=dev)
    dense = GraphOperator(P=L.double(), multipliers=op.multipliers,
                          lmax=lmax, K=K).plan("dense")
    dense_n = GraphOperator(P=L_norm.double(), multipliers=ssl_mult,
                            lmax=2.0, K=K).plan("dense")
    # the compressed wires and the faults run on one partition each,
    # built here once
    from repro_torch.dist.backends.cuda_halo import partition_block_ell
    from repro_torch.dist.partition import resolve_partition_arg

    wparts = {"banded": partition_block_ell(L.float(), world)[0],
              "general": resolve_partition_arg(op, "general", world)}
    nparts = partition_block_ell(L_norm.float(), world)[0]
    del L, L_norm
    kw_a = dict(tau=TAU, r=1, n_iters=ROUNDS_A)
    ch = plans["cuda_halo"]
    gch = gen_plans["cuda_halo"]
    # a general round's coupling launch: one per SpMV when any edge is cut
    couple, couple_n = ({"sliced_ell_spmv_accumulate": 1} if p.info[
        "partition_offsets"] else {} for p in (gch, gen_n))
    # name, call, reference, rounds, kernel launches, ppermutes per round
    # (the plan's exchange_collectives_per_round)
    ring, gen_pp = comm.DIRECTIONS_PER_ROUND, len(offsets)
    paths = [
        ("cuda_halo apply", lambda: ch.apply(F),
         lambda: dense.apply(F.double()), K,
         {"sliced_ell_spmv": K, "cheb_step": K - 1}, ring),
        ("cuda_halo apply_adjoint", lambda: ch.apply_adjoint(a),
         lambda: dense.apply_adjoint(a.double()), K, {"sliced_ell_spmv": K},
         ring),
        ("cuda_halo apply_gram", lambda: ch.apply_gram(F),
         lambda: dense.apply_gram(F.double()), 2 * K,
         {"sliced_ell_spmv": 2 * K, "cheb_step": 2 * K - 1}, ring),
        ("cuda_halo solve[jacobi] (a)",
         lambda: plan_n.solve(Y, "jacobi", **kw_a).x,
         lambda: dense_n.solve(Y.double(), "jacobi", **kw_a).x, ROUNDS_A,
         {"sliced_ell_spmv": ROUNDS_A, "jacobi_step": ROUNDS_A}, ring),
        ("halo apply", lambda: plans["halo"].apply(F),
         lambda: dense.apply(F.double()), K, {}, ring),
        ("allgather apply", lambda: plans["allgather"].apply(F),
         lambda: dense.apply(F.double()), K, {}, ring),
        ("cuda_halo[general] apply", lambda: gch.apply(F),
         lambda: dense.apply(F.double()), K,
         _times({"sliced_ell_spmv": 1, **couple}, K, cheb_step=K - 1),
         gen_pp),
        ("cuda_halo[general] solve[jacobi] (a)",
         lambda: gen_n.solve(Y, "jacobi", **kw_a).x,
         lambda: dense_n.solve(Y.double(), "jacobi", **kw_a).x, ROUNDS_A,
         _times({"sliced_ell_spmv": 1, "jacobi_step": 1, **couple_n},
                ROUNDS_A), gen_n.info["exchange_collectives_per_round"]),
        ("halo[general] apply", lambda: gen_plans["halo"].apply(F),
         lambda: dense.apply(F.double()), K, {}, gen_pp),
    ]
    rows = []
    for name, call, ref_fn, rounds, expect, per_round in paths:
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        with comm.counting() as rec:
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
        counts = {k.__name__: k.launches for k in counters if k.launches}
        check(counts == expect, f"{name} on rank {rank}: launches {counts}, "
              f"expected {expect}")
        # paper messages are the counted rounds x 2|E|: the rounds are
        # what is measured
        st = rec.stats(world, BATCH, per_round)
        check(st.exchange_rounds == rounds,
              f"{name} on rank {rank}: {st.exchange_rounds} rounds; "
              f"expected {rounds}")
        err, rel = rel_err(out, ref_fn())
        check(rel <= TOL_PATH, f"{name} on rank {rank}: rel err {rel:.3e}")
        iters = 3
        with comm.counting() as steady:
            ms = time_ms(call, iters, warmup=1)
        calls = iters + 1
        rows.append(dict(name=name, launches=counts,
                         rounds=st.exchange_rounds,
                         messages=st.paper_messages(n_edges),
                         bytes_per_round=st.bytes_per_round,
                         max_abs_err=err, rel_err=rel, first_ms=first,
                         steady_ms=ms,
                         exchange_wait_ms=steady.wait_s * 1e3 / calls,
                         exchange_post_ms=steady.post_s * 1e3 / calls,
                         assembly_ms=steady.assembly_s * 1e3 / calls))
    # where the time of the cuda_halo apply goes: the exchange alone (K
    # rounds of one (B, h) tile each way, no compute) and, on rank 0, one
    # apply under torch.profiler (the other ranks run it beside)
    tile = F[:, :h].contiguous()
    exchange_ms = _exchange_only_ms([tile, tile], (1, -1))
    profile = _profile_call(ch.apply, F) if rank == 0 else None
    if rank != 0:
        ch.apply(F)
        torch.cuda.synchronize()
    wires = _wire_checks(rank, world, op, op_n, wparts, nparts, dense, F, Y,
                         plan_n, kw_a)
    faulted = _fault_checks(rank, world, op, wparts, F)
    serving = _serving_rank(rank, world, op, wparts["banded"], dense)
    invariants = _invariant_checks(op, plans, gen_plans, wparts)
    return dict(rank=rank, halo_width=h, n_edges=n_edges, paths=rows,
                wires=wires, faults=faulted, serving=serving,
                invariants=invariants,
                exchange_only_ms_per_round=exchange_ms, profile=profile,
                general=dict(offsets=list(offsets),
                             tile_widths=list(ginfo["partition_tile_widths"]),
                             edge_cut=ginfo["edge_cut"],
                             method=ginfo["partition_method"]))


def _finding_rows(findings) -> list:
    return [dict(rule=f.rule, path=f.path, line=f.line, symbol=f.symbol,
                 message=f.message) for f in findings]


def _invariant_checks(op, plans, gen_plans, wparts) -> dict:
    """The invariants phase on one rank (every rank calls it together):
    `check_plan` over the sharded plans, `check_fault_schedule` on
    cuda_halo int8 with and without FAULT_ARGS; their findings, the calls
    run and the kernel launches they made."""
    from repro_torch.analysis import check_fault_schedule, check_plan
    from repro_torch.dist import FaultSpec

    t0 = time.perf_counter()
    counters = _graph_counters()
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    report, findings, checked = {}, [], []
    targets = [(f"{b}[banded]", p) for b, p in plans.items()] + [
        (f"{b}[general]", p) for b, p in gen_plans.items()]
    for label, p in targets:
        findings += check_plan(p, n=N, batches=INV_BATCHES,
                               solve_methods=INV_SHARDED_SOLVES,
                               report=report)
        checked.append(label)
    clean = op.plan("cuda_halo", partition=wparts["banded"],
                    exchange_dtype="int8")
    faulted = op.plan("cuda_halo", partition=wparts["banded"],
                      exchange_dtype="int8",
                      fault_spec=FaultSpec(**FAULT_ARGS))
    findings += check_fault_schedule(clean, faulted, n=N,
                                     solve_methods=INV_SHARDED_SOLVES)
    checked.append(f"fault schedule cuda_halo[banded, int8] "
                   f"{faulted.info['fault_key']}")
    torch.cuda.synchronize()
    return dict(findings=_finding_rows(findings), checked=checked,
                calls=report.get("calls", 0),
                launches={k.__name__: k.launches for k in counters
                          if k.launches},
                seconds=time.perf_counter() - t0)


def _serving_rank(rank: int, world: int, op, parts, dense) -> dict:
    """(b) of the serving phase, on one rank of the group: a virtual-clock
    engine over `cuda_halo` (eager by the capture rule: its exchange goes
    through the host) coalesces BATCH submits into one batch of K counted
    rounds and `halo_bytes_per_apply` x BATCH bytes, whose rows equal the
    direct call bit for bit and float64 dense within TOL_PATH; a plan
    under FAULT_ARGS registered beside the clean one never shares its
    batches, and its labels carry the reference's fault key; a wall-clock
    engine over the group raises."""
    from repro_torch.dist import FaultSpec, comm
    from repro_torch.serve import (DEFAULT_BUCKETS, ServeEngine,
                                   VirtualClock, WallClock)

    dev = torch.device("cuda")
    counters = _graph_counters()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    X = torch.randn(BATCH, N, generator=gen, device=dev)
    plan = op.plan("cuda_halo", partition=parts)
    check(plan.compiled("apply").mode == "eager",
          "the sharded entries are eager by the capture rule")
    eng = ServeEngine(plan, buckets=DEFAULT_BUCKETS, max_wait=SERVE_MAX_WAIT,
                      clock=VirtualClock(), sync_results=False)
    per_round = plan.info["exchange_collectives_per_round"]
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    with comm.counting() as rec:
        t0 = time.perf_counter()
        futs = [eng.submit(x) for x in X]
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
    counts = {k.__name__: k.launches for k in counters if k.launches}
    st = rec.stats(world, BATCH, per_round)
    batches = [(b.bucket, b.occupancy) for b in eng.metrics.batches]
    check(all(f.done() for f in futs) and batches == [(BATCH, BATCH)],
          f"serving on rank {rank}: batches {batches}")
    check(st.exchange_rounds == K
          and st.total_bytes == BATCH * plan.info["halo_bytes_per_apply"],
          f"serving on rank {rank}: {st.exchange_rounds} rounds, "
          f"{st.total_bytes} bytes; expected {K} and "
          f"{BATCH * plan.info['halo_bytes_per_apply']}")
    check(counts == {"sliced_ell_spmv": K, "cheb_step": K - 1},
          f"serving on rank {rank}: launches {counts}")
    rows = torch.stack([f.result() for f in futs])
    check(bool(torch.equal(rows, plan.compiled("apply")(X))),
          f"serving on rank {rank}: served rows differ from the direct call")
    err, rel = rel_err(rows, dense.apply(X.double()))
    check(rel <= TOL_PATH, f"serving on rank {rank}: rel err {rel:.3e}")
    try:
        ServeEngine(plan, clock=WallClock())
        wall = None
    except ValueError as exc:
        wall = str(exc)
    check(wall is not None and "advance_to" in wall,
          f"serving on rank {rank}: a wall-clock engine over the group must "
          "raise")
    faulty = op.plan("cuda_halo", partition=parts,
                     fault_spec=FaultSpec(**FAULT_ARGS))
    both = ServeEngine({"clean": plan, "faulty": faulty},
                       buckets=DEFAULT_BUCKETS, max_wait=SERVE_MAX_WAIT,
                       clock=VirtualClock(), sync_results=False)
    mixed = [both.submit(x, op=("clean", "faulty")[i % 2])
             for i, x in enumerate(X[:16])]
    both.run_until_idle()
    labels = sorted({b.key.label() for b in both.metrics.batches})
    want = sorted([f"clean:apply:order={K}",
                   f"faulty:apply:order={K}:faults="
                   f"{faulty.info['fault_key']}"])
    check(all(f.response.ok for f in mixed) and labels == want
          and all(b.occupancy == 8 for b in both.metrics.batches),
          f"serving on rank {rank}: clean and faulted batches {labels}")
    return dict(batches=batches, rounds=st.exchange_rounds,
                total_bytes=st.total_bytes, launches=counts,
                max_abs_err=err, rel_err=rel, first_ms=first,
                fault_labels=labels)


def _serving_phase(plan, dense, smi: str):
    """(a) of the serving phase, in this process, over the main path's
    cuda plan: warm-up (every apply kind and the mix's Jacobi solve
    captured at each bucket), replay vs eager vs device ms per kind and
    bucket, one replay per kind under torch.profiler, a virtual-clock
    replay of SERVE_VIRTUAL requests checked bit for bit against the
    direct calls and against float64 dense, and the wall-clock replays.
    Returns (the path record, the launches the replays made)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist.capture import kernel_counters
    from repro_torch.serve import (DEFAULT_BUCKETS, ServeEngine,
                                   VirtualClock, WallClock, poisson_arrivals,
                                   replay_virtual, signal_for)
    from repro_torch.serve.loadgen import DEFAULT_MIX

    dev, eta = plan.device, plan.eta
    _, _, method, skw = DEFAULT_MIX[1]
    counters = kernel_counters()
    entries = {"apply": plan.compiled("apply"),
               "apply_adjoint": plan.compiled("apply_adjoint"),
               "apply_gram": plan.compiled("apply_gram"),
               "solve": plan.compiled_solve(method, **skw)}
    eager = {"apply": plan.apply, "apply_adjoint": plan.apply_adjoint,
             "apply_gram": plan.apply_gram,
             "solve": lambda y: plan.solve(y, method, **skw).x}
    expect = {"apply": {"cheb_sweep": 1}, "apply_adjoint":
              {"sliced_ell_spmv": K}, "apply_gram": {"cheb_sweep": 1},
              "solve": {"jacobi_sweep": 1}}
    kernel = {"apply": "cheb_sweep_kernel", "apply_gram":
              "cheb_sweep_kernel", "apply_adjoint": "sliced_ell_spmv_kernel",
              "solve": "jacobi_sweep_kernel"}
    for name, e in entries.items():
        check(e.mode == "graph", f"serving entry {name}: mode {e.mode}; the "
              "capture rule puts every kind of a cuda plan on the card in "
              "a graph")
    # -- warm-up: every capture, the solver setup -------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    warm_eng = ServeEngine(plan, max_wait=SERVE_MAX_WAIT,
                           clock=VirtualClock(), sync_results=False)
    warm_eng.warm()
    plan.bucketed_callables(DEFAULT_BUCKETS,
                            kinds=("apply_adjoint", "apply_gram"),
                            solve_specs=[(method, skw)], warm=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_counts = {k.__name__: k.launches for k in counters if k.launches}
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    held_mib = (torch.cuda.memory_allocated() - base) / 2**20
    print(f"serving warm-up: {warm_s:.2f} s (host clock) for "
          f"{len(DEFAULT_BUCKETS)} buckets x 4 entries, launches {warm_counts}"
          f" (one eager run and one capture each); device memory above the "
          f"plan: peak {peak_mib:.1f} MiB, held by the graphs after "
          f"{held_mib:.1f} MiB ({smi})")
    entry_rows = {}
    for name, e in entries.items():
        caps = {str(key[0][0]): n for key, n in e.captures.items()}
        ms = {str(key[0][0]): round(v, 3) for key, v in e.capture_ms.items()}
        for key, launched in e.launches.items():
            check(launched == expect[name],
                  f"serving entry {name} {key}: captured launches "
                  f"{launched}, expected {expect[name]}")
        entry_rows[name] = dict(mode=e.mode, captures=caps, capture_ms=ms,
                                launches_per_replay=expect[name])
        print(f"  entry {name}: mode={e.mode}, captures per B {caps}, "
              f"warm-up + capture ms per B {ms}, launches per replay "
              f"{expect[name]}")
    # -- replay vs eager vs device, per kind and bucket --------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    times, traces = [], {}
    for name, e in entries.items():
        for B in DEFAULT_BUCKETS:
            shape = (B, eta, N) if name == "apply_adjoint" else (B, N)
            x = torch.randn(shape, generator=gen, device=dev)
            got, again, want = e(x), e(x), eager[name](x)
            torch.cuda.synchronize()
            check(bool(torch.equal(got, want)) and bool(torch.equal(again,
                                                                    want))
                  and got.data_ptr() != again.data_ptr(),
                  f"serving {name} B={B}: a replay must equal the eager "
                  "call bit for bit and return a new tensor")
            replay_ms = time_ms(lambda: e(x), 20)
            eager_ms = time_ms(lambda: eager[name](x), 10)
            dev_ms = all_device_ms(lambda: e(x), 5)
            times.append(dict(kind=name, B=B, replay_ms=replay_ms,
                              eager_ms=eager_ms, device_ms=dev_ms))
            print(f"  {name} B={B}: replay {replay_ms:.4f} ms, eager plan "
                  f"call {eager_ms:.4f} ms (CUDA events), device "
                  f"{dev_ms} ms per replay (profiler; copy-in and copy-out "
                  f"included) ({smi})")
            if B == DEFAULT_BUCKETS[-1]:
                # CUPTI delivers a replayed graph's kernel records late and
                # has dropped a single replay's (an H100 run traced only
                # its copy-out): trace TRACE_REPLAYS replays in one session
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(TRACE_REPLAYS):
                        e(x)
                    torch.cuda.synchronize()
                names = {}
                for ev in prof.key_averages():
                    if ev.device_type == DeviceType.CUDA:
                        names[ev.key] = names.get(ev.key, 0) + ev.count
                h2d = [k for k in names if "htod" in k.lower().replace(
                    " ", "")]
                check(any(kernel[name] in k for k in names) and not h2d,
                      f"serving {name}: the trace of {TRACE_REPLAYS} replays "
                      f"{names} must show {kernel[name]} and no "
                      "host-to-device copy")
                traces[name] = names
                print(f"  {name} B={B}: {TRACE_REPLAYS} replays under "
                      f"torch.profiler, kernels by count: {names}")
    # -- a virtual-clock replay: bit for bit, float64 dense, exactly once --
    events = poisson_arrivals(SERVE_VIRTUAL_RATE, SERVE_VIRTUAL, seed=SEED)
    eng = ServeEngine(plan, max_wait=SERVE_MAX_WAIT, clock=VirtualClock(),
                      sync_results=False)
    dispatched = []
    route = eng._callable

    def recording(key, group):
        fn = route(key, group)

        def run(batch):
            out = fn(batch)
            dispatched.append((fn, batch, out))
            return out

        return run

    eng._callable = recording
    replays = {name: sum(e.replays.values()) for name, e in entries.items()}
    futs = replay_virtual(eng, events, n=N)
    torch.cuda.synchronize()
    served_launches = {}
    for name, e in entries.items():
        for k, v in expect[name].items():
            served_launches[k] = served_launches.get(k, 0) + v * (
                sum(e.replays.values()) - replays[name])
    s = eng.metrics.summary()
    check(s["served_exactly_once"] and s["n_served"] == SERVE_VIRTUAL
          and all(f.response.ok for f in futs.values()),
          f"virtual replay: {s}")
    for fn, batch, out in dispatched:
        check(bool(torch.equal(fn(batch), out)),
              "virtual replay: a served batch differs from its bucket's "
              "direct compiled call")
    outs = {out.untyped_storage().data_ptr() for _, _, out in dispatched}
    check(all(f.result().untyped_storage().data_ptr() in outs
              for f in futs.values()),
          "virtual replay: a response is not a row of its batch")
    by_kind = {}
    for i, ev in enumerate(events):
        by_kind.setdefault(ev.kind, []).append(i)
    virtual_err = {}
    for kind, idx in by_kind.items():
        X = torch.from_numpy(np.stack([signal_for(events[i], N)
                                       for i in idx])).to(dev)
        got = torch.stack([futs[i].result() for i in idx])
        ref = (dense.apply(X.double()) if kind == "apply"
               else dense.solve(X.double(), method, **skw).x)
        virtual_err[kind] = rel_check(got, ref, TOL_PATH,
                                      f"virtual replay: {len(idx)} served "
                                      f"{kind} rows vs f64 dense")
    vsum = s
    print(f"  virtual replay: {s['n_batches']} batches, mean occupancy "
          f"{s['mean_batch_occupancy']:.2f}, padding waste "
          f"{s['padding_waste']:.3f}, p99 {s['latency_ms']['p99']:.3f} ms "
          f"(virtual clock); launches through the graphs {served_launches}")
    del dispatched, futs
    # -- wall-clock replays at the offered rates ----------------------------
    wall = {}
    for rate in SERVE_RATES:
        events = poisson_arrivals(rate, SERVE_WALL, seed=SEED)
        sigs = torch.from_numpy(np.stack([signal_for(ev, N)
                                          for ev in events])).to(dev)
        before = {name: sum(e.replays.values())
                  for name, e in entries.items()}
        eng = ServeEngine(plan, max_wait=SERVE_MAX_WAIT, clock=WallClock(),
                          sync_results=True)
        start = eng.clock.now()
        for ev, sig in zip(events, sigs):
            target = start + ev.t
            while eng.clock.now() < target:
                if not eng.poll():
                    time.sleep(1e-5)
            eng.submit(sig, kind=ev.kind, method=ev.method, **ev.kwargs())
        while eng.pending_count:
            eng.poll()
            time.sleep(1e-5)
        torch.cuda.synchronize()
        s = eng.metrics.summary()
        for name, e in entries.items():
            for k, v in expect[name].items():
                served_launches[k] += v * (sum(e.replays.values())
                                           - before[name])
        p99 = s["latency_ms"]["p99"]
        check(s["served_exactly_once"] and s["n_served"] == SERVE_WALL
              and p99 is not None and math.isfinite(p99),
              f"wall-clock replay at {rate:g}/s: {s}")
        wall[f"{rate:g}"] = s
        print(f"  wall-clock replay at {rate:g} requests/s ({SERVE_WALL} "
              f"requests): p50 {s['latency_ms']['p50']:.3f} ms, p99 "
              f"{p99:.3f} ms, {s['signals_per_sec']:.1f} signals/s, mean "
              f"occupancy {s['mean_batch_occupancy']:.2f}, padding waste "
              f"{s['padding_waste']:.3f}, {s['n_batches']} batches ({smi})")
        del sigs
    top = wall[f"{SERVE_RATES[-1]:g}"]["mean_batch_occupancy"]
    check(top >= SERVE_MIN_OCCUPANCY,
          f"mean occupancy {top:.2f} < {SERVE_MIN_OCCUPANCY} at the top rate")
    record = dict(name="serving (cuda plan, CUDA graphs)", warm_s=warm_s,
                  warm_launches=warm_counts, graph_peak_mib=peak_mib,
                  graph_held_mib=held_mib, entries=entry_rows, times=times,
                  replay_traces=traces,
                  virtual=dict(summary=vsum,
                               max_abs_err={k: v[0] for k, v in
                                            virtual_err.items()}),
                  wall=wall, served_launches=served_launches)
    return record, served_launches


def _counted(call, counters, world, batch, per_round):
    """One call with every launch count at 0 just before it and read just
    after, under `comm.counting`: (output, launches, stats, first ms)."""
    from repro_torch.dist import comm

    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    with comm.counting() as rec:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
    counts = {k.__name__: k.launches for k in counters if k.launches}
    return out, counts, rec.stats(world, batch, per_round), first


def _wire_checks(rank, world, op, op_n, wparts, nparts, dense, F, Y, plan_n,
                 kw_a) -> dict:
    """Phase 2: `cuda_halo` `apply` at every wire on the banded and the
    BFS general partition of the sensor graph: float64 error at the
    reference's gates, K rounds (2K Gram), the counted bytes at B = 1
    equal to plan.info's byte models at the wire dtype, the f32 plans'
    launches; a bf16 Jacobi solve (a) against the f32 one."""
    from repro_torch.dist import comm, plan_comm_stats

    counters = _graph_counters()
    ref = dense.apply(F.double())
    rows, errs = [], {}
    for part, parts in wparts.items():
        for dt in WIRES:
            plan = op.plan("cuda_halo", partition=parts, exchange_dtype=dt)
            info = plan.info
            per_round = info["exchange_collectives_per_round"]
            expect = {"sliced_ell_spmv": K, "cheb_step": K - 1}
            if part == "general":
                expect["sliced_ell_spmv_accumulate"] = K
            out, counts, st, first = _counted(lambda: plan.apply(F),
                                              counters, world, BATCH,
                                              per_round)
            name = f"cuda_halo[{part}, {dt} wire] apply"
            check(counts == expect, f"{name} on rank {rank}: launches "
                  f"{counts}, expected {expect}")
            check(st.exchange_rounds == K, f"{name}: {st.exchange_rounds} "
                  "rounds")
            err, rel = rel_err(out, ref)
            errs[(part, dt)] = rel
            del out
            _, _, gst, _ = _counted(lambda: plan.apply_gram(F), counters,
                                    world, BATCH, per_round)
            check(gst.exchange_rounds == 2 * K, f"{name}: Gram rounds "
                  f"{gst.exchange_rounds}")
            b1 = plan_comm_stats(plan)
            check(b1["apply"].total_bytes == info["halo_bytes_per_apply"]
                  and b1["apply_adjoint"].total_bytes
                  == info["halo_bytes_per_adjoint"]
                  and info["exchange_dtype"] == dt,
                  f"{name} bytes at B=1: {b1['apply'].summary()}, info "
                  f"{info['halo_bytes_per_apply']}")
            ms = time_ms(lambda: plan.apply(F), 3, warmup=1)
            rows.append(dict(name=name, partition=part, wire=dt,
                             launches=counts, rounds=st.exchange_rounds,
                             gram_rounds=gst.exchange_rounds,
                             bytes_per_round=st.bytes_per_round,
                             bytes_per_round_b1=b1["apply"].bytes_per_round,
                             max_abs_err=err, rel_err=rel, first_ms=first,
                             steady_ms=ms))
            del plan
        check(errs[(part, "f32")] <= TOL_PATH
              and errs[(part, "bf16")] <= TOL_WIRE_BF16
              and errs[(part, "int8")]
              <= (INT8_OVER_BF16_SENSOR_GENERAL if part == "general"
                  else INT8_OVER_BF16) * errs[(part, "bf16")],
              f"{part} wire errors against dense on rank {rank}: {errs}")
    # a Jacobi solve (a) with the bf16 wire against the f32 solve
    plan_b = op_n.plan("cuda_halo", partition=nparts, exchange_dtype="bf16")
    x16, counts, st, first = _counted(
        lambda: plan_b.solve(Y, "jacobi", **kw_a).x, counters, world, BATCH,
        comm.DIRECTIONS_PER_ROUND)
    x32 = plan_n.solve(Y, "jacobi", **kw_a).x
    err, rel = rel_err(x16, x32)
    expect = {"sliced_ell_spmv": ROUNDS_A, "jacobi_step": ROUNDS_A}
    check(counts == expect and st.exchange_rounds == ROUNDS_A
          and rel <= TOL_WIRE_SOLVE,
          f"bf16-wire Jacobi solve on rank {rank}: launches {counts}, "
          f"{st.exchange_rounds} rounds, rel {rel:.3e} vs the f32 solve")
    ms = time_ms(lambda: plan_b.solve(Y, "jacobi", **kw_a), 3, warmup=1)
    rows.append(dict(name="cuda_halo[banded, bf16 wire] solve[jacobi] (a)",
                     partition="banded", wire="bf16", launches=counts,
                     rounds=st.exchange_rounds,
                     bytes_per_round=st.bytes_per_round,
                     max_abs_err=err, rel_err=rel,
                     vs="the f32 solve", first_ms=first, steady_ms=ms))
    ratios = {part: errs[(part, "int8")] / errs[(part, "bf16")]
              for part in wparts}
    return dict(paths=rows, ratios=ratios)


def _fault_checks(rank, world, op, wparts, F) -> dict:
    """Phase 4 on the sensor graph: `cuda_halo` under link faults, banded
    and general.  None and an inactive spec are the clean plan bit for bit;
    the active spec gives the same bits on two fresh plans at f32 and
    int8, another seed or hold_last other bits, a finite result, and the
    clean plan's rounds and bytes per round."""
    from repro_torch.dist import FaultSpec

    counters = _graph_counters()
    spec = FaultSpec(**FAULT_ARGS)
    other = FaultSpec(**dict(FAULT_ARGS, seed=FAULT_ARGS["seed"] + 1))
    rows = []
    for part, parts in wparts.items():
        def build(dt="f32", fault_spec=None, degradation="zero_fill"):
            return op.plan("cuda_halo", partition=parts, exchange_dtype=dt,
                           fault_spec=fault_spec, degradation=degradation)

        clean = build()
        per_round = clean.info["exchange_collectives_per_round"]
        ref = clean.apply(F)
        for null in (None, FaultSpec(seed=99)):
            p0 = build(fault_spec=null, degradation="hold_last")
            check(p0.info["fault_key"] == "none"
                  and bool(torch.equal(p0.apply(F), ref)),
                  f"{part}: fault_spec={null} must be the clean plan bitwise")
        for dt in ("f32", "int8"):
            base = build(dt)
            _, _, cst, _ = _counted(lambda: base.apply(F), counters, world,
                                    BATCH, per_round)
            clean_ms = time_ms(lambda: base.apply(F), 3, warmup=1)
            plan = build(dt, spec)
            runs, counts, fst, first = _counted(
                lambda: [plan.apply(F), build(dt, spec).apply(F)], counters,
                world, BATCH, per_round)
            name = f"cuda_halo[{part}, {dt} wire] apply under faults"
            check(bool(torch.equal(runs[0], runs[1]))
                  and bool(torch.isfinite(runs[0]).all()),
                  f"{name} on rank {rank}: two fresh plans differ or the "
                  "output is not finite")
            check(not torch.equal(build(dt, other).apply(F), runs[0])
                  and not torch.equal(build(dt, spec, "hold_last").apply(F),
                                      runs[0]),
                  f"{name}: another seed or hold_last must change the bits")
            check(fst.exchange_rounds == 2 * K
                  and fst.bytes_per_round == cst.bytes_per_round
                  and cst.exchange_rounds == K,
                  f"{name}: rounds {fst.exchange_rounds} for two calls, "
                  f"bytes per round {fst.bytes_per_round} vs clean "
                  f"{cst.bytes_per_round}")
            ms = time_ms(lambda: plan.apply(F), 3, warmup=1)
            rows.append(dict(name=name, partition=part, wire=dt,
                             fault_key=plan.info["fault_key"],
                             launches={k: v // 2 for k, v in counts.items()},
                             rounds=fst.exchange_rounds // 2,
                             bytes_per_round=fst.bytes_per_round,
                             err_vs_clean=rel_err(runs[0],
                                                  base.apply(F))[1],
                             first_ms=first / 2, steady_ms=ms,
                             clean_steady_ms=clean_ms))
            del runs
    return dict(paths=rows)


def _banded_small():
    """benchmarks/bench_comm.py's banded Laplacian at the BENCH_faults.json
    setup (a numpy copy: n = 256, half-band 8, seed 0), its lmax and the
    four signals."""
    rng = np.random.default_rng(0)
    Bm = np.zeros((SMALL_N, SMALL_N), dtype=np.float32)
    for i in range(SMALL_N):
        lo, hi = max(0, i - SMALL_BW), min(SMALL_N, i + SMALL_BW + 1)
        Bm[i, lo:hi] = rng.standard_normal(hi - lo) * 0.1
    Bm = np.abs(Bm + Bm.T) / 2
    L = np.diag(Bm.sum(1)) - Bm
    x = rng.standard_normal((4, SMALL_N)).astype(np.float32)
    return L, float(2 * Bm.sum(1).max()), x


def _small_fault_checks(rank: int, world: int) -> dict:
    """Phase 4 on the BENCH_faults.json setup: the faulted `cuda_halo`
    apply on the card against the `halo` plan on the CPU of the same
    ranks (the draws are the host's, so the faults are the same), then the
    ladder of benchmarks/bench_faults.py on the card."""
    from repro_torch.dist import DEGRADATIONS, FaultSpec, GraphOperator, comm
    from repro_torch.dist.backends.cuda_halo import partition_block_ell

    L, lmax, x = _banded_small()
    op = GraphOperator(P=torch.from_numpy(L),
                       multipliers=[lambda lam: np.exp(-lam)], lmax=lmax,
                       K=SMALL_K)
    dev = torch.device("cuda")
    xd = torch.from_numpy(x).to(dev)
    spec = FaultSpec(**FAULT_ARGS)
    parts = partition_block_ell(L, world)[0]
    card_vs_cpu = {}
    for dt in ("f32", "int8"):
        card = op.plan("cuda_halo", partition=parts, exchange_dtype=dt,
                       fault_spec=spec).apply(xd)
        cpu = op.plan("halo", device="cpu", exchange_dtype=dt,
                      fault_spec=spec).apply(x)
        err, rel = rel_err(card.cpu(), cpu)
        card_vs_cpu[dt] = rel
        check(rel <= TOL_FAULT_CPU, f"faulted {dt} apply on rank {rank}: "
              f"card vs CPU rel {rel:.3e} > {TOL_FAULT_CPU}")
    counters = _graph_counters()
    launches = dict.fromkeys([k.__name__ for k in counters], 0)
    y = xd[0]
    kw = dict(tau=TAU, n_iters=LADDER_SOLVE_ROUNDS,
              check_every=LADDER_SOLVE_ROUNDS)
    table = {}
    t0 = time.perf_counter()
    for dt in ("f32", "int8"):
        clean = op.plan("cuda_halo", partition=parts, exchange_dtype=dt)
        apply_ref = clean.apply(xd)
        solve_ref = clean.solve(y, "jacobi", tau=TAU,
                                n_iters=LADDER_SOLVE_ROUNDS).x
        for degr in DEGRADATIONS:
            for p in LADDER_PROBS:
                errs = []
                for seed in range(LADDER_SEEDS):
                    plan = op.plan("cuda_halo", partition=parts,
                                   exchange_dtype=dt, degradation=degr,
                                   fault_spec=FaultSpec(drop_prob=p,
                                                        seed=seed))
                    torch.cuda.synchronize()
                    for k in counters:
                        k.launches = 0
                    with comm.counting() as rec:
                        out = plan.apply(xd)
                        res = plan.solve(y, "jacobi", **kw)
                        torch.cuda.synchronize()
                    for k in counters:
                        launches[k.__name__] += k.launches
                    rounds = rec.stats(world, 1, comm.DIRECTIONS_PER_ROUND
                                       ).exchange_rounds
                    check(rounds == SMALL_K + res.info["exchange_rounds"],
                          f"ladder {dt}/{degr}/p={p}: the faults must not "
                          "add rounds")
                    if p == 0.0:
                        check(bool(torch.equal(out, apply_ref)),
                              "ladder p=0 must be the clean plan bitwise")
                    errs.append([rel_err(out, apply_ref)[1],
                                 rel_err(res.x, solve_ref)[1]])
                table[f"{dt}/{degr}/{p:g}"] = np.mean(errs, axis=0).tolist()
        for degr in DEGRADATIONS:
            means = [table[f"{dt}/{degr}/{p:g}"][0] for p in LADDER_PROBS]
            check(all(a <= b for a, b in zip(means, means[1:]))
                  and means[-1] > 0,
                  f"ladder {dt}/{degr}: mean apply error falls as p rises: "
                  f"{means}")
        hold, zero = (table[f"{dt}/{d}/0.05"][1]
                      for d in ("hold_last", "zero_fill"))
        check(hold <= zero, f"ladder {dt}: hold_last solve error {hold:.3e} "
              f"above zero_fill's {zero:.3e} at p=0.05")
    return dict(card_vs_cpu=card_vs_cpu, ladder=table,
                ladder_s=time.perf_counter() - t0,
                launches={k: v for k, v in launches.items() if v})


def _gossip_checks(rank: int, world: int) -> dict:
    """Phase 5: `gossip_mean_tree` over one layer of starcoder2-3b's
    parameter shapes, f32 on every rank, against all_reduce / world: clean
    (K = ceil(world / 2)), quantized, and under the mild spec twice; the
    counted rounds (K per leaf) and `cheb_step` launches; rank 0 holds
    `cheb_step` at the largest leaf's shape against its plain version."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist import FaultSpec, comm, gossip
    from repro_torch.kernels.cheb_step import cheb_step, cheb_step_plain
    from repro_torch.models.params import abstract_params

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=1)
    metas = abstract_params(cfg)["layers"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 10 + rank)
    tree = {k: torch.randn(m.shape, generator=gen, device=dev)
            for k, m in sorted(metas.items())}
    n_values = sum(t.numel() for t in tree.values())
    mean = {}
    for k, t in tree.items():
        m = t.to("cpu", copy=True)
        dist.all_reduce(m)
        mean[k] = m.to(dev) / world
    coeffs = gossip.consensus_coeffs(world)
    Kg = len(coeffs) - 1
    group = dist.group.WORLD
    counters = _graph_counters()

    def worst(out) -> float:
        return max(rel_err(out[k], mean[k])[1] for k in tree)

    rows = {}
    for label, kw in (("clean", {}), ("int8", dict(quantize=True)),
                      ("mild", dict(fault_spec=FaultSpec(**MILD_ARGS)))):
        out, counts, st, first = _counted(
            lambda: gossip.gossip_mean_tree(tree, group, coeffs, **kw),
            counters, world, 1, comm.DIRECTIONS_PER_ROUND)
        check(st.exchange_rounds == Kg * len(tree)
              and counts == {"cheb_step": (Kg - 1) * len(tree)},
              f"gossip {label} on rank {rank}: {st.exchange_rounds} rounds, "
              f"launches {counts}")
        rel = worst(out)
        if label == "mild":
            again = gossip.gossip_mean_tree(tree, group, coeffs, **kw)
            check(all(bool(torch.equal(out[k], again[k])) for k in tree),
                  "gossip under the mild spec must repeat its bits")
            check(rel < GOSSIP_MILD_BOUND, f"gossip mild rel {rel:.3e}")
            del again
        else:
            tol = TOL_GOSSIP if label == "clean" else TOL_GOSSIP_Q
            check(rel <= tol, f"gossip {label} on rank {rank}: rel "
                  f"{rel:.3e} > {tol}")
        del out
        ms = time_ms(lambda: gossip.gossip_mean_tree(tree, group, coeffs,
                                                     **kw), 1, warmup=0)
        rows[label] = dict(rel_err=rel, rounds=st.exchange_rounds,
                           bytes_per_round=st.bytes_per_round,
                           launches=counts, first_ms=first, steady_ms=ms)
    step = None
    if rank == 0:
        big = max(tree.values(), key=lambda t: t.numel())
        xs = [torch.randn(big.shape, generator=gen, device=dev)
              for _ in range(3)]
        acc = torch.randn(big.shape[:-1] + (1, big.shape[-1]),
                          generator=gen, device=dev)
        coef = torch.randn(1, generator=gen, device=dev)
        got = cheb_step(*xs, acc, coef, alpha=gossip.RING_LMAX / 2)
        want = cheb_step_plain(*xs, acc, coef, alpha=gossip.RING_LMAX / 2)
        err = max(rel_err(got[0], want[0])[0], rel_err(got[1], want[1])[0])
        rel = max(rel_err(got[0], want[0])[1], rel_err(got[1], want[1])[1])
        check(rel <= TOL_STEP, f"cheb_step at the gossip leaf: rel {rel:.3e}")
        del got, want
        nv = big.numel()
        b_ms, b_by = bound(4 * (4 * nv + 2 * nv + 1), 4 * nv + 2 * nv)
        step = dict(shape=list(big.shape), eta=1, max_abs_err=err,
                    rel_err=rel,
                    ms=time_ms(lambda: cheb_step(*xs, acc, coef, alpha=2.0),
                               5),
                    device_ms=device_ms(lambda: cheb_step(*xs, acc, coef,
                                                          alpha=2.0), 5,
                                        "cheb_step_kernel"),
                    plain_ms=time_ms(lambda: cheb_step_plain(
                        *xs, acc, coef, alpha=2.0), 3),
                    bound_ms=b_ms, bound_by=b_by)
        del xs, acc
    dist.barrier()
    return dict(leaves=len(tree), values=n_values, K=Kg, runs=rows,
                cheb_step=step)


def _community_checks(rank: int, world: int, tmp: str) -> dict:
    """(c) The general exchange at full size: the million-vertex community
    graph's `cuda_halo` plan over the parent's spectral partition (P never
    densified), `apply`, `apply_gram` and `apply_adjoint` on B =
    COMMUNITY_B signals, each held against the float64 oracle (the
    `dense` plan over the CSR's float64 matvec, on the card) on its first
    ORACLE_SIGNALS signals; rank 0 also holds the coupling launch against
    its plain version at this shape and times it."""
    import torch.distributed as dist

    from repro_torch.core import wavelets
    from repro_torch.dist import GraphOperator, comm, plan_comm_stats
    from repro_torch.dist.partition import CSRMatrix, csr_matvec_fn

    dev = torch.device("cuda")
    saved = torch.load(Path(tmp) / "community.pt", weights_only=False)
    csr, meta, parts = saved["csr"], saved["meta"], saved["parts"]
    n = csr.n
    mult = wavelets.sgwt_multipliers(meta["lmax"], J=J)
    op = GraphOperator(P=csr_matvec_fn(csr), multipliers=mult,
                       lmax=meta["lmax"], K=K)
    t0 = time.perf_counter()
    plan = op.plan("cuda_halo", partition=parts)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    info = plan.info
    offsets = info["partition_offsets"]
    check(len(offsets) > 2 and info["transport"] == "gloo-host-staged"
          and info["partition_fingerprint"] == parts.fingerprint,
          f"community plan on rank {rank}: offsets {offsets}, info {info}")
    st = plan_comm_stats(plan, n=n)
    _check_general_bytes(f"community on rank {rank}", st, info, K)
    check(st["apply"].bytes_per_round == parts.wire_bytes_per_round(),
          "bytes per round must be the partition's wire bytes")
    oracle = GraphOperator(
        P=csr_matvec_fn(CSRMatrix(csr.indptr, csr.indices,
                                  csr.data.astype(np.float64))),
        multipliers=mult, lmax=meta["lmax"], K=K).plan("dense")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    F = torch.randn(COMMUNITY_B, n, generator=gen, device=dev)
    a = torch.randn(COMMUNITY_B, J + 1, n, generator=gen, device=dev)
    few = slice(0, ORACLE_SIGNALS)
    per_order = {"sliced_ell_spmv": 1, "sliced_ell_spmv_accumulate": 1}
    paths = [  # name, call, reference, rounds, kernel launches
        ("community apply", lambda: plan.apply(F),
         lambda: oracle.apply(F[few].double()), K,
         _times(per_order, K, cheb_step=K - 1)),
        ("community apply_gram", lambda: plan.apply_gram(F),
         lambda: oracle.apply_gram(F[few].double()), 2 * K,
         _times(per_order, 2 * K, cheb_step=2 * K - 1)),
        ("community apply_adjoint", lambda: plan.apply_adjoint(a),
         lambda: oracle.apply_adjoint(a[few].double()), K,
         _times(per_order, K)),
    ]
    counters = _graph_counters()
    rows = []
    for name, call, ref_fn, rounds, expect in paths:
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        with comm.counting() as rec:
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
        counts = {k.__name__: k.launches for k in counters if k.launches}
        check(counts == expect, f"{name} on rank {rank}: launches {counts}, "
              f"expected {expect}")
        st = rec.stats(world, COMMUNITY_B,
                       info["exchange_collectives_per_round"])
        check(st.exchange_rounds == rounds,
              f"{name} on rank {rank}: {st.exchange_rounds} rounds; "
              f"expected {rounds}")
        err, rel = rel_err(out[few], ref_fn())
        check(rel <= TOL_PATH, f"{name} on rank {rank}: rel err {rel:.3e}")
        del out
        iters = 3
        with comm.counting() as steady:
            ms = time_ms(call, iters, warmup=1)
        calls = iters + 1
        rows.append(dict(name=name, launches=counts,
                         rounds=st.exchange_rounds,
                         messages=st.paper_messages(meta["n_edges"]),
                         bytes_per_round=st.bytes_per_round,
                         max_abs_err=err, rel_err=rel, first_ms=first,
                         steady_ms=ms,
                         exchange_wait_ms=steady.wait_s * 1e3 / calls,
                         exchange_post_ms=steady.post_s * 1e3 / calls,
                         assembly_ms=steady.assembly_s * 1e3 / calls))
    # the exchange alone: K rounds of one (B, h_k) f32 tile per offset
    tiles = [F[:, :h].contiguous() for h in info["partition_tile_widths"]]
    exchange_ms = _exchange_only_ms(tiles, offsets)
    # where the time of an apply goes, on rank 0 (the others run beside);
    # the coupling launch is the kernel's accumulating instance
    profile = None
    if rank == 0:
        profile = _profile_call(plan.apply, F, {
            "coupling": ("sliced_ell_spmv_kernel<8, true>",),
            "sliced_ell_spmv": ("sliced_ell_spmv",),
            "cheb_step": ("cheb_step",), "memcpy": ("memcpy",),
            "index_and_cat": ("index", "cat")})
    else:
        plan.apply(F)
        torch.cuda.synchronize()
    coupling = _coupling_kernel_row(parts, rank, dev) if rank == 0 else None
    del plan
    torch.cuda.empty_cache()
    wires = _community_wires(rank, world, op, oracle, parts, F, info)
    dist.barrier()
    return dict(rank=rank, n=n, n_edges=meta["n_edges"], nnz=csr.nnz,
                wires=wires,
                lmax=meta["lmax"], offsets=list(offsets),
                tile_widths=list(info["partition_tile_widths"]),
                edge_cut=info["edge_cut"], build_ms=build_ms,
                n_local_padded=info["n_local_padded"],
                interior_nnz=info["nnz"],
                stored_per_nnz=info["stored_per_nnz"],
                coupling_nnz=info["coupling_nnz"], paths=rows,
                exchange_only_ms_per_round=exchange_ms, profile=profile,
                coupling=coupling)


def _community_wires(rank, world, op, oracle, parts, F, info) -> dict:
    """Phase 3: the community graph's `apply` at every wire: the float64
    oracle on the first ORACLE_SIGNALS signals at the wire's gate, K
    rounds, the f32 plan's launches, the bytes per round at B = 1 (the
    sum over the offsets of `tile_wire_bytes`); the exchange alone per
    round on each wire's encoded tiles, and with the codec around it."""
    from repro_torch.dist import quantize

    counters = _graph_counters()
    few = slice(0, ORACLE_SIGNALS)
    ref = oracle.apply(F[few].double())
    offsets = info["partition_offsets"]
    per_round = info["exchange_collectives_per_round"]
    expect = _times({"sliced_ell_spmv": 1, "sliced_ell_spmv_accumulate": 1},
                    K, cheb_step=K - 1)
    tiles = [F[:, :h].contiguous() for h in info["partition_tile_widths"]]
    rows, errs = [], {}
    for dt in WIRES:
        plan = op.plan("cuda_halo", partition=parts, exchange_dtype=dt)
        name = f"community apply[{dt} wire]"
        out, counts, st, first = _counted(lambda: plan.apply(F), counters,
                                          world, COMMUNITY_B, per_round)
        check(counts == expect and st.exchange_rounds == K,
              f"{name} on rank {rank}: launches {counts}, "
              f"{st.exchange_rounds} rounds")
        err, rel = rel_err(out[few], ref)
        errs[dt] = rel
        del out
        _, _, b1, _ = _counted(lambda: plan.apply(F[0]), counters, world, 1,
                               per_round)
        check(b1.bytes_per_round == COMMUNITY_WIRE_BYTES[dt]
              == parts.wire_bytes_per_round(dt),
              f"{name}: {b1.bytes_per_round} bytes per round at B=1, "
              f"expected {COMMUNITY_WIRE_BYTES[dt]}")
        ms = time_ms(lambda: plan.apply(F), 3, warmup=1)
        wires = [quantize.encode(t, dt) for t in tiles]
        exchange_ms = _exchange_only_ms(wires, offsets)
        codec_ms = _exchange_codec_ms(tiles, offsets, dt)
        rows.append(dict(name=name, wire=dt, launches=counts,
                         rounds=st.exchange_rounds,
                         bytes_per_round=st.bytes_per_round,
                         bytes_per_round_b1=b1.bytes_per_round,
                         max_abs_err=err, rel_err=rel, first_ms=first,
                         steady_ms=ms, exchange_only_ms_per_round=exchange_ms,
                         exchange_with_codec_ms_per_round=codec_ms))
        del plan
        torch.cuda.empty_cache()
    check(errs["f32"] <= TOL_PATH and errs["bf16"] <= TOL_WIRE_BF16
          and errs["int8"] <= INT8_OVER_BF16 * errs["bf16"],
          f"community wire errors against the oracle on rank {rank}: {errs}")
    return rows


def _exchange_codec_ms(tiles, offsets, dt: str, rounds: int = K) -> float:
    """Per round: encode the f32 tiles to `dt`, exchange them, decode what
    arrived (CUDA events, 3 calls after a warm-up)."""
    import torch.distributed as dist

    from repro_torch.dist import comm, quantize

    def round_trip():
        for _ in range(rounds):
            got = comm.offset_exchange([quantize.encode(t, dt) for t in tiles],
                                       offsets, dist.group.WORLD).wait()
            [quantize.decode(w, dt) for w in got]

    return time_ms(round_trip, 3, warmup=1) / rounds


def _coupling_kernel_row(parts, rank: int, dev) -> dict:
    """The coupling launch (the SpMV kernel, rectangular and accumulating)
    against its plain version on this rank's couplings at the community
    shape, its times, bound and the library call computing y + C r."""
    from repro_torch.dist.sharded import coupling_layout
    from repro_torch.kernels.bcsr_spmv import (sliced_ell_spmv_accumulate,
                                               sliced_ell_spmv_plain)

    C = coupling_layout(parts, rank, parts.n_local_padded, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    r = torch.randn(COMMUNITY_B, C.x_len, generator=gen, device=dev)
    y0 = torch.randn(COMMUNITY_B, C.padded_n, generator=gen, device=dev)
    got = sliced_ell_spmv_accumulate(C, r, y0.clone())
    want = sliced_ell_spmv_plain(C, r, out=y0.clone())
    torch.cuda.synchronize()
    err, rel = rel_err(got - y0, want - y0)
    check(rel <= TOL_SPMV, f"coupling spmv: rel err {rel:.3e}")
    y = y0.clone()
    ms = time_ms(lambda: sliced_ell_spmv_accumulate(C, r, y), 20)
    dev_ms = device_ms(lambda: sliced_ell_spmv_accumulate(C, r, y), 20,
                       "sliced_ell_spmv_kernel")
    plain_ms = time_ms(lambda: sliced_ell_spmv_plain(C, r, out=y), 5)
    # the library yardstick: one cuSPARSE product y^T + C r^T
    rows = C.entry_rows()[C.values != 0]
    # y + C r needs only the rows that hold an entry; the kernel reads and
    # writes every row of a slice that holds one (slice-granular)
    entry_rows = int(rows.unique().numel())
    touched_rows = int((C.widths > 0).sum()) * (C.padded_n // C.n_slices)
    C_csr = torch.sparse_coo_tensor(
        torch.stack([rows, C.columns[C.values != 0].long()]),
        C.values[C.values != 0], (C.padded_n, C.x_len)).coalesce(
        ).to_sparse_csr()
    yT, rT = y0.t().contiguous(), r.t().contiguous()
    lib_ms = lib_dev = None
    try:
        lib_ms = time_ms(lambda: torch.addmm(yT, C_csr, rT), 20)
        lib_dev = all_device_ms(lambda: torch.addmm(yT, C_csr, rT), 20)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"coupling library call torch.addmm(CSR) refused: {exc}")
    b_ms, b_by = bound(C.nnz * 8 + COMMUNITY_B * (C.x_len + 2 * entry_rows)
                       * 4, 2 * C.nnz * COMMUNITY_B)
    touched_ms, _ = bound(C.nnz * 8 + COMMUNITY_B
                          * (C.x_len + 2 * touched_rows) * 4,
                          2 * C.nnz * COMMUNITY_B)
    return dict(max_abs_err=err, rel_err=rel, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
                entry_rows=entry_rows, touched_rows=touched_rows,
                bound_touched_ms=touched_ms,
                rows=C.padded_n, cols=C.x_len, nnz=C.nnz, stored=C.stored,
                batch=COMMUNITY_B)


def _codec_checks(dev) -> list:
    """Phase 1: `quantize.encode` on the card against the port on the CPU
    (the same tile, byte for byte) at each CODEC_TILES shape, the round
    trip's error, and the time of encode + decode (CUDA events, and the
    device time of all their kernels)."""
    from repro_torch.dist import quantize

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    out = []
    for shape in CODEC_TILES:
        x = torch.randn(shape, generator=gen, device=dev)
        xc = x.cpu()
        row = {"shape": list(shape)}
        for dt in ("bf16", "int8"):
            w, wc = quantize.encode(x, dt), quantize.encode(xc, dt)
            words = torch.int16 if dt == "bf16" else torch.int8
            check(bool(torch.equal(w.cpu().view(words), wc.view(words))),
                  f"codec {dt} {shape}: the card's wire differs from the "
                  "CPU's")
            back = quantize.decode(w, dt)
            if dt == "int8":
                scale = x.abs().amax(-1, keepdim=True)
                err, tol = float(((back - x).abs() / scale).max()), \
                    0.5 / 127 + 1e-6
            else:
                err, tol = float((back - x).abs().max()), 2e-2
            check(err <= tol, f"codec {dt} {shape}: round trip {err:.3e}")

            def round_trip(dt=dt):
                return quantize.decode(quantize.encode(x, dt), dt)

            row[dt] = dict(wire_bytes=w.numel() * w.element_size(), err=err,
                           tol=tol, ms=time_ms(round_trip, 20),
                           device_ms=all_device_ms(round_trip, 20))
        out.append(row)
    return out


def _graph_counters():
    """The launch counters of the graph kernels' wrappers."""
    from repro_torch.kernels.bcsr_spmv import (sliced_ell_spmv,
                                               sliced_ell_spmv_accumulate)
    from repro_torch.kernels.cheb_step import cheb_step
    from repro_torch.kernels.cheb_sweep import cheb_sweep, jacobi_sweep
    from repro_torch.kernels.jacobi_step import jacobi_step
    from repro_torch.kernels.soft_threshold import ista_shrink

    return (sliced_ell_spmv, sliced_ell_spmv_accumulate, cheb_step,
            cheb_sweep, jacobi_step, jacobi_sweep, ista_shrink)


def _times(per_round: dict, rounds: int, **extra) -> dict:
    """Expected launches of a per-order path: `per_round` each round."""
    return {**{k: v * rounds for k, v in per_round.items()}, **extra}


def _check_general_bytes(name: str, st: dict, info: dict, K: int) -> None:
    """At B = 1: K rounds (2K Gram), 4 sum(h_k) bytes per round (one f32
    tile per offset) and the byte models of plan.info."""
    wire = 4 * sum(info["partition_tile_widths"])
    check(st["apply"].exchange_rounds == K
          and st["apply_adjoint"].exchange_rounds == K
          and st["apply_gram"].exchange_rounds == 2 * K
          and st["apply"].bytes_per_round == wire
          and st["apply"].total_bytes == info["halo_bytes_per_apply"]
          and st["apply_adjoint"].total_bytes
          == info["halo_bytes_per_adjoint"],
          f"{name} rounds and bytes at B=1: {st['apply'].summary()}, "
          f"{st['apply_adjoint'].summary()}, wire {wire}")


def _exchange_only_ms(tiles, offsets, rounds: int = K) -> float:
    """The exchange alone, per round: `rounds` rounds of `tiles` at
    `offsets` with no compute (CUDA events, 3 calls after a warm-up)."""
    import torch.distributed as dist

    from repro_torch.dist import comm

    def exchange_only():
        for _ in range(rounds):
            comm.offset_exchange(tiles, offsets, dist.group.WORLD).wait()

    return time_ms(exchange_only, 3, warmup=1) / rounds


def _print_sharded_path(row: dict, agg: dict, batch: int) -> None:
    print(f"path {row['name']} [{SHARD_LABEL}]: h={agg['halo_width']}, "
          f"steady {row['steady_ms']:.3f} ms on rank 0 (CUDA events; max "
          f"over ranks {agg['steady_ms_max']:.3f}), exchange wait "
          f"{row['exchange_wait_ms']:.3f} ms and post "
          f"{row['exchange_post_ms']:.3f} ms, assembly "
          f"{row['assembly_ms']:.3f} ms per call on rank 0 (host "
          f"clock; max wait {agg['exchange_wait_ms_max']:.3f}), first "
          f"call {row['first_ms']:.1f} ms, {row['rounds']} rounds, "
          f"{row['messages']} paper messages (rounds x 2|E|), "
          f"{row['bytes_per_round']:.0f} bytes per round at B={batch}, "
          f"launches per rank {row['launches']}, rel err max over ranks "
          f"{agg['rel_err_max']:.3e} (tol {TOL_PATH})")


def _ffma_bounds(shape, long_s: int = 4096) -> dict:
    """What holds the FFMA flash kernel at the causal f32 `shape` (B, Hq,
    Hkv, S, D): the instance's registers, shared memory and resident blocks
    per SM (the CUDA runtime's); its grid against the SMs (the K tiles of
    the heaviest block, after the kernel's split of long q tiles, against
    the mean per block slot); the same kernel at B = 2 and S = `long_s`,
    where no short tail of unequal causal blocks is left; and the SM clock
    and power while `shape` runs back to back."""
    from repro_torch.kernels.flash_attention import (ffma_kernel_info,
                                                     ffma_split,
                                                     flash_attention_ffma)
    b, hq, hkv, S, d = shape
    info = ffma_kernel_info(torch.float32, d)
    split = ffma_split(torch.float32, d, b, hq, S, S)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bq, bk = info["q_rows"], info["k_rows"]
    tiles = [min(-(-S // bk), (min(qt * bq + bq, S) - 1) // bk + 1)
             for qt in range(-(-S // bq))]
    slots = sms * info["blocks_per_sm"]
    grid = dict(sms=sms, slots=slots, q_tiles=b * hq * len(tiles),
                blocks=split["blocks"], chunk=split["chunk"],
                heaviest_q_tile_tiles=max(tiles),
                heaviest_block_tiles=min(max(tiles), split["chunk"]),
                mean_tiles_per_slot=b * hq * sum(tiles) / slots)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(batch, length):
        return (torch.randn(batch, hq, length, d, generator=gen,
                            device="cuda"),
                torch.randn(batch, hkv, length, d, generator=gen,
                            device="cuda"),
                torch.randn(batch, hkv, length, d, generator=gen,
                            device="cuda"))

    q, k, v = qkv(2, long_s)
    dev = device_ms(lambda: flash_attention_ffma(q, k, v, causal=True), 3,
                    "flash_attention_ffma_kernel")
    b_ms, _ = bound(0, 4 * 2 * hq * d * long_s * (long_s + 1) // 2)
    long = dict(shape=[2, hq, hkv, long_s, d], device_ms=dev, bound_ms=b_ms,
                bound_share=b_ms / dev if dev else None)
    del q, k, v
    q, k, v = qkv(b, S)
    # one-shot queries from a thread while this thread keeps the card busy:
    # each query is waited for, so no process outlives the phase
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30, check=True)
            samples.append(tuple(float(x) for x in
                                 out.stdout.splitlines()[0].split(",")))
            time.sleep(0.1)

    sampler = threading.Thread(target=sample)
    for _ in range(50):
        flash_attention_ffma(q, k, v, causal=True)
    sampler.start()
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1.5:
            for _ in range(50):
                flash_attention_ffma(q, k, v, causal=True)
            torch.cuda.synchronize()
    finally:
        stop.set()
        sampler.join()
    clocks = dict(samples=len(samples),
                  sm_mhz_min=min((c for c, _ in samples), default=None),
                  sm_mhz_max=max((c for c, _ in samples), default=None),
                  power_w_max=max((w for _, w in samples), default=None))
    return dict(instance=info, grid=grid, long=long, while_running=clocks)


def _profile_call(fn, arg, groups=None):
    """One call of fn(arg) under torch.profiler: the device time of its
    kernels and copies by group (the first of `groups`, name ->
    substrings, that matches), its share of the wall time, and the host
    operations with the most self time; None when the trace holds no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    groups = groups or {
        "sliced_ell_spmv": ("sliced_ell_spmv",),
        "cheb_step": ("cheb_step",), "memcpy": ("memcpy",),
        "matmul": ("gemm", "gemv", "cutlass", "xmma", "nvjet")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = dict.fromkeys(list(groups) + ["other"], 0.0)
    host = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            key = e.key.lower()
            device[next((g for g, subs in groups.items()
                         if any(x in key for x in subs)), "other")] += (
                e.self_device_time_total / 1e3)
        else:
            host.append((e.self_cpu_time_total / 1e3, e.key, e.count))
    busy = sum(device.values())
    if busy <= 0:
        return None
    host.sort(reverse=True)
    return dict(device_ms=device, busy_ms=busy, wall_ms=wall_ms,
                busy_share=busy / wall_ms,
                top_host_ms=[[k, c, round(ms, 3)] for ms, k, c in host[:8]])


def _sensor500_phase(dev, counters, path_launches) -> dict:
    """SENSOR500 (n = 500) through the three examples' `main` on the
    card, each held against the same example's float64 dense run on the
    card; the counts are read right after each f32 run, before its
    reference (the float64 references run through the f64 kernels)."""
    from repro_torch.examples import (distributed_lasso, quickstart,
                                      semi_supervised)

    row = dict(name="sensor500 examples")
    launches = {}

    def counted(fn):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in counters if k.launches}
        for k, v in counts.items():
            path_launches[k] += v
            launches[k] = launches.get(k, 0) + v
        return out, counts, seconds

    f64 = dict(backend="dense", dtype=torch.float64, device=dev)
    q, qc, qs = counted(lambda: quickstart.main([]))
    check(qc == {"cheb_sweep": 1}, f"quickstart launches {qc}")
    x = quickstart.inputs()
    q64 = quickstart.run(x["W"], x["coords"], x["f0"], x["y"], **f64)
    _, rel = rel_check(q["denoised"], q64["denoised"], TOL_PATH,
                       "sensor500 Tikhonov denoised vs f64 dense")
    row["tikhonov"] = dict(mse_noisy=q["mse_noisy"],
                           mse_denoised=q["mse_denoised"],
                           mse_denoised_f64=q64["mse_denoised"], rel_err=rel,
                           launches=qc, seconds=qs)
    print(f"sensor500 Tikhonov (Section IV-D): n={q['n']}, |E|="
          f"{q['n_edges']}, K={q['K']}: MSE noisy {q['mse_noisy']:.4f}, "
          f"denoised {q['mse_denoised']:.4f} (float64 dense "
          f"{q64['mse_denoised']:.4f}); {qs:.2f} s, launches {qc}")

    las, lc, ls = counted(lambda: distributed_lasso.main([]))
    iters = las["n_iters"]
    check(lc.get("ista_shrink") == iters and lc.get("cheb_sweep") == iters + 2,
          f"lasso launches {lc}")
    x = distributed_lasso.inputs()
    l64 = distributed_lasso.run(x["W"], x["coords"], x["f0"], x["y"],
                                n_iters=iters, **f64)
    _, rel_s = rel_check(las["signal"], l64["signal"], TOL_PATH,
                         "sensor500 lasso signal vs f64 dense")
    _, rel_c = rel_check(las["coeffs"], l64["coeffs"], TOL_PATH,
                         "sensor500 lasso coefficients vs f64 dense")
    row["lasso"] = dict(mse_noisy=las["mse_noisy"],
                        mse_tikhonov=las["mse_tikhonov"],
                        mse_lasso=las["mse_lasso"],
                        mse_lasso_f64=l64["mse_lasso"], iters=iters,
                        rel_err_signal=rel_s, rel_err_coeffs=rel_c,
                        launches=lc, seconds=ls)
    print(f"sensor500 lasso (Section VI): {iters} ISTA iterations at "
          f"K={distributed_lasso.SENSOR500.lasso_K}, mu "
          f"{distributed_lasso.mu_weights()}: MSE noisy "
          f"{las['mse_noisy']:.4f}, tikhonov {las['mse_tikhonov']:.4f}, "
          f"lasso {las['mse_lasso']:.4f} (float64 dense "
          f"{l64['mse_lasso']:.4f}); {ls:.2f} s, launches {lc}")

    ssl_res, sc, ss = counted(lambda: semi_supervised.main([]))
    check(sc == {"cheb_sweep": len(ssl_res)}, f"SSL launches {sc}")
    x = semi_supervised.inputs()
    s64 = semi_supervised.run(x["W"], x["labels"], x["mask"], **f64)
    accs = {}
    for name, r in ssl_res.items():
        ref = s64[name]["scores"]
        rel_check(r["scores"], ref, TOL_PATH,
                  f"sensor500 SSL scores [{name.strip()}] vs f64 dense")
        clear = (ref[:, 0] - ref[:, 1]).abs() > PRED_MARGIN
        check(bool((r["scores"].argmax(1) == ref.argmax(1))[clear].all()),
              f"SSL predictions [{name}] differ from float64 dense")
        accs[name.strip()] = r["accuracy"]
    row["ssl"] = dict(accuracy=accs, launches=sc, seconds=ss)
    print(f"sensor500 SSL (Section III-D, two clusters of 25): accuracy on "
          f"unlabeled {accs}; {ss:.2f} s, launches {sc}")
    row["launches"] = launches
    return row


def _report_invariants(ranks, findings, report, seconds) -> dict:
    """The invariants line: the findings per rule of the one-card checks,
    the 4 ranks' checks and the AST layer, every one allowlisted, and the
    checks run."""
    import os

    from repro_torch.analysis import Allowlist, Finding, cli

    os.chdir(ROOT)
    t0 = time.perf_counter()
    allowlist = Allowlist.load(str(cli.ALLOWLIST))
    ast = cli.ast_findings(allowlist)
    ast_s = time.perf_counter() - t0
    ranked = [Finding(**f) for r in ranks
              for f in r["invariants"]["findings"]]
    every = list(findings) + ranked + ast
    kept, allowed = allowlist.split(every)
    for f in kept:
        print(f"invariants: not allowlisted: {f}")
    per_rule = {}
    for f in allowed:
        per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
    row = dict(name="invariants", one_card_calls=report["calls"],
               one_card_seconds=seconds,
               rank_calls=[r["invariants"]["calls"] for r in ranks],
               rank_seconds=[r["invariants"]["seconds"] for r in ranks],
               rank_checked=ranks[0]["invariants"]["checked"],
               rank_launches=ranks[0]["invariants"]["launches"],
               ast_seconds=ast_s, not_allowlisted=len(kept),
               allowlisted_per_rule=per_rule,
               runtime_findings=len(findings) + len(ranked))
    print("invariants: " + json.dumps(row))
    check(not kept, f"{len(kept)} invariant finding(s) are not allowlisted")
    return row


def _report_exchange_phases(ranks, smi: str, path_rows: list, names):
    """Print and record what the ranks saw in phases 2-5 (the compressed
    wires and the faults on the sensor graph, the community graph's
    wires, the card against the CPU and the ladder, gossip); returns the
    phases' launches summed over the ranks and rank 0's `cheb_step` row at
    the gossip leaf."""
    exchange_launches = dict.fromkeys(names, 0)

    def tally(launches: dict) -> None:
        for k, v in launches.items():
            exchange_launches[k] += v

    for phase in ("wires", "faults"):
        for i, row in enumerate(ranks[0][phase]["paths"]):
            per_rank = [r[phase]["paths"][i] for r in ranks]
            for p in per_rank:
                tally(p["launches"])
            agg = dict(row, label=SHARD_LABEL,
                       steady_ms_max=max(p["steady_ms"] for p in per_rank),
                       rel_err_max=max(p.get("rel_err", 0.0)
                                       for p in per_rank))
            path_rows.append(agg)
            extra = (f"vs clean {row['err_vs_clean']:.3e}, clean steady "
                     f"{row['clean_steady_ms']:.3f} ms, fault_key "
                     f"{row['fault_key']}" if phase == "faults" else
                     f"rel err max over ranks {agg['rel_err_max']:.3e} vs "
                     + row.get("vs", "float64 dense"))
            print(f"path {row['name']} [{SHARD_LABEL}] ({smi}): steady "
                  f"{row['steady_ms']:.3f} ms on rank 0 (CUDA events; max "
                  f"over ranks {agg['steady_ms_max']:.3f}), first call "
                  f"{row['first_ms']:.1f} ms, {row['rounds']} rounds, "
                  f"{row['bytes_per_round']:.0f} bytes per round at "
                  f"B={BATCH}, launches per rank {row['launches']}, {extra}")
    # phase 3: the community graph's wires
    com = [r["community"] for r in ranks]
    for i, row in enumerate(com[0]["wires"]):
        per_rank = [c["wires"][i] for c in com]
        for p in per_rank:
            tally(p["launches"])
        exch = [p["exchange_only_ms_per_round"] for p in per_rank]
        codec_x = [p["exchange_with_codec_ms_per_round"] for p in per_rank]
        agg = dict(row, label=SHARD_LABEL,
                   steady_ms_max=max(p["steady_ms"] for p in per_rank),
                   rel_err_max=max(p["rel_err"] for p in per_rank),
                   exchange_only_ms_per_round=exch,
                   exchange_with_codec_ms_per_round=codec_x)
        path_rows.append(agg)
        print(f"path {row['name']} [{SHARD_LABEL}] ({smi}): steady "
              f"{row['steady_ms']:.3f} ms on rank 0 (max over ranks "
              f"{agg['steady_ms_max']:.3f}), first call "
              f"{row['first_ms']:.1f} ms, {row['rounds']} rounds, "
              f"{row['bytes_per_round_b1']} bytes per round at B=1, "
              f"launches per rank {row['launches']}, rel err max over ranks "
              f"{agg['rel_err_max']:.3e} (f64 oracle, {ORACLE_SIGNALS} "
              f"signals); the exchange alone {min(exch):.3f} to "
              f"{max(exch):.3f} ms per round over ranks, with encode and "
              f"decode {min(codec_x):.3f} to {max(codec_x):.3f}")
    # phase 4: the card against the CPU, and the ladder
    small = [r["small_faults"] for r in ranks]
    for r in small:
        tally(r["launches"])
    print(f"faults on the BENCH_faults.json setup [{SHARD_LABEL}] ({smi}): "
          f"faulted apply, card vs CPU rel err max over ranks "
          + ", ".join(f"{dt} {max(r['card_vs_cpu'][dt] for r in small):.3e}"
                      for dt in ("f32", "int8"))
          + f"; the ladder ({LADDER_SEEDS} seeds, means of apply and "
          f"{LADDER_SOLVE_ROUNDS}-round Jacobi rel err) in "
          f"{small[0]['ladder_s']:.1f} s: {small[0]['ladder']}")
    path_rows.append(dict(name="fault ladder", label=SHARD_LABEL,
                          card_vs_cpu=[r["card_vs_cpu"] for r in small],
                          ladder=small[0]["ladder"],
                          seconds=small[0]["ladder_s"]))
    # phase 5: gossip
    gos = [r["gossip"] for r in ranks]
    g0 = gos[0]
    for label in g0["runs"]:
        per_rank = [g["runs"][label] for g in gos]
        for p in per_rank:
            tally(p["launches"])
        row = dict(per_rank[0], name=f"gossip_mean_tree[{label}]",
                   label=SHARD_LABEL, leaves=g0["leaves"],
                   values_per_rank=g0["values"], K=g0["K"],
                   steady_ms_max=max(p["steady_ms"] for p in per_rank),
                   rel_err_max=max(p["rel_err"] for p in per_rank))
        path_rows.append(row)
        print(f"path gossip_mean_tree[{label}] over one {LM_ARCH} layer "
              f"({g0['leaves']} leaves, {g0['values']} f32 values per rank, "
              f"K={g0['K']}) [{SHARD_LABEL}] ({smi}): {row['steady_ms']:.1f} "
              f"ms per tree on rank 0 (max over ranks "
              f"{row['steady_ms_max']:.1f}), first {row['first_ms']:.1f} ms, "
              f"{row['rounds']} rounds, launches per rank {row['launches']}, "
              f"rel err max over ranks {row['rel_err_max']:.3e} vs "
              f"all_reduce / {SHARDS}")
    gossip_step = g0["cheb_step"]
    print(f"kernel cheb_step at the gossip leaf {gossip_step['shape']} eta=1: "
          f"max_abs_err={gossip_step['max_abs_err']:.3e} rel="
          f"{gossip_step['rel_err']:.3e} (tol {TOL_STEP}) ms="
          f"{gossip_step['ms']:.4f} device_ms={gossip_step['device_ms']} "
          f"plain_ms={gossip_step['plain_ms']:.4f} bound_ms="
          f"{gossip_step['bound_ms']:.5f} ({gossip_step['bound_by']})")
    print(f"launches of the exchange phases (compressed wires, faults, "
          f"gossip; summed over ranks): "
          f"{ {k: v for k, v in exchange_launches.items() if v} }")
    check(all(exchange_launches[k] > 0 for k in (
        "sliced_ell_spmv", "sliced_ell_spmv_accumulate", "cheb_step",
        "jacobi_step")), "the exchange phases must launch their kernels")
    return exchange_launches, gossip_step


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="drive the port on the card and check every kernel")
    parser.add_argument(
        "--save-wire-signal", metavar="PATH", default=None,
        help="also save the (64, 16384) f32 signals of the compressed-"
             "exchange phase, drawn on the card, to PATH (.npy), for "
             "tests/test_torch_wire_ratio.py")
    args = parser.parse_args(argv)
    save_wire_signal = (str(Path(args.save_wire_signal).resolve())
                        if args.save_wire_signal else None)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import filters, graph, jacobi, lasso, ssl, wavelets
    from repro_torch.dist import METHODS, GraphOperator
    from repro_torch.dist.partition import (community_graph_csr,
                                            partition_general)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.bcsr_spmv import (block_ell_spmv_plain,
                                               sliced_ell_spmv,
                                               sliced_ell_spmv_accumulate,
                                               sliced_ell_spmv_plain)
    from repro_torch.configs import get_config
    from repro_torch.kernels.cheb_step import cheb_step, cheb_step_plain
    from repro_torch.kernels.cheb_sweep import (cheb_sweep, cheb_sweep_plain,
                                                jacobi_sweep,
                                                jacobi_sweep_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention_ffma, flash_attention_plain, flash_attention_wgmma)
    from repro_torch.kernels.jacobi_step import jacobi_step, jacobi_step_plain
    from repro_torch.kernels.soft_threshold import (ista_shrink,
                                                    ista_shrink_plain)
    from repro_torch.models import (RunConfig, count_params, forward,
                                    init_params, lm_loss)

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.SOURCES)})")

    # -- the graph and the operators -----------------------------------------
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    g = graph.connected_sensor_graph(rng, n=N, theta=THETA, kappa=KAPPA)
    g, _ = graph.spatial_sort(g)
    L = g.laplacian()
    L_norm = g.laplacian("normalized")
    lmax = g.lambda_max_bound()
    n_edges = g.n_edges
    coords = g.coords.numpy()
    del g
    op = wavelets.sgwt_operator(L, lmax, J=J, K=K)
    plan = op.plan("cuda")
    plan_po = op.plan("cuda", sweep=False)
    A = plan.info["block_ell"]
    SL = A.sliced_ell()    # packed on the card from the blocks by the plan
    # packing alone, from a fresh Block-ELL on the same blocks
    pack_ms = time_ms(lambda: graph.BlockELL(
        blocks=A.blocks, indices=A.indices, mask=A.mask,
        n=A.n).sliced_ell(), 3, warmup=1)
    eta = op.eta
    nrb, slots, br, bc = A.blocks.shape
    nnz = int((A.blocks != 0).sum())
    fill = nnz / A.blocks.numel()
    ssl_mult = [filters.ssl_multiplier(filters.power_kernel(1), TAU)]
    op_n = GraphOperator(P=L_norm, multipliers=ssl_mult, lmax=2.0, K=K)
    plan_n = op_n.plan("cuda")
    A_n = plan_n.info["block_ell"]
    nnz_n = int((A_n.blocks != 0).sum())
    print(f"graph: n={N} kappa={KAPPA:.6f} theta={THETA:.6f} |E|={n_edges} "
          f"mean degree={2 * n_edges / N:.2f} lmax_bound={lmax:.4f} "
          f"({time.perf_counter() - t0:.1f} s to build and plan)")
    print(f"block-ell: {nrb} row blocks x {slots} slots of ({br}, {bc}), "
          f"{A.blocks.numel() * 4 / 2**20:.1f} MiB of blocks, "
          f"nnz={nnz}, fill={fill:.4f}; L_norm: "
          f"{A_n.blocks.shape[1]} slots, nnz={nnz_n}")
    print(f"sliced-ell: {SL.n_slices} slices of 32 rows, {SL.stored} stored "
          f"entries, stored_per_nnz={SL.stored_per_nnz:.4f} (Block-ELL "
          f"{A.blocks.numel() / nnz:.2f}), "
          f"{SL.stored * 8 / 2**20:.2f} MiB of values and columns; "
          f"plan.info stored_per_nnz={plan.info['stored_per_nnz']:.4f}; "
          f"packed on the card from the blocks in {pack_ms:.3f} ms "
          f"(steady, CUDA events)")
    check(SL.nnz == nnz and plan.info["flops_per_matvec"] == 2 * SL.stored,
          "the sliced-ELL layout must hold every non-zero")
    check(op.K == K and eta == J + 1, "operator shape")
    check(A_n.blocks.shape == A.blocks.shape
          and bool(torch.equal(A_n.indices, A.indices)),
          "L_norm must share the Block-ELL structure of L")
    check(ops.cheb_sweep_l2_bytes(N, BATCH, stored=SL.stored)
          <= plan.info["sweep_l2_budget"],
          "the smoke shape must take the sweep")
    check(ops.jacobi_sweep_l2_bytes(N, BATCH, stored=SL.stored)
          <= ops.DEFAULT_SWEEP_L2_BUDGET,
          "the smoke shape must take the Jacobi sweep")
    check(SL.stored_per_nnz <= 1.5,
          f"the sweeps' layout stores {SL.stored_per_nnz:.4f} entries per "
          f"non-zero")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # -- kernel phases: each kernel against its plain version ----------------
    L_csr = L.to(dev).to_sparse_csr()
    spmv_rows = {}
    for B in (1, BATCH, BATCH * eta):      # 448: the adjoint's streams
        x = randn(B, N)
        xt = x.t().contiguous()
        got = sliced_ell_spmv(SL, x)
        want = sliced_ell_spmv_plain(SL, x)
        want_bell = block_ell_spmv_plain(A.blocks, A.indices, x)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        err_bell, rel_bell = rel_err(got, want_bell)
        check(max(rel, rel_bell) <= TOL_SPMV,
              f"sliced_ell_spmv B={B}: rel err {rel:.3e} (plain), "
              f"{rel_bell:.3e} (Block-ELL plain)")
        del want, want_bell
        ms = time_ms(lambda: sliced_ell_spmv(SL, x), 20)
        plain_ms = time_ms(lambda: sliced_ell_spmv_plain(SL, x), 5)
        lib_ms = time_ms(lambda: torch.sparse.mm(L_csr, xt), 20)
        dev_ms = device_ms(lambda: sliced_ell_spmv(SL, x), 20,
                           "sliced_ell_spmv_kernel")
        lib_dev = all_device_ms(lambda: torch.sparse.mm(L_csr, xt), 20)
        b_ms, b_by = bound(nnz * 8 + 2 * B * N * 4, 2 * nnz * B)
        spmv_rows[B] = dict(max_abs_err=err, rel_err=rel,
                            max_abs_err_vs_block_ell=err_bell, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            library_device_ms=lib_dev, bound_ms=b_ms,
                            bound_by=b_by, device_ms=dev_ms)
        print(f"kernel sliced_ell_spmv B={B}: max_abs_err={err:.3e} "
              f"rel={rel:.3e} vs Block-ELL plain {err_bell:.3e} "
              f"(tol {TOL_SPMV}) ms={ms:.4f} device_ms={dev_ms} "
              f"plain_ms={plain_ms:.4f} "
              f"library_ms(torch.sparse.mm CSR)={lib_ms:.4f} "
              f"library_device_ms={lib_dev} bound_ms={b_ms:.5f} ({b_by}) "
              f"stored_per_nnz={SL.stored_per_nnz:.4f}")
    del L_csr, x, xt, got

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
    step_dev = device_ms(lambda: cheb_step(pt, t1, t2, acc, coef,
                                           alpha=alpha), 20,
                         "cheb_step_kernel")
    step_b = bound(4 * (4 * BATCH * N + 2 * BATCH * eta * N + eta),
                   4 * BATCH * N + 2 * BATCH * eta * N)
    print(f"kernel cheb_step B={BATCH} eta={eta}: max_abs_err="
          f"{max(err_tk, err_acc):.3e} rel={max(rel_tk, rel_acc):.3e} "
          f"(tol {TOL_STEP}) ms={step_ms:.4f} device_ms={step_dev} "
          f"plain_ms={step_plain:.4f} bound_ms={step_b[0]:.5f} "
          f"({step_b[1]})")

    x = randn(BATCH, N)
    c = op.coeffs
    got = cheb_sweep(SL, x, c, alpha=alpha)
    want = cheb_sweep_plain(SL, x, c, alpha=alpha)
    torch.cuda.synchronize()
    err_sw, rel_sw = rel_err(got, want)
    check(rel_sw <= TOL_SWEEP, f"cheb_sweep: rel err {rel_sw:.3e}")
    sweep_ms = time_ms(lambda: cheb_sweep(SL, x, c, alpha=alpha), 5)
    sweep_plain = time_ms(lambda: cheb_sweep_plain(SL, x, c, alpha=alpha), 2,
                          warmup=1)
    sweep_dev = device_ms(lambda: cheb_sweep(SL, x, c, alpha=alpha), 3,
                          "cheb_sweep_kernel")
    sweep_b = bound(nnz * 8 + 4 * BATCH * N + 4 * BATCH * eta * N
                    + 4 * (K + 1) * eta,
                    K * (2 * nnz * BATCH + 4 * BATCH * N)
                    + 2 * (K + 1) * BATCH * eta * N)
    print(f"kernel cheb_sweep B={BATCH} eta={eta} K={K}: max_abs_err="
          f"{err_sw:.3e} rel={rel_sw:.3e} (tol {TOL_SWEEP}) ms={sweep_ms:.4f} "
          f"device_ms={sweep_dev} plain_ms={sweep_plain:.4f} "
          f"bound_ms={sweep_b[0]:.5f} ({sweep_b[1]}) "
          f"grid={cheb_sweep.last_grid} blocks, "
          f"stored_per_nnz={SL.stored_per_nnz:.4f} (sliced-ELL)")
    print(f"earlier sweeps: {EARLIER_SWEEPS}")
    del pt, t1, t2, acc, got, want

    # jacobi_step: y and inv_d batched, shared (n,), and as the per-round
    # solver path passes them (b batched, the reciprocal diagonal shared)
    qx, xj, xp = randn(BATCH, N), randn(BATCH, N), randn(BATCH, N)
    rows = {"batched": (randn(BATCH, N), randn(BATCH, N)),
            "shared": (randn(N), randn(N))}
    rows["path"] = (rows["batched"][0], rows["shared"][1])
    js_rows = {}
    for form, (yv, dv) in rows.items():
        def call(yv=yv, dv=dv):
            return jacobi_step(qx, xj, xp, yv, dv, w=1.7, s=0.3)

        def plain(yv=yv, dv=dv):
            return jacobi_step_plain(qx, xj, xp, yv, dv, w=1.7, s=0.3)

        got, want = call(), plain()
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        check(rel <= TOL_STEP, f"jacobi_step {form}: rel err {rel:.3e}")
        ms, plain_ms = time_ms(call, 20), time_ms(plain, 20)
        dev_ms = device_ms(call, 20, "jacobi_step_kernel")
        b_ms, b_by = bound(4 * (4 * BATCH * N + yv.numel() + dv.numel()),
                           5 * BATCH * N)
        js_rows[form] = dict(max_abs_err=err, rel_err=rel, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             device_ms=dev_ms)
        print(f"kernel jacobi_step B={BATCH} y/inv_d={form}: max_abs_err="
              f"{err:.3e} rel={rel:.3e} (tol {TOL_STEP}) ms={ms:.4f} "
              f"device_ms={dev_ms} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by})")
    del qx, xj, xp, rows, got, want

    # ista_shrink: a threshold per scale (the lasso's (eta, 1)), per signal
    # and scale, and per vertex
    av, phv, grv = (randn(BATCH, eta, N) for _ in range(3))
    threshes = {"scale": 0.5 * torch.rand(eta, 1, generator=gen, device=dev),
                "signal_scale": 0.5 * torch.rand(BATCH, eta, 1, generator=gen,
                                                 device=dev),
                "vertex": 0.5 * torch.rand(BATCH, eta, N, generator=gen,
                                           device=dev)}
    ist_rows = {}
    for form, th in threshes.items():
        def call(th=th):
            return ista_shrink(av, phv, grv, th, gamma=0.3)

        def plain(th=th):
            return ista_shrink_plain(av, phv, grv, th, gamma=0.3)

        got, want = call(), plain()
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        check(rel <= TOL_STEP, f"ista_shrink {form}: rel err {rel:.3e}")
        ms, plain_ms = time_ms(call, 20), time_ms(plain, 20)
        dev_ms = device_ms(call, 20, "ista_shrink_kernel")
        b_ms, b_by = bound(4 * (4 * av.numel() + th.numel()), 6 * av.numel())
        ist_rows[form] = dict(max_abs_err=err, rel_err=rel, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              device_ms=dev_ms)
        print(f"kernel ista_shrink B={BATCH} eta={eta} thresh={form} "
              f"{tuple(th.shape)}: max_abs_err={err:.3e} rel={rel:.3e} "
              f"(tol {TOL_STEP}) ms={ms:.4f} device_ms={dev_ms} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by})")
    del av, phv, grv, threshes, got, want

    # jacobi_sweep in the two Fig. 2 settings the solve phases run:
    # (a) den = (tau, 1) on L_norm, 20 rounds; (b) den = (tau, 0, 1) on L,
    # 10 rounds; diag(den(P)) from P's rows in float64
    L_dev = L.to(dev)
    Ln_dev = L_norm.to(dev)
    diag_a = TAU + torch.diagonal(Ln_dev).double()
    diag_b = TAU + (L_dev.double() ** 2).sum(1)          # L symmetric
    sweep_cases = {
        "a": (A_n, (TAU, 1.0), ROUNDS_A, (1.0 / diag_a).float(), nnz_n),
        "b": (A, (TAU, 0.0, 1.0), ROUNDS_B, (1.0 / diag_b).float(), nnz),
    }
    del L_dev, Ln_dev, diag_a, diag_b
    jsw_rows = {}
    bj = randn(BATCH, N)
    x0j = torch.zeros_like(bj)
    for case, (Aj, den, rounds, inv_d, nz) in sweep_cases.items():
        ws = jacobi.jacobi_weights(rounds)
        Sj = Aj.sliced_ell()

        def call(Sj=Sj, den=den, ws=ws, inv_d=inv_d):
            return jacobi_sweep(Sj, bj, inv_d, ws, x0j, den=den)

        def plain(Sj=Sj, den=den, ws=ws, inv_d=inv_d):
            return jacobi_sweep_plain(Sj, bj, inv_d, ws, x0j, den=den)

        got, want = call(), plain()
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        check(rel <= TOL_SWEEP, f"jacobi_sweep ({case}): rel err {rel:.3e}")
        ms = time_ms(call, 5)
        dev_ms = device_ms(call, 3, "jacobi_sweep_kernel")
        plain_ms = time_ms(plain, 2, warmup=1)
        D = len(den) - 1
        b_ms, b_by = bound(nz * 8 + 4 * (3 * BATCH * N + N),
                           rounds * (D * (2 * nz * BATCH + 2 * BATCH * N)
                                     + 6 * BATCH * N))
        jsw_rows[case] = dict(max_abs_err=err, rel_err=rel, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              grid=jacobi_sweep.last_grid, device_ms=dev_ms)
        print(f"kernel jacobi_sweep ({case}) B={BATCH} deg(den)={D} "
              f"rounds={rounds}: max_abs_err={err:.3e} rel={rel:.3e} "
              f"(tol {TOL_SWEEP}) ms={ms:.4f} device_ms={dev_ms} "
              f"plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}) grid={jacobi_sweep.last_grid} "
              f"blocks, stored_per_nnz={Sj.stored_per_nnz:.4f} (sliced-ELL)")

    # the bf16 mode of both sweeps at the same shapes: cheb_sweep on the
    # SGWT union, jacobi_sweep in setting (a)
    bf16_rows = {}
    x = randn(BATCH, N)
    Aj, den, rounds, inv_d, nz = sweep_cases["a"]
    Sj = Aj.sliced_ell()
    ws_a = jacobi.jacobi_weights(rounds)
    bf16_calls = {
        "cheb_sweep": (
            lambda: cheb_sweep(SL, x, c, alpha=alpha, scratch_dtype="bf16"),
            lambda: cheb_sweep_plain(SL, x, c, alpha=alpha,
                                     scratch_dtype="bf16"),
            # bf16 values (value 2 B + column 4 B per non-zero), bf16 x in,
            # f32 acc out; the same FMAs as the f32 sweep, at the bf16 peak
            bound(nnz * 6 + 2 * BATCH * N + 4 * BATCH * eta * N
                  + 4 * (K + 1) * eta,
                  K * (2 * nnz * BATCH + 4 * BATCH * N)
                  + 2 * (K + 1) * BATCH * eta * N, PEAK_BF16_FLOPS),
            lambda: cheb_sweep.last_grid),
        "jacobi_sweep": (
            lambda: jacobi_sweep(Sj, bj, inv_d, ws_a, x0j, den=den,
                                 scratch_dtype="bf16"),
            lambda: jacobi_sweep_plain(Sj, bj, inv_d, ws_a, x0j, den=den,
                                       scratch_dtype="bf16"),
            bound(nz * 6 + 4 * (3 * BATCH * N + N),
                  rounds * (2 * nz * BATCH + 2 * BATCH * N + 6 * BATCH * N),
                  PEAK_BF16_FLOPS),
            lambda: jacobi_sweep.last_grid),
    }
    for name, (call, plain, (b_ms, b_by), grid) in bf16_calls.items():
        got, want = call(), plain()
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        check(rel <= TOL_BF16, f"{name} bf16: rel err {rel:.3e}")
        ms = time_ms(call, 5)
        dev_ms = device_ms(call, 3, f"{name}_kernel")
        plain_ms = time_ms(plain, 2, warmup=1)
        bf16_rows[name] = dict(max_abs_err=err, rel_err=rel, ms=ms,
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, grid=grid(), device_ms=dev_ms)
        print(f"kernel {name} bf16 B={BATCH}: max_abs_err={err:.3e} "
              f"rel={rel:.3e} (tol {TOL_BF16}) ms={ms:.4f} "
              f"device_ms={dev_ms} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}) grid={grid()} blocks")
    del bj, x0j, sweep_cases, got, want, x

    # flash attention: the tensor-core kernel at the LM layer shape and a
    # ragged S (bf16), the FFMA kernel at a small and a ragged f32 shape and
    # at head dims 80 and 256 (padded to its widths 128 and 256), each
    # against its plain version; each kernel timed at one of them
    cfg = get_config(LM_ARCH)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    flash_cases = {
        "layer": (LM_B, hq, hkv, LM_S, hd, torch.bfloat16,
                  flash_attention_wgmma),
        "ragged_bf16": (1, hq, hkv, 1000, hd, torch.bfloat16,
                        flash_attention_wgmma),
        "small_f32": (2, 4, 2, 256, 64, torch.float32, flash_attention_ffma),
        "ragged_f32": (1, hq, hkv, 1000, hd, torch.float32,
                       flash_attention_ffma),
        "d80_f32": (1, 8, 2, 1000, 80, torch.float32, flash_attention_ffma),
        "d256_f32": (1, 8, 2, 1000, 256, torch.float32,
                     flash_attention_ffma),
    }
    timed = {"layer": ("flash_attention_wgmma_kernel", PEAK_BF16_FLOPS),
             "ragged_f32": ("flash_attention_ffma_kernel", PEAK_F32_FLOPS)}
    flash_rows = {}
    for case, (b, h1, h2, S, d, dt, kern) in flash_cases.items():
        q = randn(b, h1, S, d).to(dt)
        k, v = randn(b, h2, S, d).to(dt), randn(b, h2, S, d).to(dt)
        before = kern.launches
        got = kern(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        check(kern.launches == before + 1, f"{kern.__name__} {case} did not "
              f"launch")
        tol = TOL_FLASH[dt]
        err, rel = rel_err(got, want)
        excess = float(((got.float() - want.float()).abs()
                        - tol * want.float().abs()).max())
        check(got.dtype == dt and excess <= tol,
              f"{kern.__name__} {case}: |err| - rtol |ref| = {excess:.3e} "
              f"> atol {tol}")
        row = dict(kernel=kern.__name__, shape=[b, h1, h2, S, d],
                   dtype=str(dt).split(".")[-1], max_abs_err=err,
                   rel_err=rel, tol=tol)
        msg = (f"kernel {kern.__name__} {case} (B, Hq, Hkv, S, D)="
               f"{(b, h1, h2, S, d)} {row['dtype']} causal: max_abs_err="
               f"{err:.3e} (atol = rtol = {tol})")
        if dt == torch.bfloat16:
            ref32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                          causal=True)
            rms = ref32.pow(2).mean(-1, keepdim=True).sqrt()
            row_err = flash_row_err(got, ref32, rms)
            late = ref32[:, :, S // 2:]
            typical = float(late.abs().median())
            late_err = float((got[:, :, S // 2:].float() - late).abs().max())
            check(row_err <= TOL_FLASH_ROW,
                  f"{kern.__name__} {case}: row-scaled error {row_err:.3e} "
                  f"> {TOL_FLASH_ROW}")
            row.update(row_err=row_err, row_tol=TOL_FLASH_ROW,
                       typical_ref_late=typical, max_abs_err_late=late_err)
            msg += (f"; row-scaled err={row_err:.3e} (tol {TOL_FLASH_ROW}); "
                    f"rows >= S/2: median |ref| {typical:.3e}, max |err| "
                    f"{late_err:.3e}")
            if S >= 512:
                fault = flash_row_err(
                    attention_dropping_a_tile(q, k, v), ref32[:, :, -128:],
                    rms[:, :, -128:])
                check(fault >= FLASH_FAULT_MARGIN * TOL_FLASH_ROW,
                      f"the row-scaled check misses a dropped K tile "
                      f"({fault:.3e})")
                row.update(row_err_dropped_tile=fault)
                msg += (f"; a K tile dropped from the last 128 rows gives "
                        f"{fault:.3e}")
            del ref32, rms, late
        if case in timed:
            kname, peak = timed[case]

            def call(q=q, k=k, v=v, kern=kern):
                return kern(q, k, v, causal=True)

            def sdpa(q=q, k=k, v=v):
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)

            ms = time_ms(call, 10)
            dev_ms = device_ms(call, 5, kname)
            plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), 3,
                               warmup=1)
            lib_ms = time_ms(sdpa, 10)
            lib_dev = all_device_ms(sdpa, 5)
            pairs = S * (S + 1) // 2           # causal (row, col) pairs
            flops = 4 * b * h1 * d * pairs
            nbytes = q.element_size() * (2 * b * h1 * S * d
                                         + 2 * b * h2 * S * d)
            b_ms, b_by = bound(nbytes, flops, peak)
            row.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, library_device_ms=lib_dev,
                       bound_ms=b_ms, bound_by=b_by, flops=flops,
                       bytes=nbytes)
            msg += (f" ms={ms:.4f} device_ms={dev_ms} plain_ms={plain_ms:.4f}"
                    f" library_ms(scaled_dot_product_attention)={lib_ms:.4f}"
                    f" library_device_ms={lib_dev} bound_ms={b_ms:.5f} "
                    f"({b_by}, {row['dtype']} peak)")
            if dev_ms:
                row["bound_share"] = b_ms / dev_ms
                msg += f" bound/device={b_ms / dev_ms:.1%}"
            if case in FLASH_EARLIER_DEVICE_MS:
                msg += (f" earlier device_ms="
                        f"{FLASH_EARLIER_DEVICE_MS[case]} (before the FFMA "
                        f"kernel's redesign; not measured here)")
        flash_rows[case] = row
        print(msg)
    del q, k, v, got, want
    fb = flash_rows["ragged_f32"]["bounds"] = _ffma_bounds(
        flash_cases["ragged_f32"][:5])
    print(f"kernel flash_attention_ffma ragged_f32 bounds: instance "
          f"{fb['instance']}; grid {fb['grid']}; at B=2, S=4096 device_ms="
          f"{fb['long']['device_ms']} bound_ms={fb['long']['bound_ms']:.4f}"
          f" bound/device={fb['long']['bound_share']}; while running "
          f"{fb['while_running']}")

    # -- counted paths ----------------------------------------------------------
    counters = (sliced_ell_spmv, sliced_ell_spmv_accumulate, cheb_step,
                cheb_sweep, jacobi_step, jacobi_sweep, ista_shrink,
                flash_attention_wgmma, flash_attention_ffma)
    names = [k.__name__ for k in counters]
    path_launches = dict.fromkeys(names, 0)
    bf16_launches = dict.fromkeys(names, 0)   # the bf16 sweep paths
    # the sharded paths' launches, summed over their ranks (also in
    # path_launches)
    sharded_launches = dict.fromkeys(names, 0)
    path_rows = []

    def run_path(name, fn, steady_iters=3, tally=path_launches):
        """Drive one path with every count at 0 just before it, read the
        counts just after (added to `tally`); then its steady time (CUDA
        events)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        counts = {k.__name__: k.launches for k in counters}
        peak = torch.cuda.max_memory_allocated() / 2**20
        for k, v in counts.items():
            tally[k] += v
        steady = time_ms(fn, steady_iters, warmup=0) if steady_iters else None
        shown = {k: v for k, v in counts.items() if v}
        print(f"path {name}: first call {first:.2f} ms (host clock), steady "
              + (f"{steady:.3f} ms (CUDA events)" if steady is not None
                 else "not measured")
              + f", peak {peak:.1f} MiB, launches {shown}")
        path_rows.append(dict(name=name, first_ms=first, steady_ms=steady,
                              peak_mib=peak, launches=shown))
        return out, counts

    # the main path of Algorithm 1 ----------------------------------------------
    F = randn(BATCH, N)
    a = randn(BATCH, eta, N)
    outs, calls = {}, {}
    for name, fn, arg in (("apply", plan.apply, F),
                          ("apply_adjoint", plan.apply_adjoint, a),
                          ("apply_gram", plan.apply_gram, F),
                          ("apply[sweep=False]", plan_po.apply, F)):
        outs[name], calls[name] = run_path(name, lambda fn=fn, arg=arg:
                                           fn(arg))
    check(calls["apply"]["cheb_sweep"] == 1
          and sum(calls["apply"].values()) == 1,
          "apply must be one sweep launch")
    # the sweep's share of each sweep path: its device time per call (the
    # rest of the steady time is the host's)
    for name, fn in (("apply", plan.apply), ("apply_gram", plan.apply_gram)):
        sweep_share = device_ms(lambda fn=fn: fn(F), 3, "cheb_sweep_kernel")
        print(f"  {name}: cheb_sweep device_ms per call {sweep_share}")
        path_rows[[r["name"] for r in path_rows].index(name)][
            "sweep_device_ms"] = sweep_share
    check(calls["apply_gram"]["cheb_sweep"] == 1
          and sum(calls["apply_gram"].values()) == 1,
          "apply_gram must be one sweep")
    check(calls["apply_adjoint"]["sliced_ell_spmv"] == K
          and sum(calls["apply_adjoint"].values()) == K,
          "apply_adjoint must be K SpMV launches")
    check(calls["apply[sweep=False]"]["sliced_ell_spmv"] == K
          and calls["apply[sweep=False]"]["cheb_step"] == K - 1,
          "the per-order apply must be K SpMV and K-1 step launches")

    op64 = GraphOperator(P=L.double(), multipliers=op.multipliers, lmax=lmax,
                         K=K)
    check(np.array_equal(op64.coeffs, op.coeffs), "coefficient tables")
    dense = op64.plan("dense")
    refs = {"apply": dense.apply(F.double()),
            "apply_adjoint": dense.apply_adjoint(a.double()),
            "apply_gram": dense.apply_gram(F.double())}
    refs["apply[sweep=False]"] = refs["apply"]
    print("main path vs float64 dense:")
    for name, out in outs.items():
        rel_check(out, refs[name], TOL_PATH, name)
    del refs, outs, a

    # -- the guard: sweep vs per-order on both sides of the L2 budget --------
    for B in (BATCH, 4 * BATCH):
        xg = randn(B, N)
        need = ops.cheb_sweep_l2_bytes(N, B, stored=SL.stored)
        sw = time_ms(lambda: ops.fused_cheb_apply(
            A, xg, c, lmax, l2_budget=2**62), 3, warmup=1)
        po = time_ms(lambda: ops.fused_cheb_apply(
            A, xg, c, lmax, sweep=False), 3, warmup=1)
        side = "within" if need <= ops.DEFAULT_SWEEP_L2_BUDGET else "above"
        print(f"guard B={B}: L2 working set {need} B {side} budget "
              f"{ops.DEFAULT_SWEEP_L2_BUDGET} B; sweep_ms={sw:.3f} "
              f"per_order_ms={po:.3f}")
    del xg

    # -- Section-V solvers, Fig. 2 setting (a): P = L_norm, r = 1 ----------
    Y = randn(BATCH, N)
    dense_n = GraphOperator(P=L_norm.double(), multipliers=ssl_mult,
                            lmax=2.0, K=K).plan("dense")
    expect = {"jacobi": {"jacobi_sweep": 1},
              "cheb_jacobi": {"jacobi_sweep": 1},
              "chebyshev": {"cheb_sweep": 1},
              "arma": {"sliced_ell_spmv": ROUNDS_A}}
    kw_a = dict(tau=TAU, r=1, n_iters=ROUNDS_A)
    solved = {}
    for method in METHODS:
        res, counts = run_path(
            f"solve[{method}] (a)",
            lambda method=method: plan_n.solve(Y, method, **kw_a))
        check({k: v for k, v in counts.items() if v} == expect[method],
              f"solve[{method}] launches {counts}, expected {expect[method]}")
        ref = dense_n.solve(Y.double(), method, **kw_a)
        check(set(res.info) == set(ref.info)
              and res.info["exchange_rounds"] == ref.info["exchange_rounds"],
              f"solve[{method}] info {res.info} vs {ref.info}")
        rel_check(res.x, ref.x, TOL_PATH, f"solve[{method}] (a) vs f64 dense")
        if method == "cheb_jacobi":
            print(f"  rho (estimated, 2% margin) {res.info['rho']:.9f}")
        solved[method] = res.x

    # -- the per-round path and the divergence guard -------------------------
    res, counts = run_path(
        "solve[jacobi, history=True] (a)",
        lambda: plan_n.solve(Y, "jacobi", history=True, **kw_a))
    check(counts["jacobi_step"] == ROUNDS_A
          and counts["sliced_ell_spmv"] == ROUNDS_A
          and counts["jacobi_sweep"] == 0,
          f"the per-round path must be {ROUNDS_A} jacobi_step and SpMV "
          f"launches, got {counts}")
    check(tuple(res.history.shape) == (ROUNDS_A, BATCH, N), "history shape")
    rel_check(res.x, solved["jacobi"], TOL_ROUNDS,
              "per-round final iterate vs the sweep")
    rel_check(res.history[-1], res.x, 0.0, "history[-1] vs x")
    res, counts = run_path(
        "solve[jacobi, check_every=7] (a)",
        lambda: plan_n.solve(Y, "jacobi", check_every=7, **kw_a))
    check(counts["jacobi_sweep"] == 3 and not res.info["diverged"]
          and res.info["rounds_run"] == ROUNDS_A,
          f"guarded solve: {counts}, info {res.info}")
    rel_check(res.x, solved["jacobi"], TOL_GUARD,
              "guarded (check_every=7) vs unguarded")
    print(f"  guard residuals {res.info['residual_history']}")
    del dense_n, solved

    # -- Fig. 2 setting (b): P = L, r = 2 (2 SpMVs per round in the sweep) ---
    kw_b = dict(tau=TAU, r=2, n_iters=ROUNDS_B)
    res, counts = run_path("solve[jacobi] (b)",
                           lambda: plan.solve(Y, "jacobi", **kw_b))
    check({k: v for k, v in counts.items() if v} == {"jacobi_sweep": 1},
          f"solve (b) launches {counts}")
    check(res.info["matvecs_per_round"] == 2, "setting (b): 2 matvecs/round")
    ref = dense.solve(Y.double(), "jacobi", **kw_b)
    rel_check(res.x, ref.x, TOL_PATH, "solve[jacobi] (b) vs f64 dense")

    # -- the sharded apply on one shard: no process group ---------------------
    # cuda_halo without a group is one shard whose matvec carries its
    # Block-ELL: apply is one cheb_sweep launch, a Jacobi solve one
    # jacobi_sweep launch, as in the cuda plan
    plan1 = op.plan("cuda_halo")
    plan1_n = op_n.plan("cuda_halo")
    check(plan1.info["n_shards"] == 1 and plan1.info["transport"] is None,
          f"the 1-shard plan's info {plan1.info}")
    out1, counts = run_path("cuda_halo[1 shard] apply",
                            lambda: plan1.apply(F))
    check({k: v for k, v in counts.items() if v} == {"cheb_sweep": 1},
          f"cuda_halo[1 shard] apply launches {counts}")
    rel_check(out1, dense.apply(F.double()), TOL_PATH,
              "cuda_halo[1 shard] apply vs f64 dense")
    res1, counts = run_path("cuda_halo[1 shard] solve[jacobi] (a)",
                            lambda: plan1_n.solve(Y, "jacobi", **kw_a))
    check({k: v for k, v in counts.items() if v} == {"jacobi_sweep": 1},
          f"cuda_halo[1 shard] solve launches {counts}")
    ref = GraphOperator(P=L_norm.double(), multipliers=ssl_mult, lmax=2.0,
                        K=K).plan("dense").solve(Y.double(), "jacobi", **kw_a)
    rel_check(res1.x, ref.x, TOL_PATH,
              "cuda_halo[1 shard] solve[jacobi] (a) vs f64 dense")
    # (a) a general partition on one shard: BFS-ordered, no cut edge, so
    # the permuted plan is one sweep launch again
    t0 = time.perf_counter()
    plan1 = op.plan("cuda_halo", partition=partition_general(L, 1))
    plan1_n = op_n.plan("cuda_halo", partition=partition_general(L_norm, 1))
    print(f"general partition, 1 shard: built in "
          f"{time.perf_counter() - t0:.1f} s (host), offsets "
          f"{plan1.info['partition_offsets']}, fingerprint "
          f"{plan1.info['partition_fingerprint']}")
    check(plan1.info["partition"] == "general"
          and plan1.info["exchange_collectives_per_round"] == 0,
          f"the 1-shard general plan's info {plan1.info}")
    out1, counts = run_path("cuda_halo[general, 1 shard] apply",
                            lambda: plan1.apply(F))
    check({k: v for k, v in counts.items() if v} == {"cheb_sweep": 1},
          f"cuda_halo[general, 1 shard] apply launches {counts}")
    rel_check(out1, dense.apply(F.double()), TOL_PATH,
              "cuda_halo[general, 1 shard] apply vs f64 dense")
    res1, counts = run_path("cuda_halo[general, 1 shard] solve[jacobi] (a)",
                            lambda: plan1_n.solve(Y, "jacobi", **kw_a))
    check({k: v for k, v in counts.items() if v} == {"jacobi_sweep": 1},
          f"cuda_halo[general, 1 shard] solve launches {counts}")
    rel_check(res1.x, ref.x, TOL_PATH,
              "cuda_halo[general, 1 shard] solve[jacobi] (a) vs f64 dense")
    del plan1, plan1_n, out1, res1, ref

    # -- the bf16 sweep mode: apply and the setting (a) Jacobi solve ---------
    plan16 = op.plan("cuda", sweep_dtype="bf16")
    plan_n16 = op_n.plan("cuda", sweep_dtype="bf16")
    check(plan16.info["sweep_dtype"] == "bf16"
          and ops.cheb_sweep_l2_bytes(N, BATCH, scratch_dtype="bf16",
                                      stored=SL.stored)
          <= plan16.info["sweep_l2_budget"]
          and ops.jacobi_sweep_l2_bytes(N, BATCH, scratch_dtype="bf16",
                                        stored=SL.stored)
          <= ops.DEFAULT_SWEEP_L2_BUDGET,
          "the bf16 plans must take the sweeps at the smoke shape")
    out16, counts = run_path("apply[bf16]", lambda: plan16.apply(F),
                             tally=bf16_launches)
    check({k: v for k, v in counts.items() if v} == {"cheb_sweep": 1},
          f"apply[bf16] launches {counts}")
    rel_check(out16, dense.apply(F.double()), TOL_BF16,
              "apply[bf16] vs f64 dense")
    res16, counts = run_path("solve[jacobi] (a) [bf16]",
                             lambda: plan_n16.solve(Y, "jacobi", **kw_a),
                             tally=bf16_launches)
    check({k: v for k, v in counts.items() if v} == {"jacobi_sweep": 1},
          f"solve[jacobi] (a) [bf16] launches {counts}")
    ref = GraphOperator(P=L_norm.double(), multipliers=ssl_mult, lmax=2.0,
                        K=K).plan("dense").solve(Y.double(), "jacobi", **kw_a)
    rel_check(res16.x, ref.x, TOL_BF16, "solve[jacobi] (a) [bf16] vs f64 dense")
    del plan16, plan_n16, out16, res16, ref

    # -- serving: the engine over this plan, one CUDA graph per bucket ------
    serve_row, served_launches = _serving_phase(plan, dense, smi)
    path_rows.append(serve_row)
    for k, v in served_launches.items():
        path_launches[k] += v
    torch.cuda.empty_cache()

    # -- Algorithm 3: the wavelet lasso ---------------------------------------
    gamma = lasso.ista_step_size(op)
    res, counts = run_path(
        "solve_lasso",
        lambda: plan.solve_lasso(Y, MU, gamma=gamma, n_iters=LASSO_ITERS),
        steady_iters=1)
    check(counts["ista_shrink"] == LASSO_ITERS
          and counts["cheb_sweep"] == LASSO_ITERS + 1
          and counts["sliced_ell_spmv"] == (LASSO_ITERS + 1) * K,
          f"solve_lasso launches {counts}")
    ref = dense.solve_lasso(Y.double(), MU, gamma=gamma, n_iters=LASSO_ITERS)
    print(f"  gamma={gamma:.6f}, non-zero coefficients "
          f"{int((res.coeffs != 0).sum())} of {res.coeffs.numel()}")
    rel_check(res.coeffs, ref.coeffs, TOL_PATH, "lasso coefficients vs f64")
    rel_check(res.signal, ref.signal, TOL_PATH, "lasso signal vs f64")
    del dense, op64, ref, res

    # -- Section III-D: semi-supervised classification ----------------------
    labels = ((coords[:, 0] > 0.5).astype(np.int64)
              + 2 * (coords[:, 1] > 0.5).astype(np.int64))
    mask = np.zeros(N, dtype=bool)
    mask[np.random.default_rng(SEED).choice(N, int(LABELED * N),
                                            replace=False)] = True
    res, counts = run_path(
        "semi_supervised_classify",
        lambda: ssl.semi_supervised_classify(L_norm, labels, mask, N_CLASSES,
                                             backend="cuda", lmax=2.0),
        steady_iters=1)
    check({k: v for k, v in counts.items() if v} == {"cheb_sweep": 1},
          f"SSL launches {counts}")
    ref = ssl.semi_supervised_classify(L_norm.double(), labels, mask,
                                       N_CLASSES, backend="dense", lmax=2.0,
                                       device=dev)
    rel_check(res.scores, ref.scores, TOL_PATH, "SSL scores vs f64 dense")
    top2 = torch.topk(ref.scores, 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > PRED_MARGIN
    agree = res.predictions[clear] == ref.predictions[clear]
    print(f"  SSL predictions agree on {int(agree.sum())} of "
          f"{int(clear.sum())} vertices with a top-two gap > {PRED_MARGIN}; "
          f"accuracy on unlabeled {ssl.accuracy(res, labels, mask):.4f}")
    check(bool(agree.all()), "SSL predictions differ from float64 dense")
    del res, ref

    # -- invariants: the run-time checks over this shape's plans ------------
    from repro_torch.analysis import check_plan

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    inv_report, inv_findings = {}, []
    for p in (plan, op.plan("dense")):
        inv_findings += check_plan(p, n=N, batches=INV_BATCHES,
                                   solve_methods=INV_SOLVES,
                                   report=inv_report)
    torch.cuda.synchronize()
    inv_launches = {k.__name__: k.launches for k in counters}
    for k, v in inv_launches.items():
        path_launches[k] += v
    inv_seconds = time.perf_counter() - t0
    check(all(inv_launches[k] > 0 for k in ("cheb_sweep", "sliced_ell_spmv",
                                            "jacobi_sweep")),
          f"the invariant checks must launch the kernels: {inv_launches}")
    print(f"invariant checks on one card: cuda and dense plans at n={N}, "
          f"B={INV_BATCHES}, solves {INV_SOLVES}: {inv_report['calls']} "
          f"calls in {inv_seconds:.1f} s, launches "
          f"{ {k: v for k, v in inv_launches.items() if v} }, "
          f"{len(inv_findings)} finding(s)")

    # -- SENSOR500: the paper's own workload through the three examples ------
    sensor_row = _sensor500_phase(dev, counters, path_launches)
    path_rows.append(sensor_row)

    # -- the wire codec on the card (phase 1 of the compressed exchange) ----
    codec = _codec_checks(dev)
    for c in codec:
        for dt in ("bf16", "int8"):
            r = c[dt]
            print(f"codec {dt} ({c['shape'][0]}, {c['shape'][1]}) tile: wire "
                  f"{r['wire_bytes']} bytes, byte-equal to the CPU's; round "
                  f"trip err {r['err']:.3e} (tol {r['tol']:.3e}); encode + "
                  f"decode {r['ms']:.4f} ms (CUDA events), device_ms "
                  f"{r['device_ms']} ({smi})")
    path_rows.append(dict(name="codec encode + decode", tiles=codec))

    # -- the sharded apply: SHARDS ranks on the one card ---------------------
    # every rank builds the graph from the seed and keeps its own shard;
    # NCCL refuses two ranks on one card, so the group is gloo and the
    # tiles go through pinned host memory
    import tempfile

    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        # (c)'s graph and partition, built once here for every rank
        t0 = time.perf_counter()
        csr_c, meta_c = community_graph_csr(COMMUNITY_N, seed=SEED)
        t_graph = time.perf_counter() - t0
        t0 = time.perf_counter()
        parts_c = partition_general(csr_c, SHARDS, method="spectral",
                                    block=COMMUNITY_BLOCK, seed=SEED)
        t_part = time.perf_counter() - t0
        torch.save({"csr": csr_c, "meta": meta_c, "parts": parts_c},
                   Path(tmp) / "community.pt")
        print(f"community graph: n={csr_c.n} |E|={meta_c['n_edges']} "
              f"nnz={csr_c.nnz} lmax={meta_c['lmax']:.4f} built in "
              f"{t_graph:.1f} s; spectral partition over {SHARDS} shards in "
              f"{t_part:.1f} s (host): offsets {parts_c.offsets}, tiles "
              f"{parts_c.tile_widths}, edge cut {parts_c.edge_cut}, blocks "
              f"{tuple(parts_c.blocks.shape)}")
        del csr_c, parts_c
        t0 = time.perf_counter()
        try:
            mp.spawn(_sharded_rank, args=(SHARDS, tmp, save_wire_signal),
                     nprocs=SHARDS, join=True)
        finally:
            _stop_resource_tracker()
        ranks = []
        for r in range(SHARDS):
            with open(Path(tmp) / f"rank{r}.json") as f:
                ranks.append(json.load(f))
    gen_c = ranks[0]["general"]
    print(f"sharded: {SHARDS} ranks, {SHARD_LABEL}: "
          f"{time.perf_counter() - t0:.1f} s including the spawn; halo "
          f"width h={ranks[0]['halo_width']}, |E|={ranks[0]['n_edges']}; "
          f"general partition ({gen_c['method']}): offsets "
          f"{gen_c['offsets']}, tiles {gen_c['tile_widths']}, edge cut "
          f"{gen_c['edge_cut']}")
    sharded_rows = []
    for i, row in enumerate(ranks[0]["paths"]):
        per_rank = [r["paths"][i] for r in ranks]
        for k in row["launches"]:
            launched = sum(p["launches"][k] for p in per_rank)
            path_launches[k] += launched
            sharded_launches[k] += launched
        h = (max(gen_c["tile_widths"]) if "[general]" in row["name"]
             else ranks[0]["halo_width"])
        agg = dict(row, label=SHARD_LABEL, halo_width=h,
                   steady_ms_max=max(p["steady_ms"] for p in per_rank),
                   exchange_wait_ms_max=max(p["exchange_wait_ms"]
                                            for p in per_rank),
                   rel_err_max=max(p["rel_err"] for p in per_rank))
        sharded_rows.append(agg)
        _print_sharded_path(row, agg, BATCH)
    exchange = [r["exchange_only_ms_per_round"] for r in ranks]
    print(f"sharded exchange alone [{SHARD_LABEL}]: one (B={BATCH}, "
          f"h={ranks[0]['halo_width']}) f32 tile each way per round, "
          f"{min(exchange):.3f} to {max(exchange):.3f} ms per round over "
          f"ranks (CUDA events, {K} rounds per call)")
    print(f"sharded cuda_halo apply under torch.profiler on rank 0 "
          f"[{SHARD_LABEL}]: {ranks[0]['profile']}")
    path_rows.extend(sharded_rows)
    path_rows.append(dict(name="sharded exchange alone", label=SHARD_LABEL,
                          ms_per_round=exchange,
                          profile_cuda_halo_apply=ranks[0]["profile"]))
    # (c) the community graph
    com = [r["community"] for r in ranks]
    c0 = com[0]
    print(f"community [{SHARD_LABEL}]: n={c0['n']}, |E|={c0['n_edges']}, "
          f"offsets {c0['offsets']}, h per offset {c0['tile_widths']}, "
          f"edge cut {c0['edge_cut']}; per rank: padded rows "
          f"{c0['n_local_padded']}, interior nnz "
          f"{[c['interior_nnz'] for c in com]}, stored_per_nnz "
          f"{[round(c['stored_per_nnz'], 4) for c in com]}, coupling nnz "
          f"{[c['coupling_nnz'] for c in com]}, plan build "
          f"{[round(c['build_ms'], 1) for c in com]} ms")
    for i, row in enumerate(c0["paths"]):
        per_rank = [c["paths"][i] for c in com]
        for k in row["launches"]:
            launched = sum(p["launches"][k] for p in per_rank)
            path_launches[k] += launched
            sharded_launches[k] += launched
        agg = dict(row, label=SHARD_LABEL, halo_width=max(c0["tile_widths"]),
                   steady_ms_max=max(p["steady_ms"] for p in per_rank),
                   exchange_wait_ms_max=max(p["exchange_wait_ms"]
                                            for p in per_rank),
                   rel_err_max=max(p["rel_err"] for p in per_rank))
        _print_sharded_path(row, agg, COMMUNITY_B)
        path_rows.append(agg)
    exchange = [c["exchange_only_ms_per_round"] for c in com]
    print(f"community exchange alone [{SHARD_LABEL}]: one (B={COMMUNITY_B}, "
          f"h_k) f32 tile per offset {c0['offsets']} per round, "
          f"{min(exchange):.3f} to {max(exchange):.3f} ms per round over "
          f"ranks (CUDA events, {K} rounds per call)")
    print(f"community apply under torch.profiler on rank 0 "
          f"[{SHARD_LABEL}]: {c0['profile']}")
    path_rows.append(dict(name="community exchange alone", label=SHARD_LABEL,
                          ms_per_round=exchange,
                          profile_apply=c0["profile"]))
    coupling = c0["coupling"]
    print(f"kernel sliced_ell_spmv_accumulate (the couplings of rank 0, "
          f"{coupling['rows']} x {coupling['cols']}, nnz {coupling['nnz']}, "
          f"stored {coupling['stored']}) B={COMMUNITY_B}: max_abs_err="
          f"{coupling['max_abs_err']:.3e} rel={coupling['rel_err']:.3e} (tol "
          f"{TOL_SPMV}) ms={coupling['ms']:.4f} device_ms="
          f"{coupling['device_ms']} plain_ms={coupling['plain_ms']:.4f} "
          f"library_ms(torch.addmm CSR)={coupling['library_ms']} "
          f"library_device_ms={coupling['library_device_ms']} bound_ms="
          f"{coupling['bound_ms']:.5f} ({coupling['bound_by']}, y over the "
          f"{coupling['entry_rows']} rows that hold an entry) "
          f"bound_touched_ms={coupling['bound_touched_ms']:.5f} (y over the "
          f"{coupling['touched_rows']} rows of the slices that hold one) "
          f"[{SHARD_LABEL}]")
    # (b) of the serving phase: one engine per rank over cuda_halo
    srv = [r["serving"] for r in ranks]
    for r in srv:
        for k, v in r["launches"].items():
            path_launches[k] += v
            sharded_launches[k] += v
    print(f"serving over cuda_halo [{SHARD_LABEL}]: {BATCH} submits per "
          f"rank made batches {srv[0]['batches']}, {srv[0]['rounds']} "
          f"counted rounds, {srv[0]['total_bytes']} bytes (halo_bytes_per_"
          f"apply x {BATCH}), rows equal to the direct call bit for bit, "
          f"rel err max over ranks {max(r['rel_err'] for r in srv):.3e} "
          f"(tol {TOL_PATH}); clean and faulted plans side by side gave the "
          f"batches {srv[0]['fault_labels']}; first call "
          f"{max(r['first_ms'] for r in srv):.1f} ms max over ranks")
    path_rows.append(dict(name="serving over cuda_halo", label=SHARD_LABEL,
                          ranks=srv))
    # the compressed wires, the faults and gossip (phases 2-5)
    exchange_launches, gossip_step = _report_exchange_phases(
        ranks, smi, path_rows, names)
    for k, v in exchange_launches.items():
        path_launches[k] += v
        sharded_launches[k] += v
    for part, ratio in ranks[0]["wires"]["ratios"].items():
        print(f"int8 / bf16 wire error on the sensor graph ({part}, "
              f"cuda_halo, rank 0): {ratio!r} [{SHARD_LABEL}] ({smi})")
    path_rows.append(dict(name="int8 / bf16 wire error ratio",
                          label=SHARD_LABEL,
                          ratios=ranks[0]["wires"]["ratios"]))
    # the invariants on the ranks, then the AST layer: one line
    inv_row = _report_invariants(ranks, inv_findings, inv_report,
                                 inv_seconds)
    path_rows.append(inv_row)
    for r in ranks:
        for k, v in r["invariants"]["launches"].items():
            path_launches[k] += v
            sharded_launches[k] += v
    del ranks, com

    # -- the dense LM forward: starcoder2-3b, full width and depth -----------
    t0 = time.perf_counter()
    lm_gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, lm_gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_S), device=dev,
                           generator=lm_gen)
    torch.cuda.synchronize()
    n_params = count_params(cfg)
    print(f"lm: {LM_ARCH} {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{hq}/{hkv} heads of {hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {n_params} parameters in {cfg.dtype} "
          f"({time.perf_counter() - t0:.1f} s to draw on the card); "
          f"B={LM_B} S={LM_S}")
    check(cfg.n_layers == 30 and cfg.d_model == 3072 and hq == 24
          and hkv == 2 and hd == 128, "starcoder2-3b at full width")
    run_flash = RunConfig(attn_impl="flash")
    logits, counts = run_path(
        f"lm_forward[{LM_ARCH}, B={LM_B}, S={LM_S}]",
        lambda: forward(cfg, params, tokens, run_flash))
    check({k: v for k, v in counts.items() if v}
          == {"flash_attention_wgmma": cfg.n_layers},
          f"the LM forward must be {cfg.n_layers} tensor-core flash "
          f"launches, got {counts}")
    lm_row = path_rows[-1]
    lm_row["tokens_per_s"] = LM_B * LM_S / (lm_row["steady_ms"] / 1e3)
    print(f"  tokens/s {lm_row['tokens_per_s']:.1f} (steady)")
    check(tuple(logits.shape) == (LM_B, LM_S, cfg.vocab_size)
          and logits.dtype == torch.bfloat16, "logits shape / dtype")
    loss = float(lm_loss(logits, tokens))
    # the same forward with the kernel's plain f32 version as attention
    with mock.patch.object(ops, "flash_attention", flash_attention_plain):
        logits_ref = forward(cfg, params, tokens, run_flash)
    loss_ref = float(lm_loss(logits_ref, tokens))
    err, rel = rel_check(logits, logits_ref, TOL_LM_LOGITS,
                         "LM logits vs the plain-attention forward")
    print(f"  loss {loss:.6f} vs {loss_ref:.6f} (tol {TOL_LM_LOSS})")
    check(math.isfinite(loss) and abs(loss - loss_ref) <= TOL_LM_LOSS,
          f"LM loss {loss} vs {loss_ref}")
    lm_row.update(logits_max_abs_err=err, logits_rel_err=rel, loss=loss,
                  loss_ref=loss_ref)
    lm_row["profile"] = device_breakdown(
        lambda: forward(cfg, params, tokens, run_flash),
        {"flash_attention": ("flash_attention_wgmma_kernel",),
         "matmul": ("gemm", "cutlass", "xmma", "nvjet")})
    print(f"  device time by kernel group, one forward under torch.profiler "
          f"(ms): {lm_row['profile']}")
    del params, logits, logits_ref

    # the f32 forward takes the FFMA kernel: starcoder2-3b reduced to two
    # layers of four heads of 16 (f32), B = 2, a ragged S = 1000, held
    # against the same forward through the materialised attention
    cfg32 = cfg.reduced()
    gen32 = torch.Generator(device=dev).manual_seed(SEED)
    params32 = init_params(cfg32, gen32, device=dev)
    toks32 = torch.randint(0, cfg32.vocab_size, (LM_B, 1000), device=dev,
                           generator=gen32)
    logits32, counts = run_path(
        f"lm_forward[{LM_ARCH} reduced, f32, B={LM_B}, S=1000]",
        lambda: forward(cfg32, params32, toks32, run_flash))
    check({k: v for k, v in counts.items() if v}
          == {"flash_attention_ffma": cfg32.n_layers},
          f"the f32 forward must be {cfg32.n_layers} FFMA flash launches, "
          f"got {counts}")
    rel_check(logits32, forward(cfg32, params32, toks32, RunConfig("ref")),
              TOL_LM_F32, "f32 LM logits vs the materialised attention")
    del params32, logits32

    print(f"path launches (all counted runs): {path_launches}; bf16 sweep "
          f"paths: {bf16_launches}; of these, the sharded paths "
          f"({SHARD_LABEL}, summed over ranks): {sharded_launches}")
    check(all(v > 0 for v in path_launches.values()),
          "every kernel of the paths must launch")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    # -- the records ----------------------------------------------------------
    s64 = spmv_rows[BATCH]

    def row(name, source, replaces, r, **extra):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": replaces, "launches": path_launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms"),
                "device_ms": r["device_ms"],
                "sharded_launches": sharded_launches[name],
                "exchange_launches": exchange_launches[name],
                "served_launches": served_launches.get(name, 0), **extra}

    step_row = dict(max_abs_err=max(err_tk, err_acc), ms=step_ms,
                    plain_ms=step_plain, bound_ms=step_b[0],
                    bound_by=step_b[1], device_ms=step_dev)
    sweep_row = dict(max_abs_err=err_sw, ms=sweep_ms, plain_ms=sweep_plain,
                     bound_ms=sweep_b[0], bound_by=sweep_b[1],
                     device_ms=sweep_dev)
    kernels = [
        row("sliced_ell_spmv", "sliced_ell_spmv.cu",
            "src/repro/kernels/bcsr_spmv.py:106", s64,
            also_replaces="src/repro/kernels/bcsr_spmv.py:56",
            batch=BATCH, stored_per_nnz=SL.stored_per_nnz,
            b1=spmv_rows[1], b448=spmv_rows[BATCH * eta]),
        # the same kernel's rectangular, accumulating launch: a general
        # partition's couplings (the JAX package scattered them with
        # y.at[rows].add around its Block-ELL SpMV)
        row("sliced_ell_spmv_accumulate", "sliced_ell_spmv.cu",
            "src/repro/kernels/bcsr_spmv.py:106", coupling,
            scatters="src/repro/dist/partition.py:784",
            batch=COMMUNITY_B, shape=[coupling["rows"], coupling["cols"]],
            nnz=coupling["nnz"], entry_rows=coupling["entry_rows"],
            touched_rows=coupling["touched_rows"],
            bound_touched_ms=coupling["bound_touched_ms"],
            label=SHARD_LABEL),
        row("cheb_step", "cheb_step.cu", "src/repro/kernels/cheb_step.py:66",
            step_row, gossip_leaf=gossip_step),
        row("cheb_sweep", "cheb_sweep.cu",
            "src/repro/kernels/cheb_sweep.py:121", sweep_row,
            stored_per_nnz=SL.stored_per_nnz),
        row("jacobi_step", "jacobi_step.cu",
            "src/repro/kernels/jacobi_step.py:50", js_rows["path"],
            forms=js_rows),
        row("jacobi_sweep", "jacobi_sweep.cu",
            "src/repro/kernels/cheb_sweep.py:222", jsw_rows["a"],
            settings=jsw_rows,
            stored_per_nnz=A_n.sliced_ell().stored_per_nnz),
        row("ista_shrink", "ista_shrink.cu",
            "src/repro/kernels/soft_threshold.py:28", ist_rows["scale"],
            forms=ist_rows),
        row("flash_attention_wgmma", "flash_attention.cu",
            "src/repro/kernels/flash_attention.py:77", flash_rows["layer"],
            checks={k: v for k, v in flash_rows.items()
                    if v["kernel"] == "flash_attention_wgmma"}),
        row("flash_attention_ffma", "flash_attention.cu",
            "src/repro/kernels/flash_attention.py:77",
            flash_rows["ragged_f32"],
            checks={k: v for k, v in flash_rows.items()
                    if v["kernel"] == "flash_attention_ffma"}),
        dict(row("cheb_sweep", "cheb_sweep.cu",
                 "src/repro/kernels/cheb_sweep.py:121",
                 bf16_rows["cheb_sweep"], scratch_dtype="bf16"),
             name="cheb_sweep_bf16", launches=bf16_launches["cheb_sweep"],
             sharded_launches=0, exchange_launches=0, served_launches=0),
        dict(row("jacobi_sweep", "jacobi_sweep.cu",
                 "src/repro/kernels/cheb_sweep.py:222",
                 bf16_rows["jacobi_sweep"], scratch_dtype="bf16"),
             name="jacobi_sweep_bf16",
             launches=bf16_launches["jacobi_sweep"], sharded_launches=0,
             exchange_launches=0, served_launches=0),
    ]
    left = _children()
    check(not left, f"processes this script started are still running: "
          f"{left}")
    print(json.dumps({"paths": path_rows}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
