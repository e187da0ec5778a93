#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It

1. builds every CUDA kernel of the port from ``src/repro_torch/csrc``;
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes of the paths below, and times both (plus one PyTorch library
   call computing the same product, where there is one): the sliced-ELL
   SpMV at B = 1, 64 and 448 (also against the Block-ELL plain version on
   the same P), the Chebyshev and Jacobi steps in both instances (the
   stand-alone ones, the Chebyshev one also in the per-order loop's
   prepared in-place form, and the fused `cheb_order` / `jacobi_round`,
   which run the sliced-ELL product inside), both sweeps (which read the
   same sliced-ELL layout as the SpMV), the ISTA shrink (also written over
   its input, one-shot and in the ISTA loops' prepared form) and both
   flash-attention kernels;
3. drives the main path — ``GraphOperator(...).plan("cuda")`` `apply`,
   `apply_adjoint`, `apply_gram` and the ``sweep=False`` apply — on the
   Section IV-D random sensor network at n = 16384 sensors, the SGWT union
   with J = 6 (eta = 7), K = 20, on a batch of 64 signals, and holds every
   output against the port's float64 ``plan("dense")`` on the card;
4. times the whole-recurrence sweep against the per-order path on both
   sides of the sweep's L2 budget, drives the plan's apply at B = 256
   (the guard's fallback: K `cheb_order` launches) and the per-order path
   at n = 2**18 sensors (its sliced-ELL layout packed on the card from
   COO; past the budget at B = 64), each held against float64;
5. drives the Section-V solvers (`plan.solve`, all four methods, in the
   Fig. 2 settings (a) P = L_norm, r = 1, 20 rounds and (b) P = L, r = 2,
   10 rounds of Jacobi), the per-round path (``history=True``: one
   `jacobi_round` launch per round) and the
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
   couplings' kernel, which reads the received tiles in place over the
   rows that hold an entry): (a) on one shard in
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
   a batch; then one wall-clock engine over two ``cuda_halo`` plans of
   the group (banded and BFS general): rank 0 leads, replaying seeded
   Poisson streams of DEFAULT_MIX (half to each plan) at 25, 100 and 400
   requests /s for 3 s each and broadcasting each packed batch, the
   other ranks follow (every request exactly once, each follower running
   the leader's batch count, the first batch of each (plan, kind,
   bucket) equal to a direct call of its entry on every rank bit for
   bit, every served `apply` row within 1e-4 of float64 dense, each
   batch's counted rounds and bytes those of the direct call and the
   byte model, the step, SpMV and coupling kernels launched as the
   direct calls launch them; p50 / p99, signals /s, occupancy, padding
   and the broadcast's host ms and share of a dispatch per rate);
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
14. serves the LM through the KV cache (`models.decode`, `models.steps.
   build_serve_step`, `launch.serve`) with starcoder2-3b's parameters of
   phase 7: B = 8 prompts of 512 tokens prefilled token by token, then 63
   serve steps, every step under ``set_sync_debug_mode("error")`` (no
   host read), timed (CUDA events) and traced (kernels per step, busy
   share), and its logits held at all 64 decoded positions against the
   flash forward over the prompt and the generated ids (one tensor-core
   launch per layer); an f8 (e4m3) cache against the bf16 cache; the
   launcher's `main` at full width; and the qwen2-vl-2b backbone (28
   layers, M-RoPE, 64 vision embeddings in a 128-token prompt), timed in
   bf16 and held in f32 against the f32 flash forward (the FFMA kernel),
   where bf16 alone sits at this model's noise floor.  Decode attends
   through the plain `attention_ref`, as the JAX package does outside
   its Pallas kernel;
15. trains (`models.steps.build_train_step`, `launch.train`): first the
   sharded step on a 1x1 ("data", "model") DeviceMesh over a one-rank
   NCCL group ("mesh 1x1, NCCL, one card": `dist.sharding`, DTensor
   parameters laid out by `param_pspecs` under the default and fsdp
   schemes), 2 steps from the parameters of phase 7 held against the
   plain step (step 0's loss and grad norm in float32 ulps, ms per step,
   peak MiB), the launcher's ``--dp-mode pjit --mesh 1x1`` against the
   plain launcher, qwen3-moe-30b-a3b reduced with the grouped dispatch
   under rules, the other families reduced (train steps and a sharded
   prefill against the plain ones), and gloo's collectives on CUDA
   tensors tried once (in (c)'s ranks); (a) the
   starcoder2-3b parameters of phase 7 at full width and depth, on
   `SyntheticLMData` batches of 8 x 256 tokens, 6 steps at lr 1e-3
   (autograd through the plain attention, the global-norm clip, AdamW
   with float32 moments): step 0's loss equal to `build_loss_fn`'s, step
   0's loss and gradients twice from the same state bit for bit, every
   loss and grad norm finite, and step 0's batch at a lower loss after
   the step (the JAX smoke test's learnable signal; over fresh batches
   the loss does not fall in 6 steps at this lr); ms per step, the
   optimizer's share, tokens/s, peak MiB and one step under the profiler;
   (b) the launcher's fail-and-resume protocol (qwen1.5-4b reduced, a
   crash at step 12, `--resume`) in three processes on the card, the
   resumed losses at steps 12, 15 and 17 the uninterrupted run's; (c)
   ``--dp-mode gossip --mesh 4x1`` on 4 gloo ranks on the card
   (starcoder2-3b reduced, B 8, S 32, 4 steps): rank 0's losses within
   1e-5 of the plain trainer's, the consensus's `cheb_step` launches
   counted (K - 1 per leaf and per loss, each step), ms per step and the
   gossip's share;
16. drives the other model families at full width (`FAMILY_RUNS`):
   qwen3-moe-30b-a3b (48 layers, 128 experts top 8), deepseek-v2-236b (MLA
   and 160 experts top 6 plus 2 shared; 4 of its 60 layers), rwkv6-1.6b,
   hymba-1.5b (window 1024 beside the mamba branch) and whisper-large-v3
   (32 encoder layers over 1500 frames, 32 decoder layers with
   cross-attention): the bf16 forward with ``attn_impl="flash"`` (the
   tensor-core kernel once per attention the JAX dispatch sends to it:
   qwen3-moe's layers and whisper's encoder, decoder and cross-attention;
   MLA, hymba and RWKV6 take the plain paths), timed and traced by kernel
   group, then 32 serve steps from a 64-token prompt at B 2 under
   ``set_sync_debug_mode("error")``; the same configs cut to two layers
   in f32, decode held against the flash forward at all 96 positions
   (MoE: no assignment dropped, every expert pick equal or a printed near
   tie); the sub-quadratic caches at 2**20 tokens; and the tensor-core
   kernel at whisper's non-causal and cross shapes and qwen3-moe's layer,
   against its plain version and SDPA; then runs the LM serving example
   (`repro_torch.examples.serve_lm`: hymba-1.5b reduced, B 4, 16 prompt
   tokens and 24 generated) on the card;
17. shows through the kernels' launch counters that every path ran through
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

import dataclasses
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
# The LM decode phase: starcoder2-3b at full width and depth, a prefill of
# DEC_PROMPT tokens then DEC_GEN - 1 serve steps on DEC_B sequences (the
# cache holds DEC_PROMPT + DEC_GEN slots: one more step is profiled);
# decode's logits are held at every decoded position against the flash
# forward over the prompt and the generated tokens, at TOL_LM_LOGITS (a
# bf16 model either way, in other summation orders).  The f8 cache: the
# last prefill logits against the bf16 cache's, at the JAX package's f8
# criterion (tests/test_models_smoke.py:105-122).  The VLM backbone at
# full width: VLM_VISION N(0, 1) vision embeddings replace the first
# prompt embeddings.  In bf16 its flash forward and its plain-attention
# forward already differ by 3.9e-2 to 5.0e-2 of the max (and each from
# the f32 forward by as much), so bf16 decode cannot be held to it at
# TOL_LM_LOGITS; the same weights in f32 are held at TOL_LM_F32.
DEC_B, DEC_PROMPT, DEC_GEN = 8, 512, 64
F8_B, F8_PROMPT = 8, 128
MIN_F8_CORR = 0.98
VLM_ARCH = "qwen2-vl-2b"
VLM_B, VLM_VISION, VLM_PROMPT, VLM_GEN = 2, 64, 128, 16
# The LM train phase: (a) starcoder2-3b at full width and depth, the
# train step (autograd through the plain attention, the clip, AdamW) on
# SyntheticLMData batches of TRAIN_B x TRAIN_S (seed 0) for TRAIN_STEPS
# steps at TRAIN_LR; (b) the launcher's fail-and-resume protocol
# (tests/test_checkpoint.py:66-102) in three processes on the card; (c)
# the launcher's gossip data parallelism on GOSSIP_TRAIN_RANKS gloo ranks
# on the card, rank 0's losses against the plain trainer's on the same
# global batches within TOL_GOSSIP_TRAIN (exact consensus at K = 2).
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 8, 256, 6, 1e-3
# Step 0's sliced in-place AdamW on TRAIN_REF_LEAF (30 slices of 37.7e6
# elements at full width) against the JAX package's update of the whole
# leaf in float32 from copies of its gradient and parameters, at the same
# clip scale (the step's norm, itself held to the plain whole-leaf norm
# within TOL_TRAIN_NORM: another summation order).  Both do the same
# float32 operations in the same order, so m and v must be equal
# (ULPS_TRAIN_M, ULPS_TRAIN_V units in the last place) and the bf16
# parameters within ULPS_TRAIN_P.  Units are taken at the result's own
# magnitude: a weight that its update nearly cancels (|p| ~ lr) turns
# one float32 ulp of the update into many of the result.
TRAIN_REF_LEAF = ("layers", "w_in")
TOL_TRAIN_NORM = 1e-5
ULPS_TRAIN_M, ULPS_TRAIN_V, ULPS_TRAIN_P = 0, 0, 1
RESUME_ARGV = ["--arch", "qwen1.5-4b", "--smoke", "--steps", "18",
               "--batch", "2", "--seq", "16", "--ckpt-every", "6",
               "--log-every", "1"]
RESUME_FAIL_AT, RESUME_HELD = 12, ("12", "15", "17")
GOSSIP_TRAIN_RANKS = 4
GOSSIP_TRAIN_ARGV = ["--arch", "starcoder2-3b", "--smoke", "--steps", "4",
                     "--batch", "8", "--seq", "32", "--log-every", "1"]
TOL_GOSSIP_TRAIN = 1e-5
# The mesh phase ("mesh 1x1, NCCL, one card"): (a) the train phase's
# starcoder2-3b parameters (seed 0, full width and depth) on a 1x1
# ("data", "model") DeviceMesh over a one-rank NCCL group, laid out by
# `param_pspecs` under each of MESH_SCHEMES, MESH_STEPS steps of TRAIN_B
# x TRAIN_S at TRAIN_LR from copies of the same state, against the plain
# step: step 0's loss and grad norm run the same operations in the same
# order, so bit for bit is expected, and they are held at TOL_MESH
# relative; (b) the launcher's ``--dp-mode pjit --mesh 1x1`` (one rank in
# its own process group) against the plain launcher on GOSSIP_TRAIN_ARGV
# within TOL_MESH; (c) MESH_MOE_ARCH reduced (f32) with the grouped
# dispatch over MESH_MOE_GROUPS groups, MESH_STEPS steps of MESH_MOE_B x
# MESH_MOE_S under each scheme against the plain step within TOL_MESH;
# (d) each of MESH_FAMILIES reduced (f32) the same way under `default`,
# and its prefill of MESH_PROMPT tokens at B 2 (the sharded decode, the
# cache laid out by `cache_pspecs`) against the plain prefill within
# TOL_MESH of the logits' max.
MESH_LABEL = "mesh 1x1, NCCL, one card"
MESH_SCHEMES, MESH_STEPS, TOL_MESH = ("default", "fsdp"), 2, 1e-5
MESH_MOE_ARCH, MESH_MOE_GROUPS, MESH_MOE_B, MESH_MOE_S = (
    "qwen3-moe-30b-a3b", 2, 4, 16)
MESH_FAMILIES = ("deepseek-v2-236b", "rwkv6-1.6b", "hymba-1.5b",
                 "whisper-large-v3", "qwen2-vl-2b")
MESH_PROMPT = 4
# The remat phase: the train phase's starcoder2-3b parameters (seed 0,
# full width and depth), TRAIN_B x TRAIN_S, one `loss_and_grads` and one
# train step at TRAIN_LR under each of REMAT_RUNS from the same state
# (the parameters restored from a host copy after each step).  The
# levers replay the same operations on the same inputs, so step 0's
# loss, grad norm and every gradient must equal `none`'s bit for bit
# (REMAT_ULPS float32 units in the last place).  Printed: each mode's
# peak MiB of `loss_and_grads` alone and of the whole step, and the ms
# of two calls of each (CUDA events).
REMAT_RUNS = {"none": {}, "full": {"remat": "full"},
              "dots": {"remat": "dots"}, "named": {"remat": "named"},
              "dots+attn_remat": {"remat": "dots", "attn_remat": True}}
REMAT_ULPS = 0
# The dry-run phase: `python -m repro_torch.launch.dryrun` in a child
# process (its own fake group of 256 ranks, meta tensors) on DRYRUN_CELLS,
# one per kind; then `dryrun.count_step` over the real plain train step
# of the remat phase on the card and over the same step on meta tensors
# in this process: the same FLOPs (DRYRUN_FLOPS_REL), so the dry-run
# counts the step that runs.
DRYRUN_CELLS = (("starcoder2-3b", "train_4k"),
                ("starcoder2-3b", "decode_32k"), ("rwkv6-1.6b", "long_500k"))
DRYRUN_FLOPS_REL = 0.0
# The other model families (MoE, MLA, RWKV6, hymba, whisper) at full
# width: arch -> (layers kept, None for all; forward B; forward S).
# deepseek-v2-236b keeps 4 of its 60 layers (all 60 hold 479 GB of bf16
# weights; 4 hold 31.8 GB plus 2.1 GB of embedding and head); RWKV6 and
# hymba run their per-token recurrences from the host at B 2, S 512;
# whisper reads its 1500 frames with a decoder of 448 tokens (its maximum
# target length).  The bf16 forward goes through the flash kernel where
# the JAX dispatch sends it (FAMILY_FLASH: tensor-core launches per
# forward) at the config's own MoE capacity factor; then FAMILY_STEPS
# serve steps from a FAMILY_PROMPT-token prompt at FAMILY_B under
# set_sync_debug_mode("error").  The same config cut to FAMILY_F32_LAYERS
# layers (whisper: both stacks) in f32 holds decode against the flash
# forward at every one of the FAMILY_PROMPT + FAMILY_STEPS positions to
# TOL_FAMILY_F32 of the position's max logit, the MoE at the capacity
# factor n_experts / top_k (none dropped, as decode drops none); a
# different expert pick is a fault unless the k-th and (k+1)-th router
# logits lie within MOE_TIE_GAP (a near tie: that position leaves the
# hold, printed with its gap).
FAMILY_RUNS = {"qwen3-moe-30b-a3b": (None, 1, 2048),
               "deepseek-v2-236b": (4, 1, 2048),
               "rwkv6-1.6b": (None, 2, 512),
               "hymba-1.5b": (None, 2, 512),
               "whisper-large-v3": (None, 2, 448)}
FAMILY_B, FAMILY_PROMPT, FAMILY_STEPS = 2, 64, 32
FAMILY_F32_LAYERS = 2
TOL_FAMILY_F32 = 1e-4
MOE_TIE_GAP = 1e-5
# The sub-quadratic families' cache at 2**20 tokens against a full KV
# cache of the same model (tests/test_models_smoke.py:78-95's criterion).
SUBQ_MAX_SEQ, SUBQ_SHARE = 2**20, 0.01
# The flash kernel at the families' layer shapes: (B, Hq, Hkv, Sq, Sk, D,
# causal), bf16, held as the starcoder2-3b layer is (TOL_FLASH_ROW).
FAMILY_FLASH_CASES = {
    "whisper_encoder": (2, 20, 20, 1500, 1500, 64, False),
    "whisper_cross": (2, 20, 20, 448, 1500, 64, False),
    "whisper_decoder": (2, 20, 20, 448, 448, 64, True),
    "qwen3_moe_layer": (1, 32, 4, 2048, 2048, 128, True),
}

# The per-order path past the sweep's L2 budget in n: the sensor network
# at LARGE_N sensors (2**18; the paper's scale is 1e6), B = BATCH, K and
# J as above, its layout packed on the card from COO in chunks of
# LARGE_CHUNK strip-sorted vertices, held against float64 on
# LARGE_REF_SIGNALS signals.
LARGE_N, LARGE_CHUNK, LARGE_REF_SIGNALS = 2**18, 4096, 4

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

# The step kernels before their redesign (PERF.md's kernel table: NVIDIA
# H100 80GB HBM3, 700 W): CUDA-event ms and device ms per
# call of what each row's kernel replaces.  Printed beside this run's
# times as quoted text, never in the kernels line: this run does not
# measure them.
EARLIER_STEPS = {
    "cheb_step": "the stand-alone step ms 0.0564, device_ms 0.0308",
    "cheb_step_gossip_leaf": "ms 0.3392, device_ms 0.3238",
    "cheb_order": ("a SpMV launch and a step launch: ms 0.0594 + 0.0564, "
                   "device_ms 0.01997 + 0.0308 = 0.05077"),
    "jacobi_step": "the 'path' form ms 0.0671, device_ms 0.00812",
    "jacobi_round": ("a SpMV launch (device_ms 0.01997), three eager "
                     "Horner ops (not measured) and a step launch "
                     "(ms 0.0671, device_ms 0.00812)"),
}


def _earlier(name: str) -> str:
    return (f"earlier, quoted from PERF.md, not measured in this run: "
            f"{EARLIER_STEPS[name]} (H100 80GB HBM3, 700 W)")


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
# The wall-clock leader phase on the 4 ranks: rank 0 serves Poisson
# streams of DEFAULT_MIX at SERVE_LEADER_RATES for SERVE_LEADER_S seconds
# each, half of the requests to the banded and half to the general
# cuda_halo plan, and the other ranks follow.
SERVE_LEADER_RATES, SERVE_LEADER_S = (25.0, 100.0, 400.0), 3.0
SERVE_LEADER_OPS = ("banded", "general")
TRACE_REPLAYS = 3
# A trace session whose records lack the replayed kernel (CUPTI lost them:
# an H100 run's session of 3 replays held one device-to-device copy and
# nothing else) is traced again, up to TRACE_SESSIONS in all; every
# session is printed, and any host-to-device copy in any session fails.
TRACE_SESSIONS = 3
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


def device_breakdown(fn, groups, host_ops: bool = True):
    """One call of `fn` under torch.profiler: the device time of its
    kernels by group (the first of `groups`, name -> substrings, that
    matches a kernel's name, else "other"), their sum and its share of
    the call's wall time.  None when the trace holds no device time.
    ``host_ops=False`` traces the card alone: a forward that launches
    ~1e5 kernels from a host loop then takes seconds to read back, not a
    minute."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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
    leader = _leader_phase(rank, op, wparts, dense)
    invariants = _invariant_checks(op, plans, gen_plans, wparts)
    return dict(rank=rank, halo_width=h, n_edges=n_edges, paths=rows,
                wires=wires, faults=faulted, serving=serving, leader=leader,
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
    batches, and its labels carry the reference's fault key."""
    from repro_torch.dist import FaultSpec, comm
    from repro_torch.serve import DEFAULT_BUCKETS, ServeEngine, VirtualClock

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
    check(eng.role == "lockstep", f"serving on rank {rank}: {eng.role}")
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


def _leader_phase(rank: int, op, wparts, dense) -> dict:
    """The wall-clock leader phase on one rank of the group (every rank
    calls it together): one `WallClock` engine per rate over the banded
    and the general cuda_halo plan; rank 0 replays the rate's Poisson
    stream and the others `follow()`.  After the last rate the launch
    counts are read; then rank 0 broadcasts the first batch of each
    (plan, kind, bucket) and the plan and kind of every served batch,
    every rank runs those batches' entries directly (each call counted
    alone), and each rank holds its served launches to the sum of the
    direct calls' over the served batches; rank 0 holds the direct
    outputs to its served ones bit for bit, each served batch's rounds
    and bytes to the direct call's (an `apply`: K rounds and the byte
    model), and every served `apply` row to float64 dense."""
    import torch.distributed as dist

    from repro_torch.dist import comm
    from repro_torch.serve import (DEFAULT_BUCKETS, ServeEngine, WallClock,
                                   poisson_arrivals, signal_for)
    from repro_torch.serve.loadgen import DEFAULT_MIX

    dev = torch.device("cuda")
    counters = _graph_counters()
    plans = {name: op.plan("cuda_halo", partition=wparts[name])
             for name in SERVE_LEADER_OPS}
    _, _, method, solve_kw = DEFAULT_MIX[1]
    t0 = time.perf_counter()
    for p in plans.values():  # every entry's first call, on every rank
        p.bucketed_callables(DEFAULT_BUCKETS, solve_specs=[(method,
                                                            solve_kw)],
                             warm=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    leader = rank == 0
    first, batches, applied, rates = {}, [], [], {}
    for k in counters:
        k.launches = 0
    for rate in SERVE_LEADER_RATES:
        eng = ServeEngine(plans, buckets=DEFAULT_BUCKETS,
                          max_wait=SERVE_MAX_WAIT, clock=WallClock(),
                          sync_results=True)
        check(eng.role == ("leader" if leader else "follower"),
              f"leader phase on rank {rank}: role {eng.role}")
        if not leader:
            rates[f"{rate:g}"] = dict(followed=eng.follow())
            continue
        orig = eng._callable

        def recording(key, group, _orig=orig):
            fn = _orig(key, group)

            def run(batch):
                with comm.counting() as rec:
                    out = fn(batch)
                plan = plans[key.op]
                st = rec.stats(SHARDS, batch.shape[0],
                               plan.info["exchange_collectives_per_round"])
                tag = (key.op, key.kind, batch.shape[0])
                batches.append(dict(tag=tag, rounds=st.exchange_rounds,
                                    total_bytes=st.total_bytes))
                if tag not in first:
                    first[tag] = dict(method=group.method,
                                      solve_kwargs=group.solve_kwargs,
                                      batch=batch.clone(), out=out.clone())
                return out

            return run

        eng._callable = recording
        events = [dataclasses.replace(
            ev, op=SERVE_LEADER_OPS[i % len(SERVE_LEADER_OPS)])
            for i, ev in enumerate(poisson_arrivals(
                rate, int(rate * SERVE_LEADER_S), seed=SEED))]
        sigs = torch.from_numpy(np.stack([signal_for(ev, N)
                                          for ev in events])).to(dev)
        futs = []
        start = eng.clock.now()
        for ev, sig in zip(events, sigs):
            target = start + ev.t
            while eng.clock.now() < target:
                if not eng.poll():
                    time.sleep(1e-4)
            futs.append(eng.submit(sig, op=ev.op, kind=ev.kind,
                                   method=ev.method, **ev.kwargs()))
        while eng.pending_count:
            if not eng.poll():
                time.sleep(1e-4)
        eng.close()
        torch.cuda.synchronize()
        s = eng.metrics.summary()
        check(s["served_exactly_once"] and s["n_served"] == len(events)
              and all(f.response.ok for f in futs)
              and eng.n_broadcasts == s["n_batches"],
              f"leader at {rate:g}/s: {s}, {eng.n_broadcasts} broadcasts")
        dispatch_ms = 1e3 * float(np.mean([
            b.t_complete - b.t_dispatch for b in eng.metrics.batches]))
        bcast_ms = 1e3 * eng.broadcast_s / eng.n_broadcasts
        rates[f"{rate:g}"] = dict(
            summary=s, n_requests=len(events), dispatch_ms=dispatch_ms,
            broadcast_ms=bcast_ms, broadcast_share=bcast_ms / dispatch_ms,
            kinds={k: sum(ev.kind == k for ev in events)
                   for k in ("apply", "solve")})
        applied += [(sig, f.result()) for ev, sig, f in
                    zip(events, sigs, futs) if ev.kind == "apply"]
        del sigs, futs
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters if k.launches}
    # the direct calls, on every rank together
    box = [None if not leader else dict(
        tags=[b["tag"] for b in batches],
        followed={r: v["summary"]["n_batches"] for r, v in rates.items()},
        first=[dict(tag=t, method=d["method"],
                    solve_kwargs=d["solve_kwargs"], batch=d["batch"].cpu())
               for t, d in first.items()])]
    dist.broadcast_object_list(box, src=0)
    sent = box[0]
    if not leader:
        for r, n in sent["followed"].items():
            check(rates[r]["followed"] == n,
                  f"follower rank {rank} at {r}/s ran "
                  f"{rates[r]['followed']} batches, the leader {n}")
    direct, bitwise = {}, {}
    for d in sent["first"]:
        opname, kind, bucket = d["tag"]
        plan = plans[opname]
        fn = (plan.compiled_solve(d["method"], **d["solve_kwargs"])
              if kind == "solve" else plan.compiled(kind))
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        with comm.counting() as rec:
            out = fn(d["batch"].to(dev))
        torch.cuda.synchronize()
        st = rec.stats(SHARDS, bucket,
                       plan.info["exchange_collectives_per_round"])
        direct[d["tag"]] = dict(
            rounds=st.exchange_rounds, total_bytes=st.total_bytes,
            launches={k.__name__: k.launches for k in counters
                      if k.launches})
        if leader:
            bitwise[d["tag"]] = bool(torch.equal(out, first[d["tag"]]["out"]))
    want = {}
    for tag in sent["tags"]:
        for k, v in direct[tag]["launches"].items():
            want[k] = want.get(k, 0) + v
    check(launches == want, f"leader phase on rank {rank}: served launches "
          f"{launches}, the direct calls' {want}")
    kinds = {(t[0], t[1]) for t in sent["tags"]}
    for opname in SERVE_LEADER_OPS:
        need = {"sliced_ell_spmv", "cheb_step", "jacobi_step"}
        if plans[opname].info.get("coupling_launches_per_round"):
            need.add("sliced_ell_spmv_accumulate")
        got = set()
        for kind in ("apply", "solve"):
            if (opname, kind) in kinds:
                got |= {k for t, d in direct.items()
                        if t[:2] == (opname, kind) for k in d["launches"]}
        check(need <= got, f"leader phase on rank {rank}: {opname} "
              f"launched {sorted(got)}, needs {sorted(need)}")
    out = dict(warm_s=warm_s, launches=launches, rates=rates,
               n_batches=len(sent["tags"]))
    if not leader:
        return out
    check(all(bitwise.values()), f"leader phase: first batches differ from "
          f"the direct calls: {bitwise}")
    for b in batches:
        opname, kind, bucket = b["tag"]
        d = direct[b["tag"]]
        check(b["rounds"] == d["rounds"]
              and b["total_bytes"] == d["total_bytes"],
              f"leader phase {b['tag']}: counted {b}, direct {d}")
        if kind == "apply":
            check(b["rounds"] == K and b["total_bytes"] == bucket
                  * plans[opname].info["halo_bytes_per_apply"],
                  f"leader phase {b['tag']}: {b} against K = {K} and the "
                  "byte model")
    err = ref_max = 0.0
    for c in range(0, len(applied), BATCH):
        part = applied[c:c + BATCH]
        ref = dense.apply(torch.stack([x for x, _ in part]).double())
        got = torch.stack([y for _, y in part]).double()
        check(bool(torch.isfinite(got).all()), "leader phase: non-finite")
        err = max(err, float((got - ref).abs().max()))
        ref_max = max(ref_max, float(ref.abs().max()))
    rel = err / max(ref_max, 1e-30)
    check(rel <= TOL_PATH, f"leader phase: served apply rows rel err "
          f"{rel:.3e} against float64 dense")
    out.update(bitwise=len(bitwise), max_abs_err=err, rel_err=rel,
               applied=len(applied),
               direct={f"{t[0]}:{t[1]}:{t[2]}": v for t, v in
                       direct.items()})
    return out


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

    from repro_torch.obs import kernel_counters
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
                for session in range(1, TRACE_SESSIONS + 1):
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
                    check(not h2d, f"serving {name}: the trace of "
                          f"{TRACE_REPLAYS} replays {names} must show no "
                          "host-to-device copy")
                    if any(kernel[name] in k for k in names):
                        break
                    print(f"  {name} B={B}: trace session {session} of "
                          f"{TRACE_SESSIONS} holds no {kernel[name]} "
                          f"record: {names}")
                check(any(kernel[name] in k for k in names),
                      f"serving {name}: none of {TRACE_SESSIONS} traces of "
                      f"{TRACE_REPLAYS} replays shows {kernel[name]}")
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
    # where the time of an apply goes, on rank 0 (the others run beside)
    profile = None
    if rank == 0:
        profile = _profile_call(plan.apply, F, {
            "coupling": ("coupling_spmv_kernel",),
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


# The couplings' launch before its redesign (PERF.md's kernel table, the
# SpMV's accumulating instance on the same shape; NVIDIA H100 80GB HBM3,
# 700 W).  Printed as quoted text beside this run's times, never in the
# kernels line: this run does not measure it.
EARLIER_COUPLING = ("the SpMV's accumulating instance over every row, after "
                    "a torch.cat of the tiles: ms 0.0187, device_ms 0.01633 "
                    "(PR 18)")
EARLIER_SHRINK = "ms 0.0770, device_ms 0.0654 (per-scale threshold, PR 15)"


def _coupling_kernel_row(parts, rank: int, dev) -> dict:
    """The couplings' kernel on this rank's compacted couplings at the
    community shape against its plain version: its times with r joined,
    with the tiles as a round passes them (read in place) and after a
    torch.cat of those tiles (what a round ran before the redesign), the
    compacted rows and slices, its bound and the library call computing
    y + C r."""
    from repro_torch.dist.sharded import coupling_layout
    from repro_torch.kernels.bcsr_spmv import (compact_coupling,
                                               sliced_ell_spmv_accumulate,
                                               sliced_ell_spmv_plain)

    C = coupling_layout(parts, rank, parts.n_local_padded, dev)
    L = compact_coupling(C, parts.tile_widths)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    r = torch.randn(COMMUNITY_B, C.x_len, generator=gen, device=dev)
    y0 = torch.randn(COMMUNITY_B, C.padded_n, generator=gen, device=dev)
    tiles = tuple(t.contiguous() for t in r.split(list(parts.tile_widths),
                                                 -1))
    got = sliced_ell_spmv_accumulate(L, r, y0.clone())
    want = sliced_ell_spmv_plain(C, r, out=y0.clone())
    torch.cuda.synchronize()
    err, rel = rel_err(got - y0, want - y0)
    check(rel <= TOL_SPMV, f"coupling spmv: rel err {rel:.3e}")
    check(bool(torch.equal(
        sliced_ell_spmv_accumulate(L, tiles, y0.clone()), got)),
        "coupling spmv: the tiles read in place must give the joined r's "
        "bits")
    y = y0.clone()
    joined = (lambda: sliced_ell_spmv_accumulate(L, r, y))
    in_place = (lambda: sliced_ell_spmv_accumulate(L, tiles, y))
    cat_first = (lambda: sliced_ell_spmv_accumulate(
        L, torch.cat(tiles, -1), y))
    ms = time_ms(joined, 20)
    tiles_ms = time_ms(in_place, 20)
    cat_ms = time_ms(cat_first, 20)
    tiles_ms2 = time_ms(in_place, 20)
    dev_ms = device_ms(joined, 20, "coupling_spmv_kernel")
    tiles_dev = device_ms(in_place, 20, "coupling_spmv_kernel")
    cat_dev = all_device_ms(cat_first, 20)
    plain_ms = time_ms(lambda: sliced_ell_spmv_plain(C, r, out=y), 5)
    # the library yardstick: one cuSPARSE product y^T + C r^T
    rows = C.entry_rows()[C.values != 0]
    entry_rows = int(rows.unique().numel())
    check(entry_rows == L.n_entry_rows,
          f"compacted rows {L.n_entry_rows} != {entry_rows}")
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
    # y moves in 32-byte sectors: the sectors that hold an entry's row,
    # read and written, in place of 4 bytes per row
    y_sectors = int((rows // 8).unique().numel())
    sector_ms, _ = bound(C.nnz * 8 + COMMUNITY_B * (C.x_len * 4
                                                    + 2 * y_sectors * 32),
                         2 * C.nnz * COMMUNITY_B)
    # the same launch in smaller signal tiles than the planner's one tile
    # of 16 (each row's sum is the same, so the bits are too)
    from unittest import mock

    from repro_torch.kernels import bcsr_spmv
    tile_dev = {}
    for tb in (8, 4):
        def shape(n_slices, batch, tb=tb):
            return tb, (-(-n_slices // bcsr_spmv.SPMV_WARPS),
                        -(-batch // tb))

        with mock.patch.object(bcsr_spmv, "coupling_launch", shape):
            L_tb = compact_coupling(C, parts.tile_widths)
            check(bool(torch.equal(
                sliced_ell_spmv_accumulate(L_tb, r, y0.clone()), got)),
                f"coupling spmv in tiles of {tb}: other bits")
            tile_dev[tb] = device_ms(
                lambda: sliced_ell_spmv_accumulate(L_tb, r, y), 20,
                "coupling_spmv_kernel")
    return dict(max_abs_err=err, rel_err=rel, ms=ms, device_ms=dev_ms,
                y_sectors=y_sectors, bound_sectors_ms=sector_ms,
                device_ms_by_tile=tile_dev,
                tiles_ms=[tiles_ms, tiles_ms2], tiles_device_ms=tiles_dev,
                cat_then_launch_ms=cat_ms, cat_then_launch_device_ms=cat_dev,
                plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
                entry_rows=entry_rows, compact_slices=L.n_slices,
                slices_before=C.n_slices, launches_per_round=len(L.groups),
                rows=C.padded_n, cols=C.x_len, nnz=C.nnz, stored=L.stored,
                stored_before=C.stored, batch=COMMUNITY_B)


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
    from repro_torch.kernels.cheb_step import cheb_order, cheb_step
    from repro_torch.kernels.cheb_sweep import cheb_sweep, jacobi_sweep
    from repro_torch.kernels.jacobi_step import jacobi_round, jacobi_step
    from repro_torch.kernels.soft_threshold import ista_shrink

    return (sliced_ell_spmv, sliced_ell_spmv_accumulate, cheb_step,
            cheb_order, cheb_sweep, jacobi_step, jacobi_round, jacobi_sweep,
            ista_shrink)


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
    substrings, that matches), its share of the wall time, the number of
    kernels (copies and memsets apart), and the host operations with the
    most self time; None when the trace holds no device time."""
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
    kernels = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            key = e.key.lower()
            if not key.startswith(("memcpy", "memset")):
                kernels += e.count
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
                busy_share=busy / wall_ms, kernels=kernels,
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


def _large_sensor_layout(graph, n: int, dev):
    """The Section IV-D sensor network at n sensors (seed SEED, kappa =
    sqrt(20 / (pi n)) and theta in the paper's ratio, as at N), its
    vertices in strip order, as the sliced-ELL layout of its combinatorial
    Laplacian, packed on the card from COO by `graph.sliced_ell_from_coo`:
    a dense n x n P does not fit the host at n = 2**18.  The neighbours of
    each chunk of strip-sorted vertices lie within kappa in y, so each
    chunk is held against that window alone.  Returns (layout, lmax (the
    Anderson-Morley bound), |E|)."""
    kappa = math.sqrt(20.0 / (math.pi * n))
    theta = kappa * 0.074 / 0.075
    coords = torch.from_numpy(
        np.random.RandomState(SEED).uniform(size=(n, 2))).to(dev)
    coords = coords[torch.argsort(coords[:, 1], stable=True)]
    y = coords[:, 1].contiguous()
    rows, cols, ws = [], [], []
    for r0 in range(0, n, LARGE_CHUNK):
        r1 = min(r0 + LARGE_CHUNK, n)
        lo = int(torch.searchsorted(y, y[r0] - kappa))
        hi = int(torch.searchsorted(y, y[r1 - 1] + kappa, right=True))
        d2 = ((coords[r0:r1, None, :] - coords[None, lo:hi, :]) ** 2).sum(-1)
        near = d2 <= kappa * kappa
        own = torch.arange(r0, r1, device=dev)
        near[own - r0, own - lo] = False
        i, j = near.nonzero(as_tuple=True)
        rows.append(i + r0)
        cols.append(j + lo)
        ws.append(torch.exp(-d2[i, j] / (2.0 * theta * theta)))
    rows, cols, w = torch.cat(rows), torch.cat(cols), torch.cat(ws)
    deg = torch.zeros(n, dtype=w.dtype, device=dev).index_add_(0, rows, w)
    lmax = float((deg[rows] + deg[cols]).max())
    own = torch.arange(n, device=dev)
    r, c = torch.cat([rows, own]), torch.cat([cols, own])
    order = torch.argsort(r * n + c)
    v = torch.cat([-w, deg])[order]
    S = graph.sliced_ell_from_coo(r[order], c[order], v, n, n)
    return S, lmax, rows.numel() // 2


def _large_per_order(ops, graph, randn, run_path, path_rows) -> None:
    """The per-order path at n = LARGE_N (past the sweep's L2 budget at
    B = BATCH, where the guard sends a plan's apply): the SGWT union at J
    and K on BATCH signals, K fused order launches; held against float64
    (the same recurrence on the same f32 layout, in float64, by the plain
    SpMV) on LARGE_REF_SIGNALS of them.  Adds its figures to the path's
    row."""
    from repro_torch.core import chebyshev, wavelets
    from repro_torch.kernels.bcsr_spmv import sliced_ell_spmv_plain

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    S, lmax, n_edges = _large_sensor_layout(graph, LARGE_N, dev)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    need = ops.cheb_sweep_l2_bytes(LARGE_N, BATCH, stored=S.stored)
    check(need > ops.DEFAULT_SWEEP_L2_BUDGET,
          "n = 2**18 must be past the sweep's L2 budget")
    coeffs = torch.as_tensor(chebyshev.cheb_coeffs_stack(
        wavelets.sgwt_multipliers(lmax, J), K, lmax), dtype=torch.float32,
        device=dev)
    eta = coeffs.shape[0]
    print(f"large graph: n={LARGE_N} |E|={n_edges} mean degree "
          f"{2 * n_edges / LARGE_N:.2f} lmax_bound={lmax:.4f}, stored "
          f"{S.stored} ({S.stored_per_nnz:.4f} per non-zero), L2 working "
          f"set {need} B over the {ops.DEFAULT_SWEEP_L2_BUDGET} B budget; "
          f"built on the card from COO in {built:.1f} s")
    x = randn(BATCH, LARGE_N)
    name = f"apply[per-order, n={LARGE_N}, B={BATCH}]"
    out, counts = run_path(name, lambda: ops._per_order_cheb(S, x, coeffs,
                                                               lmax))
    check({k: v for k, v in counts.items() if v} == {"cheb_order": K},
          f"the per-order path at n = {LARGE_N} must be K fused order "
          f"launches, got {counts}")
    x64 = x[:LARGE_REF_SIGNALS].double()
    ref = chebyshev.cheb_apply(
        lambda t: sliced_ell_spmv_plain(S, t), x64, coeffs.double(), lmax)
    _, rel = rel_check(out[:LARGE_REF_SIGNALS], ref, TOL_PATH,
                       f"{name} vs float64 on {LARGE_REF_SIGNALS} signals")
    dev_ms = device_ms(lambda: ops._per_order_cheb(S, x, coeffs, lmax), 1,
                       "cheb_order_kernel")
    b_ms, b_by = bound(S.nnz * 8 + 4 * (3 + 2 * eta) * BATCH * LARGE_N,
                       2 * S.nnz * BATCH + BATCH * LARGE_N * (4 + 2 * eta))
    path_rows[-1].update(n=LARGE_N, n_edges=n_edges, stored=S.stored,
                         rel_err=rel, order_device_ms=dev_ms,
                         order_bound_ms=b_ms, order_bound_by=b_by,
                         build_s=built)
    print(f"  per order: cheb_order device_ms={dev_ms} against "
          f"bound_ms={b_ms:.5f} ({b_by})")
    del S, x, out, ref
    torch.cuda.empty_cache()


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
          f"{gossip_step['bound_ms']:.5f} ({gossip_step['bound_by']}); "
          f"{_earlier('cheb_step_gossip_leaf')}")
    print(f"launches of the exchange phases (compressed wires, faults, "
          f"gossip; summed over ranks): "
          f"{ {k: v for k, v in exchange_launches.items() if v} }")
    check(all(exchange_launches[k] > 0 for k in (
        "sliced_ell_spmv", "sliced_ell_spmv_accumulate", "cheb_step",
        "jacobi_step")), "the exchange phases must launch their kernels")
    return exchange_launches, gossip_step


def _held_decode(dec, steps, cfg, params, prompt, n_gen, vision=None,
                 run=None, frames=None):
    """Prefill `prompt` (B, P) into a fresh cache of P + n_gen slots (for
    whisper, `start_cache` first runs the encoder over `frames`), then
    n_gen - 1 serve steps, all under ``set_sync_debug_mode("error")`` (a
    host read in a step raises); the decode logits at the n_gen decoded
    positions are kept (the serve step's `decode_step`, recorded).
    Returns the generated ids (B, n_gen), the logits (B, n_gen, V), the
    cache, the serve step, the prefill's ms and each step's ms (CUDA
    events) and the peak MiB."""
    from repro_torch.models import RunConfig

    run = run or RunConfig()
    B = prompt.shape[0]
    cache = dec.start_cache(cfg, params, B, prompt.shape[1] + n_gen, run,
                            encoder_frames=frames)
    serve_step = steps.build_serve_step(cfg, run)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_gen + 1)]
    real = dec.decode_step
    seen = []

    def recording(*args, **kwargs):
        logits, c = real(*args, **kwargs)
        seen.append(logits)
        return logits, c

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        marks[0].record()
        logits, cache = dec.prefill(cfg, params, prompt, cache, run,
                                    vision_embeds=vision)
        marks[1].record()
        seen.append(logits)
        out = [logits.argmax(-1).to(prompt.dtype)]
        with mock.patch.object(dec, "decode_step", recording):
            for mark in marks[2:]:
                tok, cache = serve_step(params, cache, out[-1][:, None])
                mark.record()
                out.append(tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return dict(generated=torch.stack(out, dim=1),
                logits=torch.stack(seen, dim=1), cache=cache,
                serve_step=serve_step, prefill_ms=ms[0], step_ms=ms[1:],
                peak_mib=torch.cuda.max_memory_allocated() / 2**20)


def _hold_against_forward(name, forward, run, cfg, params, prompt, got,
                          run_path, vision=None, tol=TOL_LM_LOGITS,
                          kernel="flash_attention_wgmma") -> dict:
    """The flash forward over the prompt and the generated ids but the
    last (one launch of `kernel` per layer, counted) against the decode
    logits at each decoded position: max |d| over that position's max
    |logits|, within `tol` unless it is None (then printed only); the
    share of greedy ids equal to the forward's argmax (printed, not a
    gate: bf16 ties can flip)."""
    gen, dl = got["generated"], got["logits"]
    seq = torch.cat([prompt, gen[:, :-1]], dim=1)
    n = gen.shape[1]
    full, counts = run_path(
        name, lambda: forward(cfg, params, seq, run, vision_embeds=vision),
        steady_iters=0)
    check({k: v for k, v in counts.items() if v} == {kernel: cfg.n_layers},
          f"{name} must be {cfg.n_layers} launches of {kernel}, got "
          f"{counts}")
    check(bool(torch.isfinite(dl).all()), f"{name}: non-finite logits")
    d, rel = _position_errors(dl, full[:, -n:])
    worst = float(rel.max())
    agree = float((full[:, -n:].argmax(-1) == gen).float().mean())
    print(f"  decode vs the flash forward at {n} positions: max abs "
          f"{float(d.max()):.4e}, worst position {int(rel.argmax())} at "
          f"{worst:.4e} of its max (tol {tol}); greedy ids equal to the "
          f"forward's argmax: {agree:.4f}")
    if tol is not None:
        check(worst <= tol,
              f"{name}: decode logits {worst} of the max from the forward's")
    return dict(logits_max_abs_err=float(d.max()), logits_rel_err=worst,
                greedy_agreement=agree, forward=full)


def _position_errors(got, ref):
    """max |got - ref| over (B, V) at each position of (B, n, V), and that
    over the position's max |ref|."""
    d = (got.float() - ref.float()).abs().amax(dim=(0, 2))
    return d, d / ref.float().abs().amax(dim=(0, 2)).clamp_min(1e-30)


def _lm_decode_phase(cfg, params, run_path, smi: str) -> list:
    """KV-cache decode and serve at full width: starcoder2-3b (the bf16
    cache held against the flash forward, its step timed and traced; the
    f8 cache; the launcher's `main`), then the VLM backbone."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import (RunConfig, count_params, decode as dec,
                                    forward, init_params, steps)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = []

    # -- starcoder2-3b, bf16 cache -----------------------------------------
    name = (f"lm_decode[{cfg.name}, B={DEC_B}, prompt={DEC_PROMPT}, "
            f"gen={DEC_GEN}]")
    prompt = torch.randint(0, cfg.vocab_size, (DEC_B, DEC_PROMPT),
                           device=dev, generator=gen)
    got = _held_decode(dec, steps, cfg, params, prompt, DEC_GEN)
    cache = got["cache"]
    cache_bytes = cache["k"].nbytes + cache["v"].nbytes
    steady = sum(got["step_ms"][1:]) / (DEC_GEN - 2)
    # the bound of one step: every weight but the embedding (a gather of
    # B rows) read once, and the cache; 2 operations per weight and token,
    # and the attention's 4 per cached element and query head
    weights = [t for k, t in params.items() if k not in ("embed", "layers")]
    weights += list(params["layers"].values())
    weight_bytes = sum(t.nbytes for t in weights)
    flops = (2.0 * DEC_B * sum(t.numel() for t in weights)
             + 4.0 * DEC_B * cfg.n_heads * cache["k"].shape[3] * cfg.hd
             * cfg.n_layers)
    bound_ms, bound_by = bound(weight_bytes + cache_bytes, flops,
                               PEAK_BF16_FLOPS)
    tok = got["generated"][:, -1:]
    trace = _profile_call(lambda t: got["serve_step"](params, cache, t), tok,
                          {"matmul": ("gemm", "gemv", "cutlass", "xmma",
                                      "nvjet")})
    row = dict(name=name, prefill_s=got["prefill_ms"] / 1e3,
               prefill_ms_per_token=got["prefill_ms"] / DEC_PROMPT,
               first_ms=got["step_ms"][0], steady_ms=steady,
               tokens_per_s=DEC_B / (steady / 1e3),
               peak_mib=got["peak_mib"], cache_mib=cache_bytes / 2**20,
               bound_ms=bound_ms, bound_by=bound_by,
               weight_bytes=weight_bytes, trace=trace,
               kernels_per_step=trace["kernels"] if trace else None,
               busy_share=(trace["busy_ms"] / steady if trace else None))
    print(f"path {name}: prefill {row['prefill_s']:.3f} s "
          f"({row['prefill_ms_per_token']:.3f} ms per token), first step "
          f"{row['first_ms']:.3f} ms, steady {steady:.3f} ms per step (CUDA "
          f"events, mean of {DEC_GEN - 2}), {row['tokens_per_s']:.1f} "
          f"tokens/s, peak {got['peak_mib']:.1f} MiB, cache "
          f"{row['cache_mib']:.1f} MiB; bound {bound_ms:.4f} ms "
          f"({bound_by}: {weight_bytes} weight bytes but the embedding, "
          f"and the cache); one step under torch.profiler: {trace}; busy "
          f"share (its device ms over the steady ms) {row['busy_share']} "
          f"({smi})")
    held = _hold_against_forward(
        f"lm_forward[{cfg.name}, B={DEC_B}, S={DEC_PROMPT + DEC_GEN - 1}] "
        f"(decode's reference)", forward, RunConfig("flash"), cfg, params,
        prompt, got, run_path)
    del held["forward"]
    row.update(held)
    rows.append(row)
    del got, cache, held

    # -- the f8 cache against the bf16 cache --------------------------------
    prompt = prompt[:F8_B, :F8_PROMPT]
    last = {}
    for label, dt in (("bf16", None), ("f8", torch.float8_e4m3fn)):
        c = dec.init_cache(cfg, F8_B, F8_PROMPT, dtype=dt, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            last[label], c = dec.prefill(cfg, params, prompt, c)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        last[label + "_s"] = time.perf_counter() - t0
        last[label + "_bytes"] = c["k"].nbytes + c["v"].nbytes
        check(c["k"].dtype == (dt or cfg.torch_dtype), "cache dtype")
    a, b = last["f8"].float().flatten(), last["bf16"].float().flatten()
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    top1 = float((last["f8"].argmax(-1) == last["bf16"].argmax(-1))
                 .float().mean())
    print(f"path lm_decode[{cfg.name}, f8 cache, B={F8_B}, prompt="
          f"{F8_PROMPT}]: last logits vs the bf16 cache's: correlation "
          f"{corr:.6f} (min {MIN_F8_CORR}), top-1 agreement {top1:.4f}; "
          f"cache {last['f8_bytes'] / 2**20:.1f} MiB vs "
          f"{last['bf16_bytes'] / 2**20:.1f}; prefill {last['f8_s']:.3f} s "
          f"vs {last['bf16_s']:.3f} s (host clock)")
    check(corr >= MIN_F8_CORR, f"f8 cache correlation {corr}")
    check(last["f8_bytes"] * 2 == last["bf16_bytes"],
          "the f8 cache must be half the bf16 cache")
    rows.append(dict(name=f"lm_decode[{cfg.name}, f8 cache]",
                     correlation=corr, top1_agreement=top1,
                     cache_mib=last["f8_bytes"] / 2**20,
                     bf16_cache_mib=last["bf16_bytes"] / 2**20,
                     prefill_s=last["f8_s"], bf16_prefill_s=last["bf16_s"]))
    del last, a, b

    # -- the entry point, at full width on the default device ---------------
    argv = ["--arch", cfg.name, "--batch", "4", "--prompt-len", "16",
            "--gen", "32"]
    t0 = time.perf_counter()
    rc = serve.main(argv)
    torch.cuda.synchronize()
    print(f"path launch.serve.main({' '.join(argv)}): exit {rc} in "
          f"{time.perf_counter() - t0:.1f} s (its parameters drawn on the "
          f"card)")
    check(rc == 0, f"launch.serve.main returned {rc}")
    rows.append(dict(name="launch.serve.main", argv=argv, rc=rc))
    torch.cuda.empty_cache()

    # -- the VLM backbone: bf16, the served precision (timed; its distance
    #    from the flash forward printed beside the forward's own from the
    #    plain-attention forward), then f32 (held to the f32 flash forward,
    #    the FFMA kernel, at TOL_LM_F32)
    vcfg = get_config(VLM_ARCH)
    check(vcfg.n_layers == 28 and vcfg.d_model == 1536
          and vcfg.mrope_sections == (16, 24, 24), f"{VLM_ARCH} at full width")
    t0 = time.perf_counter()
    vparams = init_params(vcfg, gen, device=dev)
    vision = torch.randn(VLM_B, VLM_VISION, vcfg.d_model, device=dev,
                         generator=gen)
    prompt = torch.randint(0, vcfg.vocab_size, (VLM_B, VLM_PROMPT),
                           device=dev, generator=gen)
    torch.cuda.synchronize()
    print(f"{VLM_ARCH}: {vcfg.n_layers} layers, d_model {vcfg.d_model}, "
          f"{vcfg.n_heads}/{vcfg.n_kv_heads} heads of {vcfg.hd}, M-RoPE "
          f"{vcfg.mrope_sections}, {count_params(vcfg)} parameters "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    rows.append(_vlm_decode("bf16", vcfg, vparams, vision, prompt,
                            run_path))
    vparams = {k: ({n: t.float() for n, t in v.items()}
                   if isinstance(v, dict) else v.float())
               for k, v in vparams.items()}      # the same weights in f32
    rows.append(_vlm_decode("f32", dataclasses.replace(vcfg, dtype="float32"),
                            vparams, vision, prompt, run_path))
    return rows


def _vlm_decode(label, cfg, params, vision, prompt, run_path) -> dict:
    """The VLM's decode at `cfg`'s dtype: timed, and held against the
    flash forward (f32: at TOL_LM_F32; bf16: printed beside the bf16
    noise floor, the flash forward against the plain-attention one)."""
    from repro_torch.models import RunConfig, decode as dec, forward, steps

    f32 = label == "f32"
    name = (f"lm_decode[{VLM_ARCH}, {label}, B={VLM_B}, vision="
            f"{VLM_VISION}, prompt={VLM_PROMPT}, gen={VLM_GEN}]")
    v = vision.to(cfg.torch_dtype)
    got = _held_decode(dec, steps, cfg, params, prompt, VLM_GEN, vision=v)
    steady = sum(got["step_ms"][1:]) / (VLM_GEN - 2)
    row = dict(name=name, prefill_s=got["prefill_ms"] / 1e3,
               first_ms=got["step_ms"][0], steady_ms=steady,
               tokens_per_s=VLM_B / (steady / 1e3), peak_mib=got["peak_mib"])
    print(f"path {name}: prefill {row['prefill_s']:.3f} s, first step "
          f"{row['first_ms']:.3f} ms, steady {steady:.3f} ms per step, "
          f"{row['tokens_per_s']:.1f} tokens/s, peak {got['peak_mib']:.1f} "
          f"MiB")
    held = _hold_against_forward(
        f"lm_forward[{VLM_ARCH}, {label}, B={VLM_B}, S="
        f"{VLM_PROMPT + VLM_GEN - 1}] (decode's reference)", forward,
        RunConfig("flash"), cfg, params, prompt, got, run_path, vision=v,
        tol=TOL_LM_F32 if f32 else None,
        kernel="flash_attention_ffma" if f32 else "flash_attention_wgmma")
    full = held.pop("forward")
    if not f32:
        seq = torch.cat([prompt, got["generated"][:, :-1]], dim=1)
        plain = forward(cfg, params, seq, RunConfig("ref"), vision_embeds=v)
        floor = float(_position_errors(full[:, -VLM_GEN:],
                                       plain[:, -VLM_GEN:])[1].max())
        print(f"  bf16 noise floor: the flash forward vs the plain-attention "
              f"forward, worst position {floor:.4e} of its max (not a gate; "
              f"the f32 run is)")
        row["forward_vs_plain_rel_err"] = floor
    row.update(held)
    return row


def _step_bound(cfg, n_params: int, batch: int, seq: int):
    """(bound_ms, terms): the train step's least time on the card: the
    weights' products (6 operations per parameter and token, bf16), the
    plain attention's (f32: Q K^T and P V, forward and twice backward,
    over the causal half) and the optimizer's bytes (bf16 parameters and
    gradients read, float32 m and v read and written, parameters written)
    in turn."""
    products = 6.0 * n_params * batch * seq / PEAK_BF16_FLOPS * 1e3
    attention = (12.0 * batch * cfg.n_heads * seq * seq * cfg.hd / 2
                 * cfg.n_layers / PEAK_F32_FLOPS * 1e3)
    optimizer = 22.0 * n_params / PEAK_BYTES * 1e3
    return products + attention + optimizer, dict(
        products_ms=products, attention_ms=attention, optimizer_ms=optimizer)


def _max_ulps(a, b) -> float:
    """The largest |a - b| in units in the last place of their dtype at
    max(|a|, |b|), in float64 on `b`'s device, one slice of the leading
    axis at a time."""
    fin = torch.finfo(a.dtype)
    worst = 0.0
    for x, y in zip(a, b):
        x, y = x.to(y.device).double(), y.double()
        mag = torch.maximum(x.abs(), y.abs()).clamp_min(fin.tiny)
        ulp = torch.exp2(torch.floor(torch.log2(mag))) * fin.eps
        worst = max(worst, float(((x - y).abs() / ulp).max()))
    return worst


def _plain_adamw_step0(g, p, gnorm, lr: float, b1=0.9, b2=0.95, eps=1e-8,
                       wd=0.01):
    """The JAX package's AdamW on one whole leaf at its first step (m = v
    = 0), in float32: the clip at 1.0 by `gnorm`, then (p, m, v) after the
    step.  Temporaries are freed as it goes (a float32 copy of a
    full-width stacked leaf is 4.5 GB)."""
    scale = torch.clamp(torch.ones_like(gnorm) / (gnorm + 1e-9), max=1.0)
    g = g.float() * scale
    m = (1 - b1) * g
    v = (1 - b2) * torch.square(g)
    del g
    step = torch.ones((), dtype=torch.float32, device=m.device)
    mhat = m / (1 - b1 ** step)
    vhat = v / (1 - b2 ** step)
    den = torch.sqrt(vhat) + eps
    del vhat
    upd = mhat / den
    del mhat, den
    p32 = p.float()
    return (p32 - lr * (upd + wd * p32)).to(p.dtype), m, v


def _check_step0_update(g, p0, gnorm_plain, gnorm, p1, m1, v1):
    """Step 0's update of TRAIN_REF_LEAF (`p1`, `m1`, `v1`: its
    parameters, m and v after the step, host copies) against
    `_plain_adamw_step0` on the card from its gradient `g` and parameters
    `p0` before the step (host copies), at the step's global norm
    `gnorm`; that norm against the plain whole-leaf one, `gnorm_plain`."""
    dev = gnorm.device
    norm_rel = float(torch.abs(gnorm - gnorm_plain) / gnorm_plain)
    p_want, m_want, v_want = _plain_adamw_step0(g.to(dev), p0.to(dev), gnorm,
                                                TRAIN_LR)
    got = dict(m=_max_ulps(m1, m_want), v=_max_ulps(v1, v_want),
               p=_max_ulps(p1, p_want))
    del p_want, m_want, v_want
    print(f"  step 0's sliced in-place AdamW on {'/'.join(TRAIN_REF_LEAF)} "
          f"{tuple(g.shape)} vs the plain whole-leaf float32 update: m "
          f"{got['m']!r}, v {got['v']!r} float32 ulps, the {p0.dtype} "
          f"parameters {got['p']!r} ulps (limits {ULPS_TRAIN_M}, "
          f"{ULPS_TRAIN_V}, {ULPS_TRAIN_P}); the step's global norm "
          f"{float(gnorm)!r} vs the plain one {float(gnorm_plain)!r} "
          f"(rel {norm_rel:.3e}, tol {TOL_TRAIN_NORM})")
    check(norm_rel <= TOL_TRAIN_NORM, f"the step's global norm vs the "
          f"plain one: rel {norm_rel}")
    check(got["m"] <= ULPS_TRAIN_M and got["v"] <= ULPS_TRAIN_V
          and got["p"] <= ULPS_TRAIN_P,
          f"step 0's update of {'/'.join(TRAIN_REF_LEAF)} vs the plain "
          f"whole-leaf update (ulps): {got}")
    return dict(got, norm_rel=norm_rel)


def _lm_train_full(cfg, params, smi: str) -> dict:
    """Phase (a): the train step at full width and depth.  Step 0's loss
    against `build_loss_fn`'s; the loss and every gradient of step 0 twice
    from the same state, bit for bit; TRAIN_STEPS steps timed (CUDA
    events, the optimizer's share by events around `adamw_update`), every
    loss and grad norm finite, step 0's update of TRAIN_REF_LEAF against
    the plain whole-leaf update, and step 0's batch at a lower loss after
    step 0; one more step under torch.profiler (busy share)."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import RunConfig, count_params, steps
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves, leaves_with_paths

    dev = torch.device("cuda")
    run = RunConfig(attn_impl="ref")
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                           global_batch=TRAIN_B, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_at(i).items()}
               for i in range(TRAIN_STEPS + 1)]
    name = (f"lm_train[{cfg.name}, B={TRAIN_B}, S={TRAIN_S}, "
            f"{TRAIN_STEPS} steps, lr {TRAIN_LR}]")
    loss_fn = steps.build_loss_fn(cfg, run)
    with torch.no_grad():
        eval_loss = loss_fn(params, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss_a, grads_a = steps.loss_and_grads(loss_fn, params, batches[0])
    torch.cuda.synchronize()
    grads_s = time.perf_counter() - t0
    grads_peak = torch.cuda.max_memory_allocated() / 2**20
    loss_b, grads_b = steps.loss_and_grads(loss_fn, params, batches[0])
    differ = ["/".join(k) for (k, a), (_, b) in zip(
        leaves_with_paths(grads_a), leaves_with_paths(grads_b))
        if not torch.equal(a, b)]
    same_loss = bool(torch.equal(loss_a, loss_b))
    print(f"path {name}: step 0's loss and gradients twice from the same "
          f"state: loss {'equal' if same_loss else 'DIFFERENT'} bit for "
          f"bit, gradients of {len(differ)} of "
          f"{len(leaves(grads_a))} leaves differ {differ}; the "
          f"first forward and backward {grads_s:.3f} s (host clock), peak "
          f"{grads_peak:.1f} MiB")
    check(same_loss and not differ,
          f"step 0 twice from the same state: loss equal {same_loss}, "
          f"gradients differ in {differ}")
    del grads_b, loss_b
    # step 0's gradient and parameters of TRAIN_REF_LEAF, and the plain
    # whole-leaf global norm, for the plain update after step 0
    gnorm_plain = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                 for g in leaves(grads_a)))
    # (host copies: device memory that the timed steps did not have
    # before would change their allocations, and so their times)
    outer, inner = TRAIN_REF_LEAF
    g_ref = grads_a[outer][inner].cpu()
    p_ref = params[outer][inner].cpu()
    del grads_a
    torch.cuda.empty_cache()

    opt_state = adamw_init(params)
    train_step = steps.build_train_step(cfg, run, lr=TRAIN_LR)
    real_update = steps.adamw_update
    opt_marks = []

    def timed_update(*args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real_update(*args, **kwargs)
        b.record()
        opt_marks.append((a, b))
        return out

    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(TRAIN_STEPS)]
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(steps, "adamw_update", timed_update):
        for i, (a, b) in enumerate(marks):
            a.record()
            params, opt_state, m = train_step(params, opt_state, batches[i])
            b.record()
            metrics.append(m)
            if i == 0:      # the JAX smoke test's learnable signal
                with torch.no_grad():
                    again = loss_fn(params, batches[0])
                after0 = [t[outer][inner].cpu()
                          for t in (params, opt_state.m, opt_state.v)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    step_ms = [a.elapsed_time(b) for a, b in marks]
    opt_ms = [a.elapsed_time(b) for a, b in opt_marks]
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    check(int(opt_state.step) == TRAIN_STEPS, "the optimizer's step count")
    steady = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    opt_steady = sum(opt_ms[1:]) / (TRAIN_STEPS - 1)
    n_params = count_params(cfg)
    bound_ms, terms = _step_bound(cfg, n_params, TRAIN_B, TRAIN_S)
    trace = _profile_call(
        lambda b: train_step(params, opt_state, b), batches[TRAIN_STEPS],
        {"matmul": ("gemm", "gemv", "cutlass", "xmma", "nvjet")})
    again = float(again)
    ref_ulps = _check_step0_update(g_ref, p_ref, gnorm_plain,
                                   metrics[0]["grad_norm"], *after0)
    del g_ref, p_ref, after0
    busy = trace["busy_ms"] / steady if trace else None
    row = dict(name=name, losses=losses, grad_norms=gnorms,
               eval_loss=float(eval_loss), batch0_after_step0=again,
               step_ms=step_ms,
               steady_ms=steady, first_ms=step_ms[0],
               optimizer_ms=opt_ms, optimizer_share=opt_steady / steady,
               tokens_per_s=TRAIN_B * TRAIN_S / (steady / 1e3),
               step0_update_vs_plain=ref_ulps,
               peak_mib=peak, grads_peak_mib=grads_peak, bound_ms=bound_ms,
               bound_terms=terms, trace=trace, busy_share=busy,
               deterministic=True)
    print(f"path {name}: losses {[round(x, 6) for x in losses]}, grad "
          f"norms {[round(x, 4) for x in gnorms]}; step 0's loss "
          f"{losses[0]!r} vs build_loss_fn's {float(eval_loss)!r}, and on "
          f"the same batch after step 0 {again!r}; steady "
          f"{steady:.3f} ms per step (CUDA events, mean of steps 1-"
          f"{TRAIN_STEPS - 1}; first {step_ms[0]:.3f}), the optimizer "
          f"{opt_steady:.3f} ms ({100 * opt_steady / steady:.1f}%), "
          f"{row['tokens_per_s']:.1f} tokens/s, peak {peak:.1f} MiB; bound "
          f"{bound_ms:.3f} ms ({terms}); one more step under torch.profiler:"
          f" {trace}; busy share (its device ms over the steady ms) {busy} "
          f"({smi})")
    check(losses[0] == float(eval_loss),
          f"step 0's loss {losses[0]} vs build_loss_fn's {float(eval_loss)}")
    check(all(math.isfinite(x) for x in losses + gnorms),
          "every loss and grad norm must be finite")
    check(again < losses[0], f"one step must lower its batch's loss: "
          f"{losses[0]} -> {again}")
    return row


def _launcher_runs(argvs) -> list:
    """`python -m repro_torch.launch.train` in one process per argv, all
    at once, on the card; each waited for (killed past 600 s)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + argv, cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for argv in argvs]
    out = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        out.append(dict(rc=proc.returncode, stdout=stdout,
                        stderr=stderr[-2000:],
                        seconds=time.perf_counter() - t0))
    return out


def _printed_losses(stdout: str) -> dict:
    return {line.split()[2]: line.split()[4] for line in stdout.splitlines()
            if line.startswith("[train] step")}


def _lm_train_resume(tmp: str) -> dict:
    """Phase (b): the launcher crashes at RESUME_FAIL_AT and resumes; the
    resumed run prints the uninterrupted run's losses at RESUME_HELD."""
    ref, crash = _launcher_runs([
        RESUME_ARGV + ["--ckpt-dir", f"{tmp}/ref"],
        RESUME_ARGV + ["--ckpt-dir", f"{tmp}/ft", "--fail-at-step",
                       str(RESUME_FAIL_AT)]])
    resume, = _launcher_runs([RESUME_ARGV + ["--ckpt-dir", f"{tmp}/ft",
                                             "--resume"]])
    for what, r, rc in (("uninterrupted", ref, 0), ("crash", crash, 42),
                        ("resume", resume, 0)):
        check(r["rc"] == rc, f"launch.train {what}: exit {r['rc']}, not "
              f"{rc}: {r['stderr']}")
    want, got = _printed_losses(ref["stdout"]), _printed_losses(
        resume["stdout"])
    held = {s: (want.get(s), got.get(s)) for s in RESUME_HELD}
    resumed = [line for line in resume["stdout"].splitlines()
               if "resumed from" in line]
    print(f"path launch.train fail-and-resume ({' '.join(RESUME_ARGV)}): "
          f"exits {ref['rc']} / {crash['rc']} / {resume['rc']} in "
          f"{ref['seconds']:.1f} / {crash['seconds']:.1f} (side by side) / "
          f"{resume['seconds']:.1f} s; {resumed}; losses at steps "
          f"{RESUME_HELD} (uninterrupted, resumed): {held}")
    check(len(resumed) == 1, "the resumed run must resume")
    check(all(a is not None and a == b for a, b in held.values()),
          f"resumed losses {held}")
    return dict(name="launch.train fail-and-resume", argv=RESUME_ARGV,
                rcs=[ref["rc"], crash["rc"], resume["rc"]],
                seconds=[ref["seconds"], crash["seconds"],
                         resume["seconds"]], resumed=resumed[0], held=held)


def _gossip_train_rank(argv) -> dict:
    """One gossip rank of the launcher (`launch.train.run` over the default
    group): rank 0's record, the `cheb_step` launches each rank counted
    in its own run (gathered, by rank), and the seconds of each of rank
    0's `gossip_mean_tree` calls (the card synchronized around it)."""
    import torch.distributed as dist
    from repro_torch.dist import gossip
    from repro_torch.kernels.cheb_step import cheb_step
    from repro_torch.launch import train

    real = gossip.gossip_mean_tree
    spent = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    cheb_step.launches = 0
    with mock.patch.object(gossip, "gossip_mean_tree", timed):
        rec = train.run(train.parse_args(argv))
    launched = cheb_step.launches
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, launched)
    rec.update(cheb_step_launches=per_rank, gossip_s=spent,
               gloo_cuda=_gloo_cuda_check())
    return rec


def _lm_train_gossip(smi: str) -> dict:
    """Phase (c): `--dp-mode gossip --mesh 4x1` on GOSSIP_TRAIN_RANKS gloo
    ranks on the card against the plain trainer in this process; the
    consensus runs `cheb_step` (K - 1 launches per recurrence: one per
    gradient leaf and one for the loss, each step), counted on each rank."""
    from repro_torch.configs import get_config
    from repro_torch.dist.gossip import consensus_coeffs
    from repro_torch.examples import spawn
    from repro_torch.launch import train
    from repro_torch.models import params as mparams
    from repro_torch.tree import leaves

    world = GOSSIP_TRAIN_RANKS
    argv = GOSSIP_TRAIN_ARGV + ["--dp-mode", "gossip", "--mesh",
                                f"{world}x1"]
    t0 = time.perf_counter()
    rec = spawn(_gossip_train_rank, world, argv)
    _stop_resource_tracker()
    spawn_s = time.perf_counter() - t0
    plain = train.run(train.parse_args(GOSSIP_TRAIN_ARGV))
    args = train.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    n_leaves = len(leaves(mparams.abstract_params(cfg)))
    K = len(consensus_coeffs(world)) - 1
    want_launches = (K - 1) * (n_leaves + 1) * args.steps
    diffs = {s: abs(rec["losses"][s] - plain["losses"][s])
             for s in plain["losses"]}
    steady = rec["step_s"][1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    gossip_ms = 1e3 * sum(rec["gossip_s"][1:]) / len(steady)
    name = (f"lm_train[{cfg.name}, gossip, {world} ranks, B={args.batch}, "
            f"S={args.seq}, {args.steps} steps]")
    print(f"path {name}: rank 0's losses {rec['losses']} vs the plain "
          f"trainer's {plain['losses']} (max |d| {max(diffs.values()):.3e}, "
          f"tol {TOL_GOSSIP_TRAIN}); cheb_step launches by rank "
          f"{rec['cheb_step_launches']} (each: K = {K}: {K - 1} per "
          f"recurrence x ({n_leaves} leaves + the loss) x {args.steps} "
          f"steps = {want_launches}); steady {step_ms:.3f} ms per step (host clock, "
          f"steps 1-{args.steps - 1}), gossip_mean_tree {gossip_ms:.3f} ms "
          f"({100 * gossip_ms / step_ms:.1f}%); plain {1e3 * sum(plain['step_s'][1:]) / len(steady):.3f} ms "
          f"per step; the spawn {spawn_s:.1f} s ({smi})")
    check(rec["cheb_step_launches"] == [want_launches] * world,
          f"gossip cheb_step launches by rank {rec['cheb_step_launches']}, "
          f"not {want_launches} each")
    check(max(diffs.values()) <= TOL_GOSSIP_TRAIN,
          f"gossip losses vs plain: {diffs}")
    print(f"gloo collectives on CUDA tensors, {world} ranks on the one card "
          f"(what a DTensor redistribute sends; {smi}): {rec['gloo_cuda']}")
    return dict(name=name, gloo_cuda=rec["gloo_cuda"], losses=rec["losses"], plain_losses=plain["losses"],
                max_abs_loss_diff=max(diffs.values()),
                cheb_step_launches=rec["cheb_step_launches"],
                cheb_step_launches_sum=sum(rec["cheb_step_launches"]),
                steady_ms=step_ms, gossip_ms=gossip_ms,
                gossip_share=gossip_ms / step_ms,
                plain_steady_ms=1e3 * sum(plain["step_s"][1:]) / len(steady),
                spawn_s=spawn_s, K=K, leaves=n_leaves)


def _f32_ulps(a: float, b: float) -> float:
    """|a - b| in float32 units in the last place at max(|a|, |b|)."""
    fin = np.finfo(np.float32)
    mag = max(abs(a), abs(b), float(fin.tiny))
    return abs(a - b) / (2.0 ** math.floor(math.log2(mag)) * float(fin.eps))


def _mesh_steps(cfg, params, batches, run, rules) -> dict:
    """MESH_STEPS train steps from a copy of `params`, laid out by `rules`
    (None: the plain step): the metrics, ms per step (CUDA events and the
    host clock, the card synchronized after each step) and peak MiB."""
    from repro_torch.models import params as mparams
    from repro_torch.models import steps
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    p = tree_map(lambda t: t.clone(), params)
    kw = {}
    if rules is not None:
        p = mparams.distribute_params(p, mparams.param_pspecs(cfg, rules),
                                      rules.mesh)
        batches = [steps.distribute_batch(b, rules) for b in batches]
        kw["rules"] = rules
    state = adamw_init(p)
    step = steps.build_train_step(cfg, run, lr=TRAIN_LR, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, ev_ms, host_ms = [], [], []
    for b in batches[:MESH_STEPS]:
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        p, state, m = step(p, state, b)
        e.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        ev_ms.append(a.elapsed_time(e))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    peak = torch.cuda.max_memory_allocated() / 2**20
    del p, state
    torch.cuda.empty_cache()
    return dict(metrics=metrics, ms=ev_ms, host_ms=host_ms, peak_mib=peak)


def _mesh_batches(cfg, n: int) -> list:
    """`n` SyntheticLMData batches of MESH_MOE_B x MESH_MOE_S on the card
    (vision embeddings and encoder frames where `cfg` takes them)."""
    from repro_torch.data import SyntheticLMData

    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=MESH_MOE_S,
        global_batch=MESH_MOE_B, seed=SEED,
        n_vision_tokens=cfg.n_vision_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model, encoder_seq=cfg.encoder_seq)
    return [{k: torch.from_numpy(v).to("cuda") for k, v in
             data.batch_at(i).items()} for i in range(n)]


def _mesh_prefill(cfg, params, run, rules) -> float:
    """The prefill of MESH_PROMPT tokens at B 2 with the cache laid out by
    `cache_pspecs` against the plain prefill: max |d logits| over the
    plain logits' max."""
    from repro_torch.dist.sharding import full
    from repro_torch.models import decode as dec
    from repro_torch.models import params as mparams
    from repro_torch.tree import tree_map

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (2, MESH_PROMPT),
                           device="cuda", generator=gen)
    kw0 = kw1 = {}
    if cfg.is_encoder_decoder:
        f = torch.randn(2, cfg.encoder_seq, cfg.d_model, device="cuda",
                        generator=gen)
        kw0 = {"encoder_frames": f}
        kw1 = {"encoder_frames": rules.distribute(f, "batch", "frames",
                                                  "embed")}
    ps = mparams.distribute_params(tree_map(lambda t: t.clone(), params),
                                   mparams.param_pspecs(cfg, rules),
                                   rules.mesh)
    c0 = dec.start_cache(cfg, params, 2, 2 * MESH_PROMPT, run, **kw0)
    c1 = dec.start_cache(cfg, ps, 2, 2 * MESH_PROMPT, run, rules=rules,
                         **kw1)
    want, _ = dec.prefill(cfg, params, prompt, c0, run)
    got, _ = dec.prefill(cfg, ps, rules.distribute(prompt, "batch", None),
                         c1, run, rules=rules)
    return float((full(got) - want).abs().max() / want.abs().max())


def _gloo_cuda_check() -> dict:
    """gloo's all_reduce and all_gather_into_tensor (what a redistribute
    sends) on CUDA tensors over the default group (the gossip phase's
    gloo ranks on the one card; every rank calls it): "ran" or the
    error's first line."""
    import torch.distributed as dist

    t = torch.ones(4, device="cuda")
    out = {}
    for name, call in (
            ("all_reduce", lambda: dist.all_reduce(t.clone())),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(4 * dist.get_world_size(), device="cuda"), t))):
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "ran"
        except Exception as e:   # the outcome is the finding
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return out


def _mesh_hold(name, plain, sharded) -> dict:
    """Each step's loss and grad norm of `sharded` against `plain`: the
    relative gaps and step 0's float32 ulps; fails past TOL_MESH."""
    rel = [max(abs(a - b) / abs(b) for a, b in zip(s, p))
           for s, p in zip(sharded["metrics"], plain["metrics"])]
    (l0, g0), (pl0, pg0) = sharded["metrics"][0], plain["metrics"][0]
    ulps = dict(loss=_f32_ulps(l0, pl0), grad_norm=_f32_ulps(g0, pg0))
    check(max(rel) <= TOL_MESH, f"{name} vs the plain step: rel {rel}")
    return dict(rel=rel, step0_ulps=ulps)


def _mesh_phase(cfg, params, smi: str) -> list:
    """The mesh phase (MESH_LABEL; see the constants): (a) the full-width
    sharded step under each scheme against the plain one, (c) the MoE's
    grouped dispatch with rules and (d) the other families, in a one-rank
    NCCL group made here; (b) the launcher's --dp-mode pjit --mesh 1x1
    against the plain launcher (its own group)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import RunConfig, init_params

    dev = torch.device("cuda")
    rows = []
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                           global_batch=TRAIN_B, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_at(i).items()}
               for i in range(MESH_STEPS)]
    run = RunConfig(attn_impl="ref")
    moe_cfg = get_config(MESH_MOE_ARCH).reduced()
    moe_run = RunConfig(attn_impl="ref", moe_dispatch="grouped",
                        moe_groups=MESH_MOE_GROUPS)
    moe_params = init_params(moe_cfg, torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    moe_batches = _mesh_batches(moe_cfg, MESH_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            t0 = time.perf_counter()
            mesh = make_test_mesh((1, 1))
            plain = _mesh_steps(cfg, params, batches, run, None)
            for scheme in MESH_SCHEMES:
                rules = make_rules(mesh, scheme)
                got = _mesh_steps(cfg, params, batches, run, rules)
                name = (f"lm_train_mesh[{cfg.name}, {scheme}, B={TRAIN_B}, "
                        f"S={TRAIN_S}, {MESH_STEPS} steps]")
                hold = _mesh_hold(name, plain, got)
                row = dict(name=name, label=MESH_LABEL, scheme=scheme,
                           metrics=got["metrics"],
                           plain_metrics=plain["metrics"], **hold,
                           ms=got["ms"], host_ms=got["host_ms"],
                           plain_ms=plain["ms"],
                           plain_host_ms=plain["host_ms"],
                           peak_mib=got["peak_mib"],
                           plain_peak_mib=plain["peak_mib"])
                print(f"path {name} [{MESH_LABEL}]: losses / grad norms "
                      f"{got['metrics']} vs the plain step's "
                      f"{plain['metrics']} (rel {hold['rel']}, tol "
                      f"{TOL_MESH}); step 0 float32 ulps "
                      f"{hold['step0_ulps']}; ms per step (events) "
                      f"{got['ms']} vs plain {plain['ms']}, host clock "
                      f"{got['host_ms']} vs {plain['host_ms']}; peak "
                      f"{got['peak_mib']:.1f} MiB vs plain "
                      f"{plain['peak_mib']:.1f} ({smi})")
                rows.append(row)
            moe_plain = _mesh_steps(moe_cfg, moe_params, moe_batches,
                                    moe_run, None)
            for scheme in MESH_SCHEMES:
                got = _mesh_steps(moe_cfg, moe_params, moe_batches, moe_run,
                                  make_rules(mesh, scheme))
                name = (f"lm_train_mesh[{moe_cfg.name}, grouped "
                        f"x{MESH_MOE_GROUPS}, {scheme}, B={MESH_MOE_B}, "
                        f"S={MESH_MOE_S}]")
                hold = _mesh_hold(name, moe_plain, got)
                print(f"path {name} [{MESH_LABEL}]: {got['metrics']} vs "
                      f"plain {moe_plain['metrics']} (rel {hold['rel']}); "
                      f"host ms per step {got['host_ms']} vs "
                      f"{moe_plain['host_ms']}")
                rows.append(dict(name=name, label=MESH_LABEL, scheme=scheme,
                                 metrics=got["metrics"],
                                 plain_metrics=moe_plain["metrics"], **hold,
                                 host_ms=got["host_ms"],
                                 plain_host_ms=moe_plain["host_ms"]))
            rules = make_rules(mesh, "default")
            for arch in MESH_FAMILIES:
                fcfg = get_config(arch).reduced()
                fp = init_params(fcfg, torch.Generator(
                    device=dev).manual_seed(SEED), device=dev)
                fb = _mesh_batches(fcfg, MESH_STEPS)
                fplain = _mesh_steps(fcfg, fp, fb, run, None)
                got = _mesh_steps(fcfg, fp, fb, run, rules)
                name = (f"lm_train_mesh[{fcfg.name}, default, "
                        f"B={MESH_MOE_B}, S={MESH_MOE_S}]")
                hold = _mesh_hold(name, fplain, got)
                pre = _mesh_prefill(fcfg, fp, run, rules)
                print(f"path {name} [{MESH_LABEL}]: {got['metrics']} vs "
                      f"plain {fplain['metrics']} (rel {hold['rel']}); "
                      f"prefill of {MESH_PROMPT} tokens vs plain {pre!r} "
                      f"of the max (tol {TOL_MESH})")
                check(pre <= TOL_MESH, f"{name}: sharded prefill {pre}")
                rows.append(dict(name=name, label=MESH_LABEL,
                                 scheme="default", metrics=got["metrics"],
                                 plain_metrics=fplain["metrics"], **hold,
                                 prefill_rel=pre))
                del fp, fb
            mesh_s = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    del moe_params, moe_batches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plain_l = train.run(train.parse_args(GOSSIP_TRAIN_ARGV))["losses"]
    argv = GOSSIP_TRAIN_ARGV + ["--dp-mode", "pjit", "--mesh", "1x1"]
    got_l = train.train(train.parse_args(argv))["losses"]
    diffs = {s: abs(got_l[s] - plain_l[s]) for s in plain_l}
    name = f"launch.train {' '.join(argv)}"
    print(f"path {name} [{MESH_LABEL}]: losses {got_l} vs the plain "
          f"launcher's {plain_l} (max |d| {max(diffs.values()):.3e}, tol "
          f"{TOL_MESH}); {time.perf_counter() - t0:.1f} s for both; the "
          f"in-process phases {mesh_s:.1f} s")
    check(sorted(got_l) == sorted(plain_l)
          and max(diffs.values()) <= TOL_MESH,
          f"launcher pjit 1x1 vs plain: {diffs}")
    rows.append(dict(name=name, label=MESH_LABEL, losses=got_l,
                     plain_losses=plain_l,
                     max_abs_loss_diff=max(diffs.values())))
    return rows


def _lm_train_phase(cfg, params, smi: str) -> list:
    """Training: (a) full width and depth in this process, (b) the
    launcher's fail-and-resume protocol, (c) gossip on 4 ranks."""
    import tempfile

    rows = [_lm_train_full(cfg, params, smi)]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        rows.append(_lm_train_resume(tmp))
    rows.append(_lm_train_gossip(smi))
    return rows


# ---------------------------------------------------------------------------
# The remat levers and the dry-run
# ---------------------------------------------------------------------------
def _restore(params: dict, host: dict) -> None:
    """Copy the host copy `host` back into the parameters in place."""
    from repro_torch.tree import leaves

    for p, h in zip(leaves(params), leaves(host)):
        p.copy_(h, non_blocking=True)
    torch.cuda.synchronize()


def _remat_phase(cfg, params, smi: str) -> dict:
    """The remat phase (see REMAT_RUNS): each mode's loss and gradients
    against `none`'s bit for bit, its peaks and ms (after one untimed
    step under `none`); returns the rows by mode and what the dry-run
    phase reuses (the batch and the host copy of the parameters)."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import RunConfig, steps
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import global_norm
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    dev = torch.device("cuda")
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                           global_batch=TRAIN_B, seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(0).items()}
    host = tree_map(lambda t: t.to("cpu", copy=True), params)
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))

    def timed(fn):
        """(fn(), its ms by CUDA events, the peak MiB while it ran)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        return out, a.elapsed_time(b), peak

    def one_step(run):
        opt = adamw_init(params)
        step = steps.build_train_step(cfg, run, lr=TRAIN_LR)
        (_, opt, m), ms, peak = timed(lambda: step(params, opt, batch))
        out = float(m["loss"]), float(m["grad_norm"]), ms, peak
        del opt, m
        _restore(params, host)
        return out

    # untimed warm-up: a step, and the checkpoint's first call (which
    # imports torch._dynamo, seconds of host time)
    one_step(RunConfig(attn_impl="ref"))
    steps.loss_and_grads(steps.build_loss_fn(
        cfg, RunConfig(attn_impl="ref", remat="dots")), params, batch)
    ref, rows = None, {}
    for label, kw in REMAT_RUNS.items():
        run = RunConfig(attn_impl="ref", **kw)
        loss_fn = steps.build_loss_fn(cfg, run)
        (loss, grads), grads_ms, grads_peak = timed(
            lambda: steps.loss_and_grads(loss_fn, params, batch))
        del grads
        (loss, grads), grads_ms2, _ = timed(
            lambda: steps.loss_and_grads(loss_fn, params, batch))
        gnorm = float(global_norm(grads))
        if ref is None:
            ref = dict(loss=float(loss), gnorm=gnorm,
                       grads=tree_map(lambda t: t.to("cpu"), grads))
            differ = []
        else:
            differ = ["/".join(k) for (k, g), h in zip(
                leaves_with_paths(grads), leaves(ref["grads"]))
                if not torch.equal(g, h.to(dev))]
        del grads
        step_loss, step_gnorm, step_ms, step_peak = one_step(run)
        _, _, step_ms2, _ = one_step(run)
        ulps = dict(loss=_f32_ulps(float(loss), ref["loss"]),
                    grad_norm=_f32_ulps(gnorm, ref["gnorm"]),
                    step_loss=_f32_ulps(step_loss, ref["loss"]),
                    step_grad_norm=_f32_ulps(step_gnorm, ref["gnorm"]))
        rows[label] = dict(loss=float(loss), grad_norm=gnorm,
                           step_loss=step_loss, step_grad_norm=step_gnorm,
                           ulps_vs_none=ulps, leaves_differ=differ,
                           grads_peak_mib=grads_peak,
                           grads_ms=[grads_ms, grads_ms2],
                           step_peak_mib=step_peak,
                           step_ms=[step_ms, step_ms2])
        print(f"path lm_train_remat[{cfg.name}, {label}, B={TRAIN_B}, "
              f"S={TRAIN_S}]: loss {float(loss)!r}, grad norm {gnorm!r}; "
              f"float32 ulps from none {ulps} (limit {REMAT_ULPS}); "
              f"gradients of {len(differ)} leaves differ from none's "
              f"{differ}; loss_and_grads {grads_ms:.3f}, {grads_ms2:.3f}"
              f" ms, peak {grads_peak:.1f} MiB; the train step "
              f"{step_ms:.3f}, {step_ms2:.3f} ms, peak {step_peak:.1f} MiB "
              f"(CUDA events, two calls each; {smi})")
        check(not differ and max(ulps.values()) <= REMAT_ULPS,
              f"remat {label} vs none: ulps {ulps}, leaves {differ}")
        check(math.isfinite(step_loss) and math.isfinite(step_gnorm),
              f"remat {label}: the step's loss and grad norm")
    del ref
    torch.cuda.empty_cache()
    none = rows["none"]
    for r in rows.values():
        r.update(grads_peak_vs_none_mib=r["grads_peak_mib"]
                 - none["grads_peak_mib"],
                 step_peak_vs_none_mib=r["step_peak_mib"]
                 - none["step_peak_mib"])
    vs = {k: (round(r["grads_peak_vs_none_mib"], 1),
              round(r["step_peak_vs_none_mib"], 1)) for k, r in rows.items()}
    print(f"remat peaks vs none (MiB; loss_and_grads / the whole step): "
          f"{vs}")
    return dict(rows=rows, batch=batch, host=host)


def _dryrun_phase(cfg, params, remat: dict, smi: str) -> list:
    """The dry-run phase (see DRYRUN_CELLS): the launcher's cells in a
    child process, then the counter over the real plain train step on
    the card against the same step on meta tensors, and the roofline of
    that step beside its measured ms."""
    import os
    import tempfile

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun, inputs
    from repro_torch.launch.roofline import Roofline
    from repro_torch.models import RunConfig, params as mparams, steps
    from repro_torch.optim import adamw_init

    rows = []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {}
        for arch, shape in DRYRUN_CELLS:      # one child per cell, at once
            out = Path(tmp) / f"{arch}-{shape}.json"
            procs[(arch, shape)] = (out, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--out", str(out)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for (arch, shape), (out, proc) in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                proc.kill()
            secs = time.perf_counter() - t0
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("[dryrun]")]
            check(proc.returncode == 0 and out.is_file(),
                  f"dryrun {arch} x {shape}: rc {proc.returncode}, "
                  f"{stdout[-1000:]} {stderr[-2000:]}")
            rec = json.loads(out.read_text())[0]
            mf = rec["model_flops"]["model_flops_per_device"]
            print(f"path dryrun[{arch} x {shape}, 16x16 fake group, meta]: "
                  f"{line[-1] if line else ''}; done {secs:.1f} s after "
                  f"the start (setup {rec['lower_s']} s, the counted run "
                  f"{rec['compile_s']} s); counted {rec['cost']['flops']:.4e} "
                  f"FLOPs per rank = {rec['cost']['flops'] / mf:.3f} x "
                  f"model_flops_per_device {mf:.4e}; collective bytes per "
                  f"rank {rec['collectives']['collective_bytes_per_device']}"
                  f"; resident {rec['memory']['total_hbm_bytes'] / 1e9:.3f}"
                  f" GB, fits 80 GB {rec['fits_hbm_80g']}")
            check(rec["status"] == "ok", f"dryrun {arch} x {shape}: {rec}")
            rows.append(dict(name=f"dryrun[{arch} x {shape}]", seconds=secs,
                             flops_per_device=rec["cost"]["flops"],
                             model_flops_per_device=mf,
                             collective_bytes_per_device=rec["collectives"][
                                 "collective_bytes_per_device"],
                             roofline=rec["roofline"],
                             memory=rec["memory"],
                             fits_hbm_80g=rec["fits_hbm_80g"]))
    # the counter over the real plain step on the card and over the same
    # step on meta tensors
    run = RunConfig(attn_impl="ref")
    batch, host = remat["batch"], remat["host"]
    step = steps.build_train_step(cfg, run, lr=TRAIN_LR)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    _, card = dryrun.count_step(step, params, opt, batch)
    torch.cuda.synchronize()
    del opt
    _restore(params, host)
    shape = ShapeSpec("smoke", TRAIN_S, TRAIN_B, "train")
    meta_p = mparams.param_shapes(cfg)
    _, meta = dryrun.count_step(
        steps.build_train_step(cfg, run, lr=TRAIN_LR), meta_p,
        adamw_init(meta_p), inputs.batch_specs(cfg, shape))
    rel = abs(card.flops - meta.flops) / meta.flops
    rf = Roofline(card.flops, card.bytes, 0.0)
    ms = remat["rows"]["none"]["step_ms"][-1]
    print(f"path dryrun.count_step[{cfg.name} train step, B={TRAIN_B}, "
          f"S={TRAIN_S}, plain]: on the card {card.flops:.6e} FLOPs, "
          f"{card.bytes:.6e} bytes; on meta tensors {meta.flops:.6e} "
          f"FLOPs, {meta.bytes:.6e} bytes (rel {rel:.3e}, tol "
          f"{DRYRUN_FLOPS_REL}); roofline compute {1e3 * rf.compute_s:.3f}"
          f" ms, memory {1e3 * rf.memory_s:.3f} ms (unfused bytes), "
          f"measured {ms:.3f} ms per step ({smi})")
    check(rel <= DRYRUN_FLOPS_REL, f"count_step on the card vs meta: rel "
          f"{rel}")
    rows.append(dict(name=f"dryrun.count_step[{cfg.name}, B={TRAIN_B}, "
                          f"S={TRAIN_S}]", card_flops=card.flops,
                     meta_flops=meta.flops, card_bytes=card.bytes,
                     meta_bytes=meta.bytes, compute_ms=1e3 * rf.compute_s,
                     memory_ms=1e3 * rf.memory_s, measured_ms=ms))
    return rows


# ---------------------------------------------------------------------------
# The other model families: MoE, MLA, RWKV6, hymba, whisper (phase 16)
# ---------------------------------------------------------------------------
_MATMUL = ("gemm", "gemv", "cutlass", "xmma", "nvjet")


def _family_flash_checks(flash_rows: dict, gen) -> None:
    """The tensor-core flash kernel at the families' layer shapes
    (FAMILY_FLASH_CASES: whisper's non-causal encoder and cross-attention
    and causal decoder at D 64, qwen3-moe's causal GQA 32 / 4 at D 128),
    each against its plain version (atol = rtol = TOL_FLASH, and the
    row-scaled TOL_FLASH_ROW against the f32 plain version on the same
    bf16 inputs) and timed beside it and SDPA; each row joins
    `flash_rows` under its case's name."""
    from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                     flash_attention_wgmma)

    dev = torch.device("cuda")
    tol = TOL_FLASH[torch.bfloat16]
    for case, (b, hq, hkv, sq, sk, d, causal) in FAMILY_FLASH_CASES.items():
        q = torch.randn(b, hq, sq, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, hkv, sk, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, hkv, sk, d, generator=gen, device=dev).bfloat16()
        before = flash_attention_wgmma.launches
        got = flash_attention_wgmma(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        ref32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                      causal=causal)
        torch.cuda.synchronize()
        check(flash_attention_wgmma.launches == before + 1,
              f"flash_attention_wgmma {case} did not launch")
        err, rel = rel_err(got, want)
        excess = float(((got.float() - want.float()).abs()
                        - tol * want.float().abs()).max())
        row_err = flash_row_err(got, ref32,
                                ref32.pow(2).mean(-1, keepdim=True).sqrt())
        check(got.dtype == torch.bfloat16 and excess <= tol,
              f"flash_attention_wgmma {case}: |err| - rtol |ref| = "
              f"{excess:.3e} > atol {tol}")
        check(row_err <= TOL_FLASH_ROW, f"flash_attention_wgmma {case}: "
              f"row-scaled error {row_err:.3e} > {TOL_FLASH_ROW}")
        del want, ref32

        def call(q=q, k=k, v=v, causal=causal):
            return flash_attention_wgmma(q, k, v, causal=causal)

        def sdpa(q=q, k=k, v=v, causal=causal):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)

        ms = time_ms(call, 10)
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v,
                                                         causal=causal),
                           3, warmup=1)
        lib_ms = time_ms(sdpa, 10)
        # late in the run CUPTI can return a session without the kernel's
        # records: trace again, up to TRACE_SESSIONS sessions
        dev_ms = lib_dev = None
        for _ in range(TRACE_SESSIONS):
            dev_ms = dev_ms or device_ms(call, 5,
                                         "flash_attention_wgmma_kernel")
            lib_dev = lib_dev or all_device_ms(sdpa, 5)
            if dev_ms and lib_dev:
                break
        pairs = sq * (sq + 1) // 2 if causal else sq * sk
        flops = 4 * b * hq * d * pairs
        nbytes = 2 * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        row = dict(kernel="flash_attention_wgmma",
                   shape=[b, hq, hkv, sq, sk, d], causal=causal,
                   dtype="bfloat16", max_abs_err=err, rel_err=rel, tol=tol,
                   row_err=row_err, row_tol=TOL_FLASH_ROW, ms=ms,
                   device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                   library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
                   flops=flops, bytes=nbytes,
                   bound_share=b_ms / dev_ms if dev_ms else None)
        flash_rows[case] = row
        print(f"kernel flash_attention_wgmma {case} (B, Hq, Hkv, Sq, Sk, D)="
              f"{(b, hq, hkv, sq, sk, d)} bf16 "
              f"{'causal' if causal else 'non-causal'}: max_abs_err="
              f"{err:.3e} (atol = rtol = {tol}); row-scaled err="
              f"{row_err:.3e} (tol {TOL_FLASH_ROW}) ms={ms:.4f} device_ms="
              f"{dev_ms} plain_ms={plain_ms:.4f} library_ms("
              f"scaled_dot_product_attention)={lib_ms:.4f} "
              f"library_device_ms={lib_dev} bound_ms={b_ms:.5f} ({b_by}, "
              f"bf16 peak) bound/device={row['bound_share']}")
        del q, k, v, got


def _family_flash_launches(cfg, kernel: str) -> dict:
    """The flash launches of one forward of `cfg`: one per attention the
    JAX dispatch sends to the kernel (no window, equal q and v head dims):
    none for MLA (q 192 wide, v 128), hymba (a window) and RWKV6; a
    decoder layer's self-attention, and for whisper its cross-attention
    and each encoder layer's."""
    if cfg.mixer != "attention" or cfg.sliding_window:
        return {}
    return {kernel: cfg.n_layers * (2 if cfg.is_encoder_decoder else 1)
            + cfg.n_encoder_layers}


def _no_drop(cfg):
    """The MoE capacity factor at which nothing drops (n_experts / top_k:
    `capacity` returns every token)."""
    return cfg.n_experts / cfg.top_k if cfg.n_experts else None


def _family_frames(cfg, batch: int, gen):
    """N(0, 1) encoder frames (batch, encoder_seq, D) in the model dtype,
    as the serve launcher draws them, in `forward`'s keyword form."""
    if not cfg.is_encoder_decoder:
        return {}
    return {"encoder_frames": torch.randn(
        batch, cfg.encoder_seq, cfg.d_model, generator=gen,
        device=torch.device("cuda"), dtype=cfg.torch_dtype)}


def _family_bf16(arch: str, run_path, path_rows: list, smi: str) -> list:
    """`arch` at full width in bf16 (FAMILY_RUNS): the flash forward
    (counted, timed, traced by kernel group), then FAMILY_STEPS serve
    steps from a FAMILY_PROMPT-token prompt under
    ``set_sync_debug_mode("error")`` (timed, one step traced), and
    decode's logits against the bf16 flash forward at the no-drop MoE
    capacity, printed (bf16 is held nowhere: the f32 run is)."""
    from repro_torch.configs import get_config
    from repro_torch.models import (RunConfig, count_params, decode as dec,
                                    forward, init_params, lm_loss, steps)
    from repro_torch.tree import leaves

    dev = torch.device("cuda")
    layers, B, S = FAMILY_RUNS[arch]
    base = get_config(arch)
    cfg = dataclasses.replace(base, n_layers=layers) if layers else base
    cut = f", {layers} of {base.n_layers} layers" if layers else ""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    weight_gib = sum(t.nbytes for t in leaves(params)) / 2**30
    print(f"{arch}{cut}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, mixer "
          f"{cfg.mixer}, experts {cfg.n_experts} (top {cfg.top_k}, shared "
          f"{cfg.n_shared_experts}), {count_params(cfg)} parameters, "
          f"{weight_gib:.2f} GiB of bf16 drawn in {draw_s:.1f} s (peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB)")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           generator=gen)
    extra = _family_frames(cfg, B, gen)
    run = RunConfig("flash")
    name = (f"lm_forward[{arch}{cut}, bf16, B={B}, S={S}"
            + (f", frames={cfg.encoder_seq}" if extra else "") + "]")
    logits, counts = run_path(
        name, lambda: forward(cfg, params, tokens, run, **extra),
        steady_iters=2)
    want = _family_flash_launches(cfg, "flash_attention_wgmma")
    check({k: v for k, v in counts.items() if v} == want,
          f"{name}: flash launches {counts}, expected {want}")
    check(tuple(logits.shape) == (B, S, cfg.vocab_size)
          and logits.dtype == torch.bfloat16, f"{name}: logits shape")
    loss = float(lm_loss(logits, tokens))
    check(bool(torch.isfinite(logits).all()) and math.isfinite(loss),
          f"{name}: non-finite logits or loss")
    del logits
    row = path_rows[-1]
    row.update(tokens_per_s=B * S / (row["steady_ms"] / 1e3), loss=loss,
               layers=cfg.n_layers, full_layers=base.n_layers,
               weight_gib=weight_gib, draw_s=draw_s)
    t0 = time.perf_counter()
    row["profile"] = device_breakdown(
        lambda: forward(cfg, params, tokens, run, **extra),
        {"flash_attention": ("flash_attention_wgmma_kernel",),
         "matmul": _MATMUL}, host_ops=False)
    row["profile_s"] = time.perf_counter() - t0
    print(f"  {row['tokens_per_s']:.1f} tokens/s (steady), loss {loss:.6f}"
          f"; one forward under torch.profiler (the card's activity; "
          f"{row['profile_s']:.1f} s with the read-back), device ms by "
          f"kernel group and busy share: {row['profile']} ({smi})")

    # -- serve steps --------------------------------------------------------
    dname = (f"lm_decode[{arch}{cut}, bf16, B={FAMILY_B}, prompt="
             f"{FAMILY_PROMPT}, steps={FAMILY_STEPS}]")
    prompt = torch.randint(0, cfg.vocab_size, (FAMILY_B, FAMILY_PROMPT),
                           device=dev, generator=gen)
    dframes = _family_frames(cfg, FAMILY_B, gen)
    got = _held_decode(dec, steps, cfg, params, prompt, FAMILY_STEPS + 1,
                       frames=dframes.get("encoder_frames"))
    cache = got["cache"]
    steady = sum(got["step_ms"][1:]) / (FAMILY_STEPS - 1)
    trace = _profile_call(lambda t: got["serve_step"](params, cache, t),
                          got["generated"][:, -1:], {"matmul": _MATMUL})
    cache_mib = sum(t.nbytes for t in cache.values()) / 2**20
    seq = torch.cat([prompt, got["generated"][:, :-1]], dim=1)
    ref = forward(cfg, params, seq,
                  RunConfig("flash", moe_capacity_factor=_no_drop(cfg)),
                  **dframes)
    d, rel = _position_errors(got["logits"], ref[:, -(FAMILY_STEPS + 1):])
    drow = dict(name=dname, prefill_s=got["prefill_ms"] / 1e3,
                first_ms=got["step_ms"][0], steady_ms=steady,
                tokens_per_s=FAMILY_B / (steady / 1e3),
                peak_mib=got["peak_mib"], cache_mib=cache_mib, trace=trace,
                kernels_per_step=trace["kernels"] if trace else None,
                busy_share=trace["busy_ms"] / steady if trace else None,
                bf16_logits_max_abs_err=float(d.max()),
                bf16_logits_rel_err=float(rel.max()))
    print(f"path {dname}: prefill {drow['prefill_s']:.3f} s, first step "
          f"{drow['first_ms']:.3f} ms, steady {steady:.3f} ms per step (CUDA"
          f" events, mean of {FAMILY_STEPS - 1}), {drow['tokens_per_s']:.1f}"
          f" tokens/s, peak {got['peak_mib']:.1f} MiB, cache {cache_mib:.1f}"
          f" MiB; one step under torch.profiler: {trace}; busy share "
          f"{drow['busy_share']}; bf16 decode vs the bf16 flash forward at "
          f"{FAMILY_STEPS + 1} positions: max abs {float(d.max()):.4e}, "
          f"worst {float(rel.max()):.4e} of its position's max (not a "
          f"gate) ({smi})")
    del params, got, cache, ref
    torch.cuda.empty_cache()
    return [drow]


def _route_recorder(sink: list):
    """A stand-in for `models.moe.route` that also keeps, per call, the
    expert ids it picks and the gap between the k-th and (k+1)-th router
    logits (f32, on the card: nothing read on the host)."""
    from repro_torch.models import moe

    real = moe.route

    def route(x, router, top_k, router_dtype=torch.float32):
        logits = x.to(router_dtype) @ router.to(router_dtype)
        vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        sink.append((idx[..., :top_k], vals[..., top_k - 1] - vals[..., top_k]))
        return real(x, router, top_k, router_dtype)

    return route


def _family_f32_hold(arch: str, run_path) -> dict:
    """`arch` at full width, FAMILY_F32_LAYERS layers, f32: decode (the
    prompt prefilled, then FAMILY_STEPS serve steps, under
    ``set_sync_debug_mode("error")``) against the flash forward over the
    same tokens at every position, to TOL_FAMILY_F32 of the position's
    max; the MoE at the no-drop capacity, its expert picks compared
    (a near tie leaves the hold, printed)."""
    from repro_torch.configs import get_config
    from repro_torch.models import (RunConfig, decode as dec, forward,
                                    init_params, moe, steps)

    dev = torch.device("cuda")
    base = get_config(arch)
    cfg = dataclasses.replace(
        base, n_layers=FAMILY_F32_LAYERS, dtype="float32",
        n_encoder_layers=min(base.n_encoder_layers, FAMILY_F32_LAYERS))
    run = RunConfig(moe_capacity_factor=_no_drop(cfg))
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    params = init_params(cfg, gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (FAMILY_B, FAMILY_PROMPT),
                           device=dev, generator=gen)
    extra = _family_frames(cfg, FAMILY_B, gen)
    P = FAMILY_PROMPT + FAMILY_STEPS
    cache = dec.start_cache(cfg, params, FAMILY_B, P, run, **extra)
    serve_step = steps.build_serve_step(cfg, run)
    seen, dec_routes, fwd_routes = [], [], []
    real = dec.decode_step

    def recording(*args, **kwargs):
        logits, c = real(*args, **kwargs)
        seen.append(logits)
        return logits, c

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with mock.patch.object(dec, "decode_step", recording), \
                mock.patch.object(moe, "route", _route_recorder(dec_routes)):
            logits, cache = dec.prefill(cfg, params, prompt, cache, run)
            out = [logits.argmax(-1).to(prompt.dtype)]
            for _ in range(FAMILY_STEPS):
                tok, cache = serve_step(params, cache, out[-1][:, None])
                out.append(tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    seq = torch.cat([prompt, torch.stack(out[:FAMILY_STEPS], dim=1)], dim=1)
    name = (f"lm_forward[{arch}, f32, {cfg.n_layers} layers, B={FAMILY_B}, "
            f"S={P}] (decode's reference)")
    with mock.patch.object(moe, "route", _route_recorder(fwd_routes)):
        full, counts = run_path(name, lambda: forward(
            cfg, params, seq, dataclasses.replace(run, attn_impl="flash"),
            **extra), steady_iters=0)
    want = _family_flash_launches(cfg, "flash_attention_ffma")
    check({k: v for k, v in counts.items() if v} == want,
          f"{name}: flash launches {counts}, expected {want}")
    dl = torch.stack(seen, dim=1)
    check(len(seen) == P and bool(torch.isfinite(dl).all()),
          f"{arch} f32: {len(seen)} decoded positions or non-finite logits")
    d, rel = _position_errors(dl, full)
    ties = {}
    L = cfg.n_layers
    for layer in range(L if cfg.n_experts else 0):
        f_idx, f_gap = fwd_routes[layer]
        f_idx = f_idx.reshape(FAMILY_B, P, -1).sort(-1).values
        f_gap = f_gap.reshape(FAMILY_B, P)
        d_idx = torch.stack([dec_routes[t * L + layer][0] for t in range(P)],
                            dim=1).sort(-1).values
        d_gap = torch.stack([dec_routes[t * L + layer][1] for t in range(P)],
                            dim=1)
        gap = torch.minimum(f_gap, d_gap)
        for b, t in (d_idx != f_idx).any(-1).nonzero().tolist():
            g = float(gap[b, t])
            what = (f"{arch} f32 layer {layer}, sequence {b}, position {t}: "
                    f"decode picks {d_idx[b, t].tolist()}, the forward "
                    f"{f_idx[b, t].tolist()}, k-th to (k+1)-th router gap "
                    f"{g:.3e}")
            check(g < MOE_TIE_GAP, what + f" >= {MOE_TIE_GAP}")
            print(f"  near tie (leaves the hold): {what}")
            ties.setdefault(t, []).append(g)
    held = [t for t in range(P) if t not in ties]
    worst = float(rel[held].max())
    at = held[int(rel[held].argmax())]
    print(f"path lm_decode[{arch}, f32, {cfg.n_layers} layers, B="
          f"{FAMILY_B}, prompt={FAMILY_PROMPT}, steps={FAMILY_STEPS}] vs the "
          f"f32 flash forward at {len(held)} of {P} positions: max abs "
          f"{float(d[held].max()):.4e}, worst position {at} at {worst:.4e} "
          f"of its max (tol {TOL_FAMILY_F32}); near ties {len(ties)}")
    check(worst <= TOL_FAMILY_F32,
          f"{arch} f32: decode logits {worst} of the max from the forward's")
    del params, cache, full, dl
    torch.cuda.empty_cache()
    return dict(name=f"lm_decode[{arch}, f32, {cfg.n_layers} layers] vs "
                     f"the flash forward",
                positions=P, held=len(held), logits_max_abs_err=float(
                    d[held].max()), logits_rel_err=worst,
                near_ties={str(t): g for t, g in ties.items()})


def _subquadratic_check(arch: str) -> dict:
    """The cache of `arch` at full width for SUBQ_MAX_SEQ tokens at B 2
    against a full K and V cache (elements, as the JAX test counts them):
    under SUBQ_SHARE."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode as dec

    cfg = get_config(arch)
    cache = dec.init_cache(cfg, 2, SUBQ_MAX_SEQ, device="cuda")
    total = sum(t.nbytes for t in cache.values())
    full_kv = cfg.n_layers * 2 * 2 * cfg.n_kv_heads * SUBQ_MAX_SEQ * cfg.hd
    print(f"{arch}: the cache for {SUBQ_MAX_SEQ} tokens at B 2 holds "
          f"{total} bytes, {total / full_kv:.3e} of a full KV cache "
          f"({full_kv} elements; limit {SUBQ_SHARE})")
    check(total < SUBQ_SHARE * full_kv, f"{arch}: the cache grows with S")
    del cache
    return dict(name=f"cache[{arch}, max_seq={SUBQ_MAX_SEQ}]",
                bytes=total, full_kv_elements=full_kv,
                share=total / full_kv)


def _serve_lm_example() -> list:
    """`python -m repro_torch.examples.serve_lm` on the card, in this
    process (the JAX example's arguments): exit 0 and the launcher's
    three ``[serve]`` lines, which it returns."""
    import contextlib
    import io

    from repro_torch.examples import serve_lm

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_lm.main([])
    lines = [l for l in buf.getvalue().splitlines() if l.startswith("[serve]")]
    check(rc == 0 and len(lines) == 3,
          f"examples.serve_lm: exit {rc}, output {buf.getvalue()!r}")
    return lines


def _families_phase(run_path, path_rows: list, flash_rows: dict,
                    smi: str) -> list:
    """Phase 16: the flash kernel at the families' layer shapes, then each
    family of FAMILY_RUNS in bf16 at full width and in f32 at
    FAMILY_F32_LAYERS layers, and the sub-quadratic caches."""
    from repro_torch.configs import get_config

    print(f"families phase: {torch.cuda.memory_allocated() / 2**20:.1f} MiB "
          f"still allocated on the card by the earlier phases")
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(SEED + 4)
    _family_flash_checks(flash_rows, gen)
    torch.cuda.empty_cache()
    rows = []
    for arch in FAMILY_RUNS:
        t0 = time.perf_counter()
        rows.extend(_family_bf16(arch, run_path, path_rows, smi))
        rows.append(_family_f32_hold(arch, run_path))
        if get_config(arch).sub_quadratic:
            rows.append(_subquadratic_check(arch))
        print(f"family {arch}: {time.perf_counter() - t0:.1f} s")
    return rows


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
    from repro_torch.kernels.cheb_step import (cheb_order, cheb_order_plain,
                                               cheb_step, cheb_step_plain,
                                               step_launcher)
    from repro_torch.kernels.cheb_sweep import (cheb_sweep, cheb_sweep_plain,
                                                jacobi_sweep,
                                                jacobi_sweep_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention_ffma, flash_attention_plain, flash_attention_wgmma)
    from repro_torch.kernels.jacobi_step import (jacobi_round,
                                                 jacobi_round_plain,
                                                 jacobi_step,
                                                 jacobi_step_plain)
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
    # the loop's form: launches prepared once, t_k over t_{k-2}, acc in
    # place (held too: the in-place outputs against the plain version)
    t2_in, acc_in = t2.clone(), acc.clone()
    launch = step_launcher(t1, acc_in, alpha=alpha)
    launch(pt, t1, t2_in, coef, t2_in, acc_in, acc_in)
    torch.cuda.synchronize()
    check(max(rel_err(t2_in, want[0])[1], rel_err(acc_in, want[1])[1])
          <= TOL_STEP, "cheb_step in place (the loop's form)")
    loop_ms = time_ms(lambda: launch(pt, t1, t2_in, coef, t2_in, acc_in,
                                     acc_in), 20)
    loop_dev = device_ms(lambda: launch(pt, t1, t2_in, coef, t2_in, acc_in,
                                        acc_in), 20, "cheb_step_kernel")
    print(f"kernel cheb_step B={BATCH} eta={eta}: max_abs_err="
          f"{max(err_tk, err_acc):.3e} rel={max(rel_tk, rel_acc):.3e} "
          f"(tol {TOL_STEP}) ms={step_ms:.4f} device_ms={step_dev} "
          f"plain_ms={step_plain:.4f} bound_ms={step_b[0]:.5f} "
          f"({step_b[1]}); the loop's prepared in-place launch ms="
          f"{loop_ms:.4f} device_ms={loop_dev}; "
          f"{_earlier('cheb_step')}")
    del t2_in, acc_in

    # the order instance: the sliced-ELL product of t_{k-1} fused with the
    # step (an order k >= 2, and order 1 from x), on the smoke graph
    coef2 = randn(2, eta)
    order_want = cheb_order_plain(SL, t1, t2, acc, coef, alpha=alpha)
    first_want = cheb_order_plain(SL, t1, None, None, coef2, alpha=alpha)
    order_got = cheb_order(SL, t1, t2, acc, coef, alpha=alpha)
    first_got = cheb_order(SL, t1, None, None, coef2, alpha=alpha)
    torch.cuda.synchronize()
    order_err = max(rel_err(g, w_)[0] for g, w_ in
                    zip(order_got + first_got, order_want + first_want))
    order_rel = max(rel_err(g, w_)[1] for g, w_ in
                    zip(order_got + first_got, order_want + first_want))
    check(order_rel <= TOL_SPMV, f"cheb_order: rel err {order_rel:.3e}")
    del order_want, first_want, order_got, first_got
    tk_buf, acc_in = t2.clone(), acc.clone()

    def order_call():
        return cheb_order(SL, t1, tk_buf, acc_in, coef, alpha=alpha,
                          out=(tk_buf, acc_in))

    order_ms = time_ms(order_call, 20)
    order_dev = device_ms(order_call, 20, "cheb_order_kernel")
    order_plain = time_ms(
        lambda: cheb_order_plain(SL, t1, t2, acc, coef, alpha=alpha), 5)
    order_b = bound(nnz * 8 + 4 * (3 * BATCH * N + 2 * BATCH * eta * N
                                   + eta),
                    2 * nnz * BATCH + BATCH * N * (4 + 2 * eta))
    order_row = dict(max_abs_err=order_err, rel_err=order_rel, ms=order_ms,
                     plain_ms=order_plain, bound_ms=order_b[0],
                     bound_by=order_b[1], device_ms=order_dev)
    print(f"kernel cheb_order B={BATCH} eta={eta} (SpMV + step fused; "
          f"orders k >= 2 and 1): max_abs_err={order_err:.3e} "
          f"rel={order_rel:.3e} (tol {TOL_SPMV}) ms={order_ms:.4f} "
          f"device_ms={order_dev} plain_ms={order_plain:.4f} "
          f"bound_ms={order_b[0]:.5f} ({order_b[1]}); "
          f"{_earlier('cheb_order')}")
    del tk_buf, acc_in

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
              f"bound_ms={b_ms:.5f} ({b_by})"
              + (f"; {_earlier('jacobi_step')}" if form == "path" else ""))

    # the round instance on L_norm (setting (a), deg(den) = 1): q = P x +
    # tau x fused with the update, b batched and inv_d shared as the
    # per-round path passes them, the output over x_prev
    SLn = A_n.sliced_ell()
    yb, dshared = rows["path"]
    round_want = jacobi_round_plain(SLn, xj, xj, xp, yb, dshared, a=1.0,
                                    c0=TAU, w=1.7, s=0.3)
    round_got = jacobi_round(SLn, xj, xj, xp, yb, dshared, a=1.0, c0=TAU,
                             w=1.7, s=0.3)
    torch.cuda.synchronize()
    round_err, round_rel = rel_err(round_got, round_want)
    check(round_rel <= TOL_SPMV, f"jacobi_round: rel err {round_rel:.3e}")
    out_buf = xp.clone()

    def round_call():
        return jacobi_round(SLn, xj, xj, xp, yb, dshared, a=1.0, c0=TAU,
                            w=1.7, s=0.3, out=out_buf)

    round_ms = time_ms(round_call, 20)
    round_dev = device_ms(round_call, 20, "jacobi_round_kernel")
    round_plain = time_ms(lambda: jacobi_round_plain(
        SLn, xj, xj, xp, yb, dshared, a=1.0, c0=TAU, w=1.7, s=0.3), 5)
    round_b = bound(nnz_n * 8 + 4 * (4 * BATCH * N + N),
                    2 * nnz_n * BATCH + 7 * BATCH * N)
    round_row = dict(max_abs_err=round_err, rel_err=round_rel, ms=round_ms,
                     plain_ms=round_plain, bound_ms=round_b[0],
                     bound_by=round_b[1], device_ms=round_dev)
    print(f"kernel jacobi_round B={BATCH} (L_norm, q = P x + tau x fused "
          f"with the update): max_abs_err={round_err:.3e} "
          f"rel={round_rel:.3e} (tol {TOL_SPMV}) ms={round_ms:.4f} "
          f"device_ms={round_dev} plain_ms={round_plain:.4f} "
          f"bound_ms={round_b[0]:.5f} ({round_b[1]}); "
          f"{_earlier('jacobi_round')}")
    del qx, xj, xp, rows, got, want, round_want, round_got, out_buf

    # ista_shrink: a threshold per scale (the lasso's (eta, 1)), per signal
    # and scale, and per vertex; then written over its input (out=a), one-
    # shot and in the ISTA loops' prepared form, per scale
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
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by})"
              + (f"; earlier, quoted from PERF.md, not measured in this "
                 f"run: {EARLIER_SHRINK} (H100 80GB HBM3, 700 W)"
                 if form == "scale" else ""))
    th = threshes["scale"]
    want = ista_shrink_plain(av, phv, grv, th, gamma=0.3)
    a_in = av.clone()
    got = ista_shrink(a_in, phv, grv, th, gamma=0.3, out=a_in)
    update = ops.ista_launcher(phv, th, 0.3)
    a_loop = av.clone()
    update(a_loop, grv, out=a_loop)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    check(rel <= TOL_STEP and bool(torch.equal(a_loop, got)),
          f"ista_shrink in place: rel err {rel:.3e}, the loop's launch equal "
          f"{bool(torch.equal(a_loop, got))}")
    # timed over the same buffer: each call shrinks the last one's output
    ms = time_ms(lambda: ista_shrink(a_in, phv, grv, th, gamma=0.3,
                                     out=a_in), 20)
    loop_ms = time_ms(lambda: update(a_loop, grv, out=a_loop), 20)
    dev_ms = device_ms(lambda: update(a_loop, grv, out=a_loop), 20,
                       "ista_shrink_kernel")
    b_ms, b_by = ist_rows["scale"]["bound_ms"], ist_rows["scale"]["bound_by"]
    ist_rows["in_place"] = dict(max_abs_err=err, rel_err=rel, ms=ms,
                                loop_ms=loop_ms,
                                plain_ms=ist_rows["scale"]["plain_ms"],
                                bound_ms=b_ms, bound_by=b_by,
                                device_ms=dev_ms)
    print(f"kernel ista_shrink B={BATCH} eta={eta} thresh=scale, out=a: "
          f"max_abs_err={err:.3e} rel={rel:.3e} (tol {TOL_STEP}) one-shot "
          f"ms={ms:.4f}, the loop's prepared launch ms={loop_ms:.4f} "
          f"device_ms={dev_ms} bound_ms={b_ms:.5f} ({b_by})")
    del a_in, a_loop, update
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
                cheb_order, cheb_sweep, jacobi_step, jacobi_round,
                jacobi_sweep, ista_shrink, flash_attention_wgmma,
                flash_attention_ffma)
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
    check({k: v for k, v in calls["apply[sweep=False]"].items() if v}
          == {"cheb_order": K},
          f"the per-order apply must be K fused order launches and no "
          f"SpMV, got {calls['apply[sweep=False]']}")

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
    # above the budget the plan's apply falls back to the per-order path:
    # K fused order launches, held against float64 dense
    check(need > ops.DEFAULT_SWEEP_L2_BUDGET, "B = 256 must be over budget")
    out, counts = run_path(f"apply[B={4 * BATCH}, guard fallback]",
                           lambda: plan.apply(xg))
    check({k: v for k, v in counts.items() if v} == {"cheb_order": K},
          f"the guard's fallback must be K fused order launches, got "
          f"{counts}")
    rel_check(out, dense.apply(xg.double()), TOL_PATH,
              f"apply[B={4 * BATCH}, guard fallback] vs f64 dense")
    del xg, out

    # -- the per-order path at n = 2**18, past the sweep's L2 budget ------
    _large_per_order(ops, graph, randn, run_path, path_rows)

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
    check({k: v for k, v in counts.items() if v} == {"jacobi_round": ROUNDS_A},
          f"the per-round path must be {ROUNDS_A} fused round launches, got "
          f"{counts}")
    check(tuple(res.history.shape) == (ROUNDS_A, BATCH, N), "history shape")
    rel_check(res.x, solved["jacobi"], TOL_ROUNDS,
              "per-round final iterate vs the sweep")
    rel_check(res.x, dense_n.solve(Y.double(), "jacobi", **kw_a).x, TOL_PATH,
              "solve[jacobi, history=True] (a) vs f64 dense")
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
          f"{coupling['rows']} x {coupling['cols']}, nnz {coupling['nnz']}; "
          f"compacted to {coupling['entry_rows']} rows in "
          f"{coupling['compact_slices']} slices, stored {coupling['stored']}, "
          f"from {coupling['slices_before']} slices, stored "
          f"{coupling['stored_before']}; {coupling['launches_per_round']} "
          f"launch a round) B={COMMUNITY_B}: max_abs_err="
          f"{coupling['max_abs_err']:.3e} rel={coupling['rel_err']:.3e} (tol "
          f"{TOL_SPMV}) ms={coupling['ms']:.4f} device_ms="
          f"{coupling['device_ms']} (r joined); tiles read in place ms="
          f"{coupling['tiles_ms']} device_ms={coupling['tiles_device_ms']}; "
          f"torch.cat of the tiles + launch ms="
          f"{coupling['cat_then_launch_ms']:.4f} device_ms="
          f"{coupling['cat_then_launch_device_ms']}; plain_ms="
          f"{coupling['plain_ms']:.4f} "
          f"library_ms(torch.addmm CSR)={coupling['library_ms']} "
          f"library_device_ms={coupling['library_device_ms']} bound_ms="
          f"{coupling['bound_ms']:.5f} ({coupling['bound_by']}, y over the "
          f"{coupling['entry_rows']} rows that hold an entry; "
          f"{coupling['bound_sectors_ms']:.5f} over the "
          f"{coupling['y_sectors']} 32-byte sectors of y they lie in); "
          f"device_ms in tiles of 8 / 4 signals "
          f"{coupling['device_ms_by_tile']} [{SHARD_LABEL}]; earlier, quoted from PERF.md, not measured in "
          f"this run: {EARLIER_COUPLING} (H100 80GB HBM3, 700 W)")
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
    # the wall-clock leader over the banded and general cuda_halo plans
    lead = [r["leader"] for r in ranks]
    for r in lead:
        for k, v in r["launches"].items():
            path_launches[k] += v
            sharded_launches[k] += v
    l0 = lead[0]
    for rate, row in l0["rates"].items():
        s = row["summary"]
        print(f"serving, wall-clock leader over cuda_halo banded + general "
              f"[{SHARD_LABEL}] at {rate} requests/s for "
              f"{SERVE_LEADER_S:g} s ({row['n_requests']} requests, "
              f"{row['kinds']}): p50 {s['latency_ms']['p50']:.3f} ms, p99 "
              f"{s['latency_ms']['p99']:.3f} ms, "
              f"{s['signals_per_sec']:.1f} signals/s, mean occupancy "
              f"{s['mean_batch_occupancy']:.2f}, padding waste "
              f"{s['padding_waste']:.3f}, {s['n_batches']} batches; "
              f"dispatch {row['dispatch_ms']:.3f} ms, broadcast "
              f"{row['broadcast_ms']:.3f} ms host per dispatch "
              f"({100 * row['broadcast_share']:.2f}% of a dispatch); "
              f"followers ran "
              f"{[r['rates'][rate]['followed'] for r in lead[1:]]} ({smi})")
    print(f"serving, wall-clock leader [{SHARD_LABEL}]: {l0['n_batches']} "
          f"batches in all, {l0['bitwise']} first batches per (plan, kind, "
          f"bucket) bit for bit the direct calls on every rank, "
          f"{l0['applied']} apply rows rel err {l0['rel_err']:.3e} (tol "
          f"{TOL_PATH}) against float64 dense; launches per rank "
          f"{[r['launches'] for r in lead]}; warm-up "
          f"{max(r['warm_s'] for r in lead):.1f} s")
    path_rows.append(dict(name="serving, wall-clock leader over cuda_halo",
                          label=SHARD_LABEL, ranks=lead))
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
    del logits, logits_ref

    # -- LM decode and serve: the same parameters, then the VLM backbone ----
    t0 = time.perf_counter()
    path_rows.extend(_lm_decode_phase(cfg, params, run_path, smi))
    print(f"lm decode phase: {time.perf_counter() - t0:.1f} s")

    # -- the sharded train step on a 1x1 mesh: the same parameters ----------
    t0 = time.perf_counter()
    path_rows.extend(_mesh_phase(cfg, params, smi))
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")

    # -- the remat levers and the dry-run: the same parameters -------------
    t0 = time.perf_counter()
    remat = _remat_phase(cfg, params, smi)
    path_rows.append(dict(name=f"lm_train_remat[{cfg.name}]",
                          modes=remat["rows"]))
    print(f"remat phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    path_rows.extend(_dryrun_phase(cfg, params, remat, smi))
    del remat
    torch.cuda.empty_cache()
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s")

    # -- LM training: the same parameters, then the launcher ---------------
    t0 = time.perf_counter()
    train_rows = _lm_train_phase(cfg, params, smi)
    path_rows.extend(train_rows)
    gossip_train = train_rows[-1]["cheb_step_launches_sum"]
    path_launches["cheb_step"] += gossip_train
    sharded_launches["cheb_step"] += gossip_train
    print(f"lm train phase: {time.perf_counter() - t0:.1f} s")
    del params, train_rows
    torch.cuda.empty_cache()

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

    # -- the other model families: MoE, MLA, RWKV6, hymba, whisper ----------
    t0 = time.perf_counter()
    path_rows.extend(_families_phase(run_path, path_rows, flash_rows, smi))
    print(f"lm families phase: {time.perf_counter() - t0:.1f} s")
    # -- the LM serving example, as a user runs it ---------------------------
    lines, _ = run_path("examples.serve_lm (hymba-1.5b --smoke, B 4, "
                        "16 + 24)", _serve_lm_example, steady_iters=0)
    for line in lines:
        print(f"examples.serve_lm: {line} ({smi})")

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
        # the same source's couplings' kernel: a general partition's
        # couplings (the JAX package scattered them with y.at[rows].add
        # around its Block-ELL SpMV)
        row("sliced_ell_spmv_accumulate", "sliced_ell_spmv.cu",
            "src/repro/kernels/bcsr_spmv.py:106", coupling,
            scatters="src/repro/dist/partition.py:784",
            batch=COMMUNITY_B, shape=[coupling["rows"], coupling["cols"]],
            nnz=coupling["nnz"], entry_rows=coupling["entry_rows"],
            compact_slices=coupling["compact_slices"],
            bound_sectors_ms=coupling["bound_sectors_ms"],
            device_ms_by_tile=coupling["device_ms_by_tile"],
            tiles_ms=coupling["tiles_ms"],
            tiles_device_ms=coupling["tiles_device_ms"],
            cat_then_launch_ms=coupling["cat_then_launch_ms"],
            label=SHARD_LABEL),
        row("cheb_step", "cheb_step.cu", "src/repro/kernels/cheb_step.py:66",
            step_row, gossip_leaf=gossip_step,
            gossip_train_launches=gossip_train, loop_ms=loop_ms,
            loop_device_ms=loop_dev),
        # the order instance: the sliced-ELL product fused with the step
        row("cheb_order", "cheb_step.cu", "src/repro/kernels/cheb_step.py:66",
            order_row, fuses="src/repro/kernels/bcsr_spmv.py:106",
            batch=BATCH, eta=eta),
        row("cheb_sweep", "cheb_sweep.cu",
            "src/repro/kernels/cheb_sweep.py:121", sweep_row,
            stored_per_nnz=SL.stored_per_nnz),
        row("jacobi_step", "jacobi_step.cu",
            "src/repro/kernels/jacobi_step.py:50", js_rows["path"],
            forms=js_rows),
        # the round instance: Horner's last step fused with the update
        row("jacobi_round", "jacobi_step.cu",
            "src/repro/kernels/jacobi_step.py:50", round_row,
            fuses="src/repro/kernels/bcsr_spmv.py:106", batch=BATCH),
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
