"""The LM trainer: config-driven, checkpointed, fault-tolerant.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --smoke --steps 50 --ckpt-dir /tmp/run1 [--resume] \
        [--fail-at-step 30] [--dp-mode none|pjit|gossip] [--mesh DxM] \
        [--gossip-quantize] [--device cpu]

The JAX package's `launch/train.py` on the port, with its flags and log
lines:

* checkpoints are atomic (tmp + rename) and in the JAX package's layout
  (`repro_torch.ckpt`); `--resume` restarts from the latest one, on any
  device;
* ``--fail-at-step N`` exits with code 42 at step N, once the save in
  flight is written; re-launching with ``--resume`` reproduces the same
  loss curve (the data is a function of (seed, step):
  `data.SyntheticLMData`);
* ``--mesh DxM`` runs D * M ranks on a ("data", "model") DeviceMesh
  (`launch.mesh.make_test_mesh`): gloo ranks spawned here on the CPU, or
  NCCL with rank r on card r (one rank runs in this process).  With
  ``--dp-mode pjit`` or ``none`` each rank lays the parameters out by
  `param_pspecs` (the scheme of `RunConfig.scheme`) and each batch by
  ``("batch", "seq")``, and runs the sharded step
  (`build_train_step(..., rules=rules)`), as the JAX launcher's jit;
* ``--dp-mode gossip --mesh DxM`` keeps the parameters replicated: each
  rank takes its data row's slice of the global batch, and the gradients
  and the loss are averaged by the paper's Algorithm 1 on the ring of the
  mesh's ``data`` group (`dist.gossip`; on a card its recurrence runs the
  `cheb_step` kernel) instead of an all-reduce, as the JAX launcher's
  shard_map; its ranks are gloo ranks (all on ``cuda:0`` of a one-card
  machine).  ``--gossip-quantize`` sends int8 messages.

Rank 0 prints; a checkpoint of a sharded run is gathered by every rank
and written by rank 0, and restores under any mesh (or none).

``--arch`` takes every preset of `repro_torch.configs.ARCH_IDS`; the
batches carry whisper's encoder frames and the VLM's vision embeddings
(`data.SyntheticLMData`).  Parameters are drawn from a seeded
torch.Generator on the device (the card unless ``--device cpu``).  The attention is the plain reference
(``attn_impl="ref"``), as the JAX trainer's: the flash kernels have no
backward.  ``--dp-mode pjit`` without ``--mesh`` is the plain step.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.multiprocessing import ProcessExitedException

from ..ckpt import (latest_checkpoint, load_checkpoint, restore_arrays,
                    save_checkpoint)
from ..ckpt.checkpoint import wait_pending
from ..configs import get_config
from ..data import SyntheticLMData
from ..dist import gossip
from ..dist.backends import resolve_device
from ..dist.sharding import ShardingRules, make_rules
from ..examples import spawn
from ..models import params as mparams
from ..models.model import RunConfig
from ..models.steps import (build_loss_fn, build_train_step,
                            distribute_batch, loss_and_grads)
from ..optim.adamw import adamw_init, adamw_update, clip_scale, global_norm
from ..tree import tree_map
from .mesh import make_test_mesh

#: The exit code of an injected failure.
FAILURE_EXIT = 42


def _widen(g):
    """A narrow float gradient (bf16) as float32: the consensus recurrence
    (`cheb_step`) runs in float32 or float64."""
    return g if g.dtype in (torch.float32, torch.float64) else g.float()


def build_gossip_train_step(cfg, run, group, lr, K: Optional[int] = None,
                            quantize: bool = False):
    """The data-parallel step of one rank of `group`: its gradients and
    loss on its slice of the batch, averaged over the rank ring by
    Chebyshev gossip (the paper's Algorithm 1, `dist.gossip`; K rounds
    per leaf, default ceil(n/2): exact consensus), then the clip at 1.0
    and AdamW, as the JAX package's shard_map step.  `quantize` sends
    int8 messages (approximate consensus).  Every rank of `group` calls
    it together, step by step."""
    loss_fn = build_loss_fn(cfg, run)
    n = 1 if group is None else dist.get_world_size(group)
    coeffs = gossip.consensus_coeffs(n, K)

    def step(params: Dict, opt_state, batch: Dict):
        loss, grads = loss_and_grads(loss_fn, params, batch)
        grads = gossip.gossip_mean_tree(tree_map(_widen, grads), group, coeffs,
                                        quantize=quantize)
        loss = gossip.gossip_mean(loss, group, coeffs)
        gnorm = global_norm(grads)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr,
                                         grad_scale=clip_scale(gnorm, 1.0))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "step": opt_state.step}

    return step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a failure (fault-tolerance test)")
    ap.add_argument("--dp-mode", choices=["none", "pjit", "gossip"],
                    default="none")
    ap.add_argument("--gossip-quantize", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DxM (data x model) mesh: D * M ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    return ap.parse_args(argv)


def mesh_shape(args: argparse.Namespace) -> Optional[Tuple[int, int]]:
    """(D, M) of ``--mesh DxM``, or None; raises ValueError for what the
    launcher cannot run."""
    if args.mesh is None:
        if args.dp_mode == "gossip":
            raise ValueError("--dp-mode gossip needs --mesh DxM")
        return None
    dims = args.mesh.split("x")
    if len(dims) != 2 or not all(v.isdigit() and int(v) > 0 for v in dims):
        raise ValueError(f"--mesh {args.mesh}: expected DxM, two positive "
                         "integers")
    d, m = (int(v) for v in dims)
    if args.dp_mode == "gossip" and args.batch % d:
        raise ValueError(f"--batch {args.batch} does not split over the "
                         f"{d} ranks of the mesh's data axis")
    return d, m


def run(args: argparse.Namespace) -> Dict:
    """The training loop of this process, or of one rank of the mesh
    ``--mesh`` asks for (the default group holds its ranks): the sharded
    step, or the gossip step on this rank's slice of each batch.  Returns
    its record: the losses by step and each step's seconds (host clock;
    the loss read waits for the device)."""
    shape = mesh_shape(args)
    rank = dist.get_rank() if shape else 0
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    run_cfg = RunConfig(attn_impl="ref")
    mesh = make_test_mesh(shape) if shape else None
    gossiping = args.dp_mode == "gossip"
    rules = (make_rules(mesh, run_cfg.scheme) if mesh and not gossiping
             else ShardingRules.null())

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = mparams.init_params(cfg, gen, device=dev)
    if rules.mesh is not None:
        params = mparams.distribute_params(
            params, mparams.param_pspecs(cfg, rules), mesh)
    opt_state = adamw_init(params)
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        n_vision_tokens=cfg.n_vision_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model,
        encoder_seq=cfg.encoder_seq,
    )
    start_step = 0

    if args.resume and args.ckpt_dir:
        path = latest_checkpoint(args.ckpt_dir)
        if path:
            step_saved, trees, _ = load_checkpoint(path)
            params = restore_arrays(trees["params"], params)
            opt_state = restore_arrays(trees["opt_state"], opt_state)
            start_step = step_saved
            if rank == 0:
                print(f"[train] resumed from {path} at step {start_step}",
                      flush=True)

    rows = slice(None)
    if gossiping:
        group = mesh.get_group("data")
        d, r = shape[0], mesh.get_local_rank("data")
        rows = slice(r * args.batch // d, (r + 1) * args.batch // d)
        step_fn = build_gossip_train_step(cfg, run_cfg, group, args.lr,
                                          quantize=args.gossip_quantize)
    else:
        step_fn = build_train_step(cfg, run_cfg, lr=args.lr, rules=rules)
    # a sharded state is gathered by every rank; a replicated one saved
    # by rank 0
    saves = rank == 0 or rules.mesh is not None

    losses, step_s = {}, []
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            if args.fail_at_step is not None and step == args.fail_at_step:
                if rank == 0:
                    print(f"[train] INJECTED FAILURE at step {step}",
                          flush=True)
                raise SystemExit(FAILURE_EXIT)
            t_step = time.time()
            batch = distribute_batch(
                {k: torch.from_numpy(v[rows]).to(dev)
                 for k, v in data.batch_at(step).items()}, rules)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            step_s.append(time.time() - t_step)
            losses[step] = loss
            if rank == 0 and (step % args.log_every == 0
                              or step == args.steps - 1):
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"({(time.time()-t0):.1f}s)", flush=True)
            if saves and args.ckpt_dir and \
                    (step + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, step + 1,
                                {"params": params, "opt_state": opt_state},
                                async_save=True)
    finally:
        # however the loop ends, a save in flight is finished first: an
        # interpreter that exits while the daemon writer is inside native
        # code can abort (SIGABRT) instead of exiting with its code
        wait_pending()
    if saves and args.ckpt_dir and args.steps % args.ckpt_every != 0:
        save_checkpoint(args.ckpt_dir, args.steps,
                        {"params": params, "opt_state": opt_state})
    first, last = losses[start_step], losses[args.steps - 1]
    if rank == 0:
        print(f"[train] done: first loss {first:.4f} last {last:.4f}",
              flush=True)
    return {"losses": losses, "step_s": step_s}


def _one_rank(args: argparse.Namespace, backend: str) -> Dict:
    """`run(args)` as the only rank of a default group in this process."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            return run(args)
        finally:
            dist.destroy_process_group()


def train(args: argparse.Namespace) -> Dict:
    """Run `args`: in this process, or on the D * M ranks of ``--mesh``
    (spawned here; one in this process); returns the record of this
    process or of rank 0.  An injected failure exits with code 42 either
    way."""
    shape = mesh_shape(args)
    if shape is None:
        return run(args)
    n = shape[0] * shape[1]
    on_cards = resolve_device(args.device).type == "cuda"
    backend = "nccl" if on_cards and args.dp_mode != "gossip" else "gloo"
    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"--mesh {args.mesh} needs {n} cards, one per NCCL "
                         f"rank; there are {torch.cuda.device_count()}")
    if n == 1:
        return _one_rank(args, backend)
    try:
        return spawn(run, n, args, backend=backend)
    except ProcessExitedException as e:
        if e.exit_code == FAILURE_EXIT:
            raise SystemExit(FAILURE_EXIT) from None
        raise


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
