"""Multi-pod dry-run: run the step of every (arch x shape) cell once on
the production mesh, on meta tensors, and count per rank what it runs
(the JAX package's `launch/dryrun.py`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
      --shape train_4k [--multipod] [--scheme default] [--out out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod]

The JAX dry-run compiles the step for 512 forced host devices and reads
the compiler's cost, memory and collective analyses.  The port has no
compiler: `run_cell` makes a ``fake`` process group of 256 (512) ranks
in this one process (``FakeStore``: no peer, no card, collectives that
move nothing), lays the parameters, the AdamW state and the batch or
cache out as meta DTensors of this rank's shards (`params.param_pspecs`,
`decode.cache_pspecs` and `inputs.batch_pspecs` after `_fit`), and runs
the train step, the prefill forward or the serve step once under
`roofline.OpCounter`: the FLOPs, bytes and collectives of rank 0, each
counted once.  The layers are a Python loop, so every layer is counted
(the JAX package's `_layer_cost` patches up a scan body XLA counts once;
``layer_costs`` stays empty).

Memory (no compiler memory analysis): ``memory`` holds this rank's bytes
of the step's resident inputs (the parameters, for a train step the
AdamW moments (f32), for decode the cache, and the batch) and
``peak_bytes``, the peak of torch's `MemTracker` over the step: the
storages it sees live at once on the meta device (activations, saved
tensors, gradients and temporaries, the inputs the step touches
included).  ``total_hbm_bytes`` is the larger of the two, and
``fits_hbm_80g`` checks it against the H100's 80 GB.
``lower_s`` is the time to build the mesh, the step and its inputs,
``compile_s`` the counted run.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch
from torch.distributed._tools.mem_tracker import MemTracker

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..dist import sharding
from ..dist.sharding import PartitionSpec as P
from ..dist.sharding import make_rules, mesh_axes
from ..models import decode as dec
from ..models import params as mparams
from ..models.model import RunConfig, forward
from ..models.steps import build_serve_step, build_train_step
from ..optim.adamw import adamw_init
from ..tree import leaves
from . import inputs as inp
from .mesh import make_production_mesh
from .roofline import OpCounter, Roofline, collective_stats, model_flops

#: HBM per H100 (bytes) that `fits_hbm_80g` checks against.
HBM_BYTES = 80e9


@contextlib.contextmanager
def _fake_group(world: int):
    """A ``fake`` default group of `world` ranks (this process is rank 0)
    for the duration; an existing fake group of that size is used as it
    is, and a group this call made is destroyed after it."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"the dry-run needs a fake group of {world} ranks; this "
                f"process has a {dist.get_backend()} group of "
                f"{dist.get_world_size()}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        with _meta_topology():
            yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _meta_topology():
    """DTensor's redistribution cost model asks the mesh's device module
    for its devices per host, and torch has no module for "meta": answer
    1, as the CPU's does (the same plans as a CPU mesh, whose shard-to-
    shard moves would all-gather where the card runs an all-to-all)."""
    from unittest import mock

    from torch.distributed import device_mesh

    env = getattr(device_mesh, "_mesh_resources", None)
    orig = getattr(env, "num_devices_per_host", None)
    if orig is None:
        yield
        return
    with mock.patch.object(env, "num_devices_per_host",
                           lambda dt: 1 if dt == "meta" else orig(dt)):
        yield


def _sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a duck-typed mesh with
    ``axis_names`` / ``axis_sizes``."""
    sizes = getattr(mesh, "axis_sizes", None)
    if sizes is None:
        sizes = tuple(mesh.shape)
    return dict(zip(mesh_axes(mesh), sizes))


def _fit_one(shape, spec: P, mesh) -> P:
    """Trim a PartitionSpec so every dim divides evenly (the JAX jit
    rejects uneven input shardings; DTensor would take them, but the
    record names the JAX package's layout and counts it): drop trailing
    mesh axes per dim until divisible.  `shape`: a tensor or a shape."""
    sizes = _sizes(mesh)
    dims = tuple(shape.shape) if hasattr(shape, "shape") else tuple(shape)
    entries = list(spec) + [None] * (len(dims) - len(spec))
    out = []
    for d, e in zip(dims, entries[:len(dims)]):
        if e is None:
            out.append(None)
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        while axes:
            total = 1
            for a in axes:
                total *= sizes[a]
            if d % total == 0:
                break
            axes = axes[:-1]
        out.append(axes[0] if len(axes) == 1 else (tuple(axes) if axes
                                                    else None))
    return P(*out)


def _zip(fn, shapes, specs):
    """fn(tensor, spec) leaf by leaf over a tree of tensors (dicts, tuples
    and named tuples) and the tree of specs of the same structure."""
    if isinstance(shapes, torch.Tensor):
        return fn(shapes, specs)
    if isinstance(shapes, dict):
        return {k: _zip(fn, v, specs[k]) for k, v in shapes.items()}
    vals = [_zip(fn, s, p) for s, p in zip(shapes, specs)]
    return type(shapes)(*vals) if hasattr(shapes, "_fields") else tuple(vals)


def _fit(shapes, specs, mesh):
    """Apply _fit_one leaf by leaf (a PartitionSpec per tensor)."""
    return _zip(lambda t, p: _fit_one(t, p, mesh), shapes, specs)


def _lay_out(shapes, specs, mesh):
    """The meta tensors of `shapes` as meta DTensors laid out by `specs`."""
    return _zip(lambda t, p: sharding.distribute(t, mesh, p), shapes, specs)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in `tree`."""
    out = 0
    for t in leaves(tree):
        if sharding.is_dtensor(t):
            t = t.to_local()
        out += t.numel() * t.element_size()
    return out


def _rules(mesh, scheme: str = "default"):
    """`scheme`'s rules bound to `mesh` (not `make_rules(mesh)`: its cache
    would hand back the rules of an earlier cell's equal mesh, whose group
    is destroyed)."""
    return dataclasses.replace(make_rules(None, scheme), mesh=mesh)


def _default_run(scheme: str) -> RunConfig:
    return RunConfig(attn_impl="chunked", attn_chunk=512, remat="dots",
                     scheme=scheme)


def count_step(fn, *args):
    """(fn(*args), OpCounter) with `fn` run once under the counter: what
    this rank runs, whatever its tensors are (meta DTensors here, real
    tensors on a card)."""
    with OpCounter() as counter:
        out = fn(*args)
    return out, counter


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    scheme: str = "default",
    run_cfg: Optional[RunConfig] = None,
    kv_dtype: Optional[str] = None,
    dump_collectives: int = 0,
) -> Dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256
    record: Dict = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": n_chips,
        "scheme": scheme,
    }
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        record.update({"status": "skipped", "reason": why})
        return record

    if run_cfg is None:
        run_cfg = _default_run(scheme)
    prefill_last_only = getattr(run_cfg, "_prefill_last_only", False)
    run = dataclasses.replace(
        run_cfg,
        unroll_layers=(shape.kind != "train"),
        attn_chunk=(max(run_cfg.attn_chunk, shape.seq_len // 8)
                    if shape.kind == "prefill" else run_cfg.attn_chunk),
        # dispatch groups can't exceed the batch's shardable width (the
        # JAX package's rule)
        moe_groups=max(1, min(run_cfg.moe_groups, shape.global_batch)),
    )
    kvdt = {"f8": torch.float8_e4m3fn, None: None, "model": None}[kv_dtype]

    t0 = time.time()
    with _fake_group(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = _rules(mesh, scheme)
        pshapes = mparams.param_shapes(cfg)
        pspecs = _fit(pshapes, mparams.param_pspecs(cfg, rules), mesh)
        params = _lay_out(pshapes, pspecs, mesh)
        mem = {"param_bytes": _local_bytes(params)}
        if shape.kind == "train":
            step = build_train_step(cfg, run, rules=rules)
            bshapes = inp.batch_specs(cfg, shape)
            bspecs = _fit(bshapes, inp.batch_pspecs(cfg, rules), mesh)
            batch = _lay_out(bshapes, bspecs, mesh)
            opt = adamw_init(params)
            args = (params, opt, batch)
            mem.update(opt_bytes=_local_bytes((opt.m, opt.v)),
                       batch_bytes=_local_bytes(batch))
            grad_mode = contextlib.nullcontext()
        elif shape.kind == "prefill":
            def step(params, batch):
                logits = forward(
                    cfg, params, batch["tokens"], run,
                    vision_embeds=batch.get("vision_embeds"),
                    encoder_frames=batch.get("encoder_frames"), rules=rules)
                if prefill_last_only:
                    return logits[:, -1:]
                return logits
            bshapes = {k: v for k, v in inp.batch_specs(cfg, shape).items()
                       if k != "labels"}
            bspecs = {k: v for k, v in inp.batch_pspecs(cfg, rules).items()
                      if k != "labels"}
            bspecs = _fit(bshapes, bspecs, mesh)
            batch = _lay_out(bshapes, bspecs, mesh)
            args = (params, batch)
            mem["batch_bytes"] = _local_bytes(batch)
            grad_mode = torch.no_grad()
        else:  # decode
            step = build_serve_step(cfg, run, rules=rules)
            cshapes, tshape = inp.decode_specs(cfg, shape, kvdt)
            cspecs = _fit(cshapes, dec.cache_pspecs(cfg, rules), mesh)
            tspec = _fit_one(tshape, rules.spec("batch", None), mesh)
            cache = _lay_out(cshapes, cspecs, mesh)
            tokens = _lay_out(tshape, tspec, mesh)
            args = (params, cache, tokens)
            mem.update(cache_bytes=_local_bytes(cache),
                       batch_bytes=_local_bytes(tokens))
            grad_mode = torch.no_grad()
        arg_bytes = _local_bytes(args)
        t_lower = time.time() - t0
        tracker = MemTracker()
        with grad_mode, tracker:
            out, counter = count_step(step, *args)
        out_bytes = _local_bytes(out)
        t_compile = time.time() - t0 - t_lower
        mem["peak_bytes"] = tracker.get_tracker_snapshot("peak")[
            torch.device("meta")]["Total"]

    mem["total_hbm_bytes"] = max(mem["peak_bytes"],
                                 sum(v for k, v in mem.items()
                                     if k != "peak_bytes"))
    coll = collective_stats(counter.records, top_k=dump_collectives)
    rf = Roofline(
        flops_per_device=counter.flops,
        bytes_per_device=counter.bytes,
        collective_bytes_per_device=coll["collective_bytes_per_device"],
        struct_bytes_per_device=float(arg_bytes + out_bytes),
    )
    mf = model_flops(cfg, shape, n_chips)
    flops_global = counter.flops * n_chips
    record["collective_s_bf16_corrected"] = rf.collective_s
    record.update({
        "status": "ok",
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": mem,
        "cost": {"flops": counter.flops, "bytes accessed": counter.bytes},
        "collectives": coll,
        "layer_costs": {},
        "roofline": rf.to_dict(),
        "model_flops": mf,
        "fits_hbm_80g": mem["total_hbm_bytes"] <= HBM_BYTES,
        "useful_flops_ratio": (
            mf["model_flops"] / flops_global if flops_global else None
        ),
    })
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--scheme", default="default")
    ap.add_argument("--kv-dtype", choices=["model", "f8"], default=None)
    ap.add_argument("--attn-impl", default="chunked")
    ap.add_argument("--attn-chunk", type=int, default=512)
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--moe-capacity", type=float, default=None)
    ap.add_argument("--moe-dispatch", choices=["global_sort", "grouped"],
                    default="global_sort")
    ap.add_argument("--moe-groups", type=int, default=None)
    ap.add_argument("--attn-remat", action="store_true")
    ap.add_argument("--no-qkv-constraints", action="store_true")
    ap.add_argument("--dump-collectives", type=int, default=0,
                    help="record the top-N largest collectives per cell")
    ap.add_argument("--no-unroll", action="store_true",
                    help="recorded in the run config; the port's layer "
                         "loop is Python either way")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    # dispatch groups = number of DP shards of the token stream
    if args.moe_groups:
        groups = args.moe_groups
    elif args.scheme in ("fsdp", "fsdp_noep"):
        groups = 512 if args.multipod else 256
    else:
        groups = 32 if args.multipod else 16
    run = RunConfig(attn_impl=args.attn_impl, attn_chunk=args.attn_chunk,
                    remat=args.remat, scheme=args.scheme,
                    moe_capacity_factor=args.moe_capacity,
                    moe_dispatch=args.moe_dispatch,
                    moe_groups=groups,
                    attn_remat=args.attn_remat,
                    qkv_constraints=not args.no_qkv_constraints,
                    unroll_layers=not args.no_unroll)
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    records = []
    for arch, shape in cells:
        try:
            rec = run_cell(arch, shape, multi_pod=args.multipod,
                           scheme=args.scheme, run_cfg=run,
                           kv_dtype=args.kv_dtype,
                           dump_collectives=args.dump_collectives)
        except Exception as e:  # noqa: BLE001 — record the failure, keep going
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        records.append(rec)
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f"dom={r['dominant']} comp={r['compute_s']:.4f}s "
                     f"mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
                     f"compile={rec['compile_s']:.0f}s")
        elif status == "skipped":
            extra = rec["reason"][:60]
        else:
            extra = rec["error"][:120]
        print(f"[dryrun] {arch} x {shape} ({rec.get('mesh', '')}): "
              f"{status} {extra}", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    bad = [r for r in records if r["status"] == "error"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
