"""Roofline terms of a dry-run cell on the H100 (the JAX package's
`launch/roofline.py`).

Terms, per rank:
    compute    = FLOPs / PEAK_FLOPS (989e12, bf16 dense tensor cores)
    memory     = bytes / HBM_BW (3.35e12 B/s HBM3)
    collective = collective bytes / LINK_BW (450e9 B/s: NVLink 4, one
                 direction)

The H100 SXM's data-sheet rates.  The collective term divides by one
direction of a GPU's 900 GB/s NVLink 4 (18 links of 25 GB/s each way):
a ring collective sends and receives the same bytes at once over
full-duplex links, so the bytes a rank sends set its time.  That assumes
every rank of the mesh is an NVLink hop away (the NVLink Switch System
joins up to 256 H100s); between nodes over 400 Gb/s InfiniBand (50 GB/s
a GPU) the term would be 9x longer.

The JAX package reads these counts from the compiled HLO (cost_analysis
and a scan of its text).  The port has no compiler: `OpCounter`, a
dispatch mode around one run of the step on meta tensors (or real ones),
counts what each rank runs.  Under a DeviceMesh it lets DTensor lower
each op to its local ops and collectives first, and counts those: each
rank's work once, in its local shapes (the mode sees a DTensor op before
DTensor runs it; counting there would add the global op, and DTensor's
sharding propagation runs each new op once on global-shaped fake
tensors, which are skipped too).  FLOPs come from
`torch.utils.flop_counter`'s formulas (matmuls, attention,
convolutions; elementwise ops count none, as XLA's flops barely do);
bytes are every non-view op's tensor operands and results (an unfused
op's traffic, as XLA:CPU's "bytes accessed").

Collective bytes: for every all-gather / all-reduce / reduce-scatter /
all-to-all / send (collective-permute) the *result* bytes count once,
except all-reduce which counts twice (ring reduce-scatter + all-gather);
the (g-1)/g factor is ignored, as in the JAX package.  DTensor keeps a
bf16 all-reduce in bf16 (XLA:CPU widens it to f32, which the JAX package
corrects for), so ``collective_bytes_bf16_corrected`` equals the total.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12     # bf16 dense FLOP/s per H100 SXM
HBM_BW = 3.35e12        # B/s per H100 SXM (HBM3)
LINK_BW = 450e9         # B/s per H100 SXM, NVLink 4, one direction

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

#: The HLO name of each torch dtype (the keys of _DTYPE_BYTES).
_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def _collective_ops() -> Dict:
    """{op overload packet: collective name} of the collectives the
    counter records: functional ones (what DTensor emits) and c10d's."""
    ops = torch.ops
    names = {
        "all-reduce": ["_c10d_functional.all_reduce",
                       "c10d_functional.all_reduce", "c10d.allreduce_"],
        "all-gather": ["_c10d_functional.all_gather_into_tensor",
                       "c10d_functional.all_gather_into_tensor",
                       "c10d.allgather_", "c10d._allgather_base_"],
        "reduce-scatter": ["_c10d_functional.reduce_scatter_tensor",
                           "c10d_functional.reduce_scatter_tensor",
                           "c10d.reduce_scatter_",
                           "c10d._reduce_scatter_base_"],
        "all-to-all": ["_c10d_functional.all_to_all_single",
                       "c10d_functional.all_to_all_single",
                       "_dtensor.shard_dim_alltoall", "c10d.alltoall_",
                       "c10d.alltoall_base_"],
        "collective-permute": ["c10d.send"],
    }
    out = {}
    for coll, qualnames in names.items():
        for q in qualnames:
            ns, op = q.split(".")
            try:
                out[getattr(getattr(ops, ns), op)] = coll
            except (AttributeError, RuntimeError):
                pass            # not in this torch
    return out


def _tensors(x) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _type_str(x) -> str:
    """HLO-style type of a tensor or of several: ``f32[16,4096]``,
    ``(bf16[8,2], f32[4])``."""
    ts = [_DTYPE_NAMES.get(t.dtype, str(t.dtype)) + "[" +
          ",".join(map(str, t.shape)) + "]" for t in _tensors(x)]
    return ts[0] if len(ts) == 1 else "(" + ", ".join(ts) + ")"


def _type_bytes(x) -> int:
    """Bytes of a tensor, or of a tuple / list of them (a result's type)."""
    return sum(t.numel() * _DTYPE_BYTES[_DTYPE_NAMES[t.dtype]]
               for t in _tensors(x))


def _is_view(func) -> bool:
    """An op that returns an alias of an input and writes nothing."""
    schema = func._schema
    return (not schema.is_mutable
            and any(r.alias_info is not None for r in schema.returns))


class OpCounter(TorchDispatchMode):
    """Counts what this rank runs while it is active (``with
    OpCounter() as c: step(...)``): `flops` (and `flops_by_op`), `bytes`
    and `records`, one (collective, bytes, type) per collective call.
    See the module docstring for what each counts."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self._colls = _collective_ops()
        self.flops = 0.0
        self.flops_by_op: Dict[str, float] = {}
        self.bytes = 0.0
        self.records: List[Tuple[str, int, str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count DTensor's local ops instead
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins):
            return out                  # sharding propagation's shape run
        packet = func._overloadpacket
        if packet in self._flops:
            f = float(self._flops[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[str(func)] = self.flops_by_op.get(str(func),
                                                               0.0) + f
        if not _is_view(func):
            self.bytes += float(_type_bytes(ins) + _type_bytes(out))
        coll = self._colls.get(packet)
        if coll is not None:
            res = out if coll != "collective-permute" else ins
            self.records.append((coll, _type_bytes(res), _type_str(res)))
        return out


def collective_stats(records: Iterable[Tuple[str, int, str]],
                     top_k: int = 0) -> Dict:
    """Per-rank collective traffic of `OpCounter.records` (the JAX
    package's dict, parsed there from the HLO text).  top_k > 0 also
    returns the largest single collectives (op, bytes, result type)."""
    bytes_by_op: Dict[str, int] = {op: 0 for op in _COLLECTIVES}
    count_by_op: Dict[str, int] = {op: 0 for op in _COLLECTIVES}
    items = []
    for op, b, type_str in records:
        mult = 2 if op == "all-reduce" else 1
        bytes_by_op[op] += b * mult
        count_by_op[op] += 1
        if top_k:
            items.append((b * mult, op, type_str[:90]))
    total = sum(bytes_by_op.values())
    out = {
        "collective_bytes_per_device": total,
        # DTensor does not widen bf16 all-reduces: nothing to correct
        "collective_bytes_bf16_corrected": total,
        "bytes_by_op": bytes_by_op,
        "count_by_op": count_by_op,
    }
    if top_k:
        items.sort(reverse=True)
        out["top_collectives"] = [
            {"bytes": b, "op": op, "type": t} for b, op, t in items[:top_k]
        ]
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    # Structural HBM-traffic estimate: the step's tensor arguments read
    # once and its results written once (no compiler memory analysis on
    # meta tensors, so no temporaries); the counted bytes, every unfused
    # op's operands, overstate a fused step's traffic.
    struct_bytes_per_device: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def memory_struct_s(self) -> Optional[float]:
        if self.struct_bytes_per_device is None:
            return None
        return self.struct_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound assuming perfect overlap: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """Roofline fraction: useful-compute share of the bound step time.
        1.0 = compute-bound at peak."""
        t = self.step_time_s
        return self.compute_s / t if t > 0 else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "struct_bytes_per_device": self.struct_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_struct_s": self.memory_struct_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "compute_fraction": self.compute_fraction,
        }


def model_flops(cfg, shape, n_chips: int) -> Dict:
    """MODEL_FLOPS = 6 N D (train) or 2 N D (inference), N = active params."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mf = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mf = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mf = 2.0 * n_active * tokens
    return {"model_flops": mf, "model_flops_per_device": mf / n_chips,
            "tokens": tokens, "active_params": n_active}
