"""The port's dry-run (`repro_torch.launch.{dryrun,roofline,inputs}` and
`mesh.make_production_mesh`) against the JAX package's.

In process: the JAX roofline unit cases (tests/test_sharding_rules.py)
as port cases at the H100 rates; `model_flops` for every preset x shape;
the meta inputs against the JAX ShapeDtypeStructs for every applicable
cell (the f8 cache too); the skipped cells with the JAX reason
(`repro.configs.shape_applicable`, what the JAX `run_cell` reads).

`repro.launch.dryrun` forces 512 host devices when it is imported, so
the JAX records come from one subprocess (`tests/_subproc.py`'s
environment), started once for the module and run beside the port's
cells: `run_cell` of rwkv6-1.6b x long_500k and starcoder2-3b x
train_4k, their fitted parameter specs and the production meshes.

The counts: one sharded product (the (256, 4096, 3072) @ (3072, 12288)
of a 16x16 mesh) counts each rank's FLOPs once; the counted FLOPs of a
reduced preset grow by the same amount per layer (no `_layer_cost`
patch-up); a 1x1 mesh counts what the unsharded step counts.  The cells
run at full width on meta tensors (the 16x16 mesh of a fake group):
starcoder2-3b's train_4k, prefill_32k and decode_32k and rwkv6-1.6b's
long_500k.  Their attention FLOPs equal the closed form, and their
counted FLOPs sit within the factor of `model_flops_per_device` that
`FACTORS` states, with its reason.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.dist.sharding import PartitionSpec as P
from repro_torch.launch import dryrun, inputs, roofline
from repro_torch.launch.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                         Roofline, _type_bytes,
                                         collective_stats, model_flops)

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
APPLICABLE = [c for c in CELLS if shape_applicable(get_config(c[0]),
                                                   SHAPES[c[1]])[0]]
SKIPPED = [c for c in CELLS if c not in APPLICABLE]

#: The cells the JAX subprocess runs.
JAX_CELLS = [("rwkv6-1.6b", "long_500k"), ("starcoder2-3b", "train_4k")]
#: The cells the port runs at full width, one per kind.
PORT_CELLS = [("starcoder2-3b", "train_4k"), ("starcoder2-3b", "prefill_32k"),
              ("starcoder2-3b", "decode_32k"), ("rwkv6-1.6b", "long_500k")]

#: (lowest, highest) counted FLOPs per rank over `model_flops_per_device`
#: of each full-width cell, and why.  6ND (2ND) counts each parameter's
#: products once over all 256 ranks, and no attention.  The counts add:
#: attention's S^2 (S x cache) products, which 6ND leaves out; dots
#: remat's recompute of the attention products; work repeated on the
#: ranks of a mesh axis that cannot cut it (24 heads, or a batch of 1,
#: over 16; DTensor's gathered FFN weights in the train step).
FACTORS = {
    # attention 3.958e14 (fwd, recompute, 2x bwd) + products 5.9x 6ND/256
    ("starcoder2-3b", "train_4k"): (8.0, 14.0),
    # attention over 32768 keys per query, 2 of the batch per rank
    ("starcoder2-3b", "prefill_32k"): (25.0, 45.0),
    # attention over the 32768-slot cache with all 24 heads on every rank
    ("starcoder2-3b", "decode_32k"): (25.0, 40.0),
    # a batch of 1 cannot shard over "data" (16x) and the wkv state
    # products per head
    ("rwkv6-1.6b", "long_500k"): (16.0, 30.0),
}

#: The JAX dry-run's records, fitted parameter specs and meshes.
_JAX = r"""
import json, sys
from repro.configs import get_config
from repro.dist.sharding import make_rules
from repro.launch.dryrun import _fit, run_cell
from repro.launch.mesh import make_production_mesh
from repro.models import params as mparams

cells = json.loads(sys.argv[1])
out = {"records": [], "specs": [], "meshes": []}
for arch, shape in cells:
    out["records"].append(run_cell(arch, shape))
    mesh = make_production_mesh()
    cfg = get_config(arch)
    fitted = _fit(mparams.param_shapes(cfg),
                  mparams.param_pspecs(cfg, make_rules(mesh)), mesh)
    flat = {}
    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + [k])
            else:
                flat["/".join(pre + [k])] = [list(e) if isinstance(e, tuple)
                                             else e for e in v]
    walk(fitted, [])
    out["specs"].append(flat)
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    out["meshes"].append([list(m.axis_names), list(m.devices.shape)])
print("JSON" + json.dumps(out, default=str))
"""


class FakeMesh:
    """Duck-typed mesh: `_fit_one` only needs axis_names / axis_sizes."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.axis_sizes = tuple(sizes.values())


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


# ---------------------------------------------------------------------------
# roofline: the JAX unit cases at the H100 rates
# ---------------------------------------------------------------------------
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_type_bytes():
    assert _type_bytes(_meta((16, 4096), torch.float32)) == 16 * 4096 * 4
    assert _type_bytes((_meta((8, 2), torch.bfloat16),
                        _meta((4,), torch.float32))) == 8 * 2 * 2 + 4 * 4
    assert _type_bytes(_meta((10,), torch.float8_e4m3fn)) == 10
    assert _type_bytes(_meta((), torch.bool)) == 1


def test_collective_stats_on_a_hand_built_sequence():
    records = [("all-reduce", 16 * 1024 * 4, "f32[16,1024]"),
               ("all-gather", 4 * 512 * 2, "bf16[4,512]"),
               ("collective-permute", 8 * 4, "f32[8]")]
    st = collective_stats(records, top_k=3)
    assert st["count_by_op"]["all-reduce"] == 1
    assert st["count_by_op"]["all-gather"] == 1
    assert st["count_by_op"]["collective-permute"] == 1
    ar_bytes = 16 * 1024 * 4 * 2  # x2 ring multiplier
    assert st["bytes_by_op"]["all-reduce"] == ar_bytes
    assert st["collective_bytes_per_device"] == ar_bytes + 4096 + 32
    # DTensor keeps bf16 all-reduces in bf16: nothing to correct
    assert st["collective_bytes_bf16_corrected"] == \
        st["collective_bytes_per_device"]
    assert st["top_collectives"][0]["op"] == "all-reduce"
    assert st["top_collectives"][0]["type"] == "f32[16,1024]"


def test_op_counter_records_dtensor_collectives():
    """On a 2x2 meta mesh of a fake group: a gather over "model" is one
    all-gather of the result's local bytes, a pending sum reduced over
    "data" one all-reduce, and an explicit all-reduce of a plain tensor
    another; no FLOPs."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import _mesh

    with dryrun._fake_group(4):
        mesh = _mesh((2, 2), ("data", "model"), "meta")
        x = DTensor.from_local(_meta((4, 3), torch.float32), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        y = DTensor.from_local(_meta((8, 3), torch.bfloat16), mesh,
                               [Partial(), Replicate()], run_check=False)
        with roofline.OpCounter() as c:
            x.redistribute(mesh, [Replicate(), Replicate()])
            y.redistribute(mesh, [Replicate(), Replicate()])
            dist.all_reduce(_meta((5,), torch.float32))
    assert [(op, b) for op, b, _ in c.records] == [
        ("all-gather", 8 * 3 * 4), ("all-reduce", 8 * 3 * 2),
        ("all-reduce", 5 * 4)]
    st = collective_stats(c.records)
    assert st["collective_bytes_per_device"] == 96 + 2 * (48 + 20)
    assert c.flops == 0


def test_roofline_terms_and_dominance():
    r = Roofline(flops_per_device=989e12, bytes_per_device=3.35e12 / 2,
                 collective_bytes_per_device=450e9 / 4)
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 0.5) < 1e-9
    assert abs(r.collective_s - 0.25) < 1e-9
    assert r.dominant == "compute"
    assert abs(r.compute_fraction - 1.0) < 1e-9
    assert r.memory_struct_s is None
    from repro.launch.roofline import Roofline as JRoofline

    assert sorted(r.to_dict()) == sorted(JRoofline(1.0, 1.0, 1.0).to_dict())


def test_fit_spec_trims_uneven_dims():
    mesh = FakeMesh({"data": 16, "model": 16})
    spec = dryrun._fit_one(_meta((1, 2048), torch.float32),
                           P("data", "model"), mesh)
    assert spec == P(None, "model")   # batch=1 can't shard
    spec = dryrun._fit_one(_meta((40,), torch.float32), P("model"), mesh)
    assert spec == P(None)            # 40 % 16 != 0
    spec = dryrun._fit_one(_meta((256, 64), torch.float32),
                           P(("data", "model"), None), mesh)
    assert spec == P(("data", "model"), None)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_jax(arch, shape):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.launch.roofline import model_flops as jmodel_flops

    for chips in (256, 512):
        assert model_flops(get_config(arch), SHAPES[shape], chips) == \
            jmodel_flops(jget_config(arch), JSHAPES[shape], chips)


# ---------------------------------------------------------------------------
# inputs, meshes, skipped cells
# ---------------------------------------------------------------------------
def _sds(t):
    return tuple(t.shape), str(t.dtype).split(".")[-1]


@pytest.mark.parametrize("arch,shape", APPLICABLE)
def test_inputs_match_jax(arch, shape):
    import jax.numpy as jnp

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.launch import inputs as jinputs

    cfg, jcfg = get_config(arch), jget_config(arch)
    sh, jsh = SHAPES[shape], JSHAPES[shape]
    if sh.is_decode:
        for kv, jkv in ((None, None), (torch.float8_e4m3fn,
                                       jnp.float8_e4m3fn)):
            got = inputs.input_specs(cfg, sh, kv)
            want = jinputs.input_specs(jcfg, jsh, jkv)
            assert {k: _sds(v) for k, v in got["cache"].items()} == \
                {k: (tuple(v.shape), str(v.dtype))
                 for k, v in want["cache"].items()}
            assert _sds(got["tokens"]) == (tuple(want["tokens"].shape),
                                           str(want["tokens"].dtype))
            assert all(t.is_meta for t in got["cache"].values())
    else:
        got = inputs.input_specs(cfg, sh)["batch"]
        want = jinputs.input_specs(jcfg, jsh)["batch"]
        assert {k: _sds(v) for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def test_batch_pspecs_match_jax():
    from repro.dist.sharding import ShardingRules as JRules
    from repro.dist.sharding import _BASE
    from repro.launch import inputs as jinputs
    from repro.configs import get_config as jget_config
    from repro_torch.dist.sharding import ShardingRules

    for arch in ARCH_IDS:
        got = inputs.batch_pspecs(
            get_config(arch), ShardingRules(dict(_BASE), FakeMesh(
                {"data": 16, "model": 16})))
        want = jinputs.batch_pspecs(jget_config(arch), JRules(
            dict(_BASE), FakeMesh({"data": 16, "model": 16})))
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch,shape", SKIPPED)
def test_inapplicable_cells_skip_with_the_jax_reason(arch, shape):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.configs import shape_applicable as jshape_applicable

    ok, why = jshape_applicable(jget_config(arch), JSHAPES[shape])
    assert not ok
    rec = dryrun.run_cell(arch, shape)
    assert rec == {"arch": arch, "shape": shape, "kind": SHAPES[shape].kind,
                   "mesh": "16x16", "chips": 256, "scheme": "default",
                   "status": "skipped", "reason": why}


# ---------------------------------------------------------------------------
# the JAX records and the port's cells at full width
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_dryrun():
    """The JAX subprocess, started before the port's cells run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.Popen([sys.executable, "-c", _JAX,
                             json.dumps(JAX_CELLS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    out = {}

    def result():
        if not out:
            try:
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                proc.kill()
            assert proc.returncode == 0, stderr[-3000:]
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("JSON")][-1]
            out.update(json.loads(line[4:]))
        return out

    yield result
    proc.kill()


@pytest.fixture(scope="module")
def port_cells(jax_dryrun, monkeypatch_module):
    """The port's record of each PORT_CELLS cell and its counter's FLOPs
    by op."""
    counters = []

    def keep(fn, *args):
        out, counter = count_step(fn, *args)
        counters.append(counter)
        return out, counter

    count_step = dryrun.count_step
    monkeypatch_module.setattr(dryrun, "count_step", keep)
    out = {}
    for cell in PORT_CELLS:
        rec = dryrun.run_cell(*cell)
        out[cell] = (rec, counters[-1].flops_by_op)
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("arch,shape", JAX_CELLS)
def test_record_keys_and_status_match_jax(jax_dryrun, port_cells, arch,
                                          shape):
    """The JAX record's keys (``fits_hbm_16g`` renamed ``fits_hbm_80g``),
    its nested keys, status and model FLOPs."""
    want = jax_dryrun()["records"][JAX_CELLS.index((arch, shape))]
    got = port_cells[(arch, shape)][0]
    assert want["status"] == got["status"] == "ok"
    assert set(got) - {"fits_hbm_80g"} == set(want) - {"fits_hbm_16g"}
    for k in ("roofline", "cost", "collectives"):
        assert set(got[k]) == set(want[k]), k
    assert got["model_flops"] == want["model_flops"]
    assert got["layer_costs"] == {}
    mem = got["memory"]
    assert mem["total_hbm_bytes"] >= max(mem["peak_bytes"],
                                         mem["param_bytes"])
    assert mem["peak_bytes"] > 0
    assert got["fits_hbm_80g"] == (mem["total_hbm_bytes"] <= 80e9)
    for k in ("arch", "shape", "kind", "mesh", "chips", "scheme"):
        assert got[k] == want[k]


@pytest.mark.parametrize("arch,shape", JAX_CELLS)
def test_fitted_param_specs_match_jax(jax_dryrun, arch, shape):
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import params as mparams

    cfg = get_config(arch)
    with dryrun._fake_group(256):
        mesh = make_production_mesh()
        fitted = dryrun._fit(mparams.param_shapes(cfg), mparams.param_pspecs(
            cfg, dryrun._rules(mesh)), mesh)
    got = {k: [list(e) if isinstance(e, tuple) else e for e in v]
           for k, v in _flat(fitted)}
    assert got == jax_dryrun()["specs"][JAX_CELLS.index((arch, shape))]


def test_make_production_mesh_matches_jax(jax_dryrun):
    from repro_torch.launch.mesh import make_production_mesh

    got = []
    for multi, world in ((False, 256), (True, 512)):
        with dryrun._fake_group(world):
            m = make_production_mesh(multi_pod=multi)
            got.append([list(m.mesh_dim_names), list(m.shape)])
            assert m.device_type == "meta"
    assert got == jax_dryrun()["meshes"]
    with dryrun._fake_group(8):
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            make_production_mesh()


def _attention_flops(cell):
    """The closed form of a cell's attention products per rank (every
    rank holds all heads: 24 does not divide by the model axis of 16):
    4 B S_q S_k H hd L per pass (q k^T and p v, 2 FLOPs a product); the
    train step runs 4 passes (forward, dots remat's recompute, 2 in the
    backward)."""
    arch, shape = cell
    cfg, sh = get_config(arch), SHAPES[shape]
    b = sh.global_batch // 16
    per = 4 * b * cfg.n_heads * cfg.hd * cfg.n_layers
    if sh.kind == "decode":
        return per * sh.seq_len
    return per * sh.seq_len ** 2 * (4 if sh.kind == "train" else 1)


@pytest.mark.parametrize("cell", PORT_CELLS, ids=[f"{a}-{s}"
                                                  for a, s in PORT_CELLS])
def test_full_width_cell_within_its_factor(port_cells, cell):
    rec, by_op = port_cells[cell]
    assert rec["status"] == "ok"
    mf = rec["model_flops"]["model_flops_per_device"]
    lo, hi = FACTORS[cell]
    assert lo <= rec["cost"]["flops"] / mf <= hi, rec["cost"]["flops"] / mf
    assert rec["roofline"]["flops_per_device"] == rec["cost"]["flops"]
    assert sum(by_op.values()) == rec["cost"]["flops"]
    if cell[0] == "starcoder2-3b":
        # the batched products are attention's, and (decode) a one-token
        # batch's projection that DTensor lowers to bmm: at most 2ND/256
        att = _attention_flops(cell)
        assert att <= by_op["aten.bmm.default"] <= att + mf
    assert rec["useful_flops_ratio"] == pytest.approx(
        rec["model_flops"]["model_flops"] / (rec["cost"]["flops"] * 256))


# ---------------------------------------------------------------------------
# counting: each rank once, every layer, a 1x1 mesh as no mesh
# ---------------------------------------------------------------------------
def test_sharded_product_counts_each_rank_once():
    """(256, 4096, 3072) @ (3072, 12288), [Shard(0), Replicate()] x
    [Replicate(), Shard(1)] on a 16x16 mesh: 3.092e11 FLOPs on a rank,
    where torch's FlopCounterMode counts the global product (7.9165e13;
    with the local one beside it on some torches, 7.9474e13)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_production_mesh

    with dryrun._fake_group(256):
        mesh = make_production_mesh()
        a = distribute_tensor(_meta((256, 4096, 3072), torch.bfloat16), mesh,
                              [Shard(0), Replicate()])
        b = distribute_tensor(_meta((3072, 12288), torch.bfloat16), mesh,
                              [Replicate(), Shard(1)])
        for _ in range(2):      # a new op, then DTensor's cached plan
            _, c = dryrun.count_step(torch.matmul, a, b)
            assert c.flops == 2 * 16 * 4096 * 3072 * 768 == 309237645312
            assert c.records == []
        with FlopCounterMode(display=False) as fc:
            a @ b
        assert fc.get_total_flops() >= 2 * 256 * 4096 * 3072 * 12288


def _meta_step_flops(cfg, rules=None, mesh=None):
    """FLOPs of one dry-run train step (remat dots, chunked attention) of
    `cfg` at B 4, S 32 on meta tensors, laid out by `rules` on `mesh`."""
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.models import params as mparams
    from repro_torch.models.steps import build_train_step
    from repro_torch.optim import adamw_init

    run = dryrun._default_run("default")
    shape = SHAPES["train_4k"].__class__("t", 32, 4, "train")
    params = mparams.param_shapes(cfg)
    batch = inputs.batch_specs(cfg, shape)
    if mesh is not None:
        params = dryrun._lay_out(params, dryrun._fit(
            params, mparams.param_pspecs(cfg, rules), mesh), mesh)
        batch = dryrun._lay_out(batch, dryrun._fit(
            batch, inputs.batch_pspecs(cfg, rules), mesh), mesh)
    step = build_train_step(cfg, run, rules=rules or ShardingRules.null())
    _, c = dryrun.count_step(step, params, adamw_init(params), batch)
    return c.flops


@pytest.mark.parametrize("arch", ["starcoder2-3b", "whisper-large-v3"])
def test_every_layer_is_counted(arch):
    """F(4 layers) - F(2 layers) = 2 x (F(3) - F(2)): each layer adds the
    same FLOPs, so the loop counts all of them (whisper: the encoder's
    layers too)."""
    import dataclasses

    base = get_config(arch).reduced()

    def flops(n):
        return _meta_step_flops(dataclasses.replace(
            base, n_layers=n, n_encoder_layers=n if base.n_encoder_layers
            else 0))

    f2, f3, f4 = flops(2), flops(3), flops(4)
    assert f3 > f2 > 0
    assert f4 - f2 == 2 * (f3 - f2)


def test_one_by_one_mesh_counts_the_unsharded_step():
    from repro_torch.launch.mesh import _mesh

    cfg = get_config("starcoder2-3b").reduced()
    plain = _meta_step_flops(cfg)
    with dryrun._fake_group(1):
        mesh = _mesh((1, 1), ("data", "model"), "meta")
        sharded = _meta_step_flops(cfg, dryrun._rules(mesh), mesh)
    assert sharded == plain > 0


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------
def test_main_prints_writes_and_flags_errors(tmp_path, capsys, monkeypatch):
    out = tmp_path / "sub" / "cells.json"
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[dryrun] rwkv6-1.6b x long_500k (16x16): ok "
                           "dom=")
    rec = json.loads(out.read_text())[0]
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert math.isclose(rec["collective_s_bf16_corrected"],
                        rec["roofline"]["collective_s"])
    assert dryrun.main(["--arch", "starcoder2-3b", "--shape",
                        "long_500k"]) == 0
    assert "skipped full quadratic" in capsys.readouterr().out

    def boom(*a, **k):
        raise RuntimeError("no plan")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k"]) == 1
    assert "error RuntimeError: no plan" in capsys.readouterr().out
