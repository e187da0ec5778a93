"""The port's package surface against the JAX package's, module by module.

For every module of `src/repro/` the port has its counterpart under the
same name (or a named one: `MOVED_MODULES`) or is listed in
`MODULE_GAPS` with the reason; for every pair, each public name of the
reference (its `__all__`, else what the module defines) is an attribute
of the port's module, or is listed in `NAME_GAPS`: "not ported, by
design" and "moved" as ROADMAP.md queue 1 lists them one by one.  A new
gap fails, and so does a listed gap that was closed (the list must be
pruned).

The halo functional forms (`dist_cheb_apply`, `dist_cheb_apply_adjoint`,
`dist_cheb_apply_gram`, `dist_lasso`) are held equal to the `halo` plan's
outputs on 8 gloo ranks (one spawn), clean and under an int8 wire with
link faults.
"""
import importlib
import json
import os
import types
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

BY_DESIGN = "not ported, by design"

#: Reference modules whose counterpart has another name.
MOVED_MODULES = {
    "repro.dist.backends.pallas": "repro_torch.dist.backends.cuda",
    "repro.dist.backends.pallas_halo": "repro_torch.dist.backends.cuda_halo",
    "repro.dist.commstats": "repro_torch.dist.comm",
}

#: Reference modules with no counterpart, and why.
MODULE_GAPS = {
    "repro._compat": BY_DESIGN + ": jax-version shims",
    "repro.core.distributed": BY_DESIGN + ": a deprecated shim",
    "repro.kernels.ref": BY_DESIGN + ": the *_plain function beside each "
                         "kernel plays its role",
    "repro.analysis.jaxpr_walk": BY_DESIGN + ": no jaxpr; comm.counting() "
                                 "is the recorder",
}

_JAXPR = BY_DESIGN + ": jaxpr machinery (analysis/jaxpr_walk.py)"
#: Public names of a reference module that its counterpart lacks, and why.
NAME_GAPS = {
    "repro": {"_compat": BY_DESIGN + ": jax-version shims"},
    "repro.analysis": {
        "COLLECTIVE_PRIMITIVES": _JAXPR, "EqnContext": _JAXPR,
        "collect_eqns": _JAXPR, "eqn_payload": _JAXPR,
        "source_location": _JAXPR, "subjaxprs": _JAXPR,
        "walk_jaxpr": _JAXPR,
        "JAXPR_RULES": "moved: RUNTIME_RULES",
        "check_vmem_budget": "moved: check_l2_budget (the TPU's VMEM "
                             "becomes the H100's L2)",
        "pallas_footprint": "moved: checks.sweep_l2_bytes, the guard's "
                            "L2 model of a recorded launch",
    },
    "repro.analysis.checks": {
        "COLLECTIVE_PRIMITIVES": _JAXPR,
        "JAXPR_RULES": "moved: RUNTIME_RULES",
        "check_vmem_budget": "moved: check_l2_budget",
        "pallas_footprint": "moved: sweep_l2_bytes",
    },
    "repro.core": {"distributed": BY_DESIGN + ": a deprecated shim"},
    "repro.dist": {
        "commstats": "moved: dist.comm",
    },
    "repro.dist.backends.pallas_halo": {
        "pallas_halo_bytes_per_apply": "moved: halo.halo_bytes_per_apply, "
                                       "which takes a ShardedBlockELL too",
    },
    "repro.dist.commstats": {
        "COLLECTIVE_PRIMITIVES": _JAXPR,
        "UncountableCollectiveError": BY_DESIGN + ": no trace, so nothing "
                                      "is uncountable; the schedule check "
                                      "sees data-dependent exchanges",
        "measure": "moved: comm.counting() around the call",
    },
    "repro.dist.partition": {
        "build_general_plan": "moved: dist.sharded",
        "make_exchange_matvec": "moved: sharded.offset_matvec",
    },
    "repro.kernels": {"block_ell_spmv": "moved: sliced_ell_spmv",
                      "ref": BY_DESIGN + ": the *_plain functions"},
    "repro.kernels.bcsr_spmv": {
        "block_ell_spmv": "moved: sliced_ell_spmv",
        "block_ell_spmv_batched": "moved: sliced_ell_spmv"},
    "repro.kernels.cheb_step": {"pick_block": BY_DESIGN + ": a TPU name"},
    "repro.kernels.flash_attention": {
        "DEFAULT_BLOCK_K": BY_DESIGN + ": a TPU name",
        "DEFAULT_BLOCK_Q": BY_DESIGN + ": a TPU name"},
    "repro.kernels.ops": {
        "DEFAULT_SWEEP_VMEM_BUDGET": BY_DESIGN + ": a TPU name "
                                     "(DEFAULT_SWEEP_L2_BUDGET)",
        "cheb_sweep_vmem_bytes": BY_DESIGN + ": a TPU name "
                                 "(cheb_sweep_l2_bytes)",
        "jacobi_sweep_vmem_bytes": BY_DESIGN + ": a TPU name "
                                   "(jacobi_sweep_l2_bytes)"},
    "repro.launch.roofline": {
        "ICI_BW": "moved: LINK_BW (NVLink 4, one direction, in place of "
                  "the TPU's ICI link)",
    },
}


def _reference_modules():
    """Every module of src/repro/ by dotted name, from the files (nothing
    is imported to find them)."""
    names = []
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


REF_MODULES = _reference_modules()
PAIRS = [m for m in REF_MODULES if m not in MODULE_GAPS]


def _port_name(ref: str) -> str:
    return MOVED_MODULES.get(ref, "repro_torch" + ref[len("repro"):])


def _public(mod) -> set:
    """`__all__`, else what the module defines (a package: what its own
    submodules define too)."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    out = set()
    pkg = hasattr(mod, "__path__")
    for n, v in vars(mod).items():
        if n.startswith("_") or isinstance(v, types.ModuleType):
            continue
        m = getattr(v, "__module__", None)
        if m is None or m == mod.__name__ or (
                pkg and m.startswith(mod.__name__ + ".")):
            out.add(n)
    return out


def test_every_reference_module_has_a_counterpart_or_a_reason():
    assert "repro.core.graph" in REF_MODULES and len(REF_MODULES) > 50
    for ref in REF_MODULES:
        path = ROOT / "src" / Path(*_port_name(ref).split("."))
        has = path.with_suffix(".py").is_file() or (path / "__init__.py"
                                                    ).is_file()
        if ref in MODULE_GAPS:
            assert not has, f"{ref} is ported now: drop it from MODULE_GAPS"
        else:
            assert has, f"{ref} has no counterpart {_port_name(ref)}"
    assert set(MODULE_GAPS) <= set(REF_MODULES)
    assert set(NAME_GAPS) <= set(PAIRS)


@pytest.mark.parametrize("ref", PAIRS)
def test_public_names_match_the_reference(ref):
    rmod = importlib.import_module(ref)
    tmod = importlib.import_module(_port_name(ref))
    missing = {n for n in _public(rmod) if not hasattr(tmod, n)}
    listed = NAME_GAPS.get(ref, {})
    assert missing - set(listed) == set(), (
        f"{_port_name(ref)} lacks {sorted(missing - set(listed))}")
    assert set(listed) - missing == set(), (
        f"{sorted(set(listed) - missing)} of {ref} are ported now: drop "
        "them from NAME_GAPS")
    assert all(listed.values())


def test_fault_3_3_names_are_in_place():
    from repro_torch import core
    from repro_torch.dist import as_graph_operator
    from repro_torch.dist.backends import halo
    from repro_torch.kernels import ops

    import repro.core as jcore

    assert set(jcore.__all__) - {"distributed"} <= set(core.__all__)
    for n in set(jcore.__all__) - {"distributed"}:
        assert getattr(core, n) is not None
    for n in ("dist_cheb_apply", "dist_cheb_apply_adjoint",
              "dist_cheb_apply_gram", "dist_lasso"):
        assert callable(getattr(halo, n))
    assert callable(as_graph_operator)
    x = torch.ones(2, 1000)
    assert ops.pad_for_kernels(x).shape == (2, 1024)
    assert ops.pad_for_kernels(x, 8).shape == (2, 1000)
    assert torch.equal(ops.pad_for_kernels(x)[:, :1000], x)


def test_as_graph_operator_rewraps_a_union():
    from repro_torch.core import wavelets
    from repro_torch.core.graph import path_graph
    from repro_torch.core.multiplier import UnionMultiplier
    from repro_torch.dist import GraphOperator, as_graph_operator

    g = path_graph(16)
    lmax = g.lambda_max_bound()
    um = UnionMultiplier(P=g.laplacian(),
                         multipliers=wavelets.sgwt_multipliers(lmax, J=2),
                         lmax=lmax, K=6)
    op = as_graph_operator(um)
    assert isinstance(op, GraphOperator) and op.P is um.P
    np.testing.assert_array_equal(op.coeffs, um.coeffs)
    assert as_graph_operator(op) is op


# ---------------------------------------------------------------------------
# The halo functional forms on 8 gloo ranks
# ---------------------------------------------------------------------------
WORLD, N, K, J, ITERS = 8, 64, 10, 2, 5
MU = [0.01, 0.5, 0.5]
FAULTS = {"drop_prob": 0.2, "stale_prob": 0.1, "noise_prob": 0.05,
          "seed": 3}


def _rank(rank, world, tmp):
    from repro_torch.core import graph, lasso, wavelets
    from repro_torch.dist import GraphOperator
    from repro_torch.dist.backends import halo

    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    out = {}
    try:
        g = graph.path_graph(N)
        lmax = g.lambda_max_bound()
        op = GraphOperator(P=g.laplacian(),
                           multipliers=wavelets.sgwt_multipliers(lmax, J=J),
                           lmax=lmax, K=K)
        parts = halo.partition_banded(op.P, world)[0]
        rs = np.random.RandomState(0)
        x = torch.tensor(rs.randn(3, N), dtype=torch.float32)
        a = torch.tensor(rs.randn(3, J + 1, N), dtype=torch.float32)
        gamma = float(lasso.ista_step_size(op))
        group = dist.group.WORLD
        for label, wire in (("clean", {}),
                            ("int8_faults", dict(exchange_dtype="int8",
                                                 fault_spec=FAULTS,
                                                 degradation="hold_last"))):
            plan = op.plan("halo", device="cpu", **wire)
            las = plan.solve_lasso(x, MU, gamma=gamma, n_iters=ITERS)
            got_lasso = halo.dist_lasso(group, parts, x, op.coeffs, lmax,
                                        MU, gamma=gamma, n_iters=ITERS,
                                        **wire)
            pairs = {
                "apply": (halo.dist_cheb_apply(group, parts, x, op.coeffs,
                                               lmax, **wire),
                          plan.apply(x)),
                "apply_adjoint": (halo.dist_cheb_apply_adjoint(
                    group, parts, a, op.coeffs, lmax, **wire),
                    plan.apply_adjoint(a)),
                "apply_gram": (halo.dist_cheb_apply_gram(
                    group, parts, x, op.coeffs, lmax, **wire),
                    plan.apply_gram(x)),
                "lasso_coeffs": (got_lasso[0], las.coeffs),
                "lasso_signal": (got_lasso[1], las.signal),
            }
            out[label] = {k: [float((f - p).abs().max()),
                              list(f.shape) == list(p.shape)]
                          for k, (f, p) in pairs.items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("names8")
    mp.spawn(_rank, args=(WORLD, str(tmp)), nprocs=WORLD, join=True)
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as fh:
            out.append(json.load(fh))
    return out


@pytest.mark.parametrize("label", ["clean", "int8_faults"])
@pytest.mark.parametrize("kind", ["apply", "apply_adjoint", "apply_gram",
                                  "lasso_coeffs", "lasso_signal"])
def test_halo_functional_forms_equal_the_plan(ranks, kind, label):
    for r in ranks:
        err, same_shape = r[label][kind]
        assert same_shape and err == 0.0, (kind, label, err)
