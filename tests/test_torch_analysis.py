"""repro_torch.analysis: tests/test_analysis.py case by case with the
port's rules.  Every planted violation is flagged under its own rule and
no other, the allowlist machinery audits what it silences, and the real
port comes out clean across every registered backend (1 rank in process,
8 gloo ranks in one spawn, as tests/test_torch_sharded.py runs them).

The run-time checks run eagerly on the CPU, where the kernel wrappers
take their plain versions; the sweep launches are seen where
`kernels.ops` calls the wrappers, so the L2 rule is exercised here too.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from datetime import timedelta

import pytest
import torch
import torch.distributed as dist

from repro_torch import analysis as A
from repro_torch.analysis import checks as C
from repro_torch.analysis import cli
from repro_torch.dist import comm

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")


def _rules(findings):
    return {f.rule for f in findings}


@pytest.fixture(scope="module")
def op():
    return cli.lint_operator()


# ---------------------------------------------------------------------------
# Exchange schedule
# ---------------------------------------------------------------------------
PERMS = [
    ([(i, (i + 1) % 8) for i in range(8)], 8),
    ([(0, 1), (1, 0)], 2),
    ([(i, (i + 1) % 8) for i in range(7)], 8),
    ([(0, 1), (0, 0)], 2),
    ([(0, 1), (1, 1), (2, 0)], 3),
    ([(0, 9)], 4),
    ([], 1),
    ([(i, i + 1) for i in range(7)], 8),
]


def test_perm_problems_unit():
    ring = [(i, (i + 1) % 8) for i in range(8)]
    assert A.perm_problems(ring, 8) == []
    assert A.perm_problems([(0, 1), (1, 0)], 2) == []
    probs = A.perm_problems(ring[:-1], 8)
    assert any("never send" in p for p in probs)
    assert any("never receive" in p for p in probs)
    assert any("send more than once" in p
               for p in A.perm_problems([(0, 1), (0, 0)], 2))
    assert any("receive more than once" in p
               for p in A.perm_problems([(0, 1), (1, 1), (2, 0)], 3))
    assert any("outside axis" in p for p in A.perm_problems([(0, 9)], 4))


@pytest.mark.parametrize("perm,size", PERMS)
def test_perm_problems_names_the_references_devices(perm, size):
    """The same devices as the JAX function (pure Python; it runs under
    jax 0.9.0), its "jax zero-fills them" wording dropped."""
    from repro.analysis.checks import perm_problems as jax_perm_problems

    def strip(ps):
        return [re.sub(r" \(.*\)$", "", p) for p in ps]

    assert strip(A.perm_problems(perm, size)) == strip(
        jax_perm_problems(perm, size))


def test_bijection_problems_over_ranks():
    ring = [[((r, (r + 1) % 4),), ((r, (r - 1) % 4),)] for r in range(4)]
    assert C.bijection_problems(ring, 4) == []
    chain = [[((r, r + 1),)] if r < 3 else [()] for r in range(4)]
    (k, probs), = C.bijection_problems(chain, 4)
    assert k == 0 and "devices [3] never send" in probs
    assert "devices [0] never receive" in probs[-1]
    uneven = [[((0, 1),)], [((1, 0),), ((1, 0),)]]
    assert C.bijection_problems(uneven, 2)[0][0] == -1


def test_exchange_schedule_runs():
    ev = [comm.Event("ppermute", ((0, 1), (1, 0)), ((0, 1),))] * 3 + [
        comm.Event("assembly", None, ())]
    assert C.exchange_schedule(ev) == (
        ("ppermute", ((0, 1), (1, 0)), 3), ("assembly", None, 1))
    # what one rank sent is not part of the schedule, which every rank
    # runs alike
    ev2 = [comm.Event("ppermute", ((0, 1), (1, 0)), ((1, 0),))] * 3 + [
        comm.Event("assembly", None, ())]
    assert C.exchange_schedule(ev2) == C.exchange_schedule(ev)


# ---------------------------------------------------------------------------
# L2 budget
# ---------------------------------------------------------------------------
def test_overbudget_sweep_launch_flagged(op):
    plan = op.plan("cuda", device="cpu")
    x = torch.randn(64)
    # the real launch fits the real budget...
    assert A.check_l2_budget(plan.apply, x) == []
    # ...and a starved budget flags the same launch
    fs = A.check_l2_budget(plan.apply, x, budget=256, label="fixture.sweep")
    assert _rules(fs) == {"RT-L2-BUDGET"}
    assert "over the budget 256 B" in fs[0].message
    assert fs[0].symbol == "fixture.sweep"
    # the Jacobi sweep too
    fs = A.check_l2_budget(lambda y: plan.solve(y, "jacobi", tau=0.5).x,
                           x, budget=256)
    assert _rules(fs) == {"RT-L2-BUDGET"} and "jacobi_sweep" in fs[0].message


def test_recorded_launch_is_the_guards_model(op):
    """The check reads the guard's own model: the recorded launch's bytes
    are `ops.cheb_sweep_l2_bytes` at the launch's shape, and a plan whose
    guard refuses the sweep launches none."""
    from repro_torch.kernels import ops

    plan = op.plan("cuda", device="cpu")
    rec = A.record_call(plan.apply, torch.randn(5, 64))
    (launch,) = rec.sweeps
    A_ell = plan.info["block_ell"]
    S = A_ell.sliced_ell()
    assert C.sweep_l2_bytes(launch) == ops.cheb_sweep_l2_bytes(
        A_ell.padded_n, 5, stored=S.stored)
    small = op.plan("cuda", device="cpu", l2_budget=256)
    rec = A.record_call(small.apply, torch.randn(5, 64))
    assert rec.sweeps == []
    assert C.l2_findings(rec, 256) == []


# ---------------------------------------------------------------------------
# Dtype discipline and TF32
# ---------------------------------------------------------------------------
def test_f64_upcast_flagged():
    x = torch.randn(8)
    fs = A.check_dtype_discipline(lambda v: (v.double() * 2).sum(), x)
    assert _rules(fs) == {"RT-DTYPE-F64"}
    assert A.check_dtype_discipline(lambda v: (v * 2.0).sum(), x) == []


def test_mixed_float_width_flagged():
    x = torch.randn(8)
    w = torch.zeros(8, dtype=torch.bfloat16)
    fs = A.check_dtype_discipline(lambda v: v + w, x)
    assert _rules(fs) == {"RT-DTYPE-PROMOTION"}
    # an explicit cast is not a promotion
    assert A.check_dtype_discipline(lambda v: v + w.float(), x) == []


def test_mixed_ok_carveout_sanctions_the_bf16_sweeps(op):
    """RT-DTYPE-MIXED-OK: a finding whose frames pass through a sanctioned
    site is dropped, with its reason recorded as rule metadata; the bf16
    sweep plan is clean."""
    site = (("src/repro_torch/kernels/cheb_sweep.py", 90, "cheb_sweep_plain"),
            ("src/repro_torch/kernels/ops.py", 150, "fused_cheb_sweep"))
    assert C._mixed_ok(site)
    assert not C._mixed_ok((("src/repro_torch/kernels/ops.py", 1, "spmv"),))
    assert all(why for _frag, why in A.DTYPE_MIXED_OK)
    plan = op.plan("cuda", device="cpu", sweep_dtype="bf16")
    x = torch.randn(3, 64)
    plan.apply(x)
    assert A.check_dtype_discipline(plan.apply, x) == []
    rec = C.CallRecord([], [], [("add", (torch.bfloat16, torch.float32),
                                 "RT-DTYPE-PROMOTION", site)], {}, (0, 0))
    assert C.dtype_findings(rec) == []
    assert _rules(C.dtype_findings(rec, mixed_ok=False)) == {
        "RT-DTYPE-PROMOTION"}


def test_mixed_ok_carveout_does_not_shadow_accidents():
    x = torch.randn(8)
    w = torch.ones(3, dtype=torch.bfloat16)

    def bad(v):
        acc = v
        for k in range(3):
            acc = acc + w[k]
        return acc

    assert "RT-DTYPE-PROMOTION" in _rules(A.check_dtype_discipline(bad, x))


def test_complex_arma_solve_is_exempt(op):
    plan = op.plan("dense", device="cpu")
    y = torch.randn(64)
    plan.solve(y, "arma", tau=0.5)
    assert A.check_dtype_discipline(
        lambda v: plan.solve(v, "arma", tau=0.5).x, y) == []


def test_tf32_flag_flagged(op):
    """TF32 turned on: the dense plan's f32 product runs under it (checked
    through the flag on the CPU); a card call with either flag on is
    flagged at the call."""
    plan = op.plan("dense", device="cpu")
    x = torch.randn(64)
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        fs = A.check_dtype_discipline(plan.apply, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    assert _rules(fs) == {"RT-TF32"}
    assert fs[0].path == "src/repro_torch/dist/backends/dense.py"
    assert A.check_dtype_discipline(plan.apply, x) == []
    rec = C.CallRecord([], [], [], {}, (False, True))
    fs = C.tf32_findings(rec, torch.device("cuda"), "cuda.apply")
    assert _rules(fs) == {"RT-TF32"} and "cudnn" in fs[0].message
    assert C.tf32_findings(rec, torch.device("cpu")) == []


def test_check_plan_flags_planted_l2_and_tf32(op):
    """check_plan itself, not only its callable-level helpers: a starved
    budget flags the cuda plan's sweeps under RT-L2-BUDGET, and TF32
    turned on flags the dense plan's product under RT-TF32, each under
    its own rule and no other."""
    plan = op.plan("cuda", device="cpu")
    fs = A.check_plan(plan, batches=(1, 4), budget=256,
                      solve_methods=("jacobi",))
    assert _rules(fs) == {"RT-L2-BUDGET"}
    assert {f.symbol for f in fs} >= {"cuda.apply", "cuda.solve[jacobi]"}
    assert A.check_plan(plan, batches=(1, 4)) == []
    dense = op.plan("dense", device="cpu")
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        fs = A.check_plan(dense, batches=(1, 4))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    assert _rules(fs) == {"RT-TF32"}
    assert "dense.apply" in {f.symbol for f in fs}
    assert A.check_plan(dense, batches=(1, 4)) == []


# ---------------------------------------------------------------------------
# AST rules (fixture sources through lint_source)
# ---------------------------------------------------------------------------
LIB = "src/repro_torch/somewhere.py"


def _lint(src, relpath=LIB, **kw):
    return A.lint_source(textwrap.dedent(src), relpath, **kw)


def test_ast_dense_materialization():
    src = """
    import torch

    def filt(L, f):
        w, v = torch.linalg.eigh(L)
        return v @ (w[:, None] * (v.T @ f))

    def pack(A):
        return A.to_dense()
    """
    fs = _lint(src)
    assert _rules(fs) == {"RP-DENSE-MAT"} and len(fs) == 2
    assert fs[0].symbol == "filt"
    plain = src.replace("def filt", "def filt_plain").replace(
        "def pack", "def pack_plain")
    assert _lint(plain) == []
    # the float64 oracle of REF_PATHS, and only that function there
    oracle = "def _eig(P):\n    return torch.linalg.eigh(P)\n"
    assert _lint(oracle, "src/repro_torch/core/multiplier.py") == []
    assert _rules(_lint(oracle.replace("_eig", "_other"),
                        "src/repro_torch/core/multiplier.py")) == {
        "RP-DENSE-MAT"}


def test_ast_order_loop():
    src = """
    def apply(mv, x, K):
        for k in range(K + 1):
            x = mv(x)
        return x
    """
    fs = _lint(src)
    assert _rules(fs) == {"RP-ORDER-LOOP"}
    for name in ("_per_order_apply", "_cheb_recurrence_loop", "apply_plain"):
        assert _lint(src.replace("def apply", f"def {name}")) == []


def test_ast_host_sync():
    fs = _lint("""
    import torch

    def pull(x):
        torch.cuda.synchronize()
        return x.sum().item()
    """)
    assert [f.rule for f in fs] == ["RP-HOST-SYNC", "RP-HOST-SYNC"]
    fs = _lint("""
    def pull(x, ev):
        ev.synchronize()
        return x.cpu().numpy().tolist()
    """)
    assert [f.rule for f in fs] == ["RP-HOST-SYNC"] * 4


def test_ast_unlogged_fallback():
    bad = """
    def dispatch(x):
        if x.device.type == "cpu":
            return spmv_plain(x)
        return _fast(x)
    """
    fs = _lint(bad)
    assert _rules(fs) == {"RP-FALLBACK-LOG"}
    good = """
    def dispatch(x):
        if x.device.type == "cpu":
            logger.info("dispatch: taking the plain version")
            return spmv_plain(x)
        return _fast(x)
    """
    assert _lint(good) == []
    assert _rules(_lint("""
    def dispatch(x, ok):
        if not ok:
            return _per_order_cheb(x)
    """)) == {"RP-FALLBACK-LOG"}


def test_ast_legacy_scaffold_import(monkeypatch):
    monkeypatch.chdir(ROOT)
    globs = ("src/repro_torch/models/*",
             "src/repro_torch/kernels/flash_attention.py")
    fs = _lint("from repro_torch.models import model\n",
               scaffold_globs=globs)
    assert _rules(fs) == {"RP-LEGACY-SCAFFOLD"}
    fs = A.lint_source("from .flash_attention import flash_attention\n",
                       "src/repro_torch/kernels/newkernel.py",
                       scaffold_globs=globs)
    assert _rules(fs) == {"RP-LEGACY-SCAFFOLD"}
    assert A.lint_source("from repro_torch.models import model\n",
                         "src/repro_torch/models/other.py",
                         scaffold_globs=globs) == []
    assert _lint("from repro_torch.core import graph\n",
                 scaffold_globs=globs) == []


def test_ast_scaffold_files_skipped_but_held_to_no_jax(monkeypatch):
    monkeypatch.chdir(ROOT)
    src = ("import torch\n\ndef f(L):\n"
           "    return torch.linalg.eigh(L)[0].item()\n")
    globs = ("src/repro_torch/models/*",)
    assert A.lint_source(src, "src/repro_torch/models/newthing.py",
                         scaffold_globs=globs) == []
    fs = A.lint_source("import jax\n", "src/repro_torch/models/newthing.py",
                       scaffold_globs=globs)
    assert _rules(fs) == {"RP-NO-JAX"}


def test_ast_no_jax():
    for src in ("import jax\n", "import jax.numpy as jnp\n",
                "from jaxlib import xla_client\n",
                "from repro.core import graph\n", "import repro\n"):
        fs = _lint(src)
        assert _rules(fs) == {"RP-NO-JAX"}, src
    fs = A.lint_source("import jax\n", "chip_smoke.py")
    assert _rules(fs) == {"RP-NO-JAX"}
    for src in ("from . import graph\n", "import repro_torch\n",
                "from repro_torch.core import graph\n", "import jaxtyping\n"):
        assert _lint(src) == [], src


# ---------------------------------------------------------------------------
# Allowlist machinery
# ---------------------------------------------------------------------------
def test_allowlist_requires_justification(tmp_path):
    p = tmp_path / "allow.txt"
    p.write_text("[allow]\nRP-DENSE-MAT src/repro_torch/foo.py\n")
    with pytest.raises(A.AllowlistError, match="justification"):
        A.Allowlist.load(str(p))
    p.write_text("[scaffold]\nsrc/repro_torch/models/*\n")
    with pytest.raises(A.AllowlistError, match="justification"):
        A.Allowlist.load(str(p))


def test_allowlist_split_and_staleness(tmp_path):
    p = tmp_path / "allow.txt"
    p.write_text(textwrap.dedent("""
        [scaffold]
        src/repro_torch/models/* -- dormant
        [allow]
        RP-DENSE-MAT src/repro_torch/foo.py::g -- oracle path
        RP-ORDER-LOOP src/repro_torch/never.py -- stale record
    """))
    al = A.Allowlist.load(str(p))
    assert al.scaffold_globs == ("src/repro_torch/models/*",)
    hit = A.Finding(rule="RP-DENSE-MAT", path="src/repro_torch/foo.py",
                    symbol="g", message="m")
    miss_sym = A.Finding(rule="RP-DENSE-MAT", path="src/repro_torch/foo.py",
                         symbol="h", message="m")
    kept, suppressed = al.split([hit, miss_sym])
    assert suppressed == [hit] and kept == [miss_sym]
    stale = al.unused_entries([hit, miss_sym])
    assert [e.path_glob for e in stale] == ["src/repro_torch/never.py"]


def test_port_allowlist_parses_and_is_fully_exercised(monkeypatch):
    """Every entry of the port's allowlist has a justification and still
    matches a real finding of the AST layer; nothing is left over."""
    al = A.Allowlist.load(str(cli.ALLOWLIST))
    assert al.entries and al.scaffold
    for e in al.entries + al.scaffold:
        assert e.justification
    assert {e.rule for e in al.entries} <= set(A.AST_RULES)
    monkeypatch.chdir(ROOT)
    findings = cli.ast_findings(al)
    kept, suppressed = al.split(findings)
    assert kept == [], [str(f) for f in kept]
    assert suppressed
    assert al.unused_entries(findings) == [], "stale allowlist entries"


def test_lint_cli_ast_layer():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check",
         "--layers", "ast"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout, proc.stdout + proc.stderr
    assert "stale" not in proc.stderr, proc.stderr


# ---------------------------------------------------------------------------
# Clean runs over every backend: 1 rank here, 8 gloo ranks in one spawn
# ---------------------------------------------------------------------------
def test_all_backends_clean_1rank(op):
    from repro_torch.dist.backends import available_backends

    assert set(available_backends()) == {
        "dense", "cuda", "halo", "cuda_halo", "allgather"}
    for backend in available_backends():
        plan = op.plan(backend, device="cpu")
        report = {}
        fs = A.check_plan(plan, batches=(1, 8), solve_methods=("jacobi",),
                          report=report)
        assert fs == [], (backend, [str(f) for f in fs])
        assert report["calls"] == 16


def _chain_exchange(x):
    """Rank r sends its tile to r + 1 and receives from r - 1, without
    the wrap: the last rank never sends, the first never receives."""
    group = dist.group.WORLD
    rank, size = dist.get_rank(), dist.get_world_size()
    ops = []
    recv = torch.empty_like(x)
    if rank + 1 < size:
        ops.append(dist.P2POp(dist.isend, x, rank + 1, group, 1))
    if rank > 0:
        ops.append(dist.P2POp(dist.irecv, recv, rank - 1, group, 1))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    comm._record("ppermute", x, tuple((i, i + 1) for i in range(size - 1)),
                 sends=((rank, rank + 1),) if rank + 1 < size else (),
                 group=group)
    return recv


def _ring(x, times):
    for _ in range(times):
        x = comm.offset_exchange([x], (1,), dist.group.WORLD).wait()[0]
    return x


def _data_loop(x):
    # one exchange per unit of |x|: a trip count that depends on the data
    return _ring(x, int(x.abs().sum() > 0) * 2)


def _batch_fixture(b):
    def fn(x):
        return _ring(x, b)  # one exchange per signal: the bug
    return fn, (torch.ones(b, 8),)


class _PlantedPlan:
    """A real plan whose `apply` runs `extra(x)` more ring exchanges after
    its own: the planted defect that check_plan must find."""

    def __init__(self, plan, extra):
        self._plan, self._extra = plan, extra

    def __getattr__(self, name):
        return getattr(self._plan, name)

    def apply(self, x):
        return _ring(self._plan.apply(x), self._extra(x))


def _planted(rank):
    from repro_torch.core import wavelets
    from repro_torch.dist import GraphOperator

    out = {}
    x = torch.arange(8.0)
    fs = A.check_comm_schedule(_chain_exchange, x, label="fixture.chain")
    out["chain"] = [[f.rule, f.message] for f in fs]
    out["ring"] = [f.rule for f in A.check_comm_schedule(
        lambda v: _ring(v, 2), x)]
    out["data"] = [f.rule for f in A.check_comm_schedule(_data_loop, x)]
    out["batch"] = [f.rule for f in A.check_batch_schedule(
        _batch_fixture, batches=(1, 4))]
    out["batch_ok"] = [f.rule for f in A.check_batch_schedule(
        lambda b: (lambda v: _ring(v, 1), (torch.ones(b, 8),)),
        batches=(1, 4))]
    # a plan whose exchange structure differs (K = 12 against K = 10: two
    # extra rounds per application) is what the fault rule must flag
    op = cli.lint_operator()
    op12 = GraphOperator(P=op.P, multipliers=wavelets.sgwt_multipliers(
        op.lmax, J=cli.LINT_J), lmax=op.lmax, K=12)
    fs = A.check_fault_schedule(op.plan("halo", device="cpu"),
                                op12.plan("halo", device="cpu"))
    out["k12"] = [f.rule for f in fs]
    # the same defects through check_plan over a plan: an exchange loop
    # whose trip count depends on the data, and one per signal
    halo = op.plan("halo", device="cpu")
    for key, extra in (("plan_data", lambda x: 2 * int(x.abs().sum() > 0)),
                       ("plan_batch", lambda x: x.shape[0])):
        fs = A.check_plan(_PlantedPlan(halo, extra), batches=(1, 4))
        out[key] = [[f.rule, f.symbol] for f in fs]
    return out


def _worker(rank, world, tmp):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        report = {}
        clean = cli.runtime_findings(world, device="cpu", report=report)
        out = {"clean": [str(f) for f in clean], "report": report,
               **_planted(rank)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("analysis8")
    mp.spawn(_worker, args=(8, str(tmp)), nprocs=8, join=True)
    out = []
    for r in range(8):
        with open(tmp / f"rank{r}.json") as fh:
            out.append(json.load(fh))
    return out


def test_all_backends_clean_8ranks(ranks):
    """halo, cuda_halo and allgather at B = 1 and 64 (apply, adjoint,
    Gram, three solves), the general partition of a community graph, and
    the int8 plans with and without a FaultSpec: no finding on any
    rank."""
    for r in ranks:
        assert r["clean"] == [], r["clean"]
        assert r["report"]["calls"] > 100


def test_incomplete_exchange_flagged_8ranks(ranks):
    for r in ranks:
        assert {rule for rule, _ in r["chain"]} == {"RT-EXCHANGE-BIJECTION"}
        assert "devices [7] never send" in r["chain"][0][1]
        assert "devices [0] never receive" in r["chain"][0][1]
        assert r["ring"] == []


def test_exchange_in_data_dependent_loop_flagged_8ranks(ranks):
    for r in ranks:
        assert set(r["data"]) == {"RT-EXCHANGE-DATA-DEPENDENT"}


def test_batch_dependent_schedule_flagged_8ranks(ranks):
    for r in ranks:
        assert set(r["batch"]) == {"RT-BATCH-SCHEDULE"}
        assert r["batch_ok"] == []


def test_fault_plan_with_extra_rounds_flagged_8ranks(ranks):
    for r in ranks:
        assert r["k12"] and set(r["k12"]) == {"RT-FAULT-NO-EXTRA-ROUNDS"}


def test_check_plan_flags_data_and_batch_dependent_plans_8ranks(ranks):
    for r in ranks:
        assert {tuple(f) for f in r["plan_data"]} == {
            ("RT-EXCHANGE-DATA-DEPENDENT", "halo.apply")}
        assert {tuple(f) for f in r["plan_batch"]} == {
            ("RT-BATCH-SCHEDULE", "halo.apply")}


def test_lint_cli_runtime_layer_defaults_to_the_card(monkeypatch, capsys):
    """The entry point runs on the card unless the caller asks for the
    CPU: without a card, the runtime layer stops instead of quietly
    running the plain CPU versions."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--check", "--layers", "runtime"]) == 2
    assert "--device cpu" in capsys.readouterr().err
