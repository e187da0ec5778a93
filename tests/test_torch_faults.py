"""Seeded link faults (`repro_torch.dist.faults`) on the port's exchange,
held against the JAX package's `repro.dist.faults` where the two can
agree and against the reference's contract where they cannot.

* The spec plumbing mirrors tests/test_faults.py:28-109 and is held equal
  to the reference's: validation, the resolve forms, `fault_key` strings
  character for character, `make_injector` gating, `spec_info`'s JSON form,
  and the build errors (`ValueError` for a degradation or wire dtype,
  `TypeError` for a malformed spec) of `halo` and `cuda_halo`; `allgather`
  refuses another wire than f32 and an active spec (`ValueError`).
* The draws are the port's own design (a host Philox keyed by (seed,
  rank, round, link, salt); jax's threefry cannot be reproduced): the
  injector gives the same bits for the same key and others for another
  seed or rank, flips exactly one of the low 8 bits of a lane, and never
  touches an int8 row's scale.  The faulted outputs are held against the
  JAX `halo` plan run on the same draws in tests/test_torch_quantize.py.
* One spawn of 8 gloo ranks on the CPU restates the payload of
  tests/test_faults.py:130-242 on the port (`halo` and `cuda_halo` with
  the kernels' plain versions, the BENCH_faults.json banded setup n = 256,
  half-band 8, K = 10, and a general partition of the 192-vertex community
  graph; f32 and int8): None and ``FaultSpec(seed=99)`` are the clean plan
  bit for bit (f32 also equal to the plan built without any wire option),
  the same seed gives the same bits on two fresh plans, another seed or
  hold_last other bits, the output stays finite, and rounds and bytes per
  round are the clean plan's; the gossip ring (clean, faulted, quantized,
  and bounded under the mild spec: relative error < 1.0 of the mean); and
  the ladder of benchmarks/bench_faults.py at S = 8 with means over 8
  seeds: the apply error does not fall as p rises, and at p = 0.05
  hold_last's solve error is at most zero_fill's (bench_faults.py:216).

The JAX package is imported only inside tests: the ranks import this
module to find their entry point and need none of it.
"""
import dataclasses
import hashlib
import json
import os
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import graph as tgraph
from repro_torch.dist import (DEGRADATIONS, FaultSpec, GraphOperator, comm,
                              faults, gossip, plan_comm_stats)
from repro_torch.dist import quantize as tq
from repro_torch.dist.partition import community_graph_csr

WORLD = 8
RING = ["halo", "cuda_halo"]
N_F, BW_F, K_F = 256, 8, 10
SPEC = FaultSpec(drop_prob=0.2, stale_prob=0.1, noise_prob=0.05, seed=3)
OTHER_SEED = dataclasses.replace(SPEC, seed=4)
MILD = FaultSpec(drop_prob=0.05, stale_prob=0.05, noise_prob=0.05, seed=3)
PROBS = (0.0, 0.01, 0.05, 0.2)
LADDER_SEEDS = 8
SOLVE_ITERS, TAU = 12, 0.5

SPECS = [None, FaultSpec(), 0.0, 0.1, 0.25, {"drop_prob": 0.1, "seed": 1},
         SPEC, FaultSpec(drop_prob=1e-7, seed=-5), {"noise_prob": 0.5},
         FaultSpec(stale_prob=1.0, seed=2**40)]


def _as_jax_spec(spec):
    """The same spec for the JAX package (its own FaultSpec class)."""
    from repro.dist import faults as jf

    if isinstance(spec, FaultSpec):
        return jf.FaultSpec(**dataclasses.asdict(spec))
    return spec


# ---------------------------------------------------------------------------
# The spec plumbing, against the reference
# ---------------------------------------------------------------------------
def test_fault_spec_validation():
    s = FaultSpec(drop_prob=0.1, stale_prob=0.2, noise_prob=0.3, seed=7)
    assert s.active and s.seed == 7
    assert not FaultSpec().active
    for bad in ({"drop_prob": -0.1}, {"stale_prob": 1.5},
                {"noise_prob": 2.0}):
        with pytest.raises(ValueError):
            FaultSpec(**bad)
    assert DEGRADATIONS == ("zero_fill", "hold_last")


def test_resolve_fault_spec_forms():
    from repro.dist import faults as jf

    assert faults.resolve_fault_spec(None) is None
    s = FaultSpec(drop_prob=0.25)
    assert faults.resolve_fault_spec(s) is s
    assert faults.resolve_fault_spec(0.25) == s
    assert faults.resolve_fault_spec({"drop_prob": 0.25}) == s
    assert (dataclasses.asdict(faults.resolve_fault_spec(0.25))
            == dataclasses.asdict(jf.resolve_fault_spec(0.25)))
    for bad in (True, "0.25", [0.25]):
        with pytest.raises(TypeError):
            faults.resolve_fault_spec(bad)
    with pytest.raises(TypeError):
        faults.resolve_fault_spec({"p": 0.05})


@pytest.mark.parametrize("degradation", ["zero_fill", "hold_last"])
@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_fault_key_equals_jax(spec, degradation):
    from repro.dist import faults as jf

    assert (faults.fault_key(spec, degradation)
            == jf.fault_key(_as_jax_spec(spec), degradation))
    assert faults.spec_info(spec) == jf.spec_info(_as_jax_spec(spec))


def test_fault_key_identity():
    assert faults.fault_key(None) == "none"
    assert faults.fault_key(FaultSpec()) == "none"
    assert faults.fault_key(0.0, "hold_last") == "none"
    k1 = faults.fault_key(0.1, "zero_fill")
    k2 = faults.fault_key(0.1, "hold_last")
    k3 = faults.fault_key({"drop_prob": 0.1, "seed": 1}, "zero_fill")
    assert len({k1, k2, k3, "none"}) == 4
    with pytest.raises(ValueError):
        faults.fault_key(0.1, "hold_first")


def test_make_injector_gating():
    assert faults.make_injector(None, "zero_fill", 0, True) is None
    assert faults.make_injector(0.0, "zero_fill", 0, True) is None
    assert faults.make_injector(0.5, "zero_fill", 0, False) is None
    inj = faults.make_injector(0.5, "hold_last", 3, True)
    assert inj is not None and inj.degradation == "hold_last"
    assert inj.rank == 3 and inj.init_round() == 0
    with pytest.raises(ValueError):
        faults.make_injector(None, "zerofill", 0, True)


def test_spec_info_jsonable():
    assert faults.spec_info(None) is None
    d = faults.spec_info({"drop_prob": 0.1, "seed": 3})
    assert d == {"drop_prob": 0.1, "stale_prob": 0.0, "noise_prob": 0.0,
                 "seed": 3}
    json.dumps(d)


def _path_op(n=32, K=4):
    g = tgraph.path_graph(n)
    return GraphOperator(P=g.laplacian(), multipliers=[lambda lam: lam],
                         lmax=g.lambda_max_bound(), K=K)


@pytest.mark.parametrize("backend", RING)
def test_build_rejects_bad_fault_args(backend):
    """tests/test_faults.py:96: a bad degradation raises ValueError (with
    an inactive spec too), a malformed spec TypeError, an unknown wire
    dtype ValueError."""
    op = _path_op()
    with pytest.raises(ValueError):
        op.plan(backend, device="cpu", fault_spec=0.1,
                degradation="drop_everything")
    with pytest.raises(ValueError):
        op.plan(backend, device="cpu", degradation="zerofill")
    with pytest.raises(TypeError):
        op.plan(backend, device="cpu", fault_spec="lossy")
    with pytest.raises(ValueError):
        op.plan(backend, device="cpu", exchange_dtype="f16")


@pytest.mark.parametrize("backend", RING)
def test_plan_info_carries_the_wire_and_fault_identity(backend):
    """pallas_halo.py:435-439's keys; on one shard the options are inert
    (nothing is exchanged) and the output is the clean plan's."""
    op = _path_op()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 32)).astype(np.float32))
    clean = op.plan(backend, device="cpu")
    assert clean.info["fault_key"] == "none"
    assert clean.info["fault_spec"] is None
    assert clean.info["exchange_dtype"] == "f32"
    assert clean.info["error_feedback"] is True
    assert clean.info["degradation"] == "zero_fill"
    faulted = op.plan(backend, device="cpu", fault_spec=0.2,
                      degradation="hold_last", exchange_dtype="int8",
                      error_feedback=False)
    assert faulted.info["fault_key"] == faults.fault_key(0.2, "hold_last")
    assert faulted.info["fault_spec"]["drop_prob"] == 0.2
    assert faulted.info["error_feedback"] is False
    assert faulted.info["exchange_dtype"] == "int8"
    assert torch.equal(faulted.apply(x), clean.apply(x))


@pytest.mark.parametrize("option", [
    dict(exchange_dtype="int8"), dict(exchange_dtype="bf16"),
    dict(fault_spec=0.05), dict(fault_spec=SPEC)])
def test_allgather_refuses_wire_and_fault_options(option):
    op = _path_op()
    with pytest.raises(ValueError, match="no compressed exchange"):
        op.plan("allgather", device="cpu", **option)


def test_allgather_takes_the_inert_options():
    """An inactive spec is no fault: allgather builds; a malformed one
    raises TypeError as on the ring backends."""
    op = _path_op()
    x = torch.ones(2, 32)
    plan = op.plan("allgather", device="cpu", fault_spec=FaultSpec(seed=99))
    assert plan.info["exchange_dtype"] == "f32"
    assert torch.equal(plan.apply(x),
                       op.plan("allgather", device="cpu").apply(x))
    with pytest.raises(TypeError):
        op.plan("allgather", device="cpu", fault_spec="lossy")


# ---------------------------------------------------------------------------
# The injector: the port's draws
# ---------------------------------------------------------------------------
def _wire(dtype, seed=0, shape=(4, 24)):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))
    return tq.encode(x, dtype)


def _bits(w: torch.Tensor) -> np.ndarray:
    if w.dtype == torch.bfloat16:
        return w.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    return w.numpy().view(np.uint8).astype(np.int64)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_noise_is_a_function_of_the_key(dtype):
    w = _wire(dtype)
    inj = faults.LinkFaultInjector(SPEC, "zero_fill", rank=2)
    again = faults.LinkFaultInjector(SPEC, "zero_fill", rank=2)
    got = inj.wire(w, 5, 1, dtype)
    assert torch.equal(_as_int(got), _as_int(again.wire(w, 5, 1, dtype)))
    others = [inj.wire(w, 6, 1, dtype), inj.wire(w, 5, 0, dtype),
              faults.LinkFaultInjector(SPEC, "zero_fill", 3).wire(
                  w, 5, 1, dtype),
              faults.LinkFaultInjector(OTHER_SEED, "zero_fill", 2).wire(
                  w, 5, 1, dtype)]
    for o in others:
        assert not torch.equal(_as_int(o), _as_int(got))


def _as_int(w):
    return w.view(torch.int16) if w.dtype == torch.bfloat16 else w


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_noise_flips_one_low_bit_per_lane_and_spares_the_scale(dtype):
    w = _wire(dtype, 1, (8, 327))
    spec = FaultSpec(noise_prob=1.0, seed=11)
    got = faults.LinkFaultInjector(spec, "zero_fill", 0).wire(w, 0, 0, dtype)
    diff = _bits(got) ^ _bits(w)
    if dtype == "int8":
        assert not diff[:, -4:].any()            # the packed scale
        diff = diff[:, :-4]
    assert diff.min() > 0 and diff.max() < 256
    assert ((diff & (diff - 1)) == 0).all()      # exactly one bit
    # at noise_prob 0.05 about one lane in twenty
    mild = faults.LinkFaultInjector(dataclasses.replace(
        spec, noise_prob=0.05), "zero_fill", 0).wire(w, 0, 0, dtype)
    share = float(((_bits(mild) ^ _bits(w)) != 0).mean())
    assert 0.02 < share < 0.09, share


def test_f32_wire_takes_no_noise():
    w = _wire("f32")
    inj = faults.LinkFaultInjector(FaultSpec(noise_prob=1.0), "zero_fill", 0)
    assert inj.wire(w, 0, 0, "f32") is w


@pytest.mark.parametrize("degradation", DEGRADATIONS)
def test_recv_drop_and_stale(degradation):
    tile = torch.full((2, 5), 3.0)
    carried = torch.full((2, 5), 7.0)
    drop = faults.LinkFaultInjector(FaultSpec(drop_prob=1.0), degradation, 0)
    out, new = drop.recv(tile, carried, 0, 0)
    want = carried if degradation == "hold_last" else torch.zeros_like(tile)
    assert torch.equal(out, want) and torch.equal(new, want)
    stale = faults.LinkFaultInjector(FaultSpec(stale_prob=1.0), degradation,
                                     0)
    out, new = stale.recv(tile, carried, 0, 0)
    assert torch.equal(out, carried) and torch.equal(new, carried)
    clean = faults.LinkFaultInjector(FaultSpec(noise_prob=0.5), degradation,
                                     0)
    out, new = clean.recv(tile, carried, 0, 0)
    assert out is tile and new is tile
    assert [float(t.abs().max()) for t in drop.init_carried([tile])] == [0.0]


def test_drop_rate_follows_the_probability():
    """Over 2000 (round, link) draws the drop share is p within 4 sigma,
    and the trace repeats for the same key."""
    inj = faults.LinkFaultInjector(FaultSpec(drop_prob=0.2, seed=5),
                                   "zero_fill", 1)
    tile = torch.ones(1, 3)
    trace = [bool(inj.recv(tile, tile, k, j)[0].sum() == 0)
             for k in range(1000) for j in range(2)]
    p = np.mean(trace)
    assert abs(p - 0.2) < 4 * np.sqrt(0.2 * 0.8 / 2000), p
    assert trace == [bool(inj.recv(tile, tile, k, j)[0].sum() == 0)
                     for k in range(1000) for j in range(2)]


# ---------------------------------------------------------------------------
# 8 ranks: tests/test_faults.py:130-242 on the port, and the ladder
# ---------------------------------------------------------------------------
def _banded_operator(n, bw, K, seed=0):
    """benchmarks/bench_comm.py's banded Laplacian (a numpy copy) and
    its first signal."""
    rng = np.random.default_rng(seed)
    Bm = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        Bm[i, lo:hi] = rng.standard_normal(hi - lo) * 0.1
    Bm = np.abs(Bm + Bm.T) / 2
    L = np.diag(Bm.sum(1)) - Bm
    x = rng.standard_normal((4, n)).astype(np.float32)
    op = GraphOperator(P=torch.tensor(L),
                       multipliers=[lambda lam: np.exp(-lam)],
                       lmax=float(2 * Bm.sum(1).max()), K=K)
    return op, x


def _general_operator(K):
    csr, meta = community_graph_csr(192, n_communities=8, seed=0)
    return GraphOperator(P=torch.tensor(csr.to_dense()),
                         multipliers=[lambda lam: np.exp(-lam)],
                         lmax=meta["lmax"], K=K)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.numpy().tobytes()).hexdigest()


def _plan_faults(op, x, kw):
    """One (backend, partition, wire)'s record of the fault payload."""
    out = {}
    base = op.plan(kw["backend"], device="cpu", partition=kw["partition"])
    clean = op.plan(kw["backend"], device="cpu", partition=kw["partition"],
                    exchange_dtype=kw["dt"])
    ref = clean.apply(x)
    out["f32_is_default"] = (kw["dt"] != "f32"
                             or torch.equal(base.apply(x), ref))
    out["null_specs"] = []
    for null in (None, FaultSpec(seed=99)):
        p0 = op.plan(kw["backend"], device="cpu", partition=kw["partition"],
                     exchange_dtype=kw["dt"], fault_spec=null,
                     degradation="hold_last")
        out["null_specs"].append([p0.info["fault_key"],
                                  torch.equal(p0.apply(x), ref)])

    def faulted(spec, degradation="zero_fill"):
        return op.plan(kw["backend"], device="cpu",
                       partition=kw["partition"], exchange_dtype=kw["dt"],
                       fault_spec=spec, degradation=degradation)

    runs = [faulted(SPEC).apply(x) for _ in range(2)]
    out["same_seed_same_bits"] = torch.equal(runs[0], runs[1])
    out["err"] = float((runs[0] - ref).abs().max())
    out["finite"] = bool(torch.isfinite(runs[0]).all())
    out["other_seed_differs"] = not torch.equal(
        faulted(OTHER_SEED).apply(x), runs[0])
    out["hold_last_differs"] = not torch.equal(
        faulted(SPEC, "hold_last").apply(x), runs[0])
    stc = plan_comm_stats(clean)["apply"]
    plan = faulted(SPEC)
    stf = plan_comm_stats(plan)["apply"]
    stb = plan_comm_stats(plan, batch=16)["apply"]
    out["rounds"] = [stc.exchange_rounds, stf.exchange_rounds,
                     stb.exchange_rounds]
    out["bytes_per_round"] = [stc.bytes_per_round, stf.bytes_per_round]
    out["fault_key"] = plan.info["fault_key"]
    out["digest"] = _digest(runs[0])
    solve = plan.solve(x, "jacobi", tau=TAU, n_iters=SOLVE_ITERS)
    out["solve_finite"] = bool(torch.isfinite(solve.x).all())
    return out


def _gossip_checks(rank, group):
    coeffs = gossip.consensus_coeffs(WORLD)
    xg = torch.arange(WORLD * 4, dtype=torch.float32).reshape(WORLD, 4) ** 1.1
    target = xg.mean(0)
    x = xg[rank]

    def run(spec, degradation="zero_fill", quantize=False):
        with comm.counting() as rec:
            y = gossip.gossip_mean(x, group, coeffs, quantize=quantize,
                                   fault_spec=spec, degradation=degradation)
        return y, rec.stats(WORLD).exchange_rounds

    clean, rounds = run(None)
    f1, f_rounds = run(SPEC)
    q1, _ = run(SPEC, quantize=True)
    mild, _ = run(MILD)
    return {
        "rounds": [rounds, f_rounds, len(coeffs) - 1],
        "clean_err": float((clean - target).abs().max()),
        "inactive_is_clean": torch.equal(run(FaultSpec())[0], clean),
        "faulted_same": torch.equal(f1, run(SPEC)[0]),
        "faulted_differs": not torch.equal(f1, clean),
        "faulted_finite": bool(torch.isfinite(f1).all()),
        "quantized_finite": bool(torch.isfinite(q1).all()),
        "quantized_differs": not torch.equal(q1, f1),
        "mild_err": float((mild - target).abs().max()),
        "target_max": float(target.abs().max()),
    }


def _rel(a, b) -> float:
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _ladder(op, x):
    """benchmarks/bench_faults.py's fault_ladder on `halo` at S = 8, the
    f32 and int8 wires, both policies, each p over LADDER_SEEDS seeds."""
    y = x[0]
    table = {}
    for dt in ("f32", "int8"):
        clean = op.plan("halo", device="cpu", exchange_dtype=dt)
        apply_ref = clean.apply(x)
        solve_ref = clean.solve(y, "jacobi", tau=TAU, n_iters=SOLVE_ITERS).x
        for degr in DEGRADATIONS:
            for p in PROBS:
                rows = []
                for seed in range(LADDER_SEEDS):
                    plan = op.plan("halo", device="cpu", exchange_dtype=dt,
                                   fault_spec=FaultSpec(drop_prob=p,
                                                        seed=seed),
                                   degradation=degr)
                    with comm.counting() as rec:
                        out = plan.apply(x)
                    res = plan.solve(y, "jacobi", tau=TAU,
                                     n_iters=SOLVE_ITERS,
                                     check_every=SOLVE_ITERS)
                    rows.append([_rel(out, apply_ref),
                                 _rel(res.x, solve_ref),
                                 rec.stats(WORLD).exchange_rounds,
                                 bool(torch.equal(out, apply_ref))])
                table[f"{dt}/{degr}/{p:g}"] = rows
    return table


def _rank_checks(rank):
    group = dist.group.WORLD
    banded, xb = _banded_operator(N_F, BW_F, K_F)
    general = _general_operator(K_F)
    xg = np.random.default_rng(1).standard_normal(192).astype(np.float32)
    out = {"rank": rank, "plans": {}}
    for name, op, x, part in (("banded", banded, xb[0], None),
                              ("general", general, xg, "general")):
        for backend in RING:
            for dt in ("f32", "int8"):
                out["plans"][f"{name}/{backend}/{dt}"] = _plan_faults(
                    op, x, dict(backend=backend, partition=part, dt=dt))
    out["gossip"] = _gossip_checks(rank, group)
    out["ladder"] = _ladder(banded, xb)
    return out


def _worker(rank, world, tmp):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        out = _rank_checks(rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("gloo8_faults")
    mp.spawn(_worker, args=(WORLD, str(tmp)), nprocs=WORLD, join=True)
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


PLAN_KEYS = [f"{name}/{backend}/{dt}" for name in ("banded", "general")
             for backend in RING for dt in ("f32", "int8")]


@pytest.mark.parametrize("key", PLAN_KEYS)
def test_inactive_spec_is_the_clean_plan_bitwise(ranks, key):
    for r in ranks:
        rec = r["plans"][key]
        assert rec["null_specs"] == [["none", True], ["none", True]]
        assert rec["f32_is_default"]


@pytest.mark.parametrize("key", PLAN_KEYS)
def test_same_seed_same_bits_other_seed_other_bits(ranks, key):
    for r in ranks:
        rec = r["plans"][key]
        assert rec["same_seed_same_bits"]
        assert rec["err"] > 0 and rec["finite"], rec["err"]
        assert rec["other_seed_differs"]
        assert rec["hold_last_differs"]
        assert rec["fault_key"] == faults.fault_key(SPEC)
        assert rec["solve_finite"]
    # the output is assembled: every rank holds the same faulted result
    assert len({r["plans"][key]["digest"] for r in ranks}) == 1


@pytest.mark.parametrize("key", PLAN_KEYS)
def test_faults_keep_the_schedule(ranks, key):
    """Rounds (B = 1 and B = 16) and bytes per round are the clean
    plan's: faults act on what was received."""
    for r in ranks:
        rec = r["plans"][key]
        assert rec["rounds"] == [K_F, K_F, K_F]
        assert rec["bytes_per_round"][0] == rec["bytes_per_round"][1]


def test_gossip_ring_under_faults(ranks):
    errs = [r["gossip"]["mild_err"] for r in ranks]
    tmax = ranks[0]["gossip"]["target_max"]
    for r in ranks:
        g = r["gossip"]
        # K = ceil(8/2) rounds per call, clean or faulted
        assert g["rounds"] == [4, 4, 4]
        assert g["clean_err"] < 1e-3 * tmax
        assert g["inactive_is_clean"] and g["faulted_same"]
        assert g["faulted_differs"] and g["faulted_finite"]
        assert g["quantized_finite"] and g["quantized_differs"]
    # degraded but bounded under the mild spec
    assert max(errs) / tmax < 1.0, max(errs) / tmax


def _mean(ranks, key, col):
    return float(np.mean([row[col] for row in ranks[0]["ladder"][key]]))


@pytest.mark.parametrize("dt", ["f32", "int8"])
@pytest.mark.parametrize("degradation", DEGRADATIONS)
def test_ladder_apply_error_rises_with_p(ranks, dt, degradation):
    means = [_mean(ranks, f"{dt}/{degradation}/{p:g}", 0) for p in PROBS]
    assert means[0] == 0.0
    assert all(a <= b for a, b in zip(means, means[1:])), means
    assert means[-1] > 0
    for r in ranks:
        for p in PROBS:
            rows = r["ladder"][f"{dt}/{degradation}/{p:g}"]
            assert all(row[2] == K_F for row in rows)
            if p == 0.0:
                assert all(row[3] for row in rows)


@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_ladder_hold_last_beats_zero_fill_on_the_solve(ranks, dt):
    hold = _mean(ranks, f"{dt}/hold_last/0.05", 1)
    zero = _mean(ranks, f"{dt}/zero_fill/0.05", 1)
    assert hold <= zero, (hold, zero)


def test_ladder_is_the_same_on_every_rank(ranks):
    assert all(r["ladder"] == ranks[0]["ladder"] for r in ranks)
