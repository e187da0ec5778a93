"""The port's sharded plans — backends 'halo', 'cuda_halo' and
'allgather' over a `torch.distributed` group — and their communication
count (`repro_torch.dist.comm`), held against the JAX package's dense
plan and against the closed forms of the paper's message accounting.

One spawn of 8 gloo ranks on the CPU (the counterpart of the 8 forced host
devices of tests/_subproc.py) runs every multi-rank check once; each rank
writes what it saw to a file, and the tests below read all eight.
``cuda_halo`` runs with ``device="cpu"``, i.e. through the kernels' plain
PyTorch versions.  The JAX package's own counter fails on this tree
(ROADMAP.md, "Where to hold the port"), so the counts are held to:

* the closed forms of tests/test_commstats.py:65-105 on the path graph
  (n = 64, K = 10, J = 2, 8 shards): K, K and 2K exchange rounds for
  apply, adjoint and Gram, exactly 2K|E| and 4K|E| paper messages,
  batch-invariant rounds at B = 4, and for the ring backends a halo
  width of 1, 8 bytes per round and 2 K S 4 bytes per apply; every byte
  model a plan states in its info is the counted total;
* BENCH_comm.json's f32 setup (n = 512, half-band 24, K = 20, 8 shards):
  20 rounds, 192 bytes per round, relative error against dense <= 1e-5
  (2.68e-7 tracked).

Outputs are held to the JAX package's plan("dense") within atol 1e-4, the
tolerance of the reference's own backend test (tests/test_backends.py:
58-67).  The JAX package is imported only inside the fixtures: the ranks
import this module to find their entry point and need none of it.
"""
import hashlib
import json
import os
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import wavelets as twav
from repro_torch.dist import (CommStats, GraphOperator, comm,
                              plan_comm_stats, solve_comm_stats,
                              verify_message_scaling)
from repro_torch.dist.backends.allgather import (
    dist_cheb_apply_adjoint_allgather, dist_cheb_apply_allgather,
    dist_cheb_apply_gram_allgather)
from repro_torch.dist.comm import CollectiveCall

WORLD = 8
SHARDED = ["halo", "cuda_halo", "allgather"]
RING = ["halo", "cuda_halo"]
N_PATH, K_PATH, J_PATH = 64, 10, 2
N_BENCH, BW_BENCH, K_BENCH = 512, 24, 20
TAU, MU, LASSO_ITERS = 0.5, [0.01, 0.5, 0.5], 10
OUTPUTS = ["apply", "apply_adjoint", "apply_gram", "solve_chebyshev",
           "solve_jacobi", "lasso_coeffs", "lasso_signal"]


def _banded_operator_P(n, bw, seed=0):
    """`benchmarks/bench_comm.py:128 _banded_operator` (a numpy copy):
    the Laplacian of a random symmetric band, its lmax and the signal."""
    rng = np.random.default_rng(seed)
    B = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        B[i, lo:hi] = rng.standard_normal(hi - lo) * 0.1
    B = np.abs(B + B.T) / 2
    L = np.diag(B.sum(1)) - B
    lmax = float(2 * B.sum(1).max())
    x = rng.standard_normal((4, n)).astype(np.float32)
    return L, lmax, x


def _path_op(setup):
    return GraphOperator(P=torch.tensor(setup["L"]),
                         multipliers=twav.sgwt_multipliers(setup["lmax"],
                                                           J=J_PATH),
                         lmax=setup["lmax"], K=K_PATH)


def _bench_op(setup):
    return GraphOperator(P=torch.tensor(setup["bench_L"]),
                         multipliers=[lambda lam: np.exp(-lam)],
                         lmax=setup["bench_lmax"], K=K_BENCH)


def _err(got, want) -> float:
    return float(np.abs(got.numpy() - want).max())


def _outputs(plan, setup):
    """Every output of the plan on the shared inputs, as numpy."""
    x, a, y = setup["x"], setup["a"], setup["y"]
    las = plan.solve_lasso(y, MU, gamma=setup["gamma"], n_iters=LASSO_ITERS)
    got = {
        "apply": plan.apply(x),
        "apply_adjoint": plan.apply_adjoint(a),
        "apply_gram": plan.apply_gram(x),
        "solve_chebyshev": plan.solve(y, "chebyshev", tau=TAU,
                                      n_iters=K_PATH).x,
        "solve_jacobi": plan.solve(y, "jacobi", tau=TAU, n_iters=30).x,
        "lasso_coeffs": las.coeffs,
        "lasso_signal": las.signal,
    }
    return got, las.fused


def _rank_checks(rank, setup):
    """What one rank sees of every sharded plan (JSON-able)."""
    out = {"rank": rank}
    op = _path_op(setup)
    E = setup["E"]
    for backend in SHARDED:
        plan = op.plan(backend, device="cpu")
        stats = plan_comm_stats(plan)
        scaling = verify_message_scaling(plan, E, batch=4)
        got, fused = _outputs(plan, setup)
        jac = solve_comm_stats(plan, "jacobi", tau=TAU, n_iters=30)
        res = plan.solve(setup["y"], "jacobi", tau=TAU, n_iters=30)
        out[backend] = {
            "info": {k: v for k, v in plan.info.items()
                     if isinstance(v, (int, float, str, type(None)))},
            "rounds": {k: s.exchange_rounds for k, s in stats.items()},
            "messages": {k: s.paper_messages(E) for k, s in stats.items()},
            "bytes_per_round": stats["apply"].bytes_per_round,
            "total_bytes": stats["apply"].total_bytes,
            "adjoint_total_bytes": stats["apply_adjoint"].total_bytes,
            "assembly_calls": sum(c.count for c in stats["apply"].assembly),
            "max_rel_dev": scaling["max_rel_dev"],
            "measured_batched": scaling["measured_batched"],
            "per_signal": scaling["per_signal_messages"],
            "solve_rounds": [jac.exchange_rounds,
                             res.info["exchange_rounds"]],
            "errors": {k: _err(v, setup["ref"][k]) for k, v in got.items()},
            "dtypes": sorted({str(v.dtype) for v in got.values()}),
            "shapes_ok": all(tuple(v.shape) == setup["ref"][k].shape
                             for k, v in got.items()),
            "lasso_fused": fused,
            "digest": hashlib.sha1(got["apply"].numpy().tobytes()
                                   ).hexdigest(),
        }
    bop = _bench_op(setup)
    ref, refmax = setup["bench_ref"], float(np.abs(setup["bench_ref"]).max())
    for backend in RING:
        plan = bop.plan(backend, device="cpu")
        st = plan_comm_stats(plan)["apply"]
        got = plan.apply(setup["bench_x"])
        out["bench_" + backend] = {
            "rounds": st.exchange_rounds,
            "bytes_per_round": st.bytes_per_round,
            "total_bytes": st.total_bytes,
            "halo_width": plan.info["halo_width"],
            "rel_err": _err(got, ref) / refmax,
        }
    # an unsorted sensor graph is not block-tridiagonal under 8 shards
    leaky = GraphOperator(P=torch.tensor(setup["leaky_L"]),
                          multipliers=twav.sgwt_multipliers(
                              setup["leaky_lmax"], J=J_PATH),
                          lmax=setup["leaky_lmax"], K=K_PATH)
    for backend in RING:
        try:
            leaky.plan(backend, device="cpu")
            raised = None
        except ValueError as exc:
            raised = str(exc)
        plan = leaky.plan(backend, device="cpu", allow_leak=True)
        out["leak_" + backend] = {"raised": raised,
                                  "leak": plan.info["partition_leak"]}
    plan = leaky.plan("allgather", device="cpu")
    out["leaky_allgather_err"] = _err(plan.apply(setup["leaky_x"]),
                                      setup["leaky_ref"])
    # the free functions of the allgather backend on this rank's rows
    nl = N_PATH // WORLD
    rows = torch.tensor(setup["L"][rank * nl:(rank + 1) * nl])
    group = dist.group.WORLD
    x, a = torch.tensor(setup["x"]), torch.tensor(setup["a"])
    out["allgather_free_errors"] = [
        _err(dist_cheb_apply_allgather(group, rank, rows, x, op.coeffs,
                                       op.lmax), setup["ref"]["apply"]),
        _err(dist_cheb_apply_adjoint_allgather(group, rank, rows, a,
                                               op.coeffs, op.lmax),
             setup["ref"]["apply_adjoint"]),
        _err(dist_cheb_apply_gram_allgather(group, rank, rows, x, op.coeffs,
                                            op.lmax),
             setup["ref"]["apply_gram"])]
    return out


def _worker(rank, world, tmp, setup):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        out = _rank_checks(rank, setup)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def setup(sensor120):
    """The shared inputs and the JAX package's dense outputs on them."""
    import jax.numpy as jnp

    from repro.core import graph as jgraph
    from repro.core import lasso as jlasso
    from repro.core import wavelets as jwav
    from repro.dist import GraphOperator as JOp

    g = jgraph.path_graph(N_PATH)
    lmax = g.lambda_max_bound()
    L = np.asarray(g.laplacian())
    jop = JOp(P=jnp.asarray(L),
              multipliers=jwav.sgwt_multipliers(lmax, J=J_PATH),
              lmax=lmax, K=K_PATH)
    rs = np.random.RandomState(0)
    x = rs.randn(4, N_PATH).astype(np.float32)
    a = rs.randn(4, J_PATH + 1, N_PATH).astype(np.float32)
    y = rs.randn(3, N_PATH).astype(np.float32)
    gamma = float(jlasso.ista_step_size(jop))
    dense = jop.plan("dense")
    las = dense.solve_lasso(jnp.asarray(y), jnp.asarray(MU), gamma=gamma,
                            n_iters=LASSO_ITERS)
    ref = {
        "apply": dense.apply(jnp.asarray(x)),
        "apply_adjoint": dense.apply_adjoint(jnp.asarray(a)),
        "apply_gram": dense.apply_gram(jnp.asarray(x)),
        "solve_chebyshev": dense.solve(jnp.asarray(y), "chebyshev", tau=TAU,
                                       n_iters=K_PATH).x,
        "solve_jacobi": dense.solve(jnp.asarray(y), "jacobi", tau=TAU,
                                    n_iters=30).x,
        "lasso_coeffs": las.coeffs,
        "lasso_signal": las.signal,
    }
    bL, blmax, bx = _banded_operator_P(N_BENCH, BW_BENCH)
    bop = JOp(P=jnp.asarray(bL), multipliers=[lambda lam: jnp.exp(-lam)],
              lmax=blmax, K=K_BENCH)
    llmax = sensor120.lambda_max_bound()
    lL = np.asarray(sensor120.laplacian())
    lop = JOp(P=jnp.asarray(lL),
              multipliers=jwav.sgwt_multipliers(llmax, J=J_PATH),
              lmax=llmax, K=K_PATH)
    lx = rs.randn(2, lL.shape[0]).astype(np.float32)
    return {
        "L": L, "lmax": float(lmax), "E": int(g.n_edges), "x": x, "a": a,
        "y": y, "gamma": gamma,
        "ref": {k: np.asarray(v) for k, v in ref.items()},
        "bench_L": bL, "bench_lmax": blmax, "bench_x": bx,
        "bench_ref": np.asarray(bop.plan("dense").apply(jnp.asarray(bx))),
        "leaky_L": lL, "leaky_lmax": float(llmax), "leaky_x": lx,
        "leaky_ref": np.asarray(lop.plan("dense").apply(jnp.asarray(lx))),
    }


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Spawn the 8 gloo ranks once; every rank's record."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("gloo8")
    mp.spawn(_worker, args=(WORLD, str(tmp), setup), nprocs=WORLD,
             join=True)
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


# ---------------------------------------------------------------------------
# 8 ranks: the closed forms of tests/test_commstats.py:65-105
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", SHARDED)
def test_rounds_and_messages_closed_form(ranks, setup, backend):
    K, E = K_PATH, setup["E"]
    assert E == N_PATH - 1
    for r in ranks:
        rec = r[backend]
        assert rec["rounds"] == {"apply": K, "apply_adjoint": K,
                                 "apply_gram": 2 * K}
        assert rec["messages"] == {"apply": 2 * K * E,
                                   "apply_adjoint": 2 * K * E,
                                   "apply_gram": 4 * K * E}
        assert rec["info"]["n_shards"] == WORLD


@pytest.mark.parametrize("backend", SHARDED)
def test_message_scaling_exact_and_batch_invariant(ranks, setup, backend):
    K, E = K_PATH, setup["E"]
    for r in ranks:
        rec = r[backend]
        assert rec["max_rel_dev"] == 0.0
        assert rec["measured_batched"] == rec["messages"]
        assert rec["per_signal"]["apply"] == 2 * K * E / 4


@pytest.mark.parametrize("backend", RING)
def test_ring_bytes_halo_width_one(ranks, backend):
    K, S = K_PATH, WORLD
    for r in ranks:
        rec = r[backend]
        assert rec["info"]["halo_width"] == 1
        assert rec["total_bytes"] == 2 * K * S * 1 * 4
        assert rec["total_bytes"] == rec["info"]["halo_bytes_per_apply"]
        assert rec["bytes_per_round"] == 2 * 1 * 4
        assert rec["info"]["exchange_collectives_per_round"] == 2


@pytest.mark.parametrize("backend", SHARDED)
def test_byte_models_are_the_counted_bytes(ranks, backend):
    """What plan.info says an apply and an adjoint send, over all shards,
    is what the counter tallied: the (..., h) tiles both ways per order
    for the ring backends (eta streams in the adjoint), the (nl,) iterate
    per order and shard for allgather."""
    K, S, eta = K_PATH, WORLD, J_PATH + 1
    for r in ranks:
        rec = r[backend]
        if backend == "allgather":
            assert rec["total_bytes"] == K * N_PATH * 4
            assert rec["total_bytes"] == rec["info"]["gather_bytes_per_apply"]
        else:
            assert rec["adjoint_total_bytes"] == 2 * K * S * eta * 1 * 4
            assert (rec["adjoint_total_bytes"]
                    == rec["info"]["halo_bytes_per_adjoint"])


@pytest.mark.parametrize("backend", SHARDED)
def test_assembly_kept_out_of_the_count(ranks, backend):
    """One gather of the output rows per call, beside the rounds."""
    for r in ranks:
        assert r[backend]["assembly_calls"] == 1


@pytest.mark.parametrize("backend", RING)
def test_bench_comm_f32_setup(ranks, backend):
    for r in ranks:
        rec = r["bench_" + backend]
        assert rec["halo_width"] == BW_BENCH
        assert rec["rounds"] == K_BENCH
        assert rec["bytes_per_round"] == 192.0
        assert rec["total_bytes"] == 30720
        assert rec["rel_err"] <= 1e-5


@pytest.mark.parametrize("kind", OUTPUTS)
@pytest.mark.parametrize("backend", SHARDED)
def test_outputs_match_reference_dense(ranks, backend, kind):
    for r in ranks:
        rec = r[backend]
        assert rec["errors"][kind] <= 1e-4, (r["rank"], rec["errors"])
        assert rec["dtypes"] == ["torch.float32"] and rec["shapes_ok"]


@pytest.mark.parametrize("backend", SHARDED)
def test_every_rank_gets_the_same_result(ranks, backend):
    assert len({r[backend]["digest"] for r in ranks}) == 1
    assert all(r[backend]["lasso_fused"] for r in ranks)
    assert [r[backend]["info"]["rank"] for r in ranks] == list(range(WORLD))
    assert {r[backend]["info"]["transport"] for r in ranks} == {"gloo"}


@pytest.mark.parametrize("backend", SHARDED)
def test_solve_rounds_match_closed_form(ranks, backend):
    """A Jacobi solve on den(P) = tau + P: one round per iteration."""
    for r in ranks:
        counted, closed = r[backend]["solve_rounds"]
        assert counted == closed == 30


@pytest.mark.parametrize("backend", RING)
def test_leaky_P_raises_unless_allowed(ranks, backend):
    for r in ranks:
        rec = r["leak_" + backend]
        assert rec["raised"] is not None and "leak=" in rec["raised"]
        assert rec["leak"] > 1e-3


def test_allgather_exact_on_a_leaky_P(ranks):
    for r in ranks:
        assert r["leaky_allgather_err"] <= 1e-4


def test_allgather_free_functions(ranks):
    """dist_cheb_apply{,_adjoint,_gram}_allgather on each rank's rows of
    P and the global signal."""
    for r in ranks:
        assert max(r["allgather_free_errors"]) <= 1e-4


# ---------------------------------------------------------------------------
# One process: the 1-shard plan, the options of later slices, CommStats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["apply", "apply_adjoint", "apply_gram",
                                  "solve_jacobi", "solve_lasso"])
def test_one_shard_plan_equals_cuda_plan(setup, kind):
    """World size 1, no group: cuda_halo's plan is the cuda plan's
    sweeps on the same Block-ELL."""
    assert not dist.is_initialized()
    op = _path_op(setup)
    one = op.plan("cuda_halo", device="cpu")
    cuda = op.plan("cuda", device="cpu")
    assert one.info["n_shards"] == 1 and one.info["transport"] is None
    assert torch.equal(one.info["block_ell"].blocks,
                       cuda.info["block_ell"].blocks)
    x, a, y = setup["x"], setup["a"], setup["y"]
    if kind == "apply":
        assert torch.equal(one.apply(x), cuda.apply(x))
    elif kind == "apply_adjoint":
        assert torch.equal(one.apply_adjoint(a), cuda.apply_adjoint(a))
    elif kind == "apply_gram":
        assert torch.equal(one.apply_gram(x), cuda.apply_gram(x))
    elif kind == "solve_jacobi":
        assert torch.equal(one.solve(y, "jacobi", tau=TAU).x,
                           cuda.solve(y, "jacobi", tau=TAU).x)
    else:
        got = one.solve_lasso(y, MU, gamma=setup["gamma"],
                              n_iters=LASSO_ITERS)
        assert got.fused
        np.testing.assert_allclose(got.coeffs.numpy(),
                                   setup["ref"]["lasso_coeffs"], atol=1e-4)


@pytest.mark.parametrize("backend", SHARDED)
def test_one_shard_plans_send_nothing(setup, backend):
    plan = _path_op(setup).plan(backend, device="cpu")
    stats = plan_comm_stats(plan, batch=2)
    for s in stats.values():
        assert s.n_collectives == 0 and s.exchange_rounds == 0
        assert s.total_bytes == 0 and s.assembly == ()
    np.testing.assert_allclose(plan.apply(setup["x"]).numpy(),
                               setup["ref"]["apply"], atol=1e-4)


@pytest.mark.parametrize("option", [
    dict(exchange_dtype="int8"), dict(exchange_dtype="bf16"),
    dict(fault_spec={"p": 0.05}),
    dict(partition="general", exchange_dtype="int8")])
@pytest.mark.parametrize("backend", SHARDED)
def test_later_slices_raise_not_implemented(setup, backend, option):
    # the compressed exchange and the faults are ported
    # (tests/test_torch_quantize.py, tests/test_torch_faults.py): the ring
    # backends take the wire options (inert on one shard), allgather
    # refuses them, and a malformed spec raises TypeError as in the JAX
    # package (no NotImplementedError is left)
    op = _path_op(setup)
    if "fault_spec" in option:
        with pytest.raises(TypeError):
            op.plan(backend, device="cpu", **option)
    elif backend == "allgather":
        with pytest.raises(ValueError, match="no compressed exchange"):
            op.plan(backend, device="cpu", **option)
    else:
        plan = op.plan(backend, device="cpu", **option)
        assert plan.info["exchange_dtype"] == option["exchange_dtype"]
        np.testing.assert_allclose(plan.apply(setup["x"]).numpy(),
                                   setup["ref"]["apply"], atol=1e-4)


@pytest.mark.parametrize("option", [dict(sweep_dtype="bf16"),
                                    dict(l2_budget=1 << 20),
                                    dict(block=(8, 8))])
def test_cuda_halo_takes_no_single_device_options(setup, option):
    """The sweep and block settings of plan("cuda") are refused, not
    ignored; another column block comes in through partition=."""
    with pytest.raises(TypeError, match="takes no options"):
        _path_op(setup).plan("cuda_halo", device="cpu", **option)


def test_precomputed_partitions(setup):
    """partition= takes the backend's own precomputed partition for the
    plan's shard count, and nothing else."""
    from repro_torch.dist.backends.cuda_halo import partition_block_ell
    from repro_torch.dist.backends.halo import partition_banded

    op = _path_op(setup)
    banded, _ = partition_banded(setup["L"], 1)
    blocked, _ = partition_block_ell(setup["L"], 1)
    for backend, parts in (("halo", banded), ("cuda_halo", blocked)):
        plan = op.plan(backend, device="cpu", partition=parts)
        np.testing.assert_allclose(plan.apply(setup["x"]).numpy(),
                                   setup["ref"]["apply"], atol=1e-4)
    with pytest.raises(TypeError, match="ShardedBlockELL"):
        op.plan("cuda_halo", device="cpu", partition=banded)
    with pytest.raises(TypeError, match="BandedPartition"):
        op.plan("halo", device="cpu", partition=blocked)
    with pytest.raises(ValueError, match="2 shards"):
        op.plan("halo", device="cpu",
                partition=partition_banded(setup["L"], 2)[0])


def test_no_card_no_default_device(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    for backend in SHARDED:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _path_op(setup).plan(backend)


def test_mesh_must_be_a_process_group(setup):
    with pytest.raises(TypeError, match="process group"):
        _path_op(setup).plan("halo", device="cpu", mesh="graph")
    assert comm.resolve_group(None) == (None, 1, 0)


def test_comm_stats_closed_form_arithmetic():
    """rounds x 2|E| (tests/test_commstats.py:55 on the port's data
    model); at two shards both directions share one perm and still make
    one round, declared or not (the ring exchange counts both), and the
    assembly calls stay out of rounds and bytes."""
    perm = ((0, 1), (1, 0))
    stats = CommStats(
        collectives=(CollectiveCall("ppermute", count=20, elems=4,
                                    nbytes=16),),
        n_shards=8,
        assembly=(CollectiveCall("assembly", count=1, elems=64,
                                 nbytes=256),))
    assert stats.exchange_rounds == 10
    assert stats.paper_messages(63) == 10 * 2 * 63
    assert stats.total_bytes == 20 * 16 * 8
    two = CommStats(collectives=(
        CollectiveCall("ppermute", 10, 1, 4, perm),
        CollectiveCall("ppermute", 10, 1, 4, perm)), n_shards=2,
        ppermutes_per_round=2)
    assert two.exchange_rounds == 10 and two.bytes_per_round == 8.0
    undeclared = CommStats(collectives=two.collectives, n_shards=2)
    assert undeclared.ppermutes_per_round == comm.DIRECTIONS_PER_ROUND
    assert undeclared.exchange_rounds == 10
    assert stats.summary()["assembly"][0]["nbytes"] == 256


def test_counting_nests_and_resets():
    with comm.counting() as outer:
        with comm.counting() as inner:
            comm._record("all_gather", torch.zeros(3))
        comm._record("all_gather", torch.zeros(3))
    assert sum(inner.tally.values()) == 1 and sum(outer.tally.values()) == 2
    assert comm._recorders == []
    st = outer.stats(n_shards=4)
    assert st.exchange_rounds == 2 and st.bytes_per_shard == 24
