"""The port's general partitions (`repro_torch.dist.partition`) and the
general plans of the ring backends 'halo' and 'cuda_halo', held against
the JAX package's `repro.dist.partition` and its dense plan.

* The partitioner keeps the JAX package's numpy logic, so the community
  graph, the edge-cut orders (bfs, spectral) and every field of a
  `GeneralPartition` are held equal exactly, fingerprint included; the
  reassembled P within 1e-6 (tests/test_property.py:292-355).
* One spawn of 8 gloo ranks on the CPU (as in tests/test_torch_sharded.py)
  runs the setup of tests/test_backends.py:270 (community graph n = 256,
  8 communities, seed 5, SGWT J = 3, K = 12, (8, 8) blocks, more than two
  ring offsets): outputs within 1e-4 of the JAX dense plan (that test's
  tolerance), K / K / 2K counted rounds and 2K|E| / 4K|E| paper
  messages exactly, batch-invariant rounds, and counted bytes equal to
  the partition's byte model.  The same spawn checks the tiles that 2-
  and 3-rank groups exchange.
* ``cuda_halo`` runs with ``device="cpu"``, i.e. through the kernels'
  plain PyTorch versions (the card-only tests hold the kernels).

The JAX package is imported only inside the fixtures: the ranks import
this module to find their entry point and need none of it.
"""
import hashlib
import json
import os
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import graph as tgraph
from repro_torch.core import wavelets as twav
from repro_torch.dist import (GraphOperator, comm, plan_comm_stats,
                              solve_comm_stats, verify_message_scaling)
from repro_torch.dist import partition as tpm
from repro_torch.dist.backends.halo import partition_banded
from repro_torch.dist.sharded import coupling_layout
from repro_torch.kernels.bcsr_spmv import (sliced_ell_spmv_accumulate,
                                           sliced_ell_spmv_plain)

WORLD = 8
RING = ["halo", "cuda_halo"]
N_GEN, COMM_GEN, SEED_GEN = 256, 8, 5
K_GEN, J_GEN, BLOCK_GEN, B_GEN = 12, 3, (8, 8), 64
TAU = 0.5
OUTPUTS = ["apply", "apply_adjoint", "apply_gram", "apply_batched",
           "solve_jacobi", "apply_string_form"]
# the tiles of a 2-rank group (the banded plan's offsets at two shards)
# and of a 3-rank group
SUBGROUPS = {2: ((0, 1), (1, 1)), 3: ((2, 3, 4), (1, 2))}


def _general_csr():
    return tpm.community_graph_csr(N_GEN, n_communities=COMM_GEN,
                                   seed=SEED_GEN)


def _general_op(csr, lmax):
    return GraphOperator(P=torch.tensor(csr.to_dense()),
                         multipliers=twav.sgwt_multipliers(lmax, J=J_GEN),
                         lmax=lmax, K=K_GEN)


def _err(got, want) -> float:
    return float(np.abs(got.numpy() - want).max())


def _subgroup_exchange(rank):
    """Every rank creates both subgroups (new_group is collective); the
    members exchange tiles whose values name their sender and offset
    index, and report whether each tile came from rank s - d."""
    out = {}
    for size, (members, offsets) in SUBGROUPS.items():
        group = dist.new_group(list(members))
        if rank not in members:
            continue
        s = members.index(rank)
        tiles = [torch.full((2, 3 + k), 100.0 * s + k)
                 for k in range(len(offsets))]
        with comm.counting() as rec:
            got = comm.offset_exchange(tiles, offsets, group).wait()
        out[str(size)] = {
            "ok": all(tuple(t.shape) == (2, 3 + k)
                      and bool((t == 100.0 * ((s - d) % size) + k).all())
                      for k, (t, d) in enumerate(zip(got, offsets))),
            "ppermutes": sum(rec.tally.values()),
        }
    return out


def _rank_checks(rank, setup):
    """What one rank sees of the general plans (JSON-able)."""
    csr, meta = _general_csr()
    E = csr.n_edges
    op = _general_op(csr, meta["lmax"])
    parts = tpm.partition_general(csr, WORLD, block=BLOCK_GEN)
    out = {"rank": rank, "offsets": list(parts.offsets),
           "wire_bytes_per_round": parts.wire_bytes_per_round(),
           "bytes_per_apply": tpm.general_bytes_per_apply(parts, K_GEN),
           "bytes_per_adjoint": tpm.general_bytes_per_apply(
               parts, K_GEN, J_GEN + 1)}
    ref = setup["ref"]
    for backend in RING:
        plan = op.plan(backend, device="cpu", partition=parts)
        stats = plan_comm_stats(plan)
        scaling = verify_message_scaling(plan, E, batch=B_GEN)
        res = plan.solve(setup["f"], "jacobi", tau=TAU)
        jac = solve_comm_stats(plan, "jacobi", tau=TAU)
        got = {
            "apply": plan.apply(setup["f"]),
            "apply_adjoint": plan.apply_adjoint(setup["a"]),
            "apply_gram": plan.apply_gram(setup["f"]),
            "apply_batched": plan.apply(setup["F"]),
            "solve_jacobi": res.x,
            "apply_string_form": op.plan(backend, device="cpu",
                                         partition="general").apply(
                                             setup["f"]),
        }
        out[backend] = {
            "info": {k: (list(v) if isinstance(v, tuple) else v)
                     for k, v in plan.info.items()
                     if isinstance(v, (int, float, str, tuple, type(None)))},
            "rounds": {k: s.exchange_rounds for k, s in stats.items()},
            "messages": {k: s.paper_messages(E) for k, s in stats.items()},
            "bytes_per_round": stats["apply"].bytes_per_round,
            "total_bytes": stats["apply"].total_bytes,
            "adjoint_total_bytes": stats["apply_adjoint"].total_bytes,
            "ppermutes_per_round": sorted(
                {c.perm[0][1] for c in stats["apply"].collectives}),
            "max_rel_dev": scaling["max_rel_dev"],
            "measured_batched": scaling["measured_batched"],
            "per_signal": scaling["per_signal_messages"],
            "solve_rounds": [jac.exchange_rounds,
                             res.info["exchange_rounds"]],
            "errors": {k: _err(v, ref[k]) for k, v in got.items()},
            "shapes_ok": all(tuple(v.shape) == ref[k].shape
                             for k, v in got.items()),
            "digest": hashlib.sha1(got["apply_batched"].numpy().tobytes()
                                   ).hexdigest(),
        }
    out["subgroups"] = _subgroup_exchange(rank)
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
def setup():
    """The shared inputs and the JAX package's dense outputs on them."""
    import jax.numpy as jnp

    from repro.core import wavelets as jwav
    from repro.dist import GraphOperator as JOp
    from repro.dist import partition as jpm

    csr, meta = jpm.community_graph_csr(N_GEN, n_communities=COMM_GEN,
                                        seed=SEED_GEN)
    jop = JOp(P=csr.to_dense(),
              multipliers=jwav.sgwt_multipliers(meta["lmax"], J=J_GEN),
              lmax=meta["lmax"], K=K_GEN)
    rs = np.random.RandomState(0)
    f = rs.randn(N_GEN).astype(np.float32)
    a = rs.randn(J_GEN + 1, N_GEN).astype(np.float32)
    F = rs.randn(B_GEN, N_GEN).astype(np.float32)
    dense = jop.plan("dense")
    ref = {
        "apply": dense.apply(jnp.asarray(f)),
        "apply_adjoint": dense.apply_adjoint(jnp.asarray(a)),
        "apply_gram": dense.apply_gram(jnp.asarray(f)),
        "apply_batched": dense.apply(jnp.asarray(F)),
        "solve_jacobi": dense.solve(jnp.asarray(f), "jacobi", tau=TAU).x,
    }
    ref["apply_string_form"] = ref["apply"]
    return {"f": f, "a": a, "F": F, "E": int(csr.n_edges),
            "ref": {k: np.asarray(v) for k, v in ref.items()}}


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Spawn the 8 gloo ranks once; every rank's record."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("gloo8_general")
    mp.spawn(_worker, args=(WORLD, str(tmp), setup), nprocs=WORLD,
             join=True)
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


# ---------------------------------------------------------------------------
# The partitioner: equal to the JAX package's, exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,n_comm,seed", [(256, 8, 5), (10000, None, 0)])
def test_community_graph_csr_equals_jax(n, n_comm, seed):
    from repro.dist import partition as jpm

    got, gmeta = tpm.community_graph_csr(n, n_communities=n_comm, seed=seed)
    want, wmeta = jpm.community_graph_csr(n, n_communities=n_comm, seed=seed)
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert gmeta == wmeta
    assert got.n_edges == want.n_edges and got.nnz == want.nnz


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("method", ["bfs", "spectral"])
@pytest.mark.parametrize("n", [256, 10000])
def test_edge_cut_order_equals_jax(n, method, shards):
    from repro.dist import partition as jpm

    n_comm = COMM_GEN if n == N_GEN else None
    csr, _ = tpm.community_graph_csr(n, n_communities=n_comm, seed=SEED_GEN)
    jcsr, _ = jpm.community_graph_csr(n, n_communities=n_comm,
                                      seed=SEED_GEN)
    np.testing.assert_array_equal(
        tpm.edge_cut_order(csr, shards, method=method, seed=3),
        jpm.edge_cut_order(jcsr, shards, method=method, seed=3))


@pytest.mark.parametrize("rows,cols", [(8, 16), (3, 5), (1, 4), (2, 2)])
def test_torus_graph_equals_jax(rows, cols):
    from repro.core import graph as jgraph

    np.testing.assert_array_equal(
        tgraph.torus_graph(rows, cols, 0.5).W.numpy(),
        np.asarray(jgraph.torus_graph(rows, cols, 0.5).W))


def _assert_partitions_equal(got, want):
    np.testing.assert_array_equal(got.order, want.order)
    assert got.offsets == want.offsets
    assert got.send_counts == want.send_counts
    assert (got.n, got.n_local, got.edge_cut, got.method) == (
        want.n, want.n_local, want.edge_cut, want.method)
    for field in ("blocks", "indices", "mask"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    for field in ("send_idx", "cpl_rows", "cpl_cols", "cpl_vals"):
        g, w = getattr(got, field), getattr(want, field)
        assert len(g) == len(w)
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert got.tile_widths == want.tile_widths
    assert got.fingerprint == want.fingerprint


@pytest.mark.parametrize("block", [(4, 4), (8, 8), (8, 128)])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("method", ["bfs", "spectral", "precomputed"])
def test_partition_general_equals_jax(method, shards, block):
    from repro.dist import partition as jpm

    csr, _ = _general_csr()
    jcsr, _ = jpm.community_graph_csr(N_GEN, n_communities=COMM_GEN,
                                      seed=SEED_GEN)
    kw = dict(block=block, seed=2)
    if method == "precomputed":
        kw["order"] = np.random.default_rng(shards).permutation(N_GEN)
    else:
        kw["method"] = method
    got = tpm.partition_general(csr, shards, **kw)
    want = jpm.partition_general(jcsr, shards, **kw)
    _assert_partitions_equal(got, want)
    assert got.method == method


def test_partition_general_from_dense_equals_jax():
    """A dense P (numpy or torch) goes through the same CSR."""
    from repro.dist import partition as jpm

    csr, _ = _general_csr()
    P = csr.to_dense()
    want = jpm.partition_general(P, 4, block=(8, 8))
    _assert_partitions_equal(tpm.partition_general(P, 4, block=(8, 8)),
                             want)
    _assert_partitions_equal(
        tpm.partition_general(torch.from_numpy(P), 4, block=(8, 8)), want)


def _random_sparse_laplacian(seed: int, n: int) -> np.ndarray:
    """tests/test_property.py's random sparse Laplacian, in numpy."""
    rng = np.random.RandomState(seed)
    m = max(n, int(1.8 * n))
    rows = rng.randint(0, n, m)
    cols = rng.randint(0, n, m)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    W = np.zeros((n, n), np.float32)
    W[rows, cols] = rng.uniform(0.5, 1.5, rows.size).astype(np.float32)
    W = np.maximum(W, W.T)
    return tgraph.laplacian(W).numpy()


PROPERTY_CASES = [(0, 12, 1, "bfs"), (1, 40, 2, "spectral"),
                  (7, 96, 3, "bfs"), (11, 64, 4, "spectral"),
                  (23, 50, 8, "bfs"), (42, 96, 8, "spectral"),
                  (99, 33, 3, "spectral"), (150, 80, 4, "bfs"),
                  (200, 17, 2, "bfs")]


@pytest.mark.parametrize("seed,n,shards,method", PROPERTY_CASES)
def test_partition_covers_every_edge_exactly_once(seed, n, shards, method):
    """Reassembling interior blocks + exchange plan reproduces P: a
    dropped edge would show as a zero, a double-covered one as a doubled
    weight."""
    L = _random_sparse_laplacian(seed, n)
    parts = tpm.partition_general(L, shards, method=method, block=(4, 4))
    np.testing.assert_allclose(tpm.partition_to_dense(parts), L, atol=1e-6)


@pytest.mark.parametrize("seed,n,shards,method", [
    c for c in PROPERTY_CASES if c[2] > 1])
def test_exchange_plan_symmetric_and_indexes_real_slots(seed, n, shards,
                                                        method):
    """Offsets are closed under d <-> S - d (P is symmetric: i sends to j
    iff j sends back), and every coupling reads a real (unpadded) row of
    the tile it receives."""
    L = _random_sparse_laplacian(seed, n)
    parts = tpm.partition_general(L, shards, method=method, block=(4, 4))
    S = parts.n_shards
    offs = set(parts.offsets)
    assert offs == {(S - d) % S for d in offs}
    assert all(0 < d < S for d in offs)
    for k, d in enumerate(parts.offsets):
        cnt = np.asarray(parts.send_counts[k])
        snd = (np.arange(S) - d) % S
        cols = parts.cpl_cols[k].numpy()
        real = parts.cpl_vals[k].numpy() != 0
        assert np.all(cols[real] < cnt[snd][np.nonzero(real)[0]])


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_banded_graph_reduces_to_ring_plan(shards):
    """A path graph under the identity order: offsets {1, S-1} only, and
    the banded partition's h."""
    n = shards * 8
    L = tgraph.path_graph(n).laplacian().numpy()
    parts = tpm.partition_general(L, shards, order=np.arange(n),
                                  block=(4, 4))
    assert set(parts.offsets) <= {1, (shards - 1) % shards}
    banded, leak = partition_banded(L, shards)
    assert leak < 1e-8
    assert parts.halo == banded.halo
    np.testing.assert_allclose(tpm.partition_to_dense(parts), L, atol=1e-6)


def test_partition_general_overfull_raises():
    """tests/test_partition.py:82: a star graph's hub row block couples
    every column block; with max_slots=1 the packer refuses."""
    n = 64
    W = np.zeros((n, n), np.float32)
    W[0, 1:] = 1.0
    W[1:, 0] = 1.0
    L = tgraph.laplacian(W).numpy()
    with pytest.raises(tpm.OverfullSlotsError):
        tpm.partition_general(L, 1, block=(8, 8), max_slots=1,
                              order=np.arange(n))
    parts = tpm.partition_general(L, 1, block=(8, 8), max_slots=8,
                                  order=np.arange(n))
    np.testing.assert_allclose(tpm.partition_to_dense(parts), L, atol=1e-6)


def test_partition_orders_and_byte_model():
    csr, _ = _general_csr()
    parts = tpm.partition_general(csr, 8, block=BLOCK_GEN)
    x = torch.arange(3 * N_GEN, dtype=torch.float32).reshape(3, N_GEN)
    px = parts.to_partition_order(x)
    assert torch.equal(px, x[:, torch.from_numpy(parts.order)])
    assert torch.equal(parts.from_partition_order(px), x)
    assert parts.wire_bytes_per_round() == 4 * sum(parts.tile_widths)
    assert (tpm.general_bytes_per_apply(parts, 12, 4)
            == 12 * 8 * 4 * 4 * sum(parts.tile_widths))
    # the compressed wires: 2 bytes per row entry (bf16), 1 + 4 per row
    # of every offset's tile (int8, the packed scale)
    assert parts.wire_bytes_per_round("bf16") == 2 * sum(parts.tile_widths)
    assert parts.wire_bytes_per_round("int8") == sum(
        h + 4 for h in parts.tile_widths)
    assert (tpm.general_bytes_per_apply(parts, 12, 4, "int8")
            == 12 * 8 * 4 * parts.wire_bytes_per_round("int8"))
    with pytest.raises(ValueError):
        parts.wire_bytes_per_round("f16")
    assert tuple(parts.dense_diag().shape) == (8, parts.n_local,
                                              parts.n_local)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_matvec_fn_matches_dense(dtype):
    """The callable P of a CSR matrix: x's dtype, any leading dims."""
    csr, _ = _general_csr()
    P = torch.from_numpy(csr.to_dense()).to(dtype)
    mv = tpm.csr_matvec_fn(tpm.CSRMatrix(csr.indptr, csr.indices,
                                         csr.data.astype(np.float64)))
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, N_GEN)).to(
        dtype)
    got = mv(x)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got, x @ P.T, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The couplings: one rectangular sliced-ELL matrix per rank
# ---------------------------------------------------------------------------
def test_rectangular_accumulating_plain_matches_dense():
    """sliced_ell_spmv_plain on a rectangular layout (rows != columns),
    with out= accumulating, is y + C x of the dense C."""
    rng = np.random.RandomState(4)
    C = np.zeros((70, 23), np.float32)
    r, c = rng.randint(0, 70, 90), rng.randint(0, 23, 90)
    C[r, c] = rng.randn(90).astype(np.float32)
    C[:, 5] = 0.0                      # an empty column
    C[40:64] = 0.0                     # empty slices
    rows, cols = np.nonzero(C)
    S = tgraph.sliced_ell_from_coo(torch.from_numpy(rows),
                                   torch.from_numpy(cols),
                                   torch.from_numpy(C[rows, cols]), 70, 72,
                                   n_cols=23)
    assert S.x_len == 23 and S.padded_n == 72 and S.nnz == rows.size
    assert int(S.columns.max()) < 23
    x = torch.from_numpy(rng.randn(2, 3, 23).astype(np.float32))
    y0 = torch.from_numpy(rng.randn(2, 3, 72).astype(np.float32))
    want = y0.clone()
    want[..., :70] += x @ torch.from_numpy(C).T
    got = sliced_ell_spmv_plain(S, x, out=y0.clone())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(sliced_ell_spmv_plain(S, x), want - y0,
                               atol=1e-5, rtol=1e-5)
    before = sliced_ell_spmv_accumulate.launches
    y = y0.clone()
    assert sliced_ell_spmv_accumulate(S, x, y) is y
    assert torch.equal(y, got)
    assert sliced_ell_spmv_accumulate.launches == before
    with pytest.raises(ValueError, match="23 columns"):
        sliced_ell_spmv_plain(S, y0)


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_coupling_layout_is_the_jax_scatter(shards):
    """C_s r (r: the tiles from ranks s - d, concatenated in offset order)
    equals the JAX package's per-offset scatter
    ``y.at[rows].add(vals * tile[cols])`` for every rank."""
    csr, _ = _general_csr()
    parts = tpm.partition_general(csr, shards, block=BLOCK_GEN)
    nl = parts.n_local
    x = np.random.RandomState(2).randn(2, shards, nl).astype(np.float32)
    for s in range(shards):
        tiles = [x[:, (s - d) % shards, parts.send_idx[k][(s - d) % shards]
                   .numpy()] for k, d in enumerate(parts.offsets)]
        want = np.zeros((2, nl), np.float32)
        for k, t in enumerate(tiles):
            rows = parts.cpl_rows[k][s].numpy()
            cols = parts.cpl_cols[k][s].numpy()
            vals = parts.cpl_vals[k][s].numpy()
            np.add.at(want, (slice(None), rows), vals * t[:, cols])
        C = coupling_layout(parts, s, nl + 5, torch.device("cpu"))
        got = sliced_ell_spmv_plain(
            C, torch.from_numpy(np.concatenate(tiles, -1)))
        assert C.x_len == sum(parts.tile_widths)
        np.testing.assert_allclose(got.numpy()[:, :nl], want, atol=1e-5)
        assert not got[:, nl:].any()


# ---------------------------------------------------------------------------
# One process: the 1-shard general plans (tests/test_backends.py:248)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_shard():
    import jax.numpy as jnp

    from repro.core import wavelets as jwav
    from repro.dist import GraphOperator as JOp
    from repro.dist import partition as jpm

    csr, meta = jpm.community_graph_csr(192, n_communities=6, seed=7)
    jop = JOp(P=csr.to_dense(),
              multipliers=jwav.sgwt_multipliers(meta["lmax"], J=2),
              lmax=meta["lmax"], K=10)
    rs = np.random.RandomState(3)
    f = rs.randn(192).astype(np.float32)
    a = rs.randn(3, 192).astype(np.float32)
    dense = jop.plan("dense")
    ref = {"apply": dense.apply(jnp.asarray(f)),
           "apply_adjoint": dense.apply_adjoint(jnp.asarray(a)),
           "apply_gram": dense.apply_gram(jnp.asarray(f)),
           "solve_jacobi": dense.solve(jnp.asarray(f), "jacobi", tau=TAU).x}
    op = GraphOperator(P=torch.tensor(csr.to_dense()),
                       multipliers=twav.sgwt_multipliers(meta["lmax"], J=2),
                       lmax=meta["lmax"], K=10)
    return op, f, a, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("kind", ["apply", "apply_adjoint", "apply_gram",
                                  "solve_jacobi"])
@pytest.mark.parametrize("backend", RING)
def test_one_shard_general_plan_matches_jax_dense(one_shard, backend, kind):
    op, f, a, ref = one_shard
    plan = op.plan(backend, device="cpu", partition="general")
    assert plan.info["partition"] == "general"
    assert plan.info["n_shards"] == 1 and plan.info["transport"] is None
    got = {"apply": lambda: plan.apply(f),
           "apply_adjoint": lambda: plan.apply_adjoint(a),
           "apply_gram": lambda: plan.apply_gram(f),
           "solve_jacobi": lambda: plan.solve(f, "jacobi", tau=TAU).x}[kind]()
    assert float(np.abs(got.numpy() - ref[kind]).max()) < 1e-4


@pytest.mark.parametrize("backend", RING)
def test_one_shard_general_plan_sends_nothing(one_shard, backend):
    op, f, _, ref = one_shard
    plan = op.plan(backend, device="cpu", partition="general",
                   partition_method="spectral")
    info = plan.info
    assert info["partition_method"] == "spectral"
    assert info["partition_offsets"] == () and info["edge_cut"] == 0
    assert info["exchange_collectives_per_round"] == 0
    assert info["halo_bytes_per_apply"] == info["halo_bytes_per_adjoint"] == 0
    for s in plan_comm_stats(plan, batch=2).values():
        assert s.n_collectives == 0 and s.exchange_rounds == 0
    if backend == "cuda_halo":
        # the Block-ELL tag: apply is one sweep, as in the cuda plan
        assert info["block_ell"].n == 192 and info["coupling_nnz"] == 0
    assert float(np.abs(plan.apply(f).numpy() - ref["apply"]).max()) < 1e-4


@pytest.mark.parametrize("backend", RING)
def test_general_string_needs_dense_P(one_shard, backend):
    """JAX `resolve_partition_arg` (:834): the string form partitions a
    dense P; a callable P needs a precomputed GeneralPartition."""
    op, f, _, ref = one_shard
    csr, meta = tpm.community_graph_csr(192, n_communities=6, seed=7)
    cop = GraphOperator(P=tpm.csr_matvec_fn(csr),
                        multipliers=op.multipliers, lmax=meta["lmax"], K=10)
    with pytest.raises(ValueError, match="needs a dense P"):
        cop.plan(backend, device="cpu", partition="general")
    plan = cop.plan(backend, device="cpu",
                    partition=tpm.partition_general(csr, 1))
    assert float(np.abs(plan.apply(f).numpy() - ref["apply"]).max()) < 1e-4


def test_partition_arguments_refused(one_shard):
    op = one_shard[0]
    with pytest.raises(ValueError, match="unknown partition"):
        op.plan("halo", device="cpu", partition="metis")
    with pytest.raises(ValueError, match="2 shards"):
        op.plan("cuda_halo", device="cpu",
                partition=tpm.partition_general(op.P, 2))
    for parts in ("general", tpm.partition_general(op.P, 1)):
        with pytest.raises(ValueError, match="no general partition"):
            op.plan("allgather", device="cpu", partition=parts)


@pytest.mark.parametrize("backend", RING)
@pytest.mark.parametrize("partition", [None, "banded", "instance"])
def test_partition_method_needs_general_string(one_shard, backend,
                                               partition):
    """partition_method= orders only partition='general': with any other
    partition it would be ignored, so the build refuses it."""
    op = one_shard[0]
    if partition == "instance":
        partition = tpm.partition_general(op.P, 1)
    with pytest.raises(TypeError, match="partition_method"):
        op.plan(backend, device="cpu", partition=partition,
                partition_method="spectral")


# ---------------------------------------------------------------------------
# 8 ranks: tests/test_backends.py:270 and tests/test_partition.py:123
# ---------------------------------------------------------------------------
def test_fixture_is_genuinely_non_banded(ranks):
    for r in ranks:
        assert len(r["offsets"]) > 2, r["offsets"]
        assert r["offsets"] == ranks[0]["offsets"]


@pytest.mark.parametrize("kind", OUTPUTS)
@pytest.mark.parametrize("backend", RING)
def test_outputs_match_reference_dense(ranks, backend, kind):
    for r in ranks:
        rec = r[backend]
        assert rec["errors"][kind] < 1e-4, (r["rank"], rec["errors"])
        assert rec["shapes_ok"]


@pytest.mark.parametrize("backend", RING)
def test_rounds_and_messages_closed_form(ranks, setup, backend):
    K, E = K_GEN, setup["E"]
    for r in ranks:
        rec = r[backend]
        assert rec["rounds"] == {"apply": K, "apply_adjoint": K,
                                 "apply_gram": 2 * K}
        assert rec["messages"] == {"apply": 2 * K * E,
                                   "apply_adjoint": 2 * K * E,
                                   "apply_gram": 4 * K * E}
        assert rec["max_rel_dev"] == 0.0
        assert rec["measured_batched"] == rec["messages"]
        assert rec["per_signal"]["apply"] == 2 * K * E / B_GEN
        # a Jacobi solve on tau + P, default K rounds: one exchange each
        assert rec["solve_rounds"][0] == rec["solve_rounds"][1] == K


@pytest.mark.parametrize("backend", RING)
def test_bytes_are_the_partition_byte_model(ranks, backend):
    """At B = 1 a round ships every offset's tile, 4 sum(h_k) bytes;
    the totals are `general_bytes_per_apply`, as plan.info states."""
    for r in ranks:
        rec, info = r[backend], r[backend]["info"]
        assert rec["bytes_per_round"] == r["wire_bytes_per_round"]
        assert r["wire_bytes_per_round"] == 4 * sum(
            info["partition_tile_widths"])
        assert rec["total_bytes"] == info["halo_bytes_per_apply"]
        assert rec["total_bytes"] == r["bytes_per_apply"]
        assert rec["adjoint_total_bytes"] == info["halo_bytes_per_adjoint"]
        assert rec["adjoint_total_bytes"] == r["bytes_per_adjoint"]
        # one ppermute per offset, each to rank + d
        assert info["exchange_collectives_per_round"] == len(r["offsets"])
        assert rec["ppermutes_per_round"] == r["offsets"]


@pytest.mark.parametrize("backend", RING)
def test_every_rank_gets_the_same_result(ranks, backend):
    assert len({r[backend]["digest"] for r in ranks}) == 1
    infos = [r[backend]["info"] for r in ranks]
    assert [i["rank"] for i in infos] == list(range(WORLD))
    assert {i["transport"] for i in infos} == {"gloo"}
    assert len({i["partition_fingerprint"] for i in infos}) == 1
    assert {i["partition"] for i in infos} == {"general"}


@pytest.mark.parametrize("size", sorted(SUBGROUPS))
def test_small_groups_deliver_the_right_tiles(ranks, size):
    """Offsets (1, 1) on 2 ranks (both tiles to the one peer) and (1, 2)
    on 3: each tile arrives from rank s - d, one ppermute per offset."""
    members, offsets = SUBGROUPS[size]
    for r in ranks:
        rec = r["subgroups"].get(str(size))
        assert (rec is not None) == (r["rank"] in members)
        if rec is not None:
            assert rec["ok"] and rec["ppermutes"] == len(offsets)
