"""The couplings' kernel and the ISTA shrink, held on the CPU against the
JAX package: the compacted coupling layout (`bcsr_spmv.compact_coupling`)
and its plain version given the received tiles as a tuple, the planner of
the coupling launches (`tile_groups`, `coupling_launch`), the shrink's
plain version written over its input (`out=a`) and its launch shape
(`shrink_launch`), and the lasso loops that update their iterate in
place.

Inputs come from numpy with a seed (a 300-vertex sensor graph, BFS
general partitions on 2, 3 and 8 shards, B <= 8) and reach both packages
as numpy arrays.  Tolerances: 1e-5 absolute for the couplings against
the JAX scatter (f32 sums in another order); bit for bit against the
port's own sliced-ELL plain version on the joined tiles (the same
products summed in the same order per row); 1e-6 for the shrink against
the JAX kernel in interpret mode (one elementwise pass in f32) and 1e-4
for whole lasso runs (tests/test_torch_lasso_ssl.py's tolerances).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lasso as jlasso
from repro.core import wavelets as jwav
from repro.dist import GraphOperator as JOp
from repro.kernels import ref as jref
from repro.kernels.soft_threshold import ista_shrink as jista_shrink
from repro_torch.core import graph as tgraph
from repro_torch.core import lasso as tlasso
from repro_torch.core import wavelets as twav
from repro_torch.dist import GraphOperator
from repro_torch.dist import partition as tpm
from repro_torch.dist.sharded import coupling_layout
from repro_torch.kernels import ops
from repro_torch.kernels.bcsr_spmv import (TILE_CAPACITY, compact_coupling,
                                           coupling_launch, coupling_plain,
                                           sliced_ell_spmv_accumulate,
                                           sliced_ell_spmv_plain,
                                           tile_groups)
from repro_torch.kernels.cheb_step import STEP_THREADS
from repro_torch.kernels.soft_threshold import (ista_shrink,
                                                ista_shrink_plain,
                                                shrink_launch)

CPU = torch.device("cpu")
GAMMA = 0.3


@pytest.fixture(scope="module")
def sensor_csr():
    g = tgraph.connected_sensor_graph(np.random.RandomState(3), n=300,
                                      theta=0.15, kappa=0.15)
    return g.laplacian().numpy()


def _round(parts, s, B, seed):
    """Rank s's received tiles (one (B, h_k) array per offset, from rank
    s - d, in offset order) and the JAX package's per-offset scatter of
    them into a y of B rows."""
    S, nl = parts.n_shards, parts.n_local
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, nl).astype(np.float32)
    y0 = rs.randn(B, parts.n_local_padded).astype(np.float32)
    tiles = [x[:, (s - d) % S, parts.send_idx[k][(s - d) % S].numpy()]
             for k, d in enumerate(parts.offsets)]
    want = jnp.asarray(y0)
    for k, rv in enumerate(tiles):
        rows = jnp.asarray(parts.cpl_rows[k][s].numpy())
        cols = jnp.asarray(parts.cpl_cols[k][s].numpy())
        vals = jnp.asarray(parts.cpl_vals[k][s].numpy())
        want = want.at[:, rows].add(vals * jnp.take(jnp.asarray(rv), cols,
                                                    axis=-1))
    return [torch.from_numpy(t) for t in tiles], torch.from_numpy(y0), \
        np.asarray(want)


@pytest.mark.parametrize("shards,B", [(2, 1), (2, 8), (3, 5), (8, 4)])
def test_compacted_coupling_is_the_jax_scatter(sensor_csr, shards, B):
    """For every rank: the compacted layout's plain version, given the
    tiles as a tuple, equals the JAX scatter, and equals the sliced-ELL
    plain version on the joined tiles bit for bit; the layout keeps only
    the rows that hold an entry."""
    parts = tpm.partition_general(sensor_csr, shards, block=(8, 8))
    pnl = parts.n_local_padded
    assert len(parts.offsets) >= 1
    for s in range(shards):
        C = coupling_layout(parts, s, pnl, CPU)
        L = compact_coupling(C, parts.tile_widths)
        tiles, y0, want = _round(parts, s, B, seed=10 * shards + s)
        got = sliced_ell_spmv_accumulate(L, tuple(tiles), y0.clone())
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        joined = sliced_ell_spmv_plain(C, torch.cat(tiles, -1),
                                       out=y0.clone())
        assert torch.equal(got, joined)
        assert torch.equal(
            sliced_ell_spmv_accumulate(L, torch.cat(tiles, -1), y0.clone()),
            joined)
        entry_rows = C.entry_rows()[C.values != 0].unique()
        assert len(L.groups) == 1 and L.nnz == C.nnz
        g = L.groups[0]
        assert torch.equal(g.rows.long(), entry_rows)
        assert L.n_entry_rows == entry_rows.numel() and g.S.nnz == C.nnz
        assert L.n_slices == -(-L.n_entry_rows // 32) <= C.n_slices
        # rows without an entry are left as they were
        untouched = torch.ones(pnl, dtype=torch.bool)
        untouched[entry_rows] = False
        assert torch.equal(got[:, untouched], y0[:, untouched])


def test_tile_table_planner():
    """One launch while the offsets fit the table; past it, runs of
    TILE_CAPACITY consecutive offsets in offset order."""
    assert TILE_CAPACITY >= 32
    assert tile_groups((5,) * 3) == ((0, 3),)
    assert tile_groups((5,) * TILE_CAPACITY) == ((0, TILE_CAPACITY),)
    assert tile_groups((5,) * (2 * TILE_CAPACITY + 3)) == (
        (0, TILE_CAPACITY), (TILE_CAPACITY, TILE_CAPACITY),
        (2 * TILE_CAPACITY, 3))
    assert tile_groups((4, 0, 7, 1, 2), capacity=2) == ((0, 2), (2, 2),
                                                        (4, 1))
    # every signal of a batch of up to 16 in one tile; tiles of 8 beyond
    assert coupling_launch(1674, 16) == (16, (419, 1))
    assert coupling_launch(1674, 112) == (8, (419, 14))
    assert coupling_launch(7, 1) == (1, (2, 1))
    assert coupling_launch(7, 3) == (4, (2, 1))
    assert coupling_launch(7, 9) == (16, (2, 1))
    assert coupling_launch(1, 8 * 70000)[1] == (1, 65535)


def test_grouped_couplings_past_the_table(sensor_csr):
    """Past the table's capacity (here cut to 1 and 2 offsets) each group
    has its own compacted layout over its offsets' columns, and y takes
    the groups' row sums in turn: ((y + s_0) + s_1) + ... exactly, within
    1e-5 of the JAX scatter."""
    parts = tpm.partition_general(sensor_csr, 8, block=(8, 8))
    n_off = len(parts.offsets)
    assert n_off >= 3
    for s in (0, 5):
        C = coupling_layout(parts, s, parts.n_local_padded, CPU)
        tiles, y0, want = _round(parts, s, 4, seed=s)
        for cap in (1, 2):
            L = compact_coupling(C, parts.tile_widths, capacity=cap)
            runs = tile_groups(parts.tile_widths, cap)
            assert len(runs) == -(-n_off // cap)
            assert {(g.first, g.count) for g in L.groups} <= set(runs)
            assert sum(g.S.nnz for g in L.groups) == C.nnz
            got = sliced_ell_spmv_accumulate(L, tuple(tiles), y0.clone())
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
            # the stated bits: the groups in turn, each its rows' sums
            step = y0.clone()
            for g in L.groups:
                sums = sliced_ell_spmv_plain(
                    g.S, torch.cat(tiles[g.first:g.first + g.count], -1))
                step[:, g.rows.long()] += sums
            assert torch.equal(got, step)
            assert torch.equal(coupling_plain(L, tiles, y0.clone()), got)
            # each stored column names its tile and its column there
            base = np.concatenate(([0], np.cumsum(parts.tile_widths)))
            for g in L.groups:
                enc = g.columns.long()
                tile, local = enc & 31, enc >> 5
                assert bool((tile < g.count).all())
                assert torch.equal(
                    torch.from_numpy(base[g.first + tile.numpy()]) + local
                    - int(base[g.first]), g.S.columns.long())


@pytest.mark.parametrize("form", ["scale", "signal_scale", "vertex"])
def test_shrink_over_its_input_matches_reference(form):
    """`ista_shrink_plain` (and the wrapper) with out= a, the loops' in-place
    form, against the JAX kernel in interpret mode (per signal, for the
    per-row forms it takes) or its plain reference (per vertex)."""
    B, eta, n = 3, 5, 256
    rs = np.random.RandomState(7)
    a, phi_y, gram = (rs.randn(B, eta, n).astype(np.float32)
                      for _ in range(3))
    shape = {"scale": (eta, 1), "signal_scale": (B, eta, 1),
             "vertex": (B, eta, n)}[form]
    thresh = np.abs(rs.randn(*shape)).astype(np.float32) * 0.5
    if form == "vertex":
        want = np.asarray(jref.ista_shrink_ref(
            *(jnp.asarray(v) for v in (a, phi_y, gram, thresh)),
            gamma=GAMMA))
    else:
        tb = np.broadcast_to(thresh, (B, eta, 1))
        want = np.stack([np.asarray(jista_shrink(
            jnp.asarray(a[b]), jnp.asarray(phi_y[b]), jnp.asarray(gram[b]),
            jnp.asarray(tb[b]), gamma=GAMMA, interpret=True))
            for b in range(B)])
    args = [torch.from_numpy(v) for v in (a, phi_y, gram, thresh)]
    a_t = args[0].clone()
    got = ista_shrink_plain(a_t, *args[1:], gamma=GAMMA, out=a_t)
    assert got is a_t
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    a_w = args[0].clone()
    assert ista_shrink(a_w, *args[1:], gamma=GAMMA, out=a_w) is a_w
    assert torch.equal(a_w, got)
    update = ops.ista_launcher(args[1], args[3], GAMMA)
    assert torch.equal(update(args[0], args[2]), got)


def test_shrink_launch_shape():
    """16-byte packs where n is a multiple of the pack and every streamed
    pointer is 16-byte aligned; one element a thread for a ragged n or an
    unaligned view; a per-row threshold's table does not count, a
    per-vertex one does; rows beyond 65535 are strided."""
    rows = 8 * 7
    a = torch.zeros(rows, 300)
    ptrs = (a.data_ptr(),) * 4
    assert shrink_launch(300, rows, ptrs + (a.data_ptr(),), 4, False) == (
        4, (1, rows))
    assert shrink_launch(16384, rows, ptrs + (0,), 4, False) == (
        4, (16384 // (STEP_THREADS * 4), rows))
    assert shrink_launch(16384, rows, ptrs + (0,), 8, False) == (
        2, (16384 // (STEP_THREADS * 2), rows))
    # ragged n: one element a thread
    assert shrink_launch(301, rows, ptrs + (0,), 4, False) == (1, (2, rows))
    # an unaligned view of the coefficients
    buf = torch.zeros(rows * 300 + 1)
    view = buf[1:].view(rows, 300)
    assert view.data_ptr() % 16 == 4
    assert shrink_launch(300, rows, (view.data_ptr(),) + ptrs[1:]
                         + (0,), 4, False) == (1, (2, rows))
    # an unaligned per-vertex table counts only when read per vertex
    odd = ptrs + (view.data_ptr(),)
    assert shrink_launch(300, rows, odd, 4, False)[0] == 4
    assert shrink_launch(300, rows, odd, 4, True)[0] == 1
    assert shrink_launch(300, 70000, ptrs + (0,), 4, False)[1] == (1, 65535)


@pytest.fixture(scope="module")
def lasso_pair():
    g = tgraph.connected_sensor_graph(np.random.RandomState(4), n=120,
                                      theta=0.2, kappa=0.25)
    L, lmax = g.laplacian().numpy(), g.lambda_max_bound()
    jop = JOp(P=jnp.asarray(L), multipliers=jwav.sgwt_multipliers(lmax, J=3),
              lmax=lmax, K=12)
    top = GraphOperator(P=torch.from_numpy(L.copy()),
                        multipliers=twav.sgwt_multipliers(lmax, J=3),
                        lmax=lmax, K=12)
    return jop, top


@pytest.mark.parametrize("start", ["zeros", "a0"])
def test_lasso_in_place_loop_matches_reference(lasso_pair, start):
    """`distributed_lasso` (and the masked loop) with the in-place update
    against the JAX loops; the caller's a0 and y are left as they were and
    the result never aliases them."""
    jop, top = lasso_pair
    rs = np.random.RandomState(5)
    y = rs.randn(2, 120).astype(np.float32)
    mu = [0.01] + [0.75] * 3
    a0 = (None if start == "zeros"
          else 0.1 * rs.randn(2, 4, 120).astype(np.float32))
    want = jlasso.distributed_lasso(
        jop, jnp.asarray(y), mu=mu, gamma=0.2, n_iters=25,
        a0=None if a0 is None else jnp.asarray(a0))
    y_t = torch.from_numpy(y.copy())
    a0_t = None if a0 is None else torch.from_numpy(a0.copy())
    got = tlasso.distributed_lasso(top.plan("dense", device="cpu"), y_t,
                                   mu=mu, gamma=0.2, n_iters=25, a0=a0_t)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs),
                               atol=1e-4)
    np.testing.assert_allclose(got.signal.numpy(), np.asarray(want.signal),
                               atol=1e-4)
    assert torch.equal(y_t, torch.from_numpy(y))
    if a0 is not None:
        assert torch.equal(a0_t, torch.from_numpy(a0))
        assert got.coeffs.data_ptr() != a0_t.data_ptr()
    mask = rs.rand(120) > 0.2
    want = jlasso.distributed_lasso_masked(jop, jnp.asarray(y[0]),
                                           jnp.asarray(mask), mu, gamma=0.2,
                                           n_iters=25)
    got = tlasso.distributed_lasso_masked(top, y_t[0], mask, mu, gamma=0.2,
                                          n_iters=25)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs),
                               atol=1e-4)
    assert torch.equal(y_t, torch.from_numpy(y))
