"""The port's banded partitions — `halo.partition_banded`,
`cuda_halo.partition_block_ell` — and the Block-ELL helpers they rest on
(`BlockELL.todense`, `block_ell_matvec_ref`), held against the JAX package
on the same numpy P and against dense P itself.

`partition_banded` keeps the JAX package's numpy logic, so diag, left,
right, n, leak and the halo width must agree bitwise.  The JAX package's
own Block-ELL partition is not the reference for the per-shard blocks:
the port's blocks are held against dense P directly, by reassembling them
(`BlockELL.todense` plus the couplings), which must give P exactly on a
leak-free P, and P's block-tridiagonal band with `leak` the norm of the
rest on a leaky one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.dist.backends import halo as jhalo
from repro_torch.core import graph as tgraph
from repro_torch.dist import OverfullSlotsError
from repro_torch.dist.backends import halo as thalo
from repro_torch.dist.backends.cuda_halo import partition_block_ell


def _banded_operator_P(n, bw, seed=0):
    """The Laplacian of `benchmarks/bench_comm.py:128 _banded_operator`
    (a copy: random symmetric band of half-width bw, seed 0)."""
    rng = np.random.default_rng(seed)
    B = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        B[i, lo:hi] = rng.standard_normal(hi - lo) * 0.1
    B = np.abs(B + B.T) / 2
    return np.diag(B.sum(1)) - B


@pytest.fixture(scope="module")
def matrices(sensor120, sensor_banded):
    """Numpy P's: banded (sorted sensor graph, path graph, the BENCH_comm
    band) and leaky (the unsorted sensor graph; the n = 64 sensor graph
    of tests/test_partition.py:99 at kappa 0.3, sorted but wider than a
    shard)."""
    g64 = jgraph.sensor_graph(jax.random.PRNGKey(0), n=64, kappa=0.3)
    g64, _ = jgraph.spatial_sort(g64)
    return {
        "sorted600": np.asarray(sensor_banded.laplacian()),
        "path64": np.asarray(jgraph.path_graph(64).laplacian()),
        "band512": _banded_operator_P(512, 24),
        "unsorted120": np.asarray(sensor120.laplacian()),
        "wide64": np.asarray(g64.laplacian()),
    }


@pytest.mark.parametrize("name,S", [("sorted600", 4), ("sorted600", 8),
                                    ("path64", 8), ("band512", 8),
                                    ("unsorted120", 8), ("wide64", 4),
                                    ("path64", 3)])
def test_partition_banded_bitwise_as_reference(matrices, name, S):
    P = matrices[name]
    want, want_leak = jhalo.partition_banded(P, S)
    got, leak = thalo.partition_banded(torch.from_numpy(P.copy()), S)
    for field in ("diag", "left", "right"):
        assert np.array_equal(getattr(got, field).numpy(),
                              np.asarray(getattr(want, field))), field
    assert got.n == want.n and leak == want_leak
    assert got.halo == want.halo
    lw, rw = want.boundary_couplings()
    lg, rg = got.boundary_couplings()
    assert np.array_equal(lg.numpy(), np.asarray(lw))
    assert np.array_equal(rg.numpy(), np.asarray(rw))
    if name in ("unsorted120", "wide64"):
        assert leak > 1e-3
    else:
        assert leak == 0.0


def _reassemble(parts) -> np.ndarray:
    """Dense (n, n) P from a ShardedBlockELL: each shard's todense() on
    its diagonal block, its couplings beside it."""
    S, nl, h = parts.n_shards, parts.n_local, parts.halo
    out = np.zeros((S * nl, S * nl), np.float32)
    for s in range(S):
        r = slice(s * nl, (s + 1) * nl)
        out[r, r] = parts.shard(s).todense().numpy()
        if s > 0:
            out[r, s * nl - h:s * nl] = parts.left[s].numpy()
        if s < S - 1:
            out[r, (s + 1) * nl:(s + 1) * nl + h] = parts.right[s].numpy()
    return out[:parts.n, :parts.n]


@pytest.mark.parametrize("name,S,block", [
    ("sorted600", 4, (8, 128)), ("sorted600", 8, (8, 8)),
    ("path64", 8, (8, 128)), ("band512", 8, (8, 128)),
    ("path64", 3, (4, 4)), ("wide64", 4, (8, 8)),
    ("unsorted120", 8, (8, 128))])
def test_partition_block_ell_reassembles_dense_P(matrices, name, S, block):
    P = matrices[name].astype(np.float32)
    parts, leak = partition_block_ell(P, S, block=block)
    assert parts.n_shards == S and parts.n_padded >= P.shape[0]
    assert parts.left.shape == parts.right.shape == (S, parts.n_local,
                                                     parts.halo)
    got = _reassemble(parts)
    if leak == 0.0:
        assert np.array_equal(got, P)
    else:
        # a leaky P: the band is kept exactly, leak is the rest's norm
        band = got != 0
        assert np.array_equal(got[band], P[band])
        assert leak == pytest.approx(float(np.linalg.norm(P - got)),
                                     rel=1e-6)
    assert not parts.left[0].any() and not parts.right[-1].any()


def test_partition_block_ell_overfull_raises(matrices):
    P = matrices["wide64"].astype(np.float32)
    with pytest.raises(OverfullSlotsError, match="refusing to truncate"):
        partition_block_ell(P, 4, block=(8, 8), max_slots=1)
    parts, _ = partition_block_ell(P, 4, block=(8, 8))
    slots = parts.blocks.shape[2]
    assert slots > 1
    partition_block_ell(P, 4, block=(8, 8), max_slots=slots)
    with pytest.raises(OverfullSlotsError):
        partition_block_ell(P, 4, block=(8, 8), max_slots=slots - 1)


def test_halo_bytes_and_pad_signal(matrices):
    parts, _ = thalo.partition_banded(matrices["band512"], 8)
    assert parts.halo == 24
    # BENCH_comm.json, f32: 192 bytes per round, 30720 per apply
    assert thalo.halo_bytes_per_apply(parts, 20) == 30720
    assert thalo.halo_bytes_per_apply(parts, 20) // 20 // 8 == 192
    bparts, _ = partition_block_ell(matrices["band512"], 8)
    assert thalo.halo_bytes_per_apply(bparts, 20, eta=3) == 3 * 30720
    x = np.ones((2, 3, 61), np.float32)
    p3, _ = thalo.partition_banded(matrices["path64"][:61, :61], 8)
    got = thalo.pad_signal(x, p3)
    assert tuple(got.shape) == (2, 3, 64) and float(got[..., 61:].abs().sum()) == 0


@pytest.mark.parametrize("block", [(8, 128), (8, 8), (4, 16)])
def test_block_ell_todense_and_matvec_ref_as_reference(matrices, block):
    P = matrices["sorted600"]
    jA = jgraph.to_block_ell(P, block)
    tA = tgraph.to_block_ell(P, block)
    assert np.array_equal(tA.todense().numpy(), np.asarray(jA.todense()))
    x = np.random.RandomState(0).randn(600).astype(np.float32)
    want = np.asarray(jgraph.block_ell_matvec_ref(jA, jnp.asarray(x)))
    got = tgraph.block_ell_matvec_ref(tA, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # leading batch axes ride the same product
    xb = np.random.RandomState(1).randn(3, 600).astype(np.float32)
    gotb = tgraph.block_ell_matvec_ref(tA, torch.from_numpy(xb))
    np.testing.assert_allclose(gotb.numpy(), xb @ P.T, atol=1e-4)
