"""Chebyshev gossip on the rank ring (`repro_torch.dist.gossip`), held
against the JAX package's `repro.dist.gossip` and a float64 numpy oracle.

* The consensus tables are numpy in both packages: `consensus_coeffs(n,
  K)` and `consensus_error` equal the reference's within 1e-12 for n in
  2..16 and K in 1..ceil(n/2), `ring_eigenvalues` and `_cheb_rows` too.
* The int8 messages are `quantize.encode`'s wires, byte for byte the
  reference's (tests/test_gossip.py:60-68).
* One spawn of 8 gloo ranks on the CPU restates tests/test_gossip.py:22-79:
  rank s holds row s of ``arange(40).reshape(8, 5) ** 1.3``.  The clean
  ring gives the mean within 1e-5 of its max (exact consensus at K = 4,
  the reference's gate is 1e-3 absolute); the quantized ring within 5e-2;
  with rank 3's left and rank 2's right link dropped, within 1e-5 of the
  float64 oracle (the same Chebyshev polynomial of the path-degraded ring
  operator, computed in numpy) and under the reference's bound of 0.35;
  `gossip_mean_tree` over a dict / list / tuple tree and a scalar leaf
  equals `gossip_mean` leaf by leaf; each leaf costs K counted rounds.
"""
import json
import os
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.dist import comm, gossip
from repro_torch.dist import quantize as tq

WORLD = 8


@pytest.mark.parametrize("n", range(2, 17))
def test_consensus_tables_equal_jax(n):
    from repro.dist import gossip as jg

    np.testing.assert_array_equal(gossip.ring_eigenvalues(n),
                                  jg.ring_eigenvalues(n))
    for K in range(1, int(np.ceil(n / 2)) + 1):
        c = gossip.consensus_coeffs(n, K)
        np.testing.assert_allclose(c, jg.consensus_coeffs(n, K), rtol=0,
                                   atol=1e-12)
        assert abs(gossip.consensus_error(n, c)
                   - jg.consensus_error(n, c)) <= 1e-12
        np.testing.assert_array_equal(
            gossip._cheb_rows(gossip.ring_eigenvalues(n), K),
            jg._cheb_rows(jg.ring_eigenvalues(n), K))
    np.testing.assert_array_equal(gossip.consensus_coeffs(n),
                                  jg.consensus_coeffs(n))


def test_consensus_exact_at_full_order_and_monotone_in_K():
    """tests/test_gossip.py:9-22."""
    for n in (4, 8, 16):
        assert gossip.consensus_error(n, gossip.consensus_coeffs(n)) < 1e-6
    errs = [gossip.consensus_error(16, gossip.consensus_coeffs(16, K))
            for K in (2, 4, 6, 8)]
    assert all(e2 <= e1 + 1e-12 for e1, e2 in zip(errs, errs[1:]))


def test_quantized_message_is_the_codec_wire():
    import jax.numpy as jnp

    from repro.dist import gossip as jg

    msg = np.linspace(-1.0, 1.0, 32, dtype=np.float32)[None]
    wire = gossip.quantize_message(torch.from_numpy(msg))
    assert wire.dtype == torch.int8 and wire.numel() == 32 + 4
    np.testing.assert_array_equal(wire.numpy(),
                                  np.asarray(jg.quantize_message(
                                      jnp.asarray(msg))))
    assert torch.equal(wire, tq.encode(torch.from_numpy(msg), "int8"))
    back = gossip.dequantize_message(wire)
    assert float((back - torch.from_numpy(msg)).abs().max()) < 1 / 127 + 1e-6
    with pytest.raises(ValueError):
        gossip.quantize_message(torch.from_numpy(msg), bits=4)


def test_one_rank_is_the_identity():
    """With no group (one rank) the consensus of one value is itself."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = gossip.gossip_mean(x, None, gossip.consensus_coeffs(1))
    torch.testing.assert_close(out, x, rtol=0, atol=1e-6)
    with comm.counting() as rec:
        gossip.gossip_mean(x, None, gossip.consensus_coeffs(1),
                           fault_spec=0.5)
    assert rec.tally == {}


# ---------------------------------------------------------------------------
# 8 ranks
# ---------------------------------------------------------------------------
def _inputs():
    return torch.arange(WORLD * 5, dtype=torch.float32).reshape(WORLD,
                                                                5) ** 1.3


def _path_oracle(x: np.ndarray, coeffs) -> np.ndarray:
    """The float64 output of the ring with rank 3's left link and rank 2's
    right link dropped: each substitutes its own state, so row 3 of the
    operator is x3 - x4 and row 2 is x2 - x1; then the Chebyshev series of
    that operator on [0, 4] (half-c0 convention) applied to x."""
    n = x.shape[0]
    M = 2.0 * np.eye(n)
    for i in range(n):
        M[i, (i - 1) % n] -= 1.0
        M[i, (i + 1) % n] -= 1.0
    M[3, 2] += 1.0
    M[3, 3] -= 1.0
    M[2, 3] += 1.0
    M[2, 2] -= 1.0
    alpha = gossip.RING_LMAX / 2.0
    c = np.asarray(coeffs, np.float64)
    t0 = x.astype(np.float64)
    acc = 0.5 * c[0] * t0
    t1 = M @ t0 / alpha - t0
    acc = acc + c[1] * t1
    for k in range(2, len(c)):
        t2 = 2.0 / alpha * (M @ t1) - 2.0 * t1 - t0
        acc = acc + c[k] * t2
        t0, t1 = t1, t2
    return acc


def _rank_checks(rank):
    group = dist.group.WORLD
    coeffs = gossip.consensus_coeffs(WORLD)
    x = _inputs()[rank]
    with comm.counting() as rec:
        clean = gossip.gossip_mean(x, group, coeffs)
    quant = gossip.gossip_mean(x, group, coeffs, quantize=True)
    dropped = gossip.gossip_mean(x, group, coeffs, drop_left=(rank == 3),
                                 drop_right=(rank == 2))
    tree = {"w": torch.stack([x, 2 * x]), "b": [x[:2], (x[3], x)]}
    with comm.counting() as tree_rec:
        got_tree = gossip.gossip_mean_tree(tree, group, coeffs)
    leaves = [got_tree["w"], got_tree["b"][0], got_tree["b"][1][0],
              got_tree["b"][1][1]]
    want = [gossip.gossip_mean(t, group, coeffs)
            for t in (tree["w"], tree["b"][0], tree["b"][1][0],
                      tree["b"][1][1])]
    return {
        "rank": rank,
        "clean": clean.tolist(), "quant": quant.tolist(),
        "dropped": dropped.tolist(),
        "rounds": rec.stats(WORLD).exchange_rounds,
        "tree_rounds": tree_rec.stats(WORLD).exchange_rounds,
        "tree_types": [type(got_tree).__name__,
                       type(got_tree["b"]).__name__,
                       type(got_tree["b"][1]).__name__,
                       list(got_tree["b"][1][0].shape)],
        "tree_equal": all(torch.equal(a, b) for a, b in zip(leaves, want)),
    }


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

    tmp = tmp_path_factory.mktemp("gloo8_gossip")
    mp.spawn(_worker, args=(WORLD, str(tmp)), nprocs=WORLD, join=True)
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def _stack(ranks, key):
    return np.array([r[key] for r in ranks])


def test_clean_ring_is_the_mean(ranks):
    target = _inputs().numpy().mean(0)
    out = _stack(ranks, "clean")
    err = np.abs(out - target[None]).max()
    assert err < 1e-5 * np.abs(target).max(), err


def test_quantized_ring_is_approximately_the_mean(ranks):
    target = _inputs().numpy().mean(0)
    rel = np.abs(_stack(ranks, "quant") - target[None]).max() / np.abs(
        target).max()
    assert rel < 5e-2, rel
    assert not np.array_equal(_stack(ranks, "quant"), _stack(ranks, "clean"))


def test_dropped_links_match_the_path_oracle(ranks):
    x = _inputs().numpy()
    want = _path_oracle(x, gossip.consensus_coeffs(WORLD))
    got = _stack(ranks, "dropped")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    target = x.mean(0)
    rel = np.abs(got - target[None]).max() / np.abs(target).max()
    assert rel < 0.35, rel


def test_rounds_are_K_per_leaf(ranks):
    for r in ranks:
        assert r["rounds"] == 4
        assert r["tree_rounds"] == 4 * 4


def test_tree_maps_every_leaf(ranks):
    for r in ranks:
        assert r["tree_equal"]
        assert r["tree_types"] == ["dict", "list", "tuple", []]
