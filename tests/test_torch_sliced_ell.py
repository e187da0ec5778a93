"""The sliced-ELL row layout and the SpMV that reads it, held against the
JAX package's Block-ELL kernels (interpret mode) and plans.

`core.graph.to_sliced_ell` packs P into slices of 32 rows; the card's
SpMV (``csrc/sliced_ell_spmv.cu``) reads it, and here, on the CPU, its
plain version `sliced_ell_spmv_plain` does.  Tolerances: the packing is
exact (bitwise); the plain SpMV against the JAX kernels atol 2e-5 (f32 in
another summation order, as tests/test_torch_kernels.py); whole paths at
the tolerances of tests/test_torch_plan.py (1e-4), tests/test_torch_
solvers.py (1e-5 against the reference solve) and tests/test_torch_
lasso_ssl.py (1e-4).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import wavelets as jwav
from repro.dist import GraphOperator as JOp
from repro.kernels.bcsr_spmv import block_ell_spmv as jspmv
from repro.kernels.bcsr_spmv import block_ell_spmv_batched as jspmv_batched
from repro_torch.core import graph as tgraph
from repro_torch.core import wavelets as twav
from repro_torch.dist import GraphOperator
from repro_torch.kernels import ops
from repro_torch.kernels.bcsr_spmv import (sliced_ell_spmv,
                                           sliced_ell_spmv_plain)


def _randn(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _dense(S):
    """The (padded_n, padded_n) matrix a sliced-ELL layout holds, every
    stored entry added into its place (padding adds 0)."""
    M = torch.zeros(S.n_slices * 32, S.padded_n)
    M.index_put_((S.entry_rows(), S.columns.long()), S.values,
                 accumulate=True)
    return M[:S.padded_n].numpy()


def _matrix(case):
    """(P as float32 numpy, Block-ELL tile) for each packing case."""
    if case == "sensor500":
        g, _ = jgraph.connected_sensor_graph(
            jax.random.PRNGKey(1), n=500, theta=0.075, kappa=0.075)
        return np.asarray(g.laplacian()), (8, 128)
    if case == "ragged203":
        # n not a multiple of 32; padded to 208, a last slice of 16 rows
        g = tgraph.sensor_graph(np.random.RandomState(3), n=203, theta=0.1,
                                kappa=0.12)
        return g.laplacian().numpy(), (8, 8)
    if case == "empty_row":      # an isolated vertex: an all-zero row
        W = tgraph.sensor_graph(np.random.RandomState(4), n=96, theta=0.15,
                                kappa=0.2).W.numpy().copy()
        W[17, :] = 0.0
        W[:, 17] = 0.0
        return tgraph.laplacian(W).numpy(), (8, 32)
    return tgraph.path_graph(70).laplacian().numpy(), (8, 128)


@pytest.mark.parametrize("case", ["sensor500", "ragged203", "empty_row",
                                  "path70"])
def test_to_sliced_ell_reassembles_bitwise(case):
    """Dense P back from the layout, bit for bit; the same layout from P
    and from its Block-ELL; slot-major slices as wide as their widest
    row, padding at value 0 on the row's own column."""
    P, block = _matrix(case)
    n = P.shape[0]
    A = tgraph.to_block_ell(P, block)
    S = tgraph.to_sliced_ell(P, padded_n=A.padded_n)
    assert (S.n, S.padded_n, S.nnz) == (n, A.padded_n, np.count_nonzero(P))
    dense = _dense(S)
    assert np.array_equal(dense[:n, :n], P)
    assert not dense[n:].any() and not dense[:, n:].any()
    from_blocks = A.sliced_ell()
    for name in ("values", "columns", "offsets", "widths"):
        assert torch.equal(getattr(S, name), getattr(from_blocks, name)), name
    assert S.values.dtype == torch.float32
    assert S.columns.dtype == S.offsets.dtype == torch.int32
    rows32 = -(-A.padded_n // 32) * 32
    counts = np.count_nonzero(np.pad(P, ((0, rows32 - n), (0, 0))), axis=1)
    widths = counts.reshape(-1, 32).max(axis=1)
    assert np.array_equal(S.widths.numpy(), widths)
    sizes = 32 * widths
    assert np.array_equal(S.offsets.numpy(),
                          np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    rows = S.entry_rows().numpy()
    pad = S.values.numpy() == 0
    own = np.where(rows < A.padded_n, rows, 0)
    assert np.array_equal(S.columns.numpy()[pad], own[pad])
    assert int(S.columns.max()) < A.padded_n
    assert S.stored == sizes.sum() and S.stored_per_nnz == S.stored / S.nnz


@pytest.mark.parametrize("case", ["sensor500", "ragged203"])
def test_block_ell_packs_sliced_layout_on_its_device(case):
    """`BlockELL.sliced_ell` packs in torch ops on the blocks' device
    (here the CPU): bitwise the host packer `to_sliced_ell` of the same
    Block-ELL, at the shared n = 500 structure and at n = 203 (a last
    slice of 16 rows), with the bf16 values copy rounded once from the
    f32 values."""
    P, block = _matrix(case)
    A = tgraph.to_block_ell(P, block)
    want = tgraph.to_sliced_ell(A)
    got = A.sliced_ell()
    assert got is A.sliced and got.device == A.device
    for name in ("values", "values_bf16", "columns", "offsets", "widths"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert (got.n, got.padded_n, got.nnz) == (want.n, want.padded_n,
                                              want.nnz)
    assert got.values_bf16.dtype == torch.bfloat16
    assert torch.equal(got.values_bf16, got.values.to(torch.bfloat16))
    assert A.padded_n % 32 == (16 if case == "ragged203" else 0)


def test_default_padding_and_bad_padded_n():
    P = tgraph.path_graph(45).laplacian()
    S = tgraph.to_sliced_ell(P)
    assert (S.padded_n, S.n_slices) == (45, 2)
    x = torch.from_numpy(_randn(2, (3, 45)))
    torch.testing.assert_close(sliced_ell_spmv_plain(S, x), x @ P.T,
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="below n"):
        tgraph.to_sliced_ell(P, padded_n=40)


def test_stored_per_nnz_on_strip_sorted_sensor_graph():
    """The smoke graph's construction (chip_smoke.py), reduced to n = 2048:
    kappa = sqrt(20 / (pi n)), strip-sorted.  The row layout stays near
    one stored entry per non-zero where Block-ELL stores dozens."""
    n = 2048
    kappa = math.sqrt(20.0 / (math.pi * n))
    g = tgraph.connected_sensor_graph(np.random.RandomState(0), n=n,
                                      theta=kappa * 0.074 / 0.075,
                                      kappa=kappa)
    g, _ = tgraph.spatial_sort(g)
    L = g.laplacian()
    A = tgraph.to_block_ell(L, (8, 128))
    S = tgraph.to_sliced_ell(A)
    assert S.stored_per_nnz <= 1.6
    assert A.blocks.numel() / S.nnz > 10 * S.stored_per_nnz


@pytest.fixture(scope="module")
def sensor500():
    """The n = 500 structure of tests/test_torch_kernels.py in both
    packages."""
    g, _ = jgraph.connected_sensor_graph(
        jax.random.PRNGKey(1), n=500, theta=0.075, kappa=0.075)
    P = np.asarray(g.laplacian())
    A = jgraph.to_block_ell(P, (8, 128))
    return A, tgraph.to_sliced_ell(P, padded_n=A.padded_n)


@pytest.mark.parametrize("batch_shape", [(), (64,), (2, 3)])
def test_sliced_plain_matches_reference_kernel(sensor500, batch_shape):
    A, S = sensor500
    x = _randn(0, batch_shape + (A.padded_n,))
    kern = jspmv if batch_shape == () else jspmv_batched
    want = np.asarray(kern(A.blocks, A.indices, jnp.asarray(x),
                           interpret=True))
    got = sliced_ell_spmv_plain(S, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_cpu_tensor_launches_nothing(sensor500):
    """A CPU tensor runs the plain version and is not counted; a tensor
    on neither the CPU nor a card raises; a signal of the wrong length
    raises."""
    _, S = sensor500
    x = torch.from_numpy(_randn(1, (4, S.padded_n)))
    before = sliced_ell_spmv.launches
    assert torch.equal(sliced_ell_spmv(S, x), sliced_ell_spmv_plain(S, x))
    assert torch.equal(sliced_ell_spmv(S, x[0]),
                       sliced_ell_spmv_plain(S, x[0]))
    assert sliced_ell_spmv.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        sliced_ell_spmv(S, torch.empty(2, S.padded_n, device="meta"))
    with pytest.raises(ValueError, match="padded n"):
        sliced_ell_spmv(S, x[..., :500])


# -- the plan's SpMV paths ---------------------------------------------------
@pytest.fixture(scope="module")
def ops120():
    """The n = 120, eta = 3, K = 12 operator of tests/test_torch_plan.py."""
    g, _ = jgraph.connected_sensor_graph(
        jax.random.PRNGKey(0), n=120, theta=0.2, kappa=0.25)
    lmax = g.lambda_max_bound()
    L = np.asarray(g.laplacian())
    jop = JOp(P=jnp.asarray(L), multipliers=jwav.sgwt_multipliers(lmax, J=2),
              lmax=lmax, K=12)
    top = GraphOperator(P=torch.from_numpy(L.copy()),
                        multipliers=twav.sgwt_multipliers(lmax, J=2),
                        lmax=lmax, K=12)
    return jop, top


@pytest.fixture
def counted(monkeypatch):
    """Count the calls that reach the sliced-ELL SpMV wrapper."""
    calls = []
    real = ops.sliced_ell_spmv

    def spy(S, x):
        calls.append(tuple(x.shape))
        return real(S, x)

    monkeypatch.setattr(ops, "sliced_ell_spmv", spy)
    return calls


def test_plan_packs_the_sliced_layout(ops120):
    """The plan packs the layout on its device when it is built and keeps
    it on the Block-ELL; the sweep of apply and the SpMV of apply_adjoint
    both read that one layout, and plan.info counts its entries."""
    _, top = ops120
    plan = top.plan("cuda", device="cpu")
    A = plan.info["block_ell"]
    S = A.sliced
    assert S is not None and S.padded_n == A.padded_n == 128
    plan.apply(_randn(5, (2, 120)))
    plan.apply_adjoint(_randn(6, (2, top.eta, 120)))
    assert A.sliced is S
    assert plan.info["nnz"] == S.nnz
    assert plan.info["stored_per_nnz"] == S.stored_per_nnz
    assert plan.info["flops_per_matvec"] == 2 * S.stored
    assert A.sliced_ell() is S
    assert A.to("cpu").sliced is not None


@pytest.mark.parametrize("batch", [(64,), ()])
def test_adjoint_and_per_order_apply_take_the_sliced_spmv(ops120, counted,
                                                          batch, monkeypatch):
    """apply_adjoint (K SpMVs over batch x eta streams) and the per-order
    apply (K launches of the order instance, whose product reads the same
    sliced layout: no stand-alone SpMV) against the reference's dense
    plan."""
    jop, top = ops120
    dense = jop.plan("dense")
    a = _randn(3, batch + (jop.eta, 120))
    got = top.plan("cuda", device="cpu").apply_adjoint(a)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(dense.apply_adjoint(jnp.asarray(a))),
        atol=1e-4)
    assert counted == [batch + (jop.eta, 128)] * jop.K
    counted.clear()
    plan = top.plan("cuda", device="cpu", sweep=False)
    orders = []
    real = ops.order_launcher

    def launcher(S, x, eta, *, alpha):
        assert S is plan.info["block_ell"].sliced_ell()
        launch = real(S, x, eta, alpha=alpha)

        def spy(t_km1, *rest):
            orders.append(tuple(t_km1.shape))
            return launch(t_km1, *rest)

        return spy

    monkeypatch.setattr(ops, "order_launcher", launcher)
    f = _randn(4, batch + (120,))
    got = plan.apply(f)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(dense.apply(jnp.asarray(f))), atol=1e-4)
    assert counted == [] and orders == [batch + (128,)] * jop.K


def test_arma_solve_takes_the_sliced_spmv(counted):
    """The Section-V ARMA solve: one SpMV per round, the reference's solve
    to atol 1e-5 (tests/test_torch_solvers.py)."""
    from repro.core import filters as jfilters
    from repro_torch.core import filters as tfilters
    tau = 0.5
    g, _ = jgraph.connected_sensor_graph(
        jax.random.PRNGKey(0), n=120, theta=0.2, kappa=0.25)
    Ln = np.asarray(g.laplacian("normalized"))
    jop = JOp(P=jnp.asarray(Ln),
              multipliers=[jfilters.ssl_multiplier(jfilters.power_kernel(1),
                                                   tau)], lmax=2.0, K=12)
    top = GraphOperator(
        P=torch.from_numpy(Ln.copy()),
        multipliers=[tfilters.ssl_multiplier(tfilters.power_kernel(1), tau)],
        lmax=2.0, K=12)
    Y = _randn(11, (64, 120))
    kw = dict(tau=tau, r=1, n_iters=30)
    want = jop.plan("dense").solve(jnp.asarray(Y), "arma", **kw)
    got = top.plan("cuda", device="cpu").solve(Y, "arma", **kw)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5)
    assert len(counted) == 30


def test_solve_lasso_takes_the_sliced_spmv(ops120, counted):
    """Algorithm 3: one adjoint (K SpMVs) per iteration plus the initial
    Phi* y, against the reference's dense lasso (atol 1e-4)."""
    jop, top = ops120
    Y = _randn(15, (3, 120))
    mu = np.array([0.01] + [0.75] * (jop.eta - 1), np.float32)
    want = jop.plan("dense").solve_lasso(jnp.asarray(Y), mu, n_iters=10)
    got = top.plan("cuda", device="cpu").solve_lasso(Y, mu, n_iters=10)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs),
                               atol=1e-4)
    np.testing.assert_allclose(got.signal.numpy(), np.asarray(want.signal),
                               atol=1e-4)
    assert len(counted) == (10 + 1) * jop.K
