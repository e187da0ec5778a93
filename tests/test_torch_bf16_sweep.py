"""The bf16 scratch mode of the port's two sweeps (``scratch_dtype`` /
``sweep_dtype="bf16"``), held against the JAX package's f32 oracles and
its dense plan on the same inputs.

Tolerance: 3e-2 of the reference's max magnitude, the JAX package's own
for its bf16 sweeps (tests/test_sweep.py:135,156): bf16 iterates carry
8 bits of mantissa through K orders or rounds.  The guard models are held
to the JAX package's footprint formulas (tests/test_sweep.py:159-172).

On the CPU the sweeps run their plain versions, on the sliced-ELL
layout packed from the reference's Block-ELL; the CUDA kernels' bf16
instances run on the card: tests/test_torch_gpu.py.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import jacobi as jjacobi
from repro.core import wavelets as jwav
from repro.dist import GraphOperator as JOperator
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import block_ell_from_numpy, operator_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.cheb_sweep import (cheb_sweep, cheb_sweep_plain,
                                            jacobi_sweep)

TOL = 3e-2


@pytest.fixture(scope="module")
def block_ell_500():
    """The n = 500 structure of tests/test_sweep.py:35-41, both packages."""
    g, _ = jgraph.connected_sensor_graph(
        jax.random.PRNGKey(1), n=500, theta=0.075, kappa=0.075)
    A = jgraph.to_block_ell(np.asarray(g.laplacian()), (8, 128))
    At = block_ell_from_numpy(np.asarray(A.blocks), np.asarray(A.indices),
                              np.asarray(A.mask), A.n)
    return g, A, At


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("batch_shape", [(4,), (), (2, 3)])
def test_cheb_sweep_bf16_matches_ref(block_ell_500, batch_shape):
    """tests/test_sweep.py:122-141 on shared inputs: f32 out, within 3e-2
    of the f32 oracle, and not the f32 result (the mode is real)."""
    g, A, At = block_ell_500
    K, eta = 9, 3
    coeffs = np.random.RandomState(0).randn(eta, K + 1).astype(np.float32)
    x = np.random.RandomState(2).randn(*batch_shape, A.padded_n) \
        .astype(np.float32)
    alpha = g.lambda_max_bound() / 2
    want = jref.cheb_sweep_ref(A.blocks, A.indices, jnp.asarray(x),
                               jnp.asarray(coeffs), alpha=alpha)
    got = cheb_sweep(At.sliced_ell(), torch.from_numpy(x), coeffs,
                     alpha=alpha, scratch_dtype="bf16")
    assert got.dtype == torch.float32
    assert got.shape == batch_shape + (eta, A.padded_n)
    assert _rel(got.numpy(), want) < TOL
    f32 = cheb_sweep(At.sliced_ell(), torch.from_numpy(x), coeffs,
                     alpha=alpha)
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("den,weights", [
    ((0.5, 1.0), "jacobi"), ((0.5, 1.0), "cheb_jacobi"),
    ((0.5, 0.0, 1.0), "jacobi"), ((0.5,), "jacobi")])
def test_jacobi_sweep_bf16_matches_ref(block_ell_500, den, weights):
    """tests/test_sweep.py:144-157 (den = (tau, 1), 10 rounds), plus the
    accelerated weights, deg(den) = 2 and deg(den) = 0."""
    g, A, At = block_ell_500
    P = np.asarray(g.laplacian(), np.float64)
    diag = sum(c * np.diag(np.linalg.matrix_power(P, m))
               for m, c in enumerate(den))
    inv_d = np.zeros(A.padded_n, np.float32)
    inv_d[:500] = 1.0 / diag
    b = np.random.RandomState(5).randn(4, A.padded_n).astype(np.float32)
    b[:, 500:] = 0
    ws = (jjacobi.jacobi_weights(10) if weights == "jacobi"
          else jjacobi.cheb_jacobi_weights(0.9, 10))
    want = jref.jacobi_sweep_ref(A.blocks, A.indices, jnp.asarray(b),
                                 jnp.asarray(inv_d), ws,
                                 jnp.zeros_like(jnp.asarray(b)), den=den)
    got = jacobi_sweep(At.sliced_ell(), torch.from_numpy(b),
                       torch.from_numpy(inv_d), ws, torch.zeros(4, A.padded_n),
                       den=den, scratch_dtype="bf16")
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL


def test_plain_bf16_rounds_every_stored_iterate(block_ell_500):
    """K = 1: acc = (c0/2) bf16(x) + c1 bf16(P bf16(x) / alpha - bf16(x))
    with P's values in bf16 (the layout's bf16 copy) — the definition the
    kernel shares."""
    _, _, At = block_ell_500
    x = torch.from_numpy(np.random.RandomState(6).randn(3, At.padded_n)
                         .astype(np.float32))
    c = np.array([[0.7, -1.3]])
    got = cheb_sweep_plain(At.sliced_ell(), x, c, alpha=2.5,
                           scratch_dtype="bf16")

    def bf(t):
        return t.to(torch.bfloat16).float()

    xb = bf(x)
    Pb = torch.from_numpy(np.array(jref.block_ell_to_dense(
        bf(At.blocks).numpy(), At.indices.numpy())))
    t1 = bf(xb @ Pb.T / 2.5 - xb)
    want = 0.5 * 0.7 * xb + (-1.3) * t1
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("call", ["cheb_sweep", "jacobi_sweep",
                                  "fused_cheb_sweep", "plan"])
def test_other_scratch_dtypes_raise(block_ell_500, call):
    _, _, At = block_ell_500
    x = torch.zeros(At.padded_n)
    with pytest.raises(ValueError, match="scratch_dtype"):
        if call == "cheb_sweep":
            cheb_sweep(At.sliced_ell(), x, np.ones((1, 4)), alpha=1.0,
                       scratch_dtype="f16")
        elif call == "jacobi_sweep":
            jacobi_sweep(At.sliced_ell(), x, x, np.ones((2, 2)), x,
                         den=(1.0,), scratch_dtype="fp8")
        elif call == "fused_cheb_sweep":
            ops.fused_cheb_sweep(At, x, np.ones((1, 4)), 2.0,
                                 scratch_dtype="bfloat16")
        else:
            op = operator_from_reference(np.eye(4), np.ones((1, 4)), 2.0, 3)
            op.plan("cuda", device="cpu", sweep_dtype="f16")


def test_guard_models_match_jax_formulas(block_ell_500):
    """The L2 guards count bf16 buffers at 2 bytes: the cheb model is the
    iterate term of the JAX `cheb_sweep_vmem_bytes` less its accumulator
    (the port's kernel writes the accumulator once, after the last order,
    so it is not re-read from the L2), without the table, and with the
    sliced-ELL layout the sweep re-reads in place of the Block-ELL blocks:
    4 + 4 bytes per stored entry in f32, 2 + 4 with the bf16 values
    copy; the Jacobi model its six buffers
    with x_prev at 4 bytes (the kernel reads it from the previous x's f32
    buffer and rounds it, where the JAX kernel kept a bf16 copy) plus the
    same layout bytes."""
    _, A, At = block_ell_500
    n, eta, K, B = A.padded_n, 3, 10, 4
    for sdt, sb in (("f32", 4), ("bf16", 2)):
        jax_total = jops.cheb_sweep_vmem_bytes(A, n, eta, K, B,
                                               scratch_dtype=sdt)
        structure = A.blocks.size * sb + A.indices.size * 4
        jax_iterates = jax_total - structure - (K + 1) * eta * 4 - B * n * sb
        assert ops.cheb_sweep_l2_bytes(n, B, scratch_dtype=sdt) \
            == jax_iterates - eta * B * n * 4 == 3 * B * n * sb
        jax_buffers = jops.jacobi_sweep_vmem_bytes(
            A, n, batch=B, scratch_dtype=sdt) - structure
        assert ops.jacobi_sweep_l2_bytes(n, B, scratch_dtype=sdt) \
            == jax_buffers + (4 - sb) * B * n
    stored = At.sliced_ell().stored
    for sdt, sv in (("f32", 4), ("bf16", 2)):
        assert ops.cheb_sweep_l2_bytes(n, B, scratch_dtype=sdt,
                                       stored=stored) \
            == ops.cheb_sweep_l2_bytes(n, B, scratch_dtype=sdt) \
            + stored * (4 + sv)
        assert ops.jacobi_sweep_l2_bytes(n, B, scratch_dtype=sdt,
                                         stored=stored) \
            == ops.jacobi_sweep_l2_bytes(n, B, scratch_dtype=sdt) \
            + stored * (4 + sv)
    assert ops.cheb_sweep_l2_bytes(n, B) == 3 * B * n * 4
    assert ops.jacobi_sweep_l2_bytes(n, B) == 6 * B * n * 4
    # the smoke shape (483904 stored entries): both bf16 sweeps fit the
    # 50 MiB L2 at B = 64
    assert ops.cheb_sweep_l2_bytes(16384, 64, scratch_dtype="bf16",
                                   stored=483904) \
        <= ops.DEFAULT_SWEEP_L2_BUDGET
    assert ops.jacobi_sweep_l2_bytes(16384, 64, scratch_dtype="bf16",
                                     stored=483904) \
        <= ops.DEFAULT_SWEEP_L2_BUDGET


def test_bf16_over_budget_takes_logged_f32_path(block_ell_500, caplog):
    """Over budget the fallback is the f32 per-order / per-round path, as
    the JAX package's ops.py:170-176 does."""
    g, _, At = block_ell_500
    lmax = g.lambda_max_bound()
    coeffs = np.random.RandomState(2).randn(2, 8)
    x = torch.from_numpy(np.random.RandomState(4).randn(3, At.padded_n)
                         .astype(np.float32))
    with caplog.at_level(logging.INFO, logger="repro_torch.kernels.ops"):
        out = ops.fused_cheb_sweep(At, x, coeffs, lmax, l2_budget=64,
                                   scratch_dtype="bf16")
    assert any("falling back to the per-order" in r.message
               for r in caplog.records)
    f32 = ops.fused_cheb_apply(At, x, coeffs, lmax, sweep=False)
    assert torch.equal(out, f32)
    inv_d = torch.full((At.padded_n,), 0.1)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="repro_torch.kernels.ops"):
        xj = ops.fused_jacobi_sweep(At, x, inv_d, (0.5, 1.0),
                                    np.ones((5, 2)) * [1, 0], l2_budget=64,
                                    scratch_dtype="bf16")
    assert any("per-round" in r.message for r in caplog.records)
    xf = ops.fused_jacobi_sweep(At, x, inv_d, (0.5, 1.0),
                                np.ones((5, 2)) * [1, 0], l2_budget=64)
    assert torch.equal(xj, xf)


def test_tagged_matvec_selects_bf16_sweep(block_ell_500):
    """``mv.sweep_dtype`` reaches the sweep through
    `fused_cheb_recurrence`, as in the JAX package."""
    g, _, At = block_ell_500
    lmax = g.lambda_max_bound()
    coeffs = np.random.RandomState(7).randn(2, 9)
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 500)
                         .astype(np.float32))

    def mv(t):
        return ops.spmv(At, t)

    mv.block_ell = At
    mv.sweep_dtype = "bf16"
    got = ops.fused_cheb_recurrence(mv, x, coeffs, lmax)
    want = ops.fused_cheb_sweep(At, ops.pad_trailing(x, At.padded_n), coeffs,
                                lmax, scratch_dtype="bf16")[..., :500]
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def ops120():
    """n = 120 sensor graph, SGWT union (J = 2), K = 12, both packages."""
    g, _ = jgraph.connected_sensor_graph(
        jax.random.PRNGKey(0), n=120, theta=0.2, kappa=0.25)
    lmax = g.lambda_max_bound()
    jop = JOperator(P=g.laplacian(),
                    multipliers=jwav.sgwt_multipliers(lmax, J=2),
                    lmax=lmax, K=12)
    top = operator_from_reference(np.asarray(jop.P, np.float32),
                                  np.asarray(jop.coeffs), lmax, 12)
    return jop, top


@pytest.mark.parametrize("kind", ["apply", "apply_gram"])
def test_bf16_plan_matches_dense(ops120, kind):
    jop, top = ops120
    plan = top.plan("cuda", device="cpu", sweep_dtype="bf16")
    assert plan.info["sweep_dtype"] == "bf16"
    assert plan.info["sweep_l2_bytes"] == ops.cheb_sweep_l2_bytes(
        plan.info["padded_n"], scratch_dtype="bf16")
    f = np.random.RandomState(9).randn(6, 120).astype(np.float32)
    want = getattr(jop.plan("dense"), kind)(jnp.asarray(f))
    got = getattr(plan, kind)(torch.from_numpy(f))
    assert _rel(got.numpy(), want) < TOL
    f32 = getattr(top.plan("cuda", device="cpu"), kind)(torch.from_numpy(f))
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("method", ["jacobi", "cheb_jacobi", "chebyshev"])
def test_bf16_plan_solve_matches_dense(ops120, method):
    """`solve` hands the plan's sweep_dtype to the sweeps, as the JAX
    package does (dist/solvers.py:254,613)."""
    jop, top = ops120
    y = np.random.RandomState(10).randn(3, 120).astype(np.float32)
    kw = dict(tau=0.5, r=1, n_iters=20)
    want = jop.plan("dense").solve(jnp.asarray(y), method, **kw)
    got = top.plan("cuda", device="cpu", sweep_dtype="bf16").solve(
        torch.from_numpy(y), method, **kw)
    f32 = top.plan("cuda", device="cpu").solve(torch.from_numpy(y), method,
                                               **kw)
    assert _rel(got.x.numpy(), want.x) < TOL
    assert not torch.equal(got.x, f32.x)
    assert got.info["exchange_rounds"] == want.info["exchange_rounds"]
