"""The plain PyTorch versions beside the port's Hopper kernels, held
against the JAX package's own Pallas kernels (interpret mode) and oracles
on the same Block-ELL structure and signals.

Tolerance: atol 2e-5, the reference's own kernel-vs-per-order tolerance
(tests/test_sweep.py:66) — both sides are f32 in different summation
orders.  The reference's `cheb_sweep` kernel does not run on this jax
(`pl.load` is gone), so the port's sweep — on the sliced-ELL layout
packed from the reference's Block-ELL — is held against
`ref.cheb_sweep_ref` and against its own per-order path.

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
"""
import importlib
import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.kernels import ref as jref
from repro.kernels.bcsr_spmv import block_ell_spmv as jspmv
from repro.kernels.bcsr_spmv import block_ell_spmv_batched as jspmv_batched
from repro.kernels.cheb_step import cheb_step as jcheb_step
from repro_torch.convert import block_ell_from_numpy
from repro_torch.core import graph as tgraph
from repro_torch.core import wavelets as twav
from repro_torch.kernels import ops
from repro_torch.kernels.bcsr_spmv import (block_ell_spmv_plain,
                                           sliced_ell_spmv,
                                           sliced_ell_spmv_plain)
from repro_torch.kernels.cheb_step import cheb_step, cheb_step_plain
from repro_torch.kernels.cheb_sweep import cheb_sweep, cheb_sweep_plain

BATCH_SHAPES = [(), (5,), (64,), (2, 3)]
K, ETA = 9, 3
# the module (the package re-exports its `cheb_sweep` function by name)
sweep_mod = importlib.import_module("repro_torch.kernels.cheb_sweep")


@pytest.fixture(scope="module")
def block_ell_500():
    """The multi-row-block, multi-slot n=500 structure of
    tests/test_sweep.py:35-41, in both packages."""
    g, _ = jgraph.connected_sensor_graph(
        jax.random.PRNGKey(1), n=500, theta=0.075, kappa=0.075)
    A = jgraph.to_block_ell(np.asarray(g.laplacian()), (8, 128))
    At = block_ell_from_numpy(np.asarray(A.blocks), np.asarray(A.indices),
                              np.asarray(A.mask), A.n)
    return A, At, g.lambda_max_bound()


def _randn(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("batch_shape", BATCH_SHAPES)
def test_spmv_plain_matches_reference_kernel(block_ell_500, batch_shape):
    A, At, _ = block_ell_500
    x = _randn(0, batch_shape + (A.padded_n,))
    kern = jspmv if batch_shape == () else jspmv_batched
    want = np.asarray(kern(A.blocks, A.indices, jnp.asarray(x),
                           interpret=True))
    got = block_ell_spmv_plain(At.blocks, At.indices, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("n", [512, 500])
@pytest.mark.parametrize("batch_shape", BATCH_SHAPES)
def test_cheb_step_plain_matches_reference_kernel(batch_shape, n):
    """Any n: 500 is not a multiple of the 128 lanes the TPU kernel pads
    to."""
    pt, t1, t2 = (_randn(s, batch_shape + (n,)) for s in (1, 2, 3))
    acc = _randn(4, batch_shape + (ETA, n))
    coef = _randn(5, (ETA,))
    alpha = 7.5
    wt, wacc = jcheb_step(*(jnp.asarray(a) for a in (pt, t1, t2, acc, coef)),
                          alpha=alpha, interpret=True)
    gt, gacc = cheb_step_plain(*(torch.from_numpy(a)
                                 for a in (pt, t1, t2, acc, coef)),
                               alpha=alpha)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=2e-5)
    np.testing.assert_allclose(gacc.numpy(), np.asarray(wacc), atol=2e-5)


@pytest.mark.parametrize("batch_shape", BATCH_SHAPES)
def test_cheb_sweep_plain_matches_reference_oracle(block_ell_500,
                                                   batch_shape):
    """K = 9, eta = 3: the port's sweep on the sliced layout of the
    reference's Block-ELL == ref.cheb_sweep_ref == the port's per-order
    path (SpMV + cheb_step per order)."""
    A, At, lmax = block_ell_500
    coeffs = np.random.RandomState(0).randn(ETA, K + 1).astype(np.float32)
    x = _randn(2, batch_shape + (A.padded_n,))
    want = np.asarray(jref.cheb_sweep_ref(A.blocks, A.indices,
                                          jnp.asarray(x), jnp.asarray(coeffs),
                                          alpha=lmax / 2))
    xt = torch.from_numpy(x)
    got = cheb_sweep_plain(At.sliced_ell(), xt, torch.from_numpy(coeffs),
                           alpha=lmax / 2)
    per_order = ops.fused_cheb_apply(At, xt, coeffs, lmax, sweep=False)
    assert tuple(got.shape) == batch_shape + (ETA, A.padded_n)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(per_order.numpy(), want, atol=2e-5)


def test_cpu_tensors_take_plain_versions_uncounted(block_ell_500):
    """A CPU tensor runs the plain version and launches nothing."""
    _, At, lmax = block_ell_500
    x = torch.from_numpy(_randn(6, (4, At.padded_n)))
    counts = (sliced_ell_spmv.launches, cheb_step.launches,
              cheb_sweep.launches)
    S = At.sliced_ell()
    assert torch.equal(sliced_ell_spmv(S, x), sliced_ell_spmv_plain(S, x))
    acc = torch.zeros(4, 2, At.padded_n)
    coef = torch.ones(2)
    got = cheb_step(x, x, x, acc, coef, alpha=2.0)
    want = cheb_step_plain(x, x, x, acc, coef, alpha=2.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    c = np.ones((2, 4), np.float32)
    assert torch.equal(cheb_sweep(S, x, c, alpha=3.0),
                       cheb_sweep_plain(S, x, c, alpha=3.0))
    assert (sliced_ell_spmv.launches, cheb_step.launches,
            cheb_sweep.launches) == counts


def test_wrappers_raise_on_devices_they_do_not_take(block_ell_500):
    """Neither CPU nor CUDA: the wrappers raise before any build."""
    _, At, _ = block_ell_500
    x = torch.empty(2, At.padded_n, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sliced_ell_spmv(At.sliced_ell(), x)
    with pytest.raises(ValueError, match="CUDA"):
        cheb_sweep(At.sliced_ell(), x, np.ones((1, 3)), alpha=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        cheb_step(x, x, x, torch.empty(2, 1, At.padded_n, device="meta"),
                  torch.empty(1, device="meta"), alpha=1.0)


def test_bf16_sweep_names_its_roadmap_item(block_ell_500):
    """The bf16 sweep mode (ROADMAP queue 2, items 2 and 4) is ported: the
    wrapper and the dispatch give the same bf16 result, within the JAX
    package's bf16 tolerance (3e-2 of the max, tests/test_sweep.py:135)
    of the f32 oracle, over the batch shapes of this file.  The fuller
    bf16 parity tests are in tests/test_torch_bf16_sweep.py."""
    A, At, lmax = block_ell_500
    coeffs = np.random.RandomState(0).randn(ETA, K + 1).astype(np.float32)
    for i, shape in enumerate(BATCH_SHAPES):
        x = _randn(20 + i, shape + (At.padded_n,))
        want = np.asarray(jref.cheb_sweep_ref(
            A.blocks, A.indices, jnp.asarray(x), jnp.asarray(coeffs),
            alpha=lmax / 2))
        got = cheb_sweep(At.sliced_ell(), torch.from_numpy(x), coeffs,
                         alpha=lmax / 2, scratch_dtype="bf16")
        via_ops = ops.fused_cheb_sweep(At, torch.from_numpy(x), coeffs, lmax,
                                       scratch_dtype="bf16")
        assert torch.equal(got, via_ops)
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 3e-2


def test_l2_guard_model_and_smoke_shape():
    """3 B n 4 bytes of the iterates each order re-reads plus 8 bytes per
    stored sliced-ELL entry against the 50 MiB L2: the smoke shape
    (n = 16384, B = 64, 483904 stored entries) takes the sweep, B = 256
    does not."""
    assert ops.cheb_sweep_l2_bytes(100, 2) == 3 * 2 * 100 * 4
    assert ops.cheb_sweep_l2_bytes(100, 2, stored=640) \
        == 3 * 2 * 100 * 4 + 640 * 8
    assert ops.DEFAULT_SWEEP_L2_BUDGET == 50 * 2**20
    assert ops.cheb_sweep_l2_bytes(16384, 64, stored=483904) <= \
        ops.DEFAULT_SWEEP_L2_BUDGET
    assert ops.cheb_sweep_l2_bytes(16384, 256, stored=483904) > \
        ops.DEFAULT_SWEEP_L2_BUDGET


def test_guard_takes_logged_per_order_path(block_ell_500, caplog):
    """A tiny budget takes the per-order path, says so, and gives the same
    numbers; within budget nothing is logged."""
    _, At, lmax = block_ell_500
    coeffs = np.random.RandomState(2).randn(2, 8)
    x = torch.from_numpy(_randn(4, (3, At.padded_n)))
    with caplog.at_level(logging.INFO, logger="repro_torch.kernels.ops"):
        out = ops.fused_cheb_sweep(At, x, coeffs, lmax, l2_budget=64)
    assert any("falling back to the per-order" in r.message
               for r in caplog.records)
    swept = ops.fused_cheb_sweep(At, x, coeffs, lmax)
    np.testing.assert_allclose(out.numpy(), swept.numpy(), atol=2e-5)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="repro_torch.kernels.ops"):
        ops.fused_cheb_sweep(At, x, coeffs, lmax)
    assert not any("falling back" in r.message for r in caplog.records)


def test_pad_trailing_and_tagged_recurrence(block_ell_500):
    """pad_trailing pads only the vertex axis; a matvec tagged with its
    Block-ELL structure takes the sweep and crops to the logical n."""
    _, At, lmax = block_ell_500
    x = torch.from_numpy(_randn(8, (2, At.n)))
    xp = ops.pad_trailing(x, At.padded_n)
    assert xp.shape == (2, At.padded_n) and torch.equal(xp[:, :At.n], x)
    assert not xp[:, At.n:].any()
    assert ops.pad_trailing(xp, At.padded_n) is xp
    coeffs = np.random.RandomState(9).randn(3, 6)

    def mv(t):
        return ops.spmv(At, ops.pad_trailing(t, At.padded_n))[..., :At.n]

    loop = ops.fused_cheb_recurrence(mv, x, coeffs, lmax)
    mv.block_ell = At
    swept = ops.fused_cheb_recurrence(mv, x, coeffs, lmax)
    assert swept.shape == (2, 3, At.n)
    np.testing.assert_allclose(swept.numpy(), loop.numpy(), atol=2e-5)


@pytest.mark.parametrize("route", ["fused_cheb_sweep", "fused_jacobi_sweep",
                                   "plan_apply", "plan_solve"])
def test_fused_routes_reach_the_sliced_plain_versions(block_ell_500,
                                                      monkeypatch, route):
    """On CPU tensors the dispatch and the cuda plan reach the sweeps'
    plain versions, each handed the sliced-ELL layout that the Block-ELL
    carries (packed at the first use, then kept)."""
    _, At, lmax = block_ell_500
    seen = []
    for name in ("cheb_sweep_plain", "jacobi_sweep_plain"):
        real = getattr(sweep_mod, name)

        def spy(S, *args, _real=real, _name=name, **kw):
            seen.append((_name, S))
            return _real(S, *args, **kw)

        monkeypatch.setattr(sweep_mod, name, spy)
    x = torch.from_numpy(_randn(12, (3, At.padded_n)))
    coeffs = np.random.RandomState(13).randn(2, 6)
    if route == "fused_cheb_sweep":
        ops.fused_cheb_sweep(At, x, coeffs, lmax)
        layout, want = At.sliced_ell(), "cheb_sweep_plain"
    elif route == "fused_jacobi_sweep":
        ops.fused_jacobi_sweep(At, x, torch.full((At.padded_n,), 0.1),
                               (0.5, 1.0), np.ones((4, 2)) * [1, 0])
        layout, want = At.sliced_ell(), "jacobi_sweep_plain"
    else:
        op = twav.sgwt_operator(tgraph.path_graph(40).laplacian(), 4.0,
                                J=1, K=8)
        plan = op.plan("cuda", device="cpu")
        if route == "plan_apply":
            plan.apply(torch.from_numpy(_randn(14, (2, 40))))
            want = "cheb_sweep_plain"
        else:
            plan.solve(torch.from_numpy(_randn(15, (2, 40))), "jacobi",
                       tau=0.5, r=1, n_iters=5)
            want = "jacobi_sweep_plain"
        layout = plan.info["block_ell"].sliced
    assert [name for name, _ in seen] == [want]
    assert seen[0][1] is layout


def test_kernel_build_is_lazy():
    """Importing every kernel module compiles and loads nothing."""
    code = ("import repro_torch.kernels, repro_torch.dist;"
            "from repro_torch.kernels import _build;"
            "assert not _build._libs, _build._libs")
    src = Path(__file__).resolve().parents[1] / "src"
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(src), "PATH": "/usr/bin:/bin"})
