"""Card-only tests: each Hopper kernel against its plain PyTorch version on
a CUDA device, and the main path against float64 dense.

They carry the `gpu` marker and skip without a card (decided inside the
`cuda` fixture, never at import).  The machine with the card has no JAX,
so this file imports none (the kernels' reference there is their plain
version) and runs without the JAX-side tests/conftest.py:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_gpu.py

Tolerances: the kernels redo the plain versions' f32 arithmetic in another
summation order — 1e-5 relative for the SpMV, 1e-6 for the elementwise
step, 1e-4 for the 9-order sweep and for the main path against float64.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import graph as tgraph
from repro_torch.core import wavelets as twav
from repro_torch.dist import GraphOperator
from repro_torch.kernels.bcsr_spmv import block_ell_spmv, block_ell_spmv_plain
from repro_torch.kernels.cheb_step import cheb_step, cheb_step_plain
from repro_torch.kernels.cheb_sweep import cheb_sweep, cheb_sweep_plain

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def structure(cuda):
    g = tgraph.connected_sensor_graph(np.random.RandomState(1), n=500,
                                      theta=0.075, kappa=0.075)
    At = tgraph.to_block_ell(g.laplacian(), (8, 128)).to(cuda)
    return At, g.lambda_max_bound()


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("batch_shape", [(), (5,), (64,), (100,), (2, 3)])
def test_block_ell_spmv_kernel_matches_plain(structure, batch_shape):
    At, _ = structure
    gen = torch.Generator(device=At.device).manual_seed(0)
    x = torch.randn(batch_shape + (At.padded_n,), generator=gen,
                    device=At.device)
    before = block_ell_spmv.launches
    got = block_ell_spmv(At.blocks, At.indices, x)
    torch.cuda.synchronize()
    assert block_ell_spmv.launches == before + 1
    assert _rel(got, block_ell_spmv_plain(At.blocks, At.indices, x)) < 1e-5


@pytest.mark.parametrize("n", [500, 16384])
def test_cheb_step_kernel_matches_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(1)
    pt, t1, t2 = (torch.randn(64, n, generator=gen, device=cuda)
                  for _ in range(3))
    acc = torch.randn(64, 7, n, generator=gen, device=cuda)
    coef = torch.randn(7, generator=gen, device=cuda)
    before = cheb_step.launches
    got = cheb_step(pt, t1, t2, acc, coef, alpha=3.5)
    want = cheb_step_plain(pt, t1, t2, acc, coef, alpha=3.5)
    torch.cuda.synchronize()
    assert cheb_step.launches == before + 1
    assert _rel(got[0], want[0]) < 1e-6 and _rel(got[1], want[1]) < 1e-6


@pytest.mark.parametrize("batch_shape", [(), (64,), (2, 3), (128,)])
def test_cheb_sweep_kernel_matches_plain(structure, batch_shape):
    At, lmax = structure
    gen = torch.Generator(device=At.device).manual_seed(2)
    x = torch.randn(batch_shape + (At.padded_n,), generator=gen,
                    device=At.device)
    coeffs = np.random.RandomState(0).randn(3, 10)
    before = cheb_sweep.launches
    got = cheb_sweep(At.blocks, At.indices, x, coeffs, alpha=lmax / 2)
    want = cheb_sweep_plain(At.blocks, At.indices, x, coeffs, alpha=lmax / 2)
    torch.cuda.synchronize()
    assert cheb_sweep.launches == before + 1
    assert _rel(got, want) < 1e-4


def test_main_path_matches_float64_dense(cuda):
    g = tgraph.connected_sensor_graph(np.random.RandomState(0), n=1000,
                                      theta=0.06, kappa=0.06)
    g, _ = tgraph.spatial_sort(g)
    L, lmax = g.laplacian(), g.lambda_max_bound()
    op = GraphOperator(P=L, multipliers=twav.sgwt_multipliers(lmax, J=6),
                       lmax=lmax, K=20)
    dense = GraphOperator(P=L.double(), multipliers=op.multipliers,
                          lmax=lmax, K=20).plan("dense")
    F = torch.randn(64, 1000, device=cuda)
    a = torch.randn(64, 7, 1000, device=cuda)
    for plan in (op.plan("cuda"), op.plan("cuda", sweep=False)):
        for kind, x in (("apply", F), ("apply_adjoint", a),
                        ("apply_gram", F)):
            got = getattr(plan, kind)(x)
            want = getattr(dense, kind)(x.double())
            assert _rel(got.double(), want) < 1e-4, kind
