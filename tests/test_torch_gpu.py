"""Card-only tests: each Hopper kernel against its plain PyTorch version on
a CUDA device (the Chebyshev and Jacobi steps in both instances: the
stand-alone ones in place, on unaligned views and in f64, the fused order
and round instances on full and partly filled slices), and the main path,
the per-order and per-round paths (their launch counts), the Section-V
solvers, the lasso and SSL against float64 dense; both flash-attention kernels (tensor cores for
bf16 at D = 64 and 128, FFMA otherwise, at every head dim to 256, on
strided and unaligned views) and the reduced dense LM forward
through them; one KV-cache decode step with no host read (f32 and f8
caches, the VLM's M-RoPE, and the MoE, MLA, RWKV6, hymba and whisper
families against their flash forward); the bf16 instances of the two sweeps; float64 signals cast
at the plans' boundary; the 1-shard `cuda_halo` plan against the `cuda`
plan; the couplings' kernel on a general partition's compacted
couplings (the tiles read in place, joined, and past the tile table),
and two calls of a 1-shard general plan bit for bit; the ISTA shrink in
place; the wire codec on the card byte for byte the CPU's, and the faulted
sharded apply (2 gloo ranks on the card) equal to the CPU's; the serving
entries (`plan.compiled`, one CUDA graph per bucket) equal to the eager
plan calls bit for bit, captured once per bucket, with no host-to-device
copy after plan build; two train steps (autograd, the clip, AdamW) on the
card against the same steps on the CPU.

They carry the `gpu` marker and skip without a card (decided inside the
`cuda` fixture, never at import).  The machine with the card has no JAX,
so this file imports none (the kernels' reference there is their plain
version) and runs without the JAX-side tests/conftest.py:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_gpu.py

Tolerances: the kernels redo the plain versions' f32 arithmetic in another
summation order — 1e-5 relative for the SpMV, 1e-6 for the elementwise
kernels (Chebyshev step, Jacobi step, ISTA shrink), 1e-5 for their fused
order and round instances (a sliced-ELL product inside), 1e-4 for the sweeps
(9 orders, or up to 20 Jacobi rounds) and for every path against float64.
Flash attention against its plain version: 2e-5 in f32 and 2e-2 in bf16
(the JAX package's kernel tolerances, tests/test_kernels.py:69).  The
bf16 sweeps against their plain bf16 versions: 3e-2 (the JAX package's
bf16 sweep tolerance; the same roundings, which may fall differently
where the f32 sums run in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import filters as tfilters
from repro_torch.core import graph as tgraph
from repro_torch.core import jacobi as tjacobi
from repro_torch.core import lasso as tlasso
from repro_torch.core import ssl as tssl
from repro_torch.core import wavelets as twav
from repro_torch.configs import get_config
from repro_torch.dist import METHODS, GraphOperator
from repro_torch.dist import partition as tpm
from repro_torch.dist import quantize as tq
from repro_torch.dist.sharded import coupling_layout
from repro_torch.kernels import ops
from repro_torch.kernels.bcsr_spmv import (block_ell_spmv_plain,
                                           compact_coupling, coupling_plain,
                                           sliced_ell_spmv,
                                           sliced_ell_spmv_accumulate,
                                           sliced_ell_spmv_plain)
from repro_torch.kernels.cheb_step import (cheb_order, cheb_order_plain,
                                           cheb_step, cheb_step_plain)
from repro_torch.kernels.cheb_sweep import (cheb_sweep, cheb_sweep_plain,
                                            jacobi_sweep, jacobi_sweep_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ffma,
                                                 flash_attention_plain,
                                                 flash_attention_wgmma,
                                                 _tma_ready)
from repro_torch.kernels.jacobi_step import (jacobi_round,
                                             jacobi_round_plain, jacobi_step,
                                             jacobi_step_plain)
from repro_torch.kernels.soft_threshold import (ista_shrink,
                                                ista_shrink_plain)
from repro_torch.models import RunConfig, forward, init_params, lm_loss

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


@pytest.mark.parametrize("batch_shape", [(), (5,), (64,), (100,), (2, 3),
                                         (448,), (64, 7)])
def test_block_ell_spmv_kernel_matches_plain(structure, batch_shape):
    """The SpMV that replaces the Block-ELL kernels (the sliced-ELL kernel,
    B = 1 to the adjoint's 448 streams) against its plain version and the
    Block-ELL plain version on the same P."""
    At, _ = structure
    S = At.sliced_ell()
    gen = torch.Generator(device=At.device).manual_seed(0)
    x = torch.randn(batch_shape + (At.padded_n,), generator=gen,
                    device=At.device)
    before = sliced_ell_spmv.launches
    got = sliced_ell_spmv(S, x)
    torch.cuda.synchronize()
    assert sliced_ell_spmv.launches == before + 1
    assert _rel(got, sliced_ell_spmv_plain(S, x)) < 1e-5
    assert _rel(got, block_ell_spmv_plain(At.blocks, At.indices, x)) < 1e-5


@pytest.mark.parametrize("B", [1, 5, 37, 64])
@pytest.mark.parametrize("n", [203, 1000, 45])
def test_sliced_ell_spmv_kernel_ragged_n(cuda, n, B):
    """Any n (a last slice partly filled) and each signal tile (1, 2 and
    8 signals per thread), a ragged last tile of signals included."""
    g = tgraph.sensor_graph(np.random.RandomState(3), n=n, theta=0.1,
                            kappa=0.15)
    S = tgraph.to_sliced_ell(g.laplacian()).to(cuda)
    x = torch.randn(B, n, generator=torch.Generator(device=cuda)
                    .manual_seed(1), device=cuda)
    got = sliced_ell_spmv(S, x)
    want = x @ g.laplacian().to(cuda).T
    torch.cuda.synchronize()
    assert _rel(got, sliced_ell_spmv_plain(S, x)) < 1e-5
    assert _rel(got, want) < 1e-5


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


def _unaligned(t):
    """A contiguous copy of t that starts 4 bytes past a 16-byte boundary:
    the stand-alone instances take one element a thread there."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape).copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [500, 203])
def test_cheb_step_kernel_in_place_and_unaligned(cuda, n, dtype):
    """out= over t_{k-2} and acc (the loops' rotation), 16-byte packs and
    the one-element fallback (ragged n, an unaligned view), f32 and f64."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    pt, t1, t2 = (torch.randn(8, n, generator=gen, device=cuda, dtype=dtype)
                  for _ in range(3))
    acc = torch.randn(8, 7, n, generator=gen, device=cuda, dtype=dtype)
    coef = torch.randn(7, generator=gen, device=cuda, dtype=dtype)
    want = cheb_step_plain(pt, t1, t2, acc, coef, alpha=2.5)
    for args in ((pt, t1, t2), (_unaligned(pt), t1, _unaligned(t2))):
        tk, acc2 = args[2].clone(), acc.clone()
        got = cheb_step(*args[:2], tk, acc2, coef, alpha=2.5,
                        out=(tk, acc2))
        torch.cuda.synchronize()
        assert got[0] is tk and got[1] is acc2
        assert _rel(tk, want[0]) < 1e-6 and _rel(acc2, want[1]) < 1e-6


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("batch_shape", [(1,), (5,), (64,), (2, 3)])
def test_cheb_order_kernel_matches_plain(structure, ragged, batch_shape,
                                         first):
    """The order instance (the sliced-ELL product fused with the step; order
    1 from x) on a full and a partly filled last slice, each signal tile,
    fresh outputs and t_k written over t_{k-2} with acc in place."""
    for At, lmax in (structure, ragged):
        S = At.sliced_ell()
        gen = torch.Generator(device=At.device).manual_seed(7)
        shape = batch_shape + (At.padded_n,)
        t1, t2 = (torch.randn(shape, generator=gen, device=At.device)
                  for _ in range(2))
        acc = torch.randn(batch_shape + (7, At.padded_n), generator=gen,
                          device=At.device)
        coef = torch.randn((2, 7) if first else (7,), generator=gen,
                           device=At.device)
        t2_arg = None if first else t2
        want = cheb_order_plain(S, t1, t2_arg, acc, coef, alpha=lmax / 2)
        before = cheb_order.launches
        got = cheb_order(S, t1, t2_arg, acc, coef, alpha=lmax / 2)
        out = (t2.clone(), acc.clone())
        cheb_order(S, t1, None if first else out[0], out[1], coef,
                   alpha=lmax / 2, out=out)
        torch.cuda.synchronize()
        assert cheb_order.launches == before + 2
        for res in (got, out):
            assert _rel(res[0], want[0]) < 1e-5
            assert _rel(res[1], want[1]) < 1e-5


# the sweeps: batches 1 to 128 (ragged last signal tiles included),
# K in {1, 2, 20}, eta in {1, 7}, and a graph whose last 32-row slice is
# partly filled (n = 203, padded to 208)
SWEEP_BATCHES = [(), (1,), (5,), (64,), (2, 3), (128,)]


@pytest.fixture(scope="module")
def ragged(cuda):
    g = tgraph.connected_sensor_graph(np.random.RandomState(3), n=203,
                                      theta=0.1, kappa=0.15)
    At = tgraph.to_block_ell(g.laplacian(), (8, 8)).to(cuda)
    assert At.padded_n % 32 == 16
    return At, g.lambda_max_bound()


def _cheb_sweep_case(At, lmax, batch_shape, K, eta, scratch_dtype):
    S = At.sliced_ell()
    gen = torch.Generator(device=At.device).manual_seed(2)
    x = torch.randn(batch_shape + (At.padded_n,), generator=gen,
                    device=At.device)
    coeffs = np.random.RandomState(0).randn(eta, K + 1)
    before = cheb_sweep.launches
    got = cheb_sweep(S, x, coeffs, alpha=lmax / 2,
                     scratch_dtype=scratch_dtype)
    want = cheb_sweep_plain(S, x, coeffs, alpha=lmax / 2,
                            scratch_dtype=scratch_dtype)
    torch.cuda.synchronize()
    assert cheb_sweep.launches == before + 1
    assert got.dtype == torch.float32
    assert got.shape == batch_shape + (eta, At.padded_n)
    return got, want, x, coeffs


@pytest.mark.parametrize("K,eta", [(1, 1), (2, 7), (20, 7), (9, 3)])
@pytest.mark.parametrize("batch_shape", SWEEP_BATCHES)
def test_cheb_sweep_kernel_matches_plain(structure, batch_shape, K, eta):
    At, lmax = structure
    got, want, _, _ = _cheb_sweep_case(At, lmax, batch_shape, K, eta, "f32")
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("scratch_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("batch_shape", [(1,), (5,), (64,)])
def test_cheb_sweep_kernel_partly_filled_slice(ragged, batch_shape,
                                               scratch_dtype):
    At, lmax = ragged
    got, want, _, _ = _cheb_sweep_case(At, lmax, batch_shape, 20, 7,
                                       scratch_dtype)
    assert _rel(got, want) < (3e-2 if scratch_dtype == "bf16" else 1e-4)


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


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n", [500, 16384])
def test_jacobi_step_kernel_matches_plain(cuda, n, shared):
    gen = torch.Generator(device=cuda).manual_seed(3)
    qx, x, xp = (torch.randn(64, n, generator=gen, device=cuda)
                 for _ in range(3))
    rows = (n,) if shared else (64, n)
    y, invd = (torch.randn(rows, generator=gen, device=cuda)
               for _ in range(2))
    before = jacobi_step.launches
    got = jacobi_step(qx, x, xp, y, invd, w=1.7, s=0.3)
    want = jacobi_step_plain(qx, x, xp, y, invd, w=1.7, s=0.3)
    torch.cuda.synchronize()
    assert jacobi_step.launches == before + 1
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jacobi_step_kernel_over_x_prev_and_unaligned(cuda, dtype):
    """out= over x_prev (the loops' rotation), a shared row, an unaligned
    view and a ragged n, f32 and f64."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    for n in (512, 203):
        qx, x, xp = (torch.randn(6, n, generator=gen, device=cuda,
                                 dtype=dtype) for _ in range(3))
        y, invd = (torch.randn(n, generator=gen, device=cuda, dtype=dtype)
                   for _ in range(2))
        want = jacobi_step_plain(qx, x, xp, y, invd, w=1.3, s=0.2)
        for args in ((qx, x), (_unaligned(qx), _unaligned(x))):
            out = xp.clone()
            got = jacobi_step(*args, out, y, invd, w=1.3, s=0.2, out=out)
            torch.cuda.synchronize()
            assert got is out and _rel(out, want) < 1e-6


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("batch_shape", [(1,), (5,), (64,)])
def test_jacobi_round_kernel_matches_plain(structure, ragged, batch_shape,
                                          shared):
    """The round instance: q = a P h + c0 x fused with the update, h = x
    (deg(den) = 1) and h apart from x, y / inv_d shared or batched, the
    output over x_prev."""
    for At, _ in (structure, ragged):
        S = At.sliced_ell()
        gen = torch.Generator(device=At.device).manual_seed(9)
        shape = batch_shape + (At.padded_n,)
        h, x, xp = (torch.randn(shape, generator=gen, device=At.device)
                    for _ in range(3))
        rows = (At.padded_n,) if shared else shape
        y, invd = (torch.randn(rows, generator=gen, device=At.device)
                   for _ in range(2))
        for hh, a in ((x, 1.0), (h, 0.7)):
            want = jacobi_round_plain(S, hh, x, xp, y, invd, a=a, c0=0.5,
                                      w=1.4, s=0.3)
            before = jacobi_round.launches
            got = jacobi_round(S, hh, x, xp, y, invd, a=a, c0=0.5, w=1.4,
                               s=0.3)
            out = xp.clone()
            jacobi_round(S, hh, x, out, y, invd, a=a, c0=0.5, w=1.4, s=0.3,
                         out=out)
            torch.cuda.synchronize()
            assert jacobi_round.launches == before + 2
            assert _rel(got, want) < 1e-5 and _rel(out, want) < 1e-5


def test_per_order_and_per_round_paths_launch_the_fused_instances(
        solver_graph):
    """The per-order apply is K order launches and no SpMV, the history
    solve one round launch per round; both hold float64 and leave the
    caller's signals as they were."""
    Ln = solver_graph.laplacian("normalized")
    L, lmax = solver_graph.laplacian(), solver_graph.lambda_max_bound()
    op = twav.sgwt_operator(L, lmax, J=6, K=20)
    F = torch.randn(64, 1000, device="cuda")
    F0 = F.clone()
    counters = (sliced_ell_spmv, cheb_step, cheb_order)
    before = [k.launches for k in counters]
    got = op.plan("cuda", sweep=False).apply(F)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [0, 0, 20]
    want = GraphOperator(P=L.double(), multipliers=op.multipliers, lmax=lmax,
                         K=20).plan("dense").apply(F.double())
    assert _rel(got.double(), want) < 1e-4 and torch.equal(F, F0)
    mult = [tfilters.ssl_multiplier(tfilters.power_kernel(1), 0.5)]
    plan = GraphOperator(P=Ln, multipliers=mult, lmax=2.0, K=20).plan("cuda")
    x0 = torch.randn(64, 1000, device="cuda")
    x00 = x0.clone()
    counters = (sliced_ell_spmv, jacobi_step, jacobi_round, jacobi_sweep)
    before = [k.launches for k in counters]
    hist = plan.solve(F, "jacobi", tau=0.5, n_iters=20, x0=x0, history=True)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [0, 0, 20, 0]
    sweep = plan.solve(F, "jacobi", tau=0.5, n_iters=20, x0=x0)
    assert _rel(hist.x, sweep.x) < 1e-5 and torch.equal(hist.history[-1],
                                                        hist.x)
    assert torch.equal(F, F0) and torch.equal(x0, x00)


@pytest.mark.parametrize("form", ["scale", "signal_scale", "vertex"])
@pytest.mark.parametrize("n", [300, 16384])
def test_ista_shrink_kernel_matches_plain(cuda, n, form):
    gen = torch.Generator(device=cuda).manual_seed(4)
    a, phi_y, gram = (torch.randn(8, 7, n, generator=gen, device=cuda)
                      for _ in range(3))
    shape = {"scale": (7, 1), "signal_scale": (8, 7, 1),
             "vertex": (8, 7, n)}[form]
    thresh = 0.5 * torch.rand(shape, generator=gen, device=cuda)
    before = ista_shrink.launches
    got = ista_shrink(a, phi_y, gram, thresh, gamma=0.3)
    want = ista_shrink_plain(a, phi_y, gram, thresh, gamma=0.3)
    torch.cuda.synchronize()
    assert ista_shrink.launches == before + 1
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["scale", "signal_scale", "vertex"])
@pytest.mark.parametrize("n", [301, 16384])
def test_ista_shrink_in_place(cuda, n, form, dtype):
    """The shrink written over a (`out=a`, the ISTA loops' form) and its
    prepared loop launch against the plain version, the same bits twice;
    an unaligned view and a ragged n (one element a thread); out may not
    be phi_y."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a, phi_y, gram = (torch.randn(8, 7, n, generator=gen, device=cuda,
                                  dtype=dtype) for _ in range(3))
    shape = {"scale": (7, 1), "signal_scale": (8, 7, 1),
             "vertex": (8, 7, n)}[form]
    thresh = 0.5 * torch.rand(shape, generator=gen, device=cuda,
                              dtype=dtype)
    want = ista_shrink_plain(a, phi_y, gram, thresh, gamma=0.3)
    before = ista_shrink.launches
    a1 = a.clone()
    assert ista_shrink(a1, phi_y, gram, thresh, gamma=0.3, out=a1) is a1
    torch.cuda.synchronize()
    assert ista_shrink.launches == before + 1
    assert _rel(a1, want) < 1e-6
    update = ops.ista_launcher(phi_y, thresh, 0.3)
    a2 = a.clone()
    for _ in range(2):      # the loop's launch, over its iterate
        b = a.clone()
        assert update(b, gram, out=b) is b
        assert torch.equal(b, a1)
    assert torch.equal(update(a2, gram), a1) and torch.equal(a2, a)
    buf = torch.empty(a.numel() + 1, device=cuda, dtype=dtype)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    assert _rel(ista_shrink(view, phi_y, gram, thresh, gamma=0.3), want) \
        < 1e-6
    with pytest.raises(ValueError, match="never phi_y"):
        ista_shrink(a, phi_y, gram, thresh, gamma=0.3, out=phi_y)


def _jacobi_inputs(cuda, graph, den, batch_shape):
    """(sliced layout of L_norm, b, inv_d, x0) with zeros past n."""
    n_log = {"n500": 500, "n203": 203}[graph]
    g = tgraph.connected_sensor_graph(
        np.random.RandomState(1 if graph == "n500" else 3), n=n_log,
        theta=0.075 if graph == "n500" else 0.1,
        kappa=0.075 if graph == "n500" else 0.15)
    Ln = g.laplacian("normalized")
    block = (8, 128) if graph == "n500" else (8, 8)
    At = tgraph.to_block_ell(Ln, block).to(cuda)
    n = At.padded_n
    P = Ln.double()
    d = sum(c * torch.linalg.matrix_power(P, m).diagonal()
            for m, c in enumerate(den))
    inv_d = torch.zeros(n, device=cuda)
    inv_d[:n_log] = (1.0 / d).float()
    gen = torch.Generator(device=cuda).manual_seed(5)
    b = torch.randn(batch_shape + (n,), generator=gen, device=cuda)
    b[..., n_log:] = 0
    return At.sliced_ell(), b, inv_d, torch.zeros_like(b)


@pytest.mark.parametrize("den,n_iters", [((0.5,), 3), ((0.5, 1.0), 20),
                                         ((0.5, 0.0, 1.0), 10),
                                         ((0.5, 0.2, 0.0, 1.0), 5)])
@pytest.mark.parametrize("batch_shape", SWEEP_BATCHES)
@pytest.mark.parametrize("graph", ["n500", "n203"])
def test_jacobi_sweep_kernel_matches_plain(cuda, graph, batch_shape, den,
                                           n_iters):
    S, b, inv_d, x0 = _jacobi_inputs(cuda, graph, den, batch_shape)
    for ws in (tjacobi.jacobi_weights(n_iters),
               tjacobi.cheb_jacobi_weights(0.9, n_iters)):
        before = jacobi_sweep.launches
        got = jacobi_sweep(S, b, inv_d, ws, x0, den=den)
        want = jacobi_sweep_plain(S, b, inv_d, ws, x0, den=den)
        torch.cuda.synchronize()
        assert jacobi_sweep.launches == before + 1
        assert got.shape == b.shape
        assert _rel(got, want) < 1e-4


@pytest.fixture(scope="module")
def solver_graph(cuda):
    g = tgraph.connected_sensor_graph(np.random.RandomState(0), n=1000,
                                      theta=0.06, kappa=0.06)
    g, _ = tgraph.spatial_sort(g)
    return g


def test_solve_methods_match_float64_dense(solver_graph):
    """Fig. 2 setting (a): P = L_norm, tau = 0.5, r = 1, 20 rounds; the
    Jacobi methods are one jacobi_sweep launch each."""
    Ln = solver_graph.laplacian("normalized")
    mult = [tfilters.ssl_multiplier(tfilters.power_kernel(1), 0.5)]
    plan = GraphOperator(P=Ln, multipliers=mult, lmax=2.0, K=20).plan("cuda")
    dense = GraphOperator(P=Ln.double(), multipliers=mult, lmax=2.0,
                          K=20).plan("dense", device="cuda")
    Y = torch.randn(64, 1000, device="cuda")
    for method in METHODS:
        before = jacobi_sweep.launches
        got = plan.solve(Y, method, tau=0.5, r=1, n_iters=20)
        launched = jacobi_sweep.launches - before
        want = dense.solve(Y.double(), method, tau=0.5, r=1, n_iters=20)
        torch.cuda.synchronize()
        assert set(got.info) == set(want.info), method
        assert got.info["exchange_rounds"] == want.info["exchange_rounds"]
        if method == "cheb_jacobi":
            assert got.info["rho"] == pytest.approx(want.info["rho"],
                                                    rel=1e-9)
        assert _rel(got.x.double(), want.x) < 1e-4, method
        assert launched == (1 if method in ("jacobi", "cheb_jacobi") else 0)
    hist = plan.solve(Y, "jacobi", tau=0.5, n_iters=20, history=True)
    sweep = plan.solve(Y, "jacobi", tau=0.5, n_iters=20)
    assert _rel(hist.x, sweep.x) < 1e-5
    guarded = plan.solve(Y, "jacobi", tau=0.5, n_iters=20, check_every=7)
    assert _rel(guarded.x, sweep.x) < 1e-6
    assert guarded.info["rounds_run"] == 20


def test_lasso_and_ssl_match_float64_dense(solver_graph):
    L, lmax = solver_graph.laplacian(), solver_graph.lambda_max_bound()
    op = twav.sgwt_operator(L, lmax, J=6, K=20)
    op64 = GraphOperator(P=L.double(), multipliers=op.multipliers,
                         lmax=lmax, K=20)
    mu = [0.01] + [0.75] * 6
    gamma = tlasso.ista_step_size(op)
    Y = torch.randn(8, 1000, device="cuda")
    before = ista_shrink.launches
    got = op.plan("cuda").solve_lasso(Y, mu, gamma=gamma, n_iters=10)
    assert ista_shrink.launches - before == 10
    want = op64.plan("dense", device="cuda").solve_lasso(
        Y.double(), mu, gamma=gamma, n_iters=10)
    torch.cuda.synchronize()
    assert _rel(got.coeffs.double(), want.coeffs) < 1e-4
    assert _rel(got.signal.double(), want.signal) < 1e-4
    coords = solver_graph.coords.numpy()
    labels = (coords[:, 0] > 0.5).astype(np.int64) \
        + 2 * (coords[:, 1] > 0.5).astype(np.int64)
    mask = np.zeros(1000, bool)
    mask[np.random.default_rng(0).choice(1000, 100, replace=False)] = True
    Ln = solver_graph.laplacian("normalized")
    res = tssl.semi_supervised_classify(Ln, labels, mask, 4, backend="cuda",
                                        lmax=2.0)
    ref = tssl.semi_supervised_classify(Ln.double(), labels, mask, 4,
                                        backend="dense", lmax=2.0,
                                        device="cuda")
    assert _rel(res.scores.double(), ref.scores) < 1e-4
    assert tssl.accuracy(res, labels, mask) > 0.8


def _row_scaled_err(got, q, k, v, **kw) -> float:
    """A bf16 output's error against the plain version in f32 from the
    same inputs, less its own rounding (2^-8 of |ref|), over the rms of
    its row: late causal rows are small, where atol = 2e-2 sees nothing
    (chip_smoke.py holds the tensor-core kernel to the same 2e-2)."""
    ref = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    return float((((got.float() - ref).abs() - 2.0**-8 * ref.abs())
                  / rms).max())


def _flash_kernel(dtype, d):
    """The kernel `flash_attention` dispatches to: tensor cores for bf16
    at D = 64 and 128, the FFMA kernel otherwise."""
    return (flash_attention_wgmma if dtype == torch.bfloat16
            and d in (64, 128) else flash_attention_ffma)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (1, 2, 2, 128, 128, 64), (2, 4, 2, 256, 256, 64), (1, 8, 1, 256, 256, 128),
    (2, 4, 2, 100, 100, 16), (1, 6, 3, 1000, 1000, 32), (1, 4, 1, 64, 300, 128),
    (2, 24, 2, 512, 512, 128), (1, 2, 1, 300, 200, 64),
    (1, 3, 1, 1000, 1000, 128), (2, 12, 1, 129, 383, 128),
    # every FFMA width and head dims padded to one, S on both sides of the
    # 64-key and 128-row tile edges (64 rows and 32 keys at width 256),
    # Sq != Sk both ways, GQA groups 1, 2 and 12
    (1, 2, 2, 63, 63, 16), (2, 4, 2, 64, 65, 20), (1, 24, 2, 65, 64, 32),
    (1, 12, 1, 127, 129, 64), (1, 4, 2, 129, 127, 80),
    (2, 2, 1, 127, 65, 96), (1, 24, 2, 129, 300, 128),
    (1, 4, 4, 65, 63, 256), (1, 12, 1, 200, 129, 256),
    (1, 2, 1, 33, 31, 256), (1, 2, 2, 300, 64, 20),
    # grids too small for the card: the K range of a q tile split over
    # blocks and merged in the launch
    (1, 1, 1, 2000, 2000, 128), (1, 2, 1, 1500, 700, 256),
    (2, 1, 1, 700, 1500, 80)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, b, hq, hkv, sq, sk, d,
                                              causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(b, hq, sq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen, device=cuda).to(dtype)
    kern = _flash_kernel(dtype, d)
    before = kern.launches
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        assert _row_scaled_err(got, q, k, v, causal=causal) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_flash_attention_kernel_reads_strided_heads(cuda, dtype, d):
    """The (B, S, H, hd) views of a fused projection, and head slices of a
    larger (B, H, S, hd) tensor, give the contiguous result."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    qkv = torch.randn(2, 200, (8 + 2 * 2) * d, generator=gen,
                      device=cuda).to(dtype)
    q = qkv[..., :8 * d].view(2, 200, 8, d).transpose(1, 2)
    k = qkv[..., 8 * d:10 * d].view(2, 200, 2, d).transpose(1, 2)
    v = qkv[..., 10 * d:].view(2, 200, 2, d).transpose(1, 2)
    heads = torch.randn(2, 12, 200, d, generator=gen, device=cuda).to(dtype)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    kern = _flash_kernel(dtype, d)
    # TMA reads both kinds of view in place, strides in any order
    assert dtype != torch.bfloat16 or all(map(_tma_ready, (q, k, v)))
    for q, k, v in ((q, k, v), (heads[:, :8], heads[:, 8:10],
                                heads[:, 10:])):
        before = kern.launches
        got = flash_attention(q, k, v, causal=True, scale=0.1)
        want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True, scale=0.1)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        if dtype == torch.bfloat16:
            assert _row_scaled_err(got, q, k, v, causal=True,
                                   scale=0.1) <= 2e-2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_ffma_kernel_takes_bf16_at_tensor_core_dims(cuda, d, causal):
    """The FFMA kernel's own bf16 instances at the tensor-core kernel's
    head dims (`flash_attention` sends a non-positive scale there)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(1, 8, 200, d, generator=gen, device=cuda).bfloat16()
    k = torch.randn(1, 2, 200, d, generator=gen, device=cuda).bfloat16()
    v = torch.randn(1, 2, 200, d, generator=gen, device=cuda).bfloat16()
    for kw in ({}, {"scale": -0.05}):
        before = flash_attention_ffma.launches
        got = (flash_attention if kw else flash_attention_ffma)(
            q, k, v, causal=causal, **kw)
        want = flash_attention_plain(q, k, v, causal=causal, **kw)
        torch.cuda.synchronize()
        assert flash_attention_ffma.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        assert _row_scaled_err(got, q, k, v, causal=causal, **kw) <= 2e-2


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ffma_kernel_reads_unaligned_rows(cuda, causal):
    """f32 views at D = 20 whose rows start 4 bytes past 16 (a slice of a
    (.., 21) tensor): the kernel copies them element by element."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    base = torch.randn(2, 8, 150, 21, generator=gen, device=cuda)
    q, k, v = base[:, :4, :, 1:], base[:, 4:6, :, 1:], base[:, 6:, :, 1:]
    assert q.data_ptr() % 16 and q.stride(2) % 4
    before = flash_attention_ffma.launches
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_ffma.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_flash_ffma_kernel_rejects_head_dims_past_256(cuda):
    q = torch.zeros(1, 2, 8, 257, device=cuda)
    with pytest.raises(ValueError, match="head dims 1 to 256"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-7b"])
def test_reduced_lm_forward_through_flash_kernel(cuda, arch):
    """Two reduced layers in f32: one kernel launch per layer, logits
    within 1e-4 of the same forward through the plain chunked attention."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 200), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = flash_attention_ffma.launches
    got = forward(cfg, params, toks, RunConfig("flash"))
    torch.cuda.synchronize()
    assert flash_attention_ffma.launches == before + cfg.n_layers
    want = forward(cfg, params, toks, RunConfig("ref"))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert abs(float(lm_loss(got, toks)) - float(lm_loss(want, toks))) < 1e-4


@pytest.mark.parametrize("arch,cache_dtype", [
    ("starcoder2-3b", None), ("qwen2-vl-2b", None),
    ("starcoder2-3b", torch.float8_e4m3fn)])
def test_decode_step_reads_nothing_on_the_host(cuda, arch, cache_dtype):
    """Two reduced layers in f32: a prefill of 8 tokens, then one serve
    step under ``set_sync_debug_mode("error")`` (a host read in the step
    raises); the cache stays on the card and its logits match the
    forward's last prefilled position within 1e-4 (f8: correlation
    > 0.98, the JAX package's f8 criterion)."""
    from repro_torch.models import decode, steps

    cfg = get_config(arch).reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda,
                         generator=gen)
    cache = decode.init_cache(cfg, 2, 9, dtype=cache_dtype)
    assert cache["idx"].device.type == "cuda"
    logits, cache = decode.prefill(cfg, params, toks[:, :8], cache)
    serve_step = steps.build_serve_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nxt, cache = serve_step(params, cache, toks[:, 8:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert nxt.shape == (2,) and int(cache["idx"]) == 9
    assert cache["idx"].device.type == "cuda"
    want = forward(cfg, params, toks, RunConfig("ref"))
    if cache_dtype is None:
        torch.testing.assert_close(logits, want[:, 7], atol=1e-4, rtol=0)
    else:
        corr = torch.corrcoef(torch.stack([logits.flatten(),
                                           want[:, 7].flatten()]))[0, 1]
        assert float(corr) > 0.98


@pytest.mark.parametrize("K,eta", [(1, 1), (2, 7), (20, 7), (9, 3)])
@pytest.mark.parametrize("batch_shape", SWEEP_BATCHES)
def test_cheb_sweep_bf16_kernel_matches_plain(structure, batch_shape, K,
                                              eta):
    At, lmax = structure
    got, want, x, coeffs = _cheb_sweep_case(At, lmax, batch_shape, K, eta,
                                            "bf16")
    assert _rel(got, want) < 3e-2
    f32 = cheb_sweep_plain(At.sliced_ell(), x, coeffs, alpha=lmax / 2)
    assert _rel(got, f32) < 3e-2


@pytest.mark.parametrize("den", [(0.5,), (0.5, 1.0), (0.5, 0.0, 1.0)])
@pytest.mark.parametrize("batch_shape", [(), (5,), (64,), (128,)])
@pytest.mark.parametrize("graph", ["n500", "n203"])
def test_jacobi_sweep_bf16_kernel_matches_plain(cuda, graph, batch_shape,
                                                den):
    S, b, inv_d, x0 = _jacobi_inputs(cuda, graph, den, batch_shape)
    ws = tjacobi.cheb_jacobi_weights(0.9, 10)
    before = jacobi_sweep.launches
    got = jacobi_sweep(S, b, inv_d, ws, x0, den=den, scratch_dtype="bf16")
    want = jacobi_sweep_plain(S, b, inv_d, ws, x0, den=den,
                              scratch_dtype="bf16")
    torch.cuda.synchronize()
    assert jacobi_sweep.launches == before + 1
    assert _rel(got, want) < 3e-2


def test_bf16_plan_matches_float64_dense(solver_graph):
    """plan("cuda", sweep_dtype="bf16"): apply and the Jacobi solve within
    3e-2 of float64 dense, each one bf16 sweep launch."""
    L, lmax = solver_graph.laplacian(), solver_graph.lambda_max_bound()
    op = twav.sgwt_operator(L, lmax, J=6, K=20)
    dense = GraphOperator(P=L.double(), multipliers=op.multipliers,
                          lmax=lmax, K=20).plan("dense", device="cuda")
    plan = op.plan("cuda", sweep_dtype="bf16")
    F = torch.randn(64, 1000, device="cuda")
    before = cheb_sweep.launches
    got = plan.apply(F)
    assert cheb_sweep.launches == before + 1
    assert _rel(got.double(), dense.apply(F.double())) < 3e-2
    Ln = solver_graph.laplacian("normalized")
    mult = [tfilters.ssl_multiplier(tfilters.power_kernel(1), 0.5)]
    kw = dict(tau=0.5, r=1, n_iters=20)
    before = jacobi_sweep.launches
    got = GraphOperator(P=Ln, multipliers=mult, lmax=2.0, K=20).plan(
        "cuda", sweep_dtype="bf16").solve(F, "jacobi", **kw)
    assert jacobi_sweep.launches == before + 1
    want = GraphOperator(P=Ln.double(), multipliers=mult, lmax=2.0,
                         K=20).plan("dense", device="cuda").solve(
        F.double(), "jacobi", **kw)
    assert _rel(got.x.double(), want.x) < 3e-2


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_float64_signal_cast_to_plan_dtype_on_card(solver_graph, backend):
    """A float64 numpy signal meets the float32 plans on the card (cast at
    the plan's boundary, ROADMAP.md fault 3.1): float32 out, within 1e-4
    of the float64 dense plan."""
    L, lmax = solver_graph.laplacian(), solver_graph.lambda_max_bound()
    mult = twav.sgwt_multipliers(lmax, J=2)
    plan = GraphOperator(P=L, multipliers=mult, lmax=lmax,
                         K=12).plan(backend)
    dense = GraphOperator(P=L.double(), multipliers=mult, lmax=lmax,
                          K=12).plan("dense")
    rs = np.random.RandomState(0)
    x, a = rs.randn(4, 1000), rs.randn(4, 3, 1000)
    for kind, sig in (("apply", x), ("apply_adjoint", a), ("apply_gram", x),
                      ("solve", x)):
        if kind == "solve":
            got = plan.solve(sig, "jacobi", tau=0.5, n_iters=20).x
            want = dense.solve(sig, "jacobi", tau=0.5, n_iters=20).x
        else:
            got, want = getattr(plan, kind)(sig), getattr(dense, kind)(sig)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.is_cuda, kind
        assert float((got.double() - want).abs().max()) < 1e-4, kind


def test_one_shard_cuda_halo_is_the_cuda_plan(solver_graph):
    """Without a process group, cuda_halo's plan is one shard: `apply` is
    one cheb_sweep launch, bitwise the cuda plan's; a Jacobi solve is one
    jacobi_sweep launch; the adjoint K SpMV launches."""
    Ln = solver_graph.laplacian("normalized")
    mult = [tfilters.ssl_multiplier(tfilters.power_kernel(1), 0.5)]
    op = GraphOperator(P=Ln, multipliers=mult, lmax=2.0, K=20)
    one, cuda = op.plan("cuda_halo"), op.plan("cuda")
    assert one.info["n_shards"] == 1 and one.info["transport"] is None
    F = torch.randn(64, 1000, device="cuda")
    counters = (sliced_ell_spmv, cheb_step, cheb_sweep, jacobi_sweep)

    def launches(fn):
        before = [k.launches for k in counters]
        out = fn()
        torch.cuda.synchronize()
        return out, tuple(k.launches - b for k, b in zip(counters, before))

    got, n_apply = launches(lambda: one.apply(F))
    assert torch.equal(got, cuda.apply(F))
    assert n_apply == (0, 0, 1, 0)
    sol, n_solve = launches(lambda: one.solve(F, "jacobi", tau=0.5,
                                              n_iters=20))
    assert torch.equal(sol.x, cuda.solve(F, "jacobi", tau=0.5, n_iters=20).x)
    assert n_solve == (0, 0, 0, 1)
    a = torch.randn(64, 1, 1000, device="cuda")
    adj, n_adj = launches(lambda: one.apply_adjoint(a))
    assert n_adj == (20, 0, 0, 0)
    assert _rel(adj, cuda.apply_adjoint(a)) < 1e-6


@pytest.mark.parametrize("B", [1, 5, 16, 112])
@pytest.mark.parametrize("shards", [2, 4])
def test_coupling_spmv_kernel_matches_plain(cuda, shards, B):
    """y += C r on a general partition's couplings (a rectangular layout:
    the shard's padded rows by the received tiles' sum(h_k) columns, most
    slices empty) against the plain version, every rank's C; the launch
    counts on its own counter, and y outside C's rows is left as it was."""
    csr, _ = tpm.community_graph_csr(20000, seed=1)
    parts = tpm.partition_general(csr, shards, method="spectral",
                                  block=(8, 8))
    gen = torch.Generator(device=cuda).manual_seed(2)
    for s in range(shards):
        C = coupling_layout(parts, s, parts.n_local_padded, cuda)
        r = torch.randn(B, C.x_len, generator=gen, device=cuda)
        y0 = torch.randn(B, C.padded_n, generator=gen, device=cuda)
        before = (sliced_ell_spmv.launches,
                  sliced_ell_spmv_accumulate.launches)
        got = sliced_ell_spmv_accumulate(C, r, y0.clone())
        torch.cuda.synchronize()
        assert (sliced_ell_spmv.launches,
                sliced_ell_spmv_accumulate.launches) == (before[0],
                                                         before[1] + 1)
        want = sliced_ell_spmv_plain(C, r, out=y0.clone())
        assert _rel(got - y0, want - y0) < 1e-5
        # no atomics: a second launch on the same inputs gives the same bits
        assert torch.equal(sliced_ell_spmv_accumulate(C, r, y0.clone()), got)
        empty = torch.ones(C.padded_n, dtype=torch.bool, device=cuda)
        empty[C.entry_rows()[C.values != 0]] = False
        assert torch.equal(got[:, empty], y0[:, empty])


@pytest.mark.parametrize("B", [1, 3, 16, 112])
@pytest.mark.parametrize("shards", [2, 4])
def test_coupling_tiles_read_in_place(cuda, shards, B):
    """The couplings' kernel on a plan's compacted layout, given the tiles
    as a round receives them (separate tensors, one a strided, unaligned
    view), against its plain version; one launch, the same bits twice,
    and the same bits from the joined tiles and from the uncompacted
    layout; past the tile table (capacity 1) one launch per offset."""
    csr, _ = tpm.community_graph_csr(20000, seed=1)
    parts = tpm.partition_general(csr, shards, method="spectral",
                                  block=(8, 8))
    gen = torch.Generator(device=cuda).manual_seed(3)
    for s in range(shards):
        C = coupling_layout(parts, s, parts.n_local_padded, cuda)
        L = compact_coupling(C, parts.tile_widths)
        assert len(L.groups) == 1 and L.n_entry_rows < C.padded_n
        tiles = [torch.randn(B, h, generator=gen, device=cuda)
                 for h in parts.tile_widths]
        wide = torch.randn(B, tiles[0].shape[-1] + 3, generator=gen,
                           device=cuda)
        wide[:, 1:-2] = tiles[0]
        tiles[0] = wide[:, 1:-2]
        y0 = torch.randn(B, C.padded_n, generator=gen, device=cuda)
        before = sliced_ell_spmv_accumulate.launches
        got = sliced_ell_spmv_accumulate(L, tuple(tiles), y0.clone())
        torch.cuda.synchronize()
        assert sliced_ell_spmv_accumulate.launches == before + 1
        want = coupling_plain(L, tiles, y0.clone())
        assert _rel(got - y0, want - y0) < 1e-5
        assert torch.equal(
            sliced_ell_spmv_accumulate(L, tuple(tiles), y0.clone()), got)
        joined = torch.cat(tiles, -1)
        assert torch.equal(sliced_ell_spmv_accumulate(L, joined, y0.clone()),
                           got)
        assert torch.equal(sliced_ell_spmv_accumulate(C, joined, y0.clone()),
                           got)
        L1 = compact_coupling(C, parts.tile_widths, capacity=1)
        before = sliced_ell_spmv_accumulate.launches
        got1 = sliced_ell_spmv_accumulate(L1, tuple(tiles), y0.clone())
        torch.cuda.synchronize()
        assert sliced_ell_spmv_accumulate.launches == before + len(L1.groups)
        assert len(L1.groups) == len(parts.offsets)
        assert _rel(got1 - y0, want - y0) < 1e-5


def test_general_plan_same_bits_twice(cuda):
    """Two calls of a 1-shard general cuda_halo plan on the same input give
    the same bits (apply: one sweep; adjoint: K SpMVs), and match float64
    dense."""
    csr, meta = tpm.community_graph_csr(3000, seed=4)
    P = torch.from_numpy(csr.to_dense())
    op = GraphOperator(P=P, multipliers=twav.sgwt_multipliers(meta["lmax"],
                                                              J=3),
                       lmax=meta["lmax"], K=20)
    plan = op.plan("cuda_halo", partition="general",
                   partition_method="spectral")
    gen = torch.Generator(device=cuda).manual_seed(5)
    F = torch.randn(16, 3000, generator=gen, device=cuda)
    a = torch.randn(16, 4, 3000, generator=gen, device=cuda)
    assert torch.equal(plan.apply(F), plan.apply(F))
    assert torch.equal(plan.apply_adjoint(a), plan.apply_adjoint(a))
    dense = GraphOperator(P=P.double(), multipliers=op.multipliers,
                          lmax=meta["lmax"], K=20).plan("dense")
    assert _rel(plan.apply(F).double(), dense.apply(F.double())) < 1e-4


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shape", [(64, 327), (16, 22086), (3, 7),
                                   (2, 5, 24)])
def test_codec_wire_on_the_card_equals_cpu(cuda, shape, dtype):
    """The wire codec is torch ops on the tile's device: the card's int8
    and bf16 wires are the CPU's byte for byte, and so is their decode."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=cuda) * 3.0
    x[(0,) * (len(shape) - 1)] = 0.0                  # an all-zero row
    w, wc = tq.encode(x, dtype), tq.encode(x.cpu(), dtype)
    words = torch.int16 if dtype == "bf16" else torch.int8
    assert torch.equal(w.cpu().view(words), wc.view(words))
    assert torch.equal(tq.decode(w, dtype).cpu(), tq.decode(wc, dtype))


FAULT_WORLD = 2
FAULT_TOL = 1e-5


def _faulted_rank(rank, world, tmp):
    """One of FAULT_WORLD gloo ranks on the card: the faulted `cuda_halo`
    and `halo` applies on the card against the `halo` plan on the CPU of
    the same ranks (BENCH_faults.json's banded setup, n = 256)."""
    import json
    import os
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.dist import FaultSpec

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        rng = np.random.default_rng(0)
        n, bw = 256, 8
        Bm = np.zeros((n, n), np.float32)
        for i in range(n):
            lo, hi = max(0, i - bw), min(n, i + bw + 1)
            Bm[i, lo:hi] = rng.standard_normal(hi - lo) * 0.1
        Bm = np.abs(Bm + Bm.T) / 2
        op = GraphOperator(P=torch.from_numpy(np.diag(Bm.sum(1)) - Bm),
                           multipliers=[lambda lam: np.exp(-lam)],
                           lmax=float(2 * Bm.sum(1).max()), K=10)
        x = rng.standard_normal((4, n)).astype(np.float32)
        spec = FaultSpec(drop_prob=0.2, stale_prob=0.1, noise_prob=0.05,
                         seed=3)
        out = {}
        for dt in ("f32", "int8"):
            cpu = op.plan("halo", device="cpu", exchange_dtype=dt,
                          fault_spec=spec).apply(x)
            for backend in ("cuda_halo", "halo"):
                card = op.plan(backend, exchange_dtype=dt,
                               fault_spec=spec).apply(x).cpu()
                out[f"{backend}/{dt}"] = _rel(card.double(), cpu.double())
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def test_faulted_apply_on_the_card_equals_cpu(cuda, tmp_path):
    """The fault draws are the host's, so the faulted output on the card
    is the CPU's within 1e-5 at both wires."""
    import json

    import torch.multiprocessing as mp

    mp.spawn(_faulted_rank, args=(FAULT_WORLD, str(tmp_path)),
             nprocs=FAULT_WORLD, join=True)
    for r in range(FAULT_WORLD):
        with open(tmp_path / f"rank{r}.json") as f:
            rec = json.load(f)
        for key, rel in rec.items():
            assert rel <= FAULT_TOL, (r, key, rel)


# ---------------------------------------------------------------------------
# Serving: plan entries captured as one CUDA graph per (label, bucket)
# ---------------------------------------------------------------------------
SERVE_KINDS = ["apply", "apply_adjoint", "apply_gram", "solve"]


@pytest.fixture(scope="module")
def serve_plan(solver_graph):
    L, lmax = solver_graph.laplacian(), solver_graph.lambda_max_bound()
    op = GraphOperator(P=L, multipliers=twav.sgwt_multipliers(lmax, J=6),
                       lmax=lmax, K=20)
    return op.plan("cuda")


def _serve_entry(plan, kind):
    if kind == "solve":
        return (plan.compiled_solve("jacobi", tau=0.5, n_iters=8),
                lambda y: plan.solve(y, "jacobi", tau=0.5, n_iters=8).x)
    return plan.compiled(kind), getattr(plan, kind)


@pytest.mark.parametrize("kind", SERVE_KINDS)
def test_captured_entry_equals_eager_call(serve_plan, kind):
    """A captured entry (graph mode by the static rule) at B = 1, 8, 64
    equals the eager plan call bit for bit; two replays hand out tensors
    that do not alias; the capture recorded the kernels' launches."""
    entry, eager = _serve_entry(serve_plan, kind)
    assert entry.mode == "graph"
    n, eta = 1000, serve_plan.eta
    for B in (1, 8, 64):
        shape = (B, eta, n) if kind == "apply_adjoint" else (B, n)
        x = torch.randn(shape, device="cuda")
        first, second = entry(x), entry(x)
        want = eager(x)
        torch.cuda.synchronize()
        assert torch.equal(first, want) and torch.equal(second, want)
        assert first.data_ptr() != second.data_ptr()
        second.add_(1.0)                  # a caller's write stays its own
        assert torch.equal(entry(x), want)
        key = (shape, torch.float32)
        assert entry.captures[key] == 1 and entry.launches[key]


def test_interleaved_buckets_capture_once(serve_plan):
    """Ten interleaved calls at B = 1 and 8 capture once per bucket."""
    entry = serve_plan.compiled("apply_gram")
    xs = {B: torch.randn(B, 1000, device="cuda") for B in (1, 8)}
    for _ in range(10):
        for B, x in xs.items():
            entry(x)
    torch.cuda.synchronize()
    for B in (1, 8):
        assert entry.captures[((B, 1000), torch.float32)] == 1
        assert entry.replays[((B, 1000), torch.float32)] >= 10


@pytest.mark.parametrize("kind", SERVE_KINDS)
def test_no_host_to_device_copy_after_plan_build(serve_plan, kind):
    """The coefficient and weight tables are on the card from plan build
    (the solve's after its first call): an eager call copies nothing from
    the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, eager = _serve_entry(serve_plan, kind)
    shape = (8, serve_plan.eta, 1000) if kind == "apply_adjoint" \
        else (8, 1000)
    x = torch.randn(shape, device="cuda")
    eager(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eager(x)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    assert names, "the profiler saw no device work"
    assert not [k for k in names if "htod" in k.lower().replace(" ", "")]


# ---------------------------------------------------------------------------
# the train step on the card against the same step on the CPU
# ---------------------------------------------------------------------------
def _tree_to(tree, dev):
    return {k: (_tree_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen3-moe-30b-a3b",
                                  "rwkv6-1.6b", "hymba-1.5b",
                                  "whisper-large-v3"])
def test_family_decode_step_reads_nothing_on_the_host(cuda, arch):
    """The other families, two reduced layers in f32: a prefill of 8
    tokens, then one serve step under ``set_sync_debug_mode("error")``;
    every cache tensor stays on the card and the step's logits match the
    forward's (through the flash kernels) at that position within 1e-4,
    the MoE at the capacity factor that drops nothing."""
    from repro_torch.models import decode, steps

    cfg = get_config(arch).reduced()
    run = RunConfig("ref", moe_capacity_factor=(
        cfg.n_experts / cfg.top_k if cfg.n_experts else None))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda,
                         generator=gen)
    extra = {}
    if cfg.is_encoder_decoder:
        extra["encoder_frames"] = torch.randn(
            2, cfg.encoder_seq, cfg.d_model, device=cuda, generator=gen)
    cache = decode.start_cache(cfg, params, 2, 9, run, **extra)
    decode.prefill(cfg, params, toks[:, :8], cache, run)
    serve_step = steps.build_serve_step(cfg, run)
    seen = []
    real = decode.decode_step

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out[0])
        return out

    torch.cuda.synchronize()
    decode.decode_step = recording
    torch.cuda.set_sync_debug_mode("error")
    try:
        nxt, cache = serve_step(params, cache, toks[:, 8:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
        decode.decode_step = real
    assert nxt.shape == (2,) and int(cache["idx"]) == 9
    assert all(t.device.type == "cuda" for t in cache.values())
    want = forward(cfg, params, toks,
                   dataclasses.replace(run, attn_impl="flash"), **extra)
    torch.testing.assert_close(seen[0], want[:, 8], atol=1e-4, rtol=0)


def _tree_max_abs(a, b):
    return max((_tree_max_abs(v, b[k]) if isinstance(v, dict)
                else float((v.cpu().float() - b[k].float()).abs().max()))
               for k, v in a.items())


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen1.5-4b",
                                  "qwen2-vl-2b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Two reduced layers in f32, two train steps (autograd through the
    plain attention, the clip, AdamW) from the same weights and batches on
    the card and on the CPU: loss and grad norm within 1e-5 (relative for
    the norm), params within 2e-5, m and v within 5e-5 of the largest
    (tests/test_torch_train.py's tolerances against the JAX step)."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import steps
    from repro_torch.optim import adamw_init

    cfg = get_config(arch).reduced()
    host = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = _tree_to(host, cuda)
    s_host, s_card = adamw_init(host), adamw_init(card)
    assert s_card.step.device.type == "cuda"
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=0,
        n_vision_tokens=cfg.n_vision_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model)
    step = steps.build_train_step(cfg, RunConfig("ref"), lr=1e-3)
    for i in range(2):
        b = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        host, s_host, m_host = step(host, s_host, b)
        card, s_card, m_card = step(card, s_card, _tree_to(b, cuda))
        assert m_card["loss"].device.type == "cuda"
        assert abs(float(m_card["loss"]) - float(m_host["loss"])) <= 1e-5
        assert abs(float(m_card["grad_norm"]) - float(m_host["grad_norm"])) \
            <= 1e-5 * float(m_host["grad_norm"])
    assert int(s_card.step) == 2
    assert _tree_max_abs(card, host) <= 2e-5
    for a, b in ((s_card.m, s_host.m), (s_card.v, s_host.v)):
        scale = max(float(t.abs().max()) for t in
                    (x for v in b.values() for x in
                     (v.values() if isinstance(v, dict) else (v,))))
        assert _tree_max_abs(a, b) <= 5e-5 * scale
