"""The fused instances of the Chebyshev and Jacobi steps and the loops
around them, on the CPU, held against the JAX package.

- `cheb_order_plain` (the sliced-ELL product followed by the Chebyshev
  step; order 1 from x) and `jacobi_round_plain` (q = a P h + c0 x, then
  the Jacobi update) against the JAX `block_ell_spmv` followed by its
  `cheb_step` / `jacobi_step` kernels in interpret mode, atol 2e-5 (the
  kernel tests' tolerance: f32 in another summation order);
- the per-order loop (one order launch per order, two rotating iterate
  buffers, the accumulator in place), the guard's fallback to it and the
  opaque-matvec loop (the stand-alone step) against the JAX `cheb_apply`,
  within 1e-5 of the output's max;
- the per-round Jacobi loop, with and without history, at deg(den) 1 and
  2, against the JAX `jacobi_solve` / `jacobi_chebyshev_solve`, atol
  1e-5 (tests/test_torch_solvers.py's tolerance against the reference
  solve);
- the caller's x and x0 come back unchanged, and the launch shapes
  (`vector_launch`, `slice_launch`) for ragged n and unaligned views.

The graph is a 300-vertex sensor graph (numpy seed 5), the signals numpy
draws; the CUDA instances themselves run only on the card
(tests/test_torch_gpu.py, marker `gpu`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chebyshev as jcheb
from repro.core import jacobi as jjacobi
from repro.core import graph as jgraph
from repro.kernels.bcsr_spmv import block_ell_spmv_batched as jspmv_batched
from repro.kernels.cheb_step import cheb_step as jcheb_step
from repro.kernels.jacobi_step import jacobi_step as jjacobi_step
from repro_torch.convert import block_ell_from_numpy
from repro_torch.core import graph as tgraph
from repro_torch.kernels import ops
from repro_torch.kernels.cheb_step import (cheb_order, cheb_order_plain,
                                           slice_launch, vector_launch)
from repro_torch.kernels.jacobi_step import jacobi_round, jacobi_round_plain

N, B, ETA, K, TAU = 300, 6, 3, 12, 0.5


@pytest.fixture(scope="module")
def graph300():
    """L and L_norm of one sensor graph, each in both packages' Block-ELL
    (n = 300 pads to 304: a partly filled last slice)."""
    g = tgraph.connected_sensor_graph(np.random.RandomState(5), n=N,
                                      theta=0.1, kappa=0.1)
    out = {}
    for kind in ("combinatorial", "normalized"):
        L = g.laplacian(kind).numpy()
        A = jgraph.to_block_ell(L, (8, 128))
        At = block_ell_from_numpy(np.asarray(A.blocks), np.asarray(A.indices),
                                  np.asarray(A.mask), A.n)
        out[kind] = (L, A, At)
    return out, g.lambda_max_bound()


def _randn(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_spmv(A, x):
    return np.asarray(jspmv_batched(A.blocks, A.indices, jnp.asarray(x),
                                    interpret=True))


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("batch", [1, B])
def test_cheb_order_plain_matches_reference_kernels(graph300, batch, first):
    (graphs, lmax) = graph300
    _, A, At = graphs["combinatorial"]
    S, n, alpha = At.sliced_ell(), A.padded_n, lmax / 2
    t1, t2 = _randn(1, (batch, n)), _randn(2, (batch, n))
    acc = _randn(3, (batch, ETA, n))
    px = _jax_spmv(A, t1)
    if first:
        coef = _randn(4, (2, ETA))
        want_t = px / alpha - t1
        want_acc = (0.5 * coef[0][:, None] * t1[:, None, :]
                    + coef[1][:, None] * want_t[:, None, :])
        got = cheb_order_plain(S, torch.from_numpy(t1), None, None,
                               torch.from_numpy(coef), alpha=alpha)
    else:
        coef = _randn(4, (ETA,))
        want_t, want_acc = (np.asarray(a) for a in jcheb_step(
            *(jnp.asarray(a) for a in (px, t1, t2, acc, coef)), alpha=alpha,
            interpret=True))
        got = cheb_order_plain(S, *(torch.from_numpy(a)
                                    for a in (t1, t2, acc, coef)),
                               alpha=alpha)
    np.testing.assert_allclose(got[0].numpy(), want_t, atol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), want_acc, atol=2e-5)
    # the wrapper on CPU tensors, with and without out= (t_k over t_{k-2})
    tt = [torch.from_numpy(a.copy()) for a in (t1, t2, acc)]
    cf = torch.from_numpy(coef)
    fresh = cheb_order(S, tt[0], None if first else tt[1], tt[2], cf,
                       alpha=alpha)
    assert all(torch.equal(a, b) for a, b in zip(fresh, got))
    out = (tt[1], tt[2])
    assert cheb_order(S, tt[0], None if first else tt[1], tt[2], cf,
                      alpha=alpha, out=out) is out
    assert torch.equal(tt[1], got[0]) and torch.equal(tt[2], got[1])


@pytest.mark.parametrize("shared", [True, False])
def test_jacobi_round_plain_matches_reference_kernels(graph300, shared):
    graphs, _ = graph300
    _, A, At = graphs["normalized"]
    S, n = At.sliced_ell(), A.padded_n
    h, x, xp = (_randn(s, (B, n)) for s in (5, 6, 7))
    rows = (n,) if shared else (B, n)
    y, invd = _randn(8, rows), np.abs(_randn(9, rows))
    a, c0, w, s = 0.7, TAU, 1.3, 0.4
    q = a * _jax_spmv(A, h) + c0 * x
    want = np.asarray(jjacobi_step(*(jnp.asarray(v)
                                     for v in (q, x, xp, y, invd)),
                                   w=w, s=s, interpret=True))
    args = [torch.from_numpy(v) for v in (h, x, xp, y, invd)]
    got = jacobi_round_plain(S, *args, a=a, c0=c0, w=w, s=s)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    out = args[2].clone()
    assert jacobi_round(S, *args[:2], out, *args[3:], a=a, c0=c0, w=w, s=s,
                        out=out) is out
    assert torch.equal(out, got)


def _jax_cheb_apply(L, x, coeffs, lmax):
    Lj = jnp.asarray(L)
    return np.asarray(jcheb.cheb_apply(lambda v: v @ Lj.T, jnp.asarray(x),
                                       jnp.asarray(coeffs), lmax))


def _counted_launcher(monkeypatch, name, calls):
    real = getattr(ops, name)

    def launcher(*a, **k):
        launch = real(*a, **k)

        def counted(*la):
            calls[name] += 1
            return launch(*la)

        return counted

    monkeypatch.setattr(ops, name, launcher)


def test_per_order_loops_match_reference_cheb_apply(graph300, monkeypatch):
    """The per-order path (K order launches, no SpMV), the guard's fallback
    to it, and the opaque-matvec loop (K - 1 stand-alone steps), each
    against the JAX recurrence; the caller's x is left as it was."""
    graphs, lmax = graph300
    L, A, At = graphs["combinatorial"]
    coeffs = np.random.RandomState(10).randn(ETA, K + 1).astype(np.float32)
    x = _randn(11, (B, A.padded_n))
    x[:, N:] = 0.0
    want = _jax_cheb_apply(np.pad(L, (0, A.padded_n - N)), x, coeffs, lmax)
    tol = 1e-5 * np.abs(want).max()
    calls = dict.fromkeys(("order_launcher", "step_launcher",
                           "sliced_ell_spmv"), 0)
    _counted_launcher(monkeypatch, "order_launcher", calls)
    _counted_launcher(monkeypatch, "step_launcher", calls)
    real_spmv = ops.sliced_ell_spmv

    def spmv(*a, **k):
        calls["sliced_ell_spmv"] += 1
        return real_spmv(*a, **k)

    monkeypatch.setattr(ops, "sliced_ell_spmv", spmv)
    xt = torch.from_numpy(x.copy())
    per_order = ops.fused_cheb_apply(At, xt, coeffs, lmax, sweep=False)
    assert calls == {"order_launcher": K, "step_launcher": 0,
                     "sliced_ell_spmv": 0}
    fallback = ops.fused_cheb_sweep(At, xt, coeffs, lmax, l2_budget=64)
    assert calls["order_launcher"] == 2 * K
    opaque = ops.fused_cheb_recurrence(lambda t: ops.spmv(At, t), xt,
                                       coeffs, lmax)
    assert calls == {"order_launcher": 2 * K, "step_launcher": K - 1,
                     "sliced_ell_spmv": K}
    for got in (per_order, fallback, opaque):
        assert tuple(got.shape) == (B, ETA, A.padded_n)
        np.testing.assert_allclose(got.numpy(), want, atol=tol)
    assert torch.equal(xt, torch.from_numpy(x))
    # K = 1 (order 1 alone) and a single unbatched signal
    one = ops.fused_cheb_apply(At, xt[0], coeffs[:, :2], lmax, sweep=False)
    np.testing.assert_allclose(
        one.numpy(), _jax_cheb_apply(np.pad(L, (0, A.padded_n - N)), x[0],
                                     coeffs[:, :2], lmax), atol=tol)


def _den_rows(L, den):
    """1 / diag(den(L)) in float64, den of degree 1 or 2 (L symmetric)."""
    d = den[0] + den[1] * np.diag(L).astype(np.float64)
    if len(den) > 2:
        d = d + den[2] * (L.astype(np.float64) ** 2).sum(1)
    return (1.0 / d).astype(np.float32)


@pytest.mark.parametrize("den", [(TAU, 1.0), (TAU, 0.3, 1.0)])
@pytest.mark.parametrize("method", ["jacobi", "cheb_jacobi"])
def test_per_round_jacobi_matches_reference_solvers(graph300, monkeypatch,
                                                    method, den):
    """The per-round path (the guard's fallback) and the history route,
    both one round launch per round, against the JAX solvers on Q =
    den(L_norm); x0 given and left as it was."""
    graphs, _ = graph300
    L, A, At = graphs["normalized"]
    n_iters, rho = 14, 0.95
    b = _randn(12, (B, N))
    x0 = 0.1 * _randn(13, (B, N))
    inv_d = _den_rows(L, den)
    Lj = jnp.asarray(L)

    def q_mv(v):
        acc = den[-1] * v
        for c in den[-2::-1]:
            acc = acc @ Lj.T + c * v
        return acc

    if method == "jacobi":
        ws = jjacobi.jacobi_weights(n_iters)
        wx, wh = jjacobi.jacobi_solve(q_mv, None, jnp.asarray(b), n_iters,
                                      x0=jnp.asarray(x0), return_history=True,
                                      inv_diag=jnp.asarray(inv_d))
    else:
        ws = jjacobi.cheb_jacobi_weights(rho, n_iters)
        wx, wh = jjacobi.jacobi_chebyshev_solve(
            q_mv, None, jnp.asarray(b), rho, n_iters, x0=jnp.asarray(x0),
            return_history=True, inv_diag=jnp.asarray(inv_d))
    calls = dict.fromkeys(("round_launcher",), 0)
    _counted_launcher(monkeypatch, "round_launcher", calls)
    args = [torch.from_numpy(v.copy()) for v in (b, inv_d, x0)]
    per_round = ops.fused_jacobi_sweep(At, args[0], args[1], den, ws,
                                       x0=args[2], l2_budget=64)
    x, hist = ops.fused_jacobi_history(At, args[0], args[1], den, ws,
                                       x0=args[2])
    assert calls["round_launcher"] == 2 * n_iters
    assert tuple(hist.shape) == (n_iters, B, N)
    np.testing.assert_allclose(per_round.numpy(), np.asarray(wx), atol=1e-5)
    np.testing.assert_allclose(hist.numpy(), np.asarray(wh), atol=1e-5)
    assert torch.equal(x, hist[-1]) and torch.equal(x, per_round)
    for got, want in zip(args, (b, inv_d, x0)):
        assert torch.equal(got, torch.from_numpy(want))


def test_launch_shapes_for_ragged_n_and_unaligned_views():
    """The stand-alone instances' 16-byte packs only where n is a multiple
    of the pack and every pointer is 16-byte aligned; the grids cover n
    and the signals (capped at 65535 rows of blocks)."""
    base = torch.empty(2 * 512 + 4).data_ptr()
    assert base % 16 == 0
    assert vector_launch(16384, 64, [base] * 7, 4) == (4, (16, 64))
    assert vector_launch(500, 8, [base] * 7, 4) == (4, (1, 8))
    assert vector_launch(1028, 3, [base] * 7, 4) == (4, (2, 3))
    assert vector_launch(203, 5, [base] * 7, 4) == (1, (1, 5))     # ragged n
    assert vector_launch(1028, 3, [base, base + 4], 4) == (1, (5, 3))
    assert vector_launch(1028, 3, [base, base + 8], 8) == (1, (5, 3))
    assert vector_launch(1028, 3, [base, base + 16], 8) == (2, (3, 3))
    assert vector_launch(12288, 3072, [base], 4) == (4, (12, 3072))
    assert vector_launch(8, 70000, [base], 4) == (4, (1, 65535))
    # an unaligned view: one element past an aligned start
    view = torch.zeros(2, 513)[:, 1:]
    assert view.data_ptr() % 16 == 4
    assert vector_launch(512, 2, [view.data_ptr()], 4)[0] == 1
    # the fused instances: signals per thread from the batch, groups of 4
    # slices, signal tiles capped at 65535
    assert slice_launch(512, 64) == (8, (128, 8))
    assert slice_launch(10, 15) == (2, (3, 8))
    assert slice_launch(10, 16) == (8, (3, 2))
    assert slice_launch(10, 17) == (8, (3, 3))
    assert slice_launch(1, 1) == (1, (1, 1))
    assert slice_launch(8192, 2**20) == (8, (2048, 65535))
