"""The port's core math (graphs, Block-ELL packing, coefficient tables,
Chebyshev applications) held against the JAX package on shared numpy
inputs.

Host-numpy tables and packing must be bitwise equal.  Torch applications
over a dense matvec must agree within atol 2e-5, the tolerance of the
reference's own sweep-vs-per-order test (tests/test_sweep.py:66): both
sides run the same f32 recurrence and differ only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chebyshev as jcheb
from repro.core import filters as jfilters
from repro.core import graph as jgraph
from repro.core import wavelets as jwav
from repro.core.multiplier import UnionMultiplier as JUnion
from repro_torch.core import chebyshev as tcheb
from repro_torch.core import filters as tfilters
from repro_torch.core import graph as tgraph
from repro_torch.core import wavelets as twav
from repro_torch.core.multiplier import UnionMultiplier as TUnion

BATCH_SHAPES = [(), (64,), (2, 3)]


@pytest.fixture(scope="module")
def lap120(sensor120):
    """(L, lmax) of the n=120 reference sensor graph, as numpy."""
    return np.asarray(sensor120.laplacian()), sensor120.lambda_max_bound()


def _families(lmax):
    """The same multiplier unions built by each package."""
    return {
        "sgwt": (jwav.sgwt_multipliers(lmax, J=2),
                 twav.sgwt_multipliers(lmax, J=2)),
        "tikhonov_heat": ([jfilters.tikhonov(2.0), jfilters.heat(0.3)],
                          [tfilters.tikhonov(2.0), tfilters.heat(0.3)]),
        "inverse": ([jfilters.inverse_filter(jfilters.heat(0.5), 1.0, 2)],
                    [tfilters.inverse_filter(tfilters.heat(0.5), 1.0, 2)]),
    }


@pytest.mark.parametrize("family", ["sgwt", "tikhonov_heat", "inverse"])
@pytest.mark.parametrize("K", [5, 20])
def test_coefficient_tables_bitwise(lap120, family, K):
    _, lmax = lap120
    jm, tm = _families(lmax)[family]
    cj = jcheb.cheb_coeffs_stack(jm, K, lmax)
    ct = tcheb.cheb_coeffs_stack(tm, K, lmax)
    assert ct.dtype == cj.dtype and np.array_equal(ct, cj)
    assert np.array_equal(tcheb.gram_coeffs(ct), jcheb.gram_coeffs(cj))
    assert np.array_equal(tcheb.cheb_product_coeffs(ct[0], ct[-1]),
                          jcheb.cheb_product_coeffs(cj[0], cj[-1]))


def test_wavelet_design_matches(lap120):
    _, lmax = lap120
    assert np.array_equal(twav.set_scales(lmax, 6), jwav.set_scales(lmax, 6))
    lam = np.linspace(0.0, lmax, 257)
    assert np.array_equal(twav.wavelet_kernel()(lam),
                          jwav.wavelet_kernel()(lam))
    assert twav.frame_bounds(twav.sgwt_multipliers(lmax, 4), lmax) == \
        jwav.frame_bounds(jwav.sgwt_multipliers(lmax, 4), lmax)


@pytest.mark.parametrize("case", ["n120", "n500", "banded600_8x8",
                                  "banded600_16x32"])
def test_to_block_ell_bitwise(sensor120, sensor_banded, case):
    """The vectorised packing equals the reference's loop, bit for bit."""
    if case == "n500":
        g, _ = jgraph.connected_sensor_graph(
            jax.random.PRNGKey(1), n=500, theta=0.075, kappa=0.075)
    else:
        g = sensor120 if case == "n120" else sensor_banded
    block = {"banded600_8x8": (8, 8),
             "banded600_16x32": (16, 32)}.get(case, (8, 128))
    L = np.asarray(g.laplacian())
    ref = jgraph.to_block_ell(L, block)
    got = tgraph.to_block_ell(L, block)
    for name in ("blocks", "indices", "mask"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.n == ref.n and got.padded_n == ref.padded_n


def test_laplacian_bound_connectivity_sort(sensor_banded):
    """Laplacians, the Anderson-Morley bound, BFS connectivity and the
    strip sort agree with the reference on the same W."""
    W = np.array(sensor_banded.W)
    for kind in ("combinatorial", "normalized"):
        np.testing.assert_allclose(
            tgraph.laplacian(W, kind).numpy(),
            np.asarray(jgraph.laplacian(jnp.asarray(W), kind)),
            rtol=1e-6, atol=1e-6)
        assert tgraph.lambda_max_bound(W, kind, chunk=7) == pytest.approx(
            jgraph.lambda_max_bound(jnp.asarray(W), kind), rel=1e-6)
    tg = tgraph.Graph(W=torch.from_numpy(W),
                      coords=torch.from_numpy(
                          np.asarray(sensor_banded.coords)))
    assert tg.is_connected() == sensor_banded.is_connected()
    assert tg.n_edges == sensor_banded.n_edges
    shuffled = np.random.RandomState(3).permutation(W.shape[0])
    jg = jgraph.Graph(W=jnp.asarray(W[np.ix_(shuffled, shuffled)]),
                      coords=jnp.asarray(
                          np.asarray(sensor_banded.coords)[shuffled]))
    tg = tgraph.Graph(W=torch.from_numpy(W[np.ix_(shuffled, shuffled)]),
                      coords=torch.from_numpy(
                          np.asarray(sensor_banded.coords)[shuffled]))
    (jgs, jorder), (tgs, torder) = jgraph.spatial_sort(jg), \
        tgraph.spatial_sort(tg)
    assert np.array_equal(jorder, torder)
    assert np.array_equal(np.asarray(jgs.W), tgs.W.numpy())


def test_sensor_graph_chunking_and_generators():
    """Row chunks do not change W; the generator draws a connected,
    symmetric graph with a zero diagonal; path and ring graphs equal the
    reference's."""
    a = tgraph.sensor_graph(np.random.RandomState(7), n=300, theta=0.1,
                            kappa=0.12, chunk=7)
    b = tgraph.sensor_graph(np.random.RandomState(7), n=300, theta=0.1,
                            kappa=0.12, chunk=10**6)
    assert torch.equal(a.W, b.W) and torch.equal(a.coords, b.coords)
    g = tgraph.connected_sensor_graph(np.random.RandomState(0), n=200,
                                      theta=0.15, kappa=0.2)
    assert g.is_connected()
    assert torch.equal(g.W, g.W.T) and not g.W.diagonal().any()
    assert np.array_equal(tgraph.path_graph(9).W.numpy(),
                          np.asarray(jgraph.path_graph(9).W))
    assert np.array_equal(tgraph.ring_graph(9).W.numpy(),
                          np.asarray(jgraph.ring_graph(9).W))


@pytest.mark.parametrize("kind", ["apply", "adjoint", "gram"])
@pytest.mark.parametrize("batch_shape", BATCH_SHAPES)
def test_cheb_applications_match_reference(lap120, kind, batch_shape):
    """cheb_apply / cheb_apply_adjoint / cheb_apply_gram over a dense
    matvec, eta = 3, on the same (P, signal)."""
    L, lmax = lap120
    coeffs = jcheb.cheb_coeffs_stack(jwav.sgwt_multipliers(lmax, J=2), 12,
                                     lmax)
    n, eta = L.shape[0], coeffs.shape[0]
    shape = batch_shape + ((eta, n) if kind == "adjoint" else (n,))
    x = np.random.RandomState(11).randn(*shape).astype(np.float32)
    Lj, Lt = jnp.asarray(L), torch.from_numpy(L)

    def jmv(v):
        return jnp.einsum("ij,...j->...i", Lj, v)

    def tmv(v):
        return v @ Lt.T

    jfn = {"apply": jcheb.cheb_apply, "adjoint": jcheb.cheb_apply_adjoint,
           "gram": jcheb.cheb_apply_gram}[kind]
    tfn = {"apply": tcheb.cheb_apply, "adjoint": tcheb.cheb_apply_adjoint,
           "gram": tcheb.cheb_apply_gram}[kind]
    jc = coeffs if kind == "gram" else jnp.asarray(coeffs, jnp.float32)
    want = np.asarray(jfn(jmv, jnp.asarray(x), jc, lmax))
    got = tfn(tmv, torch.from_numpy(x), coeffs, lmax).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_stateful_matvec_protocol_threads_state(lap120):
    """A matvec exposing init_state gets its state threaded through every
    order, exactly one call per order."""
    L, lmax = lap120
    Lt = torch.from_numpy(L)
    calls = []

    def mv(v, state):
        calls.append(state)
        return v @ Lt.T, state + 1

    mv.init_state = lambda x: 0
    coeffs = np.random.RandomState(2).randn(2, 7)
    x = torch.from_numpy(np.random.RandomState(3).randn(4, L.shape[0])
                         .astype(np.float32))
    out = tcheb.cheb_apply(mv, x, coeffs, lmax)
    assert calls == list(range(6))
    plain = tcheb.cheb_apply(lambda v: v @ Lt.T, x, coeffs, lmax)
    assert torch.equal(out, plain)


def test_union_multiplier_oracle_and_bounds(lap120):
    """exact_apply (torch.linalg.eigh oracle), the Prop. 4 bound and the
    message counts agree with the reference UnionMultiplier."""
    L, lmax = lap120
    jop = JUnion(P=jnp.asarray(L), multipliers=jwav.sgwt_multipliers(lmax, 2),
                 lmax=lmax, K=12)
    top = TUnion(P=torch.from_numpy(L),
                 multipliers=twav.sgwt_multipliers(lmax, 2), lmax=lmax, K=12)
    f = np.random.RandomState(5).randn(3, L.shape[0]).astype(np.float32)
    np.testing.assert_allclose(top.exact_apply(torch.from_numpy(f)).numpy(),
                               np.asarray(jop.exact_apply(jnp.asarray(f))),
                               atol=1e-4)
    a = np.asarray(jop.exact_apply(jnp.asarray(f)))
    np.testing.assert_allclose(
        top.exact_apply_adjoint(torch.from_numpy(a)).numpy(),
        np.asarray(jop.exact_apply_adjoint(jnp.asarray(a))), atol=1e-4)
    np.testing.assert_allclose(top.apply(torch.from_numpy(f)).numpy(),
                               np.asarray(jop.apply(jnp.asarray(f))),
                               atol=2e-5)
    assert top.error_bound() == pytest.approx(jop.error_bound(), rel=1e-3,
                                              abs=1e-5)
    assert top.message_counts(77) == jop.message_counts(77)
    assert np.array_equal(top.coeffs, jop.coeffs)
