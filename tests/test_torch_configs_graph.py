"""The paper's workload and the graph and signal leftovers of the port:
`repro_torch.configs.SENSOR500`, `core.graph.k_scaling_matrix`,
`core.graph.two_cluster_graph` and `data.graph_signal_batch`, against the
JAX package.

SENSOR500 is held field for field, `k_scaling_matrix` on the `sensor120`
fixture at gamma 0 and 0.3 to 1e-6 relative (and to L_norm at gamma 0,
as tests/test_graph.py:43 holds the reference), the deterministic signal
kinds to 1e-6 on the same coordinates.  The JAX `two_cluster_graph`
draws from a jax PRNG key, which the port cannot reproduce, so the
port's (a numpy Generator) is held by its properties: symmetric, 0/1,
zero diagonal, two labelled blocks, densities within 3 sigma of p_in and
p_out at n_per = 200, connected at the examples' settings.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SENSOR500 as JSENSOR500
from repro.core import graph as jgraph
from repro.data.pipeline import graph_signal_batch as jsignal
from repro_torch.configs import SENSOR500
from repro_torch.core import graph
from repro_torch.data import graph_signal_batch


def test_sensor500_field_for_field():
    want = dataclasses.asdict(JSENSOR500)
    assert dataclasses.asdict(SENSOR500) == want
    assert type(SENSOR500).__name__ == "GraphWorkloadConfig"
    assert SENSOR500.n_vertices == 500 and SENSOR500.K == 20
    with pytest.raises(dataclasses.FrozenInstanceError):
        SENSOR500.K = 10


@pytest.mark.parametrize("gamma", [0.0, 0.3])
def test_k_scaling_matrix_matches_reference(sensor120, gamma):
    W = np.asarray(sensor120.W)
    want = np.asarray(jgraph.k_scaling_matrix(jnp.asarray(W), gamma))
    got = graph.k_scaling_matrix(torch.from_numpy(W.copy()), gamma)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-6)
    # numpy input takes the same path
    np.testing.assert_array_equal(graph.k_scaling_matrix(W, gamma).numpy(),
                                  got.numpy())


def test_k_scaling_matrix_at_zero_is_l_norm(sensor120):
    W = torch.from_numpy(np.asarray(sensor120.W).copy())
    np.testing.assert_allclose(graph.k_scaling_matrix(W, 0.0).numpy(),
                               graph.laplacian(W, "normalized").numpy(),
                               atol=1e-6)


def test_two_cluster_graph_structure():
    g, labels = graph.two_cluster_graph(
        30, 0.5, 0.1, generator=np.random.default_rng(0))
    W = g.W.numpy()
    assert W.shape == (60, 60) and W.dtype == np.float32
    np.testing.assert_array_equal(W, W.T)
    assert set(np.unique(W)) <= {0.0, 1.0}
    assert not W.diagonal().any()
    np.testing.assert_array_equal(labels.numpy(),
                                  np.repeat([0, 1], 30))
    # one generator draw: the same seed gives the same graph
    g2, _ = graph.two_cluster_graph(30, 0.5, 0.1,
                                    generator=np.random.default_rng(0))
    assert torch.equal(g.W, g2.W)


@pytest.mark.parametrize("seed", [0, 1])
def test_two_cluster_graph_densities_within_three_sigma(seed):
    n_per, p_in, p_out = 200, 0.3, 0.05
    g, labels = graph.two_cluster_graph(
        n_per, p_in, p_out, generator=np.random.default_rng(seed))
    W = g.W.numpy()
    lab = labels.numpy()
    iu = np.triu_indices(2 * n_per, k=1)
    same = (lab[:, None] == lab[None, :])[iu]
    edges = W[iu]
    for p, pick in ((p_in, same), (p_out, ~same)):
        m = int(pick.sum())
        sigma = np.sqrt(p * (1 - p) / m)
        assert abs(edges[pick].mean() - p) <= 3 * sigma, (p, m)


@pytest.mark.parametrize("seed", range(5))
def test_two_cluster_graph_connected_at_example_settings(seed):
    """examples/semi_supervised.py's n_per = 25, p_in 0.85, p_out 0.06."""
    g, _ = graph.two_cluster_graph(25, 0.85, 0.06,
                                   generator=np.random.default_rng(seed))
    assert g.is_connected()
    assert g.n_edges > 0


@pytest.mark.parametrize("kind", ["smooth", "piecewise"])
def test_graph_signal_batch_matches_reference(sensor120, kind):
    coords = np.asarray(sensor120.coords)
    want = np.asarray(jsignal(None, jnp.asarray(coords), kind))
    got = graph_signal_batch(torch.from_numpy(coords.copy()), kind)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # numpy coordinates work too
    np.testing.assert_array_equal(
        graph_signal_batch(coords.copy(), kind).numpy(), got.numpy())


def test_graph_signal_batch_uniform_draws_from_the_generator():
    coords = torch.rand(400, 2, generator=torch.Generator().manual_seed(0))
    a = graph_signal_batch(coords, "uniform",
                           generator=torch.Generator().manual_seed(5))
    b = graph_signal_batch(coords, "uniform",
                           generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == (400,)
    assert float(a.min()) >= -10.0 and float(a.max()) <= 10.0
    assert abs(float(a.mean())) < 1.5   # Uniform[-10, 10]: sd of mean 0.29
    with pytest.raises(ValueError):
        graph_signal_batch(coords, "uniform")
    with pytest.raises(ValueError):
        graph_signal_batch(coords, "bogus")
