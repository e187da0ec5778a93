"""The frozen sensor-network generator: degree, weights, the largest
connected component, strip order and the seed."""
import json
import math
from pathlib import Path

import pytest
import torch

from portbench.reference import graph

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _radius(n):
    # the paper's kappa 0.075 and theta 0.074 at n = 500, scaled to hold
    # its mean degree at n
    scale = math.sqrt(500.0 / n)
    return 0.075 * scale, 0.074 * scale


def _draw(seed, n):
    kappa, theta = _radius(n)
    gen = torch.Generator().manual_seed(seed)
    return graph.draw(gen, n, kappa, theta), kappa, theta


def _connected(g):
    return bool((graph.components(g.n, g.rows, g.cols) == 0).all())


def _expected_degree(n, kappa):
    # a uniform point of the unit square, radius kappa:
    # (n - 1) (pi kappa^2 - 8/3 kappa^3 + kappa^4 / 2)
    return (n - 1) * (math.pi * kappa ** 2 - 8.0 / 3.0 * kappa ** 3
                      + kappa ** 4 / 2.0)


@pytest.mark.parametrize("config", ["sensor16k_sgwt", "sensor16k_tikhonov"])
def test_configs_hold_the_papers_degree_and_ratio(config):
    cfg = json.loads((CONFIGS / f"{config}.json").read_text())
    kappa, theta = _radius(cfg["n"])
    assert cfg["n"] == 16384
    assert cfg["kappa"] == pytest.approx(kappa, rel=1e-15)
    assert cfg["theta"] == pytest.approx(theta, rel=1e-15)
    # the same mean degree as the paper's 500 sensors, within the square's
    # edge effect
    assert _expected_degree(cfg["n"], kappa) == pytest.approx(
        _expected_degree(500, 0.075), rel=0.08)


def test_mean_degree_matches_the_unit_square():
    n = 4096
    g, kappa, _ = _draw(11, n)
    got = 2 * g.n_edges / g.n
    assert abs(got - _expected_degree(n, kappa)) < 0.4, got
    assert g.drawn == n and g.n > 0.99 * n


def test_edges_are_every_pair_within_kappa_with_its_weight():
    n = 300
    kappa = theta = 0.2
    g = graph.draw(torch.Generator().manual_seed(5), n, kappa, theta)
    assert g.n == n
    d2 = ((g.coords[:, None, :] - g.coords[None, :, :]) ** 2).sum(-1)
    near = d2 <= kappa * kappa
    near.fill_diagonal_(False)
    i, j = near.nonzero(as_tuple=True)
    assert torch.equal(g.rows, i) and torch.equal(g.cols, j)
    torch.testing.assert_close(
        g.w, torch.exp(-d2[i, j] / (2 * theta * theta)), rtol=0, atol=0)
    W = g.dense(torch.float64)
    assert torch.equal(W, W.T) and not bool(W.diagonal().any())


def test_connected_strip_ordered_and_fixed_by_the_seed():
    g, _, _ = _draw(2 ** 40 + 7, 1024)
    assert _connected(g)
    assert bool((g.coords[1:, 1] >= g.coords[:-1, 1]).all())
    h, _, _ = _draw(2 ** 40 + 7, 1024)
    assert torch.equal(g.rows, h.rows) and torch.equal(g.w, h.w)
    other, _, _ = _draw(2 ** 40 + 8, 1024)
    assert not torch.equal(g.coords, other.coords)


def test_components_are_labelled_by_their_least_vertex():
    # two paths, 0-1-2 and 3-4, then joined by 2-3
    rows = torch.tensor([0, 1, 1, 2, 3, 4])
    cols = torch.tensor([1, 0, 2, 1, 4, 3])
    assert graph.components(5, rows, cols).tolist() == [0, 0, 0, 3, 3]
    rows = torch.cat([rows, torch.tensor([2, 3])])
    cols = torch.cat([cols, torch.tensor([3, 2])])
    assert graph.components(5, rows, cols).tolist() == [0] * 5


def test_the_largest_component_is_kept_and_renumbered():
    # at this radius a draw of 64 sensors falls apart; what is kept is
    # the largest piece, its edges and weights those of the draw
    n, kappa = 64, 0.08
    g = graph.draw(torch.Generator().manual_seed(3), n, kappa, kappa)
    assert g.drawn == n and 1 < g.n < n
    assert _connected(g)
    assert int(g.rows.max()) == g.n - 1
    d2 = ((g.coords[g.rows] - g.coords[g.cols]) ** 2).sum(-1)
    assert bool((d2 <= kappa * kappa).all())
    torch.testing.assert_close(g.w, torch.exp(-d2 / (2 * kappa * kappa)),
                               rtol=0, atol=0)
    # no vertex left out has an edge into the piece kept
    coords = torch.rand((n, 2), generator=torch.Generator().manual_seed(3),
                        dtype=torch.float64)
    coords = coords[torch.argsort(coords[:, 1], stable=True)]
    kept = (coords[:, None, :] == g.coords[None]).all(-1).any(1)
    d2 = ((coords[~kept][:, None] - coords[kept][None]) ** 2).sum(-1)
    assert bool((d2 > kappa * kappa).all())
