"""The Section IV-D random sensor network, drawn on a device from a seed.

A frozen copy, kept with the benchmark, of the generator that the port's
chip smoke uses at n = 2**18 (``_large_sensor_layout``), at the radius
the configuration gives and cut to one component: n sensors
uniform in the unit square, drawn in float64 from a `torch.Generator`;
the vertices in strip order (sorted by y, stable); an edge between two
sensors at most kappa apart, of weight exp(-d^2 / (2 theta^2)).  The
edges are found strip by strip: the neighbours of a chunk of
strip-sorted sensors lie within kappa of it in y, so each chunk is held
against that window alone, and no n x n array is ever formed.  The graph
is the draw's largest connected component: the paper (footnote 5) draws
again until the graph is connected, which at its mean degree of ~8.8
and thousands of sensors almost never happens, since a few sensors near
the square's edge are left alone in nearly every draw.

It imports nothing of the program: the benchmark hands the graph it
draws here both to the program and to the reference.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

#: Rows of strip-sorted sensors held against their window at once.
CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class SensorGraph:
    """An undirected weighted graph as both directions of every edge.

    rows, cols: int64 (2|E|,), sorted by (row, col); w: float64 weights;
    coords: (n, 2) float64 positions in strip order; drawn: the sensors
    drawn, of which these n are the largest connected component."""

    n: int
    rows: Tensor
    cols: Tensor
    w: Tensor
    coords: Tensor
    drawn: int

    @property
    def n_edges(self) -> int:
        return self.rows.numel() // 2

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def dense(self, dtype=torch.float32) -> Tensor:
        """The (n, n) weight matrix W in `dtype` on the graph's device."""
        W = torch.zeros((self.n, self.n), dtype=dtype, device=self.device)
        W[self.rows, self.cols] = self.w.to(dtype)
        return W


def _edges(coords: Tensor, kappa: float, theta: float):
    n = coords.shape[0]
    y = coords[:, 1].contiguous()
    rows, cols, ws = [], [], []
    for r0 in range(0, n, CHUNK):
        r1 = min(r0 + CHUNK, n)
        lo = int(torch.searchsorted(y, y[r0] - kappa))
        hi = int(torch.searchsorted(y, y[r1 - 1] + kappa, right=True))
        d2 = ((coords[r0:r1, None, :] - coords[None, lo:hi, :]) ** 2).sum(-1)
        near = d2 <= kappa * kappa
        own = torch.arange(r0, r1, device=coords.device)
        near[own - r0, own - lo] = False
        i, j = near.nonzero(as_tuple=True)
        rows.append(i + r0)
        cols.append(j + lo)
        ws.append(torch.exp(-d2[i, j] / (2.0 * theta * theta)))
    return torch.cat(rows), torch.cat(cols), torch.cat(ws)


def components(n: int, rows: Tensor, cols: Tensor) -> Tensor:
    """Each vertex's component, as the least vertex in it, by label
    propagation on the device: every vertex takes the least label among
    itself and its neighbours, then jumps to its label's label, until
    nothing changes."""
    labels = torch.arange(n, device=rows.device)
    while True:
        new = labels.clone().scatter_reduce_(0, rows, labels[cols], "amin")
        new = new[new]
        if bool(torch.equal(new, labels)):
            return labels
        labels = new


def draw(gen: torch.Generator, n: int, kappa: float,
         theta: float) -> SensorGraph:
    """n sensors drawn on `gen`'s device, cut to their largest connected
    component (the first of equal size), its vertices renumbered in strip
    order."""
    dev = gen.device
    coords = torch.rand((n, 2), generator=gen, dtype=torch.float64,
                        device=dev)
    coords = coords[torch.argsort(coords[:, 1], stable=True)]
    rows, cols, w = _edges(coords, kappa, theta)
    labels = components(n, rows, cols)
    keep = labels == int(torch.argmax(torch.bincount(labels, minlength=n)))
    new = torch.cumsum(keep, 0) - 1
    e = keep[rows]
    return SensorGraph(n=int(keep.sum()), rows=new[rows[e]],
                       cols=new[cols[e]], w=w[e], coords=coords[keep],
                       drawn=n)
