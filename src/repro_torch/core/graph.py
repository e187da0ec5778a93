"""Weighted graphs, Laplacians and spectral bounds (PyTorch port).

The communication-graph model of Section I-A / II-C of the paper:
undirected weighted graphs G = {V, E, W}, the combinatorial Laplacian
L = D - W, the normalized Laplacian, the Anderson-Morley upper bound on
lambda_max used by Algorithm 1, and the random sensor network of
Section IV-D.

Weight matrices and Laplacians are dense float32 torch tensors on the
host.  Block-ELL packing (`to_block_ell`) stays host numpy, vectorised so
that n = 16384 packs in seconds; its output is bitwise equal to the JAX
package's loop.  The sensor-network generator builds W in row chunks, so
a large n never holds n^2 float64 temporaries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor


def _as_tensor(W: Union[Tensor, np.ndarray]) -> Tensor:
    return W if isinstance(W, Tensor) else torch.from_numpy(np.array(W))


# ---------------------------------------------------------------------------
# Graph container
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected weighted graph held as a dense weight matrix.

    Attributes:
      W: (N, N) symmetric non-negative weight matrix, zero diagonal.
      coords: optional (N, d) vertex coordinates (sensor positions).
    """

    W: Tensor
    coords: Optional[Tensor] = None

    @property
    def n_vertices(self) -> int:
        return self.W.shape[0]

    @property
    def n_edges(self) -> int:
        """|E| — number of undirected edges with non-zero weight."""
        return int(torch.count_nonzero(torch.triu(self.W, diagonal=1)))

    def degrees(self) -> Tensor:
        return self.W.sum(dim=1)

    def laplacian(self, kind: str = "combinatorial") -> Tensor:
        return laplacian(self.W, kind=kind)

    def lambda_max_bound(self, kind: str = "combinatorial") -> float:
        return lambda_max_bound(self.W, kind=kind)

    def is_connected(self) -> bool:
        return is_connected(self.W.numpy(force=True))


def laplacian(W: Union[Tensor, np.ndarray],
              kind: str = "combinatorial") -> Tensor:
    """Graph Laplacian of a weight matrix (Section II-C).

    kind:
      'combinatorial' : L = D - W
      'normalized'    : L_norm = D^{-1/2} L D^{-1/2}  (conventional 0/0 -> 0)
    """
    W = _as_tensor(W)
    d = W.sum(dim=1)
    L = -W
    L.diagonal().add_(d)
    if kind == "combinatorial":
        return L
    if kind == "normalized":
        safe = torch.where(d > 0, d, torch.ones_like(d))
        inv_sqrt = torch.where(d > 0, 1.0 / torch.sqrt(safe),
                               torch.zeros_like(d))
        return inv_sqrt[:, None] * L * inv_sqrt[None, :]
    raise ValueError(f"unknown Laplacian kind: {kind!r}")


def lambda_max_bound(W: Union[Tensor, np.ndarray],
                     kind: str = "combinatorial",
                     chunk: int = 2048) -> float:
    """Upper bound on lambda_max(L), computable from local degrees only.

    For the combinatorial Laplacian this is the Anderson-Morley bound
    lambda_max <= max{ d(m) + d(n) : m ~ n } (Section IV-B).  For the
    normalized Laplacian the spectrum is contained in [0, 2].  Rows are
    visited in chunks so that a large W needs no (N, N) temporary.
    """
    if kind == "normalized":
        return 2.0
    W = _as_tensor(W)
    d = W.sum(dim=1)
    bound = torch.zeros((), dtype=W.dtype)
    for r0 in range(0, W.shape[0], chunk):
        rows = W[r0:r0 + chunk]
        pair = d[r0:r0 + chunk, None] + d[None, :]
        pair = torch.where(rows > 0, pair, torch.zeros_like(pair))
        bound = torch.maximum(bound, pair.max())
    # Fall back to the max degree for edgeless graphs.
    bound = torch.maximum(bound, d.max())
    return float(bound)


def is_connected(W: np.ndarray) -> bool:
    """BFS connectivity check (the paper discards disconnected random graph
    realizations — footnote 5)."""
    W = np.asarray(W)
    n = W.shape[0]
    adj = W > 0
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        nbrs = np.nonzero(adj[u] & ~seen)[0]
        seen[nbrs] = True
        stack.extend(nbrs.tolist())
    return bool(seen.all())


# ---------------------------------------------------------------------------
# Random sensor network of Section IV-D
# ---------------------------------------------------------------------------
def sensor_graph(
    rng: np.random.RandomState,
    n: int = 500,
    theta: float = 0.074,
    kappa: float = 0.075,
    chunk: int = 512,
) -> Graph:
    """Random sensor network of Section IV-D.

    n sensors placed uniformly in [0,1]^2 (drawn from `rng`); thresholded
    Gaussian kernel weights w(e) = exp(-d(i,j)^2 / (2 theta^2)) if
    d(i,j) <= kappa else 0.  W is filled `chunk` rows at a time in float64
    and stored as float32.
    """
    coords = rng.uniform(size=(n, 2))
    W = np.zeros((n, n), dtype=np.float32)
    for r0 in range(0, n, chunk):
        diff = coords[r0:r0 + chunk, None, :] - coords[None, :, :]
        dist2 = np.sum(diff * diff, axis=-1)
        w = np.exp(-dist2 / (2.0 * theta * theta))
        w[dist2 > kappa * kappa] = 0.0
        W[r0:r0 + chunk] = w
    np.fill_diagonal(W, 0.0)
    return Graph(W=torch.from_numpy(W),
                 coords=torch.from_numpy(coords.astype(np.float32)))


def connected_sensor_graph(
    rng: np.random.RandomState, n: int = 500, theta: float = 0.074,
    kappa: float = 0.075, max_tries: int = 50,
) -> Graph:
    """Draw sensor graphs from `rng` until a connected one appears (paper
    footnote 5)."""
    for _ in range(max_tries):
        g = sensor_graph(rng, n=n, theta=theta, kappa=kappa)
        if g.is_connected():
            return g
    raise RuntimeError("could not draw a connected sensor graph")


def ring_graph(n: int, weight: float = 1.0) -> Graph:
    """Ring graph — the device-communication graph used by Chebyshev gossip."""
    W = np.zeros((n, n), dtype=np.float32)
    i = np.arange(n)
    W[i, (i + 1) % n] = weight
    W[(i + 1) % n, i] = weight
    return Graph(W=torch.from_numpy(W))


def path_graph(n: int, weight: float = 1.0) -> Graph:
    W = np.zeros((n, n), dtype=np.float32)
    i = np.arange(n - 1)
    W[i, i + 1] = weight
    W[i + 1, i] = weight
    return Graph(W=torch.from_numpy(W))


# ---------------------------------------------------------------------------
# Block-ELL static sparse format
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockELL:
    """Static block-sparse matrix: a fixed number of column-block slots per
    row block.

      blocks:  (n_row_blocks, max_slots, bs_r, bs_c) block values
      indices: (n_row_blocks, max_slots) int32 column-block index per slot;
               padded slots hold zero blocks at column block 0
      mask:    (n_row_blocks, max_slots) bool slot validity
      n:       logical (unpadded) dimension
    """

    blocks: Tensor
    indices: Tensor
    mask: Tensor
    n: int

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (self.blocks.shape[2], self.blocks.shape[3])

    @property
    def n_row_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def padded_n(self) -> int:
        return self.n_row_blocks * self.blocks.shape[2]

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def __repr__(self) -> str:
        return (f"BlockELL(n={self.n}, blocks={tuple(self.blocks.shape)}, "
                f"device={self.device})")

    def to(self, device) -> "BlockELL":
        return BlockELL(blocks=self.blocks.to(device),
                        indices=self.indices.to(device),
                        mask=self.mask.to(device), n=self.n)


def to_block_ell(
    M: Union[Tensor, np.ndarray], block_shape: Tuple[int, int] = (8, 128)
) -> BlockELL:
    """Convert a dense (sparse-in-content) square matrix to Block-ELL.

    Blocks that are entirely zero are dropped; every row block gets the
    same (max over row blocks) number of slots, in increasing column-block
    order, padded with masked zero blocks at column block 0.  The matrix is
    padded to a multiple of lcm(bs_r, bs_c) so that the SpMV output can
    feed straight back in (Chebyshev recurrence).
    """
    M = M.numpy(force=True) if isinstance(M, Tensor) else np.asarray(M)
    n = M.shape[0]
    bs_r, bs_c = block_shape
    unit = int(np.lcm(bs_r, bs_c))
    n_pad = -(-n // unit) * unit
    nrb = n_pad // bs_r
    ncb = n_pad // bs_c
    Mp = M if n_pad == n else np.pad(M, ((0, n_pad - n), (0, n_pad - n)))
    M4 = Mp.reshape(nrb, bs_r, ncb, bs_c)
    nz = np.zeros((nrb, ncb), dtype=bool)
    for r0 in range(0, nrb, 256):  # row-block chunks bound the bool temporary
        nz[r0:r0 + 256] = (M4[r0:r0 + 256] != 0).any(axis=(1, 3))
    counts = nz.sum(axis=1)
    max_slots = max(1, int(counts.max()) if nrb else 0)
    rows, cols = np.nonzero(nz)          # row-major: increasing cb per row
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(rows.size) - starts[rows]
    blocks = np.zeros((nrb, max_slots, bs_r, bs_c), dtype=M.dtype)
    indices = np.zeros((nrb, max_slots), dtype=np.int32)
    mask = np.zeros((nrb, max_slots), dtype=bool)
    blocks[rows, slot] = M4[rows, :, cols, :]
    indices[rows, slot] = cols
    mask[rows, slot] = True
    return BlockELL(blocks=torch.from_numpy(blocks),
                    indices=torch.from_numpy(indices),
                    mask=torch.from_numpy(mask), n=n)


def spatial_sort(graph: Graph) -> Tuple[Graph, np.ndarray]:
    """Reorder vertices by their y coordinate (strip order).

    With a thresholded-kernel sensor graph (connection radius kappa), two
    adjacent vertices differ in y-rank by at most the population of a
    kappa-height strip, so W becomes banded and its Block-ELL form needs
    few slots per row block.
    """
    if graph.coords is None:
        raise ValueError("spatial_sort needs coordinates")
    coords = graph.coords.numpy(force=True)
    order = np.argsort(coords[:, 1], kind="stable")
    idx = torch.from_numpy(order)
    W = graph.W.index_select(0, idx).index_select(1, idx)
    return Graph(W=W, coords=torch.from_numpy(coords[order])), order
