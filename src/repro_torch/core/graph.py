"""Weighted graphs, Laplacians and spectral bounds (PyTorch port).

The communication-graph model of Section I-A / II-C of the paper:
undirected weighted graphs G = {V, E, W}, the combinatorial Laplacian
L = D - W, the normalized Laplacian, the Anderson-Morley upper bound on
lambda_max used by Algorithm 1, and the random sensor network of
Section IV-D.

Weight matrices and Laplacians are dense float32 torch tensors on the
host.  Block-ELL packing (`to_block_ell`) stays host numpy, vectorised so
that n = 16384 packs in seconds; its output is bitwise equal to the JAX
package's loop.  The sliced-ELL row layout (`to_sliced_ell`) that the
card's SpMV and sweeps read is packed the same way on the host, from a
dense P or a Block-ELL; `BlockELL.sliced_ell` builds the same layout in
torch ops on the blocks' own device.  The sensor-network generator
builds W in row chunks, so a large n never holds n^2 float64
temporaries.
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


def k_scaling_matrix(W: Union[Tensor, np.ndarray], gamma: float) -> Tensor:
    """Ando & Zhang's K-scaling kernel matrix (Section III-D):

       S = (gamma I + D)^{-1/2} (gamma I + L) (gamma I + D)^{-1/2}

    Has the sparsity pattern of L; reduces to L_norm at gamma = 0.
    """
    W = _as_tensor(W)
    d = W.sum(dim=1)
    S = -W
    S.diagonal().add_(d + gamma)
    scale = 1.0 / torch.sqrt(gamma + d)
    return scale[:, None] * S * scale[None, :]


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


def torus_graph(rows: int, cols: int, weight: float = 1.0) -> Graph:
    """2-D torus graph (device mesh topology analog: ICI torus)."""
    n = rows * cols
    W = np.zeros((n, n), dtype=np.float32)
    r, c = np.divmod(np.arange(n), cols)
    for v in ((r + 1) % rows * cols + c, r * cols + (c + 1) % cols):
        W[np.arange(n), v] = weight
        W[v, np.arange(n)] = weight
    return Graph(W=torch.from_numpy(W))


def path_graph(n: int, weight: float = 1.0) -> Graph:
    W = np.zeros((n, n), dtype=np.float32)
    i = np.arange(n - 1)
    W[i, i + 1] = weight
    W[i + 1, i] = weight
    return Graph(W=torch.from_numpy(W))


def two_cluster_graph(n_per: int = 20, p_in: float = 0.9,
                      p_out: float = 0.05, *,
                      generator: np.random.Generator
                      ) -> Tuple[Graph, Tensor]:
    """Stochastic two-block graph and its ground-truth labels, for SSL.

    Vertices 0..n_per-1 carry label 0, the next n_per label 1; each pair
    is joined (weight 1) with probability `p_in` inside a block and
    `p_out` between the blocks, drawn from `generator` (the JAX package
    draws from a jax PRNG key, which no other generator reproduces).
    """
    n = 2 * n_per
    labels = np.repeat(np.arange(2, dtype=np.int64), n_per)
    p = np.where(labels[:, None] == labels[None, :], p_in, p_out)
    upper = np.triu(generator.uniform(size=(n, n)) < p, k=1)
    W = (upper | upper.T).astype(np.float32)
    return Graph(W=torch.from_numpy(W)), torch.from_numpy(labels)


# ---------------------------------------------------------------------------
# Block-ELL static sparse format
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BlockELL:
    """Static block-sparse matrix: a fixed number of column-block slots per
    row block.

      blocks:  (n_row_blocks, max_slots, bs_r, bs_c) block values
      indices: (n_row_blocks, max_slots) int32 column-block index per slot;
               padded slots hold zero blocks at column block 0
      mask:    (n_row_blocks, max_slots) bool slot validity
      n:       logical (unpadded) dimension
      sliced:  a cache: the same matrix in the sliced-ELL layout at
               `padded_n`, which the SpMV and the sweeps read; None until
               :meth:`sliced_ell` first packs it
    """

    blocks: Tensor
    indices: Tensor
    mask: Tensor
    n: int
    sliced: Optional["SlicedELL"] = dataclasses.field(
        default=None, repr=False, compare=False)

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
                        mask=self.mask.to(device), n=self.n,
                        sliced=(None if self.sliced is None
                                else self.sliced.to(device)))

    def todense(self) -> Tensor:
        """The (n, n) dense matrix, on the blocks' device (the JAX
        package's `BlockELL.todense`)."""
        br, bc = self.block_shape
        pn = self.padded_n
        rb, s = torch.nonzero(self.mask, as_tuple=True)
        out = torch.zeros((self.n_row_blocks, pn // bc, br, bc),
                          dtype=self.blocks.dtype, device=self.device)
        out.index_put_((rb, self.indices[rb, s].long()), self.blocks[rb, s],
                       accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(pn, pn)[:self.n, :self.n]

    def sliced_ell(self) -> "SlicedELL":
        """The sliced-ELL form of this matrix, packed from the blocks on
        their own device (torch ops, no host copy) the first time it is
        asked for and kept in `sliced`.  Bitwise equal to
        ``to_sliced_ell(self)``."""
        if self.sliced is None:
            self.sliced = _sliced_from_blocks(self)
        return self.sliced


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


def block_ell_matvec_ref(A: BlockELL, x: Tensor) -> Tensor:
    """y = A @ x by the blocks, in plain PyTorch (the JAX package's
    reference Block-ELL matvec); x: (..., n) -> (..., n)."""
    br, bc = A.block_shape
    pn = A.padded_n
    xp = torch.nn.functional.pad(x, (0, pn - x.shape[-1]))
    xb = xp.reshape(x.shape[:-1] + (-1, bc))          # (..., ncb, bc)
    gathered = xb[..., A.indices.long(), :]             # (..., nrb, slots, bc)
    prod = torch.einsum("rsij,...rsj->...rsi", A.blocks.to(x.dtype), gathered)
    prod = prod.masked_fill(~A.mask[:, :, None], 0.0)
    y = prod.sum(dim=-2).reshape(x.shape[:-1] + (pn,))
    return y[..., :A.n]


# ---------------------------------------------------------------------------
# Sliced-ELL row layout (the card's SpMV)
# ---------------------------------------------------------------------------
#: Rows per slice: one warp's 32 lanes, one row each.
SLICE_ROWS = 32


@dataclasses.dataclass(frozen=True)
class SlicedELL:
    """Sparse matrix in slices of 32 rows, each as wide as its widest row.

    Slice s holds its rows' entries slot-major from ``offsets[s]``: slot j
    of lane r (row ``32 s + r``) sits at ``offsets[s] + 32 j + r``, so one
    slot of a slice is 32 consecutive values and 32 consecutive columns.
    A row's entries keep increasing column order; the slots past a row's
    last entry hold value 0 at the row's own index (in bounds; the lanes
    past `padded_n` in a last, partly filled slice point at column 0).

      values:  (stored,) float32, the matrix's exact values
      values_bf16: (stored,) bfloat16, the values rounded once, which the
               sweeps' bf16 mode reads
      columns: (stored,) int32 column per entry
      offsets: (n_slices,) int32 first entry of each slice (multiples of 32)
      widths:  (n_slices,) int32 slots of each slice
      n:       logical dimension; rows and columns run to `padded_n`, the
               rows past n empty; n_slices = ceil(padded_n / 32)
      nnz:     non-zeros stored (the rest of `stored` is padding)
      n_cols:  columns of a rectangular layout (the length of the signals
               it reads), or None for a square one (`padded_n`); padding
               past a row's last entry points at column 0 where the row's
               own index is not a column
    """

    values: Tensor
    values_bf16: Tensor
    columns: Tensor
    offsets: Tensor
    widths: Tensor
    n: int
    padded_n: int
    nnz: int
    n_cols: Optional[int] = None

    @property
    def x_len(self) -> int:
        """Length of the signals the SpMV reads: `n_cols`, or `padded_n`
        for a square layout."""
        return self.padded_n if self.n_cols is None else self.n_cols

    @property
    def n_slices(self) -> int:
        return self.widths.shape[0]

    @property
    def stored(self) -> int:
        """Entries the SpMV reads and multiplies, padding included."""
        return self.values.shape[0]

    @property
    def stored_per_nnz(self) -> float:
        return self.stored / max(self.nnz, 1)

    @property
    def device(self) -> torch.device:
        return self.values.device

    def __repr__(self) -> str:
        return (f"SlicedELL(n={self.n}, padded_n={self.padded_n}, "
                f"nnz={self.nnz}, stored={self.stored}, "
                f"device={self.device})")

    def to(self, device) -> "SlicedELL":
        return dataclasses.replace(
            self, values=self.values.to(device),
            values_bf16=self.values_bf16.to(device),
            columns=self.columns.to(device), offsets=self.offsets.to(device),
            widths=self.widths.to(device))

    def entry_rows(self) -> Tensor:
        """(stored,) int64 row of every entry."""
        slices = torch.repeat_interleave(
            torch.arange(self.n_slices, device=self.device),
            self.widths.long() * SLICE_ROWS)
        lanes = torch.arange(self.stored, device=self.device) % SLICE_ROWS
        return slices * SLICE_ROWS + lanes


def _coo_rows(M: np.ndarray, chunk: int = 2048):
    """(rows, cols, vals) of the non-zeros of a dense matrix, row-major, a
    chunk of rows at a time."""
    parts = []
    for r0 in range(0, M.shape[0], chunk):
        r, c = np.nonzero(M[r0:r0 + chunk])
        parts.append((r + r0, c, M[r0 + r, c]))
    if not parts:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, M.dtype),)
    return tuple(np.concatenate(p) for p in zip(*parts))


def _coo_block_ell(A: BlockELL):
    """(rows, cols, vals) of the non-zeros of a Block-ELL matrix, sorted
    by row, then column."""
    blocks = A.blocks.numpy(force=True)
    indices = A.indices.numpy(force=True)
    br, bc = A.block_shape
    flat = np.flatnonzero(blocks != 0)
    rb, s, i, j = np.unravel_index(flat, blocks.shape)
    rows = rb.astype(np.int64) * br + i
    cols = indices[rb, s].astype(np.int64) * bc + j
    # C order visits a row's slots in increasing column-block order, so a
    # stable sort by row leaves each row's columns increasing
    order = np.argsort(rows, kind="stable")
    return rows[order], cols[order], blocks.ravel()[flat][order]


def to_sliced_ell(
    M: Union[Tensor, np.ndarray, BlockELL],
    padded_n: Optional[int] = None,
) -> SlicedELL:
    """Pack a dense (sparse-in-content) square matrix, or a `BlockELL`,
    into the sliced-ELL layout (:class:`SlicedELL`), on the host.

    Rows are cut into slices of :data:`SLICE_ROWS` (one warp); each slice
    is as wide as its widest row, so a row layout pads far less than
    Block-ELL on a graph whose rows spread over many column blocks.
    `padded_n` (default: a BlockELL's own padded size, else n) is the
    length of the signals the SpMV takes and returns, at least n; the rows
    past n are empty, so a padded output feeds straight back in.
    """
    if isinstance(M, BlockELL):
        n = M.n
        padded_n = M.padded_n if padded_n is None else padded_n
        rows, cols, vals = _coo_block_ell(M)
    else:
        M = M.numpy(force=True) if isinstance(M, Tensor) else np.asarray(M)
        n = M.shape[0]
        rows, cols, vals = _coo_rows(M)
    if padded_n is None:
        padded_n = n
    if padded_n < n:
        raise ValueError(f"padded_n {padded_n} is below n = {n}")
    vals = vals.astype(np.float32)
    n_slices = -(-padded_n // SLICE_ROWS)
    counts = np.bincount(rows, minlength=n_slices * SLICE_ROWS)
    widths = counts.reshape(n_slices, SLICE_ROWS).max(axis=1)
    sizes = widths * SLICE_ROWS
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    stored = int(sizes.sum())
    if stored >= 2**31:
        raise ValueError(f"{stored} stored entries do not fit int32 offsets")
    # padding: value 0 at the row's own index (column 0 past padded_n)
    slice_of = np.repeat(np.arange(n_slices), sizes)
    pos = np.arange(stored)
    columns = slice_of * SLICE_ROWS + pos % SLICE_ROWS
    columns = np.where(columns < padded_n, columns, 0).astype(np.int32)
    values = np.zeros(stored, dtype=np.float32)
    row_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(rows.size) - row_start[rows]
    dest = offsets[rows // SLICE_ROWS] + slot * SLICE_ROWS + rows % SLICE_ROWS
    values[dest] = vals
    columns[dest] = cols
    values = torch.from_numpy(values)
    return SlicedELL(values=values, values_bf16=values.to(torch.bfloat16),
                     columns=torch.from_numpy(columns),
                     offsets=torch.from_numpy(offsets.astype(np.int32)),
                     widths=torch.from_numpy(widths.astype(np.int32)),
                     n=int(n), padded_n=int(padded_n), nnz=int(rows.size))


def _sliced_from_blocks(A: BlockELL) -> SlicedELL:
    """:func:`to_sliced_ell` of a Block-ELL matrix in torch ops on the
    blocks' own device: the same layout, bit for bit, without copying the
    blocks to the host."""
    br, bc = A.block_shape
    # non-zeros in (row block, row, slot, column) order: by row, then by
    # column, since a row block's slots run in increasing column block
    nz = (A.blocks != 0).permute(0, 2, 1, 3).nonzero()
    rb, i, s, j = nz.unbind(1)
    return sliced_ell_from_coo(rb * br + i, A.indices.long()[rb, s] * bc + j,
                               A.blocks[rb, s, i, j], A.n, A.padded_n)


def sliced_ell_from_coo(rows: Tensor, cols: Tensor, vals: Tensor, n: int,
                        padded_n: int,
                        n_cols: Optional[int] = None) -> SlicedELL:
    """Pack COO entries into the sliced-ELL layout in torch ops on their
    own device.  `rows` must be sorted, and each row's `cols` increasing;
    the layout has `padded_n` rows and `n_cols` columns (None: square)."""
    dev = rows.device
    n_slices = -(-padded_n // SLICE_ROWS)
    counts = torch.bincount(rows, minlength=n_slices * SLICE_ROWS)
    widths = counts.reshape(n_slices, SLICE_ROWS).amax(dim=1)
    sizes = widths * SLICE_ROWS
    offsets = torch.cumsum(sizes, 0) - sizes
    stored = int(sizes.sum())
    if stored >= 2**31:
        raise ValueError(f"{stored} stored entries do not fit int32 offsets")
    # padding: value 0 at the row's own index (column 0 where that is not
    # a column)
    pos = torch.arange(stored, device=dev)
    columns = (torch.repeat_interleave(
        torch.arange(n_slices, device=dev), sizes) * SLICE_ROWS
        + pos % SLICE_ROWS)
    columns = torch.where(
        columns < (padded_n if n_cols is None else n_cols), columns, 0)
    values = torch.zeros(stored, dtype=torch.float32, device=dev)
    row_start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(rows.numel(), device=dev) - row_start[rows]
    dest = (offsets[rows // SLICE_ROWS] + slot * SLICE_ROWS
            + rows % SLICE_ROWS)
    values[dest] = vals.to(torch.float32)
    columns[dest] = cols
    return SlicedELL(values=values, values_bf16=values.to(torch.bfloat16),
                     columns=columns.to(torch.int32),
                     offsets=offsets.to(torch.int32),
                     widths=widths.to(torch.int32), n=int(n),
                     padded_n=int(padded_n), nnz=int(rows.numel()),
                     n_cols=n_cols)


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
