"""Sparse matvec — the Algorithm 1 hot loop — for Hopper.

The paper's per-order cost is one sparse matvec with P (Section IV-A).
The JAX package stores P in Block-ELL for the TPU's (8, 128) tiles; on a
strip-sorted sensor graph that layout stores ~40 entries per non-zero.
The card's SpMV reads the sliced-ELL row layout instead
(`core.graph.SlicedELL`: slices of 32 rows, each as wide as its widest
row, ~1.4 stored entries per non-zero).  `sliced_ell_spmv` is one wrapper
for any batch: Y = A X^T on (..., padded_n) signals, by the hand-written
CUDA kernel ``csrc/sliced_ell_spmv.cu``, which replaces both
`block_ell_spmv` and `block_ell_spmv_batched` of the JAX package.

The Block-ELL plain version (`block_ell_spmv_plain`) stays as the bridge
the parity tests hold against the JAX kernels.  The whole-iteration
sweeps (`kernels/cheb_sweep.py`) read the same sliced layout.

`sliced_ell_spmv_accumulate` is the couplings' kernel, y += C r, the
second entry of the same source: a general partition's shard adds the
cut edges to the tiles it received (`dist/sharded.py`), which the JAX
package scattered with ``y.at[rows].add`` around its Block-ELL SpMV.  It
reads a :class:`CouplingLayout`, packed once per plan on the card
(:func:`compact_coupling`): only the rows that hold an entry, sliced over
those, and the tiles in place through a table of pointers
(:func:`tile_groups` plans the launches).  It counts its own launches.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(`sliced_ell_spmv_plain`); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from ..core.graph import SLICE_ROWS, SlicedELL, sliced_ell_from_coo
from . import _build

Tensor = torch.Tensor


def block_ell_spmv_plain(blocks: Tensor, indices: Tensor, x: Tensor) -> Tensor:
    """y = A @ x in plain PyTorch; blocks (nrb, slots, br, bc), indices
    (nrb, slots), x (..., ncb * bc) with any leading batch dims.  Padded
    slots must hold zero blocks."""
    nrb, slots, br, bc = blocks.shape
    lead = x.shape[:-1]
    xb = x.reshape(lead + (-1, bc))
    gathered = xb.index_select(-2, indices.reshape(-1).long())
    gathered = gathered.reshape(lead + (nrb, slots, bc))
    y = torch.einsum("rsij,...rsj->...ri", blocks, gathered)
    return y.reshape(lead + (nrb * br,))


def sliced_ell_spmv_plain(S: SlicedELL, x: Tensor,
                          values: Optional[Tensor] = None, *,
                          out: Optional[Tensor] = None) -> Tensor:
    """y = A @ x in plain PyTorch for sliced-ELL A and x (..., A.x_len)
    with any leading batch dims: every stored entry's product gathered,
    then summed into its row (padding entries add 0).  A may be
    rectangular (`SlicedELL.n_cols` columns); the result has A's
    `padded_n` rows.  `values` replaces the layout's f32 values (the
    sweeps' bf16 mode passes its bf16 copy); products and sums are in x's
    dtype.  With `out` (..., padded_n) the product is added into it in
    place and `out` returned (the accumulating mode)."""
    _check_width(S, x)
    values = S.values if values is None else values
    prod = values.to(x.dtype) * x[..., S.columns.long()]
    y = torch.zeros(x.shape[:-1] + (S.n_slices * SLICE_ROWS,),
                    dtype=x.dtype, device=x.device)
    y.index_add_(y.ndim - 1, S.entry_rows(), prod)
    y = y[..., :S.padded_n]
    return y if out is None else out.add_(y)


def _check_width(S: SlicedELL, x: Tensor) -> None:
    if x.shape[-1] != S.x_len:
        width = (f"padded n {S.padded_n}" if S.n_cols is None
                 else f"{S.n_cols} columns")
        raise ValueError(f"signal length {x.shape[-1]} != the layout's "
                         f"{width}")


def _check_launch(S: SlicedELL, x: Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {x.device}")
    _check_width(S, x)
    if S.device != x.device:
        raise ValueError(f"layout on {S.device}, signals on {x.device}")
    if x.dtype != torch.float32 or S.values.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 values and signals")
    if S.columns.dtype != torch.int32 or S.offsets.dtype != torch.int32 \
            or S.widths.dtype != torch.int32:
        raise TypeError("sliced-ELL columns, offsets and widths are int32")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes contiguous signals")


def _lib() -> ctypes.CDLL:
    lib = _build.library("sliced_ell_spmv")
    fn = lib.sliced_ell_spmv_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                       + [ctypes.c_longlong] + [ctypes.c_int]
                       + [ctypes.c_void_p])
    return lib


def _batch(x: Tensor) -> int:
    B = math.prod(x.shape[:-1])
    if B >= 2**31 // 16:
        raise ValueError(f"batch {B} too large for one launch")
    return B


def sliced_ell_spmv(S: SlicedELL, x: Tensor) -> Tensor:
    """Y = A @ X^T for square sliced-ELL A and signals x (..., padded_n).

    Returns (..., padded_n).  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/sliced_ell_spmv.cu`` (counted in
    ``sliced_ell_spmv.launches``).
    """
    if x.device.type == "cpu":
        return sliced_ell_spmv_plain(S, x)
    _check_launch(S, x, "sliced_ell_spmv")
    if S.n_cols is not None:
        raise ValueError("sliced_ell_spmv takes a square layout; a "
                         "rectangular one is applied by "
                         "sliced_ell_spmv_accumulate")
    y = torch.empty(x.shape[:-1] + (S.padded_n,), dtype=x.dtype,
                    device=x.device)
    B = _batch(x)
    if B == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sliced_ell_spmv_f32(
            S.values.data_ptr(), S.columns.data_ptr(), S.offsets.data_ptr(),
            S.widths.data_ptr(), x.data_ptr(), y.data_ptr(), S.n_slices,
            S.padded_n, B, stream)
    _build.check(lib, err, "sliced_ell_spmv")
    sliced_ell_spmv.launches += 1
    return y


sliced_ell_spmv.launches = 0


#: Tiles one coupling launch reads (sliced_ell_spmv.cu: kMaxTiles); a
#: stored column is (column in its tile << TILE_BITS) | tile.
TILE_CAPACITY = 32
TILE_BITS = 5
#: Slices (warps) per block of the coupling launch (sliced_ell_spmv.cu:
#: kWarps), and the most signal tiles a grid takes before it strides.
SPMV_WARPS = 4
MAX_GRID_Y = 65535


def tile_groups(tile_widths: Sequence[int],
                capacity: int = TILE_CAPACITY) -> Tuple[Tuple[int, int], ...]:
    """The coupling launches of a round: ``(first, count)`` runs of
    consecutive tiles (ring offsets) in offset order, one run of all of
    them when they fit the kernel's table (`capacity`), else runs of
    `capacity` and a last, shorter one.  y takes the runs' row sums in
    turn (``csrc/sliced_ell_spmv.cu``, the note on the couplings)."""
    n = len(tile_widths)
    return tuple((k, min(capacity, n - k)) for k in range(0, n, capacity))


def coupling_launch(n_slices: int, batch: int) -> Tuple[int, Tuple[int, int]]:
    """(tb, (gx, gy)) of a coupling launch: tb signals per thread (every
    signal of a batch of up to 16 in one tile: 1, 4, 8 or 16; tiles of 8
    beyond), gx groups of SPMV_WARPS compacted slices, gy signal tiles
    (strided beyond MAX_GRID_Y)."""
    tb = next((t for t in (1, 4, 8, 16) if batch <= t), 8)
    return tb, (max(1, -(-n_slices // SPMV_WARPS)),
                max(1, min(-(-batch // tb), MAX_GRID_Y)))


@dataclasses.dataclass(frozen=True)
class CouplingGroup:
    """One launch's share of a coupling layout: the tiles ``first`` ..
    ``first + count - 1``, over the rows that hold an entry to them.

      S:       sliced-ELL over the compacted rows (m = S.padded_n) and the
               group's tiles joined (S.n_cols columns); the plain version
               reads it
      rows:    (m,) int32, sorted: compacted row i is row rows[i] of y
      columns: (stored,) int32, S's columns as (column in its tile <<
               TILE_BITS) | (tile - first), which the kernel reads
      slices:  (n_slices, 2) int32, each slice's (offset, width)
    """

    first: int
    count: int
    S: SlicedELL
    rows: Tensor
    columns: Tensor
    slices: Tensor


@dataclasses.dataclass
class CouplingLayout:
    """A shard's couplings y += C r, compacted for the coupling kernel
    (:func:`compact_coupling`): C has `n_rows` rows (y's length) and
    sum(tile_widths) columns, r the received tiles (one per ring offset,
    in offset order), split into the launches of :func:`tile_groups`."""

    groups: Tuple[CouplingGroup, ...]
    n_rows: int
    tile_widths: Tuple[int, ...]
    nnz: int
    _launch: Optional[object] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def n_cols(self) -> int:
        return sum(self.tile_widths)

    @property
    def n_entry_rows(self) -> int:
        """Rows that hold an entry (summed over the groups)."""
        return sum(g.S.padded_n for g in self.groups)

    @property
    def n_slices(self) -> int:
        return sum(g.S.n_slices for g in self.groups)

    @property
    def stored(self) -> int:
        return sum(g.S.stored for g in self.groups)


def compact_coupling(C: SlicedELL,
                     tile_widths: Optional[Sequence[int]] = None, *,
                     capacity: int = TILE_CAPACITY) -> CouplingLayout:
    """Compact a rectangular sliced-ELL C (`dist.sharded.coupling_layout`)
    for the coupling kernel, in torch ops on C's device: per launch of
    :func:`tile_groups`, the rows that hold an entry to its tiles, sliced
    over those rows alone, each stored column encoded with its tile.
    `tile_widths` splits C's columns into the received tiles (None: one
    tile of all of them).  C's stored zeros are its padding (the coupling
    layout drops the JAX package's zero-valued padding), so they are
    dropped."""
    widths = ((C.x_len,) if tile_widths is None
              else tuple(int(h) for h in tile_widths))
    if sum(widths) != C.x_len or not widths:
        raise ValueError(f"tile widths {widths} do not split C's "
                         f"{C.x_len} columns")
    if max(widths) >= 2**(31 - TILE_BITS) or capacity > 2**TILE_BITS:
        raise ValueError(f"a tile of {max(widths)} columns, or a table of "
                         f"{capacity}, does not fit the kernel's columns")
    if C.values.dtype != torch.float32 or C.columns.dtype != torch.int32:
        raise TypeError("the coupling kernel takes float32 values and int32 "
                        "columns")
    dev = C.device
    real = C.values != 0
    rows, cols, vals = C.entry_rows()[real], C.columns[real].long(), \
        C.values[real]
    order = torch.argsort(rows * max(C.x_len, 1) + cols, stable=True)
    rows, cols, vals = rows[order], cols[order], vals[order]
    base = [0]
    for h in widths:
        base.append(base[-1] + h)
    groups = []
    for first, count in tile_groups(widths, capacity):
        lo, hi = base[first], base[first + count]
        sel = (cols >= lo) & (cols < hi)
        if not bool(sel.any()):
            continue
        ids, compact = torch.unique(rows[sel], sorted=True,
                                    return_inverse=True)
        S = sliced_ell_from_coo(compact, cols[sel] - lo, vals[sel],
                                ids.numel(), ids.numel(), n_cols=hi - lo)
        ends = torch.tensor(base[first + 1:first + count + 1], device=dev) - lo
        stored = S.columns.long()
        tile = torch.searchsorted(ends, stored, right=True)
        starts = torch.tensor(base[first:first + count], device=dev) - lo
        local = stored - starts[tile]
        groups.append(CouplingGroup(
            first=first, count=count, S=S, rows=ids.to(torch.int32),
            columns=((local << TILE_BITS) | tile).to(torch.int32),
            slices=torch.stack([S.offsets, S.widths], 1).contiguous()))
    return CouplingLayout(groups=tuple(groups), n_rows=C.padded_n,
                          tile_widths=widths, nnz=C.nnz)


def _split(L: CouplingLayout, r: Tensor) -> Tuple[Tensor, ...]:
    """The tiles of a joined r (..., n_cols), as views."""
    if r.shape[-1] != L.n_cols:
        raise ValueError(f"r has {r.shape[-1]} columns, the couplings "
                         f"{L.n_cols}")
    out, lo = [], 0
    for h in L.tile_widths:
        out.append(r[..., lo:lo + h])
        lo += h
    return tuple(out)


def coupling_plain(L: CouplingLayout, tiles: Sequence[Tensor],
                   y: Tensor) -> Tensor:
    """y += C r in plain PyTorch, in place, for the tiles of r (one per
    ring offset, (..., h_k)): per launch group, the compacted rows' sums
    (`sliced_ell_spmv_plain` over the group's tiles joined) added into y
    at their rows.  Returns y."""
    for g in L.groups:
        r = torch.cat(list(tiles[g.first:g.first + g.count]), -1)
        y.index_add_(y.ndim - 1, g.rows.long(),
                     sliced_ell_spmv_plain(g.S, r))
    return y


def _row_stride(t: Tensor) -> int:
    """Elements from one signal's row of `t` (..., h) to the next, which
    the kernel's table takes; raises unless the rows are evenly strided
    and each is contiguous."""
    if t.is_contiguous():
        return t.shape[-1]
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"a coupling tile's rows must be contiguous, got "
                         f"strides {t.stride()}")
    stride, span = None, None
    for size, st in zip(reversed(t.shape[:-1]), reversed(t.stride()[:-1])):
        if size == 1:
            continue
        if span is not None and st != span:
            raise ValueError(f"a coupling tile's rows must be evenly "
                             f"strided, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
        stride = st if stride is None else stride
        span = st * size
    return t.shape[-1] if stride is None else stride


class _CouplingArgs(ctypes.Structure):
    """One coupling launch's arguments (sliced_ell_spmv.cu: CouplingArgs,
    field for field), kept per launch group and passed by address."""

    _fields_ = ([(f, ctypes.c_void_p) for f in
                 ("values", "columns", "slices", "rows", "y", "stream")]
                + [("n", ctypes.c_longlong)]
                + [(f, ctypes.c_int) for f in
                   ("n_slices", "m", "B", "tb", "n_tiles")]
                + [("gx", ctypes.c_uint), ("gy", ctypes.c_uint),
                   ("tile_ptrs", ctypes.c_void_p * TILE_CAPACITY),
                   ("tile_strides", ctypes.c_longlong * TILE_CAPACITY)])


def _coupling_launcher(L: CouplingLayout):
    """The layout's round, resolved once: the C entry and, per launch
    group, its arguments with the layout's pointers filled in.
    ``launch(r, joined, y)`` checks the round's tiles (shapes, device,
    dtype, row strides) and y, fills in their pointers, the stream and
    (when B changes) the launch shape, and launches each group."""
    lib = _build.library("sliced_ell_spmv")
    fn = lib.coupling_spmv_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    dev = L.groups[0].S.device
    f32 = torch.float32
    n_rows, widths, n_cols = L.n_rows, L.tile_widths, L.n_cols
    bases = [0]
    for h in widths[:-1]:
        bases.append(bases[-1] + 4 * h)     # byte offsets in a joined r
    groups = []
    for g in L.groups:
        args = _CouplingArgs(
            values=g.S.values.data_ptr(), columns=g.columns.data_ptr(),
            slices=g.slices.data_ptr(), rows=g.rows.data_ptr(), n=n_rows,
            n_slices=g.S.n_slices, m=g.S.padded_n, n_tiles=g.count)
        groups.append([g.first, g.count, args, ctypes.addressof(args),
                       args.tile_ptrs, args.tile_strides, 0])

    def launch(r, joined: bool, y: Tensor) -> Tensor:
        lead = y.shape[:-1]
        if (y.shape[-1] != n_rows or y.dtype != f32 or y.device != dev
                or not y.is_contiguous()):
            raise ValueError(f"y {tuple(y.shape)} {y.dtype} on {y.device} "
                             f"does not take C r: it must be a contiguous "
                             f"float32 (..., {n_rows}) on {dev}")
        if joined:
            if (r.shape[:-1] != lead or r.shape[-1] != n_cols
                    or r.dtype != f32 or r.device != dev):
                raise ValueError(f"r {tuple(r.shape)} {r.dtype} on "
                                 f"{r.device}: expected a float32 "
                                 f"{tuple(lead) + (n_cols,)} on {dev}")
            p0, st = r.data_ptr(), _row_stride(r)
            ptrs = [p0 + b for b in bases]
            strides = [st] * len(widths)
        else:
            if len(r) != len(widths):
                raise ValueError(f"{len(r)} tiles for {len(widths)} "
                                 "offsets")
            ptrs, strides = [], []
            for t, h in zip(r, widths):
                if (t.shape[:-1] != lead or t.shape[-1] != h
                        or t.dtype != f32 or t.device != dev):
                    raise ValueError(
                        f"a coupling tile {tuple(t.shape)} {t.dtype} on "
                        f"{t.device}: expected a float32 "
                        f"{tuple(lead) + (h,)} on {dev}")
                ptrs.append(t.data_ptr())
                strides.append(_row_stride(t))
        B = y.numel() // n_rows
        if B == 0:
            return y
        if B >= 2**31 // 16:
            raise ValueError(f"batch {B} too large for one launch")
        y_ptr = y.data_ptr()
        stream = _build.current_stream(dev)
        with _build.device_scope(dev):
            for grp in groups:
                first, count, args, addr, tp, ts, last_B = grp
                tp[:count] = ptrs[first:first + count]
                ts[:count] = strides[first:first + count]
                args.y, args.stream = y_ptr, stream
                if B != last_B:
                    tb, (args.gx, args.gy) = coupling_launch(args.n_slices,
                                                             B)
                    args.B, args.tb, grp[6] = B, tb, B
                err = fn(addr)
                if err:
                    _build.check(lib, err, "sliced_ell_spmv_accumulate")
                sliced_ell_spmv_accumulate.launches += 1
        return y

    return launch


def sliced_ell_spmv_accumulate(C: Union[CouplingLayout, SlicedELL],
                               r: Union[Tensor, Sequence[Tensor]],
                               y: Tensor) -> Tensor:
    """y += C @ r in place; returns y.

    C: a :class:`CouplingLayout` (a plan's, compacted once), or a
    sliced-ELL matrix of `padded_n` rows and `x_len` columns (square or
    rectangular; on a card it is compacted on every call).  r: the tiles
    as a round receives them, one (..., h_k) tensor per ring offset in
    offset order, or joined into one (..., n_cols) tensor; y (...,
    n_rows) with the same leading dims, contiguous float32.  Each tile's
    rows must be contiguous and evenly strided (a column slice of a joined
    r is).

    CPU tensors take the plain version (`coupling_plain`, or
    `sliced_ell_spmv_plain` for a sliced-ELL C); CUDA tensors launch
    ``csrc/sliced_ell_spmv.cu``'s coupling entry, once per group of
    :func:`tile_groups` (counted in ``sliced_ell_spmv_accumulate.
    launches``): the layout is checked when it is compacted, each call
    checks the tiles and y.  Each row is summed by one thread in a fixed
    order: no atomics, the same bits on every call.
    """
    joined = isinstance(r, Tensor)
    if (r if joined else r[0]).device.type == "cpu":
        if isinstance(C, SlicedELL):
            return sliced_ell_spmv_plain(
                C, r if joined else torch.cat(list(r), -1), out=y)
        return coupling_plain(C, _split(C, r) if joined else r, y)
    if isinstance(C, SlicedELL):
        C = compact_coupling(C)
    if not C.groups:
        return y
    if C._launch is None:
        C._launch = _coupling_launcher(C)
    return C._launch(r, joined, y)


sliced_ell_spmv_accumulate.launches = 0
