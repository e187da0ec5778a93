"""Pad-to-bucket batch assembly and its exact inverse (the JAX package's
`repro/serve/batching.py`, in torch).

The engine dispatches onto a FIXED set of batch sizes (the buckets: one
captured CUDA graph each on the card), so a dynamic group of R
compatible requests is stacked on the plan's device and zero-padded up
to the smallest bucket >= R (:func:`bucket_for`), dispatched once, and
the leading R rows of the result are handed back to their requests
(:func:`unpack_batch`).  Packing must be *lossless*: ``stack`` then
row-slice moves bits, never values, so
``unpack_batch(pack_batch(rows, B), len(rows))[i]`` is bitwise equal to
``rows[i]`` — the property ``tests/test_torch_serving.py`` pins.  Zero
padding is correct (not merely harmless) because every served operation
is linear in the signal and the padded rows are discarded before anyone
reads them.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def bucket_for(n_pending: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= `n_pending`; the largest bucket if none is.

    `buckets` must be sorted ascending (the engine normalizes at
    construction).  Oversized groups are the caller's problem — the
    engine chunks a group to the largest bucket before asking.
    """
    if n_pending < 1:
        raise ValueError(f"n_pending must be >= 1, got {n_pending}")
    for b in buckets:
        if b >= n_pending:
            return int(b)
    return int(buckets[-1])


def pack_batch(rows: Sequence, bucket: int,
               device=None) -> Tuple[torch.Tensor, int]:
    """Stack equal-shaped `rows` (tensors or arrays) on `device` (None:
    where they are) and zero-pad the batch axis to `bucket`.

    Returns ``(batch, n_valid)`` with ``batch.shape == (bucket, *row)``.
    """
    n_valid = len(rows)
    if n_valid == 0:
        raise ValueError("pack_batch needs at least one row")
    if n_valid > bucket:
        raise ValueError(
            f"{n_valid} rows exceed bucket {bucket} — chunk before "
            "packing")
    batch = torch.stack([torch.as_tensor(r, device=device) for r in rows])
    pad = bucket - n_valid
    if pad:
        batch = torch.cat(
            [batch, batch.new_zeros((pad,) + tuple(batch.shape[1:]))])
    return batch, n_valid


def unpack_batch(out, n_valid: int) -> List:
    """The first `n_valid` rows of a batched result, in pack order."""
    return [out[i] for i in range(n_valid)]
