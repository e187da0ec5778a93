"""Partitions of P over the shards of a sharded plan (PyTorch port).

The JAX package's ``repro.dist.partition`` holds the edge-cut partitions
of arbitrary sparse graphs (`GeneralPartition`); they are ported with
``partition="general"`` (ROADMAP queue 1, item 6).  For now this module
holds only the error that the Block-ELL partitions raise.
"""


class OverfullSlotsError(ValueError):
    """A row block needs more column-block slots than the uniform budget.

    Raised instead of silently truncating: dropping blocks would produce a
    wrong answer (missing edges) with no error.  Raise the ``max_slots``
    budget, use a smaller column block, or let the slot count float
    (``max_slots=None`` sizes slots to the actual max).
    """
