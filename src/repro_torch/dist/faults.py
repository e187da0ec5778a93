"""Seeded fault injection on the sharded exchange (the JAX package's
`repro.dist.faults`, with the same spec, policies, keys and order of
application).

Real links drop packets, deliver late and flip bits; the Chebyshev and
Jacobi iterations tolerate such bounded per-round perturbations.  A
:class:`FaultSpec` wraps the receive side of every exchange of a sharded
plan (`halo`, `cuda_halo`, banded and general partitions) and of the
gossip ring with three seeded channels and a degradation policy:

``drop_prob``
    The link delivers nothing this round.  The receiver substitutes per
    its ``degradation``: ``"zero_fill"`` (the tile is zero) or
    ``"hold_last"`` (the last delivered tile, carried across rounds in the
    matvec's state beside the int8 error-feedback residuals).
``stale_prob``
    The link delivers late: the receiver uses the previous round's
    (carried) tile instead of this round's.
``noise_prob``
    Bit noise on quantized wires (bf16, int8): each wire lane has one of
    its low 8 bits flipped with this probability.  The four scale lanes of
    an int8 row are exempt (a corrupted scale is a codec failure, not
    wire noise); f32 wires are untouched.

Every fault is applied to what was received, after the exchange, so the
counted schedule (rounds, tiles, bytes) is the clean plan's.

The draws.  The reference keys jax's PRNG by ``fold_in(seed, shard,
round, link)``; the port cannot reproduce threefry, so it keys a
counter-based generator (``numpy.random.Philox`` seeded with the tuple
``(seed, rank, round, link, salt)``, the salts the reference's 101 / 103
/ 107) on the host.  The round is the Python int the exchange matvec's
state carries, so drawing syncs nothing.  The drop and stale decisions
are host scalars; the noise mask is drawn on the host and XOR'd into the
received wire on its device.  A fault trace is thus a function of the
spec and the rank alone: the same bits on every backend and on the CPU
and the card, and another trace for another seed.

``fault_spec=None`` (or a spec with every probability 0) is the clean
path: the exchange matvec is the one without faults.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import quantize

Tensor = torch.Tensor

#: Receiver policies for a dropped link.
DEGRADATIONS = ("zero_fill", "hold_last")

#: Salts separating the per-link fault channels (the reference's).
_SALT_NOISE, _SALT_STALE, _SALT_DROP = 101, 103, 107


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded link-fault model of one plan (see the module docstring).

    drop_prob / stale_prob are per-(round, link) Bernoullis; noise_prob is
    per wire lane.  `seed` makes the fault trace a function of (seed,
    rank, round, link): the same seed gives the same faults on every run.
    """

    drop_prob: float = 0.0
    stale_prob: float = 0.0
    noise_prob: float = 0.0
    seed: int = 0

    def __post_init__(self):
        for name in ("drop_prob", "stale_prob", "noise_prob"):
            p = float(getattr(self, name))
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"FaultSpec.{name} must be in [0, 1], got {p}")
            object.__setattr__(self, name, p)
        object.__setattr__(self, "seed", int(self.seed))

    @property
    def active(self) -> bool:
        """True when any channel can fire; an all-zero spec is the clean
        exchange."""
        return (self.drop_prob > 0.0 or self.stale_prob > 0.0
                or self.noise_prob > 0.0)


def validate_degradation(degradation: str) -> str:
    if degradation not in DEGRADATIONS:
        raise ValueError(
            f"degradation must be one of {DEGRADATIONS}, "
            f"got {degradation!r}")
    return degradation


def resolve_fault_spec(
    fault_spec: Union[None, FaultSpec, dict, float]
) -> Optional[FaultSpec]:
    """Normalize a backend's ``fault_spec=``: None, a :class:`FaultSpec`,
    a dict of its fields, or a bare float for ``FaultSpec(drop_prob=p)``."""
    if fault_spec is None:
        return None
    if isinstance(fault_spec, FaultSpec):
        return fault_spec
    if isinstance(fault_spec, dict):
        return FaultSpec(**fault_spec)
    if isinstance(fault_spec, (int, float)) and not isinstance(
            fault_spec, bool):
        return FaultSpec(drop_prob=float(fault_spec))
    raise TypeError(
        f"fault_spec must be None, a FaultSpec, a dict, or a drop "
        f"probability, got {type(fault_spec).__name__}")


def fault_key(fault_spec, degradation: str = "zero_fill") -> str:
    """Identity of one (spec, policy) configuration, the reference's
    string character for character; an inactive spec is ``"none"`` (it
    runs the clean plan)."""
    validate_degradation(degradation)
    spec = resolve_fault_spec(fault_spec)
    if spec is None or not spec.active:
        return "none"
    return (f"drop{spec.drop_prob:g}-stale{spec.stale_prob:g}"
            f"-noise{spec.noise_prob:g}-seed{spec.seed}-{degradation}")


def spec_info(fault_spec) -> Optional[dict]:
    """JSON-able form of the spec for `plan.info`."""
    spec = resolve_fault_spec(fault_spec)
    if spec is None:
        return None
    return dataclasses.asdict(spec)


def make_injector(fault_spec, degradation: str, rank: int,
                  exchanging: bool) -> Optional["LinkFaultInjector"]:
    """The injector of one exchange matvec on group rank `rank`, or None
    for the clean path: no spec, an inactive one, or a site with nothing
    to exchange (one shard, no cut edge).  The degradation is validated
    in every case, so a typo raises at p = 0 too."""
    validate_degradation(degradation)
    spec = resolve_fault_spec(fault_spec)
    if spec is None or not spec.active or not exchanging:
        return None
    return LinkFaultInjector(spec, degradation, rank)


def _mask_bits(rng: np.random.Generator, shape: Tuple[int, ...],
               prob: float, np_dtype) -> np.ndarray:
    """Per lane: one of the low 8 bits set with probability `prob`, else
    0 (the XOR mask of the reference's ``_flip_low_bits``)."""
    flip = rng.random(shape) < prob
    pos = rng.integers(0, 8, size=shape, dtype=np.uint8)
    return np.where(flip, np.left_shift(1, pos), 0).astype(np_dtype)


class LinkFaultInjector:
    """Receiver-side faults of one exchange matvec on one rank.

    `round_idx` is the round counter the matvec's state carries (a Python
    int) and `link` the receive link: banded 0 = from the left (offset 1),
    1 = from the right (offset -1); general: the offset index; the gossip
    ring as the banded plan.
    """

    def __init__(self, spec: FaultSpec, degradation: str, rank: int):
        self.spec = spec
        self.degradation = validate_degradation(degradation)
        self.rank = int(rank)

    def _rng(self, round_idx: int, link: int,
             salt: int) -> np.random.Generator:
        key = (self.spec.seed % 2**64, self.rank, int(round_idx), int(link),
               salt)
        return np.random.Generator(
            np.random.Philox(np.random.SeedSequence(key)))

    def _bernoulli(self, round_idx: int, link: int, salt: int,
                   prob: float) -> bool:
        return bool(self._rng(round_idx, link, salt).random() < prob)

    def init_round(self) -> int:
        """Round-0 counter of the fault state."""
        return 0

    def init_carried(self, tiles: Sequence[Tensor]) -> Tuple[Tensor, ...]:
        """Zero carried tiles, one per incoming link: a round-0 drop
        delivers zeros under both policies (nothing has arrived to
        hold)."""
        return tuple(torch.zeros_like(t) for t in tiles)

    def wire(self, wire: Tensor, round_idx: int, link: int,
             exchange_dtype: str) -> Tensor:
        """Bit noise on one received encoded wire (before decode)."""
        if self.spec.noise_prob <= 0.0 or exchange_dtype == "f32":
            return wire
        rng = self._rng(round_idx, link, _SALT_NOISE)
        if exchange_dtype == "bf16":
            mask = _mask_bits(rng, tuple(wire.shape), self.spec.noise_prob,
                              np.int16)
            bits = wire.view(torch.int16) ^ torch.from_numpy(mask).to(
                wire.device)
            return bits.view(torch.bfloat16)
        # int8: the payload lanes only; the packed scale tail is exempt
        payload = wire[..., :-quantize._SCALE_TAIL]
        mask = _mask_bits(rng, tuple(payload.shape), self.spec.noise_prob,
                          np.uint8).view(np.int8)
        payload = payload ^ torch.from_numpy(mask).to(wire.device)
        return torch.cat([payload, wire[..., -quantize._SCALE_TAIL:]], -1)

    def recv(self, tile: Tensor, carried: Tensor, round_idx: int,
             link: int) -> Tuple[Tensor, Tensor]:
        """Stale delivery and link drop on one decoded tile.  Returns
        ``(delivered, new_carried)``: what the coupling uses this round,
        which is also the tile carried into the next (so consecutive drops
        under hold_last keep serving the last real delivery)."""
        out = tile
        if self.spec.stale_prob > 0.0 and self._bernoulli(
                round_idx, link, _SALT_STALE, self.spec.stale_prob):
            out = carried
        if self.spec.drop_prob > 0.0 and self._bernoulli(
                round_idx, link, _SALT_DROP, self.spec.drop_prob):
            out = (carried if self.degradation == "hold_last"
                   else torch.zeros_like(out))
        return out, out
