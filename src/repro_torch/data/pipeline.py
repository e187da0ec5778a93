"""Deterministic synthetic data (the JAX package's `data/pipeline.py`).

The LM stream is stateless per step (batch = f(seed, step)), so a
restarted job resumes bit-identically from a checkpoint — the property
the fault-tolerance test asserts.  Sequences are noisy modular arithmetic
progressions: learnable structure, so smoke training shows the loss fall.
It is pure numpy, copied from the JAX package: both packages draw the same
batches bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05
    n_vision_tokens: int = 0
    d_model: int = 0
    encoder_seq: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch of `step`: int32 "tokens" and "labels" (B, S), plus
        float32 "vision_embeds" / "encoder_frames" where configured."""
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2**31)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        start = rng.randint(0, V, size=(B, 1))
        stride = rng.randint(1, 7, size=(B, 1))
        toks = (start + stride * np.arange(S)[None, :]) % V
        flips = rng.rand(B, S) < self.noise
        toks = np.where(flips, rng.randint(0, V, size=(B, S)), toks)
        batch: Dict[str, np.ndarray] = {
            "tokens": toks.astype(np.int32),
            "labels": toks.astype(np.int32),
        }
        if self.n_vision_tokens:
            batch["vision_embeds"] = rng.randn(
                B, self.n_vision_tokens, self.d_model
            ).astype(np.float32)
        if self.encoder_seq:
            batch["encoder_frames"] = rng.randn(
                B, self.encoder_seq, self.d_model
            ).astype(np.float32)
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def graph_signal_batch(coords: Union[Tensor, np.ndarray],
                       kind: str = "smooth", *,
                       generator: Optional[torch.Generator] = None
                       ) -> Tensor:
    """Signals from the paper's experiments, one per vertex of `coords`
    ((N, 2) sensor positions).

    'smooth'    — Section IV-D: h_n = n_x^2 + n_y^2 - 1.
    'piecewise' — Section VI: two smooth pieces split along n_y = 1 - n_x.
    'uniform'   — Section V-E: iid Uniform[-10, 10], drawn from
                  `generator` (on the coordinates' device), which this
                  kind needs: the JAX package draws from a jax PRNG key.
    """
    coords = torch.as_tensor(coords)
    nx, ny = coords[:, 0], coords[:, 1]
    if kind == "smooth":
        return nx ** 2 + ny ** 2 - 1.0
    if kind == "piecewise":
        upper = -2.0 * nx + 0.5
        lower = nx ** 2 + ny ** 2 + 0.5
        return torch.where(ny >= 1.0 - nx, upper, lower)
    if kind == "uniform":
        if generator is None:
            raise ValueError("kind='uniform' draws from generator=")
        u = torch.rand(coords.shape[0], generator=generator,
                       dtype=coords.dtype, device=coords.device)
        return 20.0 * u - 10.0
    raise ValueError(kind)
