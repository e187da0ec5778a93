"""Data of the port: the paper's graph signals (`graph_signal_batch`).
The JAX package's `SyntheticLMData` comes with the LM training slice
(ROADMAP.md, queue 1 item 11)."""
from .pipeline import graph_signal_batch

__all__ = ["graph_signal_batch"]
