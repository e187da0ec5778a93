"""Data of the port: the paper's graph signals (`graph_signal_batch`) and
the LM's synthetic token stream (`SyntheticLMData`)."""
from .pipeline import SyntheticLMData, graph_signal_batch

__all__ = ["SyntheticLMData", "graph_signal_batch"]
