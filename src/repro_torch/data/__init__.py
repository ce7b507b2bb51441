"""Synthetic, checkpointable data of the port (a copy of ``repro.data``)."""
from .pipeline import DataIterator, SyntheticLMDataset, make_batch_iterator

__all__ = ["SyntheticLMDataset", "DataIterator", "make_batch_iterator"]
