"""Training runtime of the port (counterpart of ``repro.runtime``):
gradient compression and the ``Trainer``.  Checkpointing and the elastic
controller come later (ROADMAP queue 1, item 2)."""
from .compression import CompressionState, compress_gradients, make_compressor
from .trainer import Trainer, TrainerConfig

__all__ = ["compress_gradients", "CompressionState", "make_compressor",
           "Trainer", "TrainerConfig"]
