"""Training runtime of the port (counterpart of ``repro.runtime``):
gradient compression, the elastic controller and the ``Trainer``."""
from .compression import CompressionState, compress_gradients, make_compressor
from .elastic import ElasticController, HostState
from .trainer import Trainer, TrainerConfig

__all__ = ["compress_gradients", "CompressionState", "make_compressor",
           "ElasticController", "HostState", "Trainer", "TrainerConfig"]
