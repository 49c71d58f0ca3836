"""Gluon of the PyTorch port: Block and Parameter, layers, losses,
metrics, the Trainer, the data pipeline (``gluon.data``), ``utils``,
the model zoo and ``contrib.cnn``."""
from .parameter import Constant, DeferredInitializationError, Parameter
from .block import Block, HybridBlock, SymbolBlock
from . import nn, loss, metric, model_zoo
from . import contrib
from .trainer import Trainer
from . import data, utils

__all__ = ["Parameter", "Constant", "DeferredInitializationError", "Block",
           "HybridBlock", "SymbolBlock", "nn", "loss", "metric", "model_zoo",
           "contrib", "Trainer", "data", "utils"]
