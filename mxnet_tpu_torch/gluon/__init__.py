"""Gluon of the PyTorch port: Block and Parameter, layers, losses,
metrics, the Trainer and the model zoo."""
from .parameter import Constant, DeferredInitializationError, Parameter
from .block import Block, HybridBlock
from . import nn, loss, metric, model_zoo
from .trainer import Trainer

__all__ = ["Parameter", "Constant", "DeferredInitializationError", "Block",
           "HybridBlock", "nn", "loss", "metric", "model_zoo", "Trainer"]
