"""Gluon layers, losses, the Trainer and the model zoo of the PyTorch
port."""
from . import nn, loss, model_zoo
from .trainer import Trainer

__all__ = ["nn", "loss", "model_zoo", "Trainer"]
