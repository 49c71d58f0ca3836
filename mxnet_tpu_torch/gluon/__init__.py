"""Gluon layers and model zoo of the PyTorch port."""
from . import nn, model_zoo

__all__ = ["nn", "model_zoo"]
