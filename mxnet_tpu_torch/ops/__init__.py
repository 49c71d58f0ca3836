"""Operators of the PyTorch port: ``ops.nn`` and the hand-written CUDA
kernels under ``ops.kernels``."""
from . import nn

__all__ = ["nn"]
