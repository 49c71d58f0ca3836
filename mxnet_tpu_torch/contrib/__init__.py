"""Contributed modules of the PyTorch port (counterpart of
``mxnet_tpu/contrib``): the decode-time half of :mod:`.quantization`."""
from . import quantization  # noqa: F401

__all__ = ["quantization"]
