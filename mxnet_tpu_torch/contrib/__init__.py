"""Contributed modules of the PyTorch port (counterpart of
``mxnet_tpu/contrib``): the decode-time half of :mod:`.quantization`,
and :mod:`.passes` (``optimize_for``'s backends)."""
from . import passes, quantization  # noqa: F401

__all__ = ["passes", "quantization"]
