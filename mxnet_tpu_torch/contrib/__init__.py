"""Contributed modules of the PyTorch port (counterpart of
``mxnet_tpu/contrib``): the decode-time half of :mod:`.quantization`,
:mod:`.passes` (``optimize_for``'s backends), and :mod:`.ndarray`
(``mx.contrib.nd``, the contrib ops' aliases)."""
from . import ndarray, passes, quantization  # noqa: F401
from . import ndarray as nd  # noqa: F401

__all__ = ["ndarray", "nd", "passes", "quantization"]
