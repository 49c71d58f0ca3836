"""I/O helpers of the PyTorch port (counterpart of ``mxnet_tpu/io``):
only the content-addressed blob store the KV spill tier's disk layer
uses (:mod:`.cache`)."""
from . import cache  # noqa: F401

__all__ = ["cache"]
