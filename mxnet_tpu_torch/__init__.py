"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX one, with the same module paths and
names. It imports torch and numpy only. Its kernels are hand-written
CUDA for Hopper (``csrc/``), built at first use; each has a plain
PyTorch version that CPU tensors take. Entry points run on ``gpu(0)``
unless the caller passes ``device="cpu"``.
"""
from . import base, context
from .base import FatalError, MXNetError, TransientError
from .context import cpu, gpu
from . import ops, gluon, serving, convert

__all__ = ["base", "context", "ops", "gluon", "serving", "convert", "cpu",
           "gpu", "MXNetError", "TransientError", "FatalError"]
