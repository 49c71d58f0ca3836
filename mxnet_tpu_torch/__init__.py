"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX one, with the same module paths and
names. It imports torch and numpy only. Its kernels are hand-written
CUDA for Hopper (``csrc/``), built at first use; each has a plain
PyTorch version that CPU tensors take. Entry points run on ``gpu(0)``
unless the caller passes ``device="cpu"``. The array is
``torch.Tensor`` (``mx.nd`` holds the reference's array methods as
functions).
"""
from . import base, context
from .base import FatalError, MXNetError, TransientError
from .context import cpu, current_context, current_device, gpu
from . import ndarray, serialization
from . import ndarray as nd
from . import autograd, ops, optimizer
from .optimizer import lr_scheduler
from . import numpy as np
from . import numpy_extension as npx
from . import initializer
from . import initializer as init
from . import gluon, serving, convert, rtc
from . import aot, contrib, io, resilience, telemetry

__all__ = ["base", "context", "ndarray", "nd", "serialization",
           "autograd", "ops", "optimizer", "lr_scheduler", "np", "npx",
           "initializer", "init", "gluon", "serving", "convert", "rtc",
           "aot", "contrib", "io", "resilience", "telemetry",
           "cpu", "gpu", "current_context", "current_device", "MXNetError",
           "TransientError", "FatalError"]
