"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX one, with the same module paths and
names. It imports torch and numpy only. Its kernels are hand-written
CUDA for Hopper (``csrc/``), built at first use; each has a plain
PyTorch version that CPU tensors take. Entry points run on ``gpu(0)``
unless the caller passes ``device="cpu"`` or opens a device scope
(``with mx.cpu():``). The array is
``torch.Tensor`` (``mx.nd`` holds the reference's array methods as
functions).
"""
from . import base, context
from .base import FatalError, MXNetError, TransientError
from .context import (Context, Device, cpu, cpu_pinned, current_context,
                      current_device, device, gpu, num_gpus)
from . import ndarray, serialization
from . import ndarray as nd
from . import autograd, ops, optimizer
from .optimizer import lr_scheduler
from . import numpy as np
from . import numpy_extension as npx
from . import initializer
from . import initializer as init
from . import gluon, serving, convert, rtc
from . import aot, contrib, io, resilience, telemetry, util
from . import amp, image, recordio
from .util import is_np_array, set_np, use_np

__all__ = ["base", "context", "ndarray", "nd", "serialization",
           "autograd", "ops", "optimizer", "lr_scheduler", "np", "npx",
           "initializer", "init", "gluon", "serving", "convert", "rtc",
           "aot", "contrib", "io", "resilience", "telemetry", "util",
           "amp", "image", "recordio",
           "Context", "Device", "device", "cpu", "cpu_pinned", "gpu",
           "num_gpus", "current_context", "current_device", "is_np_array",
           "set_np", "use_np", "MXNetError", "TransientError", "FatalError"]
