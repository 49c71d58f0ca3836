"""Error taxonomy and environment knobs of the PyTorch port.

The port's own copy of what it needs from ``mxnet_tpu/base.py``: the
typed ``MXNetError`` / ``TransientError`` / ``FatalError`` hierarchy the
serving stack fails requests with, the two env-knob readers the engine
defaults go through, and :func:`dtype_from_any`, which turns the dtype
spellings the reference accepts into ``torch.dtype``s.
"""
from __future__ import annotations

import os
import warnings

import numpy as onp
import torch

__all__ = ["MXNetError", "TransientError", "FatalError", "env_str",
           "env_float", "dtype_from_any", "dtype_name"]


class MXNetError(RuntimeError):
    """Framework-level error (parity with mxnet.base.MXNetError)."""


class TransientError(MXNetError):
    """An error expected to clear on retry: resource exhaustion, overload
    shedding, a deadline that ran out. Retry loops re-attempt these and
    re-raise everything else."""


class FatalError(MXNetError):
    """An error retrying cannot fix: shape/dtype mismatches, a kernel
    that failed to build or launch, programming bugs."""


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def env_float(name: str, default: float = 0.0) -> float:
    """Float-valued knob; a set-but-unparseable value warns naming the
    variable instead of being silently ignored."""
    val = os.environ.get(name)
    if val is None:
        return default
    try:
        return float(val)
    except ValueError:
        warnings.warn(f"{name}={val!r} is not a number; using {default}",
                      RuntimeWarning, stacklevel=2)
        return default


def dtype_from_any(dtype) -> torch.dtype:
    """A ``torch.dtype`` from any spelling the reference takes: ``None``
    (float32), a ``torch.dtype``, a numpy dtype or type, or a name such
    as ``"float32"`` or ``"bfloat16"``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    name = onp.dtype(dtype).name
    if name == "bfloat16":              # ml_dtypes' numpy bfloat16
        return torch.bfloat16
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise MXNetError(f"no torch dtype for {dtype!r}")
    return out


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a ``torch.dtype`` (``torch.float32`` ->
    ``"float32"``), as the reference's ``.params`` manifest spells it."""
    return str(dtype).replace("torch.", "")
