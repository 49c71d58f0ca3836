"""Error taxonomy and environment knobs of the PyTorch port.

The port's own copy of what it needs from ``mxnet_tpu/base.py``: the
typed ``MXNetError`` / ``TransientError`` / ``FatalError`` hierarchy the
serving stack fails requests with, and the two env-knob readers the
engine defaults go through.
"""
from __future__ import annotations

import os
import warnings

__all__ = ["MXNetError", "TransientError", "FatalError", "env_str",
           "env_float"]


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
