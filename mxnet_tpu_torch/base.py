"""Error taxonomy, environment knobs and the f32 matmul policy of the
PyTorch port.

The port's own copy of what it needs from ``mxnet_tpu/base.py``: the
typed ``MXNetError`` / ``TransientError`` / ``FatalError`` hierarchy the
serving stack fails requests with, the env-knob readers the engine
defaults go through, :func:`dtype_from_any`, which turns the dtype
spellings the reference accepts into ``torch.dtype``s, and the f32
matmul precision policy read from ``MXNET_MATMUL_PRECISION`` at import
(``mxnet_tpu/base.py:50-70``).

The policy (``docs/precision.md``): unset or ``default`` multiplies f32
in one pass of reduced precision, TF32 on the card, as the reference's
default is one MXU pass; ``high`` or ``highest`` opts into full IEEE f32.
Any other value warns and keeps the default. The policy lives in torch's
own CUDA switches (``torch.backends.cuda.matmul.fp32_precision`` and
cuDNN's), set through their current API only: torch raises once a
process has touched both that API and the legacy ``allow_tf32`` flags.
:func:`matmul_precision` reads the live switch, so a caller who changes
it in a scope (:func:`matmul_precision_scope`) is followed, as the
reference's kernels follow ``jax.default_matmul_precision``. CPU
matmuls (``torch.backends.mkldnn``) are never touched.
"""
from __future__ import annotations

import os
import warnings
from contextlib import contextmanager

import numpy as onp
import torch

__all__ = ["MXNetError", "TransientError", "FatalError", "env_str",
           "env_int", "env_float", "dtype_from_any", "dtype_name",
           "matmul_precision", "set_matmul_precision",
           "matmul_precision_scope"]


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


def env_int(name: str, default: int = 0) -> int:
    """Integer-valued knob; an unparseable value gives the default, as the
    reference's reader does."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


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


# MXNET_MATMUL_PRECISION -> torch's fp32_precision of the CUDA switches;
# "high" keeps full f32 as the reference's kernels map it to HIGHEST
_FP32_PRECISION = {"default": "tf32", "high": "ieee", "highest": "ieee"}


def set_matmul_precision(policy: str) -> None:
    """Set the f32 policy (``"default"``, ``"high"`` or ``"highest"``) in
    torch's CUDA switches: cuBLAS matmuls and cuDNN convolutions and RNNs
    in TF32, or in IEEE f32."""
    if policy not in _FP32_PRECISION:
        raise ValueError(f"matmul precision {policy!r}: expected one of "
                         f"{sorted(_FP32_PRECISION)}")
    mode = _FP32_PRECISION[policy]
    torch.backends.cuda.matmul.fp32_precision = mode
    torch.backends.cudnn.conv.fp32_precision = mode
    torch.backends.cudnn.rnn.fp32_precision = mode


def matmul_precision() -> str:
    """The live f32 policy: ``"default"`` while cuBLAS may multiply f32 in
    TF32, else ``"highest"``."""
    tf32 = torch.backends.cuda.matmul.fp32_precision == "tf32"
    return "default" if tf32 else "highest"


@contextmanager
def matmul_precision_scope(policy: str):
    """Run the body under ``policy``, then restore the switches."""
    saved = (torch.backends.cuda.matmul.fp32_precision,
             torch.backends.cudnn.conv.fp32_precision,
             torch.backends.cudnn.rnn.fp32_precision)
    set_matmul_precision(policy)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.fp32_precision,
         torch.backends.cudnn.conv.fp32_precision,
         torch.backends.cudnn.rnn.fp32_precision) = saved


def _policy_from_env() -> str:
    val = os.environ.get("MXNET_MATMUL_PRECISION", "")
    if val in ("", "default", "high", "highest"):
        return val or "default"
    warnings.warn(
        f"MXNET_MATMUL_PRECISION={val!r} is not a valid matmul precision "
        "(expected default/high/highest); keeping the backend default",
        stacklevel=1)
    return "default"


set_matmul_precision(_policy_from_env())
