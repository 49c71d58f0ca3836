"""``mx.np`` of the PyTorch port (counterpart of
``mxnet_tpu/numpy/__init__.py``): the NumPy-style functions the Gluon
front door uses, over ``torch.Tensor``.

Creation functions take ``device=`` (or ``ctx=``) and default to
``gpu(0)``; with no card they raise (pass ``device="cpu"``). Default
dtypes are the JAX package's, which runs with 64-bit types on:
``zeros``/``ones``/``empty`` are float32, ``array`` of Python floats is
float32 and of ints int64, ``arange`` of ints is int64 and of floats
float64, ``linspace`` is float64, ``full`` takes the fill value's type.
Elementwise functions take tensors, numbers or nested lists; a number
mixed with a tensor follows torch's promotion (an int64 tensor times 1.5
is float32 here, float64 in the reference).

Still to port (``ROADMAP.md``): the rest of the reference's functions,
``linalg`` and ``fft``.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from ..base import dtype_from_any
from ..context import resolve_device
from ..ndarray.ndarray import from_numpy, ndarray
from . import random  # noqa: F401  (submodule)

newaxis = None
pi = math.pi
e = math.e
inf = math.inf
nan = math.nan

float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
bfloat16 = torch.bfloat16
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool


def _device(ctx, device):
    return resolve_device(device if device is not None else ctx)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def array(obj, dtype=None, ctx=None, device=None, copy=True):
    """A tensor of ``obj`` on ``device``. Host float64 data becomes
    float32 unless ``dtype`` says otherwise (the reference's mx.np
    default)."""
    dev = _device(ctx, device)
    dt = None if dtype is None else dtype_from_any(dtype)
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device=dev, dtype=dt or obj.dtype, copy=copy)
    if dt == torch.bfloat16:
        host = from_numpy(onp.array(obj, onp.float32))
    else:
        a = onp.array(obj)
        if dt is None and a.dtype == onp.float64:
            a = a.astype(onp.float32)
        host = from_numpy(a)
    return host.to(device=dev, dtype=dt)


asarray = array


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, dtype=float32, ctx=None, device=None, order="C"):
    return torch.zeros(_shape(shape), dtype=dtype_from_any(dtype),
                       device=_device(ctx, device))


def ones(shape, dtype=float32, ctx=None, device=None, order="C"):
    return torch.ones(_shape(shape), dtype=dtype_from_any(dtype),
                      device=_device(ctx, device))


def empty(shape, dtype=float32, ctx=None, device=None, order="C"):
    return torch.empty(_shape(shape), dtype=dtype_from_any(dtype),
                       device=_device(ctx, device))


def _scalar_dtype(*values):
    """numpy's dtype for Python numbers (int64, float64, bool)."""
    return dtype_from_any(onp.result_type(*values))


def full(shape, fill_value, dtype=None, ctx=None, device=None):
    if isinstance(fill_value, torch.Tensor):
        dt = fill_value.dtype if dtype is None else dtype_from_any(dtype)
        return torch.broadcast_to(fill_value.to(dt), _shape(shape)).clone()
    dt = _scalar_dtype(fill_value) if dtype is None else dtype_from_any(dtype)
    return torch.full(_shape(shape), fill_value, dtype=dt,
                      device=_device(ctx, device))


def _like_dtype(a, dtype):
    return a.dtype if dtype is None else dtype_from_any(dtype)


def zeros_like(a, dtype=None):
    return torch.zeros_like(a, dtype=_like_dtype(a, dtype))


def ones_like(a, dtype=None):
    return torch.ones_like(a, dtype=_like_dtype(a, dtype))


def empty_like(a, dtype=None):
    return torch.empty_like(a, dtype=_like_dtype(a, dtype))


def full_like(a, fill_value, dtype=None):
    return torch.full_like(a, fill_value, dtype=_like_dtype(a, dtype))


def arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    if stop is None:
        start, stop = 0, start
    dt = (_scalar_dtype(start, stop, step) if dtype is None
          else dtype_from_any(dtype))
    return torch.arange(start, stop, step, dtype=dt,
                        device=_device(ctx, device))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None, device=None):
    dt = torch.float64 if dtype is None else dtype_from_any(dtype)
    dev = _device(ctx, device)
    div = (num - 1) if endpoint else num
    step = (stop - start) / div if div > 0 else nan
    if endpoint:
        out = torch.linspace(start, stop, num, dtype=torch.float64,
                             device=dev)
    else:
        out = start + step * torch.arange(num, dtype=torch.float64,
                                          device=dev)
    out = out.to(dt)
    return (out, step) if retstep else out


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------
def _t(x, like=None):
    """``x`` as a tensor: numbers stay numbers (torch promotes them
    against the other operand), lists and numpy arrays become tensors on
    the other operand's device, or on the default device (``gpu(0)``)."""
    if isinstance(x, (torch.Tensor, bool, int, float)):
        return x
    return array(x, device=like.device if isinstance(like, torch.Tensor)
                 else None)


def _binary(fn, name):
    def op(a, b, out=None):
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            a = array(a)
        res = fn(_t(a, b), _t(b, a))
        if out is not None:
            with torch.no_grad():
                out.copy_(res)
            return out
        return res

    op.__name__ = name
    return op


_BINARY = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.true_divide, "true_divide": torch.true_divide,
    "floor_divide": torch.floor_divide, "mod": torch.remainder,
    "remainder": torch.remainder, "fmod": torch.fmod, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "fmax": torch.fmax, "fmin": torch.fmin, "arctan2": torch.atan2,
    "hypot": torch.hypot, "copysign": torch.copysign,
    "logaddexp": torch.logaddexp, "logical_and": torch.logical_and,
    "logical_or": torch.logical_or, "logical_xor": torch.logical_xor,
    "equal": torch.eq, "not_equal": torch.ne, "less": torch.lt,
    "less_equal": torch.le, "greater": torch.gt, "greater_equal": torch.ge,
}
for _n, _f in _BINARY.items():
    globals()[_n] = _binary(_f, _n)
pow = globals()["power"]


def _cbrt(x):
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _unary(fn, name):
    def op(x, out=None):
        res = fn(_t(x))
        if out is not None:
            with torch.no_grad():
                out.copy_(res)
            return out
        return res

    op.__name__ = name
    return op


_UNARY = {
    "abs": torch.abs, "absolute": torch.abs, "fabs": torch.abs,
    "exp": torch.exp, "expm1": torch.expm1, "exp2": torch.exp2,
    "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "sqrt": torch.sqrt, "cbrt": _cbrt,
    "square": torch.square, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "arcsin": torch.asin, "arccos": torch.acos,
    "arctan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "arcsinh": torch.asinh, "arccosh": torch.acosh,
    "arctanh": torch.atanh, "sign": torch.sign, "floor": torch.floor,
    "ceil": torch.ceil, "trunc": torch.trunc, "fix": torch.trunc,
    "rint": torch.round, "reciprocal": torch.reciprocal,
    "negative": torch.neg, "positive": torch.positive,
    "logical_not": torch.logical_not, "isnan": torch.isnan,
    "isinf": torch.isinf, "isfinite": torch.isfinite,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "rad2deg": torch.rad2deg, "deg2rad": torch.deg2rad,
    "sigmoid": torch.sigmoid, "relu": torch.relu,
    "erf": torch.erf, "erfinv": torch.erfinv,
}
for _n, _f in _UNARY.items():
    globals()[_n] = _unary(_f, _n)


def round(x, decimals=0):
    return torch.round(x, decimals=decimals)


around = round


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _dims(axis):
    if axis is None:
        return None
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _float_for_mean(a):
    """Integer and bool inputs of a mean are taken in float64, as numpy
    (and the reference, with 64-bit types on) does."""
    return a if a.is_floating_point() or a.is_complex() else a.double()


def sum(a, axis=None, dtype=None, keepdims=False):
    dt = None if dtype is None else dtype_from_any(dtype)
    return torch.sum(a, dim=_dims(axis), keepdim=keepdims, dtype=dt)


def mean(a, axis=None, dtype=None, keepdims=False):
    if dtype is not None:
        a = a.to(dtype_from_any(dtype))
    return torch.mean(_float_for_mean(a), dim=_dims(axis), keepdim=keepdims)


def max(a, axis=None, keepdims=False):
    return torch.amax(a, dim=_dims(axis) or (), keepdim=keepdims)


def min(a, axis=None, keepdims=False):
    return torch.amin(a, dim=_dims(axis) or (), keepdim=keepdims)


def argmax(a, axis=None, keepdims=False):
    return torch.argmax(a, dim=axis, keepdim=keepdims)


def argmin(a, axis=None, keepdims=False):
    return torch.argmin(a, dim=axis, keepdim=keepdims)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------
def dot(a, b):
    """numpy's dot: scalars multiply, 1-D . 1-D is the inner product,
    N-D . 1-D sums over the last axis of ``a``, and N-D . M-D over the
    last axis of ``a`` and the second-to-last of ``b``."""
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1:
        return torch.tensordot(a, b, dims=([-1], [0]))
    if a.dim() <= 2 and b.dim() == 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


def matmul(a, b):
    return torch.matmul(a, b)


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------
def reshape(a, newshape, order="C"):
    return a.reshape(_shape(newshape))


def transpose(a, axes=None):
    if axes is None:
        axes = tuple(range(a.dim() - 1, -1, -1))
    return a.permute(*axes)


def concatenate(seq, axis=0):
    seq = list(seq)
    if axis is None:
        return torch.cat([s.reshape(-1) for s in seq])
    return torch.cat(seq, dim=axis)


def stack(arrays, axis=0):
    return torch.stack(list(arrays), dim=axis)


def expand_dims(a, axis):
    for ax in sorted(a.dim() + 1 + x if x < 0 else x
                     for x in (_dims(axis))):
        a = a.unsqueeze(ax)
    return a


def squeeze(a, axis=None):
    if axis is None:
        return a.squeeze()
    return a.squeeze(_dims(axis))


__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("annotations", "math", "onp", "torch",
                         "dtype_from_any", "resolve_device", "from_numpy")]
