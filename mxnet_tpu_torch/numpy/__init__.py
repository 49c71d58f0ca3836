"""``mx.np`` of the PyTorch port (counterpart of
``mxnet_tpu/numpy/__init__.py``): the NumPy-style array API over
``torch.Tensor``, with the submodules ``linalg``, ``fft`` and ``random``.

Creation functions (``zeros``, ``eye``, ``tri``, ``logspace``, the window
functions, the index builders, ...) take ``device=`` (or ``ctx=``) and
default to ``gpu(0)``; with no card they raise (pass ``device="cpu"``).
Every other function computes on its input's device. Default dtypes are
the JAX package's, which runs with 64-bit types on: ``zeros``/``ones``/
``empty``/``eye`` are float32, ``array`` of Python floats is float32 and
of ints int64, ``arange`` of ints is int64 and of floats float64,
``linspace``/``logspace`` and the windows are float64, ``full`` takes the
fill value's type. An integer input of a float-valued function is taken
in float64 when it is 64-bit and in float32 otherwise, as the reference
gives; ``sum``/``prod`` of a narrower integer or bool give int64,
``cumsum`` keeps a narrower integer's dtype (bool gives int64), and
``searchsorted``/``digitize``/``argpartition`` give int32, all as the
reference does. Elementwise functions take tensors, numbers or nested
lists; a number mixed with a tensor follows torch's promotion (an int64
tensor times 1.5 is float32 here, float64 in the reference): the one
known difference.

Computed on the host, as the reference computes them with host numpy:
``unique`` and its ``unique_*`` forms, ``union1d``, ``intersect1d``,
``setdiff1d``, ``setxor1d``, ``histogram``, ``array_str``/``array_repr``,
``save``/``savez``/``load``, ``fromfile``, ``genfromtxt``, ``fromiter``,
``fromstring`` and ``frombuffer``; each returns on its input's device.
Functions whose output size depends on the data (``nonzero``,
``argwhere``, ``flatnonzero``, ``extract``, ``compress``, ``bincount``,
``trim_zeros``, ``mask_indices``, the set functions, ``roots``) read
values on the host: inside a CUDA-graph capture (a hybridized block's)
they raise :class:`~mxnet_tpu_torch.base.MXNetError` naming the
function, as the reference raises under ``jit``.

Out-of-range indices follow JAX, which never raises on them: ``take``
clips (its default mode) or wraps, ``take_along_axis`` fills, and the
in-place writers drop updates out of range; see
:func:`mxnet_tpu_torch.ops.nn.gather_index`.
"""
from __future__ import annotations

import builtins
import functools
import math

import numpy as onp
import torch
import torch.nn.functional as F

from ..base import MXNetError, dtype_from_any
from ..context import current_context, resolve_device  # noqa: F401
from ..ndarray.ndarray import asnumpy, from_numpy
from ..ops import dispatch as _dispatch
from ..ops.nn import drop_index
from . import random  # noqa: F401  (submodule)

ndarray = torch.Tensor

newaxis = None
pi = math.pi
e = math.e
inf = math.inf
nan = math.nan
euler_gamma = float(onp.euler_gamma)

float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
bfloat16 = torch.bfloat16
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = torch.uint16
uint32 = torch.uint32
uint64 = torch.uint64
bool_ = torch.bool
complex64 = csingle = torch.complex64
complex128 = cdouble = torch.complex128
single = torch.float32
double = torch.float64
int_ = torch.int64
uint = torch.uint64
# the abstract classes of numpy's dtype tree; issubdtype and isdtype take
# torch dtypes against them
floating = onp.floating
integer = onp.integer
signedinteger = onp.signedinteger
unsignedinteger = onp.unsignedinteger
inexact = onp.inexact
complexfloating = onp.complexfloating
number = onp.number
generic = onp.generic
character = onp.character
flexible = onp.flexible
object_ = onp.object_
ufunc = onp.ufunc
iterable = onp.iterable
set_printoptions = onp.set_printoptions
get_printoptions = onp.get_printoptions
printoptions = onp.printoptions


def _device(ctx, device):
    return resolve_device(device if device is not None else ctx)


def dtype(obj):
    """The ``torch.dtype`` of a name, numpy dtype or torch dtype (the
    reference's ``np.dtype``)."""
    return dtype_from_any(obj)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _host_sync(name, module="np"):
    """Refuse a read of device values on the host inside a CUDA-graph
    capture (the reference's functions of data-dependent size raise
    under ``jit`` alike)."""
    if _capturing():
        raise MXNetError(
            f"mx.{module}.{name}: the output size depends on the values, "
            "which a CUDA-graph capture cannot read; call it outside the "
            "hybridized block")


def _host(a):
    """A host numpy copy of a tensor, or ``a`` as a numpy array."""
    return asnumpy(a) if isinstance(a, torch.Tensor) else onp.asarray(a)


def _back(arr, like=None, device=None):
    """A host array back on ``like``'s device (the default device
    otherwise)."""
    dev = like.device if isinstance(like, torch.Tensor) else _device(
        None, device)
    return from_numpy(onp.ascontiguousarray(arr)).to(dev)


def _float_of(dt):
    """The float dtype the reference computes an integer or bool input's
    float-valued function in: float64 for 64-bit integers, float32 for
    the narrower ones and bool."""
    return torch.float64 if dt in (torch.int64, torch.uint64) \
        else torch.float32


def _is_int(dt):
    return not dt.is_floating_point and not dt.is_complex \
        and dt != torch.bool


def _inexact(x):
    """``x`` in its float dtype (:func:`_float_of` for integers)."""
    return x if x.is_floating_point() or x.is_complex() \
        else x.to(_float_of(x.dtype))


def _dims(axis):
    if axis is None:
        return None
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _axes(a, axis):
    """The sorted non-negative axes ``axis`` names (all when None)."""
    if axis is None:
        return tuple(range(a.dim()))
    return tuple(sorted(d % builtins.max(a.dim(), 1) for d in _dims(axis)))


def _over_last(a, axis, keepdims, fn):
    """Reduce ``a`` over ``axis`` (several axes, or all) with ``fn``,
    which reduces the last axis of its input."""
    nd = a.dim()
    dims = _axes(a, axis)
    keep = [d for d in range(nd) if d not in dims]
    x = a.permute(*keep, *dims).reshape(*[a.shape[d] for d in keep], -1)
    out = fn(x)
    if keepdims:
        out = out.reshape([1 if d in dims else a.shape[d]
                           for d in range(nd)])
    return out


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _out(res, out):
    if out is None:
        return res
    with torch.no_grad():
        out.copy_(res)
    return out


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


def asarray(a, dtype=None, ctx=None, device=None):
    """``a`` itself when it is a tensor (cast to ``dtype`` if given), else
    :func:`array` of it."""
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype_from_any(dtype))
    return array(a, dtype=dtype, ctx=ctx, device=device)


def ascontiguousarray(a, dtype=None):
    return asarray(a, dtype).contiguous()


def copy(a):
    return _tt(a).clone()


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


def _lin64(start, stop, num, endpoint, dev):
    """numpy's linspace in float64 (the step from ``num - 1`` intervals,
    or ``num`` without the endpoint)."""
    if endpoint:
        return torch.linspace(start, stop, num, dtype=torch.float64,
                              device=dev)
    step = (stop - start) / num if num > 0 else nan
    return start + step * torch.arange(num, dtype=torch.float64, device=dev)


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None, device=None):
    dt = torch.float64 if dtype is None else dtype_from_any(dtype)
    div = (num - 1) if endpoint else num
    step = (stop - start) / div if div > 0 else nan
    out = _lin64(start, stop, num, endpoint, _device(ctx, device)).to(dt)
    return (out, step) if retstep else out


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             ctx=None, device=None):
    dt = torch.float64 if dtype is None else dtype_from_any(dtype)
    lin = _lin64(start, stop, num, endpoint, _device(ctx, device))
    return torch.pow(torch.tensor(float(base), dtype=torch.float64,
                                  device=lin.device), lin).to(dt)


def geomspace(start, stop, num=50, endpoint=True, dtype=None, ctx=None,
              device=None):
    """numpy's geomspace (both ends exact, a negative pair mirrored)."""
    dt = torch.float64 if dtype is None else dtype_from_any(dtype)
    if start == 0 or stop == 0:
        raise ValueError("Geometric sequence cannot include zero")
    sign = -1.0 if (start < 0 and stop < 0) else 1.0
    lo, hi = math.log10(sign * start), math.log10(sign * stop)
    out = torch.pow(10.0, _lin64(lo, hi, num, endpoint,
                                 _device(ctx, device)))
    if num > 0:
        out[0] = sign * start
        if endpoint and num > 1:
            out[-1] = sign * stop
    return (sign * out).to(dt)


def eye(N, M=None, k=0, dtype=float32, ctx=None, device=None):
    dev = _device(ctx, device)
    M = N if M is None else M
    rows = torch.arange(N, device=dev)[:, None] + k
    return (rows == torch.arange(M, device=dev)[None, :]).to(
        dtype_from_any(dtype))


def identity(n, dtype=float32, ctx=None, device=None):
    return eye(n, dtype=dtype, ctx=ctx, device=device)


def tri(N, M=None, k=0, dtype=float32, ctx=None, device=None):
    dev = _device(ctx, device)
    M = N if M is None else M
    rows = torch.arange(N, device=dev)[:, None] + k
    return (rows >= torch.arange(M, device=dev)[None, :]).to(
        dtype_from_any(dtype))


def _as_matrix(m, name):
    m = _tt(m)
    if m.dim() < 2:
        raise ValueError(f"Argument to {name} must be at least 2D")
    return m


def tril(m, k=0):
    """The lower triangle of the last two axes."""
    return torch.tril(_as_matrix(m, "tril"), diagonal=k)


def triu(m, k=0):
    return torch.triu(_as_matrix(m, "triu"), diagonal=k)


def diag(v, k=0):
    return torch.diag(_tt(v), k)


def diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_tt(a), offset, axis1, axis2)


def diagflat(v, k=0):
    return torch.diagflat(_tt(v), k)


def meshgrid(*xi, indexing="xy"):
    return list(torch.meshgrid(*[_tt(x).reshape(-1) for x in xi],
                               indexing=indexing))


def indices(dimensions, dtype=int32, ctx=None, device=None):
    dev = _device(ctx, device)
    dt = dtype_from_any(dtype)
    grids = torch.meshgrid(*[torch.arange(n, device=dev)
                             for n in dimensions], indexing="ij")
    if not grids:
        return torch.empty((0,), dtype=dt, device=dev)
    return torch.stack(grids).to(dt)


def fromfunction(function, shape, dtype=float, ctx=None, device=None,
                 **kwargs):
    """``function`` called with one coordinate tensor per axis of
    ``shape`` (in ``dtype``, float64 by default), on the device."""
    grids = indices(shape, dtype=dtype, ctx=ctx, device=device)
    return asarray(function(*grids, **kwargs), device=grids.device)


def frombuffer(buffer, dtype=float32, count=-1, offset=0, ctx=None,
               device=None):
    arr = onp.frombuffer(buffer, _np_dtype(dtype), count, offset)
    return _back(arr.copy(), device=device if device is not None else ctx)


def fromiter(iterable, dtype, count=-1, ctx=None, device=None):
    return _back(onp.fromiter(iterable, _np_dtype(dtype), count),
                 device=device if device is not None else ctx)


def fromstring(string, dtype=float32, count=-1, sep=" ", ctx=None,
               device=None):
    return _back(onp.fromstring(string, _np_dtype(dtype), count, sep=sep),
                 device=device if device is not None else ctx)


def fromfile(file, dtype=float32, count=-1, sep="", ctx=None, device=None):
    return _back(onp.fromfile(file, _np_dtype(dtype), count, sep),
                 device=device if device is not None else ctx)


def genfromtxt(*args, ctx=None, device=None, **kwargs):
    """numpy.genfromtxt onto the device (reference ``numpy/io.py``)."""
    return _back(onp.genfromtxt(*args, **kwargs),
                 device=device if device is not None else ctx)


def from_dlpack(x):
    return torch.from_dlpack(x)


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------
def _t(x, like=None):
    """``x`` as a tensor: numbers stay numbers (torch promotes them
    against the other operand), lists and numpy arrays become tensors on
    the other operand's device, or on the default device (``gpu(0)``)."""
    if isinstance(x, (torch.Tensor, bool, int, float, complex)):
        return x
    return array(x, device=like.device if isinstance(like, torch.Tensor)
                 else None)


def _tt(x, like=None):
    """``x`` as a tensor, numbers included (numpy's dtype of a number)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (bool, int, float)):
        dev = like.device if isinstance(like, torch.Tensor) else None
        return torch.tensor(x, dtype=_scalar_dtype(x),
                            device=_device(None, dev))
    return _t(x, like)


def _binary(fn, name, to_float=False):
    def op(a, b, out=None):
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            a = array(a)
        a, b = _t(a, b), _t(b, a)
        if _dispatch.amp_policy is not None:
            a, b = _dispatch.amp_cast(name, a, b)
        dt = torch.result_type(a, b)
        if to_float and (_is_int(dt) or dt == torch.bool):
            dt = _float_of(dt)
            a, b = (x.to(dt) if isinstance(x, torch.Tensor) else x
                    for x in (a, b))
        elif dt != torch.bool:
            # a bool tensor against numbers takes their dtype first, as
            # numpy's bool - int32 (torch refuses arithmetic on bool)
            a, b = (x.to(dt) if isinstance(x, torch.Tensor)
                    and x.dtype == torch.bool else x for x in (a, b))
        return _out(fn(a, b), out)

    op.__name__ = name
    return op


def _same_dtype(fn):
    """``fn`` of two tensors promoted to one dtype first (torch's
    heaviside, nextafter and isclose take one dtype)."""
    def op(a, b):
        a, b = _tt(a, b), _tt(b, a)
        dt = torch.result_type(a, b)
        return fn(a.to(dt), b.to(dt))
    return op


def _logaddexp2(a, b):
    return torch.logaddexp2(a, b if isinstance(b, torch.Tensor)
                            else torch.tensor(b, dtype=a.dtype,
                                              device=a.device))


def _float_power(a, b):
    return torch.pow(a, b)


def _ldexp(x, i):
    x = _tt(x)
    x = _inexact(x)
    return x * torch.pow(torch.tensor(2.0, dtype=x.dtype, device=x.device),
                         _tt(i, x).to(x.dtype))


def _numbers_as_tensors(fn):
    """``fn`` that takes no Python number (torch's maximum, atan2, ...):
    a number beside a tensor becomes a 0-d tensor of the dtype torch
    promotes the pair to, made on the tensor's device by a fill."""
    def op(a, b):
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            return fn(a, b)
        t = a if isinstance(a, torch.Tensor) else b
        dt = torch.result_type(a, b)
        a, b = (x.to(dt) if isinstance(x, torch.Tensor)
                else torch.full((), x, dtype=dt, device=t.device)
                for x in (a, b))
        return fn(a, b)
    return op


_BINARY = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.true_divide, "true_divide": torch.true_divide,
    "floor_divide": torch.floor_divide, "mod": torch.remainder,
    "remainder": torch.remainder, "fmod": torch.fmod, "power": torch.pow,
    "maximum": _numbers_as_tensors(torch.maximum),
    "minimum": _numbers_as_tensors(torch.minimum),
    "fmax": _numbers_as_tensors(torch.fmax),
    "fmin": _numbers_as_tensors(torch.fmin),
    "arctan2": _numbers_as_tensors(torch.atan2),
    "hypot": _numbers_as_tensors(torch.hypot), "copysign": torch.copysign,
    "logaddexp": _numbers_as_tensors(torch.logaddexp),
    "logaddexp2": _logaddexp2,
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or, "logical_xor": torch.logical_xor,
    "equal": torch.eq, "not_equal": torch.ne, "less": torch.lt,
    "less_equal": torch.le, "greater": torch.gt, "greater_equal": torch.ge,
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
    "gcd": _numbers_as_tensors(torch.gcd),
    "lcm": _numbers_as_tensors(torch.lcm),
    "float_power": _float_power,
    "heaviside": _same_dtype(torch.heaviside),
    "nextafter": _same_dtype(torch.nextafter),
}
# float-valued: integer arrays are taken in _float_of's dtype first
_FLOAT_BINARY = {"divide", "true_divide", "arctan2", "hypot", "copysign",
                 "logaddexp", "logaddexp2", "float_power", "heaviside",
                 "nextafter"}
for _n, _f in _BINARY.items():
    globals()[_n] = _binary(_f, _n, _n in _FLOAT_BINARY)
pow = globals()["power"]
atan2 = globals()["arctan2"]
bitwise_left_shift = globals()["left_shift"]
bitwise_right_shift = globals()["right_shift"]


def ldexp(x1, x2, out=None):
    return _out(_ldexp(x1, x2), out)


def divmod(x1, x2):  # noqa: A001
    x1, x2 = _t(x1, x2), _t(x2, x1)
    return torch.floor_divide(x1, x2), torch.remainder(x1, x2)


def _cbrt(x):
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _rint(x):
    """An integer or bool array comes back as float64 of its values, as
    the reference gives for every integer width."""
    return torch.round(x) if x.is_floating_point() else x.to(torch.float64)


def _on_bool(fn, dtype=None):
    """``fn``, but a bool input comes back as the reference gives it: its
    own values (``dtype`` None) or in ``dtype``."""
    def op(x):
        if x.dtype != torch.bool:
            return fn(x)
        return x.clone() if dtype is None else x.to(dtype)
    return op


def _sigmoid(x):
    if _is_int(x.dtype):    # the reference's logistic refuses integers
        raise TypeError(f"sigmoid does not accept dtype {x.dtype}")
    return torch.sigmoid(x)


def _gamma(x):
    """Γ(x): exp(lgamma) with the sign of Γ, negative where floor(x) is
    odd below zero; NaN at the negative integers, as the reference."""
    sign = torch.where((x > 0) | (torch.floor(x) % 2 == 0), 1.0, -1.0)
    out = sign.to(x.dtype) * torch.exp(torch.lgamma(x))
    return torch.where((x < 0) & (x == torch.floor(x)),
                       torch.full_like(out, math.nan), out)


def _spacing(x):
    """The distance to the next float away from zero (negative for
    negative x), as numpy's spacing."""
    big = torch.full_like(x, math.inf)
    return torch.where(x < 0, torch.nextafter(x, -big) - x,
                       torch.nextafter(x, big) - x)


def _angle(x):
    """The argument of x (0 or pi for a real x); an integer or bool input
    gives float64, as ``jnp.angle`` does."""
    if x.is_complex():
        return torch.angle(x)
    x = x if x.is_floating_point() else x.double()
    return torch.where(x < 0, torch.full_like(x, math.pi),
                       torch.zeros_like(x))


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _nan_to_num_default(x):
    return torch.nan_to_num(x) if x.is_floating_point() else x


def _unary(fn, name, to_float=False):
    amp_name = "gamma" if name == "gamma_fn" else name

    def op(x, out=None):
        x = _tt(x)
        if _dispatch.amp_policy is not None:
            x, = _dispatch.amp_cast(amp_name, x)
        if to_float and (_is_int(x.dtype) or x.dtype == torch.bool):
            x = x.to(_float_of(x.dtype))
        return _out(fn(x), out)

    op.__name__ = name
    return op


_UNARY = {
    "abs": _on_bool(torch.abs), "absolute": _on_bool(torch.abs),
    "fabs": _on_bool(torch.abs),
    "exp": torch.exp, "expm1": torch.expm1, "exp2": torch.exp2,
    "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "sqrt": torch.sqrt, "cbrt": _cbrt,
    "square": _on_bool(torch.square, torch.int32), "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "arcsin": torch.asin, "arccos": torch.acos,
    "arctan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "arcsinh": torch.asinh, "arccosh": torch.acosh,
    "arctanh": torch.atanh, "sign": torch.sign,
    "floor": _on_bool(torch.floor), "ceil": _on_bool(torch.ceil),
    "trunc": _on_bool(torch.trunc), "fix": _on_bool(torch.trunc),
    "rint": _rint, "reciprocal": torch.reciprocal,
    "negative": torch.neg, "positive": _on_bool(torch.positive),
    "logical_not": torch.logical_not, "isnan": torch.isnan,
    "isinf": torch.isinf, "isfinite": torch.isfinite,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "rad2deg": torch.rad2deg, "deg2rad": torch.deg2rad,
    "sigmoid": _sigmoid, "relu": _on_bool(torch.relu, torch.int64),
    "erf": torch.erf, "erfinv": torch.erfinv,
    "gamma_fn": _gamma, "gammaln": torch.lgamma,
    "invert": torch.bitwise_not, "isposinf": torch.isposinf,
    "isneginf": torch.isneginf, "signbit": torch.signbit,
    "sinc": torch.sinc, "i0": torch.i0, "spacing": _spacing,
    "conj": torch.conj_physical, "conjugate": torch.conj_physical,
    "real": torch.real, "imag": _imag, "angle": _angle,
}
_FLOAT_UNARY = {"exp", "expm1", "exp2", "log", "log2", "log10", "log1p",
                "sqrt", "cbrt", "sin", "cos", "tan", "arcsin", "arccos",
                "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh",
                "arctanh", "reciprocal", "degrees", "radians", "rad2deg",
                "deg2rad", "erf", "erfinv", "gamma_fn", "gammaln", "sinc",
                "i0", "spacing"}
for _n, _f in _UNARY.items():
    globals()[_n] = _unary(_f, _n, _n in _FLOAT_UNARY)
bitwise_not = bitwise_invert = globals()["invert"]
acos, acosh = globals()["arccos"], globals()["arccosh"]
asin, asinh = globals()["arcsin"], globals()["arcsinh"]
atan, atanh = globals()["arctan"], globals()["arctanh"]


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    x = _tt(x)
    if not x.is_floating_point():
        return x
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def round(x, decimals=0):
    """Round half to even; an integer array is returned unchanged, in its
    own dtype."""
    x = _tt(x)
    if _is_int(x.dtype):
        return x
    return torch.round(x, decimals=decimals)


around = round_ = round


def modf(x):
    """(fractional part, integral part), both carrying x's sign."""
    x = _inexact(_tt(x))
    whole = torch.trunc(x)
    return x - whole, whole


def frexp(x):
    m, ex = torch.frexp(_inexact(_tt(x)))
    return m, ex.to(torch.int32)


def unwrap(p, discont=None, axis=-1, period=2 * math.pi):
    """``jnp.unwrap``: add multiples of ``period`` so that steps along
    ``axis`` stay within ``discont`` (half the period by default)."""
    p = _tt(p)
    if not p.is_floating_point():
        p = p.double()
    if p.shape[axis] == 0:
        return p
    if discont is None:
        discont = period / 2
    interval = period / 2
    dd = torch.diff(p, dim=axis)
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0),
                        torch.full_like(ddmod, interval), ddmod)
    correct = torch.where(dd.abs() < discont, torch.zeros_like(dd),
                          ddmod - dd)
    first = p.narrow(axis, 0, 1)
    rest = p.narrow(axis, 1, p.shape[axis] - 1) + torch.cumsum(correct, axis)
    return torch.cat([first, rest], dim=axis)


def iscomplex(x):
    x = _tt(x)
    return _imag(x) != 0


def isreal(x):
    x = _tt(x)
    return _imag(x) == 0


def iscomplexobj(x):
    return isinstance(x, torch.Tensor) and x.is_complex() \
        or not isinstance(x, torch.Tensor) and onp.iscomplexobj(x)


def isrealobj(x):
    return not iscomplexobj(x)


def isscalar(x):
    return onp.isscalar(x)


# ---------------------------------------------------------------------------
# reductions and statistics
# ---------------------------------------------------------------------------
def _int_sum_dtype(a):
    """The reference's accumulator of an integer sum or product: int64
    for bool and the signed integers, uint64 for the unsigned."""
    if a.dtype == torch.bool or a.dtype in (torch.int8, torch.int16,
                                            torch.int32):
        return torch.int64
    if a.dtype in (torch.uint8, torch.uint16, torch.uint32):
        return torch.uint64
    return None


def _accumulate(a, dtype, fn):
    """``fn(a in dtype)``: a uint64 accumulation runs in int64 (torch has
    no unsigned 64-bit sum), which wraps the same modulo 2**64."""
    if dtype == torch.uint64:
        return fn(a.to(torch.int64)).to(torch.uint64)
    return fn(a if dtype is None else a.to(dtype))


def _amp1(name, a):
    """``a`` as the AMP policy casts it for ``name`` (AMP is on)."""
    return _dispatch.amp_cast(name, a)[0]


def sum(a, axis=None, dtype=None, keepdims=False, out=None):
    a = _tt(a)
    if _dispatch.amp_policy is not None:
        a = _amp1("sum", a)
    dt = _int_sum_dtype(a) if dtype is None else dtype_from_any(dtype)
    return _out(_accumulate(a, dt, lambda x: torch.sum(
        x, dim=_dims(axis), keepdim=keepdims)), out)


def prod(a, axis=None, dtype=None, keepdims=False, out=None):
    a = _tt(a)
    if _dispatch.amp_policy is not None:
        a = _amp1("prod", a)
    dt = _int_sum_dtype(a) if dtype is None else dtype_from_any(dtype)
    return _out(_accumulate(a, dt, lambda x: _over_last(
        x, axis, keepdims, lambda v: torch.prod(v, -1))), out)


def nansum(a, axis=None, dtype=None, keepdims=False, out=None):
    a = _tt(a)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
    return sum(a, axis, dtype, keepdims, out)


def nanprod(a, axis=None, dtype=None, keepdims=False, out=None):
    a = _tt(a)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.ones_like(a), a)
    return prod(a, axis, dtype, keepdims, out)


def mean(a, axis=None, dtype=None, keepdims=False, out=None):
    a = _tt(a)
    if _dispatch.amp_policy is not None:
        a = _amp1("mean", a)
    if dtype is not None:
        a = a.to(dtype_from_any(dtype))
    return _out(torch.mean(_inexact(a), dim=_dims(axis), keepdim=keepdims),
                out)


def nanmean(a, axis=None, dtype=None, keepdims=False, out=None):
    a = _inexact(_tt(a))
    if dtype is not None:
        a = a.to(dtype_from_any(dtype))
    return _out(torch.nanmean(a, dim=_dims(axis), keepdim=keepdims), out)


def max(a, axis=None, keepdims=False, out=None):
    a = _tt(a)
    return _out(torch.amax(a, dim=_dims(axis) or (), keepdim=keepdims), out)


def min(a, axis=None, keepdims=False, out=None):
    a = _tt(a)
    return _out(torch.amin(a, dim=_dims(axis) or (), keepdim=keepdims), out)


amax, amin = max, min


def _nanext(a, axis, keepdims, fn, fill):
    a = _tt(a)
    if not a.is_floating_point():
        return fn(a, dim=_dims(axis) or (), keepdim=keepdims)
    nans = torch.isnan(a)
    res = fn(torch.where(nans, torch.full_like(a, fill), a),
             dim=_dims(axis) or (), keepdim=keepdims)
    allnan = torch.all(nans, dim=_dims(axis), keepdim=keepdims) \
        if a.dim() else nans
    return torch.where(allnan, torch.full_like(res, math.nan), res)


def nanmax(a, axis=None, keepdims=False, out=None):
    return _out(_nanext(a, axis, keepdims, torch.amax, -math.inf), out)


def nanmin(a, axis=None, keepdims=False, out=None):
    return _out(_nanext(a, axis, keepdims, torch.amin, math.inf), out)


def all(a, axis=None, keepdims=False, out=None):
    a = _tt(a)
    return _out(torch.all(a.bool(), dim=_dims(axis), keepdim=keepdims), out)


def any(a, axis=None, keepdims=False, out=None):
    a = _tt(a)
    return _out(torch.any(a.bool(), dim=_dims(axis), keepdim=keepdims), out)


def argmax(a, axis=None, keepdims=False):
    return torch.argmax(_tt(a), dim=axis, keepdim=keepdims)


def argmin(a, axis=None, keepdims=False):
    return torch.argmin(_tt(a), dim=axis, keepdim=keepdims)


def nanargmax(a, axis=None):
    a = _tt(a)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.full_like(a, -math.inf), a)
    return torch.argmax(a, dim=axis)


def nanargmin(a, axis=None):
    a = _tt(a)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.full_like(a, math.inf), a)
    return torch.argmin(a, dim=axis)


def _var(a, axis, ddof, keepdims, skipnan):
    """Variance about the mean, divided by count - ddof (the non-NaN
    count with ``skipnan``)."""
    a = _inexact(_tt(a))
    dims = _dims(axis)
    if not skipnan:
        return torch.var(a, dim=dims, correction=ddof, keepdim=keepdims)
    ok = ~torch.isnan(a)
    cnt = ok.sum(dim=dims, keepdim=True).to(a.dtype)
    mu = torch.where(ok, a, torch.zeros_like(a)).sum(
        dim=dims, keepdim=True) / cnt
    dev = torch.where(ok, (a - mu) ** 2, torch.zeros_like(a))
    out = dev.sum(dim=dims, keepdim=True) / (cnt - ddof)
    if not keepdims:
        out = out.squeeze(dims) if dims is not None else out.reshape(())
    return out


def var(a, axis=None, dtype=None, ddof=0, keepdims=False, out=None):
    if _dispatch.amp_policy is not None:
        a = _amp1("var", _tt(a))
    return _out(_var(a, axis, ddof, keepdims, False), out)


def std(a, axis=None, dtype=None, ddof=0, keepdims=False, out=None):
    if _dispatch.amp_policy is not None:
        a = _amp1("std", _tt(a))
    return _out(torch.sqrt(_var(a, axis, ddof, keepdims, False)), out)


def nanvar(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
    return _out(_var(a, axis, ddof, keepdims, True), out)


def nanstd(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
    return _out(torch.sqrt(_var(a, axis, ddof, keepdims, True)), out)


def average(a, axis=None, weights=None, returned=False):
    """The weighted mean (a 1-D ``weights`` runs along ``axis``);
    ``returned`` is accepted and, as in the reference, ignored."""
    a = _tt(a)
    if weights is None:
        return mean(a, axis=axis)
    w = _tt(weights, a)
    dt = torch.result_type(_inexact(a), _inexact(w))
    a, w = a.to(dt), w.to(dt)
    if w.shape != a.shape and w.dim() == 1 and axis is not None:
        shape = [1] * a.dim()
        shape[axis] = w.shape[0]
        w = w.reshape(shape)
    return torch.sum(a * w, dim=_dims(axis)) / torch.sum(
        torch.broadcast_to(w, a.shape), dim=_dims(axis))


def ptp(a, axis=None, keepdims=False):
    return max(a, axis, keepdims) - min(a, axis, keepdims)


def _cum(a, axis, dtype, fn, nan_fill=None):
    a = _tt(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    if nan_fill is not None and a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.full_like(a, nan_fill), a)
    if dtype is not None:
        dt = dtype_from_any(dtype)
    else:
        dt = torch.int64 if a.dtype == torch.bool else a.dtype
    return fn(a, dim=axis, dtype=dt)


def cumsum(a, axis=None, dtype=None, out=None):
    if _dispatch.amp_policy is not None:
        a = _amp1("cumsum", _tt(a))
    return _out(_cum(a, axis, dtype, torch.cumsum), out)


def cumprod(a, axis=None, dtype=None, out=None):
    if _dispatch.amp_policy is not None:
        a = _amp1("cumprod", _tt(a))
    return _out(_cum(a, axis, dtype, torch.cumprod), out)


def nancumsum(a, axis=None, dtype=None, out=None):
    return _out(_cum(a, axis, dtype, torch.cumsum, 0.0), out)


def nancumprod(a, axis=None, dtype=None, out=None):
    return _out(_cum(a, axis, dtype, torch.cumprod, 1.0), out)


def count_nonzero(a, axis=None, keepdims=False):
    a = _tt(a)
    out = torch.count_nonzero(a, dim=_dims(axis))
    if keepdims:
        out = out.reshape([1 if d in _axes(a, axis) else a.shape[d]
                           for d in range(a.dim())])
    return out


# Quantiles sort on the device (torch.quantile refuses inputs of more
# than 2**24 elements and names its methods differently; torch.median
# returns the lower of the two middle values where numpy averages them).
def _quantile(a, q, axis, method, keepdims, skipnan):
    a = _inexact(_tt(a))
    qt = torch.as_tensor(q.detach() if isinstance(q, torch.Tensor) else q,
                         dtype=a.dtype, device=a.device)

    def fn(v):                                   # (..., n)
        srt = torch.sort(v, dim=-1).values       # NaN sort last
        nans = torch.isnan(v)
        cnt = (~nans).sum(-1) if skipnan else torch.full(
            v.shape[:-1], v.shape[-1], device=v.device)
        last = (cnt - 1).clamp(min=0)
        qq = qt.reshape(qt.shape + (1,) * (v.dim() - 1))
        pos = qq * (cnt - 1).to(a.dtype)
        lo = torch.floor(pos).long().clamp(min=0)
        lo = torch.minimum(lo, last)
        hi = torch.minimum(lo + 1, last)
        srt_b = srt.expand(qt.shape + srt.shape)
        vlo = torch.gather(srt_b, -1, lo[..., None])[..., 0]
        vhi = torch.gather(srt_b, -1, hi[..., None])[..., 0]
        frac = pos - lo.to(a.dtype)
        if method == "linear":
            res = vlo + (vhi - vlo) * frac
        elif method == "lower":
            res = vlo
        elif method == "higher":
            res = torch.where(frac > 0, vhi, vlo)
        elif method == "midpoint":
            res = torch.where(frac > 0, (vlo + vhi) / 2, vlo)
        elif method == "nearest":
            near = torch.minimum(torch.round(pos).long().clamp(min=0), last)
            res = torch.gather(srt_b, -1, near[..., None])[..., 0]
        else:
            raise ValueError(f"method {method!r} not understood")
        bad = (cnt == 0) if skipnan else nans.any(-1)
        return torch.where(bad, torch.full_like(res, math.nan), res)

    return _over_last(a, axis, False, fn) if not keepdims else \
        _keep_q(_over_last(a, axis, False, fn), a, axis, qt)


def _keep_q(res, a, axis, qt):
    dims = _axes(a, axis)
    return res.reshape(tuple(qt.shape) + tuple(
        1 if d in dims else a.shape[d] for d in range(a.dim())))


def quantile(a, q, axis=None, interpolation="linear", keepdims=False,
             method=None):
    return _quantile(a, q, axis, method or interpolation, keepdims, False)


def percentile(a, q, axis=None, interpolation="linear", keepdims=False,
               method=None):
    q = q / 100 if isinstance(q, torch.Tensor) else onp.asarray(q) / 100
    return _quantile(a, q, axis, method or interpolation, keepdims, False)


def nanquantile(a, q, axis=None, keepdims=False):
    return _quantile(a, q, axis, "linear", keepdims, True)


def nanpercentile(a, q, axis=None, keepdims=False):
    q = q / 100 if isinstance(q, torch.Tensor) else onp.asarray(q) / 100
    return _quantile(a, q, axis, "linear", keepdims, True)


def median(a, axis=None, keepdims=False, out=None):
    """numpy's median: the mean of the two middle values of an even
    count."""
    return _out(_quantile(a, 0.5, axis, "linear", keepdims, False), out)


def nanmedian(a, axis=None, out=None, overwrite_input=False,
              keepdims=False):
    return _out(_quantile(a, 0.5, axis, "linear", keepdims, True), out)


def bincount(x, weights=None, minlength=0):
    """Counts of each value of a non-negative integer ``x``; the length
    is ``max(x) + 1`` (at least ``minlength``), read on the host."""
    _host_sync("bincount")
    x = _tt(x)
    n = builtins.max(int(x.max().item()) + 1 if x.numel() else 0, minlength)
    if weights is None:
        return torch.zeros(n, dtype=torch.int64, device=x.device).scatter_add_(
            0, x.long(), torch.ones_like(x, dtype=torch.int64))
    w = _tt(weights, x)
    wd = w.dtype if w.is_floating_point() else _float_of(w.dtype)
    return torch.zeros(n, dtype=wd, device=x.device).scatter_add(
        0, x.long(), w.to(wd))


def histogram(a, bins=10, range=None, weights=None, density=None):
    """numpy.histogram on the host, as the reference computes it; the
    counts and edges return on a's device."""
    h, edges = onp.histogram(
        _host(a), bins=_host(bins) if isinstance(bins, torch.Tensor)
        else bins, range=range,
        weights=None if weights is None else _host(weights), density=density)
    return _back(h, a), _back(edges, a)


def _edges(x, bins, rng):
    """``bins + 1`` edges over ``rng`` or x's min and max (widened by 0.5
    each way when they are equal), as numpy's histogram_bin_edges; an
    array of edges is taken as given."""
    if isinstance(bins, (torch.Tensor, list, tuple, onp.ndarray)):
        return _inexact(_tt(bins, x))
    xf = _inexact(x)
    if rng is not None:
        lo = torch.tensor(float(rng[0]), dtype=xf.dtype, device=x.device)
        hi = torch.tensor(float(rng[1]), dtype=xf.dtype, device=x.device)
    else:
        lo, hi = xf.min(), xf.max()
    eq = lo == hi
    lo, hi = torch.where(eq, lo - 0.5, lo), torch.where(eq, hi + 0.5, hi)
    steps = torch.arange(bins + 1, dtype=xf.dtype, device=x.device)
    return lo + (hi - lo) * steps / bins


def histogram_bin_edges(a, bins=10, range=None, weights=None):
    return _edges(_tt(a), bins, range)


def _bin_of(x, edges):
    """The bin of each value (-1 when outside), the last bin closed."""
    n = edges.shape[0] - 1
    idx = torch.searchsorted(edges, x.to(edges.dtype).contiguous(),
                             right=True) - 1
    idx = torch.where(x == edges[-1], torch.full_like(idx, n - 1), idx)
    inside = (x >= edges[0]) & (x <= edges[-1])
    return torch.where(inside, idx, torch.full_like(idx, -1))


def histogram2d(x, y, bins=10, range=None, weights=None, density=None):
    """Counts of (x, y) pairs over a grid of bins, on the device."""
    x, y = _tt(x), _tt(y)
    bx, by = (bins, bins) if not isinstance(bins, (list, tuple)) \
        or len(bins) != 2 else bins
    rx, ry = (None, None) if range is None else range
    ex, ey = _edges(x, bx, rx), _edges(y, by, ry)
    ix, iy = _bin_of(x, ex), _bin_of(y, ey)
    nx, ny = ex.shape[0] - 1, ey.shape[0] - 1
    ok = (ix >= 0) & (iy >= 0)
    flat = torch.where(ok, ix * ny + iy, torch.full_like(ix, nx * ny))
    w = torch.ones_like(x, dtype=torch.int64) if weights is None \
        else _tt(weights, x)
    h = torch.zeros(nx * ny + 1, dtype=w.dtype, device=x.device)
    h = h.scatter_add(0, flat.reshape(-1), w.reshape(-1))[:-1].reshape(
        nx, ny)
    if density:
        area = (ex[1:] - ex[:-1])[:, None] * (ey[1:] - ey[:-1])[None, :]
        h = h / area / h.sum()
    return h, ex, ey


def cov(m, y=None, rowvar=True, bias=False, ddof=None):
    """numpy's covariance of the rows (``rowvar``) or columns."""
    x = _inexact(_tt(m))
    if x.dim() == 1:
        x = x[None, :]
    if not rowvar and x.shape[0] != 1:
        x = x.T
    if y is not None:
        yy = _inexact(_tt(y, x))
        if yy.dim() == 1:
            yy = yy[None, :]
        if not rowvar and yy.shape[0] != 1:
            yy = yy.T
        dt = torch.result_type(x, yy)
        x = torch.cat([x.to(dt), yy.to(dt)], dim=0)
    if ddof is None:
        ddof = 0 if bias else 1
    n = x.shape[1]
    xc = x - x.mean(dim=1, keepdim=True)
    c = xc @ xc.T.conj() / (n - ddof)
    return c.squeeze()


def corrcoef(x, y=None, rowvar=True):
    c = cov(x, y, rowvar)
    if c.dim() == 0:
        return c / c
    d = torch.sqrt(torch.diagonal(c))
    return (c / d[:, None] / d[None, :]).clamp(-1, 1)


def diff(a, n=1, axis=-1):
    return torch.diff(_tt(a), n=n, dim=axis) if n else _tt(a)


def ediff1d(ary, to_end=None, to_begin=None):
    a = _tt(ary).reshape(-1)
    parts = [torch.diff(a)]
    if to_begin is not None:
        parts.insert(0, _tt(to_begin, a).reshape(-1).to(a.dtype))
    if to_end is not None:
        parts.append(_tt(to_end, a).reshape(-1).to(a.dtype))
    return torch.cat(parts)


def gradient(f, *varargs, axis=None):
    """Central differences inside, one-sided at the edges (numpy's
    ``edge_order=1``), with a scalar spacing per axis; one array for one
    axis, else a list."""
    f = _inexact(_tt(f))
    axes = list(range(f.dim())) if axis is None else list(_dims(axis))
    hs = list(varargs) if varargs else [1.0] * len(axes)
    if len(hs) == 1 and len(axes) > 1:
        hs = hs * len(axes)
    outs = []
    for ax, h in zip(axes, hs):
        n = f.shape[ax]
        upper = (f.narrow(ax, 1, 1) - f.narrow(ax, 0, 1)) / h
        lower = (f.narrow(ax, n - 1, 1) - f.narrow(ax, n - 2, 1)) / h
        inner = (f.narrow(ax, 2, n - 2) - f.narrow(ax, 0, n - 2)) * 0.5 / h
        outs.append(torch.cat([upper, inner, lower], dim=ax))
    return outs[0] if len(outs) == 1 else outs


def trapz(y, x=None, dx=1.0, axis=-1):
    y = _inexact(_tt(y))
    if x is None:
        return torch.trapezoid(y, dx=dx, dim=axis)
    return torch.trapezoid(y, _tt(x, y).to(y.dtype), dim=axis)


trapezoid = trapz


def interp(x, xp, fp, left=None, right=None, period=None):
    """Piecewise-linear interpolation of the points (xp, fp) at x
    (``xp`` increasing); ``left``/``right`` outside, fp's ends by
    default."""
    x, xp, fp = _tt(x), _tt(xp, x), _tt(fp, x)
    dt = torch.result_type(_inexact(x), _inexact(fp))
    dt = torch.promote_types(dt, _inexact(xp).dtype)
    x, xp, fp = x.to(dt), xp.to(dt), fp.to(dt)
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.shape[0] - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    w = torch.where(dx == 0, torch.zeros_like(dx), (x - x0) / torch.where(
        dx == 0, torch.ones_like(dx), dx))
    out = f0 + (f1 - f0) * w
    lv = fp[0] if left is None else torch.tensor(left, dtype=dt,
                                                 device=x.device)
    rv = fp[-1] if right is None else torch.tensor(right, dtype=dt,
                                                   device=x.device)
    out = torch.where(x < xp[0], lv, out)
    return torch.where(x > xp[-1], rv, out)


def _correlate_full(a, v):
    """sum_n a[n + k - (m - 1)] * v[n], k over the full output."""
    dt = torch.result_type(_inexact(a), _inexact(v))
    acc = torch.float64 if _is_int(dt) else dt
    m = v.shape[0]
    out = F.conv1d(a.to(acc)[None, None], v.to(acc)[None, None],
                   padding=m - 1)[0, 0]
    return out.to(dt)


def _cut(full, n, m, mode):
    if mode == "full":
        return full
    if mode == "same":
        length = builtins.max(n, m)
        start = (full.shape[0] - length) // 2
        return full[start:start + length]
    if mode == "valid":
        length = builtins.max(n, m) - builtins.min(n, m) + 1
        start = builtins.min(n, m) - 1
        return full[start:start + length]
    raise ValueError(f"mode {mode!r} not understood")


def convolve(a, v, mode="full"):
    a, v = _tt(a), _tt(v, a)
    if a.shape[0] < v.shape[0]:
        a, v = v, a
    full = _correlate_full(a, torch.flip(v, (0,)))
    return _cut(full, a.shape[0], v.shape[0], mode)


def correlate(a, v, mode="valid"):
    a, v = _tt(a), _tt(v, a)
    n, m = a.shape[0], v.shape[0]
    if n < m:
        full = torch.flip(_correlate_full(v, a), (0,))
    else:
        full = _correlate_full(a, v)
    if mode == "same" and n < m:
        length = m
        start = (full.shape[0] - length + 1) // 2
        return full[start:start + length]
    return _cut(full, n, m, mode)


def clip(a, a_min=None, a_max=None, out=None):
    a = _tt(a)
    lo = _t(a_min, a) if a_min is not None else None
    hi = _t(a_max, a) if a_max is not None else None
    return _out(torch.clamp(a, lo, hi), out)


def astype(a, dtype):
    """Functional dtype cast (array-API style)."""
    return _tt(a).to(dtype_from_any(dtype))


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------
def dot(a, b, out=None):
    """numpy's dot: scalars multiply, 1-D . 1-D is the inner product,
    N-D . 1-D sums over the last axis of ``a``, and N-D . M-D over the
    last axis of ``a`` and the second-to-last of ``b``."""
    a, b = _tt(a), _tt(b, a)
    if _dispatch.amp_policy is not None:
        a, b = _dispatch.amp_cast("dot", a, b)
    if a.dim() == 0 or b.dim() == 0:
        res = a * b
    elif b.dim() == 1:
        res = torch.tensordot(a, b, dims=([-1], [0]))
    elif a.dim() <= 2 and b.dim() == 2:
        res = torch.matmul(a, b)
    else:
        res = torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))
    return _out(res, out)


def matmul(a, b):
    a, b = _tt(a), _tt(b, a)
    if _dispatch.amp_policy is not None:
        a, b = _dispatch.amp_cast("matmul", a, b)
    return torch.matmul(a, b)


def _promoted(a, b):
    a, b = _tt(a), _tt(b, a)
    dt = torch.result_type(a, b)
    return a.to(dt), b.to(dt)


def inner(a, b):
    a, b = _promoted(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([-1], [-1]))


def outer(a, b):
    a, b = _promoted(a, b)
    return a.reshape(-1)[:, None] * b.reshape(-1)[None, :]


def vdot(a, b):
    a, b = _promoted(a, b)
    return torch.sum(a.reshape(-1).conj() * b.reshape(-1)).to(a.dtype)


def vecdot(x1, x2, axis=-1):
    a, b = _promoted(x1, x2)
    return torch.sum(a.conj() * b, dim=axis).to(a.dtype)


def kron(a, b):
    a, b = _promoted(a, b)
    return torch.kron(a, b)


def tensordot(a, b, axes=2):
    a, b = _promoted(a, b)
    return torch.tensordot(a, b, dims=axes)


def einsum(subscripts, *operands, **kwargs):
    """torch.einsum of the operands promoted to one dtype (torch takes
    one)."""
    ops = _seq(operands)
    if _dispatch.amp_policy is not None:
        ops = _dispatch.amp_cast("einsum", *ops)
    dt = functools.reduce(torch.promote_types, [o.dtype for o in ops])
    return torch.einsum(subscripts, *[o.to(dt) for o in ops])


def einsum_path(*operands, optimize="greedy"):
    """The contraction order of an einsum: opt_einsum's, as the
    reference's ``jnp.einsum_path`` gives it, where opt_einsum is
    installed; else left to right, with a one-line report."""
    subscripts, ops = operands[0], operands[1:]
    shapes = [tuple(o.shape) if isinstance(o, torch.Tensor)
              else onp.shape(o) for o in ops]
    try:
        import opt_einsum
    except ImportError:
        path = [(0, 1)] * (len(shapes) - 1) if len(shapes) > 1 else [(0,)]
        return (path,
                f"  Complete contraction:  {subscripts}\n"
                "  (left-to-right order; opt_einsum is not installed)")
    path, info = opt_einsum.contract_path(subscripts, *shapes, shapes=True,
                                          optimize=optimize)
    return list(path), info


def trace(a, offset=0, axis1=0, axis2=1):
    return sum(torch.diagonal(_tt(a), offset, axis1, axis2), axis=-1)


def cross(a, b, axis=-1):
    """The cross product of 3-vectors (a 2-vector has z = 0; two
    2-vectors give the z component alone), along ``axis``."""
    a, b = _promoted(a, b)
    a, b = torch.movedim(a, axis, -1), torch.movedim(b, axis, -1)
    if a.shape[-1] == 2 and b.shape[-1] == 2:
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    if a.shape[-1] == 2:
        a = F.pad(a, (0, 1))
    if b.shape[-1] == 2:
        b = F.pad(b, (0, 1))
    a, b = torch.broadcast_tensors(a, b)
    out = torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                       a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                       a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)
    return torch.movedim(out, -1, axis)


def matrix_transpose(x):
    return _tt(x).transpose(-2, -1)


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------
def reshape(a, newshape, order="C"):
    return _tt(a).reshape(_shape(newshape))


def transpose(a, axes=None):
    a = _tt(a)
    if axes is None:
        axes = tuple(range(a.dim() - 1, -1, -1))
    return a.permute(*axes)


permute_dims = transpose


def swapaxes(a, axis1, axis2):
    return _tt(a).transpose(axis1, axis2)


def moveaxis(a, source, destination):
    return torch.movedim(_tt(a), source, destination)


def rollaxis(a, axis, start=0):
    a = _tt(a)
    n = a.dim()
    axis %= n
    start = start + n if start < 0 else start
    if axis < start:
        start -= 1
    return torch.movedim(a, axis, start) if axis != start else a


def ravel(a, order="C"):
    return _tt(a).reshape(-1)


flatten = ravel


def expand_dims(a, axis):
    a = _tt(a)
    for ax in sorted(a.dim() + 1 + x if x < 0 else x
                     for x in (_dims(axis))):
        a = a.unsqueeze(ax)
    return a


def squeeze(a, axis=None):
    a = _tt(a)
    if axis is None:
        return a.squeeze()
    return a.squeeze(_dims(axis))


def broadcast_to(a, shape):
    return torch.broadcast_to(_tt(a), _shape(shape))


def broadcast_arrays(*args):
    return list(torch.broadcast_tensors(*[_tt(a) for a in args]))


def broadcast_shapes(*shapes):
    return tuple(torch.broadcast_shapes(*[_shape(s) for s in shapes]))


def _atleast(fn, arys):
    outs = [fn(_tt(a)) for a in arys]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*arys):
    return _atleast(torch.atleast_1d, arys)


def atleast_2d(*arys):
    return _atleast(torch.atleast_2d, arys)


def atleast_3d(*arys):
    return _atleast(torch.atleast_3d, arys)


def shape(a):
    return tuple(a.shape) if isinstance(a, torch.Tensor) else onp.shape(a)


def ndim(a):
    return a.dim() if isinstance(a, torch.Tensor) else onp.ndim(a)


def size(a, axis=None):
    if isinstance(a, torch.Tensor):
        return a.numel() if axis is None else a.shape[axis]
    return onp.size(a, axis)


# ---------------------------------------------------------------------------
# joining and splitting
# ---------------------------------------------------------------------------
def _seq(seq):
    seq = list(seq)
    like = next((s for s in seq if isinstance(s, torch.Tensor)), None)
    return [_tt(s, like) for s in seq]


def concatenate(seq, axis=0, out=None):
    seq = _seq(seq)
    if axis is None:
        return _out(torch.cat([s.reshape(-1) for s in seq]), out)
    return _out(torch.cat(seq, dim=axis), out)


concat = concatenate


def stack(arrays, axis=0, out=None):
    return _out(torch.stack(_seq(arrays), dim=axis), out)


def vstack(tup):
    return torch.vstack(_seq(tup))


row_stack = vstack


def hstack(tup):
    return torch.hstack(_seq(tup))


def dstack(tup):
    return torch.dstack(_seq(tup))


def column_stack(tup):
    return torch.column_stack(_seq(tup))


def block(arrays):
    """Assemble an array from nested lists of blocks (numpy's ``block``:
    the innermost lists join along the last axis, the next along the
    second to last, ...)."""
    def depth(x):
        return 1 + depth(x[0]) if isinstance(x, list) else 0

    d = depth(arrays)
    leaves = []

    def collect(x):
        if isinstance(x, list):
            for y in x:
                collect(y)
        else:
            leaves.append(x)

    collect(arrays)
    like = next((s for s in leaves if isinstance(s, torch.Tensor)), None)
    nd = builtins.max([d] + [_tt(x, like).dim() for x in leaves])

    def build(x, level):
        if not isinstance(x, list):
            t = _tt(x, like)
            return t.reshape((1,) * (nd - t.dim()) + tuple(t.shape))
        return torch.cat([build(y, level + 1) for y in x],
                         dim=-(d - level))

    return build(arrays, 0)


def append(arr, values, axis=None):
    arr = _tt(arr)
    values = _tt(values, arr)
    if axis is None:
        return torch.cat([arr.reshape(-1), values.reshape(-1)])
    return torch.cat([arr, values], dim=axis)


def split(ary, indices_or_sections, axis=0):
    a = _tt(ary)
    if isinstance(indices_or_sections, int) \
            and a.shape[axis] % indices_or_sections:
        raise ValueError("array split does not result in an equal division")
    return array_split(a, indices_or_sections, axis)


def array_split(ary, indices_or_sections, axis=0):
    a = _tt(ary)
    ios = indices_or_sections
    if isinstance(ios, torch.Tensor):
        ios = ios.tolist()
    return list(torch.tensor_split(a, ios if isinstance(ios, int)
                                   else list(ios), dim=axis))


def hsplit(ary, indices_or_sections):
    a = _tt(ary)
    return split(a, indices_or_sections, axis=1 if a.dim() > 1 else 0)


def vsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=0)


def dsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=2)


# ---------------------------------------------------------------------------
# reordering and editing
# ---------------------------------------------------------------------------
def tile(A, reps):
    return torch.tile(_tt(A), (reps,) if isinstance(reps, int)
                      else tuple(reps))


def repeat(a, repeats, axis=None):
    a = _tt(a)
    if isinstance(repeats, (list, tuple, onp.ndarray)):
        repeats = torch.as_tensor(repeats, device=a.device)
    return torch.repeat_interleave(a, repeats, dim=axis)


def flip(m, axis=None):
    m = _tt(m)
    dims = tuple(range(m.dim())) if axis is None else _dims(axis)
    return torch.flip(m, dims)


def fliplr(m):
    return torch.fliplr(_tt(m))


def flipud(m):
    return torch.flipud(_tt(m))


def roll(a, shift, axis=None):
    a = _tt(a)
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


def rot90(m, k=1, axes=(0, 1)):
    return torch.rot90(_tt(m), k, list(axes))


def _pad_widths(pad_width, nd):
    pw = onp.broadcast_to(onp.asarray(pad_width, dtype=onp.int64),
                          (nd, 2))
    return [(int(b), int(a)) for b, a in pw]


def _pad_source(n, before, after, mode):
    """Source index of each position of an axis padded by (before,
    after): edge clamps, wrap repeats, reflect mirrors about the ends,
    symmetric mirrors including them (numpy's periodic extensions)."""
    j = onp.arange(-before, n + after)
    if mode == "edge":
        return onp.clip(j, 0, n - 1)
    if mode == "wrap":
        return j % n
    if mode == "reflect":
        if n == 1:
            return onp.zeros_like(j)
        p = 2 * (n - 1)
        j = j % p
        return onp.where(j >= n, p - j, j)
    if mode == "symmetric":
        p = 2 * n
        j = j % p
        return onp.where(j >= n, p - 1 - j, j)
    raise ValueError(mode)


def pad(array, pad_width, mode="constant", **kwargs):
    """numpy's pad, axis by axis: ``constant`` (``constant_values``),
    ``edge``, ``wrap``, ``reflect``, ``symmetric``, ``linear_ramp``
    (``end_values``), ``maximum``/``minimum``/``mean``/``median`` over the
    whole axis, and ``empty`` (zeros)."""
    x = _tt(array)
    widths = _pad_widths(pad_width, x.dim())
    for ax, (b, a) in enumerate(widths):
        if b == 0 and a == 0:
            continue
        n = x.shape[ax]
        if mode in ("edge", "wrap", "reflect", "symmetric"):
            src = torch.as_tensor(_pad_source(n, b, a, mode),
                                  device=x.device)
            x = torch.index_select(x, ax, src)
            continue
        shape_b = list(x.shape)
        shape_b[ax] = b
        shape_a = list(x.shape)
        shape_a[ax] = a
        if mode in ("constant", "empty"):
            cv = kwargs.get("constant_values", 0) if mode == "constant" \
                else 0
            cb, ca = onp.broadcast_to(onp.asarray(cv), (x.dim(), 2))[ax] \
                if onp.ndim(cv) else (cv, cv)
            left = torch.full(shape_b, float(cb) if x.is_floating_point()
                              else int(cb), dtype=x.dtype, device=x.device)
            right = torch.full(shape_a, float(ca) if x.is_floating_point()
                               else int(ca), dtype=x.dtype, device=x.device)
        elif mode == "linear_ramp":
            # numpy's linspace(end_value, edge, width, endpoint=False),
            # reversed on the right; floored for integer arrays
            ev = kwargs.get("end_values", 0)
            eb, ea = onp.broadcast_to(onp.asarray(ev), (x.dim(), 2))[ax] \
                if onp.ndim(ev) else (ev, ev)
            view = [1] * x.dim()
            view[ax] = -1
            tb = (torch.arange(b, dtype=torch.float64, device=x.device)
                  / builtins.max(b, 1)).reshape(view)
            ta = (torch.arange(a - 1, -1, -1, dtype=torch.float64,
                               device=x.device)
                  / builtins.max(a, 1)).reshape(view)
            edge0 = x.narrow(ax, 0, 1).double()
            edge1 = x.narrow(ax, n - 1, 1).double()
            left = float(eb) + (edge0 - float(eb)) * tb
            right = float(ea) + (edge1 - float(ea)) * ta
            if not x.is_floating_point():
                left, right = torch.floor(left), torch.floor(right)
            left, right = left.to(x.dtype), right.to(x.dtype)
        elif mode in ("maximum", "minimum", "mean", "median"):
            fn = {"maximum": lambda v: torch.amax(v, ax, keepdim=True),
                  "minimum": lambda v: torch.amin(v, ax, keepdim=True),
                  "mean": lambda v: torch.mean(_inexact(v), ax,
                                               keepdim=True),
                  "median": lambda v: median(v, ax, keepdims=True)}[mode]
            stat = fn(x)
            if not x.is_floating_point():
                stat = torch.round(stat) if stat.is_floating_point() \
                    else stat
            stat = stat.to(x.dtype)
            left = stat.expand(shape_b)
            right = stat.expand(shape_a)
        else:
            raise ValueError(f"mode {mode!r} is not supported")
        x = torch.cat([left, x, right], dim=ax)
    return x


def resize(a, new_shape):
    """numpy's resize: the flattened array repeated cyclically to fill
    ``new_shape``."""
    a = _tt(a).reshape(-1)
    shp = _shape(new_shape)
    total = math.prod(shp)
    if a.numel() == 0:
        return torch.zeros(shp, dtype=a.dtype, device=a.device)
    reps = -(-total // a.numel())
    return a.repeat(reps)[:total].reshape(shp)


def _obj_index(obj, n):
    """The positions an ``insert``/``delete`` object names (an int, a
    slice or a sequence), non-negative."""
    if isinstance(obj, slice):
        return onp.arange(n)[obj]
    if isinstance(obj, torch.Tensor):
        obj = obj.tolist()
    idx = onp.asarray(obj, dtype=onp.int64)
    return onp.where(idx < 0, idx + n, idx)


def delete(arr, obj, axis=None):
    a = _tt(arr)
    if axis is None:
        a, axis = a.reshape(-1), 0
    n = a.shape[axis]
    keep = onp.ones(n, bool)
    keep[_obj_index(obj, n)] = False
    return torch.index_select(a, axis, torch.as_tensor(
        onp.nonzero(keep)[0], device=a.device))


def insert(arr, obj, values, axis=None):
    """numpy's insert: an int ``obj`` inserts ``values`` as one block
    before that index; a sequence inserts one value before each index."""
    a = _tt(arr)
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis %= a.dim()
    n = a.shape[axis]
    v = _tt(values, a).to(a.dtype)
    scalar_obj = isinstance(obj, int) or (
        isinstance(obj, torch.Tensor) and obj.dim() == 0)
    if scalar_obj:
        i = int(obj)
        i = i + n if i < 0 else i
        v = v.reshape((1,) * (a.dim() - v.dim()) + tuple(v.shape))
        v = torch.movedim(v, 0, axis) if a.dim() > 1 else v
        shape = list(a.shape)
        shape[axis] = v.shape[axis]
        v = torch.broadcast_to(v, shape)
        return torch.cat([a.narrow(axis, 0, i), v,
                          a.narrow(axis, i, n - i)], dim=axis)
    idx = _obj_index(obj, n).reshape(-1)
    k = idx.shape[0]
    rank = onp.empty(k, onp.int64)
    rank[onp.argsort(idx, kind="stable")] = onp.arange(k)
    new_pos = idx + rank                 # value j lands before idx[j]
    shape = list(a.shape)
    shape[axis] = k
    v = torch.broadcast_to(
        v.reshape((1,) * (a.dim() - v.dim()) + tuple(v.shape)), shape)
    old = onp.ones(n + k, bool)
    old[new_pos] = False
    shape[axis] = n + k
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    out = out.index_copy(axis, torch.as_tensor(onp.nonzero(old)[0],
                                               device=a.device), a)
    return out.index_copy(axis, torch.as_tensor(new_pos, device=a.device),
                          v)


def trim_zeros(filt, trim="fb"):
    _host_sync("trim_zeros")
    f = _tt(filt)
    nz = torch.nonzero(f.reshape(-1)).reshape(-1).tolist()
    if not nz:
        return f[:0]
    lo = nz[0] if "f" in trim.lower() else 0
    hi = nz[-1] + 1 if "b" in trim.lower() else f.shape[0]
    return f[lo:hi]


def fill_diagonal(a, val, wrap=False):
    """A copy of ``a`` with its main diagonal set to ``val`` (cycled when
    an array); a tall 2-D matrix restarts the diagonal after a blank row
    with ``wrap``, as numpy's fill_diagonal does."""
    a = _tt(a)
    out = a.clone().reshape(-1)
    if a.dim() == 2:
        step = a.shape[1] + 1
        end = a.numel() if wrap else builtins.min(a.shape[0],
                                                   a.shape[1]) * a.shape[1]
    else:
        step = 1 + builtins.sum(math.prod(a.shape[d + 1:])
                                for d in range(a.dim() - 1))
        end = a.numel()
    pos = torch.arange(0, end, step, device=a.device)
    vals = _tt(val, a).to(a.dtype).reshape(-1)
    vals = vals.repeat(-(-pos.numel() // builtins.max(vals.numel(), 1)))
    out[pos] = vals[:pos.numel()]
    return out.reshape(a.shape)


# ---------------------------------------------------------------------------
# indexing, searching, sorting
# ---------------------------------------------------------------------------
def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    c = _tt(condition)
    x, y = _t(x, c), _t(y, c)
    return torch.where(c.bool(), x, y)


def nonzero(a):
    _host_sync("nonzero")
    return tuple(torch.nonzero(_tt(a), as_tuple=True))


def argwhere(a):
    _host_sync("argwhere")
    return torch.argwhere(_tt(a))


def flatnonzero(a):
    _host_sync("flatnonzero")
    return torch.nonzero(_tt(a).reshape(-1)).reshape(-1)


def take(a, indices, axis=None, mode="clip"):
    """a's entries at ``indices`` along ``axis`` (of the flattened array
    when None). ``mode="clip"`` (the default) clamps each index into
    range, a negative one to 0; any other mode wraps it modulo the
    length, as the reference does."""
    a = _tt(a)
    idx = _tt(indices, a).long()
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis %= a.dim()
    n = a.shape[axis]
    idx = idx.clamp(0, n - 1) if mode == "clip" else torch.remainder(idx, n)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def _fill_value(dt):
    """JAX's fill for an out-of-range gather: NaN, the signed minimum,
    the unsigned maximum, True."""
    if dt.is_floating_point or dt.is_complex:
        return math.nan
    if dt == torch.bool:
        return True
    return torch.iinfo(dt).min if dt not in (torch.uint8, torch.uint16,
                                             torch.uint32, torch.uint64) \
        else torch.iinfo(dt).max


def take_along_axis(arr, indices, axis):
    """``arr`` gathered along ``axis``; a negative index counts from the
    end, and one still out of range gives JAX's fill value (NaN for
    floats)."""
    a = _tt(arr)
    idx = _tt(indices, a).long()
    if axis is None:
        a, axis = a.reshape(-1), 0
    n = a.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    out = torch.take_along_dim(a, idx.clamp(0, n - 1), dim=axis)
    return torch.where(ok, out, torch.full((), _fill_value(a.dtype),
                                           dtype=a.dtype, device=a.device))


def put_along_axis(arr, indices, values, axis):
    """Write ``values`` into ``arr`` along ``axis`` at ``indices``, in
    place, and return ``arr``; out-of-range updates are dropped."""
    a = _tt(arr)
    idx = _tt(indices, a)
    n = a.shape[axis]
    safe = drop_index(idx, n)
    v = torch.broadcast_to(_tt(values, a).to(a.dtype), safe.shape)
    pad = [0, 0] * (a.dim() - 1 - axis % a.dim()) + [0, 1]
    padded = F.pad(a, pad)
    res = padded.scatter(axis % a.dim(), safe, v).narrow(axis, 0, n)
    with torch.no_grad():
        a.copy_(res)
    return a


def choose(a, choices, mode="raise"):
    """``choices[a[i]][i]``. ``mode="raise"`` checks the indices on the
    host (raising ``ValueError``); ``"wrap"`` and ``"clip"`` do not read
    them."""
    idx = _tt(a).long()
    cs = _seq(choices)
    n = len(cs)
    if mode == "raise":
        _host_sync("choose")
        if bool(((idx < 0) | (idx >= n)).any()):
            raise ValueError("invalid entry in choice array")
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    else:
        raise ValueError(f"mode={mode!r} not understood")
    idx, *cs = torch.broadcast_tensors(idx, *cs)
    return torch.gather(torch.stack(cs), 0, idx[None])[0]


def compress(condition, a, axis=None):
    _host_sync("compress")
    a = _tt(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    c = _tt(condition, a).reshape(-1).bool()[:a.shape[axis]]
    return torch.index_select(a, axis, torch.nonzero(c).reshape(-1))


def extract(condition, arr):
    _host_sync("extract")
    a = _tt(arr).reshape(-1)
    c = _tt(condition, a).reshape(-1).bool()
    return a[c[:a.shape[0]]]


def select(condlist, choicelist, default=0):
    like = next((c for c in list(condlist) + list(choicelist)
                 if isinstance(c, torch.Tensor)), None)
    out = _tt(default, like)
    for c, v in reversed(list(zip(condlist, choicelist))):
        out = torch.where(_tt(c, like).bool(), _tt(v, like), out)
    return out


def piecewise(x, condlist, funclist, *args, **kw):
    """``funclist[i]`` (a callable of x, or a value) where ``condlist[i]``
    holds, later conditions winning; an extra last function or value
    fills where none holds (0 otherwise)."""
    x = _tt(x)
    conds = [_tt(c, x).bool() for c in condlist]
    if len(funclist) == len(conds) + 1:
        default, funcs = funclist[-1], list(funclist[:-1])
    else:
        default, funcs = 0, list(funclist)

    def value(f):
        v = f(x, *args, **kw) if callable(f) else f
        return torch.broadcast_to(_tt(v, x).to(x.dtype), x.shape)

    out = value(default)
    for c, f in zip(conds, funcs):
        out = torch.where(c, value(f), out)
    return out


def _sort_input(a):
    return a.to(torch.uint8) if a.dtype == torch.bool else a


def sort(a, axis=-1, kind=None, order=None, stable=True, descending=False):
    """Stable ascending sort (``jnp.sort`` is stable)."""
    a = _tt(a)
    if axis is None:
        a, axis = a.reshape(-1), -1
    out = torch.sort(_sort_input(a), dim=axis, stable=True).values
    return out.to(a.dtype)


def argsort(a, axis=-1, kind=None, order=None, stable=True,
            descending=False):
    a = _tt(a)
    if axis is None:
        a, axis = a.reshape(-1), -1
    return torch.argsort(_sort_input(a), dim=axis, stable=True)


def lexsort(keys, axis=-1):
    """Indices sorting by the last key first, ties by the one before,
    ...; stable."""
    ks = _seq(keys)
    idx = torch.argsort(_sort_input(ks[0]), dim=axis, stable=True)
    for k in ks[1:]:
        k = _sort_input(k)
        idx = torch.take_along_dim(idx, torch.argsort(
            torch.take_along_dim(k, idx, dim=axis), dim=axis, stable=True),
            dim=axis)
    return idx


def partition(a, kth, axis=-1):
    """``jnp.partition``'s order: the kth + 1 smallest ascending, then the
    rest descending (``lax.top_k``)."""
    a = _tt(a)
    x = torch.movedim(_sort_input(a), axis, -1)
    n = x.shape[-1]
    kth %= n
    bottom = torch.sort(x, dim=-1, stable=True).values[..., :kth + 1]
    top = torch.sort(x, dim=-1, descending=True,
                     stable=True).values[..., :n - kth - 1]
    return torch.movedim(torch.cat([bottom, top], -1), -1, axis).to(a.dtype)


def argpartition(a, kth, axis=-1):
    """``jnp.argpartition``'s order: the indices of the kth + 1 smallest
    (ties by lower index), then the other indices in increasing order;
    int32, as the reference gives."""
    a = _tt(a)
    x = torch.movedim(_sort_input(a), axis, -1)
    n = x.shape[-1]
    kth %= n
    bottom = torch.argsort(x, dim=-1, stable=True)[..., :kth + 1]
    rest = torch.ones(x.shape, dtype=torch.int32, device=x.device)
    rest = rest.scatter(-1, bottom, 0)
    top = torch.argsort(rest, dim=-1, descending=True,
                        stable=True)[..., :n - kth - 1]
    return torch.movedim(torch.cat([bottom, top], -1), -1, axis).to(
        torch.int32)


def searchsorted(a, v, side="left", sorter=None):
    """Insertion points of ``v`` in the sorted 1-D ``a``, int32 as the
    reference gives (``sorter`` is accepted and ignored, as there)."""
    a = _tt(a)
    v = _tt(v, a)
    dt = torch.promote_types(a.dtype, v.dtype)
    return torch.searchsorted(a.to(dt), v.to(dt).contiguous(),
                              right=side == "right").to(torch.int32)


def digitize(x, bins, right=False):
    """The bin of each value: ``bins[i-1] <= x < bins[i]`` for increasing
    bins (``<``/``<=`` swapped with ``right``), mirrored for decreasing
    ones; int32."""
    x = _tt(x)
    b = _tt(bins, x)
    dt = torch.promote_types(x.dtype, b.dtype)
    x, b = x.to(dt).contiguous(), b.to(dt)
    if b.shape[0] > 1 and bool(b[-1] < b[0]):
        idx = b.shape[0] - torch.searchsorted(torch.flip(b, (0,)), x,
                                              right=not right)
    else:
        idx = torch.searchsorted(b, x, right=not right)
    return idx.to(torch.int32)


def _unique_host(name, ar, **kw):
    _host_sync(name)
    return onp.unique(_host(ar), **kw)


def unique(ar, return_index=False, return_inverse=False,
           return_counts=False, axis=None):
    """numpy.unique on the host, as the reference computes it (torch's
    unique has no ``return_index``); results return on ar's device."""
    out = _unique_host("unique", ar, return_index=return_index,
                       return_inverse=return_inverse,
                       return_counts=return_counts, axis=axis)
    if isinstance(out, tuple):
        return tuple(_back(o, ar) for o in out)
    return _back(out, ar)


def unique_values(x):
    return _back(_unique_host("unique_values", x), x)


def unique_counts(x):
    v, c = _unique_host("unique_counts", x, return_counts=True)
    return _back(v, x), _back(c, x)


def unique_inverse(x):
    v, i = _unique_host("unique_inverse", x, return_inverse=True)
    return _back(v, x), _back(i, x)


def unique_all(x):
    out = _unique_host("unique_all", x, return_index=True,
                       return_inverse=True, return_counts=True)
    return tuple(_back(o, x) for o in out)


def isin(element, test_elements, invert=False):
    e = _tt(element)
    return torch.isin(e, _tt(test_elements, e), invert=invert)


def in1d(ar1, ar2, assume_unique=False, invert=False):
    return isin(ar1, ar2, invert=invert).reshape(-1)


def _set_host(name, fn, ar1, ar2, **kw):
    _host_sync(name)
    res = fn(_host(ar1), _host(ar2), **kw)
    like = ar1 if isinstance(ar1, torch.Tensor) else ar2
    if isinstance(res, tuple):
        return tuple(_back(r, like) for r in res)
    return _back(res, like)


def union1d(ar1, ar2):
    return _set_host("union1d", onp.union1d, ar1, ar2)


def intersect1d(ar1, ar2, assume_unique=False, return_indices=False):
    return _set_host("intersect1d", onp.intersect1d, ar1, ar2,
                     assume_unique=assume_unique,
                     return_indices=return_indices)


def setdiff1d(ar1, ar2, assume_unique=False):
    return _set_host("setdiff1d", onp.setdiff1d, ar1, ar2,
                     assume_unique=assume_unique)


def setxor1d(ar1, ar2, assume_unique=False):
    return _set_host("setxor1d", onp.setxor1d, ar1, ar2,
                     assume_unique=assume_unique)


# ---------------------------------------------------------------------------
# index helpers
# ---------------------------------------------------------------------------
def unravel_index(indices, shape):
    """The coordinates of flat ``indices`` in ``shape`` (in the indices'
    dtype); an index out of range is clamped into it first, as
    ``jnp.unravel_index`` does."""
    idx = _tt(indices)
    total = math.prod(shape)
    idx = idx.clamp(-total, total - 1)
    idx = torch.where(idx < 0, idx + total, idx)
    out = []
    for s in reversed(shape):
        out.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return tuple(reversed(out))


def ravel_multi_index(multi_index, dims, mode="clip"):
    """Flat indices of coordinates in ``dims``, each coordinate clipped
    into range (the reference clips whatever ``mode`` says)."""
    coords = _seq(multi_index)
    flat = torch.zeros_like(coords[0])
    for c, d in zip(coords, dims):
        flat = flat * d + c.clamp(0, d - 1)
    return flat


def diag_indices(n, ndim=2, ctx=None, device=None):
    i = torch.arange(n, device=_device(ctx, device))
    return (i,) * ndim


def diag_indices_from(arr):
    a = _tt(arr)
    return diag_indices(a.shape[0], a.dim(), device=a.device)


def tril_indices(n, k=0, m=None, ctx=None, device=None):
    rc = torch.tril_indices(n, n if m is None else m, k,
                            device=_device(ctx, device))
    return rc[0], rc[1]


def triu_indices(n, k=0, m=None, ctx=None, device=None):
    rc = torch.triu_indices(n, n if m is None else m, k,
                            device=_device(ctx, device))
    return rc[0], rc[1]


def tril_indices_from(arr, k=0):
    return tril_indices(arr.shape[-2], k, arr.shape[-1], device=arr.device)


def triu_indices_from(arr, k=0):
    return triu_indices(arr.shape[-2], k, arr.shape[-1], device=arr.device)


def mask_indices(n, mask_func, k=0, ctx=None, device=None):
    """The (rows, cols) where ``mask_func(ones((n, n)), k)`` is nonzero
    (``mask_func`` takes a tensor, as this module's ``triu`` does)."""
    _host_sync("mask_indices")
    m = mask_func(torch.ones((n, n), dtype=torch.int64,
                             device=_device(ctx, device)), k)
    return tuple(torch.nonzero(m, as_tuple=True))


def ix_(*args):
    """Open-mesh index arrays: the i-th of ``args`` shaped to vary along
    axis i only (a boolean one is taken by its nonzero positions)."""
    outs = []
    n = len(args)
    for i, a in enumerate(args):
        t = _tt(a)
        if t.dtype == torch.bool:
            _host_sync("ix_")
            t = torch.nonzero(t).reshape(-1)
        shape = [1] * n
        shape[i] = t.numel()
        outs.append(t.reshape(shape))
    return tuple(outs)


# ---------------------------------------------------------------------------
# polynomials (coefficients highest power first)
# ---------------------------------------------------------------------------
def polyval(p, x):
    p = _inexact(_tt(p))
    x = _tt(x, p)
    dt = torch.result_type(p, _inexact(x))
    y = torch.zeros(x.shape, dtype=dt, device=x.device)
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


def _pad_front(a, n):
    return F.pad(a, (n - a.shape[0], 0)) if a.shape[0] < n else a


def polyadd(a1, a2):
    a, b = _promoted(a1, a2)
    n = builtins.max(a.shape[0], b.shape[0])
    return _pad_front(a, n) + _pad_front(b, n)


def polysub(a1, a2):
    a, b = _promoted(a1, a2)
    n = builtins.max(a.shape[0], b.shape[0])
    return _pad_front(a, n) - _pad_front(b, n)


def polymul(a1, a2):
    a, b = _promoted(a1, a2)
    return convolve(a, b)


def polyder(p, m=1):
    p = _inexact(_tt(p))
    n = p.shape[0] - 1
    if m > n:
        return p[:0]
    coeff = torch.ones(n - m + 1, dtype=p.dtype, device=p.device)
    powers = torch.arange(n, m - 1, -1, dtype=p.dtype, device=p.device)
    for j in range(m):
        coeff = coeff * (powers - j)
    return p[:n - m + 1] * coeff


def polyint(p, m=1, k=None):
    """The m-th antiderivative; ``k`` holds the m integration constants
    (0 by default) and joins the dtype promotion, as in the reference."""
    p = _inexact(_tt(p))
    if k is not None:
        kt = torch.as_tensor(k, device=p.device)
        p = p.to(torch.result_type(p, _inexact(kt.reshape(-1))))
        ks = torch.broadcast_to(kt.reshape(-1).to(p.dtype), (m,))
    else:
        ks = torch.zeros(m, dtype=p.dtype, device=p.device)
    for i in range(m):
        div = torch.arange(p.shape[0], 0, -1, dtype=p.dtype, device=p.device)
        p = torch.cat([p / div, ks[i:i + 1]])
    return p


def polydiv(u, v):
    """(quotient, remainder) of the long division, the remainder
    untrimmed, as ``jnp.polydiv`` gives them."""
    u, v = _promoted(_inexact(_tt(u)), _inexact(_tt(v, u)))
    m, n = u.shape[0] - 1, v.shape[0] - 1
    q = torch.zeros(builtins.max(m - n + 1, 1), dtype=u.dtype,
                    device=u.device)
    r = u.clone()
    for k in range(m - n + 1):
        d = r[k] / v[0]
        q[k] = d
        r[k:k + n + 1] = r[k:k + n + 1] - d * v
    return q, r


def poly(seq_of_zeros):
    """Coefficients of the monic polynomial with these roots (the
    eigenvalues of a square matrix)."""
    z = _tt(seq_of_zeros)
    if z.dim() == 2 and z.shape[0] == z.shape[1] and z.shape[0] > 0:
        z = torch.linalg.eigvals(_inexact(z))
    z = _inexact(z)
    a = torch.ones(1, dtype=z.dtype, device=z.device)
    for r in z:
        a = torch.cat([a, torch.zeros(1, dtype=z.dtype, device=z.device)]) \
            - torch.cat([torch.zeros(1, dtype=z.dtype, device=z.device),
                         a * r])
    if a.is_complex() and bool((torch.imag(a) == 0).all()):
        a = torch.real(a)
    return a


def roots(p):
    """The roots of ``p``: leading zeros stripped (read on the host), then
    the eigenvalues of the companion matrix; complex."""
    _host_sync("roots")
    p = _inexact(_tt(p))
    nz = torch.nonzero(p).reshape(-1).tolist()
    p = p[nz[0]:] if nz else p[:0]
    n = p.shape[0] - 1
    cdt = torch.complex128 if p.dtype == torch.float64 else torch.complex64
    if n < 1:
        return torch.zeros(0, dtype=cdt, device=p.device)
    comp = torch.diag(torch.ones(n - 1, dtype=p.dtype, device=p.device), -1)
    comp[0, :] = -p[1:] / p[0]
    return torch.linalg.eigvals(comp).to(cdt)


def polyfit(x, y, deg):
    """Least-squares polynomial coefficients (highest power first), as
    ``jnp.polyfit``: columns of the Vandermonde matrix scaled to unit
    norm, solved by SVD with rcond ``len(x) * eps``."""
    from .linalg import lstsq

    x, y = _promoted(_inexact(_tt(x)), _inexact(_tt(y, x)))
    lhs = vander(x, deg + 1)
    scale = torch.sqrt((lhs * lhs).sum(0))
    rcond = x.shape[0] * torch.finfo(x.dtype).eps
    c = lstsq(lhs / scale, y, rcond)[0]
    return c / scale.reshape((-1,) + (1,) * (c.dim() - 1))


def vander(x, N=None, increasing=False):
    x = _tt(x)
    n = x.shape[0] if N is None else N
    powers = torch.arange(n, device=x.device)
    if not increasing:
        powers = torch.flip(powers, (0,))
    return x[:, None] ** powers.to(x.dtype if x.is_floating_point()
                                   else torch.int64)[None, :]


def sort_complex(a):
    """Sorted by real part, then imaginary part; complex."""
    a = _tt(a)
    if not a.is_complex():
        a = a.to(torch.complex128 if _float_of(a.dtype) == torch.float64
                 or a.dtype == torch.float64 else torch.complex64)
    idx = lexsort([torch.imag(a), torch.real(a)])
    return torch.take_along_dim(a, idx, dim=-1)


# ---------------------------------------------------------------------------
# window functions (float64, numpy's formulas)
# ---------------------------------------------------------------------------
def _window(M, ctx, device, fn):
    dev = _device(ctx, device)
    if M < 1:
        return torch.zeros(0, dtype=torch.float64, device=dev)
    if M == 1:
        return torch.ones(1, dtype=torch.float64, device=dev)
    n = torch.arange(1 - M, M, 2, dtype=torch.float64, device=dev)
    return fn(n, M)


def bartlett(M, ctx=None, device=None):
    return _window(M, ctx, device, lambda n, M: torch.where(
        n <= 0, 1 + n / (M - 1), 1 - n / (M - 1)))


def blackman(M, ctx=None, device=None):
    return _window(M, ctx, device, lambda n, M: 0.42
                   + 0.5 * torch.cos(math.pi * n / (M - 1))
                   + 0.08 * torch.cos(2.0 * math.pi * n / (M - 1)))


def hamming(M, ctx=None, device=None):
    return _window(M, ctx, device, lambda n, M: 0.54
                   + 0.46 * torch.cos(math.pi * n / (M - 1)))


def hanning(M, ctx=None, device=None):
    return _window(M, ctx, device, lambda n, M: 0.5
                   + 0.5 * torch.cos(math.pi * n / (M - 1)))


def kaiser(M, beta, ctx=None, device=None):
    def fn(_, M):
        n = torch.arange(0, M, dtype=torch.float64, device=_.device)
        alpha = (M - 1) / 2.0
        return torch.i0(beta * torch.sqrt(1 - ((n - alpha) / alpha) ** 2)) \
            / torch.i0(torch.tensor(float(beta), dtype=torch.float64,
                                    device=_.device))

    return _window(M, ctx, device, fn)


# ---------------------------------------------------------------------------
# logic
# ---------------------------------------------------------------------------
def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _promoted(a, b)
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return builtins.bool(isclose(a, b, rtol, atol, equal_nan).all())


def array_equal(a1, a2, equal_nan=False):
    a, b = _tt(a1), _tt(a2, a1)
    if a.shape != b.shape:
        return False
    eq = a == b
    if equal_nan and a.is_floating_point():
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return builtins.bool(eq.all())


def array_equiv(a1, a2):
    a, b = _tt(a1), _tt(a2, a1)
    try:
        a, b = torch.broadcast_tensors(a, b)
    except RuntimeError:
        return False
    return builtins.bool((a == b).all())


def may_share_memory(a, b):
    """Whether two tensors are views of one storage. (The reference's
    arrays never alias and it always answers False; torch views do.)"""
    return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
        and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def shares_memory(a, b):
    """Whether two views of one storage overlap in the bytes they span."""
    if not may_share_memory(a, b):
        return False

    def span(t):
        lo = t.data_ptr()
        extent = builtins.sum((s - 1) * st for s, st in
                              zip(t.shape, t.stride()) if s > 0)
        return lo, lo + (extent + 1) * t.element_size()

    (a0, a1), (b0, b1) = span(a), span(b)
    return a.numel() > 0 and b.numel() > 0 and a0 < b1 and b0 < a1


# ---------------------------------------------------------------------------
# dtypes and promotion
# ---------------------------------------------------------------------------
def _np_dtype(dt):
    """numpy's dtype of a torch dtype, name or numpy dtype (bfloat16 has
    none in numpy and maps to float32's class for the tree questions)."""
    if isinstance(dt, torch.Tensor):
        dt = dt.dtype
    if isinstance(dt, torch.dtype):
        if dt == torch.bfloat16:
            return onp.dtype(onp.float32)
        return onp.dtype(str(dt).replace("torch.", ""))
    if isinstance(dt, type) and issubclass(dt, onp.generic) \
            and dt in (onp.floating, onp.integer, onp.signedinteger,
                       onp.unsignedinteger, onp.inexact,
                       onp.complexfloating, onp.number, onp.generic):
        return dt
    return onp.dtype(dt)


# JAX's type-promotion lattice (64-bit types on): each type's direct
# upper bounds; i*/f*/c* are Python ints, floats and complexes (weak)
_LATTICE = {
    "bool": ["i*"], "i*": ["uint8", "int8"], "uint8": ["int16", "uint16"],
    "uint16": ["int32", "uint32"], "uint32": ["int64", "uint64"],
    "uint64": ["f*"], "int8": ["int16"], "int16": ["int32"],
    "int32": ["int64"], "int64": ["f*"], "f*": ["bfloat16", "float16"],
    "bfloat16": ["float32"], "float16": ["float32"],
    "float32": ["float64"], "float64": ["c*"], "c*": ["complex64"],
    "complex64": ["complex128"], "complex128": [],
}
_WEAK = {"i*": "int64", "f*": "float64", "c*": "complex128"}


def _upper(node):
    seen, todo = {node}, [node]
    while todo:
        for nxt in _LATTICE[todo.pop()]:
            if nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
    return seen


def _node(x):
    if isinstance(x, builtins.bool):
        return "bool"
    if isinstance(x, int):
        return "i*"
    if isinstance(x, float):
        return "f*"
    if isinstance(x, complex):
        return "c*"
    if isinstance(x, torch.Tensor):
        x = x.dtype
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    return onp.dtype(x).name


def result_type(*arrays_and_dtypes):
    """The dtype the reference promotes these to (JAX's lattice with
    64-bit types on), as a ``torch.dtype``."""
    nodes = [_node(x) for x in arrays_and_dtypes]
    common = set.intersection(*[_upper(n) for n in nodes])
    least = next(n for n in common if _upper(n) >= common)
    return dtype_from_any(_WEAK.get(least, least))


def promote_types(type1, type2):
    return result_type(dtype_from_any(type1), dtype_from_any(type2))


def can_cast(from_, to):
    f = from_.dtype if isinstance(from_, torch.Tensor) else from_
    return builtins.bool(onp.can_cast(_np_dtype(f), _np_dtype(to)))


def issubdtype(arg1, arg2):
    a = arg1 if isinstance(arg1, type) and issubclass(arg1, onp.generic) \
        else _np_dtype(arg1)
    b = arg2 if isinstance(arg2, type) and issubclass(arg2, onp.generic) \
        else _np_dtype(arg2)
    if arg1 == torch.bfloat16:
        return b in (onp.floating, onp.inexact, onp.number, onp.generic) \
            or arg2 == torch.bfloat16
    return builtins.bool(onp.issubdtype(a, b))


_KINDS = {
    "bool": lambda d: d == torch.bool,
    "signed integer": lambda d: _is_int(d) and d.is_signed,
    "unsigned integer": lambda d: _is_int(d) and not d.is_signed,
    "integral": _is_int,
    "real floating": lambda d: d.is_floating_point,
    "complex floating": lambda d: d.is_complex,
    "numeric": lambda d: d != torch.bool,
}


def isdtype(dtype, kind):
    """The array API's dtype query: ``kind`` a dtype, a kind name or a
    tuple of them."""
    dt = dtype_from_any(dtype)
    kinds = kind if isinstance(kind, tuple) else (kind,)
    return builtins.any(_KINDS[k](dt) if isinstance(k, str)
                        else dt == dtype_from_any(k) for k in kinds)


def finfo(dtype):
    return torch.finfo(dtype.dtype if isinstance(dtype, torch.Tensor)
                       else dtype_from_any(dtype))


def iinfo(dtype):
    return torch.iinfo(dtype.dtype if isinstance(dtype, torch.Tensor)
                       else dtype_from_any(dtype))


# ---------------------------------------------------------------------------
# printing, IO and the rest
# ---------------------------------------------------------------------------
def array_repr(arr, *args, **kwargs):
    return onp.array_repr(_host(arr), *args, **kwargs)


def array_str(arr, *args, **kwargs):
    return onp.array_str(_host(arr), *args, **kwargs)


def save(file, arr):
    """numpy's ``.npy`` of ``arr`` (host copy); either package's file
    loads in the other."""
    onp.save(file, _host(arr))


def savez(file, *args, **kwargs):
    onp.savez(file, *[_host(a) for a in args],
              **{k: _host(v) for k, v in kwargs.items()})


def load(file, ctx=None, device=None, **kwargs):
    """An ``.npy`` file as a tensor on ``device`` (``gpu(0)`` by
    default); an ``.npz`` archive as numpy's lazy dict of host arrays,
    as the reference returns it."""
    out = onp.load(file, **kwargs)
    if isinstance(out, onp.ndarray):
        return _back(out, device=device if device is not None else ctx)
    return out


def get_include():
    return onp.get_include()


def vectorize(pyfunc, excluded=None, signature=None):
    """``pyfunc`` mapped over the broadcast loop axes of its arguments by
    ``torch.vmap`` (it must be written in torch ops); ``signature`` names
    the core axes, e.g. ``"(n),(n)->()"``."""
    excluded = set(excluded or ())
    core = None
    if signature is not None:
        ins = signature.split("->")[0]
        core = [len([d for d in part.strip("()").split(",") if d.strip()])
                for part in ins.replace(" ", "").split("),(")]

    def wrapped(*args):
        pos = [i for i in range(len(args)) if i not in excluded]
        ts = [_tt(args[i]) for i in pos]
        ncore = core or [0] * len(ts)
        loops = torch.broadcast_shapes(*[t.shape[:t.dim() - c]
                                         for t, c in zip(ts, ncore)])
        ts = [torch.broadcast_to(t, tuple(loops) + tuple(
            t.shape[t.dim() - c:])).reshape((-1,) + tuple(
                t.shape[t.dim() - c:])) for t, c in zip(ts, ncore)]

        def one(*vals):
            full = list(args)
            for i, v in zip(pos, vals):
                full[i] = v
            return pyfunc(*full)

        out = torch.vmap(one)(*ts) if ts and math.prod(loops) else one(*ts)
        return out.reshape(tuple(loops) + tuple(out.shape[1:]))

    return wrapped


def apply_along_axis(func1d, axis, arr, *args, **kwargs):
    """``func1d`` over each 1-D slice along ``axis``, by ``torch.vmap``
    (``func1d`` must be written in torch ops)."""
    a = _tt(arr)
    x = torch.movedim(a, axis, -1)
    lead = x.shape[:-1]
    out = torch.vmap(lambda v: _tt(func1d(v, *args, **kwargs), v))(
        x.reshape(-1, x.shape[-1]))
    out = out.reshape(tuple(lead) + tuple(out.shape[1:]))
    if out.dim() > len(lead):
        out = torch.movedim(out, -1, axis % a.dim())
    return out


def packbits(a, axis=None, bitorder="big"):
    """Bits of ``a != 0`` packed eight to a uint8 along ``axis`` (of the
    flattened array when None), zero-padded at the end."""
    a = _tt(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    bits = torch.movedim((a != 0).to(torch.uint8), axis, -1)
    n = bits.shape[-1]
    bits = F.pad(bits, (0, (-n) % 8))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=a.device)
    if bitorder == "little":
        weights = torch.flip(weights, (0,))
    packed = (bits.reshape(bits.shape[:-1] + (-1, 8)).to(torch.int32)
              * weights).sum(-1).to(torch.uint8)
    return torch.movedim(packed, -1, axis)


def unpackbits(a, axis=None, count=None, bitorder="big"):
    a = _tt(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    x = torch.movedim(a, axis, -1).to(torch.int32)
    shifts = torch.arange(7, -1, -1, device=a.device)
    if bitorder == "little":
        shifts = torch.flip(shifts, (0,))
    bits = ((x[..., None] >> shifts) & 1).to(torch.uint8)
    bits = bits.reshape(bits.shape[:-2] + (-1,))
    if count is not None:
        bits = bits[..., :count]
    return torch.movedim(bits, -1, axis)


from . import fft, linalg  # noqa: E402,F401  (need this module's helpers)

__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("annotations", "builtins", "functools", "math",
                         "onp", "torch",
                         "F", "dtype_from_any", "resolve_device",
                         "from_numpy", "asnumpy", "drop_index",
                         "MXNetError")]
