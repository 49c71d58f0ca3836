"""Weight initializers of the PyTorch port (counterpart of
``mxnet_tpu/initializer.py``).

:meth:`Initializer.init_array` keeps the reference's name rules exactly:
a name containing ``bias`` or ending in ``beta`` gets zeros, one ending
in ``gamma`` ones, running/moving means zeros and variances ones; any
other name goes to the initializer's own rule. Arrays are filled in
place. Random draws are taken in float32 from the port's generator of
the array's device (:func:`~mxnet_tpu_torch.ops.nn.generator`, reseeded
by ``mx.np.random.seed``), then cast to the array's dtype. Registered by
name, so ``init="xavier"`` resolves as in the reference.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError
from .ops.nn import generator

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "register", "create"]

_registry: dict = {}


def register(cls, name=None):
    """Register an initializer class under its lower-cased name."""
    _registry[(name or cls.__name__).lower()] = cls
    return cls


def create(init=None, **kwargs) -> "Initializer":
    """An initializer from an instance, a registered name, or None
    (``Uniform(0.07)``, the reference's default)."""
    if init is None:
        return Uniform(0.07)
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        cls = _registry.get(init.lower())
        if cls is None:
            raise MXNetError(f"unknown initializer {init!r}; registered: "
                             f"{sorted(_registry)}")
        return cls(**kwargs)
    raise MXNetError(f"cannot create initializer from {init!r}")


def _uniform(arr, low, high, shape=None):
    shape = tuple(arr.shape) if shape is None else shape
    return torch.rand(shape, generator=generator(arr.device),
                      device=arr.device) * (high - low) + low


def _normal(arr, sigma, shape=None):
    shape = tuple(arr.shape) if shape is None else shape
    return torch.randn(shape, generator=generator(arr.device),
                       device=arr.device) * sigma


class Initializer:
    """Base initializer; subclasses implement ``_init_weight``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def init_array(self, name: str, arr: torch.Tensor) -> None:
        """Fill ``arr`` in place by the name rules, else by
        ``_init_weight``."""
        with torch.no_grad():
            if "bias" in name or name.endswith("beta"):
                arr.zero_()
            elif name.endswith("gamma"):
                arr.fill_(1)
            elif "running_mean" in name or "moving_mean" in name:
                arr.zero_()
            elif "running_var" in name or "moving_var" in name:
                arr.fill_(1)
            else:
                self._init_weight(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr.zero_()


class One(Initializer):
    def _init_weight(self, name, arr):
        arr.fill_(1)


class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        if isinstance(self.value, torch.Tensor):
            arr.copy_(self.value)
        else:
            arr.fill_(self.value)


class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr.copy_(_uniform(arr, -self.scale, self.scale))


class Normal(Initializer):
    """N(0, sigma²)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr.copy_(_normal(arr, self.sigma))


class Orthogonal(Initializer):
    """scale · an orthonormal basis from the SVD of a random
    (out, prod(rest)) matrix."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:]) if arr.dim() > 1 else 1
        tmp = (_uniform(arr, -1.0, 1.0, (nout, nin))
               if self.rand_type == "uniform"
               else _normal(arr, 1.0, (nout, nin)))
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        arr.copy_(self.scale * q.reshape(arr.shape))


class Xavier(Initializer):
    """reference initializer.py Xavier: scale = sqrt(magnitude / factor),
    factor the average, fan-in or fan-out (times the receptive field)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise MXNetError(f"Xavier requires ndim>=2, got shape {shape} "
                             f"for {name}")
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise MXNetError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.copy_(_uniform(arr, -scale, scale))
        elif self.rnd_type == "gaussian":
            arr.copy_(_normal(arr, scale))
        else:
            raise MXNetError("Unknown random type")


class MSRAPrelu(Xavier):
    """He initialization (reference initializer.py MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


for _cls in (Zero, One, Constant, Uniform, Normal, Orthogonal, Xavier,
             MSRAPrelu):
    register(_cls)
register(Zero, "zeros")
register(One, "ones")
