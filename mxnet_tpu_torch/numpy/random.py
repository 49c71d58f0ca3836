"""``mx.np.random`` of the PyTorch port (counterpart of
``mxnet_tpu/numpy/random.py``).

Draws come from one explicit ``torch.Generator`` per device
(:func:`~mxnet_tpu_torch.ops.nn.generator`), the one dropout and the
initializers draw from too; :func:`seed` reseeds all of them. Unseeded,
they start from seed 0, as the reference's key does. The reference's
threefry keys and torch's Philox never give the same numbers: compare
shapes, dtypes and moments, not values.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..base import dtype_from_any
from ..context import resolve_device
from ..ops.nn import generator, seed as _seed_all

__all__ = ["seed", "uniform", "normal", "randint"]


def seed(seed_state=None):
    """Reseed the generators of every device (a random seed when
    ``seed_state`` is None)."""
    if seed_state is None:
        seed_state = int.from_bytes(onp.random.bytes(4), "little")
    _seed_all(int(seed_state))


def _size(size, *params):
    if size is None:
        return torch.broadcast_shapes(*(torch.as_tensor(p).shape
                                        for p in params))
    return (size,) if isinstance(size, int) else tuple(size)


def _draw(fn, size, params, dtype, ctx, device, out):
    dev = resolve_device(device if device is not None else ctx)
    shape = _size(size, *params)
    params = [p.to(dev) if isinstance(p, torch.Tensor) else p
              for p in params]
    res = fn(shape, generator(dev), dev, *params)
    if dtype is not None:
        res = res.to(dtype_from_any(dtype))
    if out is not None:
        with torch.no_grad():
            out.copy_(res)
        return out
    return res


def uniform(low=0.0, high=1.0, size=None, dtype="float32", ctx=None,
            device=None, out=None):
    """Samples of U[low, high), drawn in float32."""
    return _draw(lambda shp, g, dev, lo, hi: torch.rand(
        shp, generator=g, device=dev) * (hi - lo) + lo,
        size, (low, high), dtype, ctx, device, out)


def normal(loc=0.0, scale=1.0, size=None, dtype="float32", ctx=None,
           device=None, out=None):
    """Samples of N(loc, scale²), drawn in float32."""
    return _draw(lambda shp, g, dev, mu, sd: torch.randn(
        shp, generator=g, device=dev) * sd + mu,
        size, (loc, scale), dtype, ctx, device, out)


def randint(low, high=None, size=None, dtype="int64", ctx=None, device=None,
            out=None):
    """Integers in [low, high) (in [0, low) when ``high`` is None)."""
    if high is None:
        low, high = 0, low
    shape = () if size is None else size
    return _draw(lambda shp, g, dev: torch.randint(
        low, high, shp, generator=g, device=dev),
        shape, (), dtype, ctx, device, out)
