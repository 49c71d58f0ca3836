"""Carry parameters between the JAX package and the PyTorch port.

The port's blocks use the reference's attribute names, so a model's
:meth:`~.gluon.block.Block.collect_params` names (and ``state_dict()``
keys) are exactly the reference's ``collect_params()`` names, with the
same layouts (``Dense.weight`` is (out, in) in both). Loading is checked:
names must cover the model exactly, and every shape the model knows must
match. A deferred parameter (shape not yet known, or not initialized)
takes the array's shape and is made on the model's device.
:func:`to_jax_params` goes the other way, for every parameter whose data
exists.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as onp
import torch

from .base import MXNetError
from .gluon.block import Block
from .ndarray.ndarray import asnumpy, from_numpy

__all__ = ["from_jax_params", "to_jax_params"]


def _params(model: torch.nn.Module):
    """name -> Gluon Parameter of a Block; name -> tensor of any other
    module."""
    if isinstance(model, Block):
        return model.collect_params()
    return dict(model.named_parameters())


def _device(params):
    for p in params.values():
        if isinstance(p, torch.Tensor):
            return p.device
        if p.initialized:
            return p.data().device
    return None


def from_jax_params(params: Mapping[str, "onp.ndarray"],
                    model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Load ``params`` (reference parameter name -> numpy array) into
    ``model``, converting each array to the model parameter's dtype and
    device. Raises :class:`MXNetError` when a name is missing or
    unexpected or a known shape differs. Returns the loaded state dict."""
    want = _params(model)
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise MXNetError(f"parameter names do not match the model: "
                         f"missing {missing}, unexpected {extra}")
    device = _device(want)
    srcs = {name: from_numpy(params[name]) for name in want}
    for name, p in want.items():
        shape = tuple(p.shape) if p.shape is not None else None
        if (shape is not None and all(s > 0 for s in shape)
                and tuple(srcs[name].shape) != shape):
            raise MXNetError(f"{name}: shape {tuple(srcs[name].shape)} does "
                             f"not match the model's {shape}")
    for name, p in want.items():
        if isinstance(p, torch.Tensor):
            with torch.no_grad():
                p.copy_(srcs[name])
        else:
            p.set_data(srcs[name], device=None if p.initialized else device)
    return model.state_dict()


def to_jax_params(model: torch.nn.Module) -> Dict[str, "onp.ndarray"]:
    """The reverse of :func:`from_jax_params`: reference parameter name ->
    numpy array on the host, in the parameter's dtype (bfloat16 widens
    exactly to float32, since numpy has no bfloat16 of its own).
    Parameters without data yet are left out."""
    out = {}
    for name, p in _params(model).items():
        if isinstance(p, torch.Tensor):
            out[name] = asnumpy(p)
        elif p.initialized:
            out[name] = asnumpy(p.data())
    return out
