"""Carry parameters between the JAX package and the PyTorch port.

The port's modules use the reference's attribute names, so a model's
``state_dict()`` keys are exactly the reference's ``collect_params()``
names and layouts (``Dense.weight`` is (out, in) in both). Loading is a
checked ``load_state_dict``: names and shapes must cover the model
exactly. :func:`to_jax_params` goes the other way.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["from_jax_params", "to_jax_params"]


def _to_tensor(arr) -> torch.Tensor:
    arr = onp.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":    # ml_dtypes' numpy bfloat16
        return torch.from_numpy(arr.view(onp.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_jax_params(params: Mapping[str, "onp.ndarray"],
                    model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Load ``params`` (reference parameter name -> numpy array) into
    ``model``, converting each array to the model parameter's dtype and
    device. Raises :class:`MXNetError` when a name is missing or
    unexpected or a shape differs. Returns the loaded state dict."""
    want = model.state_dict()
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise MXNetError(f"parameter names do not match the model: "
                         f"missing {missing}, unexpected {extra}")
    state = {}
    for name, ref in want.items():
        src = _to_tensor(params[name])
        if tuple(src.shape) != tuple(ref.shape):
            raise MXNetError(f"{name}: shape {tuple(src.shape)} does not "
                             f"match the model's {tuple(ref.shape)}")
        state[name] = src.to(dtype=ref.dtype, device=ref.device)
    model.load_state_dict(state, strict=True)
    return model.state_dict()


def to_jax_params(model: torch.nn.Module) -> Dict[str, "onp.ndarray"]:
    """The reverse of :func:`from_jax_params`: reference parameter name ->
    numpy array on the host, in the parameter's dtype (bfloat16 widens
    exactly to float32, since numpy has no bfloat16 of its own)."""
    out = {}
    for name, t in model.state_dict().items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy().copy()
    return out
