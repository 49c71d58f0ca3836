"""Carry parameters of the JAX package into the PyTorch port.

The port's modules use the reference's attribute names, so a model's
``state_dict()`` keys are exactly the reference's ``collect_params()``
names and layouts (``Dense.weight`` is (out, in) in both). Loading is a
checked ``load_state_dict``: names and shapes must cover the model
exactly.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["from_jax_params"]


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
