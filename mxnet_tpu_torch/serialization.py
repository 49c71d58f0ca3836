"""Array serialization of the PyTorch port (``.params`` files; counterpart
of ``mxnet_tpu/serialization.py``).

The same container as the reference, byte for byte: a numpy ``.npz``
whose members are ``arr_0``, ``arr_1``, ... and a ``__manifest__`` entry,
the JSON of ``{"arr_i": {"name": ..., "dtype": ...}}`` as uint8 bytes.
bfloat16 arrays are stored as their uint16 bits with the dtype tag
"bfloat16", so round trips are exact. A file written by either package
loads in the other.
"""
from __future__ import annotations

import json
from typing import Dict

import numpy as onp
import torch

from .base import MXNetError, dtype_name

__all__ = ["save_params", "load_params"]


def _encode(arr):
    """(numpy array, dtype tag) of a tensor or array."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(onp.uint16), "bfloat16"
        return t.numpy(), dtype_name(t.dtype)
    arr = onp.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return arr.view(onp.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _decode(arr: onp.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(onp.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(onp.asarray(arr, order="C"))


def save_params(fname: str, arrays: Dict[str, object]) -> None:
    """Write ``arrays`` (name -> tensor or numpy array) to ``fname``."""
    payload = {}
    manifest = {}
    for i, (name, arr) in enumerate(arrays.items()):
        enc, dt = _encode(arr)
        payload[f"arr_{i}"] = enc
        manifest[f"arr_{i}"] = {"name": name, "dtype": dt}
    payload["__manifest__"] = onp.frombuffer(
        json.dumps(manifest).encode(), dtype=onp.uint8)
    with open(fname, "wb") as f:
        onp.savez(f, **payload)


def load_params(fname: str) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor of a ``.params`` file."""
    with onp.load(fname, allow_pickle=False) as z:
        if "__manifest__" not in z:
            raise MXNetError(f"{fname} is not a mxnet_tpu .params file")
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        return {meta["name"]: _decode(z[key], meta["dtype"])
                for key, meta in manifest.items()}
