"""The pretrained-weight store of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``), behind every zoo
builder's ``pretrained=True``.

The reference has no network, so its store does not download: it
generates untrained weights from a fixed seed and pins them by a sha256
over the names, dtypes, shapes and bytes of the written file
(``_MODEL_SHA256``). The port keeps that manifest, the cache under
``MXNET_HOME/models`` and the file names, so either package's cached
file serves the other. It generates the same bits without JAX: the
reference's initialization is replayed on the host, every
``init_array`` taking one key of a threefry stream seeded as the
reference's ``mx.np.random.seed(seed)`` seeds it, and ``Uniform``
drawing from that key with the port's numpy copy of ``jax.random``
(:func:`~mxnet_tpu_torch.initializer.threefry_keys`). Parameters whose
shapes are known draw at ``initialize()`` in ``collect_params()`` order,
the deferred ones at the first forward, on ``zeros(1, 3, 224, 224)``,
as the reference's do.

A readable file whose hash differs from the manifest is the user's
(converted trained weights): it is returned with a warning and never
deleted. An unreadable one is regenerated. Names outside the store
raise "no offline pretrained weights".
"""
from __future__ import annotations

import hashlib
import os
import warnings
import zipfile
from typing import Dict, Optional

import numpy as onp
import torch

from ...base import MXNetError

__all__ = ["get_model_file", "purge", "supported_models"]

# name -> generation seed (reference model_store.py:41-52)
_MODELS: Dict[str, int] = {
    "resnet18_v1": 1801,
    "mobilenetv2_1.0": 2010,
}
_MODEL_SHA256: Dict[str, str] = {
    "resnet18_v1":
        "ea95b572415710482807624d4fa76697f8fe04b8a968674b57d7ff3cf3ecabf3",
    "mobilenetv2_1.0":
        "c27d035be492f25e3a67526e3f6e51adf4073e64ab1b1fcf3e99ae233b303778",
}


def _root(root: Optional[str]) -> str:
    if root is None:
        home = os.environ.get(
            "MXNET_HOME", os.path.join(os.path.expanduser("~"), ".mxnet"))
        root = os.path.join(home, "models")
    os.makedirs(root, exist_ok=True)
    return root


def supported_models():
    """The names the store holds."""
    return sorted(_MODELS)


def _logical_sha256(params: Dict[str, onp.ndarray]) -> str:
    """sha256 over each name (sorted), numpy dtype string, shape string
    and raw bytes: independent of the container's metadata."""
    h = hashlib.sha256()
    for name in sorted(params):
        arr = onp.ascontiguousarray(params[name])
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _file_sha256(path: str) -> str:
    from ...serialization import load_params

    return _logical_sha256({k: v.numpy()
                            for k, v in load_params(path).items()})


def _build(name: str):
    from . import vision

    return {"resnet18_v1": vision.resnet18_v1,
            "mobilenetv2_1.0": vision.mobilenet_v2_1_0}[name]()


def _generate(name: str, path: str) -> str:
    """Write the named model's weights to ``path``, made on the host as
    the reference makes them, and return the logical sha256 of the file
    as re-read. The draws come from the key stream alone: the caller's
    numpy state and the port's generators are not touched."""
    from ... import initializer

    net = _build(name)
    with initializer.threefry_keys(_MODELS[name]):
        net.initialize(device="cpu", force_reinit=True)
        with torch.no_grad():
            net(torch.zeros((1, 3, 224, 224)))
    net.save_parameters(path)
    return _file_sha256(path)


def get_model_file(name: str, root: Optional[str] = None) -> str:
    """The path of the named model's ``.params`` file in the cache,
    generated (or repaired) as needed (reference
    ``model_store.get_model_file``, generation in place of download)."""
    if name not in _MODELS:
        raise MXNetError(
            f"no offline pretrained weights for {name!r}. This build ships "
            f"deterministic reference weights for {supported_models()} "
            "(see model_store.py docs); for other models use "
            "net.load_parameters(path) with your own .params file.")
    path = os.path.join(_root(root), f"{name}.params")
    want = _MODEL_SHA256[name]
    if os.path.exists(path):
        try:
            got = _file_sha256(path)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile,
                MXNetError):                  # unreadable: regenerate it
            os.remove(path)
        else:
            if got != want:
                warnings.warn(
                    f"{path} differs from the generated-weights manifest; "
                    f"treating it as user-supplied weights for {name!r}")
            return path
    got = _generate(name, path)
    if got != want:
        raise MXNetError(
            f"generated weights for {name!r} hash {got[:12]}... but the "
            f"manifest pins {want[:12]}...: the random stream or the model "
            "definition changed")
    return path


def _load_pretrained(net, name: str, root: Optional[str], device=None):
    """Load the store's weights for ``name`` into ``net`` on ``device``
    (default ``gpu(0)``): the builders' ``pretrained=True``."""
    from ...context import resolve_device

    device = resolve_device(device)
    net.load_parameters(get_model_file(name, root=root), device=device)
    return net


def purge(root: Optional[str] = None) -> None:
    """Delete every cached model file (reference model_store.purge)."""
    root = _root(root)
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
