"""Gluon utilities of the PyTorch port (the port's own copy of
``mxnet_tpu/gluon/utils.py``): ``split_and_load``, the data-parallel
batch splitter over a device list, ``clip_global_norm`` and the
download helpers. ``download`` copies ``file://`` URLs and keeps files
already present; any other URL raises, as in the reference: nothing is
fetched over a network."""
from __future__ import annotations

import hashlib
import os
import shutil
import warnings
from typing import List, Optional, Sequence

import numpy as onp
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice: int, batch_axis: int = 0,
               even_split: bool = True):
    """``num_slice`` views of ``data`` along ``batch_axis``; the last takes
    the remainder when ``even_split`` is False."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"batch size {size} not divisible by {num_slice} slices; "
            "set even_split=False")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        lo = i * step
        hi = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * data.dim()
        idx[batch_axis] = slice(lo, hi)
        slices.append(data[tuple(idx)])
    return slices


def _as_tensor(data):
    if isinstance(data, torch.Tensor):
        return data
    a = onp.asarray(data)
    if a.dtype == onp.float64:
        a = a.astype(onp.float32)
    return torch.from_numpy(onp.ascontiguousarray(a))


def split_and_load(data, ctx_list: Sequence, batch_axis: int = 0,
                   even_split: bool = True):
    """Split a batch across devices: one slice per entry of ``ctx_list``
    (contexts or device strings), each moved to its device. Host data
    (numpy, float64 as float32) is split on the host."""
    data = _as_tensor(data)
    devs = [resolve_device(c) for c in ctx_list]
    if len(devs) == 1:
        return [data.to(devs[0])]
    slices = split_data(data, len(devs), batch_axis, even_split)
    return [s.to(d) for s, d in zip(slices, devs)]


def clip_global_norm(arrays: List[torch.Tensor], max_norm: float,
                     check_isfinite: bool = True):
    """Scale ``arrays`` in place so their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (a float, one host
    read). A non-finite norm warns and clips nothing when
    ``check_isfinite``."""
    if not arrays:
        raise MXNetError("arrays must not be empty")
    dev = arrays[0].device
    sq = torch.stack([torch.sum(torch.square(a.detach().float())).to(dev)
                      for a in arrays])
    total_norm = float(torch.sqrt(sq.sum()))
    if check_isfinite and not onp.isfinite(total_norm):
        warnings.warn("nan or inf in gradients, no clipping applied")
        return total_norm
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for a in arrays:
                a.mul_(scale)
    return total_norm


def check_sha1(filename: str, sha1_hash: str) -> bool:
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url: str, path: Optional[str] = None, overwrite: bool = False,
             sha1_hash: Optional[str] = None, retries: int = 5,
             verify_ssl: bool = True):
    """The file at ``path`` (or the URL's last component): kept when it
    exists, copied from a ``file://`` URL, else :class:`MXNetError`."""
    fname = path or url.split("/")[-1]
    if os.path.isdir(fname):
        fname = os.path.join(fname, url.split("/")[-1])
    if os.path.exists(fname) and not overwrite:
        return fname
    if url.startswith("file://"):
        shutil.copyfile(url[7:], fname)
        return fname
    raise MXNetError(
        f"cannot download {url}: the port fetches nothing over a network; "
        "place the file at the target path instead")
