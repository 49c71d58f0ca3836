"""Devices of the PyTorch port.

``gpu(i)`` and ``cpu()`` return ``torch.device``s. The default device
is ``gpu(0)``: an entry point given no device runs on the card, and on a
machine without one it raises instead of dropping to the CPU. The CPU
is only ever chosen by a caller that asks for it (``device="cpu"``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["gpu", "cpu", "default_device", "current_context",
           "current_device", "resolve_device"]


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def default_device() -> torch.device:
    return gpu(0)


current_context = current_device = default_device


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given (the
    first of a list, as the reference's ``ctx=[...]``), else ``gpu(0)``.
    A CUDA device on a machine without a usable card raises
    :class:`MXNetError`."""
    if isinstance(device, (list, tuple)):
        device = device[0] if device else None
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = gpu(torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise MXNetError(
                f"device {dev} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev} (cuda or cpu)")
    return dev
