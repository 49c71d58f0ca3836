"""Devices of the PyTorch port (counterpart of ``mxnet_tpu/context.py``).

``gpu(i)``, ``cpu()`` and ``Context(...)`` return a :class:`Context`.
``torch.device`` cannot be subclassed, so a ``Context`` is a ``str``
holding torch's spelling of the device (``"cuda:0"``, ``"cpu"``): every
torch call that takes ``device=`` takes it as it is, and
``torch.device(ctx)`` gives the torch device. It compares and hashes
as that string; its ``repr`` is the reference's ``gpu(0)``.

The default device is ``gpu(0)``: an entry point given no device runs on
the card, and on a machine without one it raises instead of dropping to
the CPU. The CPU is only ever chosen by a caller that asks for it: with
``device="cpu"``, or inside ``with mx.cpu():``. A ``Context`` is a scope,
as the reference's is (``mxnet_tpu/context.py:95``): scopes nest, are
per thread, and :func:`resolve_device` reads the innermost one wherever
an entry point is given no device.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Union

import torch

from .base import MXNetError

__all__ = ["Context", "Device", "device", "gpu", "cpu", "cpu_pinned",
           "num_gpus", "ctx_list", "default_device", "current_context",
           "current_device", "resolve_device"]


class Context(str):
    """A device: ``Context("gpu", 0)`` is ``cuda:0``, ``Context("cpu")``
    the host (``cpu_pinned`` and ``cpu_shared`` are the host too). Use it
    wherever torch takes a device, or as a scope: ``with mx.cpu():``
    makes the arrays and parameters of entry points given no device on
    the CPU."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {v: k for k, v in devtype2str.items()}
    _default_ctx = threading.local()

    def __new__(cls, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        elif isinstance(device_type, torch.device):
            device_type, device_id = (
                ("gpu", device_type.index or 0) if device_type.type == "cuda"
                else ("cpu", 0) if device_type.type == "cpu"
                else (device_type.type, 0))
        if device_type not in cls.devstr2type:
            raise MXNetError(f"unknown device type {device_type!r}")
        device_id = int(device_id)
        self = super().__new__(
            cls, f"cuda:{device_id}" if device_type == "gpu" else "cpu")
        self.device_type = device_type
        self.device_id = device_id
        return self

    def __reduce__(self):
        return Context, (self.device_type, self.device_id)

    @property
    def device_typeid(self) -> int:
        return self.devstr2type[self.device_type]

    @property
    def type(self) -> str:
        """torch's device type, ``"cuda"`` or ``"cpu"``."""
        return "cuda" if self.device_type == "gpu" else "cpu"

    @property
    def index(self) -> Optional[int]:
        """torch's device index (None on the host, as torch's)."""
        return self.device_id if self.device_type == "gpu" else None

    def __eq__(self, other) -> bool:
        """Equal to what spells the same torch device: a Context or str
        by torch's spelling (``gpu(0) == "cuda:0"``), a torch.device as
        torch compares them."""
        if isinstance(other, torch.device):
            return torch.device(str.__str__(self)) == other
        return str.__eq__(self, other)

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = str.__hash__

    def __repr__(self) -> str:
        return f"{self.device_type}({self.device_id})"

    def __enter__(self) -> "Context":
        stack = getattr(Context._default_ctx, "stack", None)
        if stack is None:
            stack = Context._default_ctx.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        Context._default_ctx.stack.pop()

    @classmethod
    def default(cls) -> "Context":
        """The innermost scope of this thread, else ``gpu(0)``."""
        stack = getattr(cls._default_ctx, "stack", None)
        return stack[-1] if stack else cls("gpu", 0)


# mxnet 2.x renamed Context to Device; both names stay
Device = device = Context


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context("cpu_pinned", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def ctx_list(ctx) -> List[Context]:
    if isinstance(ctx, (str, torch.device)):
        return [ctx]
    return list(ctx)


def default_device() -> Context:
    """The device of an entry point given none: the innermost
    ``with <Context>:`` scope of this thread, else ``gpu(0)``."""
    return Context.default()


def current_context() -> Context:
    return default_device()


current_device = current_context


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given (the
    first of a list, as the reference's ``ctx=[...]``), else the
    innermost device scope, else ``gpu(0)``. A CUDA device on a machine
    without a usable card raises :class:`MXNetError`."""
    if isinstance(device, (list, tuple)):
        device = device[0] if device else None
    dev = torch.device(default_device() if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise MXNetError(
                f"device {dev} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev} (cuda or cpu)")
    return dev
