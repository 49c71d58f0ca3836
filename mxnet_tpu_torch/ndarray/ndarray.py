"""The array of the PyTorch port (counterpart of
``mxnet_tpu/ndarray/ndarray.py``).

The port's array is ``torch.Tensor`` itself: no wrapper class and no
``__torch_function__`` subclass, which would cost Python time on every
op and stand between a tensor and the ``data_ptr()`` the kernels take.
``ndarray`` below is ``torch.Tensor``, for ``isinstance``. The
reference's MXNet-only methods are functions here:

- :func:`asnumpy` (bfloat16 widens exactly to float32, as
  ``convert.to_jax_params`` does);
- :func:`attach_grad` — ``x.attach_grad()`` is written ``attach_grad(x)``
  (or ``x.requires_grad_()``, which keeps torch's accumulating
  gradients);
- :func:`as_in_ctx` / :func:`copyto` to move data between devices;
- :func:`wait_to_read` and :func:`waitall`, which synchronise the
  stream (PyTorch, like the reference's engine, runs the card
  asynchronously).

``grad_req`` ("write", "add", "null") is kept on the tensor as
``_mx_grad_req``; :func:`~mxnet_tpu_torch.autograd.backward` reads it to
overwrite a "write" gradient where torch would add to it.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["ndarray", "NDArray", "from_numpy", "asnumpy", "attach_grad",
           "as_in_ctx", "as_in_context", "copyto",
           "wait_to_read", "waitall"]

ndarray = NDArray = torch.Tensor

GRAD_REQS = ("write", "add", "null")


def from_numpy(arr) -> torch.Tensor:
    """A CPU tensor sharing ``arr``'s memory (a copy for bfloat16 arrays
    of ml_dtypes, which torch cannot view)."""
    arr = onp.asarray(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(onp.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def asnumpy(x: torch.Tensor) -> onp.ndarray:
    """A host numpy copy of ``x`` (bfloat16 widens exactly to float32)."""
    t = x.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


def to_numpy(x) -> onp.ndarray:
    """``x`` as host numpy: a tensor's :func:`asnumpy` copy, anything
    else through ``numpy.asarray``."""
    return asnumpy(x) if isinstance(x, torch.Tensor) else onp.asarray(x)


def attach_grad(x: torch.Tensor, grad_req: str = "write") -> torch.Tensor:
    """``x.attach_grad(grad_req)`` of the reference: ``x`` (a leaf)
    records gradients into ``x.grad``, which starts at zeros. "write"
    makes each :func:`~mxnet_tpu_torch.autograd.backward` that reaches
    ``x`` overwrite ``x.grad``; "add" accumulates, as torch does; "null"
    detaches ``x`` from autograd."""
    if grad_req not in GRAD_REQS:
        raise MXNetError(f"grad_req must be one of {GRAD_REQS}, "
                         f"got {grad_req!r}")
    if x.grad_fn is not None:
        raise MXNetError("attach_grad needs a leaf tensor; call it on "
                         "x.detach()")
    x.requires_grad_(grad_req != "null")
    x._mx_grad_req = grad_req
    x.grad = None if grad_req == "null" else torch.zeros_like(x)
    return x


def as_in_ctx(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device`` (``x`` itself when it is there already)."""
    return x.to(resolve_device(device))


as_in_context = as_in_ctx


def copyto(x: torch.Tensor, other):
    """Copy ``x`` into the tensor ``other`` (returned), or to a new
    tensor on the device ``other``."""
    if isinstance(other, torch.Tensor):
        with torch.no_grad():
            other.copy_(x)
        return other
    return x.detach().to(resolve_device(other), copy=True)


def wait_to_read(x: torch.Tensor) -> torch.Tensor:
    """Block until the work that writes ``x`` has finished."""
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    return x


def waitall() -> None:
    """Block until all work queued on the card has finished."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
