"""K2 — fused LayerNorm forward (counterpart of
``mxnet_tpu/ops/pallas/layer_norm.py``).

Replaces ``_ln_kernel`` (``ops/pallas/layer_norm.py:32``, reached
through ``fused_layer_norm`` -> ``_run_norm``) with the hand-written
CUDA kernel in ``csrc/layer_norm.cu``: one block per row, f32 mean and
centred variance, writing ``y``, ``mean`` and ``rstd``. Bound on the
H100: bytes (one read and one write per element); at the decode shape
(8, 768) it is launch-bound. Every ``LayerNorm`` of gpt_like (``ln1``,
``ln2``, ``final_ln``) runs it: 2L+1 launches per forward step.

:func:`fused_layer_norm` launches the kernel for CUDA tensors and takes
:func:`layer_norm_plain` for CPU tensors. The backward belongs to the
training slice; the saved statistics are returned for it.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["fused_layer_norm", "layer_norm_plain"]


def _out_dtype(x, gamma, beta):
    return torch.promote_types(torch.promote_types(x.dtype, gamma.dtype),
                               beta.dtype)


def layer_norm_plain(x, gamma, beta, eps: float = 1e-5):
    """The plain PyTorch version: (N, D) -> (y, mean (N,), rstd (N,)),
    statistics in f32, ``y`` in ``result_type(x, gamma, beta)``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    cent = xf - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = cent * rstd * gamma.float() + beta.float()
    return y.to(_out_dtype(x, gamma, beta)), mean[:, 0], rstd[:, 0]


def fused_layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis of (N, D). Returns
    ``(y, mean, rstd)``. CUDA tensors: the K2 kernel (x, gamma and beta
    of one dtype, float32 or bfloat16, contiguous, D <= 8192)."""
    what = "fused_layer_norm"
    if _build.on_cpu(what, x, gamma, beta):
        return layer_norm_plain(x, gamma, beta, eps)
    _build.require(x.dim() == 2, what, f"x must be (N, D), got {tuple(x.shape)}")
    n, d = x.shape
    _build.require(1 <= d <= 8192, what, f"row width {d} not in [1, 8192]")
    _build.require(tuple(gamma.shape) == (d,) and tuple(beta.shape) == (d,),
                   what, "gamma and beta must be (D,)")
    _build.require(x.dtype == gamma.dtype == beta.dtype
                   and x.dtype in (torch.float32, torch.bfloat16), what,
                   f"dtypes {x.dtype}/{gamma.dtype}/{beta.dtype}: the kernel "
                   "takes one dtype, float32 or bfloat16")
    _build.require(x.is_contiguous() and gamma.is_contiguous()
                   and beta.is_contiguous(), what, "inputs must be contiguous")
    lib = _build.load("layer_norm")
    y = torch.empty_like(x)
    mean = torch.empty((n,), dtype=torch.float32, device=x.device)
    rstd = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mxt_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, d, float(eps),
            _build.dtype_code(x.dtype), _build.stream_ptr(x.device))
    _build.check(err, what)
    fused_layer_norm.launches += 1
    return y, mean, rstd


fused_layer_norm.launches = 0
