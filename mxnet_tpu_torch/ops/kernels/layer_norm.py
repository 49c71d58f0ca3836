"""K2 — fused LayerNorm, and K2r — fused RMSNorm (counterpart of
``mxnet_tpu/ops/pallas/layer_norm.py``).

Replaces ``_ln_kernel`` (``ops/pallas/layer_norm.py:32``, reached
through ``fused_layer_norm`` -> ``_run_norm``) with hand-written CUDA in
``csrc/layer_norm.cu``: f32 mean and centred variance, writing ``y``,
``mean`` and ``rstd``. Bound on the H100: bytes (one read and one write
per element); at the decode shape (8, 768) it is launch-bound. Every
``LayerNorm`` of gpt_like (``ln1``, ``ln2``, ``final_ln``) runs it: 2L+1
launches per forward. Two kernels take K2, chosen by :func:`ln_route`
from the row's shape: ``ln_fwd_warp_kernel`` (one warp per row, the row
in registers as 16-byte vectors, two warp sums, no shared memory) for
rows of 16-byte multiples on 16-byte-aligned storage with D <= 1024,
and ``ln_fwd_kernel`` (one block per row) for every other row up to
D 8192. Either is a launch of K2 and adds one to ``.launches``.

:func:`fused_layer_norm` is a ``torch.autograd.Function`` on both
devices, as the reference's is a ``jax.custom_vjp``: its forward
launches the kernel for CUDA tensors (:func:`layer_norm_plain` for CPU
tensors) and saves ``x``, gamma, mean and rstd; its backward is the
plain PyTorch port of the reference's ``_ln_bwd`` (``:126``), which XLA
runs there too.

K2r replaces ``_rms_kernel`` (``:50``, reached through ``fused_rms_norm``
``:145`` -> ``_rms_fwd`` -> ``_run_norm``) with ``rms_fwd_kernel`` in the
same source: one block per row, ``ms = sum(x²)/D`` and ``rstd`` in f32,
``y = x·rstd·gamma`` in f32 rounded once to the input dtype, ``rstd``
written for the backward. Bound: bytes, as K2's (at (8192, 768) f32,
50.4 MB). :func:`fused_rms_norm` is an autograd Function in the same
way; its backward is the plain port of ``_rms_bwd`` (``:159``). Its
plain version rounds ``y`` once, as the kernel does; the reference's jnp
path (``ops.nn.rms_norm`` elsewhere) casts ``rstd`` to x's dtype first,
so in bfloat16 the two differ by up to one ulp.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["fused_layer_norm", "layer_norm_plain", "layer_norm_backward",
           "ln_route", "ln_launch",
           "fused_rms_norm", "rms_norm_plain", "rms_norm_backward"]


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


def layer_norm_backward(x, gamma, mean, rstd, g, beta_dtype):
    """``_ln_bwd`` of the reference: dx, dgamma and dbeta from the saved
    statistics, in f32, cast back to the inputs' dtypes."""
    xf = x.float()
    gf = g.float()
    xhat = (xf - mean[:, None]) * rstd[:, None]
    dy = gf * gamma.float()[None, :]
    m1 = dy.mean(dim=-1, keepdim=True)
    m2 = (dy * xhat).mean(dim=-1, keepdim=True)
    dx = ((dy - m1 - xhat * m2) * rstd[:, None]).to(x.dtype)
    dgamma = (gf * xhat).sum(dim=0).to(gamma.dtype)
    dbeta = gf.sum(dim=0).to(beta_dtype)
    return dx, dgamma, dbeta


LN_WARP_MAX_D = 1024


def ln_route(x, gamma, beta):
    """The K2 kernel that takes these rows: ``"warp"`` when D·itemsize is
    a multiple of 16, x, gamma and beta start on 16-byte boundaries and
    D <= 1024 (the output is a fresh allocation, always aligned);
    ``"block"`` otherwise."""
    d = x.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, gamma, beta))
    return ("warp" if aligned and d <= LN_WARP_MAX_D
            and (d * x.element_size()) % 16 == 0 else "block")


def ln_launch(lib, route, x, gamma, beta, eps, stream):
    """Launch one K2 kernel of ``lib`` by its C entry (``route`` as
    :func:`ln_route`); returns ``(y, mean, rstd)`` and the entry's error
    code."""
    n, d = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((n,), dtype=torch.float32, device=x.device)
    rstd = torch.empty((n,), dtype=torch.float32, device=x.device)
    entry = (lib.mxt_layer_norm_fwd_warp if route == "warp"
             else lib.mxt_layer_norm_fwd)
    err = entry(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, d,
                float(eps), _build.dtype_code(x.dtype), stream)
    return (y, mean, rstd), err


def _ln_forward(x, gamma, beta, eps):
    """The K2 launch (CUDA tensors) or its plain version (CPU tensors)."""
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
    with torch.cuda.device(x.device):
        out, err = ln_launch(lib, ln_route(x, gamma, beta), x, gamma, beta,
                             eps, _build.stream_ptr(x.device))
    _build.check(err, what)
    fused_layer_norm.launches += 1
    return out


class _LayerNorm(torch.autograd.Function):
    """K2 with the reference's ``_ln_bwd``. ``setup_context`` and
    ``vmap`` let ``torch.func`` transform it: a vmapped call folds the
    mapped axis into the rows (one launch); with a mapped gamma or beta
    it launches once per mapped entry."""

    @staticmethod
    def forward(x, gamma, beta, eps):
        return _ln_forward(x, gamma, beta, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, beta, _ = inputs
        _, mean, rstd = output
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.beta_dtype = beta.dtype
        ctx.mark_non_differentiable(mean, rstd)

    @staticmethod
    def vmap(info, in_dims, x, gamma, beta, eps):
        x, gamma, beta = _build.batch_first(info, in_dims[:3], x, gamma,
                                            beta)
        if in_dims[1] is None and in_dims[2] is None:
            b, n, d = x.shape
            y, mean, rstd = _LayerNorm.apply(x.reshape(b * n, d), gamma[0],
                                             beta[0], eps)
            return (y.reshape(b, n, d), mean.reshape(b, n),
                    rstd.reshape(b, n)), (0, 0, 0)
        outs = [_LayerNorm.apply(*row, eps) for row in zip(x, gamma, beta)]
        return tuple(torch.stack(t) for t in zip(*outs)), (0, 0, 0)

    @staticmethod
    def backward(ctx, gy, _gmean, _grstd):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_backward(x, gamma, mean, rstd, gy,
                                                ctx.beta_dtype)
        return dx, dgamma, dbeta, None


def fused_layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis of (N, D). Returns
    ``(y, mean, rstd)``; ``y`` is differentiable in x, gamma and beta.
    CUDA tensors: a K2 kernel, by :func:`ln_route` (x, gamma and beta of
    one dtype, float32 or bfloat16, contiguous, D <= 8192)."""
    return _LayerNorm.apply(x, gamma, beta, float(eps))


_build.counted(fused_layer_norm)


# ---------------------------------------------------------------------------
# K2r: RMSNorm
# ---------------------------------------------------------------------------
def rms_norm_plain(x, gamma, eps: float = 1e-6):
    """The plain PyTorch version: (N, D) -> (y, rstd (N,)), ``ms`` and
    ``rstd`` in f32, ``y = x·rstd·gamma`` in f32 cast once to
    ``result_type(x, gamma)`` (``_rms_kernel``'s arithmetic)."""
    xf = x.float()
    ms = (xf * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    rstd = torch.rsqrt(ms + eps)
    y = xf * rstd * gamma.float()
    return (y.to(torch.promote_types(x.dtype, gamma.dtype)), rstd[:, 0])


def rms_norm_backward(x, gamma, rstd, g):
    """``_rms_bwd`` of the reference: dx and dgamma from the saved rstd,
    in f32, cast back to the inputs' dtypes."""
    xf = x.float()
    gf = g.float()
    xhat = xf * rstd[:, None]
    dy = gf * gamma.float()[None, :]
    m2 = (dy * xhat).mean(dim=-1, keepdim=True)
    dx = ((dy - xhat * m2) * rstd[:, None]).to(x.dtype)
    dgamma = (gf * xhat).sum(dim=0).to(gamma.dtype)
    return dx, dgamma


def _rms_forward(x, gamma, eps):
    """The K2r launch (CUDA tensors) or its plain version (CPU tensors)."""
    what = "fused_rms_norm"
    if _build.on_cpu(what, x, gamma):
        return rms_norm_plain(x, gamma, eps)
    _build.require(x.dim() == 2, what, f"x must be (N, D), got {tuple(x.shape)}")
    n, d = x.shape
    _build.require(1 <= d <= 8192, what, f"row width {d} not in [1, 8192]")
    _build.require(tuple(gamma.shape) == (d,), what, "gamma must be (D,)")
    _build.require(x.dtype == gamma.dtype
                   and x.dtype in (torch.float32, torch.bfloat16), what,
                   f"dtypes {x.dtype}/{gamma.dtype}: the kernel takes one "
                   "dtype, float32 or bfloat16")
    _build.require(x.is_contiguous() and gamma.is_contiguous(), what,
                   "inputs must be contiguous")
    lib = _build.load("layer_norm")
    y = torch.empty_like(x)
    rstd = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mxt_rms_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), y.data_ptr(), rstd.data_ptr(),
            n, d, float(eps), _build.dtype_code(x.dtype),
            _build.stream_ptr(x.device))
    _build.check(err, what)
    fused_rms_norm.launches += 1
    return y, rstd


class _RMSNorm(torch.autograd.Function):
    """K2r with the reference's ``_rms_bwd``; ``torch.func`` rules as
    :class:`_LayerNorm`'s."""

    @staticmethod
    def forward(x, gamma, eps):
        return _rms_forward(x, gamma, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, _ = inputs
        ctx.save_for_backward(x, gamma, output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def vmap(info, in_dims, x, gamma, eps):
        x, gamma = _build.batch_first(info, in_dims[:2], x, gamma)
        if in_dims[1] is None:
            b, n, d = x.shape
            y, rstd = _RMSNorm.apply(x.reshape(b * n, d), gamma[0], eps)
            return (y.reshape(b, n, d), rstd.reshape(b, n)), (0, 0)
        outs = [_RMSNorm.apply(*row, eps) for row in zip(x, gamma)]
        return tuple(torch.stack(t) for t in zip(*outs)), (0, 0)

    @staticmethod
    def backward(ctx, gy, _grstd):
        x, gamma, rstd = ctx.saved_tensors
        dx, dgamma = rms_norm_backward(x, gamma, rstd, gy)
        return dx, dgamma, None


def fused_rms_norm(x, gamma, eps: float = 1e-6):
    """RMSNorm over the last axis of (N, D). Returns ``(y, rstd)``; ``y``
    is differentiable in x and gamma. CUDA tensors: the K2r kernel (x
    and gamma of one dtype, float32 or bfloat16, contiguous, D <= 8192)."""
    return _RMSNorm.apply(x, gamma, float(eps))


_build.counted(fused_rms_norm)
