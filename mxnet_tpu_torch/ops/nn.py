"""Neural-network operators of the PyTorch port (counterpart of
``mxnet_tpu/ops/nn.py``), limited to what the serving, training
and ResNet paths run.

Convolution, pooling and BatchNorm have no kernel of the port's own: the
reference leaves them to XLA (no Pallas kernel reaches them), and the
port leaves the convolutions to cuDNN (``F.conv*``, which follow the
matmul precision policy of :mod:`~mxnet_tpu_torch.base`). Where torch's
pooling or BatchNorm computes something else than the reference (the
window of ``ceil_mode``, an average's divisor, the running variance),
the reference's arithmetic is written out in torch.

Kernel dispatch: :func:`layer_norm`, :func:`rms_norm`, :func:`attend`,
:func:`softmax_cross_entropy`, :func:`paged_attention` and
:func:`paged_attention_multi` hand their
tensors to the hand-written kernels' wrappers (:mod:`.kernels`), and a
wrapper launches its CUDA kernel for a CUDA tensor and takes its plain
PyTorch version for a CPU tensor. Inside a :class:`no_kernels` scope
every site takes the plain path instead, whatever the device — that is
how a run holds the kernels against the plain arithmetic on the card.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import numpy as onp
import torch
import torch.nn.functional as F

__all__ = ["fully_connected", "activation", "embedding", "convolution",
           "deconvolution", "pooling", "adaptive_avg_pool2d", "batch_norm",
           "layer_norm", "rms_norm", "group_norm", "instance_norm",
           "l2_normalization", "leaky_relu", "dropout", "generator",
           "dropout_generator", "seed", "using_generator", "attend",
           "softmax", "log_softmax", "pick", "softmax_cross_entropy",
           "kv_cache_quantize", "kv_cache_dequantize", "paged_write",
           "paged_attention", "paged_attention_multi", "no_kernels",
           "kernels_enabled"]


def fully_connected(x, weight, bias=None, num_hidden=None, flatten=True,
                    no_bias=False):
    """y = x @ W^T + b, W is (out, in) (reference fully_connected.cc)."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    y = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        y = y + bias
    return y


def activation(x, act_type="relu"):
    """reference src/operator/nn/activation.cc; ``gelu`` is the erf
    form, ``gelu_tanh`` the tanh approximation."""
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return F.softplus(x)
    if act_type == "softsign":
        return F.softsign(x)
    if act_type == "log_sigmoid":
        return F.logsigmoid(x)
    if act_type == "mish":
        return x * torch.tanh(F.softplus(x))
    if act_type in ("silu", "swish"):
        return F.silu(x)
    if act_type == "gelu":
        return F.gelu(x, approximate="none")
    if act_type == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {act_type}")


def embedding(indices, weight):
    """Row gather (reference indexing_op.cc Embedding). Indices must be
    in range: on a CUDA tensor an out-of-range index is a device-side
    assert, so callers bound token ids on the host."""
    return weight[indices.long()]


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------
_CHANNELS_FIRST = ("NCW", "NCHW", "NCDHW")
_CHANNELS_LAST = ("NWC", "NHWC", "NDHWC")


def _tuple(v, n):
    """The reference's ``_tuple``: an int repeated ``n`` times, or a
    sequence padded with its last entry."""
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(a) for a in v)
    return t if len(t) == n else t + (t[-1],) * (n - len(t))


def _channels_last(layout):
    if layout in _CHANNELS_FIRST:
        return False
    if layout in _CHANNELS_LAST:
        return True
    raise ValueError(f"unsupported layout {layout}")


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def convolution(x, weight, bias=None, kernel=None, stride=1, dilate=1,
                pad=0, num_group=1, layout="NCHW"):
    """N-D convolution (``mxnet_tpu/ops/nn.py:187``; reference
    src/operator/nn/convolution.cc). 1-, 2- or 3-D by ``x.dim() - 2``.
    For NCW/NCHW/NCDHW input the weight is (out, in / groups, *kernel),
    torch's own layout; for NWC/NHWC/NDHWC input it is (out, *kernel,
    in / groups), as the reference's dimension numbers say, and the
    output is channels-last too. The reference's space-to-depth rewrite
    of the stem (``_stem_space_to_depth``) computes the same taps and is
    a TPU layout trick; cuDNN picks its own algorithm, so it is not
    ported."""
    ndim = x.dim() - 2
    last = _channels_last(layout)
    if last:
        x = torch.movedim(x, -1, 1)
        weight = torch.movedim(weight, -1, 1)
    y = _CONV[ndim](x, weight, None, _tuple(stride, ndim),
                    _tuple(pad, ndim), _tuple(dilate, ndim), num_group)
    if bias is not None:
        y = y + bias.reshape((1, -1) + (1,) * ndim)
    return torch.movedim(y, 1, -1) if last else y


def deconvolution(x, weight, bias=None, stride=1, dilate=1, pad=0, adj=0,
                  num_group=1, layout="NCHW"):
    """Transposed convolution (``mxnet_tpu/ops/nn.py:243``; reference
    src/operator/nn/deconvolution.cc): the weight is (in, out / groups,
    *kernel), torch's ``conv_transpose`` layout, and ``adj`` adds to the
    high side of the output (torch's ``output_padding``, which must be
    smaller than the stride or the dilation). Channels-first layouts
    only, as the reference's."""
    ndim = x.dim() - 2
    if _channels_last(layout):
        raise ValueError(f"deconvolution takes a channels-first layout, "
                         f"not {layout}")
    y = _CONV_T[ndim](x, weight, None, _tuple(stride, ndim),
                      _tuple(pad, ndim), _tuple(adj, ndim), num_group,
                      _tuple(dilate, ndim))
    if bias is not None:
        y = y + bias.reshape((1, -1) + (1,) * ndim)
    return y


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------
def _window_sum(xp, kernel, stride):
    """Sum over each whole window of the padded ``xp`` (no implicit
    padding, so every window is full): average pooling with divisor 1;
    1-D runs as 2-D over a unit axis."""
    if len(kernel) == 1:
        return F.avg_pool2d(xp.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(xp, kernel, stride, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def pooling(x, kernel=1, pool_type="max", stride=None, pad=0,
            global_pool=False, count_include_pad=True, layout="NCHW",
            ceil_mode=False):
    """Pooling (``mxnet_tpu/ops/nn.py:294``; reference
    src/operator/nn/pooling.cc): ``max``, ``avg``, ``sum`` and ``lp``
    (the square root of the sum of squares) over 1-, 2- or 3-D windows.

    The reference's arithmetic: the input is padded explicitly (with
    ``finfo.min`` for max, zeros otherwise) by ``pad`` on both sides and,
    under ``ceil_mode``, by ``extra`` more on the high side, so that the
    last partial window is kept; then each whole window of the padded
    tensor is reduced. So a window may start in the padding (torch's own
    ``ceil_mode`` drops it), and an average divides by the full window
    size, padding and extension included, unless ``count_include_pad``
    is False, when it divides by the input positions the window covers.
    A global pool reduces every spatial axis: max, ``lp``, and the mean
    for any other type (``sum`` too, as the reference)."""
    ndim = x.dim() - 2
    last = _channels_last(layout)
    if last:
        x = torch.movedim(x, -1, 1)
    sp = tuple(range(2, 2 + ndim))
    if global_pool:
        if pool_type == "max":
            out = x.amax(dim=sp, keepdim=True)
        elif pool_type == "lp":
            out = torch.sqrt(x.abs().square().sum(dim=sp, keepdim=True))
        else:
            out = x.mean(dim=sp, keepdim=True)
        return torch.movedim(out, 1, -1) if last else out
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError(f"unknown pool_type {pool_type}")
    kernel = _tuple(kernel, ndim)
    stride = _tuple(stride if stride is not None else kernel, ndim)
    pad = _tuple(pad, ndim)
    spatial = x.shape[2:]
    extra = (0,) * ndim
    if ceil_mode:
        extra = tuple(max(0, -(-(s + 2 * p - k) // st) * st + k
                          - (s + 2 * p))
                      for s, k, st, p in zip(spatial, kernel, stride, pad))
    # F.pad's widths run from the last axis to the first
    widths = [w for p, e in zip(pad[::-1], extra[::-1]) for w in (p, p + e)]
    if pool_type == "max":
        fill = (torch.finfo(x.dtype).min if x.dtype.is_floating_point
                else torch.iinfo(x.dtype).min)
        out = _MAX_POOL[ndim](F.pad(x, widths, value=fill), kernel, stride)
    elif pool_type == "lp":
        out = torch.sqrt(_window_sum(F.pad(x.abs().square(), widths),
                                     kernel, stride))
    else:
        out = _window_sum(F.pad(x, widths), kernel, stride)
        if pool_type == "avg":
            if count_include_pad:
                out = out / math.prod(kernel)
            else:
                ones = F.pad(torch.ones((1, 1) + tuple(spatial),
                                        dtype=x.dtype, device=x.device),
                             widths)
                out = out / _window_sum(ones, kernel, stride)
    return torch.movedim(out, 1, -1) if last else out


def adaptive_avg_pool2d(x, output_size):
    """``mxnet_tpu/ops/nn.py:440``: the mean over equal tiles of an
    (N, C, H, W) input, a reshape as in the reference, so the output size
    must divide H and W (``F.adaptive_avg_pool2d`` would take uneven
    windows instead)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    n, c, h, w = x.shape
    oh, ow = output_size
    if h % oh or w % ow:
        raise ValueError(f"adaptive_avg_pool2d: output size {output_size} "
                         f"does not divide the input's {(h, w)}")
    return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------
def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               training=True, axis=1):
    """BatchNorm (``mxnet_tpu/ops/nn.py:453``; reference
    src/operator/nn/batch_norm.cc). Returns ``(out, new_moving_mean,
    new_moving_var)`` and mutates nothing.

    The reference's arithmetic, which is not ``F.batch_norm``'s: in
    training (and without ``use_global_stats``) the batch mean and the
    **biased** variance over every axis but ``axis`` are taken in f32
    whatever x's dtype, and the statistics move as ``momentum · old +
    (1 − momentum) · batch`` (torch's momentum is the complement, and its
    running variance the unbiased one). Otherwise the moving statistics
    normalize and come back unchanged. ``rsqrt(var + eps)`` and the
    statistics are cast to x's dtype before they touch x; ``fix_gamma``
    takes gamma as ones."""
    axis = axis % x.dim()
    red = tuple(i for i in range(x.dim()) if i != axis)
    bshape = [1] * x.dim()
    bshape[axis] = x.shape[axis]
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    if training and not use_global_stats:
        var, mean = torch.var_mean(x.float(), dim=red, correction=0)
        new_mean = momentum * moving_mean + (1 - momentum) * mean
        new_var = momentum * moving_var + (1 - momentum) * var
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    inv = torch.rsqrt(var + eps).to(x.dtype)
    out = (x - mean.reshape(bshape).to(x.dtype)) * inv.reshape(bshape)
    out = (out * gamma.reshape(bshape).to(x.dtype)
           + beta.reshape(bshape).to(x.dtype))
    return out, new_mean, new_var


# ---------------------------------------------------------------------------
# randomness
# ---------------------------------------------------------------------------
# One torch.Generator per device, shared by dropout, mx.np.random and the
# initializers (JAX threefry keys have no torch counterpart; the two never
# draw the same bits).
_generators: dict = {}
_seed = [0]


def seed(value: int) -> None:
    """Reseed the generators of every device."""
    _seed[0] = int(value)
    for g in _generators.values():
        g.manual_seed(_seed[0])


class _GeneratorOverride(threading.local):
    def __init__(self):
        self.gen = None


_override = _GeneratorOverride()


@contextmanager
def using_generator(gen):
    """Inside the scope every draw takes ``gen`` (a ``torch.Generator``
    on the draws' device), as the reference's ``functional_mode`` splits
    its key; ``None`` changes nothing. Thread-local."""
    prev = _override.gen
    if gen is not None:
        _override.gen = gen
    try:
        yield
    finally:
        _override.gen = prev


def generator(device) -> torch.Generator:
    """The ``torch.Generator`` the port's random draws take on
    ``device`` (created at the current seed on first use), or the one a
    :func:`using_generator` scope set."""
    if _override.gen is not None:
        return _override.gen
    device = torch.device(device)
    g = _generators.get(device)
    if g is None:
        g = _generators[device] = torch.Generator(device=device)
        g.manual_seed(_seed[0])
    return g


dropout_generator = generator


def dropout(x, p=0.5, training=True, axes=()):
    """reference src/operator/nn/dropout.cc: keep each value with
    probability 1 - p and scale it by 1 / (1 - p). The mask draws from
    :func:`generator` of x's device. With ``axes``, the mask keeps its
    size on the axes named there and has size 1 (one draw shared) on
    every other axis, as the reference's ``ops/nn.py`` dropout: a
    negative entry names no axis, so ``axes=(-1,)`` makes one draw for
    the whole tensor; empty ``axes`` gives a full mask."""
    if not training or p <= 0:
        return x
    keep = 1.0 - p
    shape = list(x.shape)
    if axes:
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    mask = torch.rand(shape, generator=generator(x.device),
                      device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


_dropout = dropout      # attend() takes a rate named ``dropout``


# ---------------------------------------------------------------------------
# kernel gate
# ---------------------------------------------------------------------------
class _KernelsDisabled(threading.local):
    def __init__(self):
        self.depth = 0


_kernels_disabled = _KernelsDisabled()   # per-thread depth


class no_kernels:
    """Route every kernel dispatch site (LayerNorm, paged attention, the
    fused decode gate) to its plain PyTorch path inside the context,
    on any device. Re-entrant and thread-local, like ``no_pallas``."""

    def __enter__(self):
        _kernels_disabled.depth += 1
        return self

    def __exit__(self, *exc):
        _kernels_disabled.depth -= 1
        return False


def kernels_enabled() -> bool:
    return not _kernels_disabled.depth


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm (reference src/operator/nn/layer_norm.cc).

    Last-axis rows of width <= 8192 go through the K2 kernel's wrapper
    (:func:`~.kernels.layer_norm.fused_layer_norm`); other axes and
    widths, and :class:`no_kernels` scopes, take the plain path."""
    ax = axis if axis >= 0 else x.dim() + axis
    d = x.shape[-1]
    if (ax == x.dim() - 1 and d <= 8192 and gamma.dim() == 1
            and gamma.shape[0] == d and beta.dim() == 1
            and beta.shape[0] == d and kernels_enabled()):
        from .kernels.layer_norm import fused_layer_norm

        shp = x.shape
        return fused_layer_norm(x.reshape(-1, d), gamma, beta,
                                float(eps))[0].reshape(shp)
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    bshape = [1] * x.dim()
    bshape[axis] = x.shape[axis]
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


def group_norm(x, gamma, beta, num_groups=1, eps=1e-5):
    """GroupNorm over NC... (``mxnet_tpu/ops/nn.py:576``; reference
    src/operator/nn/group_norm.cc): mean and biased variance over each
    group of ``C / num_groups`` channels and the spatial axes, then a
    per-channel affine."""
    n, c = x.shape[:2]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    var, mean = torch.var_mean(xg, dim=axes, correction=0, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


def instance_norm(x, gamma, beta, eps=1e-5):
    """InstanceNorm (``mxnet_tpu/ops/nn.py:590``; reference
    src/operator/instance_norm.cc): each sample's channels normalized
    over the spatial axes, then a per-channel affine."""
    axes = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    bshape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


def l2_normalization(x, eps=1e-10, mode="instance"):
    """``x / sqrt(sum(x²) + eps)`` over every axis but the batch
    (``instance``), the channel axis (``channel``) or the spatial axes
    (``spatial``) (``mxnet_tpu/ops/nn.py:621``)."""
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, x.dim()))
    return x / torch.sqrt(torch.sum(torch.square(x), dim=axes,
                                    keepdim=True) + eps)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def leaky_relu(x, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, training=True):
    """reference src/operator/leaky_relu.cc (``mxnet_tpu/ops/nn.py:660``):
    ``leaky`` (``slope * x`` below 0), ``prelu`` (a learned ``gamma``,
    per channel on axis 1 when 1-D), ``elu``, ``selu``, ``gelu`` (erf)
    and ``rrelu``: a slope drawn uniformly in [lower_bound, upper_bound)
    per element while ``training`` (from :func:`generator` of x's
    device), their mean otherwise."""
    if act_type == "leaky":
        return torch.where(x >= 0, x, slope * x)
    if act_type == "prelu":
        g = gamma
        if g.dim() == 1 and g.dim() < x.dim():
            g = g.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, g * x)
    if act_type == "elu":
        return torch.where(x >= 0, x, slope * (torch.exp(x) - 1))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(x >= 0, x,
                                         _SELU_ALPHA * (torch.exp(x) - 1))
    if act_type == "gelu":
        return F.gelu(x, approximate="none")
    if act_type == "rrelu":
        if training:
            u = torch.rand(x.shape, generator=generator(x.device),
                           device=x.device)
            u = (u * (upper_bound - lower_bound) + lower_bound).to(x.dtype)
        else:
            u = (lower_bound + upper_bound) / 2.0
        return torch.where(x >= 0, x, u * x)
    raise ValueError(f"unknown leaky_relu type {act_type}")


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """RMSNorm (``mxnet_tpu/ops/nn.py:600``; no reference counterpart).

    Last-axis rows of width <= 8192 with a 1-D gamma of that width go
    through the K2r kernel's wrapper
    (:func:`~.kernels.layer_norm.fused_rms_norm`: the CUDA kernel for CUDA
    tensors, its plain version for CPU ones); other axes and widths, and
    :class:`no_kernels` scopes, take the reference's jnp arithmetic,
    ``x * rsqrt(mean(x²) + eps).astype(x.dtype) * gamma``. Nothing is
    caught: a kernel that refuses its inputs raises."""
    ax = axis if axis >= 0 else x.dim() + axis
    d = x.shape[-1]
    if (ax == x.dim() - 1 and d <= 8192 and gamma.dim() == 1
            and gamma.shape[0] == d and kernels_enabled()):
        from .kernels.layer_norm import fused_rms_norm

        shp = x.shape
        return fused_rms_norm(x.reshape(-1, d), gamma,
                              float(eps))[0].reshape(shp)
    ms = torch.mean(torch.square(x.float()), dim=axis, keepdim=True)
    return x * torch.rsqrt(ms + eps).to(x.dtype) * gamma


# ---------------------------------------------------------------------------
# softmax family and the loss
# ---------------------------------------------------------------------------
def softmax(x, axis=-1):
    """reference src/operator/nn/softmax.cc"""
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def pick(data, index, axis=-1, keepdims=False):
    """reference src/operator/tensor/broadcast_reduce_op_index.cc pick
    (indices clipped into range)."""
    ax = axis % data.dim()
    idx = index.long().clamp(0, data.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(data, ax, idx)
    return out if keepdims else out.squeeze(ax)


class _ClampValueOnly(torch.autograd.Function):
    """min(nll, -log(1e-8)) in the value, identity in the gradient (the
    reference backward is softmax - onehot unconditionally)."""

    @staticmethod
    def forward(ctx, nll):
        cap = -torch.log(torch.tensor(1e-8, dtype=torch.float32))
        return torch.minimum(nll, cap.to(nll.device))

    @staticmethod
    def backward(ctx, g):
        return g


def softmax_cross_entropy(data, label, per_example=False):
    """Sparse-label softmax cross entropy (reference
    src/operator/loss_binary_op.cc:30 ``softmax_cross_entropy``).

    ``data`` (N, V) logits, ``label`` (N,) class indices. The default is
    the reference contract: a shape-(1,) sum over rows of the NLL clamped
    in value (not in gradient) at ``-log(1e-8)``, in data's dtype.
    ``per_example=True`` returns the unclamped per-row NLL in f32. Rows
    with a negative label contribute 0.

    The row reduction is the K3 kernel's wrapper through
    :func:`~.kernels.cross_entropy.cross_entropy_with_logits`; inside
    :class:`no_kernels` it is a plain logsumexp."""
    if data.dim() != 2 or label.dim() != 1:
        raise ValueError(
            f"softmax_cross_entropy expects (N, V) data and (N,) label, "
            f"got {tuple(data.shape)} / {tuple(label.shape)}")
    from .kernels import cross_entropy as ce

    nll = (ce.cross_entropy_with_logits(data, label) if kernels_enabled()
           else ce.cross_entropy_plain(data, label))
    if per_example:
        return nll
    return _ClampValueOnly.apply(nll).sum().reshape(1).to(data.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attend(q, k, v, heads, causal=False, mask=None, dropout=0.0,
           training=False):
    """Multi-head attention over (B, L, H*D) projections — the attention
    core behind ``MultiHeadAttention.forward``.

    No mask and no training dropout: flash attention
    (:func:`~.kernels.flash_attention.flash_attention`, the K1 kernels on
    the card). Otherwise, and inside :class:`no_kernels`: the masked
    path with an f32 softmax (``ops/nn.py:1163-1181`` of the
    reference). A boolean ``mask`` keeps True positions; any other mask
    is added to the scores."""
    b, lq, hidden = q.shape
    d = hidden // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], heads, d).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], heads, d).transpose(1, 2)
    if mask is None and not (dropout and training) and kernels_enabled():
        from .kernels.flash_attention import flash_attention

        out = flash_attention(qh, kh, vh, causal=causal)
    else:
        lk = kh.shape[2]
        s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * (
            d ** -0.5)
        if causal:
            cm = torch.ones((lq, lk), dtype=torch.bool,
                            device=q.device).tril(diagonal=lk - lq)
            s = s.masked_fill(~cm, -1e30)
        if mask is not None:
            if mask.dtype == torch.bool:
                s = s.masked_fill(~mask, -1e30)
            else:
                s = s + mask.float()
        p = torch.softmax(s, dim=-1)
        if dropout and training:
            p = _dropout(p, dropout)
        out = torch.einsum("bhqk,bhkd->bhqd", p, vh.float()).to(q.dtype)
    return out.transpose(1, 2).reshape(b, lq, hidden)


# ---------------------------------------------------------------------------
# int8 KV cache layout
# ---------------------------------------------------------------------------
# One f32 scale per (token, head), bitcast into 4 extra int8 bytes on the
# feature axis, so a cache or pool stays ONE int8 tensor:
# row = [D int8 values | 4 bytes of the f32 scale, little-endian].
_KV_SCALE_BYTES = 4
# 1/127 rounded to f32. The reference always runs the quantizer compiled,
# and XLA folds its ``amax / 127.0`` into a multiply by this constant;
# the port does the same so the scale bytes match. ``t / scale`` stays a
# true divide there and here.
_INV_127 = float(onp.float32(1.0) / onp.float32(127.0))


def kv_cache_quantize(t):
    """(..., D) float -> (..., D+4) int8 [values | bitcast f32 scale].

    Rounding is half-to-even (``torch.round``, as ``jnp.round``) of a
    divide by the scale."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) * _INV_127
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    # the bitcast: a (..., 1) float32 tensor viewed as (..., 4) int8
    sb = scale.contiguous().view(torch.int8)
    return torch.cat([q, sb], dim=-1)


def kv_cache_dequantize(c, dtype):
    """(..., D+4) int8 -> (..., D) ``dtype``."""
    d = c.shape[-1] - _KV_SCALE_BYTES
    vals = c[..., :d].float()
    scale = c[..., d:].contiguous().view(torch.float32)   # (..., 1)
    return (vals * scale).to(dtype)


def paged_write(pool_k, pool_v, k_store, v_store, block_table, positions):
    """Write T new tokens per lane into ONE layer's pools, IN PLACE (the
    reference writes a functional copy, donated on the TPU).

    ``k_store``/``v_store``: (R*T, H, D') rows in the pools' layout, lane
    ``r``'s token ``t`` at absolute position ``positions[r] + t``, which
    lands in block ``block_table[r, p // bs]`` slot ``p % bs``. Returns
    the ``(block_table, lengths)`` of the R*T virtual lanes that attend
    the pools: token ``t`` of lane ``r`` sees positions ``<= p``, so the
    lengths are the causal mask."""
    r = block_table.shape[0]
    t = k_store.shape[0] // r
    bs = pool_k.shape[2]
    abs_pos = (positions.long()[:, None]
               + torch.arange(t, device=positions.device)[None])  # (R, T)
    blk = torch.gather(block_table.long(), 1, abs_pos // bs).reshape(-1)
    slot = (abs_pos % bs).reshape(-1)
    # two advanced indices around a slice: the (R*T,) token axis goes
    # first, giving (R*T, H, D') — the layout of k_store
    pool_k[blk, :, slot, :] = k_store
    pool_v[blk, :, slot, :] = v_store
    bt = block_table if t == 1 else block_table.repeat_interleave(t, dim=0)
    return bt.contiguous(), (abs_pos + 1).reshape(-1).to(torch.int32)


def paged_attention(q, k_pool, v_pool, block_table, lengths,
                    use_kernel=None):
    """Single-token decode attention through a paged KV block pool.

    ``q`` (R, H, D); pools (NB, H, bs, D') for one layer (``D' = D + 4``
    for int8 pools); ``block_table`` (R, MB) int32; ``lengths`` (R,)
    int32 valid positions per lane. ``use_kernel=None`` takes the K4
    kernel's wrapper (CUDA kernel on a CUDA tensor, plain version on a
    CPU one) unless a :class:`no_kernels` scope is active; ``False``
    takes the plain gather path (``ops/nn.py:1063-1084`` of the
    reference). Returns (R, H, D) in the pool's dtype (float pools) or
    ``q``'s dtype (int8 pools)."""
    from .kernels.paged_attention import (paged_attention_kernel,
                                          paged_attention_plain)

    if use_kernel is None:
        use_kernel = kernels_enabled()
    if use_kernel:
        return paged_attention_kernel(q, k_pool, v_pool, block_table,
                                      lengths)
    return paged_attention_plain(q, k_pool, v_pool, block_table, lengths)


def paged_attention_multi(q, k_pool, v_pool, block_table, positions,
                          use_kernel=None):
    """Multi-token paged attention (``mxnet_tpu/ops/nn.py:1087``): ``q``
    is (R, T, H, D), lane ``r``'s query ``t`` at absolute position
    ``positions[r] + t``, attending positions ``<= positions[r] + t``
    (the length mask is the causal mask). Speculative verify (T = K+1)
    and suffix prefill (T = the suffix bucket) run it.

    ``use_kernel=None`` takes the K4 kernel for CUDA tensors unless a
    :class:`no_kernels` scope is active: R*T virtual lanes, each lane's
    table row repeated per token and lengths ``positions + t + 1``, as
    the reference's TPU route (``:1117-1125``). Otherwise each lane's
    blocks are gathered once and all T queries attend that dense view
    (``:1126-``), with the row arithmetic of :func:`paged_attention`'s
    plain path. Returns (R, T, H, D) in the pool's dtype (float pools)
    or ``q``'s dtype (int8 pools)."""
    r, t, h, d = q.shape
    bs = k_pool.shape[2]
    mb = block_table.shape[1]
    abs_pos = (positions.long()[:, None]
               + torch.arange(t, device=positions.device)[None])  # (R, T)
    if use_kernel is None:
        use_kernel = kernels_enabled() and q.is_cuda
    if use_kernel:
        from .kernels.paged_attention import paged_attention_kernel

        out = paged_attention_kernel(
            q.reshape(r * t, h, d).contiguous(), k_pool, v_pool,
            block_table.repeat_interleave(t, dim=0).contiguous(),
            (abs_pos + 1).reshape(-1).to(torch.int32))
        return out.reshape(r, t, h, d)
    bt = block_table.long()
    keys = k_pool[bt]                   # (R, MB, H, bs, D') — once
    vals = v_pool[bt]

    def flat(c):                        # -> (R, H, MB*bs, D')
        return c.permute(0, 2, 1, 3, 4).reshape(r, h, mb * bs, c.shape[-1])

    keys, vals = flat(keys), flat(vals)
    if k_pool.dtype == torch.int8:
        keys = kv_cache_dequantize(keys, q.dtype)
        vals = kv_cache_dequantize(vals, q.dtype)
    ct = torch.promote_types(q.dtype, keys.dtype)
    scores = torch.einsum("rthd,rhld->rthl", q.to(ct), keys.to(ct)).float()
    scores = scores / math.sqrt(d)
    live = (torch.arange(mb * bs, device=q.device)[None, None, :]
            < (abs_pos + 1)[:, :, None])
    scores = torch.where(live[:, :, None, :], scores,
                         torch.full_like(scores, float("-inf")))
    attn = torch.softmax(scores, dim=-1).to(vals.dtype)
    return torch.einsum("rthl,rhld->rthd", attn, vals)
