"""Neural-network operators of the PyTorch port (counterpart of
``mxnet_tpu/ops/nn.py``), limited to what the serving and training
slices run.

Kernel dispatch: :func:`layer_norm`, :func:`rms_norm`, :func:`attend`,
:func:`softmax_cross_entropy` and :func:`paged_attention` hand their
tensors to the hand-written kernels' wrappers (:mod:`.kernels`), and a
wrapper launches its CUDA kernel for a CUDA tensor and takes its plain
PyTorch version for a CPU tensor. Inside a :class:`no_kernels` scope
every site takes the plain path instead, whatever the device — that is
how a run holds the kernels against the plain arithmetic on the card.
"""
from __future__ import annotations

import threading

import numpy as onp
import torch
import torch.nn.functional as F

__all__ = ["fully_connected", "activation", "embedding", "layer_norm",
           "rms_norm", "dropout", "generator", "dropout_generator", "seed",
           "attend", "softmax",
           "log_softmax", "pick", "softmax_cross_entropy",
           "kv_cache_quantize", "kv_cache_dequantize", "paged_write",
           "paged_attention", "no_kernels", "kernels_enabled"]


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


def generator(device) -> torch.Generator:
    """The ``torch.Generator`` the port's random draws take on
    ``device`` (created at the current seed on first use)."""
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
    :func:`generator` of x's device; along ``axes`` one draw is shared
    (the mask has size 1 there)."""
    if not training or p <= 0:
        return x
    keep = 1.0 - p
    shared = {a % x.dim() for a in axes}
    shape = [1 if i in shared else s for i, s in enumerate(x.shape)]
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
