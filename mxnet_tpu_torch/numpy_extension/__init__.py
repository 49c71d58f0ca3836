"""``mx.npx`` of the PyTorch port (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``): the operators beyond numpy,
each forwarding to :mod:`~mxnet_tpu_torch.ops.nn` as the reference's
``_call`` forwards to its ``ops/nn.py``. Autograd is torch's own, so
there is no dispatch layer between, but for mixed precision: each op
that the AMP lists name (``amp/lists.py``, under the reference's
dispatch names: ``Convolution``, ``FullyConnected``, ``BatchNorm``,
``softmax_cross_entropy``, ...) hands its tensor inputs to
``ops.dispatch.amp_policy`` when one is set (``dispatch.amp_cast``),
where the reference's ``apply_op`` casts them; with AMP off that is one test of a
module global. ``dropout`` reads the training flag of
:mod:`~mxnet_tpu_torch.autograd`, as the reference's does.

The contrib family (ROI, box, SSD, deformable and the small probes) is
:mod:`~mxnet_tpu_torch.ops.contrib`'s functions themselves, and
``foreach``/``while_loop``/``cond`` are :mod:`.control_flow`'s.
``sync_batch_norm`` reads the training flag and writes the moving
statistics in place while training, as the reference's does. The
reference's key plumbing (``rng_scope``, ``functional_mode``) has
:func:`~mxnet_tpu_torch.ops.nn.using_generator` as its counterpart, and
its TPU helpers (``tpu``, ``num_tpus``) none.

``nonzero``, ``boolean_mask`` and ``index_copy`` read values on the host
(an output size, or the reference's range check): inside a CUDA-graph
capture they raise :class:`~mxnet_tpu_torch.base.MXNetError`
(``index_copy`` then drops out-of-range rows, as the reference does
under a trace). Out-of-range indices never reach torch: gathers clamp
and scatters drop (:func:`~mxnet_tpu_torch.ops.nn.gather_index`).
"""
from __future__ import annotations

import builtins

import torch
import torch.nn.functional as F

from .. import numpy as _np
from ..autograd import is_training
from ..base import MXNetError
from ..context import cpu, current_context, gpu, num_gpus  # noqa: F401
from ..ndarray.ndarray import waitall  # noqa: F401
from ..ops import contrib as _contrib
from ..ops import dispatch as _dispatch
from ..ops import nn as _nn
from ..ops.contrib import (  # noqa: F401
    all_finite, allclose, bilinear_resize_2d, bipartite_matching, box_iou,
    box_nms, count_sketch, deformable_convolution, gradientmultiplier,
    hawkes_ll, index_array, khatri_rao, modulated_deformable_convolution,
    multi_all_finite, multi_sum_sq, multibox_detection, multibox_prior,
    multibox_target, nnz, psroi_pooling, quadratic, roi_align, roi_pooling,
    round_ste, sign_ste)
from ..serialization import load, save  # noqa: F401
from ..util import is_np_array, reset_np, set_np, use_np  # noqa: F401

__all__ = ["fully_connected", "activation", "convolution", "deconvolution",
           "pooling", "batch_norm", "layer_norm", "rms_norm", "group_norm",
           "instance_norm", "l2_normalization", "leaky_relu", "gelu",
           "softmax", "log_softmax", "dropout", "embedding", "pick",
           "softmax_cross_entropy", "masked_softmax", "masked_log_softmax",
           "one_hot", "topk", "gather_nd", "scatter_nd", "sequence_mask",
           "sequence_last", "sequence_reverse", "arange_like",
           "broadcast_like", "slice_like", "reshape_like", "batch_flatten",
           "slice", "shape_array", "waitall", "load", "save", "sigmoid",
           "relu", "erf", "erfinv", "gamma", "gammaln", "digamma", "rsqrt",
           "rcbrt", "log_sigmoid", "hard_sigmoid", "silu", "swish", "mish",
           "softplus", "smooth_l1", "reshape", "index_add", "index_update",
           "index_copy", "boolean_mask", "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt",
           "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
           "multi_head_attention", "ctc_loss", "adaptive_avg_pool2d",
           "nonzero", "constraint_check", "to_dlpack_for_read",
           "to_dlpack_for_write", "from_dlpack", "seed", "bernoulli",
           "uniform_n", "normal_n", "random", "cpu", "gpu",
           "current_context", "num_gpus", "is_np_array", "set_np",
           "reset_np", "use_np", "roi_pooling", "roi_align", "count_sketch",
           "sync_batch_norm", "box_iou", "box_nms", "bipartite_matching",
           "allclose", "index_array", "multibox_prior",
           "deformable_convolution", "modulated_deformable_convolution",
           "hawkes_ll", "round_ste", "sign_ste", "khatri_rao", "quadratic",
           "all_finite", "multi_all_finite", "multi_sum_sq", "nnz",
           "bilinear_resize_2d", "psroi_pooling", "gradientmultiplier",
           "multibox_target", "multibox_detection", "foreach", "while_loop",
           "cond"]


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    if _dispatch.amp_policy is not None:
        x, weight, bias = _dispatch.amp_cast("FullyConnected", x, weight, bias)
    return _nn.fully_connected(x, weight, None if no_bias else bias,
                               num_hidden=num_hidden, flatten=flatten,
                               no_bias=no_bias)


def activation(x, act_type="relu"):
    return _nn.activation(x, act_type)


def convolution(x, weight, bias=None, kernel=None, stride=1, dilate=1, pad=0,
                num_filter=0, num_group=1, no_bias=False, layout="NCHW"):
    if _dispatch.amp_policy is not None:
        x, weight, bias = _dispatch.amp_cast("Convolution", x, weight, bias)
    return _nn.convolution(x, weight, None if no_bias else bias,
                           stride=stride, dilate=dilate, pad=pad,
                           num_group=num_group, layout=layout)


def deconvolution(x, weight, bias=None, stride=1, dilate=1, pad=0, adj=0,
                  num_filter=0, num_group=1, no_bias=False, layout="NCHW"):
    if _dispatch.amp_policy is not None:
        x, weight, bias = _dispatch.amp_cast("Deconvolution", x, weight, bias)
    return _nn.deconvolution(x, weight, None if no_bias else bias,
                             stride=stride, dilate=dilate, pad=pad, adj=adj,
                             num_group=num_group, layout=layout)


def pooling(x, kernel=1, pool_type="max", stride=None, pad=0,
            global_pool=False, count_include_pad=True, layout="NCHW",
            pooling_convention="valid"):
    """``pooling_convention="full"`` is ``ceil_mode``."""
    return _nn.pooling(x, kernel, pool_type, stride, pad, global_pool,
                       count_include_pad, layout,
                       ceil_mode=pooling_convention == "full")


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1):
    """BatchNorm in training mode while
    :func:`~mxnet_tpu_torch.autograd.is_training` (inside
    ``autograd.record()``), with the moving statistics otherwise. In
    training, and not with ``use_global_stats``, the new statistics are
    written into ``running_mean`` and ``running_var`` in place, as the
    reference's aux states. ``output_mean_var=True`` returns ``(out,
    new_mean, new_var)``."""
    training = is_training()
    rm, rv = running_mean, running_var
    if _dispatch.amp_policy is not None:
        x, gamma, beta, rm, rv = _dispatch.amp_cast("BatchNorm", x, gamma, beta, rm, rv)
    out, new_mean, new_var = _nn.batch_norm(
        x, gamma, beta, rm, rv, eps=eps,
        momentum=momentum, fix_gamma=fix_gamma,
        use_global_stats=use_global_stats, training=training, axis=axis)
    if training and not use_global_stats:
        with torch.no_grad():
            running_mean.copy_(new_mean)
            running_var.copy_(new_var)
    if output_mean_var:
        return out, new_mean, new_var
    return out


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    if _dispatch.amp_policy is not None:
        x, gamma, beta = _dispatch.amp_cast("LayerNorm", x, gamma, beta)
    return _nn.layer_norm(x, gamma, beta, axis=axis, eps=eps)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    if _dispatch.amp_policy is not None:
        x, gamma = _dispatch.amp_cast("RMSNorm", x, gamma)
    return _nn.rms_norm(x, gamma, axis=axis, eps=eps)


def group_norm(x, gamma, beta, num_groups=1, eps=1e-5):
    if _dispatch.amp_policy is not None:
        x, gamma, beta = _dispatch.amp_cast("GroupNorm", x, gamma, beta)
    return _nn.group_norm(x, gamma, beta, num_groups=num_groups, eps=eps)


def instance_norm(x, gamma, beta, eps=1e-5):
    if _dispatch.amp_policy is not None:
        x, gamma, beta = _dispatch.amp_cast("InstanceNorm", x, gamma, beta)
    return _nn.instance_norm(x, gamma, beta, eps=eps)


def l2_normalization(x, eps=1e-10, mode="instance"):
    if _dispatch.amp_policy is not None:
        x, = _dispatch.amp_cast("L2Normalization", x)
    return _nn.l2_normalization(x, eps=eps, mode=mode)


def leaky_relu(x, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """``rrelu`` draws its slopes while
    :func:`~mxnet_tpu_torch.autograd.is_training`."""
    return _nn.leaky_relu(x, gamma, act_type=act_type, slope=slope,
                          lower_bound=lower_bound, upper_bound=upper_bound,
                          training=is_training())


def gelu(x, approximate=True):
    """GELU, the tanh approximation unless ``approximate=False`` (the
    reference's default)."""
    return _nn.activation(x, "gelu_tanh" if approximate else "gelu")


def softmax(x, axis=-1, temperature=None, length=None):
    """Softmax of ``x / temperature``; with ``length`` (one per row of
    axis 0) the positions past a row's length get 0."""
    if _dispatch.amp_policy is not None:
        x, length = _dispatch.amp_cast("softmax", x, length)
    return _nn.softmax(x, axis=axis, temperature=temperature, length=length)


def log_softmax(x, axis=-1, temperature=None):
    if _dispatch.amp_policy is not None:
        x, = _dispatch.amp_cast("log_softmax", x)
    return _nn.log_softmax(x, axis=axis, temperature=temperature)


def masked_softmax(x, mask, axis=-1, temperature=1.0):
    if _dispatch.amp_policy is not None:
        x, mask = _dispatch.amp_cast("masked_softmax", x, mask)
    return _nn.masked_softmax(x, mask, axis=axis, temperature=temperature)


def masked_log_softmax(x, mask, axis=-1, temperature=1.0):
    if _dispatch.amp_policy is not None:
        x, mask = _dispatch.amp_cast("masked_log_softmax", x, mask)
    return _nn.masked_log_softmax(x, mask, axis=axis,
                                  temperature=temperature)


def softmax_cross_entropy(data, label, per_example=False):
    """Sparse-label CE over (N, V) logits through the K3 kernel's wrapper
    (reference ``loss_binary_op.cc``); float32 logits under AMP."""
    if _dispatch.amp_policy is not None:
        data, label = _dispatch.amp_cast("softmax_cross_entropy", data, label)
    return _nn.softmax_cross_entropy(data, label, per_example=per_example)


def dropout(x, p=0.5, axes=None, mode="training"):
    """Dropout while :func:`~mxnet_tpu_torch.autograd.is_training` (or
    always, with ``mode="always"``); the identity otherwise."""
    training = is_training() or mode == "always"
    return _nn.dropout(x, p=p, training=training, axes=axes or ())


def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    """Row gather; ``sparse_grad`` is accepted and the gradient is dense
    (a row-sparse gradient is not ported)."""
    return _nn.embedding(data, weight)


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """data's entry at ``index`` along ``axis``, the index clipped into
    range whatever ``mode`` says, as in the reference."""
    return _nn.pick(data, index, axis=axis, keepdims=keepdims, mode=mode)


def one_hot(data, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    return _nn.one_hot(data, depth, on_value, off_value, dtype)


def topk(data, k=1, axis=-1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    return _nn.topk(data, k=k, axis=axis, ret_typ=ret_typ,
                    is_ascend=is_ascend, dtype=dtype)


def gather_nd(data, indices):
    return _nn.gather_nd(data, indices)


def scatter_nd(data, indices, shape):
    return _nn.scatter_nd(data, indices, shape)


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    return _nn.sequence_mask(data, sequence_length, use_sequence_length,
                             value, axis)


def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    return _nn.sequence_last(data, sequence_length, use_sequence_length,
                             axis)


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    return _nn.sequence_reverse(data, sequence_length, use_sequence_length,
                                axis)


# ---------------------------------------------------------------------------
# shape and utility ops
# ---------------------------------------------------------------------------
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``arange(n) * step + start`` of data's size, shaped like ``data``
    (float64, as the reference's int64 range times a Python float), or
    along ``axis`` (float32); ``repeat`` is accepted and ignored, as in
    the reference."""
    if axis is None:
        n = data.numel()
        return (torch.arange(n, dtype=torch.float64, device=data.device)
                * step + start).reshape(data.shape)
    n = data.shape[axis]
    return torch.arange(n, dtype=torch.float32, device=data.device) * step \
        + start


def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    """``lhs`` broadcast to rhs's shape (the axes arguments are accepted
    and ignored, as in the reference)."""
    return torch.broadcast_to(lhs, rhs.shape)


def slice_like(data, shape_like, axes=()):
    idx = [builtins.slice(None)] * data.dim()
    for ax in (axes if axes else range(data.dim())):
        idx[ax] = builtins.slice(0, shape_like.shape[ax])
    return data[tuple(idx)]


def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


def batch_flatten(data):
    """Collapse every axis but the first."""
    return data.reshape(data.shape[0], -1)


def slice(data, begin, end, step=None):  # noqa: A001 - reference op name
    """Strided crop (reference ``src/operator/tensor/slice``); an entry of
    ``begin``/``end`` may be None (from the start / to the end), and a
    step may be negative."""
    step = step or [1] * len(begin)
    out = data
    for ax, (b, e, s) in enumerate(zip(begin, end, step)):
        s = 1 if s is None else s
        if s > 0:
            out = out[(builtins.slice(None),) * ax + (builtins.slice(b, e, s),)]
        else:
            pos = range(*builtins.slice(b, e, s).indices(out.shape[ax]))
            out = torch.index_select(out, ax, torch.tensor(
                list(pos), dtype=torch.long, device=out.device))
    return out


def shape_array(data):
    return torch.tensor(tuple(data.shape), dtype=torch.int64,
                        device=data.device)


# ---------------------------------------------------------------------------
# activations and special functions
# ---------------------------------------------------------------------------
def sigmoid(x):
    return torch.sigmoid(x)


def relu(x):
    return torch.relu(x)


def erf(x):
    if _dispatch.amp_policy is not None:
        x, = _dispatch.amp_cast("erf", x)
    return torch.erf(x)


def erfinv(x):
    if _dispatch.amp_policy is not None:
        x, = _dispatch.amp_cast("erfinv", x)
    return torch.erfinv(x)


def gamma(x):
    if _dispatch.amp_policy is not None:
        x, = _dispatch.amp_cast("gamma", x)
    return _np.gamma_fn(x)


def gammaln(x):
    if _dispatch.amp_policy is not None:
        x, = _dispatch.amp_cast("gammaln", x)
    return torch.lgamma(x)


def digamma(x):
    return torch.digamma(x)


def rsqrt(x):
    if _dispatch.amp_policy is not None:
        x, = _dispatch.amp_cast("rsqrt", x)
    return torch.rsqrt(x)


def rcbrt(x):
    return 1.0 / _np.cbrt(x)


def log_sigmoid(x):
    return F.logsigmoid(x)


def hard_sigmoid(x, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


def softplus(x):
    """log(1 + exp(x)), exact for large x (torch's softplus turns linear
    past a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def silu(x):
    return F.silu(x)


swish = silu


def mish(x):
    return x * torch.tanh(softplus(x))


def smooth_l1(data, scalar=1.0):
    """0.5 (s x)² where |x| < 1/s², else |x| - 0.5/s² (reference
    ``elemwise_binary_scalar_op_extended.cc``)."""
    if _dispatch.amp_policy is not None:
        data, = _dispatch.amp_cast("smooth_l1", data)
    s2 = scalar * scalar
    ax = data.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * data * data, ax - 0.5 / s2)


def reshape(data, newshape, reverse=False):
    """MXNet reshape with its special codes (reference
    ``src/operator/tensor/matrix_op.cc`` Reshape): 0 copies the input
    axis, -1 infers one axis, -2 copies all remaining axes, -3 merges two
    axes, -4 splits one axis by the next two values (one may be -1);
    ``reverse`` reads the codes right to left."""
    in_shape = list(data.shape)
    spec = list(newshape)
    if reverse:
        in_shape, spec = in_shape[::-1], spec[::-1]
    out, i, j = [], 0, 0
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(in_shape[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(in_shape[i:])
            i = len(in_shape)
        elif s == -3:
            out.append(in_shape[i] * in_shape[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            if d1 == -1:
                d1 = in_shape[i] // d2
            if d2 == -1:
                d2 = in_shape[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(int(s))
            i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return data.reshape(tuple(out))


# ---------------------------------------------------------------------------
# index ops
# ---------------------------------------------------------------------------
def index_add(data, indices, values):
    """``data.at[tuple(indices)].add(values)``, out of place; out-of-range
    updates are dropped."""
    rows = [indices[i] for i in range(indices.shape[0])]
    return _nn.scatter_drop(data, rows, values, accumulate=True)


def index_update(data, indices, values):
    """``data.at[tuple(indices)].set(values)``, out of place; out-of-range
    updates are dropped."""
    rows = [indices[i] for i in range(indices.shape[0])]
    return _nn.scatter_drop(data, rows, values, accumulate=False)


def index_copy(old_tensor, index_vector, new_tensor):
    """A copy of ``old_tensor`` with its rows at ``index_vector`` replaced
    by ``new_tensor``'s (``ops/contrib.py`` ``index_copy``). An index out
    of range raises :class:`MXNetError`, as the reference does eagerly;
    inside a CUDA-graph capture, where the range cannot be read, it is
    dropped, as the reference's trace drops it."""
    idx = index_vector.to(old_tensor.device).long()
    if not _np._capturing():
        n = old_tensor.shape[0]
        bad = (idx < 0) | (idx >= n)
        if bool(bad.any()):
            raise MXNetError(
                f"index_copy: index out of range for first axis of size "
                f"{n}: {idx[bad][:5].tolist()}")
        return old_tensor.index_put((idx,), new_tensor.to(old_tensor.dtype))
    return _nn.scatter_drop(old_tensor, [idx], new_tensor, accumulate=False)


def boolean_mask(data, index, axis=0):
    """The entries of ``data`` along ``axis`` where ``index`` is nonzero
    (``ops/contrib.py`` ``boolean_mask``); the output size is read on the
    host."""
    _np._host_sync("boolean_mask", "npx")
    keep = torch.nonzero(index.to(data.device).reshape(-1)).reshape(-1)
    return torch.index_select(data, axis, keep)


def nonzero(x):
    """Indices of the nonzero entries as an (N, ndim) int64 array (the
    reference's ``np_nonzero_op.cc`` layout)."""
    _np._host_sync("nonzero", "npx")
    return torch.argwhere(torch.as_tensor(x))


def constraint_check(x, msg="Constraint violated."):
    """Raise ``msg`` when any entry of the bool tensor is False
    (``np_constraint_check.cc``); returns the all-reduced bool. Inside a
    CUDA-graph capture it cannot read the value and only returns it, as
    the reference does under a trace."""
    ok = torch.all(torch.as_tensor(x))
    if not _np._capturing() and not bool(ok):
        raise MXNetError(msg)
    return ok


def to_dlpack_for_read(data):
    """A DLPack capsule sharing the tensor's memory."""
    return torch.utils.dlpack.to_dlpack(data.detach())


def to_dlpack_for_write(data):
    """A DLPack capsule sharing the tensor's memory; writes through it
    change the tensor (the reference hands out a copy's)."""
    return torch.utils.dlpack.to_dlpack(data.detach())


def from_dlpack(dlpack):
    return torch.utils.dlpack.from_dlpack(dlpack)


# ---------------------------------------------------------------------------
# attention, losses, pooling
# ---------------------------------------------------------------------------
def interleaved_matmul_selfatt_qk(queries_keys_values, heads):
    if _dispatch.amp_policy is not None:
        queries_keys_values, = _dispatch.amp_cast("interleaved_matmul_selfatt_qk",
                                    queries_keys_values)
    return _nn.interleaved_matmul_selfatt_qk(queries_keys_values, heads)


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads):
    if _dispatch.amp_policy is not None:
        queries_keys_values, attention = _dispatch.amp_cast(
            "interleaved_matmul_selfatt_valatt", queries_keys_values,
            attention)
    return _nn.interleaved_matmul_selfatt_valatt(queries_keys_values,
                                                 attention, heads)


def interleaved_matmul_encdec_qk(queries, keys_values, heads):
    if _dispatch.amp_policy is not None:
        queries, keys_values = _dispatch.amp_cast("interleaved_matmul_encdec_qk", queries,
                                    keys_values)
    return _nn.interleaved_matmul_encdec_qk(queries, keys_values, heads)


def interleaved_matmul_encdec_valatt(keys_values, attention, heads):
    if _dispatch.amp_policy is not None:
        keys_values, attention = _dispatch.amp_cast("interleaved_matmul_encdec_valatt",
                                      keys_values, attention)
    return _nn.interleaved_matmul_encdec_valatt(keys_values, attention,
                                                heads)


def multi_head_attention(query, key, value, heads, causal=False):
    """Multi-head attention over (B, L, H * D) projections through
    :func:`~mxnet_tpu_torch.ops.nn.attend` (the K1 kernels on the
    card)."""
    if _dispatch.amp_policy is not None:
        query, key, value = _dispatch.amp_cast("multi_head_attention", query, key, value)
    return _nn.attend(query, key, value, heads, causal=causal)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             blank_label="first"):
    """Connectionist temporal classification loss of (T, B, C)
    activations against (B, L) labels, per sequence (B,) in float32, by
    the port's ``gluon/loss.py`` recursion; the blank is class 0
    (``"first"``) or C - 1 (``"last"``)."""
    from ..gluon.loss import _ctc_nll

    t_max, b, c = data.shape
    dev = data.device
    blank = 0 if blank_label == "first" else c - 1
    dlen = torch.full((b,), t_max, dtype=torch.int32, device=dev) \
        if data_lengths is None else data_lengths.to(dev)
    llen = torch.full((b,), label.shape[1], dtype=torch.int32, device=dev) \
        if label_lengths is None else label_lengths.to(dev)
    return _ctc_nll(data.float().transpose(0, 1), label.to(dev), dlen, llen,
                    blank=blank, skip_blank=False).float()


def adaptive_avg_pool2d(data, output_size):
    return _nn.adaptive_avg_pool2d(data, output_size)


def sync_batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-3,
                    momentum=0.9, axis_name=None):
    """BatchNorm over the batch statistics while
    :func:`~mxnet_tpu_torch.autograd.is_training`, writing the
    momentum-updated statistics into ``moving_mean`` and ``moving_var``
    in place (the reference's aux states); with the moving statistics
    otherwise. Returns (out, mean_used, var_used). An ``axis_name``
    raises: the port has no device mesh yet."""
    training = is_training()
    mm, mv = moving_mean, moving_var
    if _dispatch.amp_policy is not None:
        x, gamma, beta, mm, mv = _dispatch.amp_cast("sync_batch_norm", x, gamma, beta, mm,
                                      mv)
    out, mean, var, new_mm, new_mv = _contrib.sync_batch_norm(
        x, gamma, beta, mm, mv, eps=eps, momentum=momentum,
        axis_name=axis_name, training=training)
    if training:
        with torch.no_grad():
            moving_mean.copy_(new_mm)
            moving_var.copy_(new_mv)
    return out, mean, var


from . import random  # noqa: E402
from .control_flow import cond, foreach, while_loop  # noqa: E402,F401
from .random import bernoulli, normal_n, seed, uniform_n  # noqa: E402,F401
