"""K3 — streaming logsumexp for the LM loss (counterpart of
``mxnet_tpu/ops/pallas/cross_entropy.py``).

Replaces ``_lse_kernel`` (``ops/pallas/cross_entropy.py:34``, reached
through ``fused_lse`` ``:64``) with the hand-written CUDA kernels in
``csrc/cross_entropy.cu``: one read of each row, max and sum in f32.
Bound on the H100: bytes; at the LM head's (8184, 32000) f32 logits that
is 1.05 GB read, 0.31 ms at 3.35 TB/s. It runs once per train step.

:func:`lse_route` picks one of three kernels from the row's width in
bytes and the bytes of the whole input: ``"rows"`` for many narrow rows
(SSD300's 21 classes: tiles of many rows through shared memory, one
thread a row), ``"warp"`` for a few narrow rows (one warp a row; the NSP
head's 2 classes) and ``"wide"`` for every wider row (one block a row;
ResNet-50's 1000 classes, the LM and MLM heads).
Every route takes rows at any address: the streaming ones peel a scalar
head up to the row's first 16-byte boundary, the tiles copy their
aligned body and load the ragged ends. ``"block"``, the first design
(16-byte loads only where every row is aligned), stays reachable through
:func:`lse_launch` for comparison. Each call is one launch.

:func:`fused_lse` launches the kernel for CUDA tensors and takes
:func:`lse_plain` for CPU tensors. :func:`cross_entropy_with_logits` is
a ``torch.autograd.Function``, as the reference's is a
``jax.custom_vjp``: nll = lse - x[label] (0 for a negative label), and
its backward is the plain port of ``_ce_bwd`` (``:125``) from the saved
lse, which XLA runs there too.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["fused_lse", "lse_plain", "lse_route", "lse_launch",
           "cross_entropy_with_logits", "cross_entropy_plain"]


def lse_plain(x):
    """Row-wise logsumexp of (N, V) in f32, with the kernel's ``l == 0``
    guard: (N,) f32."""
    xf = x.float()
    m = xf.amax(dim=-1, keepdim=True)
    l = torch.exp(xf - m).sum(dim=-1, keepdim=True)
    return (m + torch.log(torch.where(l == 0.0, torch.ones_like(l), l)))[:, 0]


# lse_route's cuts, from chip_smoke.py --k3's sweep on the H100: the
# widest row, in bytes, of the narrow routes; below LSE_ROWS_MIN_BYTES of
# logits the rows route's set-up (barriers, the first bulk copy) costs
# more than one warp a row
LSE_ROWS_MAX_BYTES = 256
LSE_ROWS_MIN_BYTES = 128 << 10


def lse_route(x):
    """The K3 kernel that takes the rows of ``x`` (N, V), by their width
    in bytes: up to LSE_ROWS_MAX_BYTES ``"rows"``, or ``"warp"`` while
    all of x is under LSE_ROWS_MIN_BYTES; ``"wide"`` otherwise. Every
    route reads rows at any 16-byte alignment, so the address does not
    change the choice."""
    n, v = x.shape
    row_bytes = v * x.element_size()
    if row_bytes > LSE_ROWS_MAX_BYTES:
        return "wide"
    return "rows" if n * row_bytes >= LSE_ROWS_MIN_BYTES else "warp"


def lse_launch(lib, route, x, lse, stream):
    """Launch one K3 kernel of ``lib`` by its C entry (``route`` as
    :func:`lse_route`, or ``"block"``) on (N, V) ``x``, writing (N,) f32
    ``lse``; returns the entry's error code."""
    n, v = x.shape
    code = _build.dtype_code(x.dtype)
    if route == "block":
        # 16-byte loads when every row starts on a 16-byte boundary
        vec = int(x.data_ptr() % 16 == 0 and (v * x.element_size()) % 16 == 0)
        return lib.mxt_row_lse(x.data_ptr(), lse.data_ptr(), n, v, vec, code,
                               stream)
    entry = {"rows": lib.mxt_lse_rows, "warp": lib.mxt_lse_warp,
             "wide": lib.mxt_lse_wide}[route]
    return entry(x.data_ptr(), lse.data_ptr(), n, v, code, stream)


def fused_lse(x):
    """Row-wise logsumexp of a 2-D array in one pass over it: (N,) f32.
    CUDA tensors: one K3 kernel (float32 or bfloat16, contiguous), chosen
    by :func:`lse_route`."""
    what = "fused_lse"
    _build.refuse_grad(what, x)
    if _build.on_cpu(what, x):
        return lse_plain(x)
    _build.require(x.dim() == 2, what, f"expected (N, V), got {tuple(x.shape)}")
    _build.require(x.dtype in (torch.float32, torch.bfloat16), what,
                   f"dtype {x.dtype}: float32 or bfloat16")
    _build.require(x.is_contiguous(), what, "x must be contiguous")
    lib = _build.load("cross_entropy")
    lse = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lse_launch(lib, lse_route(x), x, lse,
                         _build.stream_ptr(x.device))
    _build.check(err, what)
    fused_lse.launches += 1
    return lse


def _nll(logits, lab, lse):
    """lse - logits[i, lab[i]] in f32, 0 where the label is negative."""
    picked = logits.gather(1, lab.clamp(min=0)[:, None])[:, 0]
    return torch.where(lab >= 0, lse - picked.float(), torch.zeros_like(lse))


class _CrossEntropy(torch.autograd.Function):
    """K3 with the reference's ``_ce_bwd``. ``setup_context`` and
    ``vmap`` let ``torch.func`` transform it; a vmapped call folds the
    mapped axis into the rows (one launch)."""

    @staticmethod
    def forward(logits, labels):
        logits = logits.contiguous()
        lse = fused_lse(logits)
        return _nll(logits, labels.long(), lse), lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, labels = inputs
        ctx.save_for_backward(logits.contiguous(), labels.long(), output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def vmap(info, in_dims, logits, labels):
        logits, labels = _build.batch_first(info, in_dims, logits, labels)
        b, n, v = logits.shape
        nll, lse = _CrossEntropy.apply(logits.reshape(b * n, v),
                                       labels.reshape(b * n))
        return (nll.reshape(b, n), lse.reshape(b, n)), (0, 0)

    @staticmethod
    def backward(ctx, g, _glse):
        logits, lab, lse = ctx.saved_tensors
        # softmax from the saved lse, minus the one-hot, times g: built
        # in place in one f32 (N, V) buffer
        d = (logits.float() - lse[:, None]).exp_()
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, lab.clamp(min=0)] -= (lab >= 0).float()
        d.mul_(torch.where(lab >= 0, g.float(), 0.0)[:, None])
        return d.to(logits.dtype), None


def cross_entropy_with_logits(logits, labels):
    """Per-row sparse-label NLL ``lse(logits) - logits[i, labels[i]]``.

    logits: (N, V) float32 or bfloat16; labels: (N,) integer. Returns
    (N,) f32, differentiable in the logits. Rows with a negative label
    get loss 0 and no gradient (ignore-index)."""
    if logits.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"expected (N, V) logits and (N,) labels, got "
                         f"{tuple(logits.shape)} / {tuple(labels.shape)}")
    return _CrossEntropy.apply(logits, labels)[0]


def cross_entropy_plain(logits, labels):
    """The plain version of :func:`cross_entropy_with_logits`,
    differentiable through torch autograd (``torch.logsumexp``)."""
    return _nll(logits, labels.long(), torch.logsumexp(logits.float(), -1))


_build.counted(fused_lse)
