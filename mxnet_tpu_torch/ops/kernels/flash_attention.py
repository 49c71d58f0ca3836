"""K1 — flash attention forward and its FA2 backward (counterpart of
``mxnet_tpu/ops/pallas/flash_attention.py``).

Replaces four TPU kernels with three hand-written CUDA kernels:

- :func:`flash_forward` — one kernel in ``csrc/flash_attention.cu`` for
  ``_flash_kernel`` (K1a, ``:70``) and ``_flash_kernel_resident`` (K1b,
  ``:144``), both reached through ``_flash_forward`` (``:264``). The TPU
  bodies compute one function and differ only in how K/V reach VMEM; on
  Hopper a loop inside the block streams K/V tiles through shared memory
  at any length, with an online softmax on the scores in registers.
- :func:`flash_backward_dq` — ``_bwd_dq_kernel`` (K1c, ``:379``), in
  ``csrc/flash_attention_bwd.cu``: dQ and D = rowsum(dO * O), which it
  also writes out.
- :func:`flash_backward_dkv` — ``_bwd_dkv_kernel`` (K1d, ``:432``), in
  the same source: dK and dV, reading the D that K1c wrote (K1d
  recomputed it per block).

All three multiply on the tensor cores (``mma.sync``, building blocks
shared in ``csrc/flash_mma.cuh``). :func:`kernel_route` picks how, per
launch, from q's dtype and torch's live CUDA matmul switch, as the
reference's ``_matmul_precision`` (``:39``) picks its dots' precision
from the ambient JAX one (:mod:`mxnet_tpu_torch.base`):

- bf16: one bf16 pass (the reference's DEFAULT);
- f32 under the ``default`` policy: one TF32 pass, each operand rounded
  to nearest by ``cvt.rna`` as cuBLAS rounds (DEFAULT, the reference's
  one MXU pass);
- f32 under ``high`` or ``highest``: each operand split into a TF32 high
  and low part and multiplied in three passes (hi.hi + hi.lo + lo.hi),
  which keeps about f32 accuracy (HIGHEST).

Bound on the H100 at the main path's (8, 12, 1024, 64) causal f32, in
three TF32 passes of 495 TFLOP/s: 0.078 ms forward, 0.117 ms dQ and
0.156 ms dK/dV (operations); in one pass 0.030 (bytes), 0.045 (bytes)
and 0.052 ms (operations). The route is a property of the card's
arithmetic: CPU tensors take the exact f32 plain versions under every
policy, as torch's CPU matmuls do. The plain versions take
``round_tf32=True`` to round every product's operands as the one-pass
kernels do.

:func:`flash_attention` is the differentiable entry point, a
``torch.autograd.Function`` as the reference's is a ``jax.custom_vjp``:
its forward saves ``(q, k, v, out, lse)`` and its backward runs K1c,
then K1d. Each wrapper launches its kernel for CUDA tensors and takes
its plain version for CPU tensors. The mask is bottom-right causal,
``k <= q + (Lk - Lq)``, with the finite -1e30 of the TPU kernels; a row
that sees no key gives out = 0 and lse = -1e30.
"""
from __future__ import annotations

import torch

from . import _build
from ...base import matmul_precision

__all__ = ["flash_attention", "flash_forward", "flash_backward_dq",
           "flash_backward_dkv", "flash_forward_plain",
           "flash_backward_dq_plain", "flash_backward_dkv_plain",
           "flash_backward_plain", "mha_plain", "kernel_route", "tf32_round"]

_NEG = -1e30
_DTYPES = (torch.float32, torch.bfloat16)


def kernel_route(dtype) -> str:
    """How K1a-K1d multiply inputs of ``dtype`` on the card under the
    live policy: ``"bf16"`` (one bf16 pass), ``"tf32"`` (f32 in one TF32
    pass, the ``default`` policy) or ``"3xtf32"`` (f32 under ``high`` or
    ``highest``). The reference's ``_matmul_precision`` maps the same
    cases to DEFAULT, DEFAULT and HIGHEST."""
    if dtype == torch.bfloat16:
        return "bf16"
    return "tf32" if matmul_precision() == "default" else "3xtf32"


def tf32_round(x):
    """f32 ``x`` rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds (finite values;
    the low 13 bits come out 0)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _operand(round_tf32):
    """A product's operand in f32: as it is, or rounded to TF32."""
    return tf32_round if round_tf32 else (lambda t: t.float())


def _live(lq, lk, causal, device):
    """(Lq, Lk) bool mask of the (query, key) pairs that count."""
    if not causal:
        return torch.ones((lq, lk), dtype=torch.bool, device=device)
    return torch.ones((lq, lk), dtype=torch.bool,
                      device=device).tril(diagonal=lk - lq)


def _scale(q, sm_scale):
    return q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)


def mha_plain(q, k, v, causal=False, sm_scale=None):
    """Dense attention in f32, differentiable through torch autograd: the
    counterpart of the reference's ``_mha_reference`` (``:59``)."""
    scale = _scale(q, sm_scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_live(q.shape[2], k.shape[2], True, q.device),
                          _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_forward_plain(q, k, v, causal=False, sm_scale=None,
                        round_tf32=False):
    """The plain version of the forward kernel: ``(out, lse)``, out in
    q's dtype and lse (B, H, Lq) f32. Like the kernel it rounds p to v's
    dtype before P.V and guards ``l == 0``; with ``round_tf32`` it rounds
    q, k, v and p to TF32 before their products, as the one-pass f32
    kernel does."""
    op = _operand(round_tf32)
    scale = _scale(q, sm_scale)
    live = _live(q.shape[2], k.shape[2], causal, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", op(q), op(k)) * scale
    s = s.masked_fill(~live, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~live, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    pv = torch.einsum("bhqk,bhkd->bhqd", op(p.to(v.dtype)), op(v))
    return (pv / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _delta(out, g):
    """D = rowsum(dO * O) in f32."""
    return (g.float() * out.float()).sum(dim=-1)


def _probs(q, k, v, g, lse, delta, causal, scale, op):
    """p and ds of the FA2 backward (``pair_grads``, ``:730-746``) over
    the whole score matrix, in f32, each product's operands taken by
    ``op``."""
    live = _live(q.shape[2], k.shape[2], causal, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", op(q), op(k)) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~live, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", op(g), op(v))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def flash_backward_dq_plain(q, k, v, out, lse, g, causal=False,
                            sm_scale=None, round_tf32=False):
    """The plain version of the dQ kernel: ``(dq, delta)``. With
    ``round_tf32``, q, k, v, dO and dS are rounded to TF32 before their
    products, as the one-pass f32 kernel does."""
    op = _operand(round_tf32)
    scale = _scale(q, sm_scale)
    delta = _delta(out, g)
    _, ds = _probs(q, k, v, g, lse, delta, causal, scale, op)
    return (torch.einsum("bhqk,bhkd->bhqd", op(ds.to(q.dtype)),
                         op(k)).to(q.dtype), delta)


def flash_backward_dkv_plain(q, k, v, g, lse, delta, causal=False,
                             sm_scale=None, round_tf32=False):
    """The plain version of the dK/dV kernel: ``(dk, dv)``. With
    ``round_tf32``, q, k, v, dO, p and dS are rounded to TF32 before
    their products, as the one-pass f32 kernel does."""
    op = _operand(round_tf32)
    p, ds = _probs(q, k, v, g, lse, delta, causal, _scale(q, sm_scale), op)
    dk = torch.einsum("bhqk,bhqd->bhkd", op(ds.to(q.dtype)),
                      op(q)).to(k.dtype)
    dv = torch.einsum("bhqk,bhqd->bhkd", op(p.to(q.dtype)),
                      op(g)).to(v.dtype)
    return dk, dv


def flash_backward_plain(q, k, v, out, lse, g, causal=False, sm_scale=None,
                         round_tf32=False):
    """The plain version of the backward kernels: ``(dq, dk, dv)`` by the
    FA2 math of ``pair_grads`` from the saved lse, with p and ds rounded
    to q's dtype before their products, as the TPU kernels round (and
    every operand to TF32 with ``round_tf32``)."""
    dq, delta = flash_backward_dq_plain(q, k, v, out, lse, g, causal,
                                        sm_scale, round_tf32)
    return (dq,) + flash_backward_dkv_plain(q, k, v, g, lse, delta, causal,
                                            sm_scale, round_tf32)


def _check(what, q, k, v, *more):
    b, h, lq, d = q.shape
    _build.require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, what,
                   "q, k, v must be (B, H, L, D)")
    _build.require(k.shape[:2] == (b, h) and k.shape[3] == d
                   and tuple(v.shape) == tuple(k.shape), what,
                   f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                   f"v {tuple(v.shape)}")
    _build.require(1 <= d <= 128 and b * h <= 65535, what,
                   f"head dim {d} (1..128) or B*H {b * h} (<= 65535)")
    _build.require(q.dtype in _DTYPES and k.dtype == v.dtype == q.dtype
                   and all(t.dtype == q.dtype for t in more), what,
                   f"dtype {q.dtype}: float32 or bfloat16, one for all")
    _build.require(all(t.is_contiguous() for t in (q, k, v) + more), what,
                   "inputs must be contiguous")


def flash_forward(q, k, v, causal=False, sm_scale=None):
    """Attention forward over (B, H, L, D): ``(out, lse)``. CUDA tensors:
    the K1 forward kernel (float32 or bfloat16, D <= 128, contiguous)."""
    what = "flash_forward"
    _build.refuse_grad(what, q, k, v)
    if _build.on_cpu(what, q, k, v):
        return flash_forward_plain(q, k, v, causal, sm_scale)
    _check(what, q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    lib = _build.load("flash_attention")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mxt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, lq, lk, d, int(causal),
            _scale(q, sm_scale), _build.dtype_code(q.dtype),
            int(kernel_route(q.dtype) == "tf32"),
            _build.stream_ptr(q.device))
    _build.check(err, what)
    flash_forward.launches += 1
    return out, lse


def flash_backward_dq(q, k, v, out, lse, g, causal=False, sm_scale=None):
    """dQ of attention, and D = rowsum(dO * O) (B, H, Lq) f32 for
    :func:`flash_backward_dkv`: ``(dq, delta)``. CUDA tensors: the K1c
    kernel."""
    what = "flash_backward_dq"
    _build.refuse_grad(what, q, k, v, out, g)
    if _build.on_cpu(what, q, k, v, out, lse, g):
        return flash_backward_dq_plain(q, k, v, out, lse, g, causal,
                                       sm_scale)
    _check(what, q, k, v, out, g)
    b, h, lq, d = q.shape
    _build.require(lse.dtype == torch.float32 and lse.is_contiguous()
                   and tuple(lse.shape) == (b, h, lq), what,
                   "lse must be (B, H, Lq) float32")
    lib = _build.load("flash_attention_bwd")
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mxt_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            b * h, lq, k.shape[2], d, int(causal), _scale(q, sm_scale),
            _build.dtype_code(q.dtype), int(kernel_route(q.dtype) == "tf32"),
            _build.stream_ptr(q.device))
    _build.check(err, what)
    flash_backward_dq.launches += 1
    return dq, delta


def flash_backward_dkv(q, k, v, g, lse, delta, causal=False,
                       sm_scale=None):
    """dK and dV of attention from the saved lse and the D of
    :func:`flash_backward_dq`: ``(dk, dv)``. CUDA tensors: the K1d
    kernel."""
    what = "flash_backward_dkv"
    _build.refuse_grad(what, q, k, v, g)
    if _build.on_cpu(what, q, k, v, g, lse, delta):
        return flash_backward_dkv_plain(q, k, v, g, lse, delta, causal,
                                        sm_scale)
    _check(what, q, k, v, g)
    b, h, lq, d = q.shape
    _build.require(all(t.dtype == torch.float32 and t.is_contiguous()
                       and tuple(t.shape) == (b, h, lq)
                       for t in (lse, delta)), what,
                   "lse and delta must be (B, H, Lq) float32")
    lib = _build.load("flash_attention_bwd")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.mxt_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, lq, k.shape[2], d, int(causal), _scale(q, sm_scale),
            _build.dtype_code(q.dtype), int(kernel_route(q.dtype) == "tf32"),
            _build.stream_ptr(q.device))
    _build.check(err, what)
    flash_backward_dkv.launches += 1
    return dk, dv


class _FlashBackward(torch.autograd.Function):
    """K1c then K1d, as one Function so that ``torch.func`` hands the
    kernels plain tensors (its transforms run a Function's forward a
    level below their own wrappers); it is not differentiable again."""

    @staticmethod
    def forward(q, k, v, out, lse, g, causal, sm_scale):
        dq, delta = flash_backward_dq(q, k, v, out, lse, g, causal,
                                      sm_scale)
        dk, dv = flash_backward_dkv(q, k, v, g, lse, delta, causal,
                                    sm_scale)
        return dq, dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        raise RuntimeError("flash attention's backward is not "
                           "differentiable")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, g, causal, sm_scale):
        ts = _build.batch_first(info, in_dims[:6], q, k, v, out, lse, g)
        b = ts[0].shape[0] * ts[0].shape[1]
        grads = _FlashBackward.apply(
            *(t.reshape(b, *t.shape[2:]).contiguous() for t in ts),
            causal, sm_scale)
        return (tuple(t.reshape(info.batch_size, -1, *t.shape[1:])
                      for t in grads), (0, 0, 0))


class _FlashAttention(torch.autograd.Function):
    """K1 forward, with K1c and K1d as its backward. ``setup_context``
    and ``vmap`` let ``torch.func`` transform it; a vmapped call folds
    the mapped axis into the batch (one launch)."""

    @staticmethod
    def forward(q, k, v, causal, sm_scale):
        q, k, v = (t.contiguous() for t in (q, k, v))
        return flash_forward(q, k, v, causal, sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, sm_scale = inputs
        out, lse = output
        ctx.save_for_backward(*(t.contiguous() for t in (q, k, v)), out,
                              lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, sm_scale):
        q, k, v = _build.batch_first(info, in_dims[:3], q, k, v)
        n = info.batch_size
        out, lse = _FlashAttention.apply(
            *(t.reshape(n * t.shape[1], *t.shape[2:]) for t in (q, k, v)),
            causal, sm_scale)
        return ((out.reshape(n, -1, *out.shape[1:]),
                 lse.reshape(n, -1, *lse.shape[1:])), (0, 0))

    @staticmethod
    def backward(ctx, g, _glse):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        dq, dk, dv = _FlashBackward.apply(q, k, v, out, lse, g, ctx.causal,
                                          ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Fused attention over (batch, heads, seq, head_dim) tensors,
    differentiable in q, k and v. ``sm_scale`` defaults to D**-0.5."""
    if q.dim() != 4:
        raise ValueError(f"expected (b, h, l, d), got {tuple(q.shape)}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 _scale(q, sm_scale))[0]


_build.counted(flash_forward)
_build.counted(flash_backward_dq)
_build.counted(flash_backward_dkv)
