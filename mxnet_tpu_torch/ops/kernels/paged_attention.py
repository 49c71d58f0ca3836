"""K4 — paged decode attention (counterpart of
``mxnet_tpu/ops/pallas/paged_attention.py``).

Replaces ``_paged_kernel`` (``ops/pallas/paged_attention.py:49``,
reached through ``paged_attention_kernel``) with the hand-written CUDA
kernel in ``csrc/paged_attention.cu``, split over positions: block
(lane * head, s) owns a span of the lane's pool blocks (the source's
``PA_SPAN``), stages their K and V slices through shared memory by
16-byte ``cp.async`` copies, and computes the span's exact softmax
(finite -1e30 mask) and P.V. A lane whose live positions fit one span
writes its output directly; otherwise each span writes a partial
(m, l, acc) to a workspace and the last span of a (lane, head) to finish
merges them in span order (``max(l, 1e-30)`` denominator), so one call
is one launch and its results are bitwise repeatable. int8 pools are
dequantized in the kernel. Bound on the H100: bytes, each live K/V row
read once (at the decode step's mid-decode lengths, 8 lanes, 12 heads,
D 64, int8: 8.1 MB). It runs once per layer per decode step.

:func:`paged_attention_kernel` launches the kernel for CUDA tensors and
takes :func:`paged_attention_plain` for CPU tensors. The plain version
mirrors the reference's gather path (``ops/nn.py:1063-1084``: -inf mask
and a softmax), not the kernel's split softmax, so the two agree to a
tolerance, not bit for bit. The workspace (``R * H * S * (D + 2)``
floats and ``R * H`` counters, ``S = ceil(MB / span)``) is allocated by
the wrapper and kept per device, stream and shape; the kernel leaves
every counter at 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ..nn import kv_cache_dequantize

__all__ = ["paged_attention_kernel", "paged_attention_plain"]


def paged_attention_plain(q, k_pool, v_pool, block_table, lengths):
    """Gather each lane's blocks through its table, then dense attention
    with a per-lane length mask. Shapes as :func:`paged_attention_kernel`."""
    r, h, d = q.shape
    bs = k_pool.shape[2]
    mb = block_table.shape[1]
    bt = block_table.long()
    keys = k_pool[bt]                   # (R, MB, H, bs, D')
    vals = v_pool[bt]

    def flat(c):                        # -> (R, H, MB*bs, D')
        return c.permute(0, 2, 1, 3, 4).reshape(r, h, mb * bs, c.shape[-1])

    keys, vals = flat(keys), flat(vals)
    if k_pool.dtype == torch.int8:      # int8 rides memory; math in q's dtype
        keys = kv_cache_dequantize(keys, q.dtype)
        vals = kv_cache_dequantize(vals, q.dtype)
    ct = torch.promote_types(q.dtype, keys.dtype)   # jnp.einsum promotes
    scores = torch.einsum("rhd,rhld->rhl", q.to(ct), keys.to(ct)).float()
    scores = scores / math.sqrt(d)
    pos = torch.arange(mb * bs, device=q.device)[None, :]
    live = pos < lengths.long()[:, None]
    scores = torch.where(live[:, None, :], scores,
                         torch.full_like(scores, float("-inf")))
    attn = torch.softmax(scores, dim=-1).to(vals.dtype)
    return torch.einsum("rhl,rhld->rhd", attn, vals)


# (device, stream, R*H, S, D) -> (workspace, counters) of the kernel
_WORKSPACES = {}


def _span(lib):
    """The pool blocks one block of the kernel owns (``PA_SPAN``)."""
    span = getattr(lib, "_span_blocks", None)
    if span is None:
        out = ctypes.c_int(0)
        _build.check(lib.mxt_paged_attention_span(ctypes.byref(out)),
                     "paged_attention_kernel")
        span = lib._span_blocks = out.value
    return span


def _workspace(lib, device, stream, rows, mb, d):
    """The split kernel's partials (``rows * S * (d + 2)`` f32) and its
    per-(lane, head) counters (``rows`` int32, zeroed once; the kernel
    resets each one it uses), kept per device, stream and shape."""
    n_span = -(-mb // _span(lib))
    key = (device, stream, rows, n_span, d)
    got = _WORKSPACES.get(key)
    if got is None:
        got = _WORKSPACES[key] = (
            torch.empty(rows * n_span * (d + 2), dtype=torch.float32,
                        device=device),
            torch.zeros(rows, dtype=torch.int32, device=device))
    return got


def paged_attention_kernel(q, k_pool, v_pool, block_table, lengths):
    """Block-table decode attention.

    ``q``: (R, H, D), one token per lane; ``k_pool``/``v_pool``:
    (NB, H, bs, D') — ``D' = D`` for float pools, ``D + 4`` for int8
    pools; ``block_table``: (R, MB) int32; ``lengths``: (R,) int32, each
    >= 1 (positions at or past ``MB * bs`` never count, as on the TPU).
    Table entries must be valid block ids; the engine points unused
    entries at its trash block. Returns (R, H, D) in the pool's dtype
    (float pools) or ``q``'s dtype (int8 pools). CUDA tensors: the K4
    kernel (q float32 or bfloat16, D <= 256, D % 4 == 0 for int8 pools,
    all contiguous; two ring stages of a pool slice, ``bs * D'``
    elements, must fit in shared memory). Raises under grad mode when an
    input requires grad (decode runs under ``no_grad``)."""
    what = "paged_attention_kernel"
    _build.refuse_grad(what, q, k_pool, v_pool)
    if _build.on_cpu(what, q, k_pool, v_pool, block_table, lengths):
        return paged_attention_plain(q, k_pool, v_pool, block_table, lengths)
    r, h, d = q.shape
    nb, hp, bs, dp = k_pool.shape
    quantized = k_pool.dtype == torch.int8
    _build.require(hp == h and tuple(v_pool.shape) == tuple(k_pool.shape)
                   and v_pool.dtype == k_pool.dtype, what,
                   "pools must be (NB, H, bs, D') of one dtype")
    _build.require(d <= 256 and dp == (d + 4 if quantized else d)
                   and (not quantized or d % 4 == 0), what,
                   f"head dim {d} with pool row {dp} not supported")
    _build.require(q.dtype in (torch.float32, torch.bfloat16), what,
                   f"q dtype {q.dtype} (float32 or bfloat16)")
    _build.require(block_table.dtype == torch.int32
                   and lengths.dtype == torch.int32
                   and block_table.dim() == 2 and block_table.shape[0] == r
                   and tuple(lengths.shape) == (r,), what,
                   "block_table (R, MB) and lengths (R,) must be int32")
    _build.require(all(t.is_contiguous() for t in
                       (q, k_pool, v_pool, block_table, lengths)), what,
                   "inputs must be contiguous")
    lib = _build.load("paged_attention")
    mb = block_table.shape[1]
    out_dtype = q.dtype if quantized else v_pool.dtype
    out = torch.empty((r, h, d), dtype=out_dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = _build.stream_ptr(q.device)
        ws, counters = _workspace(lib, q.device, stream, r * h, mb, d)
        err = lib.mxt_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), r, h, bs, d, dp, mb,
            float(d) ** -0.5, _build.dtype_code(q.dtype),
            _build.dtype_code(k_pool.dtype), stream)
    _build.check(err, what)
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
