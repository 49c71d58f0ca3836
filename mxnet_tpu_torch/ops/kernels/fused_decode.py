"""K5a / K5b and the fused paged decode step (counterpart of
``mxnet_tpu/ops/pallas/fused_decode.py``).

One attention sublayer's decode step runs as three hand-written CUDA
kernels around an in-place pool write:

- :func:`fused_qkv_project` (K5a, replaces ``_qkv_kernel``,
  ``ops/pallas/fused_decode.py:92``) — QKV projection + bias, split by
  head, and for int8 pools the per-(token, head) quantization of K and V
  straight into the pool row layout, so K and V never exist unquantized
  in device memory;
- :func:`~.paged_attention.paged_attention_kernel` (K4);
- :func:`fused_out_project` (K5b, replaces ``_out_kernel``,
  ``fused_decode.py:120``) — out projection + bias.

Like K4, both wrappers raise under grad mode when an input requires grad:
decode is inference and runs under ``no_grad``. Both projections are
bound by bytes on the H100: at decode the product
is a rank-N update (N = lanes), so the cost is reading the weights once
(7.08 MB of f32 W_qkv and 2.36 MB of W_out per layer at units 768). The
kernels live in ``csrc/fused_decode.cu``; each wrapper takes its plain
PyTorch version for CPU tensors.

K5a runs as a thread-block cluster of C blocks per (Q|K|V, head), each
block about D/C of the head's weight rows, brought into shared memory by
bulk copies (TMA) on mbarriers; the int8 amax per token is merged over
the cluster through distributed shared memory. C is the source's
``QKV_CLUSTER`` (3: 108 blocks at gpt_like's width, at most one an SM),
doubled up to 8 where a block's slab and 8 tokens of x would not fit in
shared memory; where they do not fit even at 8, one block per (Q|K|V,
head) streams the rows from device memory (the head
route). :func:`qkv_cluster` reports the choice.

K5b: block b owns R contiguous rows of W_out, one thread brings the
chunk of up to 8 tokens of activations and the block's rows into shared
memory by bulk copies through a ring of stages, each on an mbarrier, and
each warp multiplies a share of U_in of every row of a stage from shared
memory. At gpt_like's width (R 6, 128 blocks) the whole slab comes in
one copy. Where a block's rows do not fit beside the chunk (f32 U_in
4608) the ring walks them, a stage refilled as the warps release it;
where not even one group of 4 rows fits, a warp per output feature
streams its row from device memory (the row route).
:func:`out_geometry` reports the route and the ring's shape.

Gate: :func:`fused_decode_armed` reads ``MXNET_TPU_LLM_FUSED_DECODE``
(``0``/``1``/``auto``, default ``auto``). ``auto`` arms for CUDA tensors
and stays off on the CPU, as the reference's ``auto`` arms on the TPU
and stays off on the CPU; there is no cost model (the reference's is
calibrated for the TPU). Always off inside ``no_kernels`` scopes. On
CUDA, ``0`` keeps K2 and K4 but runs the QKV and out projections as
cuBLAS products: a path for comparisons, which ``chip_smoke.py`` holds
against the plain path; serving runs ``auto``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ...base import env_str
from ..nn import (_KV_SCALE_BYTES, kernels_enabled, kv_cache_quantize,
                  paged_write)
from .paged_attention import paged_attention_kernel

__all__ = ["fused_decode_armed", "fused_decode_step", "fused_qkv_project",
           "fused_out_project", "qkv_project_plain", "out_project_plain",
           "qkv_cluster", "out_geometry"]


def fused_decode_armed(device: torch.device) -> bool:
    """Should the paged decode step on ``device`` run the fused kernels?"""
    if not kernels_enabled():
        return False
    mode = env_str("MXNET_TPU_LLM_FUSED_DECODE", "auto").strip().lower()
    if mode in ("0", "off", "false", "no", ""):
        return False
    if mode in ("1", "on", "true", "yes", "force"):
        return True
    return torch.device(device).type == "cuda"


def _store(y, store_dtype):
    """(N, H, D) f32 -> the pool row layout of ``store_dtype``."""
    if store_dtype == torch.int8:
        return kv_cache_quantize(y)
    return y.to(store_dtype)


def qkv_project_plain(x, w_qkv, b_qkv, heads, store_dtype):
    """The plain PyTorch version of K5a: f32 product, then split, cast
    or quantize."""
    n, u = x.shape
    d = u // heads
    y = torch.matmul(x.float(), w_qkv.float().t())
    if b_qkv is not None:
        y = y + b_qkv.float()
    q = y[:, :u].reshape(n, heads, d).to(x.dtype)
    k = y[:, u:2 * u].reshape(n, heads, d)
    v = y[:, 2 * u:].reshape(n, heads, d)
    return q, _store(k, store_dtype), _store(v, store_dtype)


def out_project_plain(attn, w_out, b_out):
    """The plain PyTorch version of K5b."""
    y = torch.matmul(attn.float(), w_out.float().t())
    if b_out is not None:
        y = y + b_out.float()
    return y.to(attn.dtype)


def _check_dense(what, x, w, b, rows):
    n, u = x.shape
    _build.require(w.dim() == 2 and tuple(w.shape) == (rows, u), what,
                   f"weight {tuple(w.shape)} must be ({rows}, {u})")
    _build.require(b is None or tuple(b.shape) == (rows,), what,
                   f"bias must be ({rows},)")
    _build.require(x.dtype in (torch.float32, torch.bfloat16)
                   and w.dtype == x.dtype
                   and (b is None or b.dtype == x.dtype), what,
                   "x, weight and bias must share one dtype, float32 or "
                   "bfloat16")
    # 16-byte loads of every weight and activation row
    _build.require((u * x.element_size()) % 16 == 0
                   and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                   what, "rows must be 16-byte multiples on 16-byte "
                   "aligned storage")
    _build.require(x.is_contiguous() and w.is_contiguous()
                   and (b is None or b.is_contiguous()), what,
                   "inputs must be contiguous")


def qkv_cluster(u, heads, dtype):
    """K5a's cluster size on the card for (units, heads, activation
    dtype): C of the cluster route, or 0 where the head route takes the
    shape (``mxt_qkv_cluster``)."""
    c = _build.load("fused_decode").mxt_qkv_cluster(
        u, heads, _build.dtype_code(dtype))
    _build.require(c >= 0, "qkv_cluster", f"units {u} / heads {heads}")
    return c


# mxt_out_geometry's report, in its order
_OUT_GEOMETRY = ("route", "rows", "stage_groups", "stages", "slots",
                 "blocks", "smem", "threads")


def out_geometry(u_in, u_out, dtype):
    """K5b's shape on the card for (U_in, U_out, activation dtype)
    (``mxt_out_geometry``): ``route`` ``"ring"`` or ``"row"``; on the
    ring, the rows a block owns, the row groups of 4 rows a stage, the
    stages of a block's slab, the ring's slots (``walks`` when fewer than
    the stages), the blocks, the dynamic shared memory and the
    threads."""
    geo = (ctypes.c_int * len(_OUT_GEOMETRY))()
    err = _build.load("fused_decode").mxt_out_geometry(
        u_in, u_out, _build.dtype_code(dtype), geo)
    _build.require(err == 0, "out_geometry",
                   f"U_in {u_in}, U_out {u_out}, {dtype}")
    out = dict(zip(_OUT_GEOMETRY, geo))
    out["route"] = "ring" if out["route"] else "row"
    out["walks"] = out["route"] == "ring" and out["slots"] < out["stages"]
    return out


def fused_qkv_project(x, w_qkv, b_qkv, *, heads, store_dtype):
    """QKV projection + bias + KV-store conversion (K5a).

    ``x``: (N, U); ``w_qkv``: (3U, U) Dense weight (out, in), read as it
    is; ``b_qkv``: (3U,) or None. Returns ``(q, k_store, v_store)``: q
    (N, H, D) in ``x``'s dtype; k/v (N, H, D') in the pool layout —
    int8 + bitcast scale when ``store_dtype`` is int8, a cast otherwise."""
    what = "fused_qkv_project"
    tensors = [x, w_qkv] + ([b_qkv] if b_qkv is not None else [])
    _build.refuse_grad(what, *tensors)
    if _build.on_cpu(what, *tensors):
        return qkv_project_plain(x, w_qkv, b_qkv, heads, store_dtype)
    n, u = x.shape
    _build.require(u % heads == 0 and u // heads <= 256, what,
                   f"units {u} / heads {heads}")
    _check_dense(what, x, w_qkv, b_qkv, 3 * u)
    d = u // heads
    dp = d + _KV_SCALE_BYTES if store_dtype == torch.int8 else d
    lib = _build.load("fused_decode")
    q = torch.empty((n, heads, d), dtype=x.dtype, device=x.device)
    ks = torch.empty((n, heads, dp), dtype=store_dtype, device=x.device)
    vs = torch.empty_like(ks)
    with torch.cuda.device(x.device):
        err = lib.mxt_qkv_project(
            x.data_ptr(), w_qkv.data_ptr(),
            b_qkv.data_ptr() if b_qkv is not None else None,
            q.data_ptr(), ks.data_ptr(), vs.data_ptr(), n, u, heads,
            _build.dtype_code(x.dtype), _build.dtype_code(store_dtype),
            _build.stream_ptr(x.device))
    _build.check(err, what)
    fused_qkv_project.launches += 1
    return q, ks, vs


fused_qkv_project.launches = 0


def fused_out_project(attn, w_out, b_out):
    """Out projection + bias (K5b). ``attn``: (N, U_in); ``w_out``:
    (U_out, U_in) Dense weight (out, in); ``b_out``: (U_out,) or None.
    Returns (N, U_out) in ``attn``'s dtype."""
    what = "fused_out_project"
    tensors = [attn, w_out] + ([b_out] if b_out is not None else [])
    _build.refuse_grad(what, *tensors)
    if _build.on_cpu(what, *tensors):
        return out_project_plain(attn, w_out, b_out)
    n, u_in = attn.shape
    u_out = w_out.shape[0]
    _check_dense(what, attn, w_out, b_out, u_out)
    lib = _build.load("fused_decode")
    out = torch.empty((n, u_out), dtype=attn.dtype, device=attn.device)
    with torch.cuda.device(attn.device):
        err = lib.mxt_out_project(
            attn.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr() if b_out is not None else None,
            out.data_ptr(), n, u_in, u_out, _build.dtype_code(attn.dtype),
            _build.stream_ptr(attn.device))
    _build.check(err, what)
    fused_out_project.launches += 1
    return out


fused_out_project.launches = 0


def fused_decode_step(x, w_qkv, b_qkv, w_out, b_out, pool_k, pool_v,
                      block_table, positions, *, heads, units):
    """One attention sublayer's paged decode step through the fused
    kernels: K5a -> pool write -> K4 -> K5b.

    ``x``: (R, T, U) at per-lane absolute positions ``positions[r] + t``;
    pools (NB, H, bs, D') of ONE layer, written IN PLACE (the reference
    writes a functional copy, donated on the TPU); ``block_table``
    (R, MB) int32. Returns ``(out (R, T, U), pool_k, pool_v)``."""
    r, t, u = x.shape
    n = r * t
    q, ks, vs = fused_qkv_project(x.reshape(n, u), w_qkv, b_qkv,
                                  heads=heads, store_dtype=pool_k.dtype)
    bt, lengths = paged_write(pool_k, pool_v, ks, vs, block_table, positions)
    out = paged_attention_kernel(q, pool_k, pool_v, bt, lengths)
    o = fused_out_project(out.reshape(n, u).to(x.dtype), w_out, b_out)
    return o.reshape(r, t, u), pool_k, pool_v
