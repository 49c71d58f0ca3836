"""Contrib operator family of the PyTorch port (counterpart of
``mxnet_tpu/ops/contrib.py``): ROI ops, count sketch, sync BatchNorm, box
IoU and NMS, bipartite matching, SSD's anchors, targets and decoding,
deformable convolution, Hawkes log-likelihood, straight-through
estimators and the small probes.

Every op keeps the reference's arithmetic, in the same order where the
reference's is elementwise, written in torch on the tensors' device. No
function of the reference module reaches a Pallas kernel: XLA computes
them, or numpy on the host (``multibox_target``, ``multibox_detection``),
so torch ops are their counterparts here. Where the reference masks a
whole (bins x pixels) grid, the port reads the same windows from a table:
``roi_pooling`` from a 2-D sparse table of maxima, ``psroi_pooling`` from
a summed-area table in float64, so a Fast R-CNN or R-FCN head fits in
memory at its published shapes.

The reference's two host loops run on the device, batched over images
and anchors. What stays sequential is a loop of a fixed count of device
ops with no read on the host: the greedy matching of
:func:`multibox_target` (one pass per label row), and the NMS sweeps of
:func:`box_nms` and :func:`multibox_detection` (one pass per sorted
row). So the four detection ops run under
``torch.cuda.set_sync_debug_mode("error")``, and each replays from a
CUDA graph bitwise equal to its eager call (``chip_smoke.py``, phase
16).

``boolean_mask`` and ``index_copy`` are ``npx``'s
(:mod:`~mxnet_tpu_torch.numpy_extension`), and ``adaptive_avg_pool2d``
:mod:`.nn`'s; none is written twice.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .nn import adaptive_avg_pool2d  # noqa: F401  (the reference's name)

__all__ = [
    "roi_pooling", "roi_align", "count_sketch", "adaptive_avg_pool2d",
    "sync_batch_norm", "box_iou", "box_nms", "bipartite_matching",
    "allclose", "index_array", "multibox_prior", "deformable_convolution",
    "modulated_deformable_convolution", "hawkes_ll", "gradientmultiplier",
    "multibox_target", "multibox_detection", "round_ste", "sign_ste",
    "khatri_rao", "quadratic", "all_finite", "multi_all_finite",
    "multi_sum_sq", "nnz", "bilinear_resize_2d", "psroi_pooling",
]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _div(x, n):
    """``x / n`` with ``n`` a 0-d tensor on x's device: CUDA takes a Python
    divisor as a product with its reciprocal (a rounding apart from the
    quotient, which moves a bin edge or a sample across a pixel), the
    CPU and the reference divide."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def _roi_fields(rois, batch):
    """Batch index (clamped into range, as the reference's gather) and
    the four coordinates of (N, 5) rois, in float32."""
    r = rois.float()
    b = r[:, 0].to(torch.int32).long().clamp(0, batch - 1)
    return b, r[:, 1], r[:, 2], r[:, 3], r[:, 4]


def _bin_ranges(start, size, n, extent):
    """[floor(start + i*bin), ceil(start + (i+1)*bin)) for i < n, clipped
    to [0, extent): (R, n) int64 lows and highs."""
    i = torch.arange(n, dtype=torch.float32, device=start.device)
    lo = torch.floor(start[:, None] + i * size[:, None])
    hi = torch.ceil(start[:, None] + (i + 1) * size[:, None])
    return (lo.clamp(0, extent).long(), hi.clamp(0, extent).long())


# ---------------------------------------------------------------------------
# ROI ops (reference contrib/roi_align.cc, operator/roi_pooling.cc)
# ---------------------------------------------------------------------------
def _floor_log2(n, device):
    """floor(log2(k)) for k in 0..n (0 for k = 0), int64."""
    k = torch.arange(n + 1, device=device)
    lg = torch.zeros(n + 1, dtype=torch.long, device=device)
    for bit in range(1, max(n, 1).bit_length()):
        lg += (k >= (1 << bit)).long()
    return lg


def _max_table(x):
    """The 2-D sparse table of maxima of x (B, C, H, W): entry (ky, kx,
    b, y, x) holds max over rows [y, y + 2**ky) and columns
    [x, x + 2**kx) of image b, as (LY * LX * B * H * W, C) rows."""
    B, C, H, W = x.shape
    ly, lx = H.bit_length(), W.bit_length()
    levels_y = [x.permute(0, 2, 3, 1)]                  # (B, H, W, C)
    for k in range(1, ly):
        p, s = levels_y[-1], 1 << (k - 1)
        levels_y.append(torch.cat([torch.maximum(p[:, :H - s], p[:, s:]),
                                   p[:, H - s:]], 1))
    table = []
    for t in levels_y:
        levels_x = [t]
        for k in range(1, lx):
            p, s = levels_x[-1], 1 << (k - 1)
            levels_x.append(torch.cat(
                [torch.maximum(p[:, :, :W - s], p[:, :, s:]),
                 p[:, :, W - s:]], 2))
        table.append(torch.stack(levels_x))
    return torch.stack(table).reshape(-1, C), lx


def roi_pooling(data, rois, pooled_size, spatial_scale=1.0):
    """Max-pool each ROI onto a fixed (ph, pw) grid.

    data: (B, C, H, W); rois: (N, 5) of [batch_idx, x1, y1, x2, y2] in
    image coordinates (multiplied by ``spatial_scale``, quantized like the
    reference: round and an inclusive end, bins split by floor/ceil); an
    empty bin gives 0. Each bin is the maximum of four overlapping
    power-of-two windows of a 2-D sparse table (:func:`_max_table`)."""
    ph, pw = pooled_size
    B, C, H, W = data.shape
    dev = data.device
    b, x1, y1, x2, y2 = _roi_fields(rois, B)
    x1, y1 = torch.round(x1 * spatial_scale), torch.round(y1 * spatial_scale)
    x2, y2 = torch.round(x2 * spatial_scale), torch.round(y2 * spatial_scale)
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)
    ylo, yhi = _bin_ranges(y1, _div(rh, ph), ph, H)     # (N, ph)
    xlo, xhi = _bin_ranges(x1, _div(rw, pw), pw, W)     # (N, pw)
    table, lx = _max_table(data)
    lgy, lgx = _floor_log2(H, dev), _floor_log2(W, dev)
    ky = lgy[(yhi - ylo).clamp(min=1)]
    kx = lgx[(xhi - xlo).clamp(min=1)]
    # an empty bin may start at the edge: its (unused) reads stay inside
    ya, yb = ylo.clamp(max=H - 1), (yhi - torch.pow(2, ky)).clamp(min=0)
    xa, xb = xlo.clamp(max=W - 1), (xhi - torch.pow(2, kx)).clamp(min=0)

    def row(yy, xx):                                    # (N, ph, pw, C)
        lvl = ky[:, :, None] * lx + kx[:, None, :]
        idx = (((lvl * B + b[:, None, None]) * H + yy[:, :, None]) * W
               + xx[:, None, :])
        return table.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (C,))

    out = torch.maximum(torch.maximum(row(ya, xa), row(ya, xb)),
                        torch.maximum(row(yb, xa), row(yb, xb)))
    empty = ((yhi <= ylo)[:, :, None] | (xhi <= xlo)[:, None, :])
    out = torch.where(empty[..., None], torch.zeros((), dtype=out.dtype,
                                                    device=dev), out)
    return out.permute(0, 3, 1, 2)


def roi_align(data, rois, pooled_size, spatial_scale=1.0, sample_ratio=2,
              aligned=False):
    """Bilinear ROI align (Mask R-CNN; reference contrib/roi_align.cc).

    Averages ``sample_ratio**2`` bilinear samples per output bin, each a
    gather of four rows of the channels-last map. With ``aligned=True``
    applies the half-pixel offset correction."""
    ph, pw = pooled_size
    sr = int(sample_ratio) if sample_ratio > 0 else 2
    B, C, H, W = data.shape
    dev = data.device
    offset = 0.5 if aligned else 0.0
    b, x1, y1, x2, y2 = _roi_fields(rois, B)
    x1 = x1 * spatial_scale - offset
    y1 = y1 * spatial_scale - offset
    x2 = x2 * spatial_scale - offset
    y2 = y2 * spatial_scale - offset
    rh, rw = y2 - y1, x2 - x1
    if not aligned:
        rh, rw = torch.clamp(rh, min=1.0), torch.clamp(rw, min=1.0)
    bin_h, bin_w = _div(rh, ph), _div(rw, pw)
    f32 = dict(dtype=torch.float32, device=dev)
    n = (-1, 1, 1, 1, 1)
    iy = torch.arange(ph, **f32)[:, None, None, None]
    ix = torch.arange(pw, **f32)[None, :, None, None]
    sy = torch.arange(sr, **f32)[None, None, :, None]
    sx = torch.arange(sr, **f32)[None, None, None, :]
    bh, bw = bin_h.reshape(n), bin_w.reshape(n)
    y = y1.reshape(n) + iy * bh + _div((sy + 0.5) * bh, sr)  # (N,ph,1,sr,1)
    x = x1.reshape(n) + ix * bw + _div((sx + 0.5) * bw, sr)  # (N,1,pw,1,sr)
    y = torch.clamp(y, 0.0, H - 1.0)
    x = torch.clamp(x, 0.0, W - 1.0)
    y0, x0 = torch.floor(y).long(), torch.floor(x).long()
    y1i, x1i = torch.clamp(y0 + 1, max=H - 1), torch.clamp(x0 + 1, max=W - 1)
    wy1, wx1 = y - y0, x - x0
    rows = data.permute(0, 2, 3, 1).reshape(B * H * W, C)
    base = b.reshape(n) * H

    def v(yy, xx):                                      # (N,ph,pw,sr,sr,C)
        idx = ((base + yy) * W + xx).expand(-1, ph, pw, sr, sr)
        return rows.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (C,))

    wy0, wx0 = (1 - wy1)[..., None], (1 - wx1)[..., None]
    wy1, wx1 = wy1[..., None], wx1[..., None]
    samp = (v(y0, x0) * wy0 * wx0 + v(y0, x1i) * wy0 * wx1
            + v(y1i, x0) * wy1 * wx0 + v(y1i, x1i) * wy1 * wx1)
    return samp.mean(dim=(3, 4)).permute(0, 3, 1, 2)


def psroi_pooling(data, rois, output_dim, pooled_size, spatial_scale=1.0,
                  group_size=None):
    """Position-sensitive ROI average pooling (reference
    contrib/psroi_pooling.cc, the R-FCN head): output bin (i, j) of
    output channel d averages input channel d*G*G + gi*G + gj (gi =
    i*G//P) over the bin's region, from a summed-area table kept in
    float64. data (B, C, H, W) with C == output_dim * G * G; rois (N, 5)
    [batch_idx, x1, y1, x2, y2], rounded, scaled by spatial_scale."""
    g = int(group_size or pooled_size)
    p = int(pooled_size)
    B, C, H, W = data.shape
    dev = data.device
    if C != output_dim * g * g:
        raise MXNetError(
            f"psroi_pooling: channels {C} != output_dim*group_size^2 "
            f"({output_dim}*{g}^2)")
    b, x1, y1, x2, y2 = _roi_fields(rois, B)
    x1 = torch.round(x1) * spatial_scale
    y1 = torch.round(y1) * spatial_scale
    x2 = (torch.round(x2) + 1.0) * spatial_scale
    y2 = (torch.round(y2) + 1.0) * spatial_scale
    rh = torch.clamp(y2 - y1, min=0.1)
    rw = torch.clamp(x2 - x1, min=0.1)
    ylo, yhi = _bin_ranges(y1, _div(rh, p), p, H)       # (N, p)
    xlo, xhi = _bin_ranges(x1, _div(rw, p), p, W)
    sat = torch.nn.functional.pad(
        data.double().cumsum(2).cumsum(3), (1, 0, 1, 0)).reshape(-1)
    gi = (torch.arange(p, device=dev) * g) // p
    d = torch.arange(output_dim, device=dev)
    ch = (d[:, None, None] * g + gi[None, :, None]) * g + gi[None, None, :]
    plane = (b[:, None, None, None] * C + ch[None]) * (H + 1)  # (N,D,p,p)

    def at(yy, xx):
        idx = (plane + yy[:, None, :, None]) * (W + 1) + xx[:, None, None, :]
        return sat.index_select(0, idx.reshape(-1)).reshape(idx.shape)

    total = at(yhi, xhi) - at(ylo, xhi) - at(yhi, xlo) + at(ylo, xlo)
    count = ((yhi - ylo)[:, :, None] * (xhi - xlo)[:, None, :])[:, None]
    out = torch.where(count > 0, total / count.clamp(min=1), 0.0)
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# sketching (reference contrib/count_sketch.cc)
# ---------------------------------------------------------------------------
def count_sketch(data, h, s, out_dim):
    """Count-sketch projection (reference contrib/count_sketch.cc):
    ``out[..., h[i]] += s[i] * data[..., i]``, an ``index_add``."""
    h = torch.as_tensor(h, device=data.device).reshape(-1).long()
    s = torch.as_tensor(s, device=data.device).reshape(-1).to(data.dtype)
    signed = data * s
    out = torch.zeros(data.shape[:-1] + (out_dim,), dtype=data.dtype,
                      device=data.device)
    return out.index_add(-1, h, signed)


# ---------------------------------------------------------------------------
# sync batch norm (reference contrib/sync_batch_norm.cc)
# ---------------------------------------------------------------------------
def sync_batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-3,
                    momentum=0.9, axis_name=None, training=True):
    """BatchNorm whose batch statistics the reference averages across the
    mesh axis ``axis_name``. On one card (no ``axis_name``) it is the
    local BatchNorm; an ``axis_name`` raises :class:`MXNetError`, as the
    port has no mesh yet (``ROADMAP.md`` §1 item 8).

    ``training=True``: normalize with the batch statistics and return
    momentum-updated moving statistics; ``training=False``: normalize
    with the moving statistics. Returns (out, mean_used, var_used,
    new_moving_mean, new_moving_var)."""
    if axis_name is not None:
        raise MXNetError(
            f"sync_batch_norm(axis_name={axis_name!r}): the port has no "
            "device mesh yet (ROADMAP.md §1 item 8, parallel/); on one "
            "card call it without axis_name")
    shape = [1, -1] + [1] * (x.dim() - 2)
    if not training:
        if moving_mean is None or moving_var is None:
            raise MXNetError("sync_batch_norm inference needs moving stats")
        mean, var = moving_mean, moving_var
        xhat = (x - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + eps)
        return (xhat * gamma.reshape(shape) + beta.reshape(shape),
                mean, var, moving_mean, moving_var)
    red = tuple(i for i in range(x.dim()) if i != 1)
    mean = x.mean(red)
    sq = (x * x).mean(red)
    var = sq - mean * mean
    if moving_mean is not None and moving_var is not None:
        new_mm = momentum * moving_mean + (1.0 - momentum) * mean
        new_mv = momentum * moving_var + (1.0 - momentum) * var
    else:
        new_mm, new_mv = mean, var
    xhat = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    return (xhat * gamma.reshape(shape) + beta.reshape(shape),
            mean, var, new_mm, new_mv)


# ---------------------------------------------------------------------------
# detection utilities (reference contrib/bounding_box.cc, multibox_*.cc)
# ---------------------------------------------------------------------------
def box_iou(lhs, rhs, fmt="corner"):
    """Pairwise IoU of (N, 4) x (M, 4) boxes (reference box_iou)."""
    if fmt == "center":
        def to_corner(b):
            cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
            return torch.stack([cx - w / 2, cy - h / 2,
                                cx + w / 2, cy + h / 2], -1)
        lhs, rhs = to_corner(lhs), to_corner(rhs)
    tl = torch.maximum(lhs[:, None, :2], rhs[None, :, :2])
    br = torch.minimum(lhs[:, None, 2:], rhs[None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_l = ((lhs[:, 2] - lhs[:, 0]) * (lhs[:, 3] - lhs[:, 1]))[:, None]
    area_r = ((rhs[:, 2] - rhs[:, 0]) * (rhs[:, 3] - rhs[:, 1]))[None, :]
    return inter / torch.clamp(area_l + area_r - inter, min=1e-12)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            score_index=1, coord_start=2):
    """Greedy non-max suppression (reference box_nms): rows are
    [class?, score, x1, y1, x2, y2, ...]; suppressed and invalid rows come
    back as -1, survivors sorted by score. The sweep is one masked update
    per sorted row (``topk`` rows when given: later rows are invalid),
    with no read on the host."""
    n = data.shape[0]
    scores = data[:, score_index]
    order = torch.argsort(-scores, stable=True)
    data_s = data.index_select(0, order)
    boxes_s = data_s[:, coord_start:coord_start + 4]
    ar = torch.arange(n, device=data.device)
    valid = data_s[:, score_index] > valid_thresh
    if topk > 0:
        valid = valid & (ar < topk)
    later = ar[None, :] > ar[:, None]
    sup = (box_iou(boxes_s, boxes_s) > overlap_thresh) & later
    keep = valid
    for i in range(n if topk <= 0 else min(n, topk)):
        keep = keep & ~(sup[i] & keep[i])
    return torch.where(keep[:, None], data_s, -1.0)


def bipartite_matching(score, threshold=1e-12, topk=-1, is_ascend=False):
    """Greedy bipartite matching over an (N, M) score matrix (reference
    contrib/bipartite_matching): repeatedly take the globally best pair,
    retire its row and column; min(N, M) (or ``topk``) masked passes on
    the device. Returns (row->col, col->row) int32 index vectors with -1
    for unmatched."""
    n, m = score.shape
    k = min(n, m) if topk <= 0 else min(topk, min(n, m))
    dev = score.device
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    rowmatch = torch.full((n,), -1, dtype=torch.int32, device=dev)
    colmatch = torch.full((m,), -1, dtype=torch.int32, device=dev)
    worst = math.inf if is_ascend else -math.inf
    s = score
    for _ in range(k):
        flat = s.reshape(-1)
        best = (flat.argmin() if is_ascend else flat.argmax()).reshape(1)
        val = flat.index_select(0, best)
        r, c = best // m, best % m
        good = (val < threshold) if is_ascend else (val > threshold)
        rowmatch = torch.where(good & (rows == r), c.to(torch.int32),
                               rowmatch)
        colmatch = torch.where(good & (cols == c), r.to(torch.int32),
                               colmatch)
        s = torch.where(good & ((rows[:, None] == r) | (cols[None, :] == c)),
                        worst, s)
    return rowmatch, colmatch


def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), steps=(-1.0, -1.0),
                   offsets=(0.5, 0.5), clip=False):
    """SSD anchor generation (reference contrib/multibox_prior.cc): per
    feature-map cell, anchors for sizes[0] x ratios plus the extra sizes
    at ratio 1, ``len(sizes) + len(ratios) - 1`` anchors a cell, as
    (1, H * W * anchors, 4) corner boxes."""
    H, W = data.shape[-2:]
    f32 = dict(dtype=torch.float32, device=data.device)
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (torch.arange(H, **f32) + offsets[0]) * step_y
    cx = (torch.arange(W, **f32) + offsets[1]) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    whs = [(sizes[0] * math.sqrt(r), sizes[0] / math.sqrt(r))
           for r in ratios]
    whs += [(s * math.sqrt(ratios[0]), s / math.sqrt(ratios[0]))
            for s in sizes[1:]]
    out = torch.stack([torch.stack([cxg - w / 2, cyg - h / 2, cxg + w / 2,
                                    cyg + h / 2], -1) for w, h in whs],
                      2).reshape(1, -1, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def _iou_corner(a, b):
    """IoU of [l, t, r, b] boxes a (..., N, 4) against b (..., M, 4) ->
    (..., N, M), zero where the union is not positive (the reference's
    host helper, in its order of operations)."""
    iw = torch.clamp(torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
                     - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]),
                     min=0.0)
    ih = torch.clamp(torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
                     - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]),
                     min=0.0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def _centers(boxes):
    """Widths, heights and centres of corner boxes (..., 4)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w, h, (boxes[..., 0] + boxes[..., 2]) * 0.5,
            (boxes[..., 1] + boxes[..., 3]) * 0.5)


def _first_argmax(x, dim):
    """Index of the first maximum along ``dim``, and the maximum."""
    idx = x.argmax(dim, keepdim=True)
    return idx.squeeze(dim), x.gather(dim, idx).squeeze(dim)


def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training-target assignment (reference multibox_target.cc:72).

    anchor (1, A, 4) corner boxes shared over the batch; label (B, L, 5+)
    rows ``[cls, l, t, r, b, ...]`` padded with -1; cls_pred (B, C, A)
    raw class scores (used only by negative mining). Returns (loc_target
    (B, A*4), loc_mask (B, A*4), cls_target (B, A)), float32, no
    gradient.

    The reference's host loops, on the device and batched over images:
    the greedy bipartite matching is L passes (one per label row) of
    "take the first largest IoU among unmatched anchors and ground
    truths", each pass a no-op once nothing above 1e-6 is left; the
    threshold matching, the hard-negative choice (a stable sort of the
    background probability, computed in float64, over the candidates)
    and the encoding are whole-tensor ops. Nothing is read on the host.
    """
    with torch.no_grad():
        dev = cls_pred.device
        anchors = torch.as_tensor(anchor, device=dev).reshape(-1, 4).float()
        labels = torch.as_tensor(label, device=dev).float()
        preds = torch.as_tensor(cls_pred, device=dev).float()
        B, L = labels.shape[:2]
        A = anchors.shape[0]
        vx, vy, vw, vh = variances
        valid = labels[:, :, 0] != -1.0                         # (B, L)
        gt = labels[:, :, 1:5]
        overlaps = torch.where(valid[:, None, :],
                               _iou_corner(anchors[None], gt), -1.0)
        ar_a = torch.arange(A, device=dev)
        ar_l = torch.arange(L, device=dev)
        flag = torch.zeros((B, A), dtype=torch.bool, device=dev)
        gt_done = ~valid
        matches = torch.full((B, A), -1, dtype=torch.long, device=dev)
        match_iou = torch.full((B, A), -1.0, device=dev)
        for _ in range(L):                     # greedy bipartite matching
            ov = overlaps.masked_fill(flag[:, :, None] | gt_done[:, None, :],
                                      -1.0)
            flat, best = _first_argmax(ov.reshape(B, -1), 1)
            good = best > 1e-6
            j, k = flat // L, flat % L
            hit = good[:, None] & (ar_a[None, :] == j[:, None])
            matches = torch.where(hit, k[:, None], matches)
            match_iou = torch.where(hit, best[:, None], match_iou)
            flag = flag | hit
            gt_done = gt_done | (good[:, None] & (ar_l[None, :] == k[:, None]))
        if overlap_threshold > 0:
            k, best = _first_argmax(overlaps, 2)                # (B, A)
            free = ~flag
            matches = torch.where(free, k, matches)
            match_iou = torch.where(free, best, match_iou)
            flag = flag | (free & (best > overlap_threshold))
        if negative_mining_ratio > 0:
            num_pos = flag.sum(1)
            num_neg = torch.floor(num_pos.double() * negative_mining_ratio
                                  ).long()
            num_neg = torch.minimum(num_neg, A - num_pos).clamp(
                min=int(minimum_negative_samples))
            cand = ~flag & (match_iou < negative_mining_thresh)
            p_bg = torch.softmax(preds.double(), dim=1)[:, 0]   # (B, A)
            key = torch.where(cand, p_bg, math.inf)
            order = torch.argsort(key, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, ar_a.expand(B, A).contiguous())
            neg = cand & (rank < num_neg[:, None])
        else:
            neg = ~flag
        idx = matches.clamp(min=0)
        cls_gt = labels[:, :, 0].gather(1, idx)
        cls_target = torch.full((B, A), float(ignore_label), device=dev)
        cls_target = torch.where(neg, 0.0, cls_target)
        cls_target = torch.where(flag, cls_gt + 1, cls_target)
        cls_target = torch.where(valid.any(1)[:, None], cls_target, 0.0)
        g = gt.gather(1, idx[:, :, None].expand(B, A, 4))
        aw, ah, ax, ay = _centers(anchors)
        gw, gh, gx, gy = _centers(g)
        enc = torch.stack([
            _div((gx - ax) / aw, vx), _div((gy - ay) / ah, vy),
            _div(torch.log(torch.clamp(gw / aw, min=1e-12)), vw),
            _div(torch.log(torch.clamp(gh / ah, min=1e-12)), vh)], -1)
        pos = flag[:, :, None]
        loc_target = torch.where(pos, enc, 0.0).reshape(B, A * 4)
        loc_mask = pos.expand(B, A, 4).float().reshape(B, A * 4)
    return loc_target, loc_mask, cls_target


# the pairwise suppression matrix is built this many (image, row, column)
# entries at a time, so its float temporaries stay near 64 MiB
_NMS_CHUNK = 1 << 24


def multibox_detection(cls_prob, loc_pred, anchor, threshold=0.01,
                       clip=True, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_threshold=0.5, force_suppress=False,
                       nms_topk=-1):
    """SSD detection decode and per-class NMS (reference
    multibox_detection.cc:83): cls_prob (B, C, A) softmax probabilities,
    loc_pred (B, A*4) encoded offsets, anchor (1, A, 4). Returns (B, A, 6)
    rows ``[class_id, score, l, t, r, b]``, the kept detections first in
    descending score (stable), suppressed rows with class_id -1 and the
    rest all -1.

    On the device, batched over images: a stable sort by score, the
    pairwise "same class and IoU at or above the threshold" matrix of
    the first ``nms_topk`` rows (all rows without it), then one masked
    pass per row that retires the later rows a surviving row
    suppresses. Nothing is read on the host."""
    with torch.no_grad():
        dev = cls_prob.device
        B, C, A = cls_prob.shape
        vx, vy, vw, vh = variances
        anchors = torch.as_tensor(anchor, device=dev).reshape(-1, 4).float()
        p = loc_pred.float().reshape(B, A, 4)
        aw, ah, ax, ay = _centers(anchors)
        ox = p[..., 0] * vx * aw + ax
        oy = p[..., 1] * vy * ah + ay
        ow = torch.exp(p[..., 2] * vw) * aw / 2
        oh = torch.exp(p[..., 3] * vh) * ah / 2
        boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], -1)
        if clip:
            boxes = torch.clamp(boxes, 0.0, 1.0)
        if C > 1:
            ids, scores = _first_argmax(cls_prob[:, 1:].float(), 1)
        else:
            ids = torch.zeros((B, A), dtype=torch.long, device=dev)
            scores = torch.zeros((B, A), device=dev)
        keep = scores >= threshold
        order = torch.argsort(torch.where(keep, -scores, math.inf), dim=1,
                              stable=True)
        K = min(A, nms_topk) if nms_topk > 0 else A
        order = order[:, :K]
        valid = torch.arange(K, device=dev)[None, :] < keep.sum(1)[:, None]
        cls = torch.where(valid, ids.gather(1, order).float(), -1.0)
        score_s = scores.gather(1, order)
        boxes_s = boxes.gather(1, order[:, :, None].expand(B, K, 4))
        sup = torch.empty((B, K, K), dtype=torch.bool, device=dev)
        rows = max(1, _NMS_CHUNK // max(B * K, 1))
        later = torch.arange(K, device=dev)
        for r0 in range(0, K, rows):
            r1 = min(K, r0 + rows)
            s = _iou_corner(boxes_s[:, r0:r1], boxes_s) >= nms_threshold
            if not force_suppress:
                s = s & (cls[:, r0:r1, None] == cls[:, None, :])
            sup[:, r0:r1] = s & (later[None, :] > later[r0:r1, None])
        for i in range(K):
            alive = cls[:, i:i + 1] >= 0
            cls = cls.masked_fill(sup[:, i] & alive & (cls >= 0), -1.0)
        dets = torch.cat([cls[..., None], score_s[..., None], boxes_s], -1)
        out = torch.full((B, A, 6), -1.0, device=dev)
        out[:, :K] = torch.where(valid[..., None], dets, -1.0)
    return out


# ---------------------------------------------------------------------------
# misc (reference contrib/allclose_op.cc, index_array.cc)
# ---------------------------------------------------------------------------
def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """Whether every ``|a - b| <= atol + rtol * |b|``, as a 0-d bool
    tensor (the reference's array)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    dt = torch.promote_types(a.dtype, b.dtype)
    if not dt.is_floating_point and not dt.is_complex:
        dt = torch.get_default_dtype()
    return torch.isclose(a.to(dt), b.to(dt).to(a.device), rtol=rtol,
                         atol=atol, equal_nan=equal_nan).all()


def index_array(data, axes=None):
    """Per-element coordinate array (reference contrib/index_array.cc):
    out[i_0,...,i_k] = [i_0,...,i_k] (or the ``axes`` subset), int64."""
    shape = tuple(data.shape)
    axes = tuple(range(len(shape))) if axes is None else tuple(axes)
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.int64,
                                          device=data.device)
                             for s in shape], indexing="ij")
    return torch.stack([grids[a] for a in axes], dim=-1)


# ---------------------------------------------------------------------------
# deformable convolution (reference contrib/deformable_convolution.cc
# DCNv1, contrib/modulated_deformable_convolution.cc DCNv2)
# ---------------------------------------------------------------------------
def deformable_convolution(data, offset, weight, bias=None, kernel=None,
                           stride=1, dilate=1, pad=0, num_filter=None,
                           num_group=1, num_deformable_group=1, mask=None,
                           no_bias=False):
    """Deformable convolution v1/v2.

    data (B, C, H, W); offset (B, 2*kh*kw*ndg, OH, OW) ordered
    [y0, x0, y1, x1, ...] per deformable group (reference
    deformable_im2col.h coordinate order); weight (O, C/g, kh, kw);
    ``mask`` (B, kh*kw*ndg, OH, OW) enables the DCNv2 modulated variant.
    The sampled columns are four gathers of the map, zero outside it,
    weighted bilinearly; the product is one batched matmul per group, as
    the reference's einsum (kernel defaults to the weight's)."""
    kh, kw = _pair(kernel) if kernel is not None else tuple(weight.shape[2:])
    sh, sw = _pair(stride)
    dh, dw = _pair(dilate)
    ph, pw = _pair(pad)
    B, C, H, W = data.shape
    OH = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    OW = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    ndg = num_deformable_group
    if C % ndg or (offset.shape[1] != 2 * kh * kw * ndg):
        raise MXNetError(
            f"deformable_convolution: offset channels {offset.shape[1]} != "
            f"2*kh*kw*num_deformable_group = {2 * kh * kw * ndg}")
    K, cg = kh * kw, C // ndg
    f32 = dict(dtype=torch.float32, device=data.device)
    oy = torch.arange(OH, **f32) * sh - ph
    ox = torch.arange(OW, **f32) * sw - pw
    ky = torch.arange(kh, **f32) * dh
    kx = torch.arange(kw, **f32) * dw
    base_y = (ky[:, None, None, None] + oy[None, None, :, None]).expand(
        kh, kw, OH, OW).reshape(K, OH, OW)
    base_x = (kx[None, :, None, None] + ox[None, None, None, :]).expand(
        kh, kw, OH, OW).reshape(K, OH, OW)
    off = offset.reshape(B, ndg, K, 2, OH, OW)
    ys = base_y + off[:, :, :, 0]                 # (B, ndg, K, OH, OW)
    xs = base_x + off[:, :, :, 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    maps = data.reshape(B, ndg, cg, H * W)
    P = K * OH * OW
    cols = 0.0
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yi, xi = y0 + dy, x0 + dx
            inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            v = maps.gather(3, idx.reshape(B, ndg, 1, P).expand(
                B, ndg, cg, P))
            cols = cols + v * (wy * wx * inside).reshape(B, ndg, 1, P)
    cols = cols.reshape(B, ndg, cg, K, OH * OW)
    if mask is not None:
        cols = cols * mask.reshape(B, ndg, 1, K, OH * OW)
    O, g = weight.shape[0], num_group
    cols = cols.reshape(B, g, (C // g) * K, OH * OW)
    w = weight.reshape(g, O // g, (C // g) * K)
    y = torch.matmul(w[None], cols).reshape(B, O, OH, OW)
    if bias is not None and not no_bias:
        y = y + bias.reshape(1, -1, 1, 1)
    return y


def modulated_deformable_convolution(data, offset, mask, weight, bias=None,
                                     **kw):
    """DCNv2 (reference contrib/modulated_deformable_convolution.cc):
    deformable convolution with a learned per-sample modulation mask."""
    return deformable_convolution(data, offset, weight, bias=bias, mask=mask,
                                  **kw)


# ---------------------------------------------------------------------------
# Hawkes process log-likelihood (reference contrib/hawkes_ll-inl.h)
# ---------------------------------------------------------------------------
def hawkes_ll(mu, alpha, beta, state, lags, marks, valid_length, max_time):
    """Log-likelihood of a marked self-exciting Hawkes process.

    mu (N, K) background intensities; alpha/beta (K,) branching ratio and
    decay; state (N, K) initial states; lags (N, T) interarrival times;
    marks (N, T) ints; valid_length (N,); max_time (N,). Returns
    (log_likelihood (N,), out_state (N, K)) by the reference's recursion
    (hawkes_ll-inl.h:113-160): a loop over the T events, batched over
    the N sequences, each step updating the mark's entry only."""
    N, K = mu.shape
    T = lags.shape[1]
    dev = mu.device
    marks = torch.as_tensor(marks, device=dev).long()
    ll = torch.zeros(N, dtype=mu.dtype, device=dev)
    t = torch.zeros(N, dtype=mu.dtype, device=dev)
    s = state
    last = torch.zeros((N, K), dtype=mu.dtype, device=dev)
    ks = torch.arange(K, device=dev)
    for j in range(T):
        on = j < valid_length
        mark = marks[:, j]
        oh = ks[None, :] == mark[:, None]
        t_new = t + lags[:, j]
        at = mark[:, None]
        last_m = last.gather(1, at)[:, 0]
        b, a = beta[mark], alpha[mark]
        m_, sc = mu.gather(1, at)[:, 0], s.gather(1, at)[:, 0]
        d = t_new - last_m
        ed = torch.exp(-b * d)
        lda = m_ + a * b * sc * ed
        comp = m_ * d + a * sc * (1.0 - ed)
        ll_new = ll + torch.log(lda) - comp
        s_new = torch.where(oh, s + (1.0 + sc * ed - sc)[:, None], s)
        last_new = torch.where(oh, last + (t_new - last_m)[:, None], last)
        ll = torch.where(on, ll_new, ll)
        t = torch.where(on, t_new, t)
        s = torch.where(on[:, None], s_new, s)
        last = torch.where(on[:, None], last_new, last)
    d = max_time[:, None] - last
    ed = torch.exp(-beta * d)
    rem = mu * d + alpha * s * (1.0 - ed)
    return ll - rem.sum(-1), s * ed


# ---------------------------------------------------------------------------
# gradient multiplier and straight-through estimators (reference
# contrib/gradient_multiplier_op.cc, contrib/stes_op.cc)
# ---------------------------------------------------------------------------
class _GradMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scalar):
        ctx.scalar = scalar
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


def gradientmultiplier(data, scalar=1.0):
    """Identity forward; backward scales the gradient by ``scalar``
    (reference contrib/gradient_multiplier_op.cc:73-90; a negative scalar
    gives the DANN gradient-reversal layer)."""
    return _GradMultiplier.apply(data, float(scalar))


def _round_half_away(x):
    # the reference rounds half AWAY from zero (std::roundf), not
    # torch's half-to-even
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_half_away(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _SignSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.sign(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(data):
    """round(x) forward (half away from zero, the reference's),
    straight-through identity gradient."""
    return _RoundSTE.apply(data)


def sign_ste(data):
    """sign(x) forward, straight-through identity gradient."""
    return _SignSTE.apply(data)


def quadratic(data, a=0.0, b=0.0, c=0.0):
    """a*x^2 + b*x + c elementwise (reference contrib/quadratic_op.cc)."""
    return a * data * data + b * data + c


def all_finite(data, init_output=True):
    """1.0 if every element is finite else 0.0, shape (1,) (reference
    contrib/all_finite.cc, the AMP loss-scaler overflow probe)."""
    return torch.isfinite(data).all().float().reshape(1)


def multi_all_finite(*arrays, num_arrays=None):
    """all_finite over several arrays at once, shape (1,) (reference
    contrib/all_finite.cc MultiAllFinite)."""
    if not arrays:
        raise MXNetError("multi_all_finite needs at least one input")
    ok = torch.isfinite(arrays[0]).all()
    for a in arrays[1:]:
        ok = ok & torch.isfinite(a).all().to(ok.device)
    return ok.float().reshape(1)


def multi_sum_sq(*arrays, num_arrays=None):
    """Per-array sum of squares in float32, shape (num_arrays,)
    (reference contrib/multi_sum_sq.cc)."""
    if not arrays:
        raise MXNetError("multi_sum_sq needs at least one input")
    dev = arrays[0].device
    return torch.stack([torch.square(a.float()).sum().to(dev)
                        for a in arrays])


def nnz(data):
    """Number of non-zero entries, a 0-d int64 tensor (reference
    contrib/nnz.cc)."""
    return torch.count_nonzero(data)


def bilinear_resize_2d(data, height=None, width=None, scale_height=None,
                       scale_width=None, align_corners=True):
    """Bilinear resize over NCHW (reference contrib/bilinear_resize.cc,
    mode='size'; ``align_corners`` True by default, as the reference's).
    Source coordinates are float64, as the reference's; two row gathers
    and two column gathers, then the lerps."""
    B, C, H, W = data.shape
    # scale mode truncates like the reference kernel's int cast
    out_h = int(H * scale_height) if scale_height else int(height)
    out_w = int(W * scale_width) if scale_width else int(width)
    f64 = dict(dtype=torch.float64, device=data.device)

    def coords(n_in, n_out):
        if align_corners:
            return torch.linspace(0.0, n_in - 1.0, n_out, **f64)
        scale = n_in / n_out
        return torch.clamp((torch.arange(n_out, **f64) + 0.5) * scale - 0.5,
                           0.0, n_in - 1.0)

    yc, xc = coords(H, out_h), coords(W, out_w)
    y0, x0 = torch.floor(yc).long(), torch.floor(xc).long()
    y1, x1 = torch.clamp(y0 + 1, max=H - 1), torch.clamp(x0 + 1, max=W - 1)
    wy = (yc - y0).to(data.dtype)[None, None, :, None]
    wx = (xc - x0).to(data.dtype)
    r0, r1 = data.index_select(2, y0), data.index_select(2, y1)
    top = r0.index_select(3, x0) * (1 - wx) + r0.index_select(3, x1) * wx
    bot = r1.index_select(3, x0) * (1 - wx) + r1.index_select(3, x1) * wx
    return top * (1 - wy) + bot * wy


def khatri_rao(*matrices):
    """Column-wise Kronecker (Khatri-Rao) product (reference
    contrib/krprod.cc): inputs (n_i, k) -> output (prod n_i, k); one
    input returns it unchanged."""
    if not matrices:
        raise MXNetError("khatri_rao needs at least one input")
    k = None
    for m in matrices:
        if m.dim() != 2 or (k is not None and m.shape[-1] != k):
            raise MXNetError(
                f"khatri_rao: all inputs must be 2-D with matching "
                f"columns, got {[tuple(x.shape) for x in matrices]}")
        k = m.shape[-1]
    out = matrices[0]
    for m in matrices[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, k)
    return out
