#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``mxnet_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py              # the run that must pass
    python3 chip_smoke.py --profile    # also a torch.profiler table of
                                       # one decode step, by kernel

Phases (each asserts; any failure exits non-zero before the result line):

1. Environment: the card's name and power limit, TF32 off, and the build
   of every CUDA kernel from ``mxnet_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together).
2. Kernel checks: each kernel of the serving path (K2 LayerNorm, K4 paged
   attention, K5a QKV projection + int8 KV quantize, K5b out projection)
   against its plain PyTorch version on the card, at the shapes the main
   path gives it, with its device time, its plain version's, that of one
   PyTorch library call computing the same function where there is one,
   and its bound from bytes and operations. K5a's int8 rounding is also
   held to exactly known rows on inputs built to expose a wrong rounding
   (:func:`qkv_rounding_probe`), and every other dtype variant the
   wrappers launch (bfloat16 activations, bfloat16 / float16 / float32
   KV stores and pools) is checked against its plain version once.
3. The main path: gpt_like at full width (vocab 32000, units 768, hidden
   3072, 12 layers, 12 heads, max_length 2048) with seeded numpy weights
   loaded through ``from_jax_params``, served by ``LLMEngine`` with its
   defaults (int8 KV, block 16, 8 lanes) for 8 requests; every kernel's
   launch count over that run must be exactly what the run's prefills and
   decode steps imply.
4. Output checks, at the served batch's mid-decode lengths: one paged
   decode step's logits with the kernels, and with
   ``MXNET_TPU_LLM_FUSED_DECODE=0`` (cuBLAS projections around K4),
   against the same step on the plain path (``no_kernels``); and greedy
   tokens of the paged engine (f32 KV) against the dense-cache
   ``generate``.
5. Decode-step time: the same decode step through the decode program,
   device time against host time, kernels and plain.

The last lines are the card line, one ``{"kernels": [...]}`` line and
``{"ok": true, "device": {...}}``. Full results also go to
``chiprun_out/chip_smoke.json``.
"""
import json
import os
import subprocess
import sys
import time
from contextlib import nullcontext

import numpy as np

SEED = 0
# published H100 SXM peaks: HBM bytes/s and f32 (non-tensor-core) FLOP/s
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
# spin cycles per second for torch.cuda._sleep: at or above the H100's
# highest SM clock (1.98 GHz), so a spin lasts at least as long as asked
SPIN_CYCLES_S = 2e9
CFG = dict(vocab_size=32000, units=768, hidden_size=3072, num_layers=12,
           num_heads=12, max_length=2048)
NEW_TOKENS = 32
# name in the kernels line -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "layer_norm_fwd": ("mxnet_tpu_torch/csrc/layer_norm.cu",
                       "mxnet_tpu/ops/pallas/layer_norm.py:32"),
    "paged_attention": ("mxnet_tpu_torch/csrc/paged_attention.cu",
                        "mxnet_tpu/ops/pallas/paged_attention.py:49"),
    "qkv_project": ("mxnet_tpu_torch/csrc/fused_decode.cu",
                    "mxnet_tpu/ops/pallas/fused_decode.py:92"),
    "out_project": ("mxnet_tpu_torch/csrc/fused_decode.cu",
                    "mxnet_tpu/ops/pallas/fused_decode.py:120"),
}
LINE_KEYS = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, n_inputs=1, iters=100, warmup=5):
    """Time one call of ``fn``. Returns ``(device_ms, host_ms)``.

    ``device_ms`` is the mean over ``iters`` calls enqueued back to back
    between two CUDA events. A spin kernel (``torch.cuda._sleep``) holds
    the stream until the host has enqueued every call, so the events time
    the card's work and not the Python wrapper's; when the host could not
    enqueue them all within the spin (a full launch queue), the run is
    repeated with half as many calls. ``host_ms`` is the host's time per
    call in a loop that ends in a synchronise. ``fn(i)`` cycles through
    ``n_inputs`` input sets, so that operands the main path finds cold in
    L2 (one weight set per layer) are cold here too."""
    import torch

    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / iters
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    while True:
        spin.record()
        torch.cuda._sleep(int((2e-3 * iters * host_ms + 1e-3)
                              * SPIN_CYCLES_S))
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i % n_inputs)
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        end.synchronize()
        if enqueue_ms < spin.elapsed_time(start):
            return start.elapsed_time(end) / iters, host_ms
        check(iters > 1, "time_ms: one call outlasts the spin")
        iters //= 2


def bound_ms(nbytes, flops):
    b, f = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    return 1e3 * max(b, f), ("bytes" if b >= f else "operations")


def measure(name, case, err, tol, kernel, plain, library, nbytes, flops,
            n_inputs=1, plain_iters=20):
    """Check one kernel's error against its tolerance, time it, its plain
    version and (where there is one) the library call, and return the
    row of the kernels line (plus the case and the host time per call)."""
    check(err <= tol, f"{name} {case}: max err {err} > {tol}")
    ms, call_ms = time_ms(kernel, n_inputs)
    plain_ms, _ = time_ms(plain, n_inputs, iters=plain_iters)
    lib_ms = time_ms(library, n_inputs)[0] if library else None
    bms, by = bound_ms(nbytes, flops)
    lib_txt = "null" if lib_ms is None else f"{lib_ms:.5f}"
    print(f"{name} {case}: max_abs_err {err:.3e} (tol {tol:g}) ms {ms:.5f} "
          f"(host {call_ms:.5f} per call) plain_ms {plain_ms:.5f} "
          f"library_ms {lib_txt} bound_ms {bms:.6f} ({by})", flush=True)
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "case": case, "tol": tol,
            "host_ms_per_call": call_ms}


def int8_rows_diff(torch, got, want, what):
    """Hold K5a's int8 K/V rows (``got``, one tuple of (N, H, D+4)
    tensors) against the plain version's (``want``). Inputs are random,
    so the f32 sums of U products run in another order on each side:
    the amax, hence the scale, may differ in the last bit, and a value
    lying within that much of a half-way point may round one step
    apart. Scales must agree to 1e-5 relative, and at most 2 values may
    differ, by one step; a quantizer that truncates or rounds half away
    from zero differs on about half of them. Returns the largest
    difference of the dequantized rows and the counts of differing
    scales and values."""
    from mxnet_tpu_torch.ops import nn as tnn

    err, scales_off, values_off, total = 0.0, 0, 0, 0
    for g, w in zip(got, want):
        d = g.shape[-1] - 4
        sg = g[..., d:].contiguous().view(torch.float32)
        sw = w[..., d:].contiguous().view(torch.float32)
        check(((sg - sw).abs() <= 1e-5 * sw.abs()).all().item(),
              f"{what}: int8 scales differ by more than 1e-5 relative")
        steps = (g[..., :d].int() - w[..., :d].int()).abs()
        check(steps.max().item() <= 1, f"{what}: int8 values differ by "
              "more than one quantization step")
        scales_off += int((sg != sw).sum().item())
        values_off += int((steps > 0).sum().item())
        total += steps.numel()
        err = max(err, (tnn.kv_cache_dequantize(g, torch.float32)
                        - tnn.kv_cache_dequantize(w, torch.float32))
                  .abs().max().item())
    print(f"{what}: int8 K/V against the plain version, {scales_off} of "
          f"{total // d} scales one or more bits apart, {values_off} of "
          f"{total} values one step apart (limit 2)", flush=True)
    check(values_off <= 2, f"{what}: {values_off} int8 values differ")
    return err, scales_off, values_off


def qkv_rounding_probe(u, heads, n, seed=SEED):
    """K5a inputs whose int8 K/V rows are known exactly, built so that a
    quantizer that rounds wrongly shows.

    ``x`` is one-hot per token (``x[t, t] = 1``), so ``x . W^T + b``
    (``b = 0``) picks column ``t`` of ``W`` and every sum is exact in any
    order. The K and V columns hold, per (token, head), one value
    ``±amax`` and D-1 values ``(k + 1/2) * scale`` rounded to f32, with
    ``scale = amax * f32(1/127)`` as the quantizer computes it: ``y /
    scale`` then lands on a half-way point or one ulp beside it.
    Returns ``(x, w, b, q, kv_rows, wrong)``: the f32 inputs, the
    expected q (N, H, D), the expected (N, 2, H, D+4) int8 rows of K and
    V, and for each wrong rounding (truncation, a multiply by the
    reciprocal of the scale, half away from zero) the number of values
    on which it would differ from the expected rows."""
    rng = np.random.default_rng(seed)
    d = u // heads
    inv127 = np.float32(1) / np.float32(127)
    amax = rng.uniform(0.5, 4.0, (n, 2, heads, 1)).astype(np.float32)
    scale = amax * inv127
    halves = (rng.integers(-127, 127, (n, 2, heads, d)).astype(np.float32)
              + np.float32(0.5))
    vals = halves * scale
    top = rng.integers(0, d, (n, 2, heads, 1))
    sign = rng.choice(np.float32([-1, 1]), (n, 2, heads, 1))
    np.put_along_axis(vals, top, sign * amax, axis=-1)
    t = vals / scale
    expect = np.clip(np.rint(t), -127, 127)           # half to even
    wrong = {
        "truncating": np.trunc(t),
        "reciprocal-multiply": np.rint(vals * (np.float32(1) / scale)),
        "half-away-from-zero": np.sign(t) * np.floor(np.abs(t) + 0.5)}
    wrong = {k: int((np.clip(v, -127, 127) != expect).sum())
             for k, v in wrong.items()}
    rows = np.concatenate([expect.astype(np.int8), scale.view(np.int8)],
                          axis=-1)                    # little-endian bytes
    y = np.zeros((n, 3 * u), np.float32)
    y[:, :u] = rng.standard_normal((n, u))
    y[:, u:] = vals.reshape(n, 2 * u)
    x = np.zeros((n, u), np.float32)
    x[np.arange(n), np.arange(n)] = 1.0
    w = np.zeros((3 * u, u), np.float32)
    w[:, :n] = y.T
    return (x, w, np.zeros(3 * u, np.float32), y[:, :u].reshape(n, heads, d),
            rows, wrong)


def rounding_probe_check(torch, dev, u, heads, n):
    """K5a and its plain version on :func:`qkv_rounding_probe`'s inputs
    must give the expected rows byte for byte, and each wrong rounding
    must differ from them on at least 5% of the values, so that the probe
    would catch it."""
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd

    x, w, b, q, rows, wrong = qkv_rounding_probe(u, heads, n)
    nvals = rows[..., :-4].size
    for name, cnt in wrong.items():
        check(cnt >= 0.05 * nvals, f"rounding probe: a {name} quantizer "
              f"would differ on only {cnt} of {nvals} values")
    x, w, b = (torch.from_numpy(a).to(dev) for a in (x, w, b))
    q, rows = torch.from_numpy(q).to(dev), torch.from_numpy(rows).to(dev)
    for side, out in (
            ("kernel", kfd.fused_qkv_project(x, w, b, heads=heads,
                                             store_dtype=torch.int8)),
            ("plain", kfd.qkv_project_plain(x, w, b, heads, torch.int8))):
        check(torch.equal(out[0], q), f"rounding probe: {side} q differs")
        for i, c in enumerate(out[1:]):
            off = int((c != rows[:, i]).sum().item())
            check(off == 0, f"rounding probe: {side} {'KV'[i]} rows differ "
                  f"from the expected rows in {off} bytes")
    print(f"qkv_project rounding probe: kernel and plain int8 K/V rows "
          f"identical to the expected {rows.numel()} bytes; a quantizer "
          f"would differ on this many of {nvals} values: {wrong}",
          flush=True)


def kernel_checks(torch, dev):
    """Phase 2: every kernel against its plain version at full-width
    shapes. Returns every measured row; the first row of each kernel is
    its entry in the kernels line."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd
    from mxnet_tpu_torch.ops.kernels import layer_norm as kln
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rows = []
    u, heads, d, bs = 768, 12, 64, 16

    # K2: decode rows (8) and the largest prefill bucket (1024) ----------
    for n in (8, 1024):
        x = randn(n, u, scale=2.0) + 0.5
        gam, bet = randn(u, scale=0.1) + 1.0, randn(u, scale=0.1)
        y, mean, rstd = kln.fused_layer_norm(x, gam, bet, 1e-5)
        py, pmean, prstd = kln.layer_norm_plain(x, gam, bet, 1e-5)
        err = max((y - py).abs().max().item(),
                  (mean - pmean).abs().max().item(),
                  (rstd - prstd).abs().max().item())
        rows.append(measure(
            "layer_norm_fwd", f"({n}, {u}) f32", err,
            1e-5,               # f32 sums of 768 terms in another order
            lambda i: kln.fused_layer_norm(x, gam, bet, 1e-5),
            lambda i: kln.layer_norm_plain(x, gam, bet, 1e-5),
            lambda i: F.layer_norm(x, (u,), gam, bet, 1e-5),
            4 * (2 * n * u + 2 * u + 2 * n), 8 * n * u))

    # K4: 8 lanes, lengths spread over 1..2048 ----------------------------
    r, mb = 8, 128
    nb = r * mb + 1
    lengths = torch.tensor([1, 17, 256, 511, 1000, 1500, 2047, 2048],
                           dtype=torch.int32, device=dev)
    perm = torch.randperm(r * mb, generator=g, device=dev)
    table = perm.reshape(r, mb).to(torch.int32).contiguous()
    q = randn(r, heads, d)
    live = int(lengths.sum().item())
    blocks = int(((lengths + bs - 1) // bs).sum().item())
    for kind in ("int8", "float32"):
        n_sets = 4 if kind == "int8" else 2     # > 50 MB of pools cycled
        pools = []
        for _ in range(n_sets):
            kp, vp = randn(nb, heads, bs, d), randn(nb, heads, bs, d)
            if kind == "int8":
                kp, vp = tnn.kv_cache_quantize(kp), tnn.kv_cache_quantize(vp)
            pools.append((kp.contiguous(), vp.contiguous()))
        kp, vp = pools[0]
        out = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
        ref = kpa.paged_attention_plain(q, kp, vp, table, lengths)
        check(torch.isfinite(out).all().item(),
              f"paged_attention {kind}: non-finite output")
        row_bytes = kp.shape[-1] * kp.element_size()
        # live K and V rows once, q, out, the live table entries, lengths
        nbytes = (2 * live * heads * row_bytes + 2 * r * heads * d * 4
                  + 4 * blocks + 4 * r)
        rows.append(measure(
            "paged_attention",
            f"R{r} H{heads} D{d} bs{bs} MB{mb} {kind} pools, lengths "
            f"{lengths.tolist()}", (out - ref).abs().max().item(),
            1e-4,   # online softmax over 128-position chunks vs softmax
            lambda i: kpa.paged_attention_kernel(
                q, pools[i][0], pools[i][1], table, lengths),
            lambda i: kpa.paged_attention_plain(
                q, pools[i][0], pools[i][1], table, lengths),
            None, nbytes, 4 * live * heads * d, n_inputs=n_sets))
        del pools

    # K5a / K5b: 8 decode tokens, one weight set per layer ----------------
    n, n_sets = 8, 12
    x = randn(n, u)
    wq = [randn(3 * u, u, scale=0.02) for _ in range(n_sets)]
    bq = [randn(3 * u, scale=0.02) for _ in range(n_sets)]
    q5, k5, v5 = kfd.fused_qkv_project(x, wq[0], bq[0], heads=heads,
                                       store_dtype=torch.int8)
    pq, pk, pv = kfd.qkv_project_plain(x, wq[0], bq[0], heads, torch.int8)
    q_err = (q5 - pq).abs().max().item()
    check(q_err <= 1e-4, f"qkv_project: q differs by {q_err}")
    err, scales_off, values_off = int8_rows_diff(torch, (k5, v5), (pk, pv),
                                                 "qkv_project f32")
    err = max(err, q_err)
    rounding_probe_check(torch, dev, u, heads, n)
    rows.append(measure(
        "qkv_project", f"N{n} U{u} H{heads} int8 store", err,
        # q: f32 sums of 768 terms in another order; int8 K/V may flip a
        # near-tie rounding, one step = the scale, about 0.02 here
        0.05,
        lambda i: kfd.fused_qkv_project(x, wq[i], bq[i], heads=heads,
                                        store_dtype=torch.int8),
        lambda i: kfd.qkv_project_plain(x, wq[i], bq[i], heads, torch.int8),
        None, 4 * (3 * u * u + 3 * u + 2 * n * u) + 2 * n * heads * (d + 4),
        2 * n * 3 * u * u, n_inputs=n_sets))
    del wq, bq

    a = randn(n, u)
    wo = [randn(u, u, scale=0.02) for _ in range(n_sets)]
    bo = [randn(u, scale=0.02) for _ in range(n_sets)]
    err = (kfd.fused_out_project(a, wo[0], bo[0])
           - kfd.out_project_plain(a, wo[0], bo[0])).abs().max().item()
    rows.append(measure(
        "out_project", f"N{n} U{u}", err, 1e-4,
        lambda i: kfd.fused_out_project(a, wo[i], bo[i]),
        lambda i: kfd.out_project_plain(a, wo[i], bo[i]),
        lambda i: F.linear(a, wo[i], bo[i]),
        4 * (u * u + u + 2 * n * u), 2 * n * u * u, n_inputs=n_sets))
    return rows


def variant_checks(torch, dev):
    """Phase 2, the other dtype variants: every combination of dtypes the
    wrappers launch, besides the float32 ones timed above, once against
    its plain version at the main path's shapes. A bfloat16 model or
    ``kv_cache_dtype="bfloat16"|"float16"`` reaches them. Returns one
    row per variant."""
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd
    from mxnet_tpu_torch.ops.kernels import layer_norm as kln
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa

    f32, bf16, f16, i8 = (torch.float32, torch.bfloat16, torch.float16,
                          torch.int8)
    # (atol, rtol) of an output that both sides compute in f32 and round
    # once to its dtype: after sums in another order the f32 values may
    # lie on either side of a rounding point, one ulp apart (2^-7 of the
    # value in bfloat16, 2^-10 in float16)
    once = {f32: (1e-4, 0.0), bf16: (1e-5, 2.0 ** -7),
            f16: (1e-5, 2.0 ** -10)}
    # K4's plain version also rounds the softmax weights to the dtype it
    # attends in (and, attending in bfloat16, the scores), where the
    # kernel keeps f32: each weight within 2^-8 (bfloat16) or 2^-11
    # (float16) of the kernel's, so the output within that share of
    # max |v| (about 5 here: 0.02 and 0.0025), plus the output's own
    # rounding; the bfloat16 limit is the CPU tests' 3e-2
    attend = {f32: (1e-4, 0.0), bf16: (3e-2, 0.0), f16: (1e-2, 0.0)}
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)

    def randn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(dtype)

    out = []

    def hold(kernel, case, got, want, tol):
        gf, wf = got.float(), want.float()
        diff = (gf - wf).abs()
        check(torch.isfinite(gf).all().item(), f"{kernel} {case}: non-finite")
        err = diff.max().item()
        ratio = (diff / (tol[0] + tol[1] * wf.abs())).max().item()
        print(f"{kernel} {case}: max_abs_err {err:.3e}, worst |err| / "
              f"({tol[0]:g} + {tol[1]:g} |ref|) = {ratio:.3f} (limit 1)",
              flush=True)
        check(ratio <= 1.0, f"{kernel} {case}: max err {err} outside "
              f"atol {tol[0]} rtol {tol[1]}")
        out.append({"name": kernel, "case": case, "max_abs_err": err,
                    "atol": tol[0], "rtol": tol[1]})

    u, heads, d, bs = 768, 12, 64, 16
    # K2 in bfloat16: y rounded once, statistics in f32 -------------------
    for n in (8, 1024):
        x = randn(n, u, scale=2.0, dtype=bf16) + 0.5
        gam = randn(u, scale=0.1, dtype=bf16) + 1.0
        bet = randn(u, scale=0.1, dtype=bf16)
        y, mean, rstd = kln.fused_layer_norm(x, gam, bet, 1e-5)
        py, pmean, prstd = kln.layer_norm_plain(x, gam, bet, 1e-5)
        check(y.dtype == py.dtype == bf16, "layer_norm_fwd bf16: dtype")
        hold("layer_norm_fwd", f"({n}, {u}) bf16 y", y, py, once[bf16])
        hold("layer_norm_fwd", f"({n}, {u}) bf16 mean, rstd",
             torch.cat([mean, rstd]), torch.cat([pmean, prstd]), (1e-5, 0.0))

    # K4: q float32 / bfloat16 x pools int8 / float32 / bfloat16 / float16
    r, mb = 8, 128
    lengths = torch.tensor([1, 17, 256, 511, 1000, 1500, 2047, 2048],
                           dtype=torch.int32, device=dev)
    table = (torch.randperm(r * mb, generator=g, device=dev)
             .reshape(r, mb).to(torch.int32).contiguous())
    for q_dt in (f32, bf16):
        q = randn(r, heads, d, dtype=q_dt)
        for p_dt in (i8, f32, bf16, f16):
            if (q_dt, p_dt) in ((f32, i8), (f32, f32)):
                continue                        # timed and held above
            kp, vp = (randn(r * mb + 1, heads, bs, d) for _ in range(2))
            if p_dt == i8:
                kp, vp = tnn.kv_cache_quantize(kp), tnn.kv_cache_quantize(vp)
            else:
                kp, vp = kp.to(p_dt), vp.to(p_dt)
            got = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
            want = kpa.paged_attention_plain(q, kp, vp, table, lengths)
            check(got.dtype == want.dtype, f"paged_attention q {q_dt} "
                  f"pools {p_dt}: dtype {got.dtype} != {want.dtype}")
            hold("paged_attention", f"q {str(q_dt)[6:]} pools "
                 f"{str(p_dt)[6:]} R{r} H{heads} D{d} bs{bs} MB{mb}",
                 got, want, attend[want.dtype])
    del kp, vp

    # K5a: x float32 / bfloat16 x store int8 / float32 / bfloat16 / float16
    n = 8
    for x_dt in (f32, bf16):
        x = randn(n, u, dtype=x_dt)
        w = randn(3 * u, u, scale=0.02, dtype=x_dt)
        b = randn(3 * u, scale=0.02, dtype=x_dt)
        for s_dt in (i8, f32, bf16, f16):
            if (x_dt, s_dt) == (f32, i8):
                continue                        # timed and held above
            case = f"N{n} U{u} H{heads} x {str(x_dt)[6:]} store " \
                   f"{str(s_dt)[6:]}"
            got = kfd.fused_qkv_project(x, w, b, heads=heads,
                                        store_dtype=s_dt)
            want = kfd.qkv_project_plain(x, w, b, heads, s_dt)
            for gt, wt in zip(got, want):
                check(gt.dtype == wt.dtype and gt.shape == wt.shape,
                      f"qkv_project {case}: {gt.dtype} {tuple(gt.shape)} "
                      f"!= {wt.dtype} {tuple(wt.shape)}")
            hold("qkv_project", case + " q", got[0], want[0], once[x_dt])
            if s_dt == i8:
                err, scales_off, values_off = int8_rows_diff(
                    torch, got[1:], want[1:], f"qkv_project {case}")
                out.append({"name": "qkv_project", "case": case + " k, v",
                            "max_abs_err": err, "scales_off": scales_off,
                            "values_off": values_off})
            else:
                hold("qkv_project", case + " k, v", torch.cat(got[1:]),
                     torch.cat(want[1:]), once[s_dt])

    # K5b in bfloat16 ------------------------------------------------------
    a = randn(n, u, dtype=bf16)
    w = randn(u, u, scale=0.02, dtype=bf16)
    b = randn(u, scale=0.02, dtype=bf16)
    hold("out_project", f"N{n} U{u} bf16",
         kfd.fused_out_project(a, w, b), kfd.out_project_plain(a, w, b),
         once[bf16])
    return out


def seeded_params(model, seed):
    """Numpy weights under the reference's parameter names: normal with
    std 0.02 (LayerNorm gains 1 + that)."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, t in model.state_dict().items():
        v = rng.standard_normal(tuple(t.shape), dtype=np.float32) * 0.02
        if name.endswith(".gamma"):
            v += 1.0
        params[name] = v
    return params


def decode_state(torch, model, lengths, gen):
    """A decode step's inputs at per-lane ``lengths``: int8 pools of
    random K/V, each lane's blocks in its own table row, every lane's new
    token at position ``length - 1``."""
    from mxnet_tpu_torch.ops import nn as tnn

    dev = model.word_embed.weight.device
    bs, r = 16, len(lengths)
    mb = CFG["max_length"] // bs
    need = [-(-int(n) // bs) for n in lengths]
    pk, pv = model.init_block_pool(sum(need) + 1, bs, dtype="int8")
    for pool in (pk, pv):
        for layer in pool:              # one layer at a time: less memory
            layer.copy_(tnn.kv_cache_quantize(torch.randn(
                layer.shape[:-1] + (layer.shape[-1] - 4,), generator=gen,
                device=dev)))
    table = torch.full((r, mb), sum(need), dtype=torch.int32, device=dev)
    first = 0
    for i, k in enumerate(need):
        table[i, :k] = torch.arange(first, first + k, dtype=torch.int32)
        first += k
    pos = torch.tensor([int(n) - 1 for n in lengths], dtype=torch.int32,
                       device=dev)
    toks = torch.randint(0, CFG["vocab_size"], (r, 1), generator=gen,
                         device=dev, dtype=torch.int32)
    return toks, pk, pv, table, pos


def profile_decode(torch, run, args, gen):
    """``--profile``: torch.profiler over three decode steps; writes the
    table by kernel to chiprun_out/decode_profile.txt and returns the
    device time per step summed over kernels (None when the profiler saw
    no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run(*args, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run(*args, gen)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_device_time_total", row_limit=40)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "decode_profile.txt"), "w") as fh:
        fh.write(table)
    # the device rows that the table's "Self CUDA time total" counts:
    # user annotations are device rows too, but span kernels counted
    # already
    dev_us = sum(e.self_device_time_total for e in avgs
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
    print(table, flush=True)
    return dev_us / 3e3 if dev_us else None


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.bert import gpt_like
    from mxnet_tpu_torch.gluon.model_zoo.generation import (
        generate, paged_decode_program)
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd
    from mxnet_tpu_torch.ops.kernels import layer_norm as kln
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa
    from mxnet_tpu_torch.serving.llm import LLMEngine

    t_start = time.perf_counter()
    results = {}
    # -- phase 1: environment and build ------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {count} device(s), device 0 = {kind}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the plain versions' half-precision products accumulate in f32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {built} in {build_s:.2f} s", flush=True)
    for name in built:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    results["build_s"] = build_s

    # -- phase 2: kernels against their plain versions ----------------------
    rows = kernel_checks(torch, dev)
    results["variants"] = variant_checks(torch, dev)
    entries = {}
    for row in rows:
        entries.setdefault(row["name"], row)

    # -- phase 3: the main path ---------------------------------------------
    t0 = time.perf_counter()
    model = gpt_like(**CFG)                       # on gpu(0) by default
    from_jax_params(seeded_params(model, SEED), model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"gpt_like {CFG}: {n_params} parameters on "
          f"{model.word_embed.weight.device}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(SEED + 1)
    prompt_lens = rng.integers(16, 1025, size=8)
    prompts = [rng.integers(0, CFG["vocab_size"], size=int(p))
               .astype(np.int32) for p in prompt_lens]
    wrappers = {"layer_norm_fwd": kln.fused_layer_norm,
                "paged_attention": kpa.paged_attention_kernel,
                "qkv_project": kfd.fused_qkv_project,
                "out_project": kfd.fused_out_project}
    with LLMEngine(model) as eng:                 # int8 KV, block 16, 8 lanes
        # warm-up request: first-call costs stay out of the measured run
        eng.generate(prompts[0][:16], 4)
        before = eng.stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        handles = [eng.submit(p, NEW_TOKENS) for p in prompts]
        outs = [h.wait(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        after = eng.stats()
    for out in outs:
        check(out.shape == (NEW_TOKENS,), f"request returned {out.shape}")
        check(((out >= 0) & (out < CFG["vocab_size"])).all(),
              "token out of vocabulary")
    steps = (after["counters"]["decode_steps"]
             - before["counters"]["decode_steps"])
    prefills = after["counters"]["prefills"] - before["counters"]["prefills"]
    layers = CFG["num_layers"]
    expected = {"layer_norm_fwd": (2 * layers + 1) * (prefills + steps),
                "paged_attention": layers * steps,
                "qkv_project": layers * steps,
                "out_project": layers * steps}
    print(f"served {len(prompts)} requests (prompt lengths "
          f"{prompt_lens.tolist()}, {NEW_TOKENS} new tokens each): "
          f"{prefills} prefills, {steps} decode steps, launches {counts}, "
          f"expected {expected}", flush=True)
    check(prefills == len(prompts), f"{prefills} prefills")
    check(counts == expected, f"launch counts {counts} != {expected}")
    for row in rows:
        row["launches"] = counts[row["name"]]
    dec_s = after["decode_s"] - before["decode_s"]
    pre_s = after["prefill_s"] - before["prefill_s"]
    dec_tok = after["decode_tokens"] - before["decode_tokens"]
    serve = {"wall_s": wall, "tok_s": len(prompts) * NEW_TOKENS / wall,
             "decode_step_ms": 1e3 * dec_s / steps,
             "prefill_ms": 1e3 * pre_s / prefills,
             "decode_tok_s": dec_tok / dec_s, "decode_steps": steps,
             "prompt_lens": prompt_lens.tolist(), "card": card}
    results["serve"] = serve
    print(f"serve on {card}: prefill_ms {serve['prefill_ms']:.3f} (mean of "
          f"{prefills}), decode_step_ms {serve['decode_step_ms']:.3f} (mean "
          f"of {steps}), tok_s {serve['tok_s']:.1f} end to end, decode "
          f"tok_s {serve['decode_tok_s']:.1f}", flush=True)

    # -- phase 4: output checks, at the served batch's mid-decode lengths ---
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    lengths = prompt_lens + NEW_TOKENS // 2
    args = decode_state(torch, model, lengths, g)
    toks, pk, pv, table, pos = args

    def step_logits():
        with torch.no_grad():
            return model.decode_step_paged(toks, pk.clone(), pv.clone(),
                                           table, pos)[0]

    lg_kernel = step_logits()
    with tnn.no_kernels():
        lg_plain = step_logits()
    # the projections on cuBLAS around K4 and K2: a comparison path
    env_fused = os.environ.get("MXNET_TPU_LLM_FUSED_DECODE")
    os.environ["MXNET_TPU_LLM_FUSED_DECODE"] = "0"
    for w in wrappers.values():
        w.launches = 0
    lg_unfused = step_logits()
    unfused_counts = {k: w.launches for k, w in wrappers.items()}
    if env_fused is None:
        del os.environ["MXNET_TPU_LLM_FUSED_DECODE"]
    else:
        os.environ["MXNET_TPU_LLM_FUSED_DECODE"] = env_fused
    check(unfused_counts == {"layer_norm_fwd": 2 * layers + 1,
                             "paged_attention": layers, "qkv_project": 0,
                             "out_project": 0},
          f"MXNET_TPU_LLM_FUSED_DECODE=0 launched {unfused_counts}")
    # 12 layers of f32 sums in another order, plus int8 K/V of the new
    # token that may round one step apart (one step ~1% of a value)
    tol = 2e-3
    errs = {}
    for path, lg in (("kernels", lg_kernel), ("fused decode off", lg_unfused)):
        check(torch.isfinite(lg).all().item(), f"{path}: non-finite logits")
        err = (lg - lg_plain).abs().max().item()
        same = (lg.argmax(-1) == lg_plain.argmax(-1)).float().mean().item()
        print(f"decode step int8 KV at lengths {lengths.tolist()}, {path} vs "
              f"plain path on the card: logits max_abs_err {err:.3e} (tol "
              f"{tol:g}), argmax agreement {same}", flush=True)
        check(err <= tol, f"decode-step logits: {path} vs plain {err} > {tol}")
        errs[path] = err
    results["decode_step_logits_err"] = errs
    del lg_kernel, lg_plain, lg_unfused

    check_prompts = [prompts[1][:40], prompts[2][:23]]
    with LLMEngine(model, kv_cache_dtype="float32") as eng:
        paged = [eng.generate(p, 8) for p in check_prompts]
    dense = [generate(model, p[None], 8).cpu().numpy()[0]
             for p in check_prompts]
    for a_, b_ in zip(paged, dense):
        check(np.array_equal(a_, b_), f"paged engine {a_.tolist()} != "
              f"dense generate {b_.tolist()}")
    print("paged engine (f32 KV, kernels) == dense generate: greedy tokens "
          "identical on 2 prompts x 8 tokens", flush=True)

    # -- phase 5: the same decode step, device time against host time -------
    run = paged_decode_program(model)
    step = {"lengths": lengths.tolist()}
    for path in ("kernels", "plain"):
        with tnn.no_kernels() if path == "plain" else nullcontext():
            dev_ms, host_ms = time_ms(lambda i: run(*args, g), iters=10,
                                      warmup=2)
        step[path] = {"device_ms": dev_ms, "host_ms": host_ms,
                      "device_busy": dev_ms / host_ms}
        print(f"decode step on {card}, {path} path, lengths "
              f"{step['lengths']}: device_ms {dev_ms:.4f} host_ms "
              f"{host_ms:.4f} (device busy {dev_ms / host_ms:.3f})",
              flush=True)
    if "--profile" in argv:
        prof_ms = profile_decode(torch, run, args, g)
        step["profiler_device_ms"] = prof_ms
        print(f"decode step, profiler: device ms per step summed over "
              f"kernels: {'not measured' if prof_ms is None else prof_ms}",
              flush=True)
    results["decode_step"] = step
    del args, pk, pv

    results["kernels"] = rows
    results["seconds"] = time.perf_counter() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"total {results['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": [{k: e[k] for k in LINE_KEYS}
                                  for e in entries.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
