#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``mxnet_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py              # the run that must pass
    python3 chip_smoke.py --profile    # also torch.profiler tables of one
                                       # decode step and one train step,
                                       # by kernel
    python3 chip_smoke.py --kernels    # phases 1 and 2 only (no result)
    python3 chip_smoke.py --trials     # also, after phase 1, trial builds
                                       # of K4's span, K1 forward's
                                       # tiling, K5a's cluster size,
                                       # threads and slab copies, and
                                       # K5b's rows, stages, threads and
                                       # row route (and two diagnostic
                                       # builds each of K5a and K5b)
                                       # timed against each other
    python3 chip_smoke.py --trials=K5b # only the trials whose label
                                       # holds "K5b"

Phases (each asserts; any failure exits non-zero before the result line):

1. Environment: the card's name and power limit, the matmul precision
   policy set to ``highest`` (IEEE f32 in cuBLAS and cuDNN, 3xTF32 in the
   attention kernels; every check below runs under it unless it names
   the ``default`` policy, TF32), and the build of every CUDA kernel from
   ``mxnet_tpu_torch/csrc`` (one ``nvcc`` per source, all started
   together).
2. Kernel checks: each kernel of the serving path (K2 LayerNorm, K4 paged
   attention, K5a QKV projection + int8 KV quantize, K5b out projection)
   against its plain PyTorch version on the card, at the shapes the main
   path gives it, with its device time, its plain version's, that of one
   PyTorch library call computing the same function where there is one,
   and its bound from bytes and operations. K5a's int8 rounding is also
   held to exactly known rows on inputs built to expose a wrong rounding
   (:func:`qkv_rounding_probe`), and every other dtype variant the
   wrappers launch (bfloat16 activations, bfloat16 / float16 / float32
   KV stores and pools) is checked against its plain version once. The
   training slice's kernels (K1 flash-attention forward, K1c dQ, K1d
   dK/dV, K3 logsumexp) are timed at the train step's shapes and checked
   in their other cases (:func:`train_kernel_checks`); the three
   attention kernels must give bitwise-equal results on two runs, K1
   forward must beat SDPA's forward, and their bound is that of the
   tensor cores they run on (three TF32 passes in f32), with the f32-FMA
   bound printed beside it; cuobjdump must find HMMA in every
   instantiation. The same three kernels on the ``default`` policy's
   route, f32 in one TF32 pass (:func:`one_pass_checks`), are held
   against the plain versions that round their operands to TF32 and
   against the exact ones, run twice for the same bits, and timed against
   their one-pass bound and SDPA under the same policy. K4 is timed at phase 3's mid-decode lengths too, must
   beat its plain version, and is held at the edges of its split
   (:func:`paged_edge_checks`). K2 is checked and timed on both of its
   routes at the decode, prefill and train shapes (the warp route through
   the wrapper, the block route through its C entry), and on the block
   route through the wrapper at widths the warp route does not take
   (4096, 770). K5a runs as a thread-block cluster fed by bulk copies:
   cuobjdump must find the bulk copy in every instantiation and the
   cluster barrier in the int8 ones; two runs must give the same bits;
   20 tokens (three chunks) and a width on its head route (U 4096) must
   give the plain version's rows byte for byte on exact inputs. K5b runs
   on every SM, a block's weight rows brought in by bulk copies through
   a ring of stages: cuobjdump must find the bulk copy in both of its
   instantiations; its geometry is printed; two runs must give the same
   bits; and 20 tokens, a U_out no block size divides, U 4096, a width
   whose rows the ring walks (U_in 4608, 20 tokens), bfloat16 and a
   width on its row route (U_in 8192) must give the plain version's
   outputs byte for byte on exact inputs. A near-empty launch
   (:func:`launch_floor`) is timed beside K2, K5a and K5b.
   K2r (RMSNorm
   forward) and R (runtime-compiled user kernels) are checked at the
   front-door path's shapes (:func:`frontdoor_kernel_checks`).
3. The main path: gpt_like at full width (vocab 32000, units 768, hidden
   3072, 12 layers, 12 heads, max_length 2048) with seeded numpy weights
   loaded through ``from_jax_params``, served by ``LLMEngine`` with its
   defaults (int8 KV, block 16, 8 lanes) for 8 requests, after
   ``warmup`` captured the decode step and the prompts' prefill buckets
   as CUDA graphs; the served run replays them, and every kernel's
   launch count over it must be exactly what its prefills and decode
   steps imply.
4. Output checks, at the served batch's mid-decode lengths: one paged
   decode step's logits with the kernels, and with
   ``MXNET_TPU_LLM_FUSED_DECODE=0`` (cuBLAS projections around K4),
   against the same step on the plain path (``no_kernels``); greedy
   tokens of the paged engine (f32 KV, graphs) against the dense-cache
   ``generate``; one replay of the decode graph, and of a prefill
   bucket's, against one eager call of the same program, bitwise in
   tokens, pools and launches (:func:`replay_equals_eager`); a sampling
   engine's graphs draw anew from its generator (:func:`sampling_check`).
5. Step times: the same decode step replayed and eager, on the kernels
   and on the plain path, and each served prefill bucket replayed and
   eager, device time against host time.
6. Train-step check: one full-width backward at B 2, L 1024 through the
   kernels against the same under ``no_kernels``, and under the
   ``default`` policy against ``highest`` (:func:`train_grad_check`).
7. The train main path: the same gpt_like trains through
   ``SoftmaxCrossEntropyLoss`` and ``Trainer`` (SGD, momentum 0.9) on 8
   sequences of 1024 seeded tokens, under ``highest`` and then under
   ``default``, each a warm-up step and 5 timed steps with exact launch
   counts and a falling loss (:func:`train_phase`).
8. The front-door path (:func:`frontdoor_phase`): the RMSNorm FFN stack at
   gpt_like's widths (12 blocks of x + Dense(768)(Dense(3072, gelu)(
   RMSNorm()(x))) and a final RMSNorm, every layer with a deferred shape)
   built with Gluon, ``net.initialize(Xavier())``, data from
   ``mx.np.random``, scaled per row by a user kernel compiled with
   ``mx.rtc.CudaModule`` (NVRTC), trained through ``autograd.record()``,
   ``L2Loss`` and ``Trainer(net.collect_params(), "adam")``: shapes
   completed at the first forward, then under each policy exactly 13 K2r
   launches per forward (one RMSNorm per block and the final one) and
   one user-kernel launch per step and a falling loss, a B 2 step's loss
   and gradients against ``no_kernels`` and under ``default`` against
   ``highest``, and a bitwise ``.params`` round trip. Its kernels (K2r RMSNorm, kernel R through two user sources) are
   checked in phase 2 (:func:`frontdoor_kernel_checks`).

The last lines are the card line, one ``{"kernels": [...]}`` line and
``{"ok": true, "device": {...}}``. Full results also go to
``chiprun_out/chip_smoke.json``.
"""
import json
import os
import re
import subprocess
import sys
import time
from contextlib import nullcontext

import numpy as np

SEED = 0
# published H100 SXM peaks: HBM bytes/s and f32 (non-tensor-core) FLOP/s
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
# dense tensor-core peaks: TF32 and bf16
TF32_FLOP_S = 495e12
BF16_FLOP_S = 989e12
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
    # one kernel for K1a (:70) and K1b (:144); gpt_like's path runs K1b
    "flash_attention_fwd": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                            "mxnet_tpu/ops/pallas/flash_attention.py:144"),
    # K1c and K1d: tensor-core kernels (mma.sync, 3xTF32 for f32)
    "flash_attention_bwd_dq": ("mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
                               "mxnet_tpu/ops/pallas/flash_attention.py:379"),
    "flash_attention_bwd_dkv": (
        "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:432"),
    # the same three kernels on the default matmul policy's route: f32 in
    # one TF32 pass (OpsTF32)
    "flash_attention_fwd_tf32": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                                 "mxnet_tpu/ops/pallas/flash_attention.py:144"),
    "flash_attention_bwd_dq_tf32": (
        "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:379"),
    "flash_attention_bwd_dkv_tf32": (
        "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:432"),
    "cross_entropy_lse": ("mxnet_tpu_torch/csrc/cross_entropy.cu",
                          "mxnet_tpu/ops/pallas/cross_entropy.py:34"),
    "rms_norm_fwd": ("mxnet_tpu_torch/csrc/layer_norm.cu",
                     "mxnet_tpu/ops/pallas/layer_norm.py:50"),
    # kernel R: the user's CUDA C (USER_SOURCE below), compiled by
    # mxnet_tpu_torch/rtc.py with NVRTC; the front-door path launches
    # row_absmax_scale
    "rtc_row_absmax_scale": ("mxnet_tpu_torch/rtc.py",
                             "mxnet_tpu/rtc.py:57"),
}
# two user kernels for mx.rtc.CudaModule: an axpy, and a per-row max-abs
# scaling that uses the grid, the block and dynamic shared memory
USER_SOURCE = r"""
extern "C" __global__ void axpy(int n, const float* x, const float* y,
                                float* o) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i] + y[i];
}

extern "C" __global__ void row_absmax_scale(const float* x, int d,
                                            float* o) {
  extern __shared__ float red[];
  const float* xr = x + (size_t)blockIdx.x * d;
  float* orow = o + (size_t)blockIdx.x * d;
  float m = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) m = fmaxf(m, fabsf(xr[j]));
  red[threadIdx.x] = m;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = fmaxf(red[threadIdx.x],
                                                  red[threadIdx.x + s]);
    __syncthreads();
  }
  const float amax = red[0];
  for (int j = threadIdx.x; j < d; j += blockDim.x) orow[j] = xr[j] / amax;
}
"""
ROW_SCALE_THREADS = 256
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


def kernel_name(mangled):
    """A template kernel's mangled name as name<T, DP>, with ", 1-pass"
    for the attention kernels' one-TF32-pass instantiations; others as
    they are."""

    t = re.search(r"([a-z][a-z_]*_kernel)I(13__nv_bfloat16|f|6__half)"
                  r"Li(\d+)E(Lb1E)?", mangled)
    if t is None:
        return mangled
    ty = {"f": "float", "13__nv_bfloat16": "bf16",
          "6__half": "half"}[t.group(2)]
    return f"{t.group(1)}<{ty}, {t.group(3)}{', 1-pass' if t.group(4) else ''}>"


def ptxas_summary(log):
    """(kernel, registers line, spill line) for each kernel in an ``nvcc
    -Xptxas -v`` log."""

    out, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn is not None:
            out.append((fn, line.split(":", 1)[1].strip(), spill))
            fn, spill = None, ""
    return out


def sass_opcodes(lib):
    """``cuobjdump -sass`` of a built kernel library: the count of each
    instruction mnemonic in each kernel, by mangled name, or None where
    the toolkit has no cuobjdump."""
    from collections import Counter

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    exe = os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    ins = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = Counter()
        elif fn is not None:
            m = ins.search(line)
            if m:
                counts[fn][m.group(1)] += 1
    return counts


def sass_mma_counts(lib):
    """The number of tensor-core instructions (HMMA) in each kernel of a
    built library, by mangled name, or None without cuobjdump."""
    ops = sass_opcodes(lib)
    if ops is None:
        return None
    return {fn: sum(c for op, c in ctr.items() if op.startswith("HMMA"))
            for fn, ctr in ops.items()}


# K5a's cluster route and K5b's ring route in SASS: the bulk copy
# (cp.async.bulk) and the cluster barrier (barrier.cluster, cluster.sync);
# mbarrier and fence instructions are printed beside them
SASS_BULK, SASS_CLUSTER_BAR = "BLKCP", "CGABAR"
SASS_SHOWN = ("BLK", "TMA", "CGA", "SYNCS", "FENCE", "MEMBAR")


def bulk_copy_sass_check(path):
    """Every qkv_cluster_kernel (K5a, 8) and out_ring_kernel (K5b, 2)
    instantiation must issue a bulk copy, and the int8 K5a ones
    (``Lb1E``: QUANT true) a cluster barrier; prints the mnemonics found.
    Returns them, or None without cuobjdump."""
    ops = sass_opcodes(path)
    if ops is None:
        print("cuobjdump not found: SASS of fused_decode not inspected")
        return None
    found = {}
    for fn, ctr in ops.items():
        if "qkv_cluster_kernel" not in fn and "out_ring_kernel" not in fn:
            continue
        shown = {op: c for op, c in sorted(ctr.items())
                 if any(k in op for k in SASS_SHOWN)}
        found[fn] = shown
        bulk = sum(c for op, c in shown.items() if SASS_BULK in op)
        cbar = sum(c for op, c in shown.items() if SASS_CLUSTER_BAR in op)
        print(f"cuobjdump -sass fused_decode {fn}: {shown}", flush=True)
        check(bulk > 0, f"{fn}: no bulk copy ({SASS_BULK}) in its SASS")
        check(cbar > 0 or "Lb1E" not in fn or "out_ring" in fn,
              f"{fn}: no cluster barrier ({SASS_CLUSTER_BAR}) in its SASS")
    counts = [sum(k in fn for fn in found)
              for k in ("qkv_cluster_kernel", "out_ring_kernel")]
    check(counts == [8, 2], f"bulk-copy kernel instantiations: {list(found)}")
    return found


def tc_bound_ms(nbytes, flops, dtype, passes=3):
    """The tensor-core bound of the attention kernels (K1 forward, K1c,
    K1d): f32 operands take ``passes`` TF32 passes at 495 TFLOP/s (three,
    hi.hi + hi.lo + lo.hi, under the full-f32 policy; one under the
    default), bf16 one pass at 989."""
    passes, rate = ((passes, TF32_FLOP_S) if dtype == "float32"
                    else (1, BF16_FLOP_S))
    b, f = nbytes / HBM_BYTES_S, passes * flops / rate
    return 1e3 * max(b, f), ("bytes" if b >= f else "operations")


def use_tc_bound(row, nbytes, flops, dtype, passes=3):
    """Make an attention kernel's row's ``bound_ms`` and ``bound_by``
    (those of the kernels line) the tensor-core bound, the rate these
    kernels multiply at, keep the f32-FMA bound beside it as
    ``fma_bound_ms``, and print both with the roofline share against
    each."""
    tms, tby = tc_bound_ms(nbytes, flops, dtype, passes)
    row["fma_bound_ms"], row["fma_bound_by"] = row["bound_ms"], row["bound_by"]
    row["bound_ms"], row["bound_by"] = tms, tby
    rate = (f"{passes} TF32 pass{'es' if passes > 1 else ''} at 495"
            if dtype == "float32" else "1 bf16 pass at 989")
    print(f"{row['name']} {row['case']}: bound_ms {tms:.6f} ({tby}, tensor "
          f"cores, {rate} TFLOP/s; the kernels line's bound_ms, roofline "
          f"share {tms / row['ms']:.3f}) f32-FMA bound "
          f"{row['fma_bound_ms']:.6f} ({row['fma_bound_by']}, 67 TFLOP/s; "
          f"roofline share {row['fma_bound_ms'] / row['ms']:.3f})",
          flush=True)


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


def launch_floor(torch):
    """The device time of a near-empty launch (``torch.cuda._sleep(1)``)
    by :func:`time_ms`: the floor that rows at decode shapes are read
    against. Not a kernel of the port."""
    ms = time_ms(lambda i: torch.cuda._sleep(1))[0]
    print(f"launch floor: torch.cuda._sleep(1) ms {ms:.5f}", flush=True)
    return ms


def kernel_checks(torch, dev, floor_ms):
    """Phase 2: every kernel against its plain version at full-width
    shapes. Returns every measured row; the first row of each kernel is
    its entry in the kernels line. ``floor_ms`` is the launch floor
    (:func:`launch_floor`), printed beside K2, K5a and K5b."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd
    from mxnet_tpu_torch.ops.kernels import layer_norm as kln
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rows = []
    u, heads, d, bs = 768, 12, 64, 16

    # K2: decode rows (8), the largest prefill bucket (1024) and the train
    # step (8192), each on the warp route; the block route beside it,
    # through its library entry, checked and timed in the same run -----
    lib = _build.load("layer_norm")

    def ln_block(x, gam, bet):
        with torch.cuda.device(x.device):
            out, err = kln.ln_launch(lib, "block", x, gam, bet, 1e-5,
                                     _build.stream_ptr(x.device))
        _build.check(err, "layer_norm_fwd block route")
        return out

    def ln_err(got, want):
        return max((a - b).abs().max().item() for a, b in zip(got, want))

    for n in (8, 1024, 8192):
        x = randn(n, u, scale=2.0) + 0.5
        gam, bet = randn(u, scale=0.1) + 1.0, randn(u, scale=0.1)
        check(kln.ln_route(x, gam, bet) == "warp",
              f"layer_norm_fwd ({n}, {u}): not on the warp route")
        want = kln.layer_norm_plain(x, gam, bet, 1e-5)
        err = ln_err(kln.fused_layer_norm(x, gam, bet, 1e-5), want)
        block_err = ln_err(ln_block(x, gam, bet), want)
        # f32 sums of 768 terms in another order
        check(block_err <= 1e-5, f"layer_norm_fwd ({n}, {u}) block route: "
              f"max err {block_err}")
        row = measure(
            "layer_norm_fwd", f"({n}, {u}) f32", err, 1e-5,
            lambda i: kln.fused_layer_norm(x, gam, bet, 1e-5),
            lambda i: kln.layer_norm_plain(x, gam, bet, 1e-5),
            lambda i: F.layer_norm(x, (u,), gam, bet, 1e-5),
            4 * (2 * n * u + 2 * u + 2 * n), 8 * n * u)
        # in turns: warp (above), block, block, warp
        block_ms = [time_ms(lambda i: ln_block(x, gam, bet))[0]
                    for _ in range(2)]
        warp_ms = time_ms(lambda i: kln.fused_layer_norm(x, gam, bet,
                                                         1e-5))[0]
        row.update(block_ms=block_ms, warp_ms=[row["ms"], warp_ms],
                   block_err=block_err, launch_floor_ms=floor_ms)
        print(f"layer_norm_fwd ({n}, {u}) f32: warp route ms {row['ms']:.5f}, "
              f"{warp_ms:.5f}; block route ms {block_ms[0]:.5f}, "
              f"{block_ms[1]:.5f} (max_abs_err {block_err:.3e}); launch "
              f"floor {floor_ms:.5f}", flush=True)
        rows.append(row)
    # rows the warp route does not take: wider than 1024, or no multiple
    # of 16 bytes; through the wrapper, on the block route
    for d_ in (4096, 770):
        x = randn(8, d_, scale=2.0) + 0.5
        gam, bet = randn(d_, scale=0.1) + 1.0, randn(d_, scale=0.1)
        check(kln.ln_route(x, gam, bet) == "block",
              f"layer_norm_fwd (8, {d_}): not on the block route")
        err = ln_err(kln.fused_layer_norm(x, gam, bet, 1e-5),
                     kln.layer_norm_plain(x, gam, bet, 1e-5))
        print(f"layer_norm_fwd (8, {d_}) f32, block route: max_abs_err "
              f"{err:.3e} (tol 1e-5)", flush=True)
        check(err <= 1e-5, f"layer_norm_fwd (8, {d_}): max err {err}")
        rows.append({"name": "layer_norm_fwd", "case": f"(8, {d_}) f32 block "
                     "route", "max_abs_err": err, "tol": 1e-5})

    # K4: 8 lanes, lengths spread over 1..2048, and the decode step's
    # mid-decode lengths (the served batch's prompts + 16) ---------------
    r, mb = 8, 128
    nb = r * mb + 1
    perm = torch.randperm(r * mb, generator=g, device=dev)
    table = perm.reshape(r, mb).to(torch.int32).contiguous()
    q = randn(r, heads, d)
    for name, lens in (("lengths", [1, 17, 256, 511, 1000, 1500, 2047, 2048]),
                       ("mid-decode lengths", mid_decode_lengths())):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = int(lengths.sum().item())
        blocks = int(((lengths + bs - 1) // bs).sum().item())
        for kind in ("int8", "float32"):
            n_sets = 4 if kind == "int8" else 2     # > 50 MB of pools cycled
            pools = []
            for _ in range(n_sets):
                kp, vp = randn(nb, heads, bs, d), randn(nb, heads, bs, d)
                if kind == "int8":
                    kp = tnn.kv_cache_quantize(kp)
                    vp = tnn.kv_cache_quantize(vp)
                pools.append((kp.contiguous(), vp.contiguous()))
            kp, vp = pools[0]
            out = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
            ref = kpa.paged_attention_plain(q, kp, vp, table, lengths)
            check(torch.isfinite(out).all().item(),
                  f"paged_attention {kind}: non-finite output")
            # no atomics on the values: a second run gives the same bits
            again = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
            check(torch.equal(out, again),
                  f"paged_attention {kind} {name}: two runs differ")
            row_bytes = kp.shape[-1] * kp.element_size()
            # live K and V rows once, q, out, the live table entries,
            # lengths
            nbytes = (2 * live * heads * row_bytes + 2 * r * heads * d * 4
                      + 4 * blocks + 4 * r)
            rows.append(measure(
                "paged_attention",
                f"R{r} H{heads} D{d} bs{bs} MB{mb} {kind} pools, {name} "
                f"{lens}", (out - ref).abs().max().item(),
                # each span's exact softmax merged with the others against
                # one softmax over all positions: f32 sums in another order
                1e-4,
                lambda i: kpa.paged_attention_kernel(
                    q, pools[i][0], pools[i][1], table, lengths),
                lambda i: kpa.paged_attention_plain(
                    q, pools[i][0], pools[i][1], table, lengths),
                None, nbytes, 4 * live * heads * d, n_inputs=n_sets))
            check(rows[-1]["ms"] < rows[-1]["plain_ms"],
                  f"paged_attention {kind} {name}: kernel {rows[-1]['ms']} "
                  f"ms not under its plain version {rows[-1]['plain_ms']}")
            del pools

    # K5a / K5b: 8 decode tokens, one weight set per layer ----------------
    n, n_sets = 8, 12
    cl = {str(dt)[6:]: kfd.qkv_cluster(u, heads, dt)
          for dt in (torch.float32, torch.bfloat16)}
    print(f"qkv_project: cluster size at U {u} H {heads} (0: the head "
          f"route) {cl}", flush=True)
    check(all(c > 0 for c in cl.values()), f"qkv_project: U {u} H {heads} "
          f"not on the cluster route: {cl}")
    x = randn(n, u)
    wq = [randn(3 * u, u, scale=0.02) for _ in range(n_sets)]
    bq = [randn(3 * u, scale=0.02) for _ in range(n_sets)]
    q5, k5, v5 = kfd.fused_qkv_project(x, wq[0], bq[0], heads=heads,
                                       store_dtype=torch.int8)
    # fixed-order sums and an order-free amax: a second run, the same bits
    again = kfd.fused_qkv_project(x, wq[0], bq[0], heads=heads,
                                  store_dtype=torch.int8)
    check(all(torch.equal(a_, b_) for a_, b_ in zip((q5, k5, v5), again)),
          "qkv_project: two runs differ")
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
    rows[-1].update(cluster=cl["float32"], launch_floor_ms=floor_ms,
                    two_runs_bitwise=True)
    print(f"qkv_project N{n} U{u}: cluster {cl['float32']}, ms "
          f"{rows[-1]['ms']:.5f} against its bound {rows[-1]['bound_ms']:.6f} "
          f"and the launch floor {floor_ms:.5f}; two runs bitwise equal",
          flush=True)
    del wq, bq
    # N 20: three token chunks, the last one ragged; then a width whose
    # slab does not fit a cluster (U 4096, D 128: the head route). Inputs
    # are small multiples of 1/4 and 1/64, so every sum is exact in f32
    # in any order and the kernel's q and int8 K/V rows must equal the
    # plain version's byte for byte
    def dyadic(*shape, denom):
        return torch.randint(-4, 5, shape, generator=g, device=dev) / denom

    for n_, u_, h_ in ((20, u, heads), (8, 4096, 32)):
        xx, ww, bb = (dyadic(n_, u_, denom=4), dyadic(3 * u_, u_, denom=64),
                      dyadic(3 * u_, denom=4))
        c_ = kfd.qkv_cluster(u_, h_, torch.float32)
        check((c_ > 0) == (u_ == u), f"qkv_project U {u_}: cluster {c_}")
        got = kfd.fused_qkv_project(xx, ww, bb, heads=h_,
                                    store_dtype=torch.int8)
        want = kfd.qkv_project_plain(xx, ww, bb, h_, torch.int8)
        case = (f"N{n_} U{u_} H{h_} int8 store, dyadic inputs, "
                + (f"cluster {c_}" if c_ else "head route"))
        off = [int((a_ != b_).sum().item()) for a_, b_ in zip(got, want)]
        print(f"qkv_project {case}: q, K and V rows differing from the "
              f"plain version in {off} elements (must be 0)", flush=True)
        check(off == [0, 0, 0], f"qkv_project {case}: {off} elements differ")
        rows.append({"name": "qkv_project", "case": case, "max_abs_err": 0.0,
                     "elements_off": off})
        del xx, ww, bb, got, want

    # K5b: the ring route at the decode step's shape, W cold in L2 ------
    geo = {str(dt)[6:]: kfd.out_geometry(u, u, dt)
           for dt in (torch.float32, torch.bfloat16)}
    print(f"out_project: geometry at U {u}: {geo}", flush=True)
    check(all(g_["route"] == "ring" and not g_["walks"]
              for g_ in geo.values()),
          f"out_project U {u}: not on the ring route with its slab resident")
    a = randn(n, u)
    wo = [randn(u, u, scale=0.02) for _ in range(n_sets)]
    bo = [randn(u, scale=0.02) for _ in range(n_sets)]
    o5 = kfd.fused_out_project(a, wo[0], bo[0])
    # fixed-order sums: a second run, the same bits
    check(torch.equal(o5, kfd.fused_out_project(a, wo[0], bo[0])),
          "out_project: two runs differ")
    err = (o5 - kfd.out_project_plain(a, wo[0], bo[0])).abs().max().item()
    rows.append(measure(
        # f32 sums of 768 terms in another order
        "out_project", f"N{n} U{u}", err, 1e-4,
        lambda i: kfd.fused_out_project(a, wo[i], bo[i]),
        lambda i: kfd.out_project_plain(a, wo[i], bo[i]),
        lambda i: F.linear(a, wo[i], bo[i]),
        4 * (u * u + u + 2 * n * u), 2 * n * u * u, n_inputs=n_sets))
    row = rows[-1]
    row.update(geometry=geo["float32"], launch_floor_ms=floor_ms,
               two_runs_bitwise=True)
    print(f"out_project N{n} U{u} f32, cold W: ms {row['ms']:.5f} against "
          f"its bound {row['bound_ms']:.6f}, the launch floor "
          f"{floor_ms:.5f}, F.linear {row['library_ms']:.5f} "
          f"({row['library_ms'] / row['ms']:.2f}x the kernel's time); "
          "two runs bitwise equal", flush=True)
    del wo, bo
    # exact (dyadic) inputs, byte for byte against the plain version: 20
    # tokens (three chunks), a U_out no block size divides, U 4096 f32
    # (its rows just fit beside the activations), a width whose rows the
    # ring walks (U_in 4608 f32), bfloat16, and a width on the row route
    # (U_in 8192 f32)
    for n_, ui, uo, dt, route in (
            (20, u, u, torch.float32, "resident"),
            (n, u, 769, torch.float32, "resident"),
            (n, 4096, 4096, torch.float32, "resident"),
            (20, 4608, u, torch.float32, "walks"),
            (n, u, u, torch.bfloat16, "resident"),
            (n, 8192, u, torch.float32, "row")):
        g_ = kfd.out_geometry(ui, uo, dt)
        got_route = ("row" if g_["route"] == "row"
                     else "walks" if g_["walks"] else "resident")
        case = (f"N{n_} U_in {ui} U_out {uo} {str(dt)[6:]}, dyadic inputs, "
                f"{got_route} (rows {g_['rows']}, stages {g_['stages']}, "
                f"slots {g_['slots']}, blocks {g_['blocks']})")
        check(got_route == route, f"out_project {case}: expected {route}")
        aa = dyadic(n_, ui, denom=4).to(dt)
        ww, bb = dyadic(uo, ui, denom=64).to(dt), dyadic(uo, denom=4).to(dt)
        off = int((kfd.fused_out_project(aa, ww, bb)
                   != kfd.out_project_plain(aa, ww, bb)).sum().item())
        print(f"out_project {case}: {off} elements differing from the plain "
              "version (must be 0)", flush=True)
        check(off == 0, f"out_project {case}: {off} elements differ")
        rows.append({"name": "out_project", "case": case, "max_abs_err": 0.0,
                     "elements_off": off})
        del aa, ww, bb
    return rows


def mid_decode_lengths():
    """The served batch's lengths halfway through its 32 new tokens (the
    decode step of phases 4 and 5): phase 3 draws the 8 prompt lengths
    first from this generator."""
    prompt_lens = np.random.default_rng(SEED + 1).integers(16, 1025, size=8)
    return [int(n) + NEW_TOKENS // 2 for n in prompt_lens]


def paged_edge_checks(torch, dev):
    """K4 once at the edges of its split, against its plain version at
    1e-4, each run twice for bitwise-equal results: lengths span - 1,
    span and span + 1 positions (one span, and a second span of one
    position), MB * bs, one above MB * bs (capped, as on the TPU), and a
    batch of one lane; int8 and f32 pools. Then once on each path of the
    kernel that the main path's shapes do not take. Returns one row per
    case."""
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 8)
    heads, d, bs, mb = 12, 64, 16, 128
    rows = []
    span_blocks = kpa._span(_build.load("paged_attention"))
    span = span_blocks * bs
    r = 6
    lens_all = [span - 1, span, span + 1, mb * bs, mb * bs + 1, 1]
    table = (torch.randperm(r * mb, generator=g, device=dev)
             .reshape(r, mb).to(torch.int32).contiguous())
    q = torch.randn(r, heads, d, generator=g, device=dev)
    for kind in ("int8", "float32"):
        kp, vp = (torch.randn(r * mb + 1, heads, bs, d, generator=g,
                              device=dev) for _ in range(2))
        if kind == "int8":
            kp, vp = tnn.kv_cache_quantize(kp), tnn.kv_cache_quantize(vp)
        for case, (qq, tt, ll) in (
                (f"lengths {lens_all}", (q, table, lens_all)),
                ("one lane, length 1000", (q[:1], table[:1], [1000]))):
            lengths = torch.tensor(ll, dtype=torch.int32, device=dev)
            out = kpa.paged_attention_kernel(qq, kp, vp, tt, lengths)
            again = kpa.paged_attention_kernel(qq, kp, vp, tt, lengths)
            ref = kpa.paged_attention_plain(qq, kp, vp, tt, lengths)
            err = (out - ref).abs().max().item()
            print(f"paged_attention {kind} pools, span {span} positions, "
                  f"{case}: max_abs_err {err:.3e} (tol 1e-4), two runs "
                  f"bitwise equal {torch.equal(out, again)}", flush=True)
            check(torch.isfinite(out).all().item() and err <= 1e-4,
                  f"paged_attention {kind} {case}: {err}")
            check(torch.equal(out, again),
                  f"paged_attention {kind} {case}: two runs differ")
            rows.append({"name": "paged_attention", "case": f"{kind} pools, "
                         f"span {span}, {case}", "max_abs_err": err,
                         "tol": 1e-4})
    # the kernel's other paths: slices staged by plain loads (no multiple
    # of 16 bytes), 4 and 8 features a lane (D 128, 256), one slice per
    # ring stage, over 48 KB of shared memory (64 KB slices); tolerances
    # as variant_checks' (the plain version rounds weights to the pool's
    # dtype)
    f32, bf16, f16, i8 = (torch.float32, torch.bfloat16, torch.float16,
                          torch.int8)
    for q_dt, p_dt, d, bs, tol in ((f32, i8, 64, 1, 1e-4),
                                   (bf16, i8, 128, 8, 3e-2),
                                   (f32, f32, 256, 16, 1e-4),
                                   (f32, f16, 33, 3, 1e-2),
                                   (bf16, bf16, 256, 128, 3e-2)):
        r, mb = 3, max(2, 1024 // bs)
        lens = [1, span_blocks * bs + 1, mb * bs]
        table = (torch.randperm(r * mb, generator=g, device=dev)
                 .reshape(r, mb).to(torch.int32).contiguous())
        q = torch.randn(r, heads, d, generator=g, device=dev).to(q_dt)
        kp, vp = (torch.randn(r * mb + 1, heads, bs, d, generator=g,
                              device=dev) for _ in range(2))
        if p_dt == i8:
            kp, vp = tnn.kv_cache_quantize(kp), tnn.kv_cache_quantize(vp)
        else:
            kp, vp = kp.to(p_dt), vp.to(p_dt)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
        again = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
        ref = kpa.paged_attention_plain(q, kp, vp, table, lengths)
        err = (out.float() - ref.float()).abs().max().item()
        case = (f"q {str(q_dt)[6:]} pools {str(p_dt)[6:]} D{d} bs{bs} MB{mb} "
                f"lengths {lens}")
        print(f"paged_attention {case}: max_abs_err {err:.3e} (tol {tol:g}), "
              f"two runs bitwise equal {torch.equal(out, again)}", flush=True)
        check(out.dtype == ref.dtype and torch.isfinite(out).all().item()
              and err <= tol, f"paged_attention {case}: {err}")
        check(torch.equal(out, again), f"paged_attention {case}: two runs "
              "differ")
        rows.append({"name": "paged_attention", "case": case,
                     "max_abs_err": err, "tol": tol})
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


def live_pairs(lq, lk, causal):
    """(query, key) pairs attention counts: all of them, or those under
    the bottom-right causal mask k <= q + (lk - lq)."""
    if not causal:
        return lq * lk
    return sum(min(lk, max(0, q + lk - lq + 1)) for q in range(lq))


def attention_cost(b, h, lq, lk, d, causal, itemsize):
    """Bytes and f32 operations of the three attention kernels at one
    shape: every input read once and every output written once, and 2
    operations per multiply-add over the live pairs (2 products
    forward, 3 for dQ, 4 for dK/dV)."""
    pairs = b * h * live_pairs(lq, lk, causal)
    q_t, kv_t = b * h * lq * d * itemsize, b * h * lk * d * itemsize
    vec = 4 * b * h * lq                      # lse or D, f32
    return {"fwd": (q_t + 2 * kv_t + q_t + vec, 4 * d * pairs),
            "dq": (3 * q_t + 2 * kv_t + vec + q_t + vec, 6 * d * pairs),
            "dkv": (2 * q_t + 2 * kv_t + 2 * vec + 2 * kv_t, 8 * d * pairs)}


def flash_case(torch, kfa, q, k, v, go, causal, policy="highest",
               round_tf32=False):
    """K1 forward, K1c and K1d under the matmul ``policy`` and their plain
    versions on one input set, each kernel fed the kernel's own upstream
    results and each plain version the same. The plain versions run in
    IEEE f32, their operands rounded to TF32 with ``round_tf32``.
    Returns {part: (errors, max |ref|)}."""
    from mxnet_tpu_torch.base import matmul_precision_scope

    with torch.no_grad():
        with matmul_precision_scope(policy):
            out, lse = kfa.flash_forward(q, k, v, causal)
            dq, delta = kfa.flash_backward_dq(q, k, v, out, lse, go, causal)
            dk, dv = kfa.flash_backward_dkv(q, k, v, go, lse, delta, causal)
        with matmul_precision_scope("highest"):
            pout, plse = kfa.flash_forward_plain(q, k, v, causal,
                                                 round_tf32=round_tf32)
            pdq, pdelta = kfa.flash_backward_dq_plain(
                q, k, v, out, lse, go, causal, round_tf32=round_tf32)
            pdk, pdv = kfa.flash_backward_dkv_plain(
                q, k, v, go, lse, delta, causal, round_tf32=round_tf32)
    live = plse > -1e29                   # rows that see a key
    res = {}
    for part, pairs in (("out", ((out, pout),)),
                        ("lse", ((lse[live], plse[live]),)),
                        ("dq", ((dq, pdq), (delta, pdelta))),
                        ("dkv", ((dk, pdk), (dv, pdv)))):
        errs = [(a.float() - b.float()).abs().max().item() for a, b in pairs]
        scale = max(b.float().abs().max().item() for _, b in pairs)
        check(all(torch.isfinite(a).all().item() for a, _ in pairs),
              f"flash {part}: non-finite")
        res[part] = (max(errs), scale)
    return res


# Tolerances of the attention kernels against their plain versions, as a
# share of the reference's largest magnitude. f32: sums of up to 1024
# terms in another order (and an online against a two-pass softmax),
# about 1e-6 of the magnitude; 1e-5 leaves ten times that. bf16: p and
# ds are rounded to bf16 (2^-8 relative) at another scale (the running
# against the final max), and the outputs once more: 2^-5 of the largest
# value, four bf16 steps of it.
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}


def train_kernel_checks(torch, dev):
    """Phase 2, the training slice's kernels. K1 forward, K1c and K1d at
    the train step's (8, 12, 1024, 64) causal f32 and K3 at its
    (8184, 32000) f32 logits against their plain versions, timed, with
    SDPA and torch.logsumexp as library yardsticks, the three attention
    kernels also against their tensor-core bound and run twice for
    bitwise-equal results, and K1 forward under SDPA's forward; then the
    other K1 cases (non-causal, ragged L 1000, Lq 256 < Lk 1024, bf16
    (all three timed there too, beside SDPA in bf16), D 128 and D 36 in
    f32 and bf16) and K3 in bf16 once each. Returns (timed rows, other
    cases, extra timings)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import cross_entropy as kce
    from mxnet_tpu_torch.ops.kernels import flash_attention as kfa

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    rows, cases, extra = [], [], {}
    b, h, l, d = 8, 12, 1024, 64
    q, k, v, go = (randn(b, h, l, d) for _ in range(4))
    res = flash_case(torch, kfa, q, k, v, go, True)
    cost = attention_cost(b, h, l, l, d, True, 4)
    tol = FLASH_TOL["float32"]
    with torch.no_grad():
        out, lse = kfa.flash_forward(q, k, v, True)
        dq, delta = kfa.flash_backward_dq(q, k, v, out, lse, go, True)
    shape = f"B{b} H{h} L{l} D{d} causal f32"
    for name, part, kernel, plain, lib in (
            ("flash_attention_fwd", "out",
             lambda i: kfa.flash_forward(q, k, v, True),
             lambda i: kfa.flash_forward_plain(q, k, v, True),
             lambda i: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)),
            ("flash_attention_bwd_dq", "dq",
             lambda i: kfa.flash_backward_dq(q, k, v, out, lse, go, True),
             lambda i: kfa.flash_backward_dq_plain(q, k, v, out, lse, go,
                                                   True), None),
            ("flash_attention_bwd_dkv", "dkv",
             lambda i: kfa.flash_backward_dkv(q, k, v, go, lse, delta, True),
             lambda i: kfa.flash_backward_dkv_plain(q, k, v, go, lse, delta,
                                                    True), None)):
        err, scale = res[part]
        if part == "out":
            err = max(err, res["lse"][0] / max(res["lse"][1], 1.0))
        nbytes, flops = cost["fwd" if part == "out" else part]
        with torch.no_grad():
            rows.append(measure(name, shape, err, tol * max(scale, 1.0),
                                kernel, plain, lib, nbytes, flops))
    # SDPA forward + backward beside the three kernels, one call each
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd(i):
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        torch.autograd.grad(o, (qs, ks, vs), go)

    extra["sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, iters=20)[0]
    extra["k1_fwd_dq_dkv_ms"] = sum(r["ms"] for r in rows)
    # SDPA's backward alone, the yardstick of K1c + K1d: the
    # efficient-attention backward gives dQ, dK and dV in one call
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        extra["sdpa_bwd_ms"] = time_ms(
            lambda i: torch.autograd.grad(o, (qs, ks, vs), go,
                                          retain_graph=True), iters=20)[0]
    del o
    extra["k1c_k1d_ms"] = rows[1]["ms"] + rows[2]["ms"]
    for row, part in zip(rows[1:], ("dq", "dkv")):
        row["library_ms"] = extra["sdpa_bwd_ms"]   # one call for both
    # all three run on the tensor cores: that is their bound
    for row, part in zip(rows, ("fwd", "dq", "dkv")):
        use_tc_bound(row, *cost[part], "float32")
    check(rows[0]["ms"] < rows[0]["library_ms"],
          f"K1 forward {rows[0]['ms']} ms not under SDPA's forward "
          f"{rows[0]['library_ms']} ms")
    # no atomics: two runs of K1 forward, K1c and K1d give the same bits
    with torch.no_grad():
        runs = [kfa.flash_forward(q, k, v, True)
                + kfa.flash_backward_dq(q, k, v, out, lse, go, True)
                + kfa.flash_backward_dkv(q, k, v, go, lse, delta, True)
                for _ in range(2)]
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    print(f"K1 forward, K1c, K1d twice at {shape}: out, lse, dq, delta, dk, "
          f"dv bitwise equal {same}", flush=True)
    check(all(same), f"K1 forward / K1c / K1d not deterministic: {same}")
    extra["bitwise_repeatable"] = all(same)
    del runs
    print(f"attention fwd + bwd at {shape}: K1 forward + K1c + K1d "
          f"{extra['k1_fwd_dq_dkv_ms']:.5f} ms, SDPA forward + backward "
          f"{extra['sdpa_fwd_bwd_ms']:.5f} ms; K1c + K1d "
          f"{extra['k1c_k1d_ms']:.5f} ms, SDPA backward alone (efficient "
          f"attention, dQ, dK and dV in one call) "
          f"{extra['sdpa_bwd_ms']:.5f} ms", flush=True)
    del q, k, v, go, out, lse, dq, delta, qs, ks, vs

    # D 128 reaches the kernels' second tile width, D 36 the zero-padded
    # columns and, in bf16 (72-byte rows), the unaligned staging
    for case, (b, h, lq, lk, d, causal, dt) in {
            "non-causal": (2, 12, 1024, 1024, 64, False, torch.float32),
            "ragged L 1000": (2, 12, 1000, 1000, 64, True, torch.float32),
            "Lq 256 < Lk 1024": (2, 12, 256, 1024, 64, True, torch.float32),
            "bf16": (8, 12, 1024, 1024, 64, True, torch.bfloat16),
            "D 128": (2, 12, 1024, 1024, 128, True, torch.float32),
            "D 128 bf16": (2, 12, 1024, 1024, 128, True, torch.bfloat16),
            "D 36": (2, 12, 1000, 1000, 36, True, torch.float32),
            "D 36 bf16": (2, 12, 1000, 1000, 36, True,
                          torch.bfloat16)}.items():
        q, go = randn(b, h, lq, d, dtype=dt), randn(b, h, lq, d, dtype=dt)
        k, v = randn(b, h, lk, d, dtype=dt), randn(b, h, lk, d, dtype=dt)
        res = flash_case(torch, kfa, q, k, v, go, causal)
        tol = FLASH_TOL[str(dt)[6:]]
        for part, (err, scale) in res.items():
            limit = tol * max(scale, 1.0)
            print(f"flash {part} {case} B{b} H{h} Lq{lq} Lk{lk} D{d}: "
                  f"max_abs_err {err:.3e} (limit {limit:.3e})", flush=True)
            check(err <= limit, f"flash {part} {case}: {err} > {limit}")
            cases.append({"name": "flash_attention", "case": case,
                          "part": part, "max_abs_err": err, "limit": limit})
        if case == "bf16":
            extra["bf16"] = bf16_times(torch, kfa, q, k, v, go)
        del q, k, v, go

    # K3: the loss's (8 * 1023, 32000) logits, about 5% of labels -1
    n, vocab = 8 * 1023, 32000
    x = randn(n, vocab) * 2.0
    labels = torch.randint(0, vocab, (n,), generator=g, device=dev)
    labels[torch.rand(n, generator=g, device=dev) < 0.05] = -1
    lse = kce.fused_lse(x)
    err = (lse - kce.lse_plain(x)).abs().max().item()
    nll = kce.cross_entropy_with_logits(x, labels)
    with tnn.no_kernels():
        pnll = tnn.softmax_cross_entropy(x, labels, per_example=True)
    nll_err = (nll - pnll).abs().max().item()
    ignored = labels < 0
    check(bool((nll[ignored] == 0).all().item()), "K3: ignored rows not 0")
    print(f"cross_entropy_with_logits ({n}, {vocab}) f32, "
          f"{int(ignored.sum().item())} labels -1: nll max_abs_err "
          f"{nll_err:.3e} against the no_kernels path", flush=True)
    # lse of 32000 exponentials summed in another order: a few f32 ulps
    # of values near 12
    rows.append(measure(
        "cross_entropy_lse", f"({n}, {vocab}) f32", max(err, nll_err), 1e-5,
        lambda i: kce.fused_lse(x), lambda i: kce.lse_plain(x),
        lambda i: torch.logsumexp(x, -1), 4 * n * vocab + 4 * n,
        4 * n * vocab))
    xb = x.bfloat16()
    err = (kce.fused_lse(xb) - kce.lse_plain(xb)).abs().max().item()
    print(f"cross_entropy_lse ({n}, {vocab}) bf16: max_abs_err {err:.3e} "
          f"(limit 1e-5)", flush=True)
    check(err <= 1e-5, f"cross_entropy_lse bf16: {err}")
    cases.append({"name": "cross_entropy_lse", "case": "bf16",
                  "max_abs_err": err, "limit": 1e-5})
    return rows, cases, extra


# The one-pass route (the default policy, f32 operands rounded once to
# TF32), as a share of the reference's largest magnitude. Against the
# plain version that rounds the same operands: the forward rounds p
# relative to the running row max, the plain version relative to the
# final one, so each p may land one TF32 step (2^-11) apart; averaged
# over the keys that was 4.5e-5 in a CPU emulation at L 512, and 2e-4
# leaves 4x. Against the exact plain version: operands carry 10
# mantissa bits, each product is off by up to 2^-10 and sums of up to
# 1024 such terms add; 3e-4 to 6.7e-4 in that emulation, and 2e-3
# leaves 3x.
TF32_TOL, TF32_EXACT_TOL = 2e-4, 2e-3


def one_pass_checks(torch, dev):
    """Phase 2, the default policy's route: K1 forward, K1c and K1d in
    one TF32 pass at the train step's (8, 12, 1024, 64) causal f32,
    against the plain versions that round their operands to TF32
    (``TF32_TOL``) and against the exact ones (``TF32_EXACT_TOL``), run
    twice for bitwise-equal results, timed under the default policy
    against their one-pass bound, with SDPA's forward and backward under
    the same policy (TF32 allowed) as library yardsticks. Returns the
    three rows of the kernels line."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.ops.kernels import flash_attention as kfa

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    b, h, l, d = 8, 12, 1024, 64
    q, k, v, go = (torch.randn(b, h, l, d, generator=g, device=dev)
                   for _ in range(4))
    near = flash_case(torch, kfa, q, k, v, go, True, "default", True)
    exact = flash_case(torch, kfa, q, k, v, go, True, "default", False)
    cost = attention_cost(b, h, l, l, d, True, 4)
    shape = f"B{b} H{h} L{l} D{d} causal f32, one TF32 pass"
    rows = []
    with torch.no_grad(), matmul_precision_scope("default"):
        check(kfa.kernel_route(torch.float32) == "tf32",
              "the default policy does not route f32 to one TF32 pass")
        out, lse = kfa.flash_forward(q, k, v, True)
        dq, delta = kfa.flash_backward_dq(q, k, v, out, lse, go, True)
        for name, part, kernel, plain, lib in (
                ("flash_attention_fwd_tf32", "out",
                 lambda i: kfa.flash_forward(q, k, v, True),
                 lambda i: kfa.flash_forward_plain(q, k, v, True,
                                                   round_tf32=True),
                 lambda i: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True)),
                ("flash_attention_bwd_dq_tf32", "dq",
                 lambda i: kfa.flash_backward_dq(q, k, v, out, lse, go,
                                                 True),
                 lambda i: kfa.flash_backward_dq_plain(
                     q, k, v, out, lse, go, True, round_tf32=True), None),
                ("flash_attention_bwd_dkv_tf32", "dkv",
                 lambda i: kfa.flash_backward_dkv(q, k, v, go, lse, delta,
                                                  True),
                 lambda i: kfa.flash_backward_dkv_plain(
                     q, k, v, go, lse, delta, True, round_tf32=True),
                 None)):
            errs = {}
            for which, res in (("near", near), ("exact", exact)):
                err, scale = res[part]
                if part == "out":
                    err = max(err, res["lse"][0] / max(res["lse"][1], 1.0))
                errs[which] = (err, scale)
            xerr, xscale = errs["exact"]
            xlim = TF32_EXACT_TOL * max(xscale, 1.0)
            print(f"{name} {shape}: max_abs_err against the exact plain "
                  f"version {xerr:.3e} (limit {xlim:.3e})", flush=True)
            check(xerr <= xlim, f"{name}: against the exact plain version "
                  f"{xerr} > {xlim}")
            nbytes, flops = cost["fwd" if part == "out" else part]
            err, scale = errs["near"]
            row = measure(name, shape, err, TF32_TOL * max(scale, 1.0),
                          kernel, plain, lib, nbytes, flops)
            row.update(exact_err=xerr, exact_limit=xlim)
            use_tc_bound(row, nbytes, flops, "float32", passes=1)
            rows.append(row)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            sdpa_bwd = time_ms(lambda i: torch.autograd.grad(
                o, (qs, ks, vs), go, retain_graph=True), iters=20)[0]
        for row in rows[1:]:
            row["library_ms"] = sdpa_bwd     # one call for dQ, dK and dV
        runs = [kfa.flash_forward(q, k, v, True)
                + kfa.flash_backward_dq(q, k, v, out, lse, go, True)
                + kfa.flash_backward_dkv(q, k, v, go, lse, delta, True)
                for _ in range(2)]
    same = [torch.equal(a, b_) for a, b_ in zip(*runs)]
    print(f"one TF32 pass at B{b} H{h} L{l} D{d}: out, lse, dq, delta, dk, "
          f"dv bitwise equal on two runs {same}; SDPA backward with TF32 "
          f"allowed {sdpa_bwd:.5f} ms against K1c + K1d "
          f"{rows[1]['ms'] + rows[2]['ms']:.5f}", flush=True)
    check(all(same), f"one-pass K1 not deterministic: {same}")
    return rows


def bf16_times(torch, kfa, q, k, v, go):
    """K1 forward, K1c and K1d on the bf16 case at the train step's
    shape, timed against their tensor-core bounds and SDPA's bf16
    forward and backward (PyTorch picks the backend)."""
    import torch.nn.functional as F

    b, h, l, d = q.shape
    cost = attention_cost(b, h, l, l, d, True, 2)
    with torch.no_grad():
        fwd_ms = time_ms(lambda i: kfa.flash_forward(q, k, v, True))[0]
        sdpa_fwd_ms = time_ms(lambda i: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))[0]
        out, lse = kfa.flash_forward(q, k, v, True)
        _, delta = kfa.flash_backward_dq(q, k, v, out, lse, go, True)
        dq_ms = time_ms(lambda i: kfa.flash_backward_dq(
            q, k, v, out, lse, go, True))[0]
        dkv_ms = time_ms(lambda i: kfa.flash_backward_dkv(
            q, k, v, go, lse, delta, True))[0]
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    sdpa_ms = time_ms(lambda i: torch.autograd.grad(
        o, (qs, ks, vs), go, retain_graph=True), iters=20)[0]
    res = {"fwd_ms": fwd_ms, "sdpa_fwd_ms": sdpa_fwd_ms, "dq_ms": dq_ms,
           "dkv_ms": dkv_ms, "sdpa_bwd_ms": sdpa_ms,
           "fwd_tc_bound_ms": tc_bound_ms(*cost["fwd"], "bfloat16")[0],
           "dq_tc_bound_ms": tc_bound_ms(*cost["dq"], "bfloat16")[0],
           "dkv_tc_bound_ms": tc_bound_ms(*cost["dkv"], "bfloat16")[0]}
    print(f"bf16 at B{b} H{h} L{l} D{d} causal: K1 forward {fwd_ms:.5f} ms "
          f"(tensor-core bound {res['fwd_tc_bound_ms']:.6f}), SDPA bf16 "
          f"forward {sdpa_fwd_ms:.5f} ms; K1c "
          f"{dq_ms:.5f} ms (bound {res['dq_tc_bound_ms']:.6f}), "
          f"K1d {dkv_ms:.5f} ms (bound {res['dkv_tc_bound_ms']:.6f}), "
          f"together {dq_ms + dkv_ms:.5f}; SDPA bf16 backward {sdpa_ms:.5f} "
          f"ms", flush=True)
    return res


def rms_tol(dtype, ref):
    """K2r's tolerance against its plain version, from the largest
    magnitude of the reference: f32 sums of up to 8192 terms in another
    order, 2e-6 of it; bf16 values rounded once from f32 on both sides,
    one bf16 ulp (2^-7) of it."""
    rel = 2e-6 if dtype == "float32" else 2.0 ** -7
    return rel * max(ref.float().abs().max().item(), 1.0)


def frontdoor_kernel_checks(torch, dev):
    """Phase 2, the front-door slice's kernels. K2r forward at the
    stack's (8192, 768) and (8, 768) in f32 (timed, against
    torch.nn.functional.rms_norm) and bf16, a ragged D 1000 with 37 rows
    (no block multiple), and its backward through the autograd Function
    against the plain port of _rms_bwd; then kernel R: NVRTC compiles
    USER_SOURCE, axpy on 2^24 floats and row_absmax_scale on the stack's
    (8192, 768) input must equal their torch expressions exactly (f32),
    each timed against its bound and one torch call. Returns (timed rows,
    other cases, the compiled module, extra numbers)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops.kernels import layer_norm as kln

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    rows, cases, extra = [], [], {}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(dtype)

    for n, d in ((8192, 768), (8, 768), (37, 1000)):
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt)[6:]
            x = (randn(n, d, scale=2.0) + 0.5).to(dt)
            gam = (randn(d, scale=0.1) + 1.0).to(dt)
            y, rstd = kln.fused_rms_norm(x, gam, 1e-6)
            py, prstd = kln.rms_norm_plain(x, gam, 1e-6)
            check(y.dtype == py.dtype == dt, f"rms_norm_fwd {name}: dtype")
            errs = {"y": ((y.float() - py.float()).abs().max().item(),
                          rms_tol(name, py)),
                    "rstd": ((rstd - prstd).abs().max().item(),
                             rms_tol("float32", prstd))}
            if (n, d) != (8, 768):
                xg = x.detach().requires_grad_()
                gg = gam.detach().requires_grad_()
                gy = randn(n, d, dtype=dt)
                dx, dgam = torch.autograd.grad(
                    kln.fused_rms_norm(xg, gg, 1e-6)[0], (xg, gg), gy)
                pdx, pdgam = kln.rms_norm_backward(x, gam, prstd, gy)
                for part, a, b in (("dx", dx, pdx), ("dgamma", dgam, pdgam)):
                    errs[part] = ((a.float() - b.float()).abs().max().item(),
                                  rms_tol(name, b))
            case = f"({n}, {d}) {name}"
            for part, (err, tol) in errs.items():
                check(torch.isfinite(torch.tensor(err)).item()
                      and err <= tol,
                      f"rms_norm_fwd {case} {part}: {err} > {tol}")
            print(f"rms_norm_fwd {case}: " + ", ".join(
                f"{k} max_abs_err {e:.3e} (tol {t:.3e})"
                for k, (e, t) in errs.items()), flush=True)
            cases.append({"name": "rms_norm_fwd", "case": case,
                          "errors": errs})
            if dt == torch.float32 and d == 768:
                err = max(errs["y"][0], errs["rstd"][0])
                tol = max(errs["y"][1], errs["rstd"][1])
                rows.append(measure(
                    "rms_norm_fwd", case, err, tol,
                    lambda i: kln.fused_rms_norm(x, gam, 1e-6),
                    lambda i: kln.rms_norm_plain(x, gam, 1e-6),
                    lambda i: F.rms_norm(x, (d,), gam, 1e-6),
                    4 * (2 * n * d + d + n), 4 * n * d))

    # kernel R ---------------------------------------------------------------
    major, minor = rtc.nvrtc_version()
    t0 = time.perf_counter()
    mod = rtc.CudaModule(USER_SOURCE, exports=["axpy", "row_absmax_scale"])
    extra["nvrtc_version"] = f"{major}.{minor}"
    extra["compile_s"] = time.perf_counter() - t0
    print(f"NVRTC {major}.{minor}: compiled the user module (axpy, "
          f"row_absmax_scale) for sm_90a in {extra['compile_s']:.3f} s",
          flush=True)
    axpy = mod.get_kernel("axpy", "int n, const float *x, const float *y, "
                          "float *o")
    n = 1 << 24
    x, y = randn(n), randn(n)
    grid = ((n + 255) // 256,)

    def run_axpy(i):
        return axpy.launch([n, x, y], out_shapes=[(n,)], grid=grid,
                           block=(256,))

    exact = torch.equal(run_axpy(0), 2 * x + y)
    check(exact, "rtc axpy differs from 2 * x + y")
    ms, _ = time_ms(run_axpy)
    plain_ms, _ = time_ms(lambda i: 2 * x + y)
    lib_ms, _ = time_ms(lambda i: torch.add(y, x, alpha=2))
    bms, by = bound_ms(12 * n, 2 * n)
    extra["axpy"] = {"n": n, "exact": exact, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}
    print(f"rtc axpy on 2^24 floats: equal to 2 * x + y; ms {ms:.5f} "
          f"plain_ms {plain_ms:.5f} library_ms {lib_ms:.5f} (torch.add "
          f"alpha=2) bound_ms {bms:.6f} ({by}, 12 bytes per element)",
          flush=True)
    scale = mod.get_kernel("row_absmax_scale", "const float *x, int d, "
                           "float *o")
    rn, d = FD_B * FD_L, FD_UNITS
    xs = randn(rn, d)
    want = xs / xs.abs().amax(-1, keepdim=True)
    got = row_scale(scale, xs)
    check(torch.equal(got, want), "rtc row_absmax_scale differs from x / "
          "max|x| per row")
    # 64 KB of dynamic shared memory (above the 48 KB default): 1024 rows
    big = scale.launch([xs[:1024], d], out_shapes=[(1024, d)], grid=(1024,),
                       block=(1024,), shared_mem=64 * 1024)
    check(torch.equal(big, want[:1024]), "rtc row_absmax_scale with 64 KB "
          "of dynamic shared memory differs")
    rows.append(measure(
        "rtc_row_absmax_scale", f"({rn}, {d}) f32, grid {rn}, block "
        f"{ROW_SCALE_THREADS}, {4 * ROW_SCALE_THREADS} B dynamic shared",
        0.0, 0.0, lambda i: row_scale(scale, xs),
        lambda i: xs / xs.abs().amax(-1, keepdim=True),
        lambda i: F.normalize(xs, p=float("inf"), dim=-1),
        8 * rn * d, 2 * rn * d))
    del x, y, xs, want, got, big
    return rows, cases, mod, extra


def row_scale(kernel, x):
    """The user kernel row_absmax_scale on (N, D) rows: x / max|x| per
    row, one block per row."""
    n, d = x.shape
    return kernel.launch([x, d], out_shapes=[(n, d)], grid=(n,),
                         block=(ROW_SCALE_THREADS,),
                         shared_mem=4 * ROW_SCALE_THREADS)


# the front-door path: gpt_like's widths (model_zoo/bert.py:224)
FD_UNITS, FD_HIDDEN, FD_LAYERS = 768, 3072, 12
FD_B, FD_L, FD_STEPS = 8, 1024, 5
FD_PARAMS = FD_LAYERS * (2 * FD_UNITS * FD_HIDDEN + FD_HIDDEN + 2 * FD_UNITS) \
    + FD_UNITS


def ffn_stack(gluon, layers=FD_LAYERS, units=FD_UNITS, hidden=FD_HIDDEN):
    """layers x [x + Dense(units)(Dense(hidden, gelu)(RMSNorm()(x)))] and
    a final RMSNorm, each layer without in_units/in_channels, from the
    port's Gluon (tests/test_torch_frontdoor.py builds the same stack in
    both packages)."""
    nn = gluon.nn

    class FFNBlock(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.norm = nn.RMSNorm()
            self.ffn_1 = nn.Dense(hidden, activation="gelu", flatten=False)
            self.ffn_2 = nn.Dense(units, flatten=False)

        def forward(self, x):
            return x + self.ffn_2(self.ffn_1(self.norm(x)))

    net = nn.HybridSequential()
    for _ in range(layers):
        net.add(FFNBlock())
    net.add(nn.RMSNorm())
    return net


def frontdoor_steps(torch, dev, card, wrappers, step, profile, policy):
    """Phase 8's timed steps under the matmul ``policy`` (set by the
    caller): a warm-up step, then 5 timed steps with exact launch counts
    and a loss that falls below the warm-up's."""
    first = step().mean().item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    losses, host_ms, span_ms = [], [], []
    for _ in range(FD_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        loss = step()
        end.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        span_ms.append(start.elapsed_time(end))
        losses.append(loss.mean().item())
    counts = {k: w.launches for k, w in wrappers.items()}
    want = dict({k: 0 for k in wrappers},
                rms_norm_fwd=FD_STEPS * (FD_LAYERS + 1),
                rtc_row_absmax_scale=FD_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)) and np.isfinite(first),
          f"non-finite loss {first} {losses}")
    check(losses[-1] < first, f"loss did not fall: {first} -> {losses}")
    check(counts == want, f"front-door launches {counts} != {want}")
    step_ms = float(np.mean(host_ms))
    out = {"warmup_loss": first, "losses": losses, "host_ms": host_ms,
           "device_span_ms": span_ms, "step_ms": step_ms,
           "tok_s": FD_B * FD_L / step_ms * 1e3, "max_memory_allocated": peak,
           "launches": counts, "policy": policy}
    print(f"front door on {card}, matmul precision {policy}: RMSNorm FFN "
          f"stack ({FD_LAYERS} blocks, {FD_UNITS}/{FD_HIDDEN}) B{FD_B} "
          f"L{FD_L} Adam lr 1e-3, L2Loss; loss {first:.6f} (warm-up) -> "
          f"{[round(v, 6) for v in losses]}; step ms (host wall to a "
          f"synchronise) {[round(v, 3) for v in host_ms]}, device span ms "
          f"(CUDA events) {[round(v, 3) for v in span_ms]}; "
          f"{out['tok_s']:.1f} tokens/s; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB; launches over {FD_STEPS} steps {counts}",
          flush=True)
    if profile:
        dev_ms, wall_ms = profile_train_step(
            torch, step, f"frontdoor_profile_{policy}.txt")
        out["profile"] = {"device_ms": dev_ms, "wall_ms": wall_ms}
        print(f"front-door step ({policy}), profiler: device ms summed over "
              f"kernels {'not measured' if dev_ms is None else f'{dev_ms:.3f}'}"
              f", wall ms {wall_ms:.3f}"
              + ("" if dev_ms is None else
                 f", device busy {dev_ms / wall_ms:.3f}"), flush=True)
    return out


def frontdoor_phase(torch, card, wrappers, scale_kernel, profile):
    """Phase 8: the front-door path. The RMSNorm FFN stack is built with
    deferred shapes, initialized with Xavier on gpu(0), and trained with
    Adam (lr 1e-3) on L2Loss against a target: inputs and targets
    (8, 1024, 768) from mx.np.random.normal at seed 0, each step's input
    scaled per row by the user kernel row_absmax_scale (kernel R). One
    warm-up step completes the shapes; 5 timed steps follow, with exact
    launch counts and a falling loss. Then a B 2 step through the kernels
    against no_kernels, and a .params round trip into a fresh stack."""
    import shutil

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.ops import nn as tnn

    dev = mx.context.resolve_device(None)
    net = ffn_stack(mx.gluon)
    net.initialize(mx.init.Xavier())                  # gpu(0) by default
    params = net.collect_params()
    deferred = [n for n, p in params.items() if not p.initialized]
    check(len(deferred) == 3 * FD_LAYERS + 1 and all(
        0 in params[n].shape for n in deferred),
        f"deferred before the first forward: {deferred}")
    mx.np.random.seed(SEED)
    x = mx.np.random.normal(size=(FD_B, FD_L, FD_UNITS))
    target = mx.np.random.normal(size=(FD_B, FD_L, FD_UNITS))
    loss_fn = mx.gluon.loss.L2Loss()
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-3})
    rows = FD_B * FD_L

    def step():
        inp = row_scale(scale_kernel, x.reshape(rows, FD_UNITS))
        with autograd.record():
            loss = loss_fn(net(inp.reshape(x.shape)), target)
        autograd.backward(loss)
        trainer.step(FD_B)
        return loss.detach()

    t0 = time.perf_counter()
    first = step().mean().item()                      # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    n_params = sum(p.data().numel() for p in params.values())
    check(all(p.initialized for p in params.values()), "deferred after the "
          "first forward")
    check(n_params == FD_PARAMS, f"{n_params} parameters != {FD_PARAMS}")
    check(params["0.ffn_1.weight"].shape == (FD_HIDDEN, FD_UNITS)
          and params[f"{FD_LAYERS - 1}.ffn_2.weight"].shape
          == (FD_UNITS, FD_HIDDEN)
          and params[f"{FD_LAYERS}.gamma"].shape == (FD_UNITS,),
          "completed shapes")
    print(f"front door: the RMSNorm FFN stack had {len(deferred)} deferred "
          f"parameters before its first forward; after it, {n_params} "
          f"parameters on {params['0.ffn_1.weight'].data().device} "
          f"(warm-up step {warm_s:.2f} s)", flush=True)
    out = {"batch": FD_B, "seq": FD_L, "params": n_params,
           "warmup_loss": first, "card": card}
    for policy in ("highest", "default"):
        with matmul_precision_scope(policy):
            out[policy] = frontdoor_steps(torch, dev, card, wrappers, step,
                                          profile, policy)

    # B 2 through the kernels against no_kernels -----------------------------
    inp = row_scale(scale_kernel, x[:2].reshape(2 * FD_L, FD_UNITS)).reshape(
        2, FD_L, FD_UNITS)

    def grads():
        for w in wrappers.values():
            w.launches = 0
        with autograd.record():
            loss = loss_fn(net(inp), target[:2])
        autograd.backward(loss)
        got = {n: p.grad().clone() for n, p in params.items()}
        net.zero_grad(set_to_none=True)
        return loss.detach(), got, {k: w.launches for k, w in wrappers.items()}

    loss_k, grad_k, counts_k = grads()
    with tnn.no_kernels():
        loss_p, grad_p, counts_p = grads()
    check(counts_k == dict({k: 0 for k in wrappers},
                           rms_norm_fwd=FD_LAYERS + 1),
          f"one forward launched {counts_k}")
    check(not any(counts_p.values()), f"no_kernels launched {counts_p}")
    loss_err = (loss_k - loss_p).abs().max().item()
    check(loss_err <= 1e-5 * loss_p.abs().max().item(),
          f"front-door loss kernels vs plain: {loss_err}")
    worst, worst_name = 0.0, None
    for name, gp in grad_p.items():
        gk = grad_k[name]
        check(torch.isfinite(gk).all().item(), f"{name}: non-finite grad")
        ratio = ((gk - gp).abs().max() / gp.abs().max()).item()
        if ratio > worst:
            worst, worst_name = ratio, name
        if name.endswith("gamma"):
            check(gk.abs().max().item() > 0, f"{name}: zero gradient")
    check(worst <= 1e-3, f"gradient {worst_name}: {worst} > 1e-3")
    with matmul_precision_scope("default"):
        loss_d, grad_d, _ = grads()
    out["default_vs_highest"] = policy_diff(torch, "front door B2", loss_d,
                                            grad_d, loss_k, grad_k)
    n_gamma = sum(n.endswith("gamma") for n in grad_p)
    print(f"front door B2 L{FD_L}, kernels vs no_kernels on the card: loss "
          f"{loss_k.tolist()} vs {loss_p.tolist()} (max err "
          f"{loss_err:.3e}); {len(grad_p)} gradients, worst max|err| / "
          f"max|g| {worst:.3e} ({worst_name}, limit 1e-3); all {n_gamma} "
          f"RMSNorm gains have non-zero gradients; launches {counts_k}",
          flush=True)
    out["grad_check"] = {"loss_err": loss_err, "worst_grad_ratio": worst,
                         "worst_grad": worst_name, "launches": counts_k}

    # .params round trip into a fresh stack ----------------------------------
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "mxnet_tpu_torch", "_build", "chip_smoke_params")
    os.makedirs(tmp, exist_ok=True)
    try:
        fname = os.path.join(tmp, "ffn_stack.params")
        net.save_parameters(fname)
        size = os.path.getsize(fname)
        fresh = ffn_stack(mx.gluon)
        fresh.load_parameters(fname)                  # gpu(0) by default
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fp = fresh.collect_params()
    check(list(fp) == list(params), "fresh stack names differ")
    for name, p in params.items():
        check(torch.equal(fp[name].data(), p.data()),
              f"{name}: .params round trip not bitwise")
    with torch.no_grad():
        same = torch.equal(fresh(inp), net(inp))
    check(same, "fresh stack's output differs after load_parameters")
    print(f"front door .params round trip: {size} bytes, all {len(fp)} "
          f"parameters bitwise equal in a fresh stack, same output",
          flush=True)
    out["params_bytes"] = size
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

    dev = model.word_embed.weight.data().device
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


def replay_equals_eager(torch, model, run, args, gen, prompt, wrappers):
    """Phase 4: one replay of the decode graph gives bitwise the next
    tokens and pools of one eager call of the same program on the same
    inputs, with the same launches; the same for the prefill of
    ``prompt`` in its bucket. Each graph is captured first (its capture
    runs the step once), the pools are reset in place, and then it
    replays once."""
    from mxnet_tpu_torch.gluon.model_zoo.generation import (
        paged_prefill_program)

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def zero():
        for w in wrappers.values():
            w.launches = 0

    out = {}
    toks, pk, pv, table, pos = args
    bs = 16
    p = len(prompt)
    bucket = bs * max(1, 1 << (-(-p // bs) - 1).bit_length())
    nb = bucket // bs
    prog = paged_prefill_program(model, prefill_len=bucket, block_size=bs,
                                 kv_cache_dtype="int8")
    ids = torch.arange(nb, dtype=torch.int64)
    padded = torch.zeros((1, bucket), dtype=torch.int32)
    padded[0, :p] = torch.from_numpy(prompt)
    fresh = model.init_block_pool(nb + 1, bs, dtype="int8")
    cases = (("decode", run, (pk, pv),
              lambda call, k_, v_: call(toks, k_, v_, table, pos, gen)),
             (f"prefill bucket {bucket}", prog, fresh,
              lambda call, k_, v_: call(padded, p - 1, k_, v_, ids, gen)))
    for name, program, pools, call in cases:
        gk, gv = (t.clone() for t in pools)
        call(program, gk, gv)                     # captures
        gk.copy_(pools[0])
        gv.copy_(pools[1])
        zero()
        got = call(program, gk, gv)[0].clone()
        replay_counts = counts()
        ek, ev = (t.clone() for t in pools)
        zero()
        want = call(program.eager, ek, ev)[0]
        eager_counts = counts()
        same = {"tokens": torch.equal(got, want),
                "pool_k": torch.equal(gk, ek), "pool_v": torch.equal(gv, ev),
                "launches": replay_counts == eager_counts}
        print(f"{name}: one replay against one eager call, bitwise equal "
              f"{same}; launches {replay_counts}", flush=True)
        check(all(same.values()), f"{name}: replay differs from eager {same}")
        out[name] = dict(same, launches=replay_counts)
        del gk, gv, ek, ev
    return out


def sampling_check(torch, model, prompt):
    """A sampling engine (top-k 50, temperature 0.8) replays graphs that
    draw from its generator: two requests for the same prompt give tokens
    in the vocabulary that differ, and the generator's offset advanced."""
    from mxnet_tpu_torch.serving.llm import LLMEngine

    with LLMEngine(model, greedy=False, temperature=0.8, top_k=50,
                   seed=3) as eng:
        eng.warmup([len(prompt)])
        state = eng._gen.get_state().clone()
        outs = [eng.generate(prompt, 8) for _ in range(2)]
        moved = not torch.equal(state, eng._gen.get_state())
        graphs = eng.stats()["graphs"]
    ok = all(((o >= 0) & (o < CFG["vocab_size"])).all() for o in outs)
    print(f"sampling engine (top-k 50, temperature 0.8) replaying graphs: "
          f"{outs[0].tolist()} then {outs[1].tolist()}; generator moved "
          f"{moved}; graphs {graphs}", flush=True)
    check(ok and moved and not np.array_equal(outs[0], outs[1]),
          "sampling through the graphs does not draw anew")
    return {"tokens": [o.tolist() for o in outs], "generator_moved": moved,
            "graphs": graphs}


def prefill_times(torch, model, card, prompts, buckets):
    """Phase 5: each bucket of the served run's prefills, replayed and
    eager, device against host ms (int8 pools, a prompt of the served
    run that falls in the bucket)."""
    from mxnet_tpu_torch.gluon.model_zoo.generation import (
        paged_prefill_program)

    dev = model.word_embed.weight.data().device
    gen = torch.Generator(device=dev)
    bs, out = 16, {}
    for bucket in buckets:
        prompt = next((q for q in prompts
                       if bucket // 2 < len(q) <= bucket), None)
        if prompt is None:
            continue
        p, nb = len(prompt), bucket // bs
        prog = paged_prefill_program(model, prefill_len=bucket,
                                     block_size=bs, kv_cache_dtype="int8")
        pk, pv = model.init_block_pool(nb + 1, bs, dtype="int8")
        # inputs on the card: a copy from pageable host memory would wait
        # for time_ms's spin kernel
        ids = torch.arange(nb, dtype=torch.int64, device=dev)
        last = torch.tensor([p - 1], dtype=torch.int64, device=dev)
        padded = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
        padded[0, :p] = torch.from_numpy(prompt).to(dev)
        row = {"prompt": p}
        for mode, call in (("replayed", prog), ("eager", prog.eager)):
            dev_ms, host_ms = time_ms(
                lambda i: call(padded, last, pk, pv, ids, gen), iters=10,
                warmup=2)
            row[mode] = {"device_ms": dev_ms, "host_ms": host_ms,
                         "device_busy": dev_ms / host_ms}
        out[bucket] = row
        print(f"prefill bucket {bucket} (prompt {p}) on {card}: replayed "
              f"device_ms {row['replayed']['device_ms']:.4f} host_ms "
              f"{row['replayed']['host_ms']:.4f} (busy "
              f"{row['replayed']['device_busy']:.3f}); eager device_ms "
              f"{row['eager']['device_ms']:.4f} host_ms "
              f"{row['eager']['host_ms']:.4f} (busy "
              f"{row['eager']['device_busy']:.3f})", flush=True)
        del pk, pv
    return out


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


TRAIN_B, TRAIN_L, TRAIN_STEPS = 8, 1024, 5
# launches per train step of gpt_like (12 layers): K1 forward, K1c and
# K1d once per layer, K3 once, K2 for ln1, ln2 of each layer and final_ln
TRAIN_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
                  "flash_attention_bwd_dkv": 12, "cross_entropy_lse": 1,
                  "layer_norm_fwd": 25, "paged_attention": 0,
                  "qkv_project": 0, "out_project": 0, "rms_norm_fwd": 0,
                  "rtc_row_absmax_scale": 0}


def kernel_wrappers():
    """name in the kernels line -> the wrapper that counts its launches"""
    from mxnet_tpu_torch.ops.kernels import cross_entropy as kce
    from mxnet_tpu_torch.ops.kernels import flash_attention as kfa
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd
    from mxnet_tpu_torch.ops.kernels import layer_norm as kln
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa
    from mxnet_tpu_torch.rtc import CudaKernel

    return {"layer_norm_fwd": kln.fused_layer_norm,
            "paged_attention": kpa.paged_attention_kernel,
            "qkv_project": kfd.fused_qkv_project,
            "out_project": kfd.fused_out_project,
            "flash_attention_fwd": kfa.flash_forward,
            "flash_attention_bwd_dq": kfa.flash_backward_dq,
            "flash_attention_bwd_dkv": kfa.flash_backward_dkv,
            "cross_entropy_lse": kce.fused_lse,
            "rms_norm_fwd": kln.fused_rms_norm,
            # every runtime-compiled kernel's launches (a class counter)
            "rtc_row_absmax_scale": CudaKernel}


def train_loss(model, tokens):
    """The next-token loss of the Gluon train loop, per sequence."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(model(tokens)[:, :-1],
                                         tokens[:, 1:])
    autograd.backward(loss)
    return loss.detach()


def train_grad_check(torch, model, dev, wrappers):
    """Phase 6: one full-width backward at B 2, L 1024 through the kernels
    and the same under ``no_kernels`` (the plain path: dense f32
    attention, plain LayerNorm and logsumexp) on the card. The losses
    agree to 1e-5 relative and each parameter's gradient to 1e-3 of its
    largest magnitude (f32 sums in another order through 12 layers and
    the 32000-way softmax); no kernel launches under ``no_kernels``; every
    LayerNorm gain gets a non-zero gradient through K2's backward. Then
    the same step under the default policy against the kernels' step
    (:func:`policy_diff`)."""
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.ops import nn as tnn

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    tokens = torch.randint(0, CFG["vocab_size"], (2, TRAIN_L),
                           generator=gen, device=dev)

    def grads():
        for w in wrappers.values():
            w.launches = 0
        loss = train_loss(model, tokens)
        out = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss, out, {k: w.launches for k, w in wrappers.items()}

    loss_k, grad_k, counts_k = grads()
    with tnn.no_kernels():
        loss_p, grad_p, counts_p = grads()
    check(counts_k == TRAIN_LAUNCHES,
          f"kernel step launched {counts_k} != {TRAIN_LAUNCHES}")
    check(not any(counts_p.values()), f"no_kernels launched {counts_p}")
    loss_err = (loss_k - loss_p).abs().max().item()
    check(loss_err <= 1e-5 * loss_p.abs().max().item(),
          f"train loss kernels vs plain: {loss_err}")
    worst, worst_name = 0.0, None
    for name, gp in grad_p.items():
        gk = grad_k[name]
        check(torch.isfinite(gk).all().item(), f"{name}: non-finite grad")
        ratio = ((gk - gp).abs().max() / gp.abs().max()).item()
        if ratio > worst:
            worst, worst_name = ratio, name
        if name.endswith(".gamma"):
            check(gk.abs().max().item() > 0, f"{name}: zero gradient")
    print(f"train step B2 L{TRAIN_L}, kernels vs no_kernels on the card: "
          f"loss {loss_k.tolist()} vs {loss_p.tolist()} (max err "
          f"{loss_err:.3e}); {len(grad_p)} gradients, worst max|err| / "
          f"max|g| {worst:.3e} ({worst_name}, limit 1e-3); all "
          f"{sum(n.endswith('.gamma') for n in grad_p)} LayerNorm gains "
          f"have non-zero gradients; kernel launches {counts_k}",
          flush=True)
    check(worst <= 1e-3, f"gradient {worst_name}: {worst} > 1e-3")
    with matmul_precision_scope("default"):
        loss_d, grad_d, counts_d = grads()
    policy = policy_diff(torch, "gpt_like B2", loss_d, grad_d, loss_k, grad_k)
    check(counts_d == TRAIN_LAUNCHES,
          f"default-policy step launched {counts_d} != {TRAIN_LAUNCHES}")
    return {"loss_err": loss_err, "worst_grad_ratio": worst,
            "worst_grad": worst_name, "launches": counts_k,
            "default_vs_highest": policy}


# The default policy's step (cuBLAS and K1 in one TF32 pass) against the
# "highest" step at the same weights and batch, as a share of the
# highest step's values. Each product's operands keep 10 mantissa bits
# (2^-11 relative rounding), so a matmul output is off by about 1e-3 of
# its magnitude; the loss, a mean over thousands of rows, moves far less
# (1e-3 relative leaves room), and the gradients carry the error
# through 12 layers forward and back and the 32000-way softmax: 5e-2 of
# each gradient's largest magnitude.
POLICY_LOSS_TOL, POLICY_GRAD_TOL = 1e-3, 5e-2


def policy_diff(torch, what, loss_d, grad_d, loss_h, grad_h):
    """Hold a default-policy step's loss and gradients against the
    highest-policy step's (``POLICY_LOSS_TOL``, ``POLICY_GRAD_TOL``)."""
    loss_err = ((loss_d - loss_h).abs().max()
                / loss_h.abs().max()).item()
    worst, worst_name = 0.0, None
    for name, gh in grad_h.items():
        gd = grad_d[name]
        check(torch.isfinite(gd).all().item(), f"{name}: non-finite grad")
        ratio = ((gd - gh).abs().max() / gh.abs().max()).item()
        if ratio > worst:
            worst, worst_name = ratio, name
    print(f"{what}, the default policy (TF32) against highest at the same "
          f"weights: loss relative err {loss_err:.3e} (limit "
          f"{POLICY_LOSS_TOL:g}); {len(grad_h)} gradients, worst max|err| "
          f"/ max|g| {worst:.3e} ({worst_name}, limit {POLICY_GRAD_TOL:g})",
          flush=True)
    check(loss_err <= POLICY_LOSS_TOL, f"{what}: default-policy loss "
          f"{loss_err} from highest")
    check(worst <= POLICY_GRAD_TOL, f"{what}: default-policy gradient "
          f"{worst_name} {worst} from highest")
    return {"loss_rel_err": loss_err, "worst_grad_ratio": worst,
            "worst_grad": worst_name}


def profile_train_step(torch, step, fname="train_profile.txt"):
    """``--profile``: torch.profiler over one train step; writes the table
    by kernel to chiprun_out/``fname``. Returns (device ms summed over
    kernels, wall ms of the profiled step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_device_time_total", row_limit=40)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", fname), "w") as fh:
        fh.write(table)
    print(table, flush=True)
    dev_us = sum(e.self_device_time_total for e in avgs
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
    return (dev_us / 1e3 if dev_us else None), wall_ms


def train_phase(torch, model, dev, card, wrappers, profile, policy):
    """Phase 7: gpt_like trains at full width through
    SoftmaxCrossEntropyLoss and Trainer (SGD, momentum 0.9, lr 0.01) on
    one seeded batch of 8 x 1024 tokens, run by the caller under the
    matmul ``policy`` (named in the results): one warm-up step, then 5
    timed steps with exact launch counts and a falling loss."""
    from mxnet_tpu_torch.gluon import Trainer

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    tokens = torch.randint(0, CFG["vocab_size"], (TRAIN_B, TRAIN_L),
                           generator=gen, device=dev)
    trainer = Trainer(dict(model.named_parameters()), "sgd",
                      {"learning_rate": 0.01, "momentum": 0.9})

    def step():
        loss = train_loss(model, tokens)
        trainer.step(TRAIN_B)
        return loss

    first = step().mean().item()                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    losses, host_ms, span_ms = [], [], []
    for _ in range(TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        loss = step()
        end.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        span_ms.append(start.elapsed_time(end))
        losses.append(loss.mean().item())
    counts = {k: w.launches for k, w in wrappers.items()}
    want = {k: TRAIN_STEPS * n for k, n in TRAIN_LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)) and np.isfinite(first),
          f"non-finite loss {first} {losses}")
    check(losses[-1] < first, f"loss did not fall: {first} -> {losses}")
    check(counts == want, f"train launches {counts} != {want}")
    step_ms = float(np.mean(host_ms))
    out = {"batch": TRAIN_B, "seq": TRAIN_L, "warmup_loss": first,
           "losses": losses, "host_ms": host_ms, "device_span_ms": span_ms,
           "step_ms": step_ms, "tok_s": TRAIN_B * TRAIN_L / step_ms * 1e3,
           "max_memory_allocated": peak, "launches": counts, "card": card,
           "policy": policy}
    print(f"train on {card}, matmul precision {policy}: gpt_like {CFG} "
          f"B{TRAIN_B} L{TRAIN_L} SGD "
          f"momentum 0.9 lr 0.01; loss {first:.5f} (warm-up) -> "
          f"{[round(x, 5) for x in losses]}; step ms (host wall to a "
          f"synchronise) {[round(x, 3) for x in host_ms]}, device span ms "
          f"(CUDA events) {[round(x, 3) for x in span_ms]}; "
          f"{out['tok_s']:.1f} tokens/s; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB; launches over {TRAIN_STEPS} steps "
          f"{counts}", flush=True)
    if profile:
        dev_ms, wall_ms = profile_train_step(
            torch, step, f"train_profile_{policy}.txt")
        out["profile"] = {"device_ms": dev_ms, "wall_ms": wall_ms}
        print(f"train step, profiler: device ms summed over kernels "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.3f}'}, "
              f"wall ms {wall_ms:.3f}"
              + ("" if dev_ms is None else
                 f", device busy {dev_ms / wall_ms:.3f}"), flush=True)
    return out


def write_results(results):
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(results, fh, indent=1)


# K5b's ring route without its products (the loop over a share of U_in
# runs no iteration), without the activations' copy, without the
# weights' copies
K5B_NO_FMA = ("for (int j = lane + 32 * warp; j < nvec; j += 32 * OUT_WARPS) {",
              "for (int j = lane + 32 * warp; j < 0; j += 32 * OUT_WARPS) {")
K5B_NO_X = ("u_in * sizeof(T));\n    mbar_expect_tx(xbar, bytes);\n",
            "u_in * sizeof(T));\n    mbar_expect_tx(xbar, 0);\n    return;\n")
K5B_NO_W = (
    "    mbar_expect_tx(bar0 + 8 * slot, bytes);\n"
    "    bulk_g2s(ring + (size_t)slot * stage_rows * u_in,\n"
    "             w + (int64_t)(o0 + r0) * u_in, bytes, bar0 + 8 * slot);\n",
    "    mbar_expect_tx(bar0 + 8 * slot, 0);\n")


def k5b_const(name, value):
    """The substitution (a pattern) that sets one of K5b's constants in
    fused_decode.cu."""
    return (re.compile(rf"constexpr int {name} = \d+;"),
            f"constexpr int {name} = {value};")


# --trials: builds of a source with one constant changed, timed against
# each other in one run. (source, label, [(text, replacement)])
TRIALS = (
    ("paged_attention", "span 4", [("constexpr int PA_SPAN = 8;",
                                    "constexpr int PA_SPAN = 4;")]),
    ("paged_attention", "span 8 (the source)", []),
    ("paged_attention", "span 16", [("constexpr int PA_SPAN = 8;",
                                     "constexpr int PA_SPAN = 16;")]),
    ("flash_attention", "32-row K/V tiles, 3 blocks per SM at D 64 (the "
     "source)", []),
    ("flash_attention", "64-row K/V tiles", [
        ("template <int DP> constexpr int FWD_N = Tile<DP>::N;",
         "template <int DP> constexpr int FWD_N = 64;")]),
    ("flash_attention", "4 blocks per SM at D 64", [
        ("__launch_bounds__(FA_THREADS, Tile<DP>::MIN_BLOCKS)\n"
         "flash_fwd_tc_kernel",
         "__launch_bounds__(FA_THREADS, DP <= 64 ? 4 : 1)\n"
         "flash_fwd_tc_kernel")]),
    ("fused_decode", "K5a cluster of 2", [
        ("constexpr int QKV_CLUSTER = 3;", "constexpr int QKV_CLUSTER = 2;")]),
    ("fused_decode", "K5a cluster of 3, 384 threads (the source)", []),
    ("fused_decode", "K5a cluster of 4", [
        ("constexpr int QKV_CLUSTER = 3;", "constexpr int QKV_CLUSTER = 4;")]),
    ("fused_decode", "K5a cluster of 8", [
        ("constexpr int QKV_CLUSTER = 3;", "constexpr int QKV_CLUSTER = 8;")]),
    ("fused_decode", "K5a cluster of 3, 256 threads", [
        ("constexpr int CL_THREADS = 384;", "constexpr int CL_THREADS = 256;")]),
    ("fused_decode", "K5a cluster of 3, the slab in one bulk copy", [
        ("constexpr int W_CHUNKS = 4;", "constexpr int W_CHUNKS = 1;")]),
    # diagnostic builds (results not checked): the launch and scheduling
    # of the clusters alone, and the copies, waits and epilogue without
    # the products
    ("fused_decode", "diagnostic: K5a returning at entry", [
        ("  cg::cluster_group cluster = cg::this_cluster();\n",
         "  if (n_tok >= 0) return;\n"
         "  cg::cluster_group cluster = cg::this_cluster();\n")]),
    ("fused_decode", "diagnostic: K5a without the products", [
        ("for (int j = lane + 32 * p; j < nvec; j += 32 * parts) {",
         "for (int j = lane + 32 * p; j < 0; j += 32 * parts) {")]),
    # K5b: rows a block owns (R), bulk copies of the slab (S), threads,
    # copies of the activations; the row route (out_kernel) for every
    # shape; and diagnostic builds of the ring route (results not
    # checked): the launch alone, and the copies, waits and epilogue
    # without the products, and without either copy
    *(("fused_decode", f"K5b R {r}", [k5b_const("OUT_ROWS", r)])
      for r in (4, 8, 12)),
    ("fused_decode", "K5b R 6, 1 stage, 256 threads, the activations in 4 "
     "copies (the source)", []),
    ("fused_decode", "K5b 2 stages", [k5b_const("OUT_STAGES", 2)]),
    ("fused_decode", "K5b R 12, 3 stages", [k5b_const("OUT_ROWS", 12),
                                            k5b_const("OUT_STAGES", 4)]),
    *(("fused_decode", f"K5b {t} threads",
       [k5b_const("OUT_RING_THREADS", t)]) for t in (128, 384)),
    *(("fused_decode", f"K5b the activations in {c} cop"
       f"{'ies' if c > 1 else 'y'}", [k5b_const("OUT_X_COPIES", c)])
      for c in (1, 8)),
    ("fused_decode", "K5b on the row route (out_kernel)", [
        ("      g.route = 1;\n", "      g.route = 0;\n")]),
    ("fused_decode", "diagnostic: K5b returning at entry", [
        ("  const int o0 = blockIdx.x * geo.rows;",
         "  if (n_tok >= 0) return;\n  const int o0 = blockIdx.x * geo.rows;")]),
    ("fused_decode", "diagnostic: K5b without the products", [K5B_NO_FMA]),
    ("fused_decode", "diagnostic: K5b without the products or the "
     "activations' copy", [K5B_NO_FMA, K5B_NO_X]),
    ("fused_decode", "diagnostic: K5b without the products or the weights' "
     "copies", [K5B_NO_FMA, K5B_NO_W]),
)


def trial_builds(trials):
    """Build each trial's copy of its source (one nvcc each, all started
    together) under mxnet_tpu_torch/_build/trials; returns the loaded
    libraries, with the entry points' argtypes set, and the ptxas lines."""
    import ctypes

    from mxnet_tpu_torch.ops.kernels import _build

    out = _build._OUT / "trials"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, label, subs) in enumerate(trials):
        src = (_build._SRC / f"{name}.cu").read_text()
        for old, new in subs:
            if isinstance(old, re.Pattern):
                src, hits = old.subn(new, src)
            else:
                hits = src.count(old)
                src = src.replace(old, new)
            check(hits > 0, f"trial {label}: {old!r} not in {name}.cu")
        cu, lib = out / f"{name}-{i}.cu", out / f"lib{name}-{i}.so"
        cu.write_text(src)
        procs.append((subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._SRC),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib))
    libs, logs = [], []
    for (name, label, _), (proc, lib) in zip(trials, procs):
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"trial {label}: nvcc failed\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in _build._SIGNATURES[name].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs.append(cdll)
        logs.append(ptxas_summary(log))
        for fn, regs, spill in logs[-1]:
            print(f"  trial {name} [{label}] ptxas {fn}: {regs}; {spill}")
    return libs, logs


def trial_phase(torch, dev, only=""):
    """``--trials``: the K4 span, K1 forward's tiling, K5a's cluster size
    and K5b's rows, stages and threads, each build timed twice, in turns,
    at the shapes the main paths give them, after a check against the
    plain version. ``--trials=K5b`` runs only the trials whose label
    holds ``K5b``."""
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import flash_attention as kfa
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa

    trials = [t for t in TRIALS if only in t[1]]
    libs, logs = trial_builds(trials)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 9)
    heads, d, bs, r, mb = 12, 64, 16, 8, 128
    table = (torch.randperm(r * mb, generator=g, device=dev)
             .reshape(r, mb).to(torch.int32).contiguous())
    q = torch.randn(r, heads, d, generator=g, device=dev)
    pools = {}
    for kind, n_sets in (("int8", 4), ("float32", 2)):
        pools[kind] = []
        for _ in range(n_sets):
            kp, vp = (torch.randn(r * mb + 1, heads, bs, d, generator=g,
                                  device=dev) for _ in range(2))
            if kind == "int8":
                kp, vp = tnn.kv_cache_quantize(kp), tnn.kv_cache_quantize(vp)
            pools[kind].append((kp, vp))
    paged_cases = [
        (kind, name, torch.tensor(lens, dtype=torch.int32, device=dev))
        for kind, name, lens in (
            ("int8", "lengths 1..2048",
             [1, 17, 256, 511, 1000, 1500, 2047, 2048]),
            ("int8", "mid-decode lengths", mid_decode_lengths()),
            ("float32", "lengths 1..2048",
             [1, 17, 256, 511, 1000, 1500, 2047, 2048]))]
    b, l = 8, 1024
    qkv = {dt: [torch.randn(b, heads, l, d, generator=g, device=dev).to(dt)
                for _ in range(3)] for dt in (torch.float32, torch.bfloat16)}
    # K5a at the decode step's shape, 12 weight sets (cold in L2)
    u = heads * d
    x5 = torch.randn(8, u, generator=g, device=dev)
    w5 = [(0.02 * torch.randn(3 * u, u, generator=g, device=dev),
           0.02 * torch.randn(3 * u, generator=g, device=dev))
          for _ in range(12)]
    # K5b at the decode step's shape, 12 weight sets (cold in L2)
    a5 = torch.randn(8, u, generator=g, device=dev)
    wo5 = [(0.02 * torch.randn(u, u, generator=g, device=dev),
            0.02 * torch.randn(u, generator=g, device=dev))
           for _ in range(12)]
    saved = dict(_build._libs)
    res = []
    try:
        for rep in range(2):
            for (name, label, _), lib, log in zip(trials, libs, logs):
                _build._libs[name] = lib
                row = {"source": name, "trial": label, "rep": rep,
                       "ptxas": log, "ms": {}}
                if name == "paged_attention":
                    for kind, case, lengths in paged_cases:
                        ps = pools[kind]
                        with torch.no_grad():
                            out = kpa.paged_attention_kernel(
                                q, ps[0][0], ps[0][1], table, lengths)
                            ref = kpa.paged_attention_plain(
                                q, ps[0][0], ps[0][1], table, lengths)
                        err = (out - ref).abs().max().item()
                        check(err <= 1e-4, f"trial {label}: err {err}")
                        row["ms"][f"{kind} {case}"] = time_ms(
                            lambda i: kpa.paged_attention_kernel(
                                q, ps[i][0], ps[i][1], table, lengths),
                            len(ps))[0]
                elif "K5b" in label:
                    geo = kfd.out_geometry(u, u, torch.float32)
                    if not label.startswith("diagnostic"):
                        with torch.no_grad():
                            err = (kfd.fused_out_project(a5, *wo5[0])
                                   - kfd.out_project_plain(a5, *wo5[0])
                                   ).abs().max().item()
                        check(err <= 1e-4, f"trial {label}: err {err}")
                    row["geometry"] = geo
                    row["ms"][f"N8 U{u} f32, {geo['route']} route, rows "
                              f"{geo['rows']}, stages {geo['stages']}, "
                              f"blocks {geo['blocks']}"] = time_ms(
                        lambda i: kfd.fused_out_project(a5, *wo5[i]),
                        len(wo5))[0]
                elif name == "fused_decode":
                    c = kfd.qkv_cluster(u, heads, torch.float32)
                    if not label.startswith("diagnostic"):
                        with torch.no_grad():
                            got = kfd.fused_qkv_project(
                                x5, *w5[0], heads=heads,
                                store_dtype=torch.int8)
                            want = kfd.qkv_project_plain(x5, *w5[0], heads,
                                                         torch.int8)
                        err = (got[0] - want[0]).abs().max().item()
                        check(err <= 1e-4, f"trial {label}: q err {err}")
                        int8_rows_diff(torch, got[1:], want[1:],
                                       f"trial {label}")
                    row["cluster"] = c
                    row["ms"][f"N8 U{u} int8, cluster {c}"] = time_ms(
                        lambda i: kfd.fused_qkv_project(
                            x5, *w5[i], heads=heads,
                            store_dtype=torch.int8), len(w5))[0]
                else:
                    for dt, (qq, kk, vv) in qkv.items():
                        with torch.no_grad():
                            out, _ = kfa.flash_forward(qq, kk, vv, True)
                            ref, _ = kfa.flash_forward_plain(qq, kk, vv,
                                                             True)
                        err = (out.float() - ref.float()).abs().max().item()
                        lim = FLASH_TOL[str(dt)[6:]] * max(
                            ref.float().abs().max().item(), 1.0)
                        check(err <= lim, f"trial {label} {dt}: {err}")
                        with torch.no_grad():
                            row["ms"][str(dt)[6:]] = time_ms(
                                lambda i: kfa.flash_forward(qq, kk, vv,
                                                            True))[0]
                print(f"trial {name} [{label}] run {rep + 1}: " + ", ".join(
                    f"{k} {v:.5f} ms" for k, v in row["ms"].items()),
                    flush=True)
                res.append(row)
    finally:
        _build._libs.clear()
        _build._libs.update(saved)
    if any("K5b" in t[1] for t in trials):
        res.append(k5b_landing(torch, res, a5, wo5))
    return res


def k5b_landing(torch, res, a5, wo5):
    """The rate at which K5b's slabs land: W_out's bytes over the time
    the diagnostic build without the products takes beyond the one that
    returns at entry (both ring route builds of the source), per run;
    beside it F.linear on the same inputs as a yardstick."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd

    def times(label):
        return [next(iter(r["ms"].values())) for r in res
                if r["trial"] == f"diagnostic: K5b {label}"]

    u = a5.shape[1]
    geo = kfd.out_geometry(u, u, torch.float32)
    w_bytes = 4 * u * u
    x_bytes = 4 * 8 * u * geo["blocks"]      # every block's activations
    land = [b - a for a, b in zip(times("returning at entry"),
                                  times("without the products"))]
    lin = time_ms(lambda i: F.linear(a5, *wo5[i]), len(wo5))[0]
    out = {"trial": "K5b slab landing", "w_bytes": w_bytes,
           "x_bytes_from_l2": x_bytes, "landing_ms": land,
           "w_tb_s": [w_bytes / (1e9 * ms) for ms in land],
           "w_and_x_tb_s": [(w_bytes + x_bytes) / (1e9 * ms) for ms in land],
           "f_linear_ms": lin}
    print(f"K5b slab landing at N8 U{u} f32: no-products minus "
          f"return-at-entry {land} ms per run: W_out {w_bytes} bytes at "
          f"{out['w_tb_s']} TB/s (with every block's activations from L2, "
          f"{x_bytes} bytes more: {out['w_and_x_tb_s']} TB/s) against "
          f"3.35 TB/s; F.linear {lin:.5f} ms", flush=True)
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.base import (matmul_precision,
                                      matmul_precision_scope,
                                      set_matmul_precision)
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.bert import gpt_like
    from mxnet_tpu_torch.gluon.model_zoo.generation import (
        generate, paged_decode_program)
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import _build
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
    # every check runs in IEEE f32, as the reference's tests pin
    # "highest"; the default policy's paths set it where they run
    set_matmul_precision("highest")
    print(f"matmul precision policy {matmul_precision()} (cuBLAS "
          f"{torch.backends.cuda.matmul.fp32_precision}, cuDNN conv "
          f"{torch.backends.cudnn.conv.fp32_precision})", flush=True)
    # the plain versions' half-precision products accumulate in f32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {built} in {build_s:.2f} s", flush=True)
    results["ptxas"] = {}
    for name in _build.KERNEL_SOURCES:     # cached libraries keep their log
        results["ptxas"][name] = ptxas_summary(_build.build_log(name))
        for fn, regs, spill in results["ptxas"][name]:
            print(f"  ptxas[{name}] {fn}: {regs}; {spill}")
    results["build_s"] = build_s
    # the attention kernels must multiply on the tensor cores: HMMA in
    # every instantiation of K1 forward (6: f32 in three TF32 passes and
    # in one, bf16, each at D 64 and 128), K1c and K1d (12)
    results["sass_hmma"] = {}
    for src, prefix, n in (("flash_attention", "flash_fwd_", 6),
                           ("flash_attention_bwd", "flash_bwd_", 12)):
        mma = sass_mma_counts(_build._lib_path(src))
        if mma is None:
            print(f"cuobjdump not found: SASS of {src} not inspected")
            continue
        got = {kernel_name(k): c for k, c in mma.items() if prefix in k}
        print(f"cuobjdump -sass {src}: HMMA per kernel {got}", flush=True)
        check(len(got) == n and all(got.values()),
              f"{src}: instantiations without HMMA: {got}")
        results["sass_hmma"][src] = got
    # K5a's cluster route and K5b's ring route: bulk copies, and cluster
    # barriers in K5a's int8 instantiations
    results["sass_bulk"] = bulk_copy_sass_check(
        _build._lib_path("fused_decode"))
    trials = [a for a in argv if a.split("=")[0] == "--trials"]
    if trials:
        results["trials"] = trial_phase(torch, dev,
                                        trials[0].partition("=")[2])
    # -- phase 2: kernels against their plain versions ----------------------
    results["launch_floor_ms"] = launch_floor(torch)
    rows = kernel_checks(torch, dev, results["launch_floor_ms"])
    results["paged_edges"] = paged_edge_checks(torch, dev)
    results["variants"] = variant_checks(torch, dev)
    train_rows, results["train_variants"], results["attention"] = \
        train_kernel_checks(torch, dev)
    rows += train_rows
    rows += one_pass_checks(torch, dev)
    fd_rows, results["frontdoor_variants"], user_module, results["rtc"] = \
        frontdoor_kernel_checks(torch, dev)
    rows += fd_rows
    entries = {}
    for row in rows:
        entries.setdefault(row["name"], row)
    if "--kernels" in argv:      # phases 1 and 2 only: no result line
        results["kernels"] = rows
        write_results(results)
        print("chip_smoke --kernels: phases 1 and 2 passed")
        return 0

    # -- phase 3: the main path ---------------------------------------------
    t0 = time.perf_counter()
    model = gpt_like(**CFG)                       # on gpu(0) by default
    from_jax_params(seeded_params(model, SEED), model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"gpt_like {CFG}: {n_params} parameters on "
          f"{model.word_embed.weight.data().device}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(SEED + 1)
    prompt_lens = rng.integers(16, 1025, size=8)
    prompts = [rng.integers(0, CFG["vocab_size"], size=int(p))
               .astype(np.int32) for p in prompt_lens]
    wrappers = kernel_wrappers()
    with LLMEngine(model) as eng:                 # int8 KV, block 16, 8 lanes
        # the decode graph and the prompts' prefill buckets are captured
        # ahead of traffic; a warm-up request keeps other first-call
        # costs out of the measured run
        t0 = time.perf_counter()
        buckets = eng.warmup([len(p) for p in prompts])
        warm_s = time.perf_counter() - t0
        warm = eng.stats()["graphs"]
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
    print(f"warmup: buckets {buckets}, {warm['captures']} graphs captured "
          f"in {warm['capture_s']:.3f} s ({warm_s:.3f} s in warmup())",
          flush=True)
    check(warm["captures"] == len(buckets) + 1,
          f"warmup captured {warm['captures']} graphs for {buckets}")
    for out in outs:
        check(out.shape == (NEW_TOKENS,), f"request returned {out.shape}")
        check(((out >= 0) & (out < CFG["vocab_size"])).all(),
              "token out of vocabulary")
    steps = (after["counters"]["decode_steps"]
             - before["counters"]["decode_steps"])
    prefills = after["counters"]["prefills"] - before["counters"]["prefills"]
    layers = CFG["num_layers"]
    expected = dict({k: 0 for k in wrappers},
                    layer_norm_fwd=(2 * layers + 1) * (prefills + steps),
                    paged_attention=layers * steps,
                    qkv_project=layers * steps, out_project=layers * steps)
    print(f"served {len(prompts)} requests (prompt lengths "
          f"{prompt_lens.tolist()}, {NEW_TOKENS} new tokens each): "
          f"{prefills} prefills, {steps} decode steps, launches {counts}, "
          f"expected {expected}", flush=True)
    check(prefills == len(prompts), f"{prefills} prefills")
    check(counts == expected, f"launch counts {counts} != {expected}")
    replays = after["graphs"]["replays"] - before["graphs"]["replays"]
    check(after["graphs"]["captures"] == before["graphs"]["captures"]
          and replays == prefills + steps,
          f"served run: graphs {before['graphs']} -> {after['graphs']}, "
          f"{prefills} prefills and {steps} steps")
    for row in rows:
        row["launches"] = counts.get(row["name"], 0)   # the train phases reset
    dec_s = after["decode_s"] - before["decode_s"]
    pre_s = after["prefill_s"] - before["prefill_s"]
    dec_tok = after["decode_tokens"] - before["decode_tokens"]
    serve = {"wall_s": wall, "tok_s": len(prompts) * NEW_TOKENS / wall,
             "decode_step_ms": 1e3 * dec_s / steps,
             "prefill_ms": 1e3 * pre_s / prefills,
             "decode_tok_s": dec_tok / dec_s, "decode_steps": steps,
             "prompt_lens": prompt_lens.tolist(), "buckets": buckets,
             "graph_captures": warm["captures"],
             "graph_capture_s": warm["capture_s"], "warmup_s": warm_s,
             "graph_replays": replays, "card": card}
    results["serve"] = serve
    print(f"serve on {card}, replaying CUDA graphs: prefill_ms "
          f"{serve['prefill_ms']:.3f} (mean of {prefills}), decode_step_ms "
          f"{serve['decode_step_ms']:.3f} (host wall per engine step, mean "
          f"of {steps}), tok_s {serve['tok_s']:.1f} end to end, decode "
          f"tok_s {serve['decode_tok_s']:.1f}; {replays} replays",
          flush=True)

    # -- phase 4: output checks, at the served batch's mid-decode lengths ---
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    lengths = prompt_lens + NEW_TOKENS // 2
    check(lengths.tolist() == mid_decode_lengths(), "mid-decode lengths")
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
    check(unfused_counts == dict({k: 0 for k in wrappers},
                                 layer_norm_fwd=2 * layers + 1,
                                 paged_attention=layers),
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
    print("paged engine (f32 KV, kernels, CUDA graphs) == dense generate: "
          "greedy tokens identical on 2 prompts x 8 tokens", flush=True)
    run = paged_decode_program(model)
    results["replay_vs_eager"] = replay_equals_eager(
        torch, model, run, args, g, prompts[3], wrappers)
    results["sampling"] = sampling_check(torch, model, prompts[4][:40])

    # -- phase 5: the same decode step, replayed and eager -------------------
    step = {"lengths": lengths.tolist()}
    for path in ("kernels", "plain"):
        for mode, call in (("replayed", run), ("eager", run.eager)):
            with tnn.no_kernels() if path == "plain" else nullcontext():
                dev_ms, host_ms = time_ms(lambda i: call(*args, g), iters=10,
                                          warmup=2)
            step[f"{path} {mode}"] = {"device_ms": dev_ms, "host_ms": host_ms,
                                      "device_busy": dev_ms / host_ms}
            print(f"decode step on {card}, {path} path {mode}, lengths "
                  f"{step['lengths']}: device_ms {dev_ms:.4f} host_ms "
                  f"{host_ms:.4f} (device busy {dev_ms / host_ms:.3f})",
                  flush=True)
    step["graphs"] = {"captures": run.captures, "replays": run.replays,
                      "capture_s": run.capture_s}
    if "--profile" in argv:
        prof_ms = profile_decode(torch, run, args, g)
        step["profiler_device_ms"] = prof_ms
        print(f"decode step, profiler: device ms per step summed over "
              f"kernels: {'not measured' if prof_ms is None else prof_ms}",
              flush=True)
    results["decode_step"] = step
    del args, pk, pv
    results["prefill_step"] = prefill_times(torch, model, card, prompts,
                                            buckets)

    # -- phase 6: a train step's loss and gradients, kernels against plain --
    results["train_check"] = train_grad_check(torch, model, dev, wrappers)

    # -- phase 7: the train main path, under each matmul policy ---------------
    for policy in ("highest", "default"):
        with matmul_precision_scope(policy):
            train = train_phase(torch, model, dev, card, wrappers,
                                "--profile" in argv, policy)
        results[f"train_{policy}"] = train
        for row in rows:       # the one-pass rows take the default's counts
            base = row["name"].removesuffix("_tf32")
            if ((base != row["name"]) == (policy == "default")
                    and TRAIN_LAUNCHES.get(base)
                    and base != "layer_norm_fwd"):
                row["launches"] = train["launches"][base]

    # -- phase 8: the front-door path ------------------------------------------
    del model, run         # free gpt_like: the stack's peak is its own
    torch.cuda.empty_cache()
    scale_kernel = user_module.get_kernel(
        "row_absmax_scale", "const float *x, int d, float *o")
    front = frontdoor_phase(torch, card, wrappers, scale_kernel,
                            "--profile" in argv)
    results["frontdoor"] = front
    for row in rows:
        if row["name"] in ("rms_norm_fwd", "rtc_row_absmax_scale"):
            row["launches"] = front["default"]["launches"][row["name"]]

    results["kernels"] = rows
    results["seconds"] = time.perf_counter() - t_start
    write_results(results)
    print(f"total {results['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": [{k: e[k] for k in LINE_KEYS}
                                  for e in entries.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
