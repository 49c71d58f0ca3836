"""The f32 matmul precision policy of the PyTorch port against the JAX
package, on the CPU: ``MXNET_MATMUL_PRECISION`` read at import by
``mxnet_tpu_torch/base.py`` (the reference's ``mxnet_tpu/base.py:50-70``),
the K1 router against the reference's ``_matmul_precision``, and the
plain attention that rounds its operands to TF32 as the one-pass
kernels do.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds the
one-pass route against these plain versions. Inputs come from a seeded
numpy RNG.
"""
import importlib
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from mxnet_tpu_torch import base
from mxnet_tpu_torch.ops.kernels import flash_attention as tfa

# the package re-exports the function under the module's name
jfa = importlib.import_module("mxnet_tpu.ops.pallas.flash_attention")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CASES = [(None, "default", "tf32", 0), ("default", "default", "tf32", 0),
          ("high", "highest", "ieee", 0), ("highest", "highest", "ieee", 0),
          ("bfloat16_3x", "default", "tf32", 1)]
# one process for every case: base.py is executed afresh under each value
# (it imports os, warnings, numpy and torch only), and torch's switches
# are read after each
_PROBE = """
import importlib.util, json, os, sys, warnings
import torch
mk = lambda: [torch.backends.mkldnn.matmul.fp32_precision,
              torch.backends.mkldnn.conv.fp32_precision]
untouched, out = mk(), []
for i, value in enumerate(json.loads(sys.argv[1])):
    os.environ.pop("MXNET_MATMUL_PRECISION", None)
    if value is not None:
        os.environ["MXNET_MATMUL_PRECISION"] = value
    spec = importlib.util.spec_from_file_location(f"base{i}", sys.argv[2])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        b = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(b)
    out.append([b.matmul_precision(),
                torch.backends.cuda.matmul.fp32_precision,
                torch.backends.cudnn.conv.fp32_precision,
                torch.backends.cudnn.rnn.fp32_precision,
                sum("MXNET_MATMUL_PRECISION" in str(x.message) for x in w)])
print(json.dumps({"cases": out, "untouched": untouched, "mkldnn": mk()}))
"""


@pytest.fixture(scope="module")
def policy_reads():
    import json

    res = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps([c[0] for c in _CASES]),
         os.path.join(ROOT, "mxnet_tpu_torch", "base.py")],
        capture_output=True, text=True, check=True)
    return json.loads(res.stdout)


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_policy_is_read_at_import(policy_reads, case):
    """Unset or ``default``: TF32 for cuBLAS matmuls and cuDNN
    convolutions and RNNs; ``high``/``highest``: IEEE f32; anything else
    warns, naming the variable, and keeps the default, as the reference
    does. The CPU's (mkldnn) switches are never touched."""
    _, policy, switch, warned = _CASES[case]
    assert policy_reads["cases"][case] == [policy, switch, switch, switch,
                                           warned]
    assert policy_reads["mkldnn"] == policy_reads["untouched"]


@pytest.fixture
def restore_policy():
    saved = base.matmul_precision()
    yield
    base.set_matmul_precision(saved)


def test_scope_restores_and_invalid_policy_raises(restore_policy):
    base.set_matmul_precision("default")
    with base.matmul_precision_scope("highest"):
        assert base.matmul_precision() == "highest"
        assert torch.backends.cudnn.conv.fp32_precision == "ieee"
    assert base.matmul_precision() == "default"
    assert torch.backends.cudnn.conv.fp32_precision == "tf32"
    with pytest.raises(ValueError, match="matmul precision"):
        base.set_matmul_precision("tensorfloat32")


@pytest.mark.parametrize("ambient", [None, "default", "high", "highest"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_router_matches_reference_matmul_precision(restore_policy,
                                                      ambient, dtype):
    """The port's K1 route under each ambient policy gives the precision
    the reference's ``_matmul_precision`` gives its kernel dots: bf16 and
    f32 under the default one pass (DEFAULT), f32 under ``high`` or
    ``highest`` three TF32 passes (HIGHEST)."""
    with jax.default_matmul_precision(ambient):
        want = jfa._matmul_precision(jnp.dtype(dtype))
    with base.matmul_precision_scope(ambient or "default"):
        route = tfa.kernel_route(getattr(torch, dtype))
    assert {"bf16": jax.lax.Precision.DEFAULT,
            "tf32": jax.lax.Precision.DEFAULT,
            "3xtf32": jax.lax.Precision.HIGHEST}[route] == want


def test_tf32_round_is_round_to_nearest_ties_away():
    """``tf32_round`` keeps 10 mantissa bits, rounding to nearest with
    ties away from zero (``cvt.rna.tf32.f32``), on a numpy model of the
    bits: half-way values of both signs, values just beside them,
    subnormals and random f32."""
    ulp = 2.0 ** -10
    edge = onp.float32([1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp,
                        1 + ulp / 2 - 2 ** -23, 1 + ulp / 2 + 2 ** -23,
                        3.0e-39, -7.123456, 0.0])
    x = onp.concatenate([edge, onp.random.RandomState(5).randn(1000)
                         .astype(onp.float32) * 100])
    bits = x.view(onp.uint32).astype(onp.int64)
    mag = bits & 0x7FFFFFFF
    want = ((bits & 0x80000000) | (((mag + 0x1000) >> 13) << 13)).astype(
        onp.uint32).view(onp.float32)
    got = tfa.tf32_round(torch.from_numpy(x)).numpy()
    onp.testing.assert_array_equal(got, want)
    assert got[0] == 1 + ulp and got[1] == -(1 + ulp)
    assert got[2] == 1 + 2 * ulp and got[3] == 1.0


def _qkvg(seed, lq=64, lk=64, d=16):
    rng = onp.random.RandomState(seed)
    return (rng.randn(1, 2, lq, d).astype(onp.float32),
            rng.randn(1, 2, lk, d).astype(onp.float32),
            rng.randn(1, 2, lk, d).astype(onp.float32),
            rng.randn(1, 2, lq, d).astype(onp.float32))


def _rel(got, want):
    return float(onp.abs(onp.asarray(got) - onp.asarray(want)).max()
                 / max(onp.abs(onp.asarray(want)).max(), 1.0))


@pytest.mark.parametrize("causal", [True, False])
def test_tf32_plain_attention_against_exact_and_pallas(causal):
    """The plain attention that rounds every product's operands to TF32
    (forward: q, k, v and p; backward: also dO and dS) against the exact
    plain version and against the JAX flash kernel in interpret mode
    under ``highest`` (the suite's pin): within chip_smoke's
    ``TF32_EXACT_TOL`` of the largest magnitude (10 mantissa bits a
    operand; sums of 64 terms here), and away from both by more than f32
    rounding, so the rounding does take place."""
    q, k, v, g = _qkvg(31)
    scale = 16 ** -0.5
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    jout, jlse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, scale, 16, 16,
                                    True, save_residuals=True)
    out, lse = tfa.flash_forward_plain(tq, tk, tv, causal, scale,
                                       round_tf32=True)
    xout, xlse = tfa.flash_forward_plain(tq, tk, tv, causal, scale)
    jdq, jdk, jdv = jfa._flash_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(xout.numpy()), jnp.asarray(xlse.numpy()),
        jnp.asarray(g), causal, scale, 16, 16, True)
    grads = tfa.flash_backward_plain(tq, tk, tv, xout, xlse, tg, causal,
                                     scale, round_tf32=True)
    xgrads = tfa.flash_backward_plain(tq, tk, tv, xout, xlse, tg, causal,
                                      scale)
    pairs = [(out, xout, jout), (lse, xlse, jlse)] + [
        (a, b, c) for a, b, c in zip(grads, xgrads, (jdq, jdk, jdv))]
    for got, exact, ref in pairs:
        for want in (exact.numpy(), onp.asarray(ref)):
            err = _rel(got.numpy(), want)
            assert 1e-6 < err <= chip_smoke.TF32_EXACT_TOL, err


def test_one_pass_forward_emulation_holds_chip_smoke_tolerances():
    """Why chip_smoke holds the one-pass K1 forward to ``TF32_TOL`` of its
    TF32-rounding plain version and ``TF32_EXACT_TOL`` of the exact one:
    the kernel's arithmetic emulated (S = QK^T of TF32-rounded operands,
    an online softmax over 32-key tiles in units of log2, p rounded to
    TF32 at the running max and P.V added per two 8-key k-steps, lse =
    m + log(l)) stays within both, with room."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvg(33, 256, 256, 64))
    r = tfa.tf32_round
    scale, log2e = 64 ** -0.5, 1.4426950408889634
    live = torch.ones(256, 256, dtype=torch.bool).tril()
    m = torch.full((1, 2, 256, 1), -1e30)
    l = torch.zeros(1, 2, 256, 1)
    acc = torch.zeros(1, 2, 256, 64)
    for k0 in range(0, 256, 32):
        kt, vt = k[:, :, k0:k0 + 32], v[:, :, k0:k0 + 32]
        x = (r(q) @ r(kt).transpose(-1, -2)) * (scale * log2e)
        x = x.masked_fill(~live[:, k0:k0 + 32], -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(x > -1e30, torch.exp2(x - m_new),
                        torch.zeros_like(x))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for c in range(0, 32, 16):
            acc = acc + r(p[..., c:c + 16]) @ r(vt[:, :, c:c + 16])
        m = m_new
    out, lse = acc / l, (m / log2e + torch.log(l))[..., 0]
    for tol, rounded in ((chip_smoke.TF32_TOL, True),
                         (chip_smoke.TF32_EXACT_TOL, False)):
        wout, wlse = tfa.flash_forward_plain(q, k, v, True, scale,
                                             round_tf32=rounded)
        assert _rel(out.numpy(), wout.numpy()) <= tol / 2
        assert _rel(lse.numpy(), wlse.numpy()) <= tol / 2


def test_chip_smoke_one_pass_bound_is_one_tf32_pass():
    """The kernels line's bound of the one-pass rows: one TF32 pass at
    495 TFLOP/s against the bytes; at the train step's shape the forward
    and dQ are bound by bytes and dK/dV by operations."""
    cost = chip_smoke.attention_cost(8, 12, 1024, 1024, 64, True, 4)
    got = {}
    for part, (nbytes, flops) in cost.items():
        ms, by = chip_smoke.tc_bound_ms(nbytes, flops, "float32", passes=1)
        assert ms == pytest.approx(
            1e3 * max(nbytes / 3.35e12, flops / 495e12), rel=1e-12)
        got[part] = by
        assert ms < chip_smoke.tc_bound_ms(nbytes, flops, "float32")[0]
    assert got == {"fwd": "bytes", "dq": "bytes", "dkv": "operations"}
