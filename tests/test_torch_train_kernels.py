"""Kernel modules of the training slice of the PyTorch port against the
JAX package, on the CPU: flash attention forward (K1a/K1b) and backward
(K1c/K1d), the streaming logsumexp of the loss (K3), and the LayerNorm
backward, plus the repairs of the slice-1 wrappers under grad mode.

Each port wrapper takes its plain PyTorch version for CPU tensors; the
JAX side runs its Pallas kernel in interpret mode, as the JAX package's
own tests do. Inputs come from a seeded numpy RNG. Tolerances are 2e-5
for f32 (sums of at most a few hundred f32 terms in another order).
The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds them against these same plain versions.
"""
import importlib
from contextlib import nullcontext

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops.pallas import cross_entropy as jce
from mxnet_tpu.ops.pallas import layer_norm as jln
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import FatalError
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops.kernels import cross_entropy as tce
from mxnet_tpu_torch.ops.kernels import flash_attention as tfa
from mxnet_tpu_torch.ops.kernels import fused_decode as tfused
from mxnet_tpu_torch.ops.kernels import layer_norm as tln
from mxnet_tpu_torch.ops.kernels import paged_attention as tpaged

# the package re-exports the function under the module's name
jfa = importlib.import_module("mxnet_tpu.ops.pallas.flash_attention")
F32_TOL = 2e-5


def _t(a):
    return torch.from_numpy(onp.array(a, dtype=onp.float32))


def _qkv(seed, b, h, lq, lk, d):
    rng = onp.random.RandomState(seed)
    return (rng.randn(b, h, lq, d).astype(onp.float32),
            rng.randn(b, h, lk, d).astype(onp.float32),
            rng.randn(b, h, lk, d).astype(onp.float32))


def _live_rows(lq, lk, causal):
    """Query rows that see at least one key (bottom-right causal)."""
    rows = onp.arange(lq)
    return rows + (lk - lq) >= 0 if causal else onp.ones(lq, bool)


# (lq, lk, causal): Lq = Lk ragged against the 16-block, non-causal,
# Lq < Lk bottom-right, and Lq > Lk where the first rows see no key
_CASES = [(24, 24, True), (24, 24, False), (8, 24, True), (24, 8, True)]


@pytest.mark.parametrize("lq,lk,causal", _CASES)
@pytest.mark.parametrize("body", ["resident", "streaming"])
def test_flash_forward_matches_pallas(monkeypatch, body, lq, lk, causal):
    """Port flash_forward (plain version on the CPU) against
    ``_flash_forward(save_residuals=True)`` in interpret mode, through
    the resident body (K1b) and, with the VMEM budget at 0, the
    streaming body (K1a): out everywhere (0 on rows that see no key) and
    lse on the rows that see a key (the two TPU bodies write different
    sentinels on the others)."""
    if body == "streaming":
        monkeypatch.setattr(jfa, "_RESIDENT_KV_VMEM_BYTES", 0)
    q, k, v = _qkv(lq * 100 + lk, 1, 2, lq, lk, 16)
    scale = 16 ** -0.5
    jout, jlse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, scale, 16, 16,
                                    True, save_residuals=True)
    out, lse = tfa.flash_forward(_t(q), _t(k), _t(v), causal, scale)
    live = _live_rows(lq, lk, causal)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(jout),
                                rtol=F32_TOL, atol=F32_TOL)
    assert (out.numpy()[:, :, ~live] == 0).all()
    onp.testing.assert_allclose(lse.numpy()[:, :, live],
                                onp.asarray(jlse)[:, :, live],
                                rtol=F32_TOL, atol=F32_TOL)


def test_flash_forward_bf16_matches_pallas():
    """bf16 operands: both sides round p to bf16 before P.V (at different
    running maxima), so out agrees to 2e-2, a few bf16 ulps of values
    near 1; lse is f32 from the same bf16 scores, to 2e-5."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(5, 1, 2, 24, 24, 16))
    jout, jlse = jfa._flash_forward(q, k, v, True, 0.25, 16, 16, True,
                                    save_residuals=True)
    tq, tk, tv = (_t(onp.asarray(a, onp.float32)).bfloat16()
                  for a in (q, k, v))
    out, lse = tfa.flash_forward(tq, tk, tv, True, 0.25)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    onp.testing.assert_allclose(out.float().numpy(),
                                onp.asarray(jout, onp.float32),
                                rtol=2e-2, atol=2e-2)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(jlse),
                                rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("lq,lk,causal", _CASES[:3])
def test_flash_backward_matches_pallas(lq, lk, causal):
    """Port flash_backward_dq / flash_backward_dkv (the two wrappers the
    autograd backward calls, plain versions on the CPU) and
    flash_backward_plain against ``_flash_bwd_pallas`` (K1c, K1d) in
    interpret mode, on the same out and lse: dq, dk, dv at 2e-5."""
    q, k, v = _qkv(lq * 7 + lk, 1, 2, lq, lk, 16)
    g = onp.random.RandomState(3).randn(1, 2, lq, 16).astype(onp.float32)
    scale = 16 ** -0.5
    out, lse = tfa.flash_forward_plain(_t(q), _t(k), _t(v), causal, scale)
    want = jfa._flash_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(g),
        causal, scale, 16, 16, True)
    dq, delta = tfa.flash_backward_dq(_t(q), _t(k), _t(v), out, lse, _t(g),
                                      causal, scale)
    dk, dv = tfa.flash_backward_dkv(_t(q), _t(k), _t(v), _t(g), lse, delta,
                                    causal, scale)
    plain = tfa.flash_backward_plain(_t(q), _t(k), _t(v), out, lse, _t(g),
                                     causal, scale)
    for got, ref, w in zip((dq, dk, dv), plain, want):
        onp.testing.assert_allclose(got.numpy(), onp.asarray(w),
                                    rtol=F32_TOL, atol=F32_TOL)
        onp.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_matches_torch_autograd(causal):
    """The port's flash_attention (a torch.autograd.Function) on the CPU
    against torch.autograd through the dense mha_plain: out and the
    gradients of q, k and v at 2e-5, Lq < Lk."""
    q, k, v = (_t(a).requires_grad_() for a in _qkv(9, 2, 2, 12, 20, 8))
    g = _t(onp.random.RandomState(4).randn(2, 2, 12, 8))
    with autograd.record():
        out = tfa.flash_attention(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), g)
    with autograd.record():
        ref = tfa.mha_plain(q, k, v, causal=causal)
    ref_grads = torch.autograd.grad(ref, (q, k, v), g)
    onp.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                                rtol=F32_TOL, atol=F32_TOL)
    for a, b in zip(grads, ref_grads):
        onp.testing.assert_allclose(a.numpy(), b.numpy(), rtol=F32_TOL,
                                    atol=F32_TOL)


@pytest.mark.parametrize("mask_kind", ["none", "bool", "additive",
                                       "no_kernels"])
def test_attend_matches_jax_attend(mask_kind):
    """ops.nn.attend over (B, L, H*D) projections, causal, against the JAX
    attend under no_pallas (its masked f32-softmax path): flash attention
    with no mask, the masked path with a boolean or an additive mask, and
    the masked path inside no_kernels. Out and the gradients of q, k and v
    at 2e-5."""
    rng = onp.random.RandomState(15)
    q, k, v = (rng.randn(2, 10, 24).astype(onp.float32) for _ in range(3))
    g = rng.randn(2, 10, 24).astype(onp.float32)
    mask = None
    if mask_kind == "bool":
        mask = rng.rand(2, 1, 10, 10) < 0.7
        mask[..., onp.arange(10), onp.arange(10)] = True
    elif mask_kind == "additive":
        mask = rng.randn(2, 1, 10, 10).astype(onp.float32)
    with jnn.no_pallas():
        jout, vjp = jax.vjp(
            lambda a, b, c: jnn.attend(a, b, c, 3, causal=True, mask=(
                None if mask is None else jnp.asarray(mask))),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    with (tnn.no_kernels() if mask_kind == "no_kernels" else nullcontext()):
        with autograd.record():
            out = tnn.attend(tq, tk, tv, 3, causal=True, mask=(
                None if mask is None else torch.from_numpy(mask)))
    autograd.backward(out, _t(g))
    onp.testing.assert_allclose(out.detach().numpy(), onp.asarray(jout),
                                rtol=F32_TOL, atol=F32_TOL)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        onp.testing.assert_allclose(got.numpy(), onp.asarray(w),
                                    rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("n,v", [(13, 300), (8, 2048)])
def test_fused_lse_matches_pallas(n, v):
    """Port fused_lse (plain version) against the Pallas _lse_kernel in
    interpret mode, ragged rows and a vocab that is no block multiple."""
    x = (onp.random.RandomState(n).randn(n, v) * 4).astype(onp.float32)
    want = jce.fused_lse(jnp.asarray(x), interpret=True)
    got = tce.fused_lse(_t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                rtol=F32_TOL, atol=F32_TOL)


def test_cross_entropy_with_logits_value_and_grad_match_jax():
    """cross_entropy_with_logits: nll and d(sum w * nll)/dlogits against
    the JAX custom_vjp (``jax.grad``), with some labels -1: those rows
    give nll 0 and no gradient."""
    rng = onp.random.RandomState(11)
    x = (rng.randn(10, 130) * 3).astype(onp.float32)
    lab = rng.randint(0, 130, 10).astype(onp.int32)
    lab[[2, 7]] = -1
    w = rng.randn(10).astype(onp.float32)
    jnll = jce.cross_entropy_with_logits(jnp.asarray(x), jnp.asarray(lab))
    jgrad = jax.grad(lambda a: jnp.sum(jce.cross_entropy_with_logits(
        a, jnp.asarray(lab)) * jnp.asarray(w)))(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    with autograd.record():
        nll = tce.cross_entropy_with_logits(tx, torch.from_numpy(lab))
    (nll * _t(w)).sum().backward()
    onp.testing.assert_allclose(nll.detach().numpy(), onp.asarray(jnll),
                                rtol=F32_TOL, atol=F32_TOL)
    assert (nll.detach().numpy()[[2, 7]] == 0).all()
    onp.testing.assert_allclose(tx.grad.numpy(), onp.asarray(jgrad),
                                rtol=F32_TOL, atol=F32_TOL)
    assert (tx.grad.numpy()[[2, 7]] == 0).all()


def test_softmax_cross_entropy_summed_contract_and_no_kernels_path():
    """ops.nn.softmax_cross_entropy: the summed (1,) form clamps the
    value at -log(1e-8) but not the gradient, and the no_kernels path
    (plain logsumexp) gives the same values and gradients."""
    rng = onp.random.RandomState(12)
    x = (rng.randn(6, 40) * 2).astype(onp.float32)
    x[0] = -1e4
    x[0, 5] = 1e4                       # row 0: label 3 has p = 0
    lab = torch.from_numpy(rng.randint(0, 40, 6))
    lab[0] = 3
    out = {}
    for path in ("kernels", "plain"):
        tx = _t(x).requires_grad_()
        with tnn.no_kernels() if path == "plain" else nullcontext():
            with autograd.record():
                tot = tnn.softmax_cross_entropy(tx, lab)
                per = tnn.softmax_cross_entropy(tx, lab, per_example=True)
        autograd.backward(tot)
        out[path] = (tot.detach(), per.detach(), tx.grad)
    cap = float(-onp.log(onp.float32(1e-8)))
    for tot, per, grad in out.values():
        assert tuple(tot.shape) == (1,)
        assert float(per[0]) > cap
        assert abs(float(tot) - (cap + float(per[1:].sum()))) < 1e-3
        assert float(grad[0, 3]) == pytest.approx(-1.0)
    for a, b in zip(out["kernels"], out["plain"]):
        onp.testing.assert_allclose(a.numpy(), b.numpy(), rtol=F32_TOL,
                                    atol=F32_TOL)


def test_layer_norm_backward_matches_jax_vjp():
    """K2 as a torch.autograd.Function: dx, dgamma and dbeta of the port's
    fused_layer_norm against jax.vjp of the JAX fused_layer_norm
    (interpret) with the same cotangent, at 2e-5; ops.nn.layer_norm on a
    3-D input gets the same gradients through it."""
    rng = onp.random.RandomState(13)
    x = (rng.randn(10, 48) * 2 + 1).astype(onp.float32)
    gam = (1 + 0.1 * rng.randn(48)).astype(onp.float32)
    bet = (0.1 * rng.randn(48)).astype(onp.float32)
    ct = rng.randn(10, 48).astype(onp.float32)
    _, vjp = jax.vjp(lambda a, b, c: jln.fused_layer_norm(a, b, c, 1e-5, True),
                     jnp.asarray(x), jnp.asarray(gam), jnp.asarray(bet))
    want = vjp(jnp.asarray(ct))
    for shape in ((10, 48), (2, 5, 48)):
        tx, tg, tb = (_t(a).requires_grad_() for a in (x, gam, bet))
        with autograd.record():
            y = tnn.layer_norm(tx.reshape(shape), tg, tb)
        autograd.backward(y, _t(ct).reshape(shape))
        for got, w in zip((tx.grad, tg.grad, tb.grad), want):
            onp.testing.assert_allclose(got.numpy(), onp.asarray(w),
                                        rtol=F32_TOL, atol=F32_TOL)


def test_inference_wrappers_refuse_grad_mode():
    """K4, K5a and K5b return tensors without an autograd graph on the
    card, so their wrappers raise, on every device, when grad mode is on
    and an input requires grad; under no_grad they run."""
    rng = onp.random.RandomState(14)
    q = _t(rng.randn(2, 4, 8)).requires_grad_()
    pool = _t(rng.randn(3, 4, 4, 8))
    bt = torch.tensor([[0, 1], [2, 2]], dtype=torch.int32)
    lens = torch.tensor([5, 3], dtype=torch.int32)
    x = _t(rng.randn(2, 32)).requires_grad_()
    w = _t(rng.randn(96, 32))
    wo = _t(rng.randn(32, 32))
    calls = [
        lambda: tpaged.paged_attention_kernel(q, pool, pool, bt, lens),
        lambda: tfused.fused_qkv_project(x, w, None, heads=4,
                                         store_dtype=torch.float32),
        lambda: tfused.fused_out_project(x, wo, None)]
    for call in calls:
        with pytest.raises(FatalError, match="requires grad"):
            with autograd.record():
                call()
        with torch.no_grad():
            call()
