"""The imperative Gluon front door of the PyTorch port against the JAX
package, on the CPU: the K2r RMSNorm kernel's plain version and
``ops.nn.rms_norm``, ``mx.np`` creation dtypes and arithmetic,
``autograd.grad``/``Function``, and Gluon's ``Parameter``/``Block``
(deferred shapes, initializers, ``collect_params`` names, ``.params``
files, the Trainer) on the RMSNorm FFN stack at a small width (2 blocks,
units 32, hidden 64). Inputs and weights are seeded numpy arrays handed
to both packages; the port runs on ``device="cpu"``, where every kernel
wrapper takes its plain version. Tolerances are stated at each check.
"""
import importlib
import os

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_jax_params, to_jax_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.parameter import DeferredInitializationError
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops.kernels import layer_norm as kln

# the module, not the function of the same name its package exports
jln = importlib.import_module("mxnet_tpu.ops.pallas.layer_norm")

UNITS, HIDDEN, LAYERS = 32, 64, 2
B, L = 2, 8
# bfloat16 results are rounded once from f32 on both sides; after sums
# in another order they may land one bf16 ulp (2^-7 relative) apart
BF16_RTOL = 2.0 ** -7


def _t(a):
    return torch.from_numpy(onp.array(a))


def _np(x):
    return onp.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# K2r and rms_norm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_plain_matches_pallas_kernel_and_vjp(dtype):
    """The port's fused_rms_norm (the K2r kernel's plain version on CPU
    tensors) against the JAX fused_rms_norm in interpret mode (the
    Pallas body _rms_kernel and its custom vjp _rms_bwd), on 40 rows of
    width 48: y, and dx and dgamma of a seeded cotangent. f32 within
    1e-6 of the largest magnitude (dgamma sums 40 rows: a few f32 ulps of
    values near 13); bf16 within one bf16 ulp of it."""
    rng = onp.random.RandomState(0)
    x = (rng.randn(40, 48) * 2 + 0.5).astype(onp.float32)
    g = (1 + 0.1 * rng.randn(48)).astype(onp.float32)
    gy = rng.randn(40, 48).astype(onp.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, jg, jgy = (jnp.asarray(a).astype(jdt) for a in (x, g, gy))
    jy, vjp = jax.vjp(lambda a, b: jln.fused_rms_norm(a, b, 1e-6, True),
                      jx, jg)
    jdx, jdg = vjp(jgy)
    tdt = getattr(torch, dtype)
    tx = _t(_np(jx)).to(tdt).requires_grad_()
    tg = _t(_np(jg)).to(tdt).requires_grad_()
    ty, rstd = kln.fused_rms_norm(tx, tg, 1e-6)
    tdx, tdg = torch.autograd.grad(ty, (tx, tg), _t(_np(jgy)).to(tdt))
    assert ty.dtype == tdt and rstd.dtype == torch.float32
    assert kln.fused_rms_norm.launches == 0
    for got, want in ((ty, jy), (tdx, jdx), (tdg, jdg)):
        got, want = got.detach().float().numpy(), _np(want)
        if dtype == "float32":
            onp.testing.assert_allclose(
                got, want, rtol=1e-6, atol=1e-6 * onp.abs(want).max())
        else:
            onp.testing.assert_allclose(
                got, want, rtol=BF16_RTOL,
                atol=BF16_RTOL * onp.abs(want).max())


@pytest.mark.parametrize("dtype,kernels,axis", [
    ("float32", True, -1), ("bfloat16", True, -1), ("bfloat16", False, -1),
    ("float32", True, 1)])
def test_npx_rms_norm_matches_jax_npx(dtype, kernels, axis):
    """npx.rms_norm (-> ops.nn.rms_norm) on the CPU against the JAX
    mx.npx.rms_norm on the CPU (its jnp path: rstd cast to x's dtype
    before the products). Last-axis rows take the K2r wrapper's plain
    version (y rounded once): equal in f32 (1e-6), within one bf16 ulp
    in bf16. Under no_kernels, and on another axis, the port takes the
    same jnp arithmetic: within 1e-6 of the magnitude, also in bf16."""
    rng = onp.random.RandomState(1)
    x = (rng.randn(4, 6, 24) * 2).astype(onp.float32)
    width = x.shape[axis]
    g = (1 + 0.1 * rng.randn(width)).astype(onp.float32)
    if axis != -1:
        g = g.reshape(-1, 1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = jmx.np.array(x).astype(jdt)
    jg = jmx.np.array(g).astype(jdt)
    want = _np(jmx.npx.rms_norm(jx, jg, axis=axis, eps=1e-6)._data)
    tx, tg = (_t(_np(a._data)).to(getattr(torch, dtype)) for a in (jx, jg))
    if kernels:
        got = tmx.npx.rms_norm(tx, tg, axis=axis, eps=1e-6)
    else:
        with tops.no_kernels():
            got = tmx.npx.rms_norm(tx, tg, axis=axis, eps=1e-6)
    assert got.dtype == getattr(torch, dtype) and got.shape == tx.shape
    got = got.float().numpy()
    if dtype == "float32" or not kernels:
        onp.testing.assert_allclose(got, want, rtol=1e-6,
                                    atol=1e-6 * onp.abs(want).max())
    else:
        onp.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                    atol=BF16_RTOL * onp.abs(want).max())


def test_rms_norm_wrapper_checks_its_inputs_and_counts_nothing_on_cpu():
    """The K2r wrapper raises on what the kernel would not take only for
    CUDA tensors; CPU tensors of any dtype take the plain version, and
    a mix of devices raises."""
    x = torch.randn(3, 8, dtype=torch.float64)
    y, rstd = kln.fused_rms_norm(x, torch.ones(8, dtype=torch.float64))
    assert y.dtype == torch.float64 and rstd.shape == (3,)
    with pytest.raises(MXNetError):
        kln.fused_rms_norm(torch.randn(3, 8), torch.ones(8, device="meta"))
    assert kln.fused_rms_norm.launches == 0


# ---------------------------------------------------------------------------
# mx.np
# ---------------------------------------------------------------------------
CREATION = [
    ("array", ([1, 2],), {}), ("array", ([1.0, 2.0],), {}),
    ("array", (3,), {}), ("array", ([True, False],), {}),
    ("array", ([[1.5, 2]],), {"dtype": "float64"}),
    ("array", ([1, 2],), {"dtype": "float32"}),
    ("zeros", (3,), {}), ("zeros", ((2, 3),), {"dtype": "int32"}),
    ("ones", ((2, 2),), {"dtype": "int32"}), ("ones", (4,), {}),
    ("empty", ((2, 5),), {}), ("full", (3, 2), {}), ("full", (3, 2.0), {}),
    ("full", ((2,), 7), {"dtype": "float32"}), ("arange", (5,), {}),
    ("arange", (5.0,), {}), ("arange", (0, 1, 0.25), {}),
    ("arange", (2, 9, 3), {"dtype": "float32"}),
    ("linspace", (0, 1, 5), {}), ("linspace", (0, 1, 4),
                                  {"endpoint": False, "dtype": "float32"}),
]


@pytest.mark.parametrize("name,args,kw", CREATION,
                         ids=[f"{n}{a}{k}" for n, a, k in CREATION])
def test_np_creation_dtype_and_shape_match_jax(name, args, kw):
    """Every creation function gives the JAX package's dtype and shape
    for the same arguments (its 64-bit defaults included), on the device
    asked for; values match where they are defined."""
    want = getattr(jmx.np, name)(*args, **kw)
    got = getattr(tmx.np, name)(*args, device="cpu", **kw)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.device.type == "cpu"
    if name != "empty":
        onp.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-6)


@pytest.mark.parametrize("name", ["zeros_like", "ones_like", "full_like",
                                  "empty_like"])
def test_np_like_functions_keep_dtype(name):
    args = (1.5,) if name == "full_like" else ()
    for src in ([1, 2, 3], [1.0, 2.0]):
        want = getattr(jmx.np, name)(jmx.np.array(src), *args)
        got = getattr(tmx.np, name)(tmx.np.array(src, device="cpu"), *args)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        if name != "empty_like":
            onp.testing.assert_array_equal(got.numpy(), want.asnumpy())


def test_np_creation_defaults_to_the_card(monkeypatch):
    """Without device=, creation, random draws and functions given host
    data (lists) target gpu(0) and raise with no card instead of running
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tmx.np.zeros(3), lambda: tmx.np.array([1.0]),
                 lambda: tmx.np.random.normal(size=(2,)),
                 lambda: tmx.np.exp([1.0, 2.0]),
                 lambda: tmx.np.add([1.0], [2.0])):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            call()


_A = onp.random.RandomState(3).uniform(0.2, 2.0, (3, 4)).astype(onp.float32)
_B = onp.random.RandomState(4).uniform(-1.5, 1.5, (3, 4)).astype(onp.float32)
ELEMENTWISE = ["add", "subtract", "multiply", "divide", "power", "maximum",
               "minimum", "exp", "log", "sqrt", "square", "abs", "negative",
               "sin", "cos", "tanh", "sigmoid", "relu", "floor", "sign",
               "log1p", "reciprocal", "arctan", "greater"]
REDUCTION = [("sum", {}), ("sum", {"axis": 1}), ("mean", {"axis": 0}),
             ("max", {}), ("min", {"axis": 1, "keepdims": True}),
             ("argmax", {"axis": 1}), ("argmin", {}),
             ("mean", {"axis": (0, 1), "keepdims": True})]


@pytest.mark.parametrize("name", ELEMENTWISE)
def test_np_elementwise_matches_jax(name):
    """Elementwise results (binary on (3, 4) pairs, unary on one) match
    the JAX package's within 1e-6 (f32, one rounding each)."""
    binary = name in ("add", "subtract", "multiply", "divide", "power",
                      "maximum", "minimum", "greater")
    jargs = (jmx.np.array(_A), jmx.np.array(_B)) if binary \
        else (jmx.np.array(_B if name not in ("log", "sqrt", "log1p")
                           else _A),)
    targs = [tmx.np.array(a.asnumpy(), device="cpu") for a in jargs]
    want = getattr(jmx.np, name)(*jargs).asnumpy()
    got = getattr(tmx.np, name)(*targs).numpy()
    assert got.dtype == want.dtype
    onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kw", REDUCTION,
                         ids=[f"{n}-{k}" for n, k in REDUCTION])
def test_np_reductions_and_shapes_match_jax(name, kw):
    """Reductions over (3, 4) f32 match within 1e-6 (sums of 4 terms in
    another order), with the same dtype and shape."""
    want = getattr(jmx.np, name)(jmx.np.array(_B), **kw).asnumpy()
    got = getattr(tmx.np, name)(tmx.np.array(_B, device="cpu"), **kw)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_np_products_and_shape_functions_match_jax():
    """dot (1-D, 2-D, N-D . 1-D), matmul, reshape, transpose,
    concatenate, stack, expand_dims and squeeze against the JAX
    package's, within 1e-6."""
    rng = onp.random.RandomState(5)
    a, b = rng.randn(3, 4).astype(onp.float32), rng.randn(4, 2).astype(
        onp.float32)
    v, t3 = rng.randn(4).astype(onp.float32), rng.randn(2, 3, 4).astype(
        onp.float32)
    J, T = jmx.np, tmx.np

    def both(fn):
        want = fn(J, lambda x: J.array(x))
        got = fn(T, lambda x: T.array(x, device="cpu"))
        want = [want] if not isinstance(want, list) else want
        got = [got] if not isinstance(got, list) else got
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            onp.testing.assert_allclose(g.numpy(), w.asnumpy(), rtol=1e-6,
                                        atol=1e-6)

    both(lambda M, A: M.dot(A(v), A(v)))
    both(lambda M, A: M.dot(A(a), A(b)))
    both(lambda M, A: M.dot(A(t3), A(v)))
    both(lambda M, A: M.matmul(A(t3), A(b)))
    both(lambda M, A: M.reshape(A(t3), (6, 4)))
    both(lambda M, A: M.transpose(A(t3)))
    both(lambda M, A: M.transpose(A(t3), (1, 0, 2)))
    both(lambda M, A: M.concatenate([A(a), A(a)], axis=1))
    both(lambda M, A: M.stack([A(a), A(a)], axis=0))
    both(lambda M, A: M.expand_dims(A(a), 1))
    both(lambda M, A: M.squeeze(M.expand_dims(A(a), 0), 0))


def test_np_random_shapes_dtypes_and_moments():
    """Threefry and Philox never agree, so the draws are held to shapes,
    dtypes (the JAX package's: float32 samples, int64 integers) and
    moments (20,000 samples: mean within 0.03, std within 3%); a reseed
    repeats the stream."""
    R = tmx.np.random
    R.seed(11)
    u = R.uniform(-1.0, 3.0, size=(100, 200), device="cpu")
    n = R.normal(0.5, 2.0, size=(20000,), device="cpu")
    i = R.randint(2, 9, size=(5000,), device="cpu")
    assert u.dtype == torch.float32 and u.shape == (100, 200)
    assert i.dtype == torch.int64 and int(i.min()) >= 2 and int(i.max()) < 9
    assert -1.0 <= float(u.min()) and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 1.0) < 0.03
    assert abs(float(n.mean()) - 0.5) < 0.03
    assert abs(float(n.std()) / 2.0 - 1.0) < 0.03
    R.seed(11)
    assert torch.equal(R.uniform(-1.0, 3.0, size=(100, 200), device="cpu"), u)


def test_nd_functions():
    """asnumpy (bfloat16 widens), attach_grad's write and add, copyto."""
    x = torch.tensor([1.5, -2.0], dtype=torch.bfloat16)
    out = tmx.nd.asnumpy(x)
    assert out.dtype == onp.float32 and out.tolist() == [1.5, -2.0]
    for req, want in (("write", [2.0, 4.0]), ("add", [4.0, 8.0])):
        w = torch.tensor([1.0, 2.0])
        tmx.nd.attach_grad(w, req)
        assert w.grad.tolist() == [0.0, 0.0]
        for _ in range(2):
            with autograd.record():
                loss = (w * w).sum()
            autograd.backward(loss)
        assert w.grad.tolist() == want, req
    dst = torch.zeros(2)
    assert tmx.nd.copyto(torch.tensor([3.0, 4.0]), dst) is dst
    assert dst.tolist() == [3.0, 4.0]


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("create_graph", [False, True])
def test_autograd_grad_matches_jax(create_graph):
    """autograd.grad of sum(x³·y) against the JAX package's, within
    1e-6; with create_graph the first-order gradient is differentiated
    again (d/dx of sum(3x²y) = 6xy), and .grad stays untouched."""
    xv = onp.array([0.5, -1.0, 2.0], onp.float32)
    yv = onp.array([1.5, 2.0, -0.5], onp.float32)
    jx, jy = jmx.np.array(xv), jmx.np.array(yv)
    jx.attach_grad()
    jy.attach_grad()
    with jautograd.record():
        jz = (jx ** 3 * jy).sum()
        jg = jautograd.grad(jz, [jx], create_graph=create_graph)[0]
        if create_graph:
            jgg = jautograd.grad(jg.sum(), [jx])[0]
    tx = torch.from_numpy(xv.copy()).requires_grad_()
    ty = torch.from_numpy(yv.copy()).requires_grad_()
    with autograd.record():
        tz = (tx ** 3 * ty).sum()
        tg = autograd.grad(tz, [tx], create_graph=create_graph)[0]
        if create_graph:
            tgg = autograd.grad(tg.sum(), [tx])[0]
    onp.testing.assert_allclose(tg.detach().numpy(), jg.asnumpy(),
                                rtol=1e-6)
    assert tg.requires_grad == create_graph and tx.grad is None
    if create_graph:
        onp.testing.assert_allclose(tgg.numpy(), jgg.asnumpy(), rtol=1e-6)
        onp.testing.assert_allclose(tgg.numpy(), 6 * xv * yv, rtol=1e-6)
    with pytest.raises(MXNetError):
        autograd.grad(torch.ones(2).sum(), [torch.ones(2)])


def test_autograd_function_matches_jax():
    """The sigmoid Function of the reference's docstring in both
    packages: values and gradients within 1e-6."""
    class JSigmoid(jautograd.Function):
        def forward(self, x):
            y = 1 / (1 + jmx.np.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    class TSigmoid(autograd.Function):
        def forward(self, x):
            y = 1 / (1 + torch.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    xv = onp.linspace(-3, 3, 7).astype(onp.float32)
    jx = jmx.np.array(xv)
    jx.attach_grad()
    with jautograd.record():
        jy = JSigmoid()(jx)
    jy.backward()
    tx = torch.from_numpy(xv.copy())
    tmx.nd.attach_grad(tx)
    with autograd.record():
        ty = TSigmoid()(tx)
    autograd.backward(ty)
    onp.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), rtol=1e-6)
    onp.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                                rtol=1e-6, atol=1e-7)


def test_autograd_scopes():
    """set_recording/set_training return the previous state;
    train_mode/predict_mode flip only the training flag."""
    assert autograd.set_training(True) is False
    try:
        assert autograd.is_training()
        with autograd.predict_mode():
            assert not autograd.is_training()
        assert autograd.is_training()
    finally:
        autograd.set_training(False)
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    prev = autograd.set_recording(True)
    try:
        assert prev is False and autograd.is_recording()
        assert torch.is_grad_enabled()
    finally:
        autograd.set_recording(False)
        torch.set_grad_enabled(True)


# ---------------------------------------------------------------------------
# Gluon: the RMSNorm FFN stack
# ---------------------------------------------------------------------------
def ffn_stack(gluon, layers=LAYERS, units=UNITS, hidden=HIDDEN):
    """layers x [x + Dense(units)(Dense(hidden, gelu)(RMSNorm()(x)))] and
    a final RMSNorm, every layer without in_units/in_channels, built
    from one package's Gluon."""
    nn = gluon.nn

    class FFNBlock(gluon.nn.HybridBlock):
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


def _data(seed=7):
    rng = onp.random.RandomState(seed)
    return (rng.randn(B, L, UNITS).astype(onp.float32),
            rng.randn(B, L, UNITS).astype(onp.float32))


def _weights(seed=8):
    """Seeded numpy weights of the stack under the reference's names:
    gains 1 + N(0, 0.1²), biases N(0, 0.1²), weights Xavier-sized
    normal."""
    rng = onp.random.RandomState(seed)
    out = {}
    for i in range(LAYERS):
        out[f"{i}.norm.gamma"] = 1 + 0.1 * rng.randn(UNITS)
        out[f"{i}.ffn_1.weight"] = rng.randn(HIDDEN, UNITS) / UNITS ** 0.5
        out[f"{i}.ffn_1.bias"] = 0.1 * rng.randn(HIDDEN)
        out[f"{i}.ffn_2.weight"] = rng.randn(UNITS, HIDDEN) / HIDDEN ** 0.5
        out[f"{i}.ffn_2.bias"] = 0.1 * rng.randn(UNITS)
    out[f"{LAYERS}.gamma"] = 1 + 0.1 * rng.randn(UNITS)
    return {k: v.astype(onp.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_stack():
    """The JAX stack, hybridized (one compiled program instead of an op
    by op trace at each first call); each test sets its weights."""
    net = ffn_stack(jmx.gluon)
    net.initialize()
    net.hybridize()
    return net


def _set(jnet, params):
    for n, p in jnet.collect_params().items():
        p.set_data(jmx.np.array(params[n]))
    return jnet


def test_collect_params_names_and_deferred_shapes(jax_stack):
    """The port's stack has the JAX package's collect_params() names,
    equal to state_dict()'s keys; before the first forward the weights
    are deferred (shape (units, 0)) and data() raises, after it every
    shape equals the JAX package's."""
    jnet = _set(jax_stack, _weights())
    tnet = ffn_stack(tmx.gluon)
    tnet.initialize(tmx.init.Xavier(), device="cpu")
    names = list(tnet.collect_params())
    assert names == list(jnet.collect_params())
    assert names == [n for n, _ in tnet.named_parameters()]
    w = tnet.collect_params()["0.ffn_1.weight"]
    assert w.shape == (HIDDEN, 0) and not w.initialized
    with pytest.raises(DeferredInitializationError):
        w.data()
    tnet(torch.from_numpy(_data()[0]))
    assert names == list(tnet.state_dict())
    assert {n: p.shape for n, p in tnet.collect_params().items()} == \
        {n: p.shape for n, p in jnet.collect_params().items()}
    assert tnet[0].ffn_1.weight is w and w.data().shape == (HIDDEN, UNITS)
    assert w.data().device.type == "cpu"


def test_initializer_name_rules_and_moments():
    """Initializer.init_array's name rules give the JAX package's exact
    zeros and ones; Uniform and Xavier draw within their bounds with the
    expected scale (moments of 60,000 draws: std within 3%)."""
    names = ["dense0.bias", "ln.beta", "ln.gamma", "bn.running_mean",
             "bn.moving_var", "bias_scale", "x.moving_mean",
             "x.running_var"]
    for name in names:
        jarr = jmx.np.zeros((4, 3))
        jmx.init.Uniform(0.5).init_array(name, jarr)
        tarr = torch.full((4, 3), 7.0)
        tmx.init.Uniform(0.5).init_array(name, tarr)
        onp.testing.assert_array_equal(tarr.numpy(), jarr.asnumpy())
    t = torch.empty(300, 200)
    tmx.init.Uniform(0.07).init_array("weight", t)
    assert float(t.abs().max()) <= 0.07
    assert abs(float(t.std()) / (0.07 / 3 ** 0.5) - 1) < 0.03
    tmx.init.Xavier().init_array("weight", t)
    bound = (3.0 / ((300 + 200) / 2)) ** 0.5
    assert float(t.abs().max()) <= bound
    assert abs(float(t.std()) / (bound / 3 ** 0.5) - 1) < 0.03
    tmx.init.Xavier("gaussian", "in", 2).init_array("weight", t)
    assert abs(float(t.std()) / (2.0 / 200) ** 0.5 - 1) < 0.03
    tmx.init.Orthogonal(1.0).init_array("weight", t[:100])
    q = t[:100]
    onp.testing.assert_allclose((q @ q.T).numpy(), onp.eye(100), atol=1e-5)
    assert isinstance(tmx.init.create("xavier"), tmx.init.Xavier)
    assert isinstance(tmx.init.create("zeros"), tmx.init.Zero)
    with pytest.raises(MXNetError):
        tmx.init.create("no_such_init")


def test_trainer_adam_two_steps_match_jax_gluon_loop(jax_stack):
    """The stack trained two Adam steps (lr 1e-3) through record() /
    L2Loss / backward / Trainer(net.collect_params(), "adam") in both
    packages, from the same seeded weights, carried into the port's
    still-deferred parameters with from_jax_params: the loss, every
    gradient at both steps and every weight after them within 1e-5 (f32
    through two blocks, summed in another order)."""
    params = _weights()
    jnet = _set(jax_stack, params)
    tnet = ffn_stack(tmx.gluon)
    tnet.initialize(tmx.init.Xavier(), device="cpu")
    from_jax_params(params, tnet)
    x, y = _data()
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    jloss_fn, tloss_fn = jmx.gluon.loss.L2Loss(), tmx.gluon.loss.L2Loss()
    tol = dict(rtol=1e-5, atol=1e-5)
    for _ in range(2):
        with jautograd.record():
            jl = jloss_fn(jnet(jmx.np.array(x)), jmx.np.array(y))
        jl.backward()
        jgrads = {n: p.grad().asnumpy()
                  for n, p in jnet.collect_params().items()}
        jtr.step(B)
        with autograd.record():
            tl = tloss_fn(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        autograd.backward(tl)
        tgrads = {n: p.grad().numpy().copy()
                  for n, p in tnet.collect_params().items()}
        ttr.step(B)
        onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(), **tol)
        for n in jgrads:
            onp.testing.assert_allclose(tgrads[n], jgrads[n], err_msg=n,
                                        **tol)
    got = to_jax_params(tnet)
    for n, p in jnet.collect_params().items():
        onp.testing.assert_allclose(got[n], p.data().asnumpy(), err_msg=n,
                                    **tol)
        assert not onp.allclose(got[n], params[n]), n


def test_params_files_load_across_packages(jax_stack, tmp_path):
    """A .params file saved by the JAX package loads into a fresh,
    uninitialized port stack (deferred shapes taken from the file) and
    gives the JAX outputs within 1e-5; one saved by the port loads into
    the JAX stack bit for bit. bfloat16 arrays cross both ways
    exactly, as uint16 bits."""
    jnet = _set(jax_stack, _weights())
    x = _data()[0]
    jfile = str(tmp_path / "jax.params")
    jnet.save_parameters(jfile)
    tnet = ffn_stack(tmx.gluon)
    tnet.load_parameters(jfile, device="cpu")
    onp.testing.assert_allclose(
        tnet(torch.from_numpy(x)).detach().numpy(),
        jnet(jmx.np.array(x)).asnumpy(), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        for p in tnet.parameters():
            p.mul_(1.5)
    tfile = str(tmp_path / "torch.params")
    tnet.save_parameters(tfile)
    jnet.load_parameters(tfile)
    for n, p in tnet.collect_params().items():
        onp.testing.assert_array_equal(
            jnet.collect_params()[n].data().asnumpy(),
            p.data().detach().numpy())
    bits = onp.array([1.0, -2.5, 3.140625], onp.float32)
    tmx.serialization.save_params(
        str(tmp_path / "b.params"),
        {"h": torch.from_numpy(bits).to(torch.bfloat16)})
    back = jmx.serialization.load_params(str(tmp_path / "b.params"))["h"]
    assert str(back.dtype) == "bfloat16"
    onp.testing.assert_array_equal(back.astype(onp.float32), bits)
    jmx.serialization.save_params(str(tmp_path / "c.params"), {"h": back})
    again = tmx.serialization.load_params(str(tmp_path / "c.params"))["h"]
    assert again.dtype == torch.bfloat16
    assert again.float().numpy().tolist() == bits.tolist()


def test_save_load_round_trip_is_bitwise_and_checks_names(tmp_path,
                                                         monkeypatch):
    """save_parameters -> load_parameters into a fresh port net is
    bitwise and gives the same output; a missing or extra name
    raises unless allowed; without device= a fresh net loads onto
    gpu(0) (here: raises), not onto the CPU the file was read to."""
    net = ffn_stack(tmx.gluon)
    net.initialize(tmx.init.Xavier(), device="cpu")
    x = torch.from_numpy(_data()[0])
    y = net(x)
    f = str(tmp_path / "a.params")
    net.save_parameters(f)
    fresh = ffn_stack(tmx.gluon)
    fresh.load_parameters(f, device="cpu")
    for (n, a), (_, b) in zip(net.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
    assert torch.equal(fresh(x), y)
    big = ffn_stack(tmx.gluon, layers=3)
    with pytest.raises(MXNetError, match="missing"):
        big.load_parameters(f, device="cpu")
    with pytest.raises(MXNetError, match="extra"):
        ffn_stack(tmx.gluon, layers=1).load_parameters(
            f, device="cpu", allow_missing=True)
    small = ffn_stack(tmx.gluon, layers=1)
    small.load_parameters(f, device="cpu", allow_missing=True,
                          ignore_extra=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        ffn_stack(tmx.gluon).load_parameters(f)
    assert torch.equal(small[0].ffn_1.weight.data(),
                       net[0].ffn_1.weight.data())


def test_block_utilities(monkeypatch):
    """Forward hooks (detach), apply, cast, zero_grad, grad_req "add"
    kept by the Trainer, lr_mult, Sequential indexing, Activation,
    Lambda, Constant, hybridize (accepted, eager), and initialize's
    default device."""
    net = tnn.HybridSequential()
    net.add(tnn.Dense(4, in_units=3), tnn.Activation("relu"),
            tnn.Lambda(lambda x: x * 2), tnn.Dense(2))
    net.initialize(device="cpu")
    net.hybridize()
    seen = []
    h = net.register_forward_hook(lambda blk, inp, out: seen.append(out))
    x = torch.randn(5, 3)
    out = net(x)
    assert len(seen) == 1 and seen[0] is out
    h.detach()
    net(x)
    assert len(seen) == 1
    assert isinstance(net[1], tnn.Activation) and len(net) == 4
    assert len(net[:2]) == 2
    kinds = []
    net.apply(lambda b: kinds.append(type(b).__name__))
    assert kinds[-1] == "HybridSequential"
    w = net[0].weight
    assert float(w.data().abs().max()) <= 0.07       # Uniform(0.07)
    assert float(net[0].bias.data().abs().max()) == 0.0
    w.grad_req = "add"
    w.lr_mult = 0.0
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    before = w.data().detach().clone()
    for _ in range(2):
        with autograd.record():
            loss = net(x).sum()
        autograd.backward(loss)
    acc = w.grad().clone()
    tr.step(1)
    assert torch.equal(w.data(), before)             # lr_mult 0
    assert torch.equal(w.grad(), acc)                # "add" kept
    assert net[3].weight.data().grad is None         # "write" cleared
    net.zero_grad()
    assert float(w.grad().abs().max()) == 0.0
    net.cast("float64")
    assert net(x.double()).dtype == torch.float64
    c = tmx.gluon.Constant(torch.arange(3.0))
    c.initialize(device="cpu")
    assert c.data().tolist() == [0.0, 1.0, 2.0] and c.grad_req == "null"
    lone = tnn.Dense(2, in_units=2)
    with pytest.raises(MXNetError, match="not been initialized"):
        lone.weight.data()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        lone.initialize()


def test_port_blocks_keep_their_state_dict_names():
    """gpt_like's blocks are Gluon blocks now: collect_params() names and
    order are state_dict()'s, and every parameter is initialized on the
    device it was built for."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import gpt_like

    net = gpt_like(device="cpu", vocab_size=17, units=16, hidden_size=32,
                   num_layers=1, num_heads=2, max_length=8)
    params = net.collect_params()
    assert list(params) == list(net.state_dict())
    assert all(p.initialized and p.data().device.type == "cpu"
               for p in params.values())
    assert float(params["encoder.layer0.ln1.gamma"].data().min()) == 1.0
    assert float(params["encoder.layer0.attn.qkv.bias"].data().abs().max()) \
        == 0.0
