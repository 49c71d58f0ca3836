"""The ResNet path of the PyTorch port against the JAX package, on the
CPU: the ops behind the layers (convolution, deconvolution, pooling,
``adaptive_avg_pool2d``, ``batch_norm``), the conv, pooling and
BatchNorm layers, the ResNet builders, ``functionalize`` and
``hybridize``, ResNet-50's eval logits through the JAX
``functionalize`` (as ``__graft_entry__.entry()`` builds it), a
resnet18 train step and SGD step against ``jax.value_and_grad`` and the
JAX Trainer, and the committed golden logits of the JAX model store's
resnet18_v1. Inputs and weights are seeded numpy arrays handed to both
packages; the port runs on ``device="cpu"``. ``tests/conftest.py`` pins
JAX's f32 matmuls to "highest". Tolerances are stated at each check, as
a share of the largest magnitude of the reference's value unless named.
"""
import os

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops import nn as jops
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch import numpy_extension as npx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon import Trainer, loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.ops import nn as tops

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# f32 convolutions and reductions sum in another order than XLA's: a
# few f32 ulps of the largest magnitude (sums of up to ~600 products)
F32_TOL = 1e-5
# bf16 results are rounded from f32 on both sides; after sums in another
# order or one more rounding of an intermediate they may land one or
# two bf16 ulps (2^-8 relative each) apart
BF16_TOL = 2.0 ** -6


def _np(x):
    return onp.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else onp.asarray(got, onp.float32)
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(onp.abs(want).max()), 1e-30)
    err = float(onp.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(onp.array(a, onp.float32)).to(dtype)
    return t.requires_grad_() if grad else t


def _j(a, dtype=jnp.float32):
    return jnp.asarray(onp.array(a, onp.float32)).astype(dtype)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------
CONV_CASES = {
    # name: (x shape, w shape, kwargs, bias)
    "2d_groups_dilate_stride": ((2, 4, 11, 10), (6, 2, 3, 3),
                                dict(stride=2, dilate=2, pad=1,
                                     num_group=2), True),
    "2d_nhwc": ((2, 9, 8, 3), (5, 3, 3, 3),
                dict(stride=1, pad=1, layout="NHWC"), True),
    "1d_stride_pad": ((2, 3, 17), (4, 3, 5), dict(stride=2, pad=2), True),
    "1d_nwc_groups": ((2, 13, 4), (6, 2, 3),
                      dict(dilate=3, num_group=2, layout="NWC"), False),
    "3d_groups": ((1, 4, 6, 7, 5), (4, 2, 3, 2, 3),
                  dict(stride=(1, 2, 1), pad=(1, 0, 1), num_group=2), True),
    "3d_ndhwc": ((1, 5, 6, 4, 3), (2, 3, 3, 3, 3),
                 dict(pad=1, layout="NDHWC"), False),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_jax(case):
    """``ops.nn.convolution`` against the JAX op, with the input's and
    the weight's gradients of a seeded cotangent; f32 within F32_TOL."""
    xs, ws, kw, use_bias = CONV_CASES[case]
    rng = onp.random.RandomState(1)
    x, w = rng.randn(*xs), rng.randn(*ws)
    b = rng.randn(ws[0]) if use_bias else None
    if kw.get("layout", "NCHW")[1] != "C":
        w = onp.moveaxis(w, 1, -1)      # channels-last weight: (O, *k, I)
    jy, vjp = jax.vjp(lambda a, c: jops.convolution(
        a, c, None if b is None else _j(b), **kw), _j(x), _j(w))
    gy = rng.randn(*jy.shape)
    jdx, jdw = vjp(_j(gy))
    tx, tw = _t(x, grad=True), _t(w, grad=True)
    ty = tops.convolution(tx, tw, None if b is None else _t(b), **kw)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), _t(gy))
    for got, want, what in ((ty, jy, "y"), (tdx, jdx, "dx"),
                            (tdw, jdw, "dw")):
        _close(got, want, F32_TOL, f"{case} {what}")


@pytest.mark.parametrize("case", ["2d_adj_groups", "1d_adj", "3d"])
def test_deconvolution_matches_jax(case):
    """``ops.nn.deconvolution`` (IOHW weight, ``adj`` as torch's
    output_padding, groups) against the JAX op; f32 within F32_TOL."""
    xs, ws, kw = {
        "2d_adj_groups": ((2, 4, 5, 6), (4, 3, 3, 3),
                          dict(stride=2, pad=1, adj=1, num_group=2)),
        "1d_adj": ((2, 3, 7), (3, 2, 4), dict(stride=3, pad=1, adj=2)),
        "3d": ((1, 2, 3, 4, 3), (2, 3, 2, 3, 2),
               dict(stride=(2, 1, 2), dilate=(1, 2, 1), pad=(0, 1, 1))),
    }[case]
    rng = onp.random.RandomState(2)
    x, w, b = rng.randn(*xs), rng.randn(*ws), rng.randn(
        ws[1] * kw.get("num_group", 1))
    jy = jops.deconvolution(_j(x), _j(w), _j(b), **kw)
    ty = tops.deconvolution(_t(x), _t(w), _t(b), **kw)
    _close(ty, jy, F32_TOL, case)


POOL_CASES = {
    # name: (x shape, kwargs)
    "max_pad": ((2, 3, 9, 8), dict(kernel=3, pool_type="max", stride=2,
                                   pad=1)),
    # ceil_mode windows that start in the right padding (torch drops them)
    "max_ceil_into_pad": ((1, 2, 6, 7), dict(kernel=2, pool_type="max",
                                             stride=2, pad=1,
                                             ceil_mode=True)),
    "avg_ceil_full_divisor": ((2, 2, 7, 6), dict(kernel=3, pool_type="avg",
                                                 stride=2, pad=1,
                                                 ceil_mode=True)),
    "avg_exclude_pad_ceil": ((2, 2, 7, 6),
                             dict(kernel=3, pool_type="avg", stride=2,
                                  pad=1, ceil_mode=True,
                                  count_include_pad=False)),
    "sum": ((1, 3, 8, 9), dict(kernel=(2, 3), pool_type="sum",
                               stride=(2, 1), pad=(1, 0))),
    "lp": ((1, 3, 8, 9), dict(kernel=3, pool_type="lp", stride=2, pad=1)),
    "avg_non_overlap": ((2, 3, 8, 6), dict(kernel=2, pool_type="avg")),
    "max_nhwc": ((2, 7, 6, 3), dict(kernel=3, pool_type="max", stride=2,
                                    pad=1, layout="NHWC")),
    "avg_1d": ((2, 3, 11), dict(kernel=4, pool_type="avg", stride=3,
                                pad=2, layout="NCW")),
    "max_3d_ceil": ((1, 2, 5, 6, 5), dict(kernel=2, pool_type="max",
                                          stride=2, ceil_mode=True,
                                          layout="NCDHW")),
    "global_max": ((2, 3, 5, 4), dict(pool_type="max", global_pool=True)),
    "global_avg": ((2, 3, 5, 4), dict(pool_type="avg", global_pool=True)),
    "global_sum_is_mean": ((2, 3, 5, 4), dict(pool_type="sum",
                                              global_pool=True)),
    "global_lp_nhwc": ((2, 5, 4, 3), dict(pool_type="lp", global_pool=True,
                                          layout="NHWC")),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_jax(case):
    """``ops.nn.pooling`` against the JAX op, value and input gradient:
    max pooling exactly (it selects), sums and means within F32_TOL."""
    xs, kw = POOL_CASES[case]
    rng = onp.random.RandomState(3)
    x = rng.randn(*xs)
    args = dict(kernel=kw.get("kernel", 1), pool_type=kw["pool_type"],
                stride=kw.get("stride"), pad=kw.get("pad", 0),
                global_pool=kw.get("global_pool", False),
                count_include_pad=kw.get("count_include_pad", True),
                layout=kw.get("layout", "NCHW"),
                ceil_mode=kw.get("ceil_mode", False))
    jy, vjp = jax.vjp(lambda a: jops.pooling(a, **args), _j(x))
    gy = rng.randn(*jy.shape)
    (jdx,) = vjp(_j(gy))
    tx = _t(x, grad=True)
    ty = tops.pooling(tx, **args)
    (tdx,) = torch.autograd.grad(ty, tx, _t(gy))
    tol = 0.0 if kw["pool_type"] == "max" else F32_TOL
    _close(ty, jy, tol, f"{case} y")
    _close(tdx, jdx, tol, f"{case} dx")


def test_pooling_edges_differ_from_torch():
    """Where the reference's ceil_mode keeps a window that starts in the
    right padding, torch's own pooling drops it: the port follows the
    reference (an extra column, here all padding: finfo.min for max,
    0 / 4 for the padded average)."""
    x = torch.arange(12, dtype=torch.float32).reshape(1, 1, 3, 4)
    kw = dict(kernel=2, stride=2, pad=1, ceil_mode=True)
    got = tops.pooling(x, pool_type="max", **kw)
    ref = jops.pooling(_j(x.numpy()), pool_type="max", **kw)
    assert got.shape == (1, 1, 3, 3) == ref.shape
    assert torch.nn.functional.max_pool2d(x, 2, 2, 1, ceil_mode=True
                                          ).shape == (1, 1, 2, 3)
    assert onp.array_equal(got.numpy(), _np(ref))
    assert got[0, 0, 2, 0].item() == torch.finfo(torch.float32).min
    avg = tops.pooling(x, pool_type="avg", **kw)
    onp.testing.assert_array_equal(avg.numpy(), _np(
        jops.pooling(_j(x.numpy()), pool_type="avg", **kw)))
    assert avg[0, 0, 0, 0].item() == 0.0 / 4          # one real value, 0


def test_adaptive_avg_pool2d_matches_jax_and_raises_where_it_does():
    """A reshape as in the reference: equal within F32_TOL where the size
    divides, a ValueError where it does not (the reference's reshape
    raises; torch's adaptive pool would take uneven windows)."""
    x = onp.random.RandomState(4).randn(2, 3, 8, 6)
    _close(tops.adaptive_avg_pool2d(_t(x), (4, 3)),
           jops.adaptive_avg_pool2d(_j(x), (4, 3)), F32_TOL)
    _close(tops.adaptive_avg_pool2d(_t(x), 2),
           jops.adaptive_avg_pool2d(_j(x), 2), F32_TOL)
    with pytest.raises(ValueError):
        tops.adaptive_avg_pool2d(_t(x), 5)


BN_CASES = [
    # (training, dtype, axis, fix_gamma, use_global_stats)
    (True, "float32", 1, False, False),
    (True, "float32", -1, False, False),
    (True, "bfloat16", 1, False, False),
    (True, "bfloat16", -1, True, False),
    (False, "float32", 1, False, False),
    (False, "bfloat16", 1, False, False),
    (True, "float32", 1, True, True),
    (False, "float32", -1, True, False),
]


@pytest.mark.parametrize("training,dtype,axis,fix_gamma,global_stats",
                         BN_CASES)
def test_batch_norm_matches_jax(training, dtype, axis, fix_gamma,
                                global_stats):
    """``ops.nn.batch_norm``'s three outputs against the JAX op: the
    biased batch variance in f32, the momentum of the old statistic 0.9,
    rsqrt cast to x's dtype, fix_gamma and use_global_stats; then the
    gradients of x, gamma and beta for a seeded cotangent. f32 within
    F32_TOL; bf16 outputs within BF16_TOL (the statistics stay f32,
    F32_TOL)."""
    rng = onp.random.RandomState(5)
    x = rng.randn(4, 3, 5, 6) * 2 + 0.7
    c = x.shape[axis]
    g, b = 1 + 0.2 * rng.randn(c), 0.3 * rng.randn(c)
    mm, mv = 0.1 * rng.randn(c), 1 + 0.5 * rng.rand(c)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma,
              use_global_stats=global_stats, training=training, axis=axis)

    def jfn(a, gg, bb):
        return jops.batch_norm(a, gg, bb, _j(mm), _j(mv), **kw)

    jout, vjp = jax.vjp(jfn, _j(x, jdt), _j(g, jdt), _j(b, jdt))
    tx, tg, tb = (_t(a, tdt, grad=True) for a in (x, g, b))
    tout = tops.batch_norm(tx, tg, tb, _t(mm), _t(mv), **kw)
    assert tout[0].dtype == tdt and tout[1].dtype == torch.float32
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    _close(tout[0], jout[0], tol, "out")
    _close(tout[1], jout[1], F32_TOL, "new mean")
    _close(tout[2], jout[2], F32_TOL, "new var")
    gy = rng.randn(*x.shape)
    jgrads = vjp((_j(gy, jdt), jnp.zeros(c, jnp.float32),
                  jnp.zeros(c, jnp.float32)))
    tgrads = torch.autograd.grad(tout[0], (tx, tg, tb), _t(gy, tdt),
                                 allow_unused=True)
    for got, want, what in zip(tgrads, jgrads, ("dx", "dgamma", "dbeta")):
        if got is None:            # fix_gamma: gamma takes no gradient
            assert what == "dgamma" and fix_gamma
            assert float(onp.abs(_np(want)).max()) == 0.0
            continue
        # bf16 gradients sum 120 rounded terms per channel
        _close(got, want, 4 * tol if dtype == "bfloat16" else tol, what)


def test_npx_batch_norm_writes_running_stats_only_when_training():
    """``npx.batch_norm`` moves the passed running statistics in place
    under ``autograd.record()`` (training), not outside it, not with
    ``use_global_stats``, and not inside ``record(train_mode=False)``;
    ``output_mean_var`` returns the new statistics."""
    rng = onp.random.RandomState(6)
    x, g, b = _t(rng.randn(4, 3, 2, 2)), torch.ones(3), torch.zeros(3)
    rm, rv = torch.zeros(3), torch.ones(3)
    npx.batch_norm(x, g, b, rm, rv)
    with autograd.record(train_mode=False):
        npx.batch_norm(x, g, b, rm, rv)
    with autograd.record():
        npx.batch_norm(x, g, b, rm, rv, use_global_stats=True)
    assert torch.equal(rm, torch.zeros(3)) and torch.equal(rv, torch.ones(3))
    with autograd.record():
        out, m, v = npx.batch_norm(x, g, b, rm, rv, output_mean_var=True)
    want_m = 0.1 * x.mean(dim=(0, 2, 3))
    want_v = 0.9 + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
    assert torch.allclose(rm, want_m, atol=1e-7) and torch.equal(rm, m)
    assert torch.allclose(rv, want_v, atol=1e-6) and torch.equal(rv, v)
    assert out.shape == x.shape


def test_stem_convolution_equals_jax_space_to_depth(monkeypatch):
    """The reference rewrites the 7x7/s2 stem as a stride-1 convolution
    over space-to-depth input (``MXNET_TPU_STEM_S2D=force`` takes that
    route on the CPU); the port keeps the plain convolution. Both
    compute the same taps: equal within F32_TOL (147 products each)."""
    monkeypatch.setenv("MXNET_TPU_STEM_S2D", "force")
    rng = onp.random.RandomState(7)
    x, w = rng.randn(2, 3, 30, 30), rng.randn(8, 3, 7, 7)
    xj, wj = _j(x), _j(w)
    assert jops._stem_s2d_wanted(xj, wj, 2, (2, 2), (1, 1), 1, "NCHW")
    jy = jops.convolution(xj, wj, None, stride=2, pad=3)
    ty = tops.convolution(_t(x), _t(w), None, stride=2, pad=3)
    _close(ty, jy, F32_TOL)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def _layer_nets(pkg):
    net = pkg.HybridSequential()
    net.add(pkg.ReflectionPad2D(1),
            pkg.Conv2D(6, 3, strides=2, padding=1, groups=2,
                       activation="relu"),
            pkg.BatchNormReLU(),
            pkg.Conv2DTranspose(4, 3, strides=2, padding=1,
                                output_padding=1),
            pkg.MaxPool2D(3, 2, 1, ceil_mode=True),
            pkg.AvgPool2D(2, 1, 1, count_include_pad=False),
            pkg.SyncBatchNorm(scale=False),
            pkg.Identity(),
            pkg.GlobalAvgPool2D(),
            pkg.Flatten(),
            pkg.Dense(5))
    seq = pkg.HybridSequential()
    seq.add(pkg.Conv1D(4, 3, padding=1), pkg.MaxPool1D(2),
            pkg.Conv1DTranspose(3, 2, strides=2), pkg.GlobalMaxPool1D())
    vol = pkg.HybridSequential()
    vol.add(pkg.Conv3D(3, 2, padding=1), pkg.AvgPool3D(2, ceil_mode=True),
            pkg.Conv3DTranspose(2, 2), pkg.GlobalAvgPool3D())
    return net, seq, vol


def _seeded(jnet, tnet, rng):
    """Seeded weights in the shapes of the port's net, whose forward
    completed them, set into the JAX net uninitialized (its shapes taken
    from the arrays; its forward then fails unless they are the ones its
    input gives)."""
    params = {}
    for name, p in tnet.collect_params().items():
        v = rng.randn(*p.shape) * 0.3
        if name.endswith(("gamma", "running_var")):
            v = 1 + 0.3 * rng.rand(*p.shape)
        params[name] = v.astype(onp.float32)
    for name, p in jnet.collect_params().items():
        p.set_data(params[name])
    return params


def test_conv_pool_norm_layers_match_jax():
    """The Gluon conv, pooling and BatchNorm layers (deferred in_channels
    everywhere) in both packages on the same seeded weights: forward in
    predict mode and in training mode, where BatchNorm's running
    statistics must move alike; names equal, and the JAX net runs on
    the shapes the port's forward completed. f32 within 1e-5 (stacked
    ops of F32_TOL each)."""
    rng = onp.random.RandomState(8)
    inputs = (rng.randn(2, 4, 9, 8), rng.randn(2, 3, 10),
              rng.randn(1, 2, 4, 5, 4))
    for jnet, tnet, x in zip(_layer_nets(jnn), _layer_nets(tnn), inputs):
        tnet.initialize(device="cpu")
        jx, tx = jmx.np.array(x.astype(onp.float32)), _t(x)
        tnet(tx)
        params = _seeded(jnet, tnet, rng)
        from_jax_params(params, tnet)
        assert list(tnet.collect_params()) == list(jnet.collect_params())
        for mode in ("predict", "train"):
            if mode == "train":
                with jmx.autograd.record():
                    jy = jnet(jx)
                with autograd.record():
                    ty = tnet(tx)
            else:
                jy, ty = jnet(jx), tnet(tx)
            _close(ty, jy.asnumpy(), 1e-5, mode)
        for name, p in jnet.collect_params().items():
            _close(tnet.collect_params()[name].data(), p.data().asnumpy(),
                   1e-5, name)


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------
RESNETS = sorted(n for n in tvision._models if n.startswith("resnet"))


def test_registry_matches_the_reference_and_refuses_the_rest():
    """Every name the reference registers, the ten ResNets among them;
    any other name raises MXNetError as the reference's does;
    pretrained=True raises with guidance for a depth the model store
    does not hold."""
    assert sorted(tvision._models) == sorted(jvision._models)
    assert RESNETS == sorted(n for n in jvision._models
                             if n.startswith("resnet"))
    with pytest.raises(MXNetError, match="is not supported"):
        tvision.get_model("resnet20_v1")
    with pytest.raises(MXNetError, match="no offline pretrained"):
        tvision.resnet34_v1(pretrained=True, device="cpu")


# the builders whose every shape the JAX net is held to by tracing its
# forward on them; the traces of 101 and 152 layers take seconds each
TRACED = ("resnet18_v1", "resnet18_v2", "resnet34_v1", "resnet34_v2",
          "resnet50_v1", "resnet50_v2")


@pytest.mark.parametrize("name", RESNETS)
def test_resnet_builders_match_jax_names_and_shapes(name):
    """Each builder's collect_params() names, in order, before the first
    forward equal the JAX net's; after the port's forward at (1, 3, 32,
    32) every shape equals the JAX net's shape before its forward, where
    that is known (a deferred axis, 0 there, is any width). For the
    TRACED builders the JAX net takes the port's completed shapes and
    ``jax.eval_shape`` traces its ``functionalize`` fn on them (without
    compiling), which fails unless every deferred width is the one its
    input gives, and yields logits of (1, 1000)."""
    jnet, tnet = jvision.get_model(name), tvision.get_model(name)
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    tnet.initialize(device="cpu")
    x = onp.zeros((1, 3, 32, 32), onp.float32)
    with torch.no_grad():
        assert tnet(_t(x)).shape == (1, 1000)
    got = {n: tuple(p.shape) for n, p in tnet.collect_params().items()}
    for n, p in jnet.collect_params().items():
        want = tuple(p.shape)
        assert len(got[n]) == len(want), n
        assert all(w in (0, g) for g, w in zip(got[n], want)), n
    if name in TRACED:
        for n, p in jnet.collect_params().items():
            p.set_data(onp.zeros(got[n], onp.float32))
        fn, params = jnet.functionalize(jmx.np.array(x))
        out = jax.eval_shape(lambda p, a: fn(p, a)[0], params,
                             jnp.asarray(x))
        assert out.shape == (1, 1000)


def _resnet_weights(tnet, jnet, seed):
    """He-scaled seeded weights (so 50 layers keep activations near 1),
    BatchNorm statistics and gains near their initial values, in the
    shapes of the port's net, whose forward completed them: set into the
    JAX net, uninitialized (its shapes taken from the arrays, so neither
    its initializers nor its ``functionalize``'s shape inference run),
    and returned for the port."""
    rng = onp.random.RandomState(seed)
    params = {}
    for name, p in tnet.collect_params().items():
        shape = tuple(p.shape)
        if name.endswith("weight"):
            fan_in = int(onp.prod(shape[1:]))
            v = rng.randn(*shape) * onp.sqrt(2.0 / fan_in)
        elif name.endswith(("gamma", "running_var")):
            v = 1 + 0.2 * rng.rand(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        params[name] = v.astype(onp.float32)
    for name, p in jnet.collect_params().items():
        p.set_data(params[name])
    return params


def test_resnet50_eval_logits_match_jax_functionalize():
    """ResNet-50 v1 built as ``__graft_entry__.entry()`` builds it
    (classes 1000, ``functionalize(training=False)``) at (1, 3, 32, 32):
    the jitted JAX ``fn``'s logits against the port's ``fn`` given the
    JAX net's weights while the block still holds its own initial ones
    (so ``fn`` must compute with what it is given), then against the
    block after ``from_jax_params``, which must equal that ``fn`` call
    bitwise. Within 1e-4 (53 convolutions and BatchNorms of f32 sums in
    another order)."""
    x = onp.random.RandomState(9).randn(1, 3, 32, 32).astype(onp.float32)
    tnet = tvision.resnet50_v1(classes=1000)
    tnet.initialize(device="cpu")
    tfn, tparams = tnet.functionalize(_t(x))
    jnet = jvision.resnet50_v1(classes=1000)
    params = _resnet_weights(tnet, jnet, 10)
    fn, _ = jnet.functionalize(jmx.np.array(x), training=False)
    want = jax.jit(lambda p, a: fn(p, a)[0])(
        {n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x))
    assert set(tparams) == set(params)
    given = {n: _t(v) for n, v in params.items()}
    with torch.no_grad():
        out, new = tfn(given, _t(x))
    _close(out, want, 1e-4, "fn")
    assert all(new[n] is given[n] for n in given)
    from_jax_params(params, tnet)
    with torch.no_grad():
        got = tnet(_t(x))
    _close(got, want, 1e-4, "block")
    assert torch.equal(out, got)


def _sce(logits, label):
    lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.take_along_axis(lp, label[:, None], axis=-1)[:, 0]


def test_resnet18_train_step_and_sgd_match_jax():
    """resnet18_v1(thumbnail=True, classes=10) at (2, 3, 32, 32), train
    mode: the port's ``record``/``SoftmaxCrossEntropyLoss``/``backward``
    against ``jax.value_and_grad`` of the JAX ``functionalize(training=
    True)`` fn (the mean loss within 1e-5 relative, each gradient within
    1e-4 of its largest magnitude, the new running statistics within
    F32_TOL), then one SGD momentum step (lr 0.05, momentum 0.9) of both
    Trainers, the JAX one on value_and_grad's gradients, every parameter
    compared afterwards within 1e-5. Before that, ``torch.func.
    grad_and_value`` of the port's ``functionalize(training=True)`` fn,
    given the JAX net's weights while the block still holds its own
    initial ones, against the same loss, gradients and statistics at
    the same tolerances; neither the given tensors nor the block
    change."""
    rng = onp.random.RandomState(11)
    x = rng.randn(2, 3, 32, 32).astype(onp.float32)
    y = onp.array([3, 7])
    tnet = tvision.resnet18_v1(thumbnail=True, classes=10)
    tnet.initialize(device="cpu")
    with autograd.pause():
        tnet(_t(x))                     # completes the deferred shapes
    jnet = jvision.resnet18_v1(thumbnail=True, classes=10)
    params = _resnet_weights(tnet, jnet, 12)
    fn, _ = jnet.functionalize(jmx.np.array(x), training=True)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}

    def loss_fn(p):
        out, new = fn(p, jnp.asarray(x))
        return _sce(out, jnp.asarray(y)).mean(), new

    (jloss, jnew), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams)
    tp = tnet.collect_params()
    own = {n: p.data().detach().clone() for n, p in tp.items()}
    given = {n: _t(v) for n, v in params.items()}
    tfn, _ = tnet.functionalize(training=True)

    def tloss_fn(p):
        out, new = tfn(p, _t(x))
        lp = torch.log_softmax(out, -1)
        loss = -lp[torch.arange(len(y)), torch.from_numpy(y)].mean()
        return loss, new

    fgrads, (floss, fnew) = torch.func.grad_and_value(
        tloss_fn, has_aux=True)(given)
    _close(floss, jloss, 1e-5, "fn loss")
    for name, p in tp.items():
        assert torch.equal(given[name], _t(params[name])), name
        assert torch.equal(p.data(), own[name]), name
        if p.grad_req == "null":
            _close(fnew[name], jnew[name], F32_TOL, f"fn {name}")
        else:
            _close(fgrads[name], jgrads[name], 1e-4, f"fn grad {name}")

    from_jax_params(params, tnet)
    with autograd.record():
        tl = tloss.SoftmaxCrossEntropyLoss()(tnet(_t(x)),
                                             torch.from_numpy(y))
    autograd.backward(tl.mean())
    _close(tl.mean(), jloss, 1e-5, "loss")
    for name, p in tp.items():
        if p.grad_req == "null":
            _close(p.data(), jnew[name], F32_TOL, name)
        else:
            _close(p.grad(), jgrads[name], 1e-4, f"grad {name}")

    # the JAX net takes value_and_grad's gradients and new statistics,
    # and its Trainer steps on them
    for name, p in jnet.collect_params().items():
        if p.grad_req == "null":
            p.set_data(jnew[name])
        else:
            p.grad()._set_data(jgrads[name])
    jtrainer = jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                                 {"learning_rate": 0.05, "momentum": 0.9})
    ttrainer = Trainer(tp, "sgd", {"learning_rate": 0.05, "momentum": 0.9})
    jtrainer.step(1)
    ttrainer.step(1)
    for name, p in jnet.collect_params().items():
        _close(tp[name].data(), p.data().asnumpy(), 1e-5, f"after {name}")


def test_resnet18_v1_golden_logits(tmp_path):
    """The JAX package's model store writes resnet18_v1's .params; the
    port loads it with ``load_parameters`` and its train-mode logits on
    the golden input (``tests/test_model_zoo.py``) equal
    ``tests/golden/resnet18_v1_logits.npz`` within the JAX test's
    2e-4 (rtol and atol)."""
    from mxnet_tpu.gluon.model_zoo import model_store

    path = model_store.get_model_file("resnet18_v1", root=str(tmp_path))
    net = tvision.resnet18_v1()
    net.load_parameters(path, device="cpu")
    x = onp.random.RandomState(1234).uniform(
        -1, 1, size=(2, 3, 224, 224)).astype(onp.float32)
    with autograd.record():
        logits = net(_t(x)).detach().numpy()
    golden = onp.load(os.path.join(GOLDEN, "resnet18_v1_logits.npz"))
    onp.testing.assert_allclose(logits, golden["logits"], rtol=2e-4,
                                atol=2e-4)


# ---------------------------------------------------------------------------
# functionalize and hybridize
# ---------------------------------------------------------------------------
def _small_net():
    net = tvision.resnet18_v1(thumbnail=True, classes=4)
    net.initialize(device="cpu")
    return net


def test_functionalize_leaves_params_unchanged():
    """A training-mode ``fn`` returns new running statistics (equal to
    what an eager training forward writes) and leaves the ``params`` it
    was given, and the block's own statistics, unchanged; the outputs
    equal the eager training forward's; ``key`` (a generator) is
    accepted."""
    net = _small_net()
    x = _t(onp.random.RandomState(13).randn(2, 3, 16, 16))
    fn, params = net.functionalize(x, training=True)
    before = {n: t.clone() for n, t in params.items()}
    out, new = fn(params, x, key=torch.Generator().manual_seed(0))
    for n, t in params.items():
        assert torch.equal(t, before[n]), n
        assert torch.equal(net.collect_params()[n].data(), before[n]), n
    stats = [n for n in params if n.endswith("running_mean")]
    assert stats and all(not torch.equal(new[n], params[n]) for n in stats)
    with autograd.record():
        eager = net(x)
    assert torch.equal(out, eager)
    for n in stats:
        assert torch.equal(new[n], net.collect_params()[n].data()), n


def test_hybridized_block_on_the_cpu_runs_eagerly_with_gradients():
    """On the CPU a hybridized block (the reference's hybridize options
    accepted) gives the eager result and captures nothing; while
    recording, gradients flow through it as through the eager block;
    ``hybridize(False)`` turns it back."""
    net = _small_net()
    x = _t(onp.random.RandomState(14).randn(2, 3, 16, 16))
    with torch.no_grad():
        want = net(x)
    net.hybridize(static_alloc=True, static_shape=True)
    with torch.no_grad():
        assert torch.equal(net(x), want)
    assert net.captures == 0 and net.replays == 0
    grads = []
    for active in (True, False):
        net.hybridize(active)
        with autograd.record():
            loss = net(x).square().sum()
        autograd.backward(loss)
        grads.append({n: p.grad().clone()
                      for n, p in net.collect_params().items()
                      if p.grad_req != "null"})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


def test_vision_entry_points_raise_without_a_card():
    """With no card, initialize() on the default device raises
    MXNetError, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: initialize() runs on it")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tvision.resnet50_v1().initialize()
