"""Parity of the port's mixed precision (``mxnet_tpu_torch.amp``) with the
JAX package's (``mxnet_tpu.amp``), on the CPU: the policy's cast
decisions on a small Conv-BatchNorm-Dense net with its loss, the dtypes
each op runs in, the loss scaler's dynamics, the overflow skip,
``unscale``, ``convert_hybrid_block`` and the graph key that
``amp.init()``/``disable()`` change (after ``tests/test_amp.py``).

Tolerances: the bf16 step's loss agrees with the reference's within
2e-2 (bf16 carries 8 bits; the two packages' convolutions sum in
another order before rounding), its float32 gradients, which flow back
through bf16 activations, within 0.1 of each tensor's largest
magnitude; the float16 ``unscale`` path's gradients and weights within
1e-6 relative; the loss scaler's values exactly.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch.gluon import Trainer as TTrainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.generation import routing_key
from mxnet_tpu_torch.ops import dispatch as tdispatch
from mxnet_tpu_torch.ops.kernels import cross_entropy as tce

BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _amp_off_after():
    yield
    jamp.disable()
    tamp.disable()


def _build(nn):
    net = nn.HybridSequential()
    # no convolution bias: BatchNorm cancels it, so its gradient is bf16
    # rounding noise alone
    net.add(nn.Conv2D(4, 3, in_channels=3, use_bias=False),
            nn.BatchNorm(in_channels=4),
            nn.Activation("relu"), nn.Dense(5, in_units=4 * 6 * 6))
    return net


def _pair():
    """The same net in both packages, the port's weights copied into the
    reference's."""
    jnet = _build(jnn)
    jnet.initialize()
    tnet = _build(tnn)
    tnet.initialize(device="cpu")
    for tp, jp in zip(tnet.collect_params().values(),
                      jnet.collect_params().values()):
        jp.set_data(jmx.np.array(tp.data().detach().numpy()))
    return jnet, tnet


def _logged(policy, log):
    """Record each (op name, dtype decided) of the policy's calls."""
    orig = policy.cast_inputs

    def cast_inputs(name, vals):
        if name in policy.target_ops:
            log.append((name, "target"))
        elif name in policy.fp32_ops:
            log.append((name, "float32"))
        return orig(name, vals)

    policy.cast_inputs = cast_inputs


_X = onp.random.default_rng(0).random((2, 3, 8, 8), dtype=onp.float32)
_Y = onp.array([1, 3])


@pytest.fixture(scope="module")
def reference_amp_step():
    """The reference's AMP forward, loss and backward, run once: its
    decisions, dtypes, loss, gradients and the weights it ran from."""
    jnet, tnet = _pair()
    jamp.init()
    log = []
    _logged(jmx.ops.dispatch.amp_policy, log)
    try:
        with jag.record():
            out = jnet(jmx.np.array(_X))
            loss = jloss.SoftmaxCrossEntropyLoss()(out, jmx.np.array(_Y))
        loss.backward()
    finally:
        jamp.disable()
    grads = [p.data().grad.asnumpy() for p in jnet.collect_params().values()
             if p.grad_req != "null"]
    return dict(log=log, out_dtype=str(out.dtype), loss=loss.asnumpy(),
                grads=grads, tnet=tnet)


@pytest.mark.parametrize("what", ["decisions", "dtypes", "loss", "grads"])
def test_amp_step_matches_reference(reference_amp_step, what):
    ref = reference_amp_step
    tnet = ref["tnet"]
    for p in tnet.collect_params().values():
        p.data().grad = None
    tamp.init()
    log, seen = [], {}
    _logged(tdispatch.amp_policy, log)

    def saw(key):
        def hook(block, args, out):
            seen[key] = out.dtype
        return hook

    hooks = [tnet[0].register_forward_hook(saw("conv")),
             tnet[3].register_forward_hook(saw("dense"))]
    orig_lse = tce.fused_lse

    def spy(x):
        seen["k3"] = x.dtype
        return orig_lse(x)

    tce.fused_lse = spy
    try:
        with tag.record():
            out = tnet(torch.from_numpy(_X))
            loss = tloss.SoftmaxCrossEntropyLoss()(out, torch.from_numpy(_Y))
        tag.backward(loss)
    finally:
        tce.fused_lse = orig_lse
        for h in hooks:
            h.detach()
    if what == "decisions":
        assert log == ref["log"] == [
            ("Convolution", "target"), ("BatchNorm", "float32"),
            ("FullyConnected", "target"), ("softmax_cross_entropy",
                                           "float32")]
    elif what == "dtypes":
        assert seen == {"conv": torch.bfloat16, "dense": torch.bfloat16,
                        "k3": torch.float32}
        assert ref["out_dtype"] == "bfloat16" and out.dtype == torch.bfloat16
        assert all(p.data().grad.dtype == torch.float32
                   for p in tnet.collect_params().values()
                   if p.grad_req != "null")
    elif what == "loss":
        onp.testing.assert_allclose(loss.float().detach().numpy(),
                                    ref["loss"].astype(onp.float32),
                                    rtol=BF16_TOL, atol=BF16_TOL)
    else:
        grads = [p.data().grad.numpy() for p in tnet.collect_params().values()
                 if p.grad_req != "null"]
        for g, r in zip(grads, ref["grads"]):
            scale = max(float(onp.abs(r).max()), 1e-6)
            assert float(onp.abs(g - r).max()) <= BF16_TOL * 5 * scale


@pytest.mark.parametrize("op,args,want", [
    ("fully_connected", ((2, 4), (3, 4)), torch.bfloat16),
    ("softmax", ((2, 4),), torch.float32),
    ("log_softmax", ((2, 4),), torch.float32),
    ("layer_norm", ((2, 4), (4,), (4,)), torch.float32),
    ("rms_norm", ((2, 4), (4,)), torch.float32),
    ("activation", ((2, 4),), None),
])
def test_named_op_dtypes(op, args, want):
    """Under a bf16 policy a target op runs in bf16 even from f32 inputs,
    an fp32 op in f32 even from bf16 ones, any other op as its input;
    with AMP off nothing is cast."""
    fn = getattr(tnpx, op)
    ins = [torch.ones(s, dtype=torch.bfloat16 if want == torch.float32
                      else torch.float32) for s in args]
    assert fn(*ins).dtype == ins[0].dtype
    tamp.init("bfloat16")
    assert fn(*ins).dtype == (want or ins[0].dtype)


def test_loss_scaler_dynamics():
    for amp in (jamp, tamp):
        s = amp.LossScaler(init_scale=64.0, scale_factor=2.0, scale_window=2)
        seq = []
        for overflow in (False, False, True, True, False, False, False):
            s.update_scale(overflow)
            seq.append(s.loss_scale)
        assert seq == [64.0, 128.0, 64.0, 32.0, 32.0, 64.0, 64.0]


@pytest.mark.parametrize("bad", ["inf", "nan", None])
def test_has_overflow(bad):
    net = tnn.Dense(4, in_units=4)
    net.initialize(device="cpu")
    g = torch.ones(4, 4)
    if bad:
        g[1, 2] = float(bad)
    net.weight.data().grad = g
    net.bias.data().grad = torch.zeros(4)
    assert tamp.LossScaler().has_overflow(
        list(net.collect_params().values())) == (bad is not None)


def test_overflow_skips_update():
    """float16 policy, init_scale 4: an inf gradient leaves the weights
    bitwise unchanged, clears the gradients and halves the scale, as in
    the reference; a clean step then updates."""
    tamp.init("float16")
    net = tnn.Dense(4, in_units=4)
    net.initialize(device="cpu")
    trainer = TTrainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    tamp.init_trainer(trainer, init_scale=4.0)
    w_before = net.weight.data().detach().clone()
    with tag.record():
        loss = net(torch.ones(2, 4)).float().sum()
    tag.backward(loss)
    net.weight.data().grad.fill_(float("inf"))
    trainer.step(1)
    assert torch.equal(net.weight.data(), w_before)
    assert net.weight.data().grad is None
    assert trainer._amp_loss_scaler.loss_scale == 2.0
    with tag.record():
        loss = net(torch.ones(2, 4)).float().sum()
    tag.backward(loss)
    trainer.step(1)
    assert not torch.equal(net.weight.data(), w_before)
    assert trainer._amp_loss_scaler.loss_scale == 2.0


def test_unscale_matches_reference():
    """scale_loss multiplies the gradients by the scale, unscale divides
    them back without touching the scale, and the wrapped step then
    does not divide again: the same weights as the reference's."""
    res = {}
    for name, amp, nn, Trainer, ag in (("jax", jamp, jnn, JTrainer, jag),
                                       ("torch", tamp, tnn, TTrainer, tag)):
        amp.init("float16")
        net = nn.Dense(2, in_units=2)
        if name == "jax":
            net.initialize()
            net.weight.set_data(jmx.np.array(onp.eye(2, dtype=onp.float32)))
            net.bias.set_data(jmx.np.zeros((2,)))
            x = jmx.np.ones((2, 2))
        else:
            net.initialize(device="cpu")
            net.weight.set_data(torch.eye(2))
            net.bias.set_data(torch.zeros(2))
            x = torch.ones(2, 2)
        trainer = Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.01})
        amp.init_trainer(trainer, init_scale=8.0)
        with ag.record():
            loss = net(x).astype("float32").sum() if name == "jax" \
                else net(x).float().sum()
            with amp.scale_loss(loss, trainer) as scaled:
                ag.backward([scaled])
        g = net.weight.data().grad
        scaled_g = onp.array(g.asnumpy() if name == "jax" else g.numpy())
        amp.unscale(trainer)
        g = net.weight.data().grad
        res[name] = [scaled_g, onp.array(g.asnumpy() if name == "jax"
                                         else g.numpy())]
        assert trainer._amp_loss_scaler.loss_scale == 8.0
        trainer.step(1)
        w = net.weight.data()
        res[name].append(w.asnumpy() if name == "jax"
                         else w.detach().numpy())
        assert trainer._amp_loss_scaler.loss_scale == 8.0
        amp.disable()
    for a, b in zip(res["torch"], res["jax"]):
        onp.testing.assert_allclose(a.astype(onp.float32),
                                    b.astype(onp.float32), rtol=1e-6)
    onp.testing.assert_allclose(res["torch"][1] * 8.0, res["torch"][0],
                                rtol=1e-6)


@pytest.mark.parametrize("hybridize", [False, True])
def test_convert_hybrid_block(hybridize):
    dtypes = []
    for amp, nn, x in ((jamp, jnn, lambda: jmx.np.ones((2, 4))),
                       (tamp, tnn, lambda: torch.ones(2, 4))):
        net = nn.Dense(8, in_units=4)
        if amp is jamp:
            net.initialize()
        else:
            net.initialize(device="cpu")
        if hybridize:
            net.hybridize()
        amp.convert_hybrid_block(net, "bfloat16")
        dtypes.append((str(net.weight.data().dtype).replace("torch.", ""),
                       str(net(x()).dtype).replace("torch.", "")))
    assert dtypes[0] == dtypes[1] == ("bfloat16", "bfloat16")


def test_amp_changes_graph_key():
    """The captured graphs key on the policy's version: amp.init() and
    disable() each give a new key, and two policies never share one."""
    off = routing_key("cpu")
    tamp.init()
    on = routing_key("cpu")
    tamp.init()
    again = routing_key("cpu")
    tamp.disable()
    assert len({off, on, again}) == 3 and routing_key("cpu") == off


def test_amp_invalidates_hybridized_cache():
    """A hybridized net's outputs follow amp.init()/disable(), as the
    reference's (its cached program keys on the policy version)."""
    seen = []
    for amp, nn, x in ((jamp, jnn, lambda: jmx.np.ones((2, 4))),
                       (tamp, tnn, lambda: torch.ones(2, 4))):
        net = nn.Dense(8, in_units=4)
        if amp is jamp:
            net.initialize()
        else:
            net.initialize(device="cpu")
        net.hybridize()
        out = [str(net(x()).dtype)]
        amp.init("bfloat16")
        out.append(str(net(x()).dtype))
        amp.disable()
        out.append(str(net(x()).dtype))
        seen.append([o.replace("torch.", "") for o in out])
    assert seen[0] == seen[1] == ["float32", "bfloat16", "float32"]


def test_amp_training_with_loss_scaler():
    """init -> init_trainer -> scale_loss -> step: float32 masters keep
    updating and the loss falls."""
    tamp.init("bfloat16")
    net = tnn.HybridSequential()
    net.add(tnn.Dense(16, activation="relu", in_units=4),
            tnn.Dense(1, in_units=16))
    net.initialize(device="cpu")
    trainer = TTrainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    tamp.init_trainer(trainer)
    assert trainer._amp_loss_scaler.loss_scale == 1.0   # bf16 starts at 1
    rng = onp.random.RandomState(0)
    x = torch.from_numpy(rng.randn(32, 4).astype(onp.float32))
    y = torch.from_numpy((rng.randn(32, 1) * 0.1).astype(onp.float32))
    losses = []
    for _ in range(20):
        with tag.record():
            loss = ((net(x).float() - y) ** 2).mean()
            with tamp.scale_loss(loss, trainer) as scaled:
                tag.backward(scaled)
        trainer.step(1)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]
    assert net[0].weight.data().dtype == torch.float32


def test_init_rejects_bad_dtype():
    with pytest.raises(tmx.MXNetError):
        tamp.init("int8")
    with pytest.raises(tmx.MXNetError):
        tamp.scale_loss(torch.ones(1), object()).__enter__()


def test_policy_version_and_lists():
    from mxnet_tpu.amp import lists as jlists
    from mxnet_tpu_torch.amp import lists as tlists

    assert tlists.TARGET_DTYPE_OPS == jlists.TARGET_DTYPE_OPS
    assert tlists.FP32_OPS == jlists.FP32_OPS
    a, b = tamp.AMPPolicy(), tamp.AMPPolicy("float16")
    assert a.version != b.version and b.target_dtype == torch.float16
    assert not tamp.is_enabled()
    tamp.init()
    assert tamp.is_enabled() and tdispatch.amp_version() is not None


@pytest.mark.parametrize("fn,args", [
    ("matmul", ((4, 4), (4, 4))), ("dot", ((4, 4), (4,))),
    ("einsum", ("ij,jk->ik", (3, 4), (4, 2))), ("sum", ((4, 4),)),
    ("mean", ((4, 4),)), ("exp", ((3,),)), ("log", ((3,),)),
    ("tanh", ((3,),)), ("power", ((3,), (3,))), ("linalg.norm", ((3, 3),)),
    ("add", ((3,), (3,))), ("cumsum", ((5,),)), ("var", ((4, 2),)),
])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_np_function_dtypes_match_reference(fn, args, in_dtype):
    """The np functions the AMP lists name cast where the reference's
    do: the output dtype of each, from float32 and from bfloat16 inputs,
    equals the reference's under a bf16 policy (and ``add``, in no list,
    keeps its input's)."""
    got = []
    for mod, amp, make in (
            (jmx.np, jamp, lambda s: jmx.np.ones(s, dtype=in_dtype)),
            (tmx.np, tamp, lambda s: torch.ones(
                s, dtype=getattr(torch, in_dtype)))):
        f = mod
        for part in fn.split("."):
            f = getattr(f, part)
        ins = [a if isinstance(a, str) else make(a) for a in args]
        amp.init("bfloat16")
        try:
            got.append(str(f(*ins).dtype).replace("torch.", ""))
        finally:
            amp.disable()
    assert got[0] == got[1]
