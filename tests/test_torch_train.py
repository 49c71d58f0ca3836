"""The training slice of the PyTorch port against the JAX package, on the
CPU: a tiny gpt_like trained through ``SoftmaxCrossEntropyLoss``,
``autograd.record()`` / ``backward()`` and ``Trainer.step`` in both
packages from the same seeded numpy weights and tokens.

The JAX side runs under ``no_pallas()``: the same function through its
jnp paths (flash attention's masked f32 softmax, the plain logsumexp,
the jnp LayerNorm), which costs a fifth of the interpreted Pallas
kernels; ``test_torch_train_kernels.py`` holds the port's plain versions
against the Pallas bodies. Its model and loss are hybridized once per
module, which compiles each into one program instead of tracing op by
op at every first step. The port runs its kernel wrappers, whose plain
versions CPU tensors take. Tolerance 1e-4 (f32 through two layers, a
softmax over 64 classes and the optimizer, summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu import autograd as jautograd
from mxnet_tpu import numpy as mxnp
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JLoss
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ops.nn import no_pallas
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_jax_params, to_jax_params
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.nn import Dropout
from mxnet_tpu_torch.ops import nn as tnn

CFG = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
           num_heads=4, max_length=32)
TOL = 1e-4
B, L = 2, 16


@pytest.fixture(scope="module")
def jax_blocks():
    """The JAX gpt_like and loss, hybridized; each test sets the weights."""
    jnet = jbert.gpt_like(dropout=0.0, **CFG)
    jnet.initialize()
    jnet.hybridize()
    jloss = JLoss()
    jloss.hybridize()
    return jnet, jloss


def _models(seed, jnet=None):
    """The JAX gpt_like (a fresh one unless given) with seeded numpy
    weights, and the port's with the same weights through
    from_jax_params."""
    if jnet is None:
        jnet = jbert.gpt_like(dropout=0.0, **CFG)
        jnet.initialize()
    rng = onp.random.RandomState(seed)
    params = {}
    for name, p in jnet.collect_params().items():
        v = (1.0 + 0.1 * rng.randn(*p.shape) if name.endswith(".gamma")
             else 0.2 * rng.randn(*p.shape))
        params[name] = v.astype(onp.float32)
        p.set_data(params[name])
    tnet = tbert.gpt_like(device="cpu", **CFG)
    from_jax_params(params, tnet)
    return jnet, tnet, params


def _jax_step(jnet, jloss, jtr, tokens):
    with no_pallas():
        x = mxnp.array(tokens)
        with jautograd.record():
            logits = jnet(x)
            loss = jloss(logits[:, :-1], x[:, 1:])
        jautograd.backward(loss)
        grads = {n: p.grad().asnumpy()
                 for n, p in jnet.collect_params().items()}
        jtr.step(B)
    return logits.asnumpy(), loss.asnumpy(), grads


def _torch_step(tnet, ttr, tokens):
    x = torch.from_numpy(tokens)
    with autograd.record():
        logits = tnet(x)
        loss = SoftmaxCrossEntropyLoss()(logits[:, :-1], x[:, 1:])
    autograd.backward(loss)
    grads = {n: p.grad.numpy().copy() for n, p in tnet.named_parameters()}
    ttr.step(B)
    return logits.detach().numpy(), loss.detach().numpy(), grads


@pytest.mark.parametrize("opt,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01})])
def test_train_steps_match_jax(jax_blocks, opt, opt_params):
    """Two train steps in each package: the forward logits, the per-row
    loss and every parameter's gradient by name at both steps, and every
    weight after the second step, within 1e-4. The second step's
    gradients agree only if the port's backward wrote them anew rather
    than adding to the first step's (the reference's grad_req="write")."""
    jnet, tnet, params = _models(0, jax_blocks[0])
    tokens = onp.random.RandomState(1).randint(0, CFG["vocab_size"],
                                               (B, L)).astype(onp.int32)
    jtr = JTrainer(jnet.collect_params(), opt, dict(opt_params))
    ttr = Trainer(dict(tnet.named_parameters()), opt, dict(opt_params))
    for step in range(2):
        jl, jloss, jg = _jax_step(jnet, jax_blocks[1], jtr, tokens)
        tl, tloss, tg = _torch_step(tnet, ttr, tokens)
        assert tloss.shape == (B,) and set(tg) == set(jg) == set(params)
        onp.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
        onp.testing.assert_allclose(tloss, jloss, rtol=TOL, atol=TOL)
        for name in jg:
            onp.testing.assert_allclose(tg[name], jg[name], rtol=TOL,
                                        atol=TOL, err_msg=name)
        assert all(p.grad is None for p in tnet.parameters())
    got = to_jax_params(tnet)
    for name, p in jnet.collect_params().items():
        onp.testing.assert_allclose(got[name], p.data().asnumpy(), rtol=TOL,
                                    atol=TOL, err_msg=name)
        assert not onp.allclose(got[name], params[name]), name


@pytest.mark.parametrize("kw", [dict(from_logits=True), dict(axis=1),
                                dict(sparse_label=False, weight=0.5)])
def test_softmax_ce_loss_unfused_paths_match_jax(kw):
    """The paths of SoftmaxCrossEntropyLoss that bypass the fused kernel
    (log-probability inputs, a class axis other than the last, dense
    labels with a loss weight) against the JAX loss: the per-row loss and
    d(sum loss)/d pred, within 1e-5 (f32 softmax over 5 or 7 classes)."""
    rng = onp.random.RandomState(21)
    pred = rng.randn(3, 5, 7).astype(onp.float32)
    if kw.get("sparse_label", True):
        n_cls = pred.shape[kw.get("axis", -1)]
        shape = (3, 7) if kw.get("axis") == 1 else (3, 5)
        label = rng.randint(0, n_cls, shape).astype(onp.int32)
    else:
        label = rng.dirichlet(onp.ones(7), (3, 5)).astype(onp.float32)
    jp = mxnp.array(pred)
    jp.attach_grad()
    with jautograd.record():
        jl = JLoss(**kw)(jp, mxnp.array(label))
    jautograd.backward(jl)
    tp = torch.from_numpy(pred).requires_grad_()
    with autograd.record():
        tl = SoftmaxCrossEntropyLoss(**kw)(tp, torch.from_numpy(label))
    autograd.backward(tl)
    assert tuple(tl.shape) == (3,)
    onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(tp.grad.numpy(), jp.grad.asnumpy(),
                                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.5}),
    ("adam", {"learning_rate": 0.01, "epsilon": 0.1, "wd": 0.01}),
    ("adamw", {"learning_rate": 0.01, "epsilon": 0.1, "wd": 0.1,
               "clip_gradient": 0.5})])
def test_optimizer_rules_match_jax(name, kw):
    """Three updates of two parameters, the second under lr and wd
    multipliers set by name, with rescale_grad, against the JAX
    optimizer's imperative update, within 1e-6 (f32, one rule). The large
    epsilon makes Adam's epsilon placement show: the reference divides by
    sqrt(v) + eps after its bias correction, torch.optim inside it."""
    from mxnet_tpu import optimizer as jopt
    from mxnet_tpu_torch import optimizer as topt

    rng = onp.random.RandomState(5)
    w0 = [rng.randn(4, 3).astype(onp.float32),
          rng.randn(6).astype(onp.float32)]
    grads = [[rng.randn(*w.shape).astype(onp.float32) for w in w0]
             for _ in range(3)]
    opts = []
    for mod in (jopt, topt):
        o = mod.create(name, rescale_grad=0.5, param_idx2name={0: "a", 1: "b"},
                       **kw)
        o.set_lr_mult({"b": 0.5})
        o.set_wd_mult({"b": 2.0})
        opts.append(o)
    jw = [mxnp.array(w) for w in w0]
    tw = [torch.from_numpy(w.copy()) for w in w0]
    js = [opts[0].create_state(i, w) for i, w in enumerate(jw)]
    ts = [opts[1].create_state(i, w) for i, w in enumerate(tw)]
    for step in grads:
        for i, g in enumerate(step):
            opts[0].update(i, jw[i], mxnp.array(g), js[i])
            js[i] = opts[0]._latest_states[i]
            opts[1].update(i, tw[i], torch.from_numpy(g), ts[i])
    for i in range(2):
        onp.testing.assert_allclose(tw[i].numpy(), jw[i].asnumpy(),
                                    rtol=1e-6, atol=1e-6)
        assert not onp.allclose(tw[i].numpy(), w0[i])


def test_trainer_refuses_a_step_without_backward_and_sets_lr():
    """After a step every .grad reads None, so a second step without a
    backward raises (ignore_stale_grad=True skips); the learning rate
    reads and sets through the optimizer."""
    w = torch.nn.Parameter(torch.ones(3))
    tr = Trainer({"w": w}, "sgd", {"learning_rate": 0.5})
    with autograd.record():
        loss = (w * torch.tensor([1.0, 2.0, 3.0])).sum()
    autograd.backward(loss)
    tr.step(1)
    onp.testing.assert_allclose(w.detach().numpy(), [0.5, 0.0, -0.5])
    assert w.grad is None
    with pytest.raises(MXNetError, match="no gradient"):
        tr.step(1)
    tr.step(1, ignore_stale_grad=True)
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25


def test_autograd_backward_takes_ones_for_non_scalar_heads():
    """autograd.backward on a non-scalar head takes ones as its gradient
    (as the reference does; a bare torch backward refuses it), and
    several heads add up."""
    x = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    with autograd.record():
        assert autograd.is_training() and autograd.is_recording()
        y = x * x
        z = 3 * x
    assert not autograd.is_training()
    with pytest.raises(RuntimeError):
        y.backward(retain_graph=True)
    autograd.backward([y, z])
    onp.testing.assert_allclose(x.grad.numpy(), [5.0, -1.0, 9.0])
    with autograd.pause():
        assert not torch.is_grad_enabled()


def test_dropout_applies_only_while_training():
    """Dropout is the identity outside record(); inside it zeroes about a
    fraction p and scales the rest by 1 / (1 - p), from the seeded
    generator of the device (the same mask after the same reseed)."""
    x = torch.ones(4000)
    drop = Dropout(0.25)
    assert torch.equal(drop(x), x)
    tnn.seed(7)
    with autograd.record():
        a = drop(x)
    tnn.seed(7)
    with autograd.record(), torch.no_grad():
        b = drop(x)
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.7 < kept.float().mean().item() < 0.8
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))


def test_forward_refuses_sequences_past_max_length():
    _, tnet, _ = _models(2)
    with pytest.raises(MXNetError, match="max_length"):
        tnet(torch.zeros((1, CFG["max_length"] + 1), dtype=torch.int64))


def test_to_jax_params_round_trips_through_from_jax_params():
    """to_jax_params gives the reference names and values the model was
    loaded with; loading them into a fresh model gives the same state,
    and bfloat16 parameters come back as exact float32."""
    _, tnet, params = _models(3)
    got = to_jax_params(tnet)
    assert set(got) == set(params)
    for name in params:
        assert got[name].dtype == onp.float32
        onp.testing.assert_array_equal(got[name], params[name])
    fresh = tbert.gpt_like(device="cpu", **CFG)
    from_jax_params(got, fresh)
    for (n, a), (_, b) in zip(tnet.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
    half = tbert.gpt_like(device="cpu", dtype="bfloat16", **CFG)
    from_jax_params(params, half)
    back = to_jax_params(half)
    onp.testing.assert_array_equal(
        back["pos_embed"], half.pos_embed.detach().float().numpy())


def test_functionalize_computes_with_the_given_params():
    """gpt_like's ``functionalize`` fn given the JAX net's weights while
    the block holds its own initial ones: the logits, the mean loss and
    the gradient of every given tensor (``word_embed.weight``'s with the
    tied head's term) against ``jax.value_and_grad`` of the JAX
    ``functionalize`` fn, within 1e-4; the block's own weights are left
    as they were. The gradient is torch's autograd through ``fn``: the
    kernels' autograd Functions take no ``torch.func`` transform."""
    jnet, _, params = _models(6)
    tokens = onp.random.RandomState(7).randint(0, CFG["vocab_size"],
                                               (B, L)).astype(onp.int32)
    with no_pallas():
        fn, _ = jnet.functionalize(mxnp.array(tokens))

        def loss_fn(p):
            logits = fn(p, jnp.asarray(tokens))[0]
            lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
            nll = -jnp.take_along_axis(lp, jnp.asarray(tokens)[:, 1:, None],
                                       axis=-1)
            return nll.mean(), logits

        (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))({n: jnp.asarray(v)
                                     for n, v in params.items()})
    tnet = tbert.gpt_like(device="cpu", **CFG)
    own = {n: t.detach().clone() for n, t in tnet.state_dict().items()}
    tfn, tparams = tnet.functionalize(torch.from_numpy(tokens))
    assert set(tparams) == set(params)
    given = {n: torch.from_numpy(v).requires_grad_()
             for n, v in params.items()}
    x = torch.from_numpy(tokens).long()
    with autograd.record():
        logits = tfn(given, x)[0]
        lp = torch.log_softmax(logits[:, :-1], -1)
        loss = -lp.gather(-1, x[:, 1:, None]).mean()
    grads = torch.autograd.grad(loss, list(given.values()))
    onp.testing.assert_allclose(logits.detach().numpy(), onp.asarray(jlogits),
                                rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(float(loss.detach()), float(jloss),
                                rtol=TOL, atol=TOL)
    for name, g in zip(given, grads):
        onp.testing.assert_allclose(g.numpy(), onp.asarray(jgrads[name]),
                                    rtol=TOL, atol=TOL, err_msg=name)
    for n, t in tnet.state_dict().items():
        assert torch.equal(t, own[n]), n
