"""The compiled training step of the PyTorch port against the JAX package,
on the CPU: the Trainer's fused update over device scalars, a hybridized
block under ``autograd.record()`` (one recorded node whose forward and
backward run eagerly here, as the card's graphs do), ``functionalize``'s
fn under ``torch.func``, the activation and normalization blocks and
ops, ``infer_shape`` and ``optimize_for(backend="fold_bn")``.

Inputs and weights are numpy arrays from seeded generators, given to
both packages. The JAX side of each model is built once per module and
its functions run under one ``jax.jit``. Tolerances: optimizer weights
1e-5 relative and 1e-6 absolute, bfloat16 masters 1e-2 and 1e-3 (the
tolerances of ``test_torch_train_front.py``); gradients and logits of
the small nets 1e-4 (float32 summed in another order through a few
layers); ops and blocks 1e-5; the hybridized node against the port's
own eager block bitwise (the same torch ops).
"""
import os

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.contrib import passes as jpasses
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.ops.nn import no_pallas
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch import numpy_extension as tnpx
from mxnet_tpu_torch.contrib import passes as tpasses
from mxnet_tpu_torch.convert import from_jax_params, to_jax_params
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
OP_TOL = dict(rtol=1e-5, atol=1e-5)


def _j(a):
    return jmx.np.array(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return onp.asarray(jnp.asarray(getattr(x, "_data", x), jnp.float32))


def _seeded(jnet, tnet, seed, scale=0.3):
    """The same seeded numpy weights in both nets (gamma near 1, running
    variance positive)."""
    rng = onp.random.RandomState(seed)
    params = {}
    for name, p in jnet.collect_params().items():
        shape = tuple(p.shape)
        if name.endswith(("gamma", "running_var")):
            v = 1.0 + 0.1 * rng.rand(*shape)
        else:
            v = scale * rng.randn(*shape)
        params[name] = v.astype(onp.float32)
        p.set_data(_j(params[name]))
    if tnet is not None:
        from_jax_params(params, tnet)
    return params


# ---------------------------------------------------------------------------
# the Trainer's fused update over device scalars
# ---------------------------------------------------------------------------
FUSABLE = [
    ("sgd", {"momentum": 0.9}), ("sgd", {}), ("nag", {}),
    ("signum", {}), ("signum", {"momentum": 0.0, "wd_lh": 0.01}),
    ("dcasgd", {"momentum": 0.9}), ("lars", {}),
    ("adam", {}), ("adam", {"correct_bias": False}), ("adamw", {}),
    ("adamax", {}), ("adagrad", {}), ("adadelta", {}),
    ("rmsprop", {}), ("rmsprop", {"centered": True, "clip_weights": 0.8}),
    ("ftrl", {}), ("ftml", {}), ("lamb", {}),
    ("lamb", {"bias_correction": False, "lower_bound": 0.5,
              "upper_bound": 2.0}),
    ("groupadagrad", {}),
]


def _dense_pair(seed, units=3, dtype=None, use_bias=True):
    """A Dense(units, in_units=4) in each package on the same seeded
    weights (cast to ``dtype``), and 3 steps of seeded gradients."""
    rng = onp.random.RandomState(seed)
    jnet = jmx.gluon.nn.Dense(units, in_units=4, use_bias=use_bias)
    tnet = tmx.gluon.nn.Dense(units, in_units=4, use_bias=use_bias)
    tnet.initialize(device="cpu")
    params = _seeded(jnet, tnet, seed)
    if dtype is not None:
        jnet.cast(dtype)
        tnet.cast(dtype)
    grads = [{n: (3 * rng.randn(*v.shape)).astype(onp.float32)
              for n, v in params.items()} for _ in range(3)]
    return jnet, tnet, grads


def _step_both(jnet, tnet, jtr, ttr, grads):
    """Both Trainers' step from the same gradients, written into each
    package's gradient buffers in the weights' dtype."""
    tparams = tnet.collect_params()
    for n, p in jnet.collect_params().items():
        p.grad()._set_data(jnp.asarray(grads[n]).astype(p.data().dtype))
        w = tparams[n].data()
        w.grad = torch.from_numpy(grads[n]).to(w.dtype)
    jtr.step(6)
    ttr.step(6)


def _sched(mod):
    return mod.lr_scheduler.FactorScheduler(step=1, factor=0.5, base_lr=0.2,
                                            warmup_steps=1,
                                            warmup_begin_lr=0.05)


@pytest.mark.parametrize("name,kw", FUSABLE,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(FUSABLE)])
def test_fused_update_over_device_scalars_matches_jax(name, kw):
    """Each fusable optimizer in the Trainer, 3 steps of a Dense from the
    same seeded gradients under a scheduler whose rate changes every
    step: the update reads lr,
    rescale_grad and t from 0-d tensors on the weights' device (t in
    float64), and the weights agree with the reference's fused step
    within TOL after every step (GroupAdaGrad's weight alone: it takes
    no 1-D weight)."""
    jnet, tnet, grads = _dense_pair(41, use_bias=name != "groupadagrad")
    params = dict(kw, learning_rate=0.1)
    if name != "groupadagrad":
        params["wd"] = 1e-3
    jtr = jmx.gluon.Trainer(jnet.collect_params(), name,
                            dict(params, lr_scheduler=_sched(jmx)))
    ttr = tmx.gluon.Trainer(tnet.collect_params(), name,
                            dict(params, lr_scheduler=_sched(tmx)))
    rates = []
    for k, g in enumerate(grads):
        _step_both(jnet, tnet, jtr, ttr, g)
        got = to_jax_params(tnet)
        for n, p in jnet.collect_params().items():
            onp.testing.assert_allclose(got[n], _np(p.data()), **TOL,
                                        err_msg=f"{name} step {k}: {n}")
        lr, scale, t = ttr._scalars
        assert lr.dim() == scale.dim() == t.dim() == 0
        assert (lr.dtype, scale.dtype, t.dtype) == (
            torch.float32, torch.float32, torch.float64)
        assert float(t) == k + 1 and float(scale) == onp.float32(1 / 6)
        rates.append(float(lr))
    assert len(set(rates)) == 3
    assert ttr.captures == 0        # the CPU runs the update eagerly


@pytest.mark.parametrize("name", ["sgd", "nag", "adagrad"])
def test_fused_update_multi_precision_bf16_matches_jax(name):
    """bfloat16 weights with float32 masters (``multi_precision``), 2
    steps through the fused update over device scalars: each weight is
    its master rounded to bfloat16 bitwise, and the masters agree with
    the reference's within 1e-2 relative (the tolerance of
    ``test_torch_train_front.py``'s bf16 Trainer test). The rules of one
    state tensor: the reference's fused step raises on a multi-precision
    state of two (Adam's, LAMB's: ``TypeError`` in
    ``Adam.update_step``)."""
    jnet, tnet, grads = _dense_pair(42, dtype="bfloat16")
    params = {"learning_rate": 0.05, "multi_precision": True}
    if name == "sgd":
        params["momentum"] = 0.9
    jtr = jmx.gluon.Trainer(jnet.collect_params(), name,
                            dict(params, lr_scheduler=_sched(jmx)))
    ttr = tmx.gluon.Trainer(tnet.collect_params(), name,
                            dict(params, lr_scheduler=_sched(tmx)))
    for g in grads[:2]:
        _step_both(jnet, tnet, jtr, ttr, g)
    jt = jtr.states_tree()["states"]
    for i, p in enumerate(tnet.collect_params().values()):
        master, _ = ttr._states[i]
        assert master.dtype == torch.float32
        assert torch.equal(p.data().detach(), master.bfloat16())
        onp.testing.assert_allclose(master.numpy(), onp.asarray(
            jt[str(i)][0], onp.float32), rtol=1e-2, atol=1e-3)


# ---------------------------------------------------------------------------
# a hybridized block under autograd.record() (tests/test_gluon.py)
# ---------------------------------------------------------------------------
class _JaxMLP:
    """The reference's MLP (Dense 16 relu, Dense 5) with its
    ``functionalize`` fn's gradients under one ``jax.jit`` each: of the
    outputs' sum and of the summed softmax cross entropy (as the
    reference's recorded MLP hands them to ``backward``) by the
    parameters, and of the squared outputs' sum by the input."""

    def __init__(self):
        self.net = jmx.gluon.nn.HybridSequential()
        self.net.add(jmx.gluon.nn.Dense(16, activation="relu", in_units=8),
                     jmx.gluon.nn.Dense(5, in_units=16))
        _seeded(self.net, None, 0)
        fn, _ = self.net.functionalize(_j(_mlp_input(0)))

        def out(p, x):
            return fn(p, x)[0]

        def ce(p, x, y):
            lp = jax.nn.log_softmax(out(p, x), axis=-1)
            return -jnp.take_along_axis(lp, y[:, None], axis=-1).sum()

        self.grad_sum = jax.jit(jax.grad(lambda p, x: out(p, x).sum()))
        self.grad_ce = jax.jit(jax.grad(ce))
        self.grad_x = jax.jit(jax.grad(
            lambda x, p: (out(p, x) ** 2).sum()))


@pytest.fixture(scope="module")
def jax_mlp():
    return _JaxMLP()


def _mlp_pair(jmlp, seed):
    """The port's MLP, and the seeded weights it shares with the
    reference's (set into both)."""
    tnet = tmx.gluon.nn.HybridSequential()
    tnet.add(tmx.gluon.nn.Dense(16, activation="relu", in_units=8),
             tmx.gluon.nn.Dense(5, in_units=16))
    tnet.initialize(device="cpu")
    return tnet, _seeded(jmlp.net, tnet, seed)


def _mlp_input(seed):
    return onp.random.RandomState(seed).uniform(-1, 1, (32, 8)).astype(
        onp.float32)


def _recorded_node(out):
    """The :class:`_CachedOp` node of a hybridized call's output."""
    fn = out.grad_fn
    assert fn is not None and type(fn).__name__ == "_CachedOpBackward"
    return fn


def test_hybridized_backward_is_one_node_and_matches(jax_mlp):
    """(test_gluon.py:57) A hybridized MLP under record() records ONE
    node over the call; its parameters' gradients equal the eager
    block's bitwise, and the reference's (``jax.grad`` of its fn) within
    GRAD_TOL."""
    tnet, params = _mlp_pair(jax_mlp, 51)
    x = _mlp_input(52)
    want = jax_mlp.grad_sum(params, x)
    grads = []
    for active in (False, True):
        tnet.hybridize(active)
        with autograd.record():
            out = tnet(torch.from_numpy(x))
            loss = out.sum()
        if active:
            node = _recorded_node(out)
            # the call's input and its 4 parameters
            assert len(node.next_functions) == 5
        autograd.backward(loss)
        grads.append({n: p.grad().clone()
                      for n, p in tnet.collect_params().items()})
    for n in params:
        assert torch.equal(grads[0][n], grads[1][n]), n
        assert grads[1][n].abs().sum() > 0, n
        onp.testing.assert_allclose(_np(grads[1][n]), onp.asarray(want[n]),
                                    **GRAD_TOL, err_msg=n)


def test_hybridized_batchnorm_statistics_move_once_per_call():
    """(test_gluon.py:102) A hybridized BatchNorm under record(): the
    running statistics are the node's state, read and written where
    they lie, once per call; after one call they equal the reference's,
    and a second call moves them again."""
    jbn = jmx.gluon.nn.BatchNorm(in_channels=4)
    tbn = tmx.gluon.nn.BatchNorm(in_channels=4)
    tbn.initialize(device="cpu")
    _seeded(jbn, tbn, 53)
    jbn.hybridize()
    tbn.hybridize()
    x = onp.random.RandomState(54).normal(1.0, 1.0, (8, 4, 3, 3)).astype(
        onp.float32)
    with jautograd.record():
        jbn(_j(x))
    with autograd.record():
        out = tbn(torch.from_numpy(x))
    graph = _recorded_node(out)
    assert out.requires_grad and graph is not None
    for n in ("running_mean", "running_var"):
        onp.testing.assert_allclose(
            _np(getattr(tbn, n).data()), _np(getattr(jbn, n).data()),
            **OP_TOL, err_msg=n)
    rm1 = tbn.running_mean.data().clone()
    with autograd.record():
        tbn(torch.from_numpy(x))
    assert not torch.allclose(rm1, tbn.running_mean.data())


def test_hybridized_mlp_trains_with_the_trainer_as_the_reference(jax_mlp):
    """(test_gluon.py:145) A hybridized MLP classifier trained 3 steps by
    Adam through SoftmaxCrossEntropyLoss: the port's Trainer against the
    reference's, which steps on its fn's gradients of the same loss
    written into its parameters' gradient buffers; the weights agree
    within GRAD_TOL after the last step."""
    tnet, params = _mlp_pair(jax_mlp, 55)
    tnet.hybridize()
    x = _mlp_input(56)
    y = onp.random.RandomState(56).randint(0, 5, 32)
    jparams = jax_mlp.net.collect_params()
    jtr = jmx.gluon.Trainer(jparams, "adam", {"learning_rate": 0.01})
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "adam",
                            {"learning_rate": 0.01})
    tce = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(3):
        now = {n: p.data()._data for n, p in jparams.items()}
        for n, g in jax_mlp.grad_ce(now, x, jnp.asarray(y)).items():
            jparams[n].grad()._set_data(g)
        jtr.step(32)
        with autograd.record():
            tl = tce(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        autograd.backward(tl)
        ttr.step(32)
    got = to_jax_params(tnet)
    for n, p in jparams.items():
        onp.testing.assert_allclose(got[n], _np(p.data()), **GRAD_TOL,
                                    err_msg=n)


def test_hybridized_input_gradients_match_eager_and_jax(jax_mlp):
    """(test_gluon.py:422) An input that requires grad is differentiated
    by the node: its gradient equals the eager block's bitwise and the
    reference's within GRAD_TOL; an input that does not is not."""
    tnet, params = _mlp_pair(jax_mlp, 57)
    xv = _mlp_input(58)
    want = jax_mlp.grad_x(xv, params)
    grads = []
    for active in (False, True):
        tnet.hybridize(active)
        xt = torch.from_numpy(xv).requires_grad_()
        with autograd.record():
            loss = (tnet(xt) ** 2).sum()
        autograd.backward(loss)
        grads.append(xt.grad.clone())
    assert torch.equal(grads[0], grads[1])
    onp.testing.assert_allclose(grads[1].numpy(), onp.asarray(want),
                                **GRAD_TOL)
    graph = tblock._EagerGraph(tnet, (torch.zeros(32, 8),))
    assert graph.diff_args == [False] and len(graph.params) == 4


def test_no_graphs_and_cpu_structure():
    """On the CPU nothing is captured; a recorded call is one node
    (``_EagerGraph``) whose structure lists the differentiated
    parameters and the state; inside ``_graphs_off`` the block runs as
    its plain forward (no node)."""
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(4, in_units=3), tmx.gluon.nn.BatchNorm(
        in_channels=4))
    net.initialize(device="cpu")
    net.hybridize()
    x = torch.randn(5, 3)
    graph = tblock._EagerGraph(net, (x,))
    assert len(graph.params) == 4 and len(graph.state) == 2
    with autograd.record():
        out = net(x)
    _recorded_node(out)
    with autograd.record(), tblock._graphs_off():
        out = net(x)
    assert type(out.grad_fn).__name__ != "_CachedOpBackward"
    assert tblock._graphs_on()
    assert net.captures == 0 and net.replays == 0


def test_lease_drops_only_a_keys_extra_graph_pair():
    """A recorded call's lease marks its graph pair busy until the
    backward; releasing it frees the pair for the next call of the key,
    and drops the pair from the key's list when it is not the first
    (captured while the first was busy), so idle pairs do not pile up.
    Release is idempotent (the backward and the node's end both
    release)."""
    class Pair:
        def __init__(self, slots=None):
            self.busy, self.slots = False, slots

    slots = []
    first = Pair()
    slots.append(first)
    extra = Pair(slots)
    slots.append(extra)
    leases = [tblock._Lease(first), tblock._Lease(extra)]
    assert first.busy and extra.busy
    for lease in leases + leases:
        lease.release()
    assert slots == [first] and not first.busy and not extra.busy


def test_hybridized_grad_semantics_are_the_ports(jax_mlp):
    """Through the recorded node the port's ``.grad`` semantics hold: a
    ``grad_req="add"`` parameter sums two backwards as the eager block
    does (bitwise), a "write" one takes the last; after a Trainer step
    the "write" gradients read None and a second step raises."""
    tnet, _ = _mlp_pair(jax_mlp, 59)
    tnet[0].weight.grad_req = "add"
    x = torch.from_numpy(onp.random.RandomState(60).randn(4, 8).astype(
        onp.float32))
    grads = []
    for active in (False, True):
        tnet.hybridize(active)
        tnet.zero_grad(set_to_none=True)
        for _ in range(2):
            with autograd.record():
                loss = tnet(x).square().sum()
            autograd.backward(loss)
        grads.append({n: p.grad().clone()
                      for n, p in tnet.collect_params().items()})
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
    with autograd.record():
        loss = tnet(x).square().sum()
    autograd.backward(loss)
    once = tnet[0].bias.grad().clone()
    assert torch.equal(once, grads[1]["0.bias"])         # "write": last
    tr = tmx.gluon.Trainer(tnet.collect_params(), "sgd")
    tr.step(4)
    assert tnet[0].bias.data().grad is None
    assert tnet[0].weight.data().grad is not None        # "add" kept
    with pytest.raises(tmx.base.MXNetError, match="no gradient"):
        tr.step(4)


# ---------------------------------------------------------------------------
# functionalize's fn under torch.func against jax.grad / jax.vmap
# ---------------------------------------------------------------------------
CFG = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
           num_heads=4, max_length=32)


@pytest.fixture(scope="module")
def lm_case():
    """gpt_like in both packages on one set of seeded weights, and the
    reference's loss gradient and vmapped logits under one jit."""
    jnet = jbert.gpt_like(dropout=0.0, **CFG)
    tnet = tbert.gpt_like(device="cpu", **CFG)
    params = _seeded(jnet, tnet, 61, scale=0.2)
    tokens = onp.random.RandomState(62).randint(
        0, CFG["vocab_size"], (3, 2, 8)).astype(onp.int32)
    with no_pallas():
        fn, _ = jnet.functionalize(_j(tokens[0]))

        def loss(p, t):
            logits = fn(p, t)[0]
            lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
            return -jnp.take_along_axis(lp, t[:, 1:, None], axis=-1).mean()

        jp = {n: jnp.asarray(v) for n, v in params.items()}
        grads, logits = jax.jit(lambda p, ts: (
            jax.grad(loss)(p, ts[0]),
            jax.vmap(lambda t: fn(p, t)[0])(ts)))(jp, jnp.asarray(tokens))
    return tnet, params, tokens, grads, logits


def _lm_loss(logits, t):
    lp = torch.log_softmax(logits[:, :-1], -1)
    return -lp.gather(-1, t[:, 1:, None]).mean()


def test_torch_func_grad_of_functionalize_matches_jax_grad(lm_case):
    """``torch.func.grad`` of a loss over gpt_like's ``functionalize``
    fn (through the K1, K2 and K3 autograd Functions, their plain
    versions here) against ``jax.grad`` of the reference's fn, within
    GRAD_TOL for every parameter."""
    tnet, params, tokens, jgrads, _ = lm_case
    fn, tparams = tnet.functionalize(torch.from_numpy(tokens[0]))
    t = torch.from_numpy(tokens[0]).long()
    grads = torch.func.grad(lambda p: _lm_loss(fn(p, t)[0], t))(tparams)
    assert set(grads) == set(params)
    for n, g in grads.items():
        onp.testing.assert_allclose(g.numpy(), onp.asarray(jgrads[n]),
                                    **GRAD_TOL, err_msg=n)


def test_torch_func_vmap_of_functionalize_matches_jax_vmap(lm_case):
    """``torch.func.vmap`` of gpt_like's fn over a leading axis of token
    batches (the kernels' Functions fold it into their rows or batch)
    against ``jax.vmap`` of the reference's fn, within GRAD_TOL; and
    ``vmap`` of ``grad`` runs."""
    tnet, params, tokens, _, jlogits = lm_case
    fn, tparams = tnet.functionalize(torch.from_numpy(tokens[0]))
    ts = torch.from_numpy(tokens).long()
    got = torch.func.vmap(lambda t: fn(tparams, t)[0])(ts)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(jlogits),
                                **GRAD_TOL)
    per = torch.func.vmap(torch.func.grad(
        lambda p, t: _lm_loss(fn(p, t)[0], t)), in_dims=(None, 0))(
        tparams, ts)
    assert per["word_embed.weight"].shape == (3,) + tuple(
        tparams["word_embed.weight"].shape)


def _bn_pair(seed):
    nets = []
    for mod in (jmx, tmx):
        nn = mod.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Conv2D(4, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=4), nn.Activation("relu"),
                nn.Flatten(), nn.Dense(3, in_units=4 * 6 * 6))
        if mod is tmx:
            net.initialize(device="cpu")
        nets.append(net)
    _seeded(*nets, seed)
    return nets


def test_torch_func_on_a_batchnorm_net_matches_jax():
    """A Conv/BatchNorm/Dense net: ``torch.func.grad`` of the training-
    mode fn's loss (batch statistics) against ``jax.grad``, and
    ``torch.func.vmap`` of the predict-mode fn against ``jax.vmap``,
    within GRAD_TOL; the training fn returns moved statistics."""
    jnet, tnet = _bn_pair(63)
    xs = onp.random.RandomState(64).randn(2, 4, 3, 6, 6).astype(onp.float32)
    jfn_t, jp = jnet.functionalize(_j(xs[0]), training=True)
    jfn_p, _ = jnet.functionalize(_j(xs[0]))
    jgrads, jouts = jax.jit(lambda p, x: (
        jax.grad(lambda q: jnp.sum(jfn_t(q, x[0])[0] ** 2))(p),
        jax.vmap(lambda v: jfn_p(p, v)[0])(x)))(jp, jnp.asarray(xs))
    tfn_t, tp = tnet.functionalize(torch.from_numpy(xs[0]), training=True)
    tfn_p, _ = tnet.functionalize(torch.from_numpy(xs[0]))
    x = torch.from_numpy(xs)
    diff = {n: v for n, v in tp.items() if "running" not in n}
    grads = torch.func.grad(lambda p: (tfn_t({**tp, **p}, x[0])[0] ** 2)
                            .sum())(diff)
    for n, g in grads.items():
        onp.testing.assert_allclose(g.numpy(), onp.asarray(jgrads[n]),
                                    **GRAD_TOL, err_msg=n)
    outs = torch.func.vmap(lambda v: tfn_p(tp, v)[0])(x)
    onp.testing.assert_allclose(outs.numpy(), onp.asarray(jouts), **GRAD_TOL)
    _, new = tfn_t(tp, x[0])
    assert not torch.equal(new["1.running_mean"], tp["1.running_mean"])


# ---------------------------------------------------------------------------
# ops and blocks
# ---------------------------------------------------------------------------
def _x(seed, shape=(2, 6, 5, 5)):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


OPS = [
    ("group_norm", lambda m, x, g, b: m.group_norm(x, g, b, num_groups=3,
                                                   eps=1e-5)),
    ("instance_norm", lambda m, x, g, b: m.instance_norm(x, g, b)),
    ("l2_instance", lambda m, x, g, b: m.l2_normalization(x)),
    ("l2_channel", lambda m, x, g, b: m.l2_normalization(x, mode="channel")),
    ("l2_spatial", lambda m, x, g, b: m.l2_normalization(x, mode="spatial")),
    ("leaky", lambda m, x, g, b: m.leaky_relu(x, slope=0.1)),
    ("prelu", lambda m, x, g, b: m.leaky_relu(x, g, act_type="prelu")),
    ("elu", lambda m, x, g, b: m.leaky_relu(x, act_type="elu", slope=0.7)),
    ("selu", lambda m, x, g, b: m.leaky_relu(x, act_type="selu")),
    ("gelu", lambda m, x, g, b: m.leaky_relu(x, act_type="gelu")),
    ("rrelu_predict", lambda m, x, g, b: m.leaky_relu(x, act_type="rrelu")),
    ("gelu_tanh", lambda m, x, g, b: m.gelu(x)),
    ("gelu_erf", lambda m, x, g, b: m.gelu(x, approximate=False)),
] + [(f"act_{a}", lambda m, x, g, b, a=a: m.activation(x, act_type=a))
     for a in ("relu", "sigmoid", "tanh", "softrelu", "softsign",
               "log_sigmoid", "mish", "silu", "swish", "gelu", "gelu_tanh")]


class _JaxOps:
    """The reference's ``npx`` ops as their functions in
    ``mxnet_tpu/ops/nn.py`` take them, on jnp arrays (predict mode), so
    that one ``jax.jit`` computes every case of :data:`OPS`."""

    group_norm = staticmethod(jops.group_norm)
    instance_norm = staticmethod(jops.instance_norm)
    l2_normalization = staticmethod(jops.l2_normalization)
    activation = staticmethod(jops.activation)

    @staticmethod
    def leaky_relu(x, gamma=None, **kw):
        return jops.leaky_relu(x, gamma, training=False, **kw)

    @staticmethod
    def gelu(x, approximate=True):          # npx.gelu
        return jax.nn.gelu(x, approximate=approximate)


@pytest.fixture(scope="module")
def op_case():
    """Float32 NCHW input, gamma and beta per channel, and the
    reference's output of every op of :data:`OPS` under one jit."""
    x = _x(71)
    rng = onp.random.RandomState(72)
    g = (1 + 0.1 * rng.randn(6)).astype(onp.float32)
    b = (0.1 * rng.randn(6)).astype(onp.float32)
    want = jax.jit(lambda *a: {n: op(_JaxOps, *a) for n, op in OPS})(
        x, g, b)
    return (x, g, b), want


@pytest.mark.parametrize("name,op", OPS, ids=[n for n, _ in OPS])
def test_op_matches_jax(op_case, name, op):
    """Each op on float32 NCHW input (gamma and beta per channel) against
    the reference's (``mxnet_tpu/ops/nn.py:576-680``, what its ``npx``
    calls), within OP_TOL."""
    inputs, want = op_case
    got = op(tnpx, *(torch.from_numpy(a) for a in inputs))
    onp.testing.assert_allclose(_np(got), onp.asarray(want[name]), **OP_TOL)


def test_rrelu_draws_within_its_bounds_in_training():
    """``rrelu`` while training: every negative input is scaled by a
    slope in [lower_bound, upper_bound), drawn per element (the draws
    are Philox's, not the reference's Threefry, so only the bounds are
    held); positive inputs pass."""
    x = torch.from_numpy(_x(73, (4, 256)))
    with autograd.train_mode():
        y = tnpx.leaky_relu(x, act_type="rrelu", lower_bound=0.2,
                            upper_bound=0.4)
    neg = x < 0
    slope = y[neg] / x[neg]
    assert bool(((slope >= 0.2 - 1e-6) & (slope < 0.4 + 1e-6)).all())
    assert slope.unique().numel() > 10
    assert torch.equal(y[~neg], x[~neg])


BLOCKS = [
    ("LeakyReLU", dict(alpha=0.2)), ("PReLU", dict(in_channels=6)),
    ("ELU", dict(alpha=0.5)), ("SELU", {}), ("GELU", {}),
    ("GELU", dict(approximation="tanh")), ("SiLU", {}),
    ("Swish", dict(beta=1.5)), ("GroupNorm", dict(num_groups=2)),
    ("InstanceNorm", {}),
]


@pytest.mark.parametrize("name,kw", BLOCKS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(BLOCKS)])
def test_block_matches_jax(name, kw):
    """Each block's ``collect_params()`` names (the reference's, so
    ``.params`` files cross) and its float32 output on seeded weights,
    within OP_TOL."""
    jb = getattr(jmx.gluon.nn, name)(**kw)
    tb = getattr(tmx.gluon.nn, name)(**kw)
    jb.initialize()
    tb.initialize(device="cpu")
    x = _x(74)
    jy = jb(_j(x))
    with torch.no_grad():
        tb(torch.from_numpy(x))
    assert list(tb.collect_params()) == list(jb.collect_params())
    _seeded(jb, tb, 75)
    with torch.no_grad():
        ty = tb(torch.from_numpy(x))
    onp.testing.assert_allclose(_np(ty), _np(jb(_j(x))), **OP_TOL)
    assert jy.shape == tuple(ty.shape)


def test_concatenate_matches_jax():
    """``Concatenate`` (a Block) and ``HybridConcatenate`` run every
    child on the input and join the outputs on ``axis``, as the
    reference's."""
    x = _x(76, (3, 4))
    for kind in ("Concatenate", "HybridConcatenate"):
        jc, tc = (getattr(m.gluon.nn, kind)(axis=1) for m in (jmx, tmx))
        for c, m in ((jc, jmx), (tc, tmx)):
            c.add(m.gluon.nn.Dense(2, in_units=4), m.gluon.nn.Dense(
                3, in_units=4))
        tc.initialize(device="cpu")
        _seeded(jc, tc, 77)
        with torch.no_grad():
            got = tc(torch.from_numpy(x))
        assert tuple(got.shape) == (3, 5)
        onp.testing.assert_allclose(_np(got), _np(jc(_j(x))), **OP_TOL)


# ---------------------------------------------------------------------------
# infer_shape and optimize_for
# ---------------------------------------------------------------------------
def _deferred(mod):
    nn = mod.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(), nn.Activation(
        "relu"), nn.Conv2D(4, 3, strides=2), nn.GroupNorm(num_groups=2),
        nn.Flatten(), nn.Dense(7), nn.PReLU(), nn.Dense(3))
    return net


def test_infer_shape_matches_jax():
    """``infer_shape`` on a net of deferred shapes completes every
    parameter's shape without running the net (the forward on the meta
    device), with the reference's shapes and output shape; the
    parameters are then initialized on their device."""
    x = _x(81, (2, 3, 9, 9))
    jnet, tnet = _deferred(jmx), _deferred(tmx)
    jnet.initialize(init="zeros")
    tnet.initialize(init="zeros", device="cpu")
    want = jnet.infer_shape(_j(x))
    got = tnet.infer_shape(torch.from_numpy(x))
    assert tuple(got) == tuple(want) == (2, 3)
    jshapes = {n: tuple(p.shape) for n, p in jnet.collect_params().items()}
    for n, p in tnet.collect_params().items():
        assert tuple(p.shape) == jshapes[n], n
        assert p.initialized and p.data().device.type == "cpu", n
    with torch.no_grad():
        assert tuple(tnet(torch.from_numpy(x)).shape) == (2, 3)


def test_optimize_for_fold_bn_matches_jax(monkeypatch):
    """``optimize_for(x, backend="fold_bn")`` folds each Conv + BatchNorm
    pair into the convolution (the BatchNorm becomes Identity, a bias
    grafted where there was none): its predict-mode output agrees with
    the reference's after the same pass and with the unfolded net's,
    within OP_TOL; ``MXNET_SUBGRAPH_BACKEND`` names the pass when
    ``backend`` is not given; the registries list the same passes."""
    assert tpasses.list_passes() == jpasses.list_passes()
    x = _x(82, (2, 3, 8, 8))
    outs = {}
    for mod in (jmx, tmx):
        nn = mod.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Conv2D(6, 3, padding=1, use_bias=False, in_channels=3),
                nn.BatchNorm(in_channels=6), nn.Activation("relu"),
                nn.Conv2D(4, 1, in_channels=6), nn.BatchNorm(in_channels=4))
        outs[mod] = net
    jnet, tnet = outs[jmx], outs[tmx]
    tnet.initialize(device="cpu")
    _seeded(jnet, tnet, 83)
    with torch.no_grad():
        before = tnet(torch.from_numpy(x))
    want = jnet.optimize_for(_j(x), backend="fold_bn")
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "fold_bn")
    with torch.no_grad():
        got = tnet.optimize_for(torch.from_numpy(x))
    assert [type(b).__name__ for b in tnet] == [
        "Conv2D", "Identity", "Activation", "Conv2D", "Identity"]
    assert tnet[0].bias is not None
    onp.testing.assert_allclose(_np(got), _np(want), **OP_TOL)
    onp.testing.assert_allclose(_np(got), _np(before), **OP_TOL)
    with pytest.raises(tmx.base.MXNetError, match="unknown"):
        tpasses.apply_pass(tnet, "nope")
    assert os.environ["MXNET_SUBGRAPH_BACKEND"] == "fold_bn"


def test_export_and_symbol_block_raise_naming_their_item():
    """``export`` and ``SymbolBlock`` (the reference's symbol graph) are
    not ported: each raises MXNetError naming ROADMAP item 10."""
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(device="cpu")
    with pytest.raises(tmx.base.MXNetError, match="item 10"):
        net.export("model")
    with pytest.raises(tmx.base.MXNetError, match="item 10"):
        tmx.gluon.SymbolBlock.imports("model-symbol.json", ["data"])
    with pytest.raises(tmx.base.MXNetError, match="item 10"):
        tmx.gluon.SymbolBlock()
