"""The training front door of the PyTorch port against the JAX package,
on the CPU: the learning-rate schedulers, the 17 registered optimizers
(with ``multi_precision``), the Trainer (a scheduler, the multipliers
fixed at its first step, ``.states`` files and ``Updater`` blobs across
the packages), every loss with its input gradient, and every metric.

Inputs are numpy arrays from seeded generators, given to both packages.
Tolerances: optimizer and Trainer weights 1e-5 relative and 1e-6
absolute (float32 rules summed in another order; the Trainer's learning
rate is rounded to float32 in both, and the reference widens some
scalars to float64 before rounding them, one float32 ulp); losses and
their gradients 1e-5; metrics 1e-6 (float32 sums in another order, or
float64 against float32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.numpy.random as jrandom
from mxnet_tpu import autograd as jautograd
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_jax_params, to_jax_params

TOL = dict(rtol=1e-5, atol=1e-6)


def _j(a):
    return jmx.np.array(a)


def _np(x):
    """A JAX-package array or a torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return onp.asarray(jnp.asarray(x._data if hasattr(x, "_data") else x,
                                   jnp.float32))


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------
SCHEDULERS = [
    ("FactorScheduler", dict(step=4, factor=0.5, stop_factor_lr=1e-3,
                             base_lr=0.1)),
    ("FactorScheduler", dict(step=3, factor=0.7, base_lr=0.2,
                             warmup_steps=5, warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[3, 9, 20], factor=0.1,
                                  base_lr=0.05)),
    ("MultiFactorScheduler", dict(step=[6, 12], factor=0.5, base_lr=0.1,
                                  warmup_steps=4, warmup_mode="constant",
                                  warmup_begin_lr=0.02)),
    ("PolyScheduler", dict(max_update=25, base_lr=0.1, pwr=2,
                           final_lr=1e-3)),
    ("PolyScheduler", dict(max_update=20, base_lr=0.3, pwr=1,
                           warmup_steps=5)),
    ("CosineScheduler", dict(max_update=24, base_lr=0.1, final_lr=0.01)),
    ("CosineScheduler", dict(max_update=18, base_lr=0.1, warmup_steps=6,
                             warmup_begin_lr=0.001)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULERS)])
def test_scheduler_matches_jax(name, kw):
    """Each scheduler, called at updates 0..30 in order (their state moves
    as updates pass), gives the reference's rates exactly (the same
    Python arithmetic), warmup included; inside an optimizer built with
    another learning_rate, base_lr takes it and warmup_final_lr keeps the
    scheduler's own."""
    js = getattr(jmx.lr_scheduler, name)(**kw)
    ts = getattr(tmx.lr_scheduler, name)(**kw)
    assert [ts(u) for u in range(31)] == [js(u) for u in range(31)]
    jo = jmx.optimizer.create("sgd", learning_rate=0.07,
                              lr_scheduler=getattr(jmx.lr_scheduler,
                                                   name)(**kw))
    to = tmx.optimizer.create("sgd", learning_rate=0.07,
                              lr_scheduler=getattr(tmx.lr_scheduler,
                                                   name)(**kw))
    assert to.lr_scheduler.warmup_final_lr == kw["base_lr"]
    rates = []
    for u in range(31):
        jo.num_update = to.num_update = u
        rates.append((to.learning_rate, jo.learning_rate))
    assert [t for t, _ in rates] == [j for _, j in rates]
    with pytest.raises(MXNetError):
        to.set_learning_rate(0.1)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
# (name, kwargs): the 17 registered optimizers with their defaults, and
# the variants the issue names
OPTIMIZERS = [
    ("sgd", {"momentum": 0.9}), ("sgd", {}), ("nag", {}),
    ("signum", {}), ("signum", {"momentum": 0.0, "wd_lh": 0.01}),
    ("sgld", {}), ("dcasgd", {"momentum": 0.9}), ("lars", {}),
    ("adam", {}), ("adam", {"correct_bias": False}), ("adamw", {}),
    ("adamax", {}), ("nadam", {}), ("adagrad", {}), ("adadelta", {}),
    ("rmsprop", {}), ("rmsprop", {"centered": True, "clip_weights": 0.8}),
    ("ftrl", {}), ("ftml", {}), ("lamb", {}),
    ("lamb", {"bias_correction": False, "lower_bound": 0.5,
              "upper_bound": 2.0}),
    ("groupadagrad", {}),
]


class _ThreefryNoise:
    """Replaces the JAX package's key source for SGLD and records the
    noise it draws with each key, for the port's ``draw_noise``."""

    def __init__(self, monkeypatch):
        self.keys = iter(jax.random.split(jax.random.PRNGKey(7), 64))
        self.drawn = []
        monkeypatch.setattr(jrandom, "new_key", self._key)

    def _key(self):
        key = next(self.keys)
        self.drawn.append(key)
        return key

    def feed(self, opt):
        """The port's next updates draw the noise of the keys the
        reference took since the last feed, in order."""
        pending, self.drawn = iter(self.drawn), []
        opt.draw_noise = lambda w: torch.from_numpy(onp.array(
            jax.random.normal(next(pending), tuple(w.shape), jnp.float32))
        ).to(w.dtype)


def _param_data(seed, n_steps=3):
    rng = onp.random.RandomState(seed)
    ws = [rng.randn(5, 4).astype(onp.float32),
          rng.randn(3, 6).astype(onp.float32)]
    gs = [[(rng.randn(*w.shape) * 3).astype(onp.float32) for w in ws]
          for _ in range(n_steps)]
    return ws, gs


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_three_steps_match_jax(name, kw, monkeypatch):
    """Three imperative updates of two (5, 4) and (3, 6) parameters with
    wd 0.01 (0 for GroupAdaGrad, which refuses it), rescale_grad 0.5 and
    clip_gradient 1.0 against the reference's (SGLD fed the reference's
    threefry noise): weights and every state tensor within TOL after each
    step."""
    opts = dict(kw, rescale_grad=0.5, clip_gradient=1.0,
                wd=0.0 if name == "groupadagrad" else 0.01)
    jo = jmx.optimizer.create(name, **opts)
    to = tmx.optimizer.create(name, **opts)
    ws, gs = _param_data(11)
    jw = [_j(w) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    js = {i: jo.create_state(i, w) for i, w in enumerate(jw)}
    ts = {i: to.create_state(i, w) for i, w in enumerate(tw)}
    noise = _ThreefryNoise(monkeypatch) if name == "sgld" else None
    for step in gs:
        for i, g in enumerate(step):
            jo.update(i, jw[i], _j(g), js[i])
            js[i] = jo._latest_states[i]
        if noise is not None:
            noise.feed(to)
        for i, g in enumerate(step):
            to.update(i, tw[i], torch.from_numpy(g), ts[i])
        for i in range(2):
            onp.testing.assert_allclose(tw[i].numpy(), _np(jw[i]),
                                        err_msg=f"{name} w{i}", **TOL)
            for a, b in zip(ts[i], js[i]):
                onp.testing.assert_allclose(_np(a), _np(b),
                                            err_msg=f"{name} state", **TOL)
        assert to.num_update == jo.num_update
    assert not onp.allclose(tw[0].numpy(), ws[0])


@pytest.mark.parametrize("name", ["sgd", "adam", "lamb", "nag"])
def test_multi_precision_bf16_matches_jax(name):
    """multi_precision on bfloat16 weights: the state is (float32 master,
    inner state) in both; after three updates the masters agree within
    TOL, each port weight is its master rounded to bfloat16 bitwise, and
    the weights agree within one bfloat16 step (2^-7 relative)."""
    opts = dict(multi_precision=True, wd=0.01, rescale_grad=0.5,
                momentum=0.9) if name in ("sgd", "nag") else dict(
        multi_precision=True, wd=0.01, rescale_grad=0.5)
    jo = jmx.optimizer.create(name, **opts)
    to = tmx.optimizer.create(name, **opts)
    ws, gs = _param_data(12)
    jw = [jmx.np.array(w).astype("bfloat16") for w in ws]
    tw = [torch.from_numpy(w).bfloat16() for w in ws]
    js = {i: jo.create_state_multi_precision(i, w) for i, w in enumerate(jw)}
    ts = {i: to.create_state_multi_precision(i, w) for i, w in enumerate(tw)}
    assert all(s[0].dtype == torch.float32 and isinstance(s[1], tuple)
               for s in ts.values())
    for step in gs:
        for i, g in enumerate(step):
            jo.update(i, jw[i], jmx.np.array(g).astype("bfloat16"), js[i])
            js[i] = jo._latest_states[i]
            to.update_multi_precision(i, tw[i],
                                      torch.from_numpy(g).bfloat16(), ts[i])
    for i in range(2):
        assert tw[i].dtype == torch.bfloat16
        onp.testing.assert_allclose(ts[i][0].numpy(), _np(js[i][0]), **TOL)
        assert torch.equal(tw[i], ts[i][0].bfloat16())
        onp.testing.assert_allclose(_np(tw[i]), _np(jw[i]), rtol=2.0 ** -7,
                                    atol=1e-6)


def test_optimizer_registry_aliases_and_errors():
    """The port registers the reference's 17 names and keeps its module
    aliases; GroupAdaGrad refuses weight decay and 1-D weights; unknown
    keyword arguments are kept, as the reference keeps them."""
    from mxnet_tpu.base import registry
    from mxnet_tpu_torch.optimizer import optimizer as topt
    import mxnet_tpu.optimizer.optimizer as jopt

    assert sorted(topt._registry) == sorted(registry.entries("optimizer"))
    for alias in ("sgd", "signsgd", "adagrad", "lamb", "group_adagrad"):
        assert getattr(topt, alias).__name__ == \
            getattr(jopt, alias).__name__
    with pytest.raises(MXNetError):
        tmx.optimizer.create("groupadagrad", wd=0.1)
    with pytest.raises(MXNetError):
        tmx.optimizer.create("groupadagrad").create_state(0, torch.ones(3))
    opt = tmx.optimizer.create("adam", momentum=0.9, correct_bias=False)
    assert opt._kwargs == {"momentum": 0.9} and not opt.correct_bias
    os.environ["MXNET_OPTIMIZER_AGGREGATION_SIZE"] = "7"
    try:
        assert tmx.optimizer.create("sgd").aggregate_num == \
            jmx.optimizer.create("sgd").aggregate_num == 7
    finally:
        del os.environ["MXNET_OPTIMIZER_AGGREGATION_SIZE"]


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
def _dense_pair(seed):
    """A Dense(3, in_units=4) in each package with the same seeded
    weights, and the data."""
    rng = onp.random.RandomState(seed)
    w0 = rng.randn(3, 4).astype(onp.float32)
    b0 = rng.randn(3).astype(onp.float32)
    xs = [rng.randn(6, 4).astype(onp.float32) for _ in range(4)]
    jnet = jmx.gluon.nn.Dense(3, in_units=4)
    jnet.initialize()
    jp = jnet.collect_params()
    jp["weight"].set_data(_j(w0))
    jp["bias"].set_data(_j(b0))
    tnet = tmx.gluon.nn.Dense(3, in_units=4)
    tnet.initialize(device="cpu")
    from_jax_params({"weight": w0, "bias": b0}, tnet)
    return jnet, tnet, xs


def _backward(jnet, tnet, x):
    with jautograd.record():
        jl = (jnet(_j(x)) ** 2).sum()
    jl.backward()
    with autograd.record():
        tl = (tnet(torch.from_numpy(x)) ** 2).sum()
    autograd.backward(tl)


def _assert_same_weights(jnet, tnet, what):
    got = to_jax_params(tnet)
    for n, p in jnet.collect_params().items():
        onp.testing.assert_allclose(got[n], p.data().asnumpy(),
                                    err_msg=f"{what}: {n}", **TOL)


@pytest.mark.parametrize("opt,kw", [
    ("nag", {"momentum": 0.9}),
    ("lamb", {}),
    ("nadam", {}),
])
def test_trainer_with_scheduler_matches_jax(opt, kw, tmp_path):
    """Dense(3) trained 3 steps with a warmup-then-factor scheduler in both
    packages, the multipliers of a list of Parameters set after step 1
    (both ignore them in the fused step, NAG and LAMB; both follow them in
    Nadam's per-parameter one), weights within TOL after each step; then
    a .states file of each package loads into a fresh Trainer of the
    other and the next step agrees, and reset_states forgets the
    counts."""
    jnet, tnet, xs = _dense_pair(31)

    def sched(mod):
        return mod.lr_scheduler.FactorScheduler(
            step=2, factor=0.5, base_lr=0.2, warmup_steps=2,
            warmup_begin_lr=0.05)

    params = dict(kw, learning_rate=0.1, wd=1e-3)
    jtr = jmx.gluon.Trainer(list(jnet.collect_params().values()), opt,
                            dict(params, lr_scheduler=sched(jmx)))
    ttr = tmx.gluon.Trainer(list(tnet.collect_params().values()), opt,
                            dict(params, lr_scheduler=sched(tmx)))
    for k, x in enumerate(xs[:3]):
        _backward(jnet, tnet, x)
        jtr.step(6)
        ttr.step(6)
        assert ttr.learning_rate == jtr.learning_rate
        _assert_same_weights(jnet, tnet, f"step {k}")
        if k == 0:
            w_step1 = to_jax_params(tnet)["weight"]
            for tr in (jtr, ttr):
                tr.optimizer.set_lr_mult({"weight": 0.0})
                tr.optimizer.set_wd_mult({"bias": 3.0})
    w_before = to_jax_params(tnet)["weight"]
    # the fused step keeps the multipliers of its first step; Nadam's
    # per-parameter updates take the new ones
    assert onp.array_equal(w_before, w_step1) == (opt == "nadam")
    assert ttr.optimizer._index_update_count == {0: 3, 1: 3}

    # .states across the packages: each loads the other's file
    jfile, tfile = str(tmp_path / "j.states"), str(tmp_path / "t.states")
    jtr.save_states(jfile)
    ttr.save_states(tfile)
    jtr2 = jmx.gluon.Trainer(jnet.collect_params(), opt,
                             dict(params, lr_scheduler=sched(jmx)))
    ttr2 = tmx.gluon.Trainer(tnet.collect_params(), opt,
                             dict(params, lr_scheduler=sched(tmx)))
    jtr2.load_states(tfile)
    ttr2.load_states(jfile)
    tree = ttr2.states_tree()
    assert tree["num_update"] == 3 and tree["index_update_count"] == \
        {"0": 3, "1": 3}
    jtree = jtr.states_tree()
    for i in tree["states"]:
        for a, b in zip(jax.tree_util.tree_leaves(tree["states"][i]),
                        jax.tree_util.tree_leaves(jtree["states"][i])):
            onp.testing.assert_allclose(a, onp.asarray(b), **TOL)
    _backward(jnet, tnet, xs[3])
    jtr2.step(6)
    ttr2.step(6)
    _assert_same_weights(jnet, tnet, "after loading the other's states")
    # fresh optimizers: no multiplier, the weight moves again
    assert not onp.allclose(to_jax_params(tnet)["weight"], w_before)
    ttr2.reset_states()
    assert ttr2.optimizer.num_update == 0 and not ttr2.states_tree()[
        "states"]


def test_trainer_warmup_from_zero_trains():
    """A linear warmup from 0: the port fixes each multiplier itself at
    the first step (1 here), so the second step moves the weights by
    the warmup's rate. (The reference divides the first step's rate by
    itself, 0 / 1e-30, and its fused step never updates.)"""
    _, tnet, xs = _dense_pair(32)
    sched = tmx.lr_scheduler.FactorScheduler(step=10, base_lr=0.1,
                                             warmup_steps=4)
    tr = tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                           {"learning_rate": 0.1, "lr_scheduler": sched})
    w0 = to_jax_params(tnet)["weight"]
    for x in xs[:2]:
        with autograd.record():
            tl = (tnet(torch.from_numpy(x)) ** 2).sum()
        autograd.backward(tl)
        tr.step(6)
    assert tr.learning_rate == 0.1 * 2 / 4
    assert not onp.allclose(to_jax_params(tnet)["weight"], w0)


def test_trainer_kvstore_and_list_params():
    """kvstore device/local/None/none/null run on one card (allreduce is
    the identity); a distributed store or compression raises; list and
    tuple params take the Parameters' names."""
    _, tnet, _ = _dense_pair(33)
    plist = list(tnet.collect_params().values())
    for kv in ("device", "local", None, "none", "null"):
        tr = tmx.gluon.Trainer(plist, "sgd", kvstore=kv,
                               update_on_kvstore=False)
        tr.allreduce_grads()
    assert tr.optimizer.idx2name == {0: "weight", 1: "bias"}
    for kv, comp in (("dist_sync", None), ("dist_tpu_sync", None),
                     ("device", {"type": "2bit"})):
        with pytest.raises(MXNetError, match="item 8"):
            tmx.gluon.Trainer(tuple(plist), "sgd", kvstore=kv,
                              compression_params=comp)
    with pytest.raises(MXNetError):
        tmx.gluon.Trainer([torch.nn.Parameter(torch.ones(2))], "sgd")


def test_trainer_multi_precision_bf16_matches_jax():
    """A bfloat16 Dense trained 2 steps by SGD(multi_precision=True) in
    both Trainers: the port's masters stay the same tensors, updated in
    place; each weight is its master rounded to bfloat16 bitwise, and
    the states trees' masters agree within 1e-2 relative (the packages'
    bfloat16 forwards and backwards round their sums in another order, so
    the gradients differ by bfloat16 steps)."""
    jnet, tnet, xs = _dense_pair(34)
    jnet.cast("bfloat16")
    tnet.cast("bfloat16")
    params = {"learning_rate": 0.1, "momentum": 0.9,
              "multi_precision": True}
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd", params)
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd", params)
    masters = None
    for x in xs[:2]:
        with jautograd.record():
            jl = (jnet(_j(x).astype("bfloat16")) ** 2).sum()
        jl.backward()
        with autograd.record():
            tl = (tnet(torch.from_numpy(x).bfloat16()) ** 2).sum()
        autograd.backward(tl)
        jtr.step(6)
        ttr.step(6)
        # the masters are updated in place, never rebuilt
        assert masters is None or all(
            ttr._states[i][0] is m for i, m in enumerate(masters))
        masters = [ttr._states[i][0] for i in range(2)]
    jt, tt = jtr.states_tree()["states"], ttr.states_tree()["states"]
    for i, p in enumerate(tnet.collect_params().values()):
        master, inner = ttr._states[i]
        assert master.dtype == torch.float32 and isinstance(inner, tuple)
        assert torch.equal(p.data().detach(), master.bfloat16())
        onp.testing.assert_allclose(tt[str(i)][0], onp.asarray(
            jt[str(i)][0], onp.float32), rtol=1e-2, atol=1e-3)


def test_updater_blobs_cross_load():
    """Updater.get_states of each package loads into the other's Updater
    (plain SGD momentum states, and multi-precision (master, inner)
    pairs of bfloat16 weights), and the next update agrees within TOL."""
    rng = onp.random.RandomState(41)
    w = rng.randn(4, 3).astype(onp.float32)
    g1, g2 = (rng.randn(4, 3).astype(onp.float32) for _ in range(2))
    for mp in (False, True):
        kw = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": mp}
        dt = "bfloat16" if mp else "float32"
        tdt = torch.bfloat16 if mp else torch.float32

        def jarr(a):
            return jmx.np.array(a).astype(dt)

        def tarr(a):
            return torch.from_numpy(a.copy()).to(tdt)

        ju = jmx.optimizer.get_updater(jmx.optimizer.create("sgd", **kw))
        tu = tmx.optimizer.get_updater(tmx.optimizer.create("sgd", **kw))
        jw, tw = jarr(w), tarr(w)
        ju(0, jarr(g1), jw)
        tu(0, tarr(g1), tw)
        # each blob into the other package's fresh updater
        ju2 = jmx.optimizer.get_updater(jmx.optimizer.create("sgd", **kw))
        tu2 = tmx.optimizer.get_updater(tmx.optimizer.create("sgd", **kw))
        ju2.set_states(tu.get_states())
        tu2.set_states(ju.get_states())
        jw2, tw2 = jarr(_np(tw)), tarr(_np(jw))
        ju2(0, jarr(g2), jw2)
        tu2(0, tarr(g2), tw2)
        ju(0, jarr(g2), jw)
        tu(0, tarr(g2), tw)
        tol = dict(rtol=2.0 ** -7, atol=1e-6) if mp else TOL
        for got in (_np(jw2), _np(tw2), _np(tw)):
            onp.testing.assert_allclose(got, _np(jw), **tol)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _loss_cases():
    rng = onp.random.RandomState(51)
    f = onp.float32
    pred = rng.randn(4, 5).astype(f)
    reg = rng.randn(4, 5).astype(f)
    sign = onp.where(rng.rand(4, 5) > 0.5, 1, -1).astype(f)
    binary = (rng.rand(4, 5) > 0.5).astype(f)
    prob = rng.uniform(0.05, 0.95, (4, 5)).astype(f)
    dist = onp.abs(rng.randn(4, 5)).astype(f)
    dist /= dist.sum(-1, keepdims=True)
    sw = rng.rand(4, 1).astype(f)
    cls = rng.randint(0, 5, (4,)).astype(f)
    counts = rng.randint(0, 5, (4, 5)).astype(f)
    ctc = rng.randn(3, 7, 5).astype(f)
    ctc_lab = onp.array([[1, 2, 2], [3, 1, 0], [4, 4, 4]], onp.int32)
    ctc_len = onp.array([3, 2, 3], onp.int32)
    ctc_in = onp.array([7, 6, 7], onp.int32)
    lab_pm = onp.array([1, -1, 1, -1], f)
    return [
        ("L2Loss", {}, (pred, reg), {"sample_weight": sw}),
        ("L1Loss", {"weight": 0.5}, (pred, reg), {}),
        ("HuberLoss", {"rho": 0.7}, (pred, reg), {"sample_weight": sw}),
        ("HingeLoss", {"margin": 1.5}, (pred, sign), {}),
        ("SquaredHingeLoss", {}, (pred, sign), {}),
        ("LogisticLoss", {}, (pred, sign), {}),
        ("LogisticLoss", {"label_format": "binary"}, (pred, binary), {}),
        ("SigmoidBinaryCrossEntropyLoss", {}, (pred, binary), {}),
        ("SigmoidBCELoss", {}, (pred, binary),
         {"pos_weight": onp.full((5,), 2.0, f)}),
        ("SigmoidBCELoss", {"from_sigmoid": True}, (prob, binary), {}),
        ("SigmoidBCELoss", {"from_sigmoid": True}, (prob, binary),
         {"pos_weight": onp.full((5,), 3.0, f)}),
        ("SoftmaxCrossEntropyLoss", {}, (pred, cls), {}),
        ("SoftmaxCELoss", {"sparse_label": False}, (pred, dist), {}),
        ("SoftmaxCELoss", {"from_logits": True}, (pred, cls),
         {"sample_weight": sw[:, 0]}),
        ("KLDivLoss", {}, (pred, dist), {}),
        ("KLDivLoss", {"from_logits": False}, (pred, dist), {}),
        ("CTCLoss", {}, (ctc, ctc_lab), {}),
        ("CTCLoss", {}, (ctc, ctc_lab, ctc_in, ctc_len), {}),
        ("CTCLoss", {"layout": "TNC"}, (ctc.transpose(1, 0, 2).copy(),
                                        ctc_lab, None, ctc_len), {}),
        ("TripletLoss", {"margin": 2.0}, (pred, reg, prob), {}),
        ("PoissonNLLLoss", {}, (pred, counts), {}),
        ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
         (prob + 0.5, counts), {}),
        ("CosineEmbeddingLoss", {"margin": 0.2}, (pred, reg, lab_pm), {}),
        ("SDMLLoss", {"smoothing_parameter": 0.2}, (pred, reg), {}),
    ]


LOSS_CASES = _loss_cases()


@pytest.mark.parametrize("case", range(len(LOSS_CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(LOSS_CASES)])
def test_loss_value_and_gradient_match_jax(case):
    """Each loss of the reference's loss.py (aliases included) on seeded
    inputs: the value and the gradient of its sum with respect to the
    first input within 1e-5, the same shape and dtype."""
    name, kw, args, extra = LOSS_CASES[case]
    jl = getattr(jmx.gluon.loss, name)(**kw)
    tl = getattr(tmx.gluon.loss, name)(**kw)
    jx, tx = _j(args[0]), torch.from_numpy(args[0].copy())
    jx.attach_grad()
    tx.requires_grad_(True)
    jrest = [None if a is None else _j(a) for a in args[1:]]
    trest = [None if a is None else torch.from_numpy(a) for a in args[1:]]
    jextra = {k: _j(v) for k, v in extra.items()}
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    with jautograd.record():
        jout = jl(jx, *jrest, **jextra)
    jout.backward()
    tout = tl(tx, *trest, **textra)
    tout.sum().backward()
    assert tuple(tout.shape) == jout.shape
    assert str(tout.dtype).replace("torch.", "") == str(jout.dtype)
    onp.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), rtol=1e-5,
                                atol=1e-5)


def test_loss_names_are_the_references():
    """Every public name of the reference's loss module is in the port's,
    and the aliases point at the same classes."""
    for n in jmx.gluon.loss.__all__ + ["SDMLLoss"]:
        assert hasattr(tmx.gluon.loss, n), n
    assert tmx.gluon.loss.SoftmaxCELoss is \
        tmx.gluon.loss.SoftmaxCrossEntropyLoss
    assert tmx.gluon.loss.SigmoidBCELoss is \
        tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _metric_batches():
    rng = onp.random.RandomState(61)
    f = onp.float32
    out = []
    for _ in range(2):
        logits = rng.randn(8, 4).astype(f)
        probs = onp.exp(logits) / onp.exp(logits).sum(-1, keepdims=True)
        out.append(dict(
            cls=rng.randint(0, 4, (8,)).astype(f), logits=logits,
            probs=probs.astype(f), bin=rng.randint(0, 2, (8,)).astype(f),
            bin2=rng.randn(8, 2).astype(f), p1=rng.rand(8).astype(f),
            reg=rng.randn(8, 3).astype(f), reg2=rng.randn(8, 3).astype(f),
            loss=rng.rand(8).astype(f),
            cls5=rng.randint(0, 6, (8,)).astype(f),
            logits6=rng.randn(8, 6).astype(f)))
    return out


METRICS = [
    ("acc", {}, "cls", "logits"), ("Accuracy", {"axis": 1}, "cls", "probs"),
    ("TopKAccuracy", {"top_k": 2}, "cls", "logits"),
    ("F1", {}, "bin", "bin2"), ("F1", {}, "bin", "p1"),
    ("Fbeta", {"beta": 2.0}, "bin", "bin2"), ("MCC", {}, "bin", "bin2"),
    ("MAE", {}, "reg", "reg2"), ("MSE", {}, "reg", "reg2"),
    ("RMSE", {}, "reg", "reg2"), ("CrossEntropy", {}, "cls", "probs"),
    ("NegativeLogLikelihood", {}, "cls", "probs"),
    ("Perplexity", {"ignore_label": None}, "cls", "probs"),
    ("PearsonCorrelation", {}, "reg", "reg2"),
    ("PCC", {}, "cls5", "logits6"), ("PCC", {}, "bin", "p1"),
    ("Loss", {}, "cls", "loss"), ("BinaryAccuracy", {}, "bin", "p1"),
    ("MeanCosineSimilarity", {}, "reg", "reg2"),
    ("MeanPairwiseDistance", {"p": 3}, "reg", "reg2"),
]


@pytest.mark.parametrize("name,kw,lab,pred", METRICS,
                         ids=[f"{m[0]}-{i}" for i, m in enumerate(METRICS)])
def test_metric_matches_jax(name, kw, lab, pred):
    """Each metric (created by name, as create() resolves it) updated
    with two seeded batches, as lists, in both packages: get() gives the
    same name and a value within 1e-6."""
    jm = jmx.gluon.metric.create(name, **kw)
    tm = tmx.gluon.metric.create(name, **kw)
    for b in _metric_batches():
        jm.update([_j(b[lab])], [_j(b[pred])])
        tm.update([torch.from_numpy(b[lab])], [torch.from_numpy(b[pred])])
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn
    onp.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-7)


def test_metric_composite_custom_aliases_and_numpy_inputs():
    """A composite from a list (a custom function among its members) of
    numpy inputs, get_name_value and reset; the aliases; every name of
    the reference's metric module is in the port's."""
    b = _metric_batches()[0]

    def feval(label, pred):
        return float(onp.abs(label - pred.argmax(-1)).mean())

    jm = jmx.gluon.metric.create(["acc", "topkaccuracy", feval])
    tm = tmx.gluon.metric.create(["acc", "topkaccuracy", feval])
    jm.update([b["cls"]], [b["logits"]])
    tm.update([b["cls"]], [b["logits"]])
    assert [n for n, _ in tm.get_name_value()] == \
        [n for n, _ in jm.get_name_value()]
    onp.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-6)
    tm.reset()
    assert all(onp.isnan(v) for v in tm.get()[1])
    for n in jmx.gluon.metric.__all__ + ["BinaryAccuracy", "Fbeta", "PCC",
                                         "MeanCosineSimilarity",
                                         "MeanPairwiseDistance", "Torch",
                                         "Caffe"]:
        assert hasattr(tmx.gluon.metric, n), n
    assert tmx.gluon.metric.Torch is tmx.gluon.metric.Caffe is \
        tmx.gluon.metric.Loss
    assert isinstance(tmx.gluon.metric.create("acc"),
                      tmx.gluon.metric.Accuracy)
    with pytest.raises(MXNetError):
        tmx.gluon.metric.create("no_such_metric")
