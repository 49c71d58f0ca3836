"""The rest of the model zoo in the PyTorch port against the JAX package,
on the CPU: BERT (``BERTModel``, ``BERTForPretraining``, one SGD step),
the vision families other than ResNet (AlexNet, DenseNet, Inception V3,
MobileNet V1 and V2, SqueezeNet, VGG) and the registry, the port's
numpy threefry against ``jax.random``, and the model store's
``pretrained=True`` (the manifest's hashes, the golden logits, the
cache's repair and user-file rules, and a file the reference accepts).

Inputs and weights are seeded numpy arrays handed to both packages; the
port runs on ``device="cpu"``. The JAX nets are built once per module,
their weights set from numpy (their own initializers compile a draw per
shape), and run as one jit: hybridized BERTModel, and the
``functionalize`` fn of the others. ``tests/conftest.py``
pins JAX's f32 matmuls to "highest". Tolerances are a share of the
largest magnitude of the reference's value, stated at each check.
"""
import os
import shutil
import warnings
from contextlib import contextmanager

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import engine as jengine
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JLoss
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo import model_store as jstore
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ndarray.ndarray import _wrap
from mxnet_tpu.ops.nn import no_pallas
from mxnet_tpu_torch import _threefry, autograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import model_store as tstore
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.ops.nn import generator

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@contextmanager
def _untracked():
    """The reference's bookkeeping of pending eager errors
    (``engine._track``) asks each traced value for ``block_until_ready``,
    and JAX builds a tracer's error message for every ask: about half of
    a hybridized net's trace. Off while the JAX nets here run; it records
    no value and changes no arithmetic."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "_track", lambda val: None)
        yield


def _close(got, want, tol, what=""):
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else onp.asarray(got, onp.float32))
    want = onp.asarray(want, onp.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(onp.abs(want).max()), 1e-30)
    err = float(onp.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------
BERT_CFG = dict(vocab_size=1000, units=64, hidden_size=128, num_layers=2,
                num_heads=4, max_length=64, dropout=0.0)
B, L = 2, 16
# f32 sums of up to 128 products in another order through two post-norm
# layers, the pooler's tanh and the tied decoder: a few f32 ulps of the
# largest magnitude (about 2e-7 measured); 2e-5 leaves a wide margin
BERT_TOL = 2e-5


def _bert_weights(jnet, seed):
    """Seeded numpy weights for every parameter of the JAX net, set into
    it; LayerNorm gains near 1."""
    rng = onp.random.RandomState(seed)
    params = {}
    for name, p in jnet.collect_params().items():
        v = (1.0 + 0.1 * rng.randn(*p.shape) if name.endswith(".gamma")
             else 0.2 * rng.randn(*p.shape))
        params[name] = v.astype(onp.float32)
        p.set_data(params[name])
    return params


@pytest.fixture(scope="module")
def berts():
    """The JAX BERTForPretraining (hybridized) and the port's, on the same
    seeded weights."""
    jnet = jbert.BERTForPretraining(jbert.bert_base(**BERT_CFG),
                                    vocab_size=BERT_CFG["vocab_size"])
    params = _bert_weights(jnet, 0)
    jnet.hybridize()
    tnet = tbert.BERTForPretraining(tbert.bert_base(**BERT_CFG),
                                    vocab_size=BERT_CFG["vocab_size"])
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    tnet.initialize(device="cpu")
    from_jax_params(params, tnet)
    return jnet, tnet, params


def _bert_inputs(seed=1):
    rng = onp.random.RandomState(seed)
    tokens = rng.randint(0, BERT_CFG["vocab_size"], (B, L)).astype(onp.int32)
    types = rng.randint(0, 2, (B, L)).astype(onp.int32)
    valid = onp.array([L, 9], onp.int32)
    return tokens, types, valid


@pytest.mark.parametrize("types,valid", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_bert_model_matches_jax(berts, types, valid):
    """BERTModel's sequence and pooled outputs, with and without
    token_types and valid_length (the masked path, keys past the length
    dropped), within BERT_TOL."""
    jnet, tnet = berts[0].bert, berts[1].bert
    tokens, tt, vl = _bert_inputs()
    jargs = [jmx.np.array(tokens), jmx.np.array(tt) if types else None,
             jmx.np.array(vl) if valid else None]
    targs = [torch.from_numpy(tokens), torch.from_numpy(tt) if types
             else None, torch.from_numpy(vl) if valid else None]
    with no_pallas(), _untracked():
        jseq, jpooled = jnet(*jargs)
    with torch.no_grad():
        tseq, tpooled = tnet(*targs)
    _close(tseq, jseq.asnumpy(), BERT_TOL, "seq")
    _close(tpooled, jpooled.asnumpy(), BERT_TOL, "pooled")


def test_bert_pretraining_logits_match_jax(berts):
    """BERTForPretraining's MLM logits (B, L, vocab) and NSP logits (B, 2)
    with token types, within BERT_TOL."""
    jnet, tnet, _ = berts
    tokens, tt, _ = _bert_inputs(2)
    with no_pallas(), _untracked():
        jmlm, jnsp = jnet(jmx.np.array(tokens), jmx.np.array(tt))
    with torch.no_grad():
        tmlm, tnsp = tnet(torch.from_numpy(tokens), torch.from_numpy(tt))
    assert tuple(tmlm.shape) == (B, L, BERT_CFG["vocab_size"])
    _close(tmlm, jmlm.asnumpy(), BERT_TOL, "mlm logits")
    _close(tnsp, jnsp.asnumpy(), BERT_TOL, "nsp logits")


def test_bert_sgd_step_matches_jax(berts):
    """One pretraining step: MLM loss over every position (labels the
    tokens) plus NSP loss, both SoftmaxCrossEntropyLoss. The per-row loss
    and every parameter's gradient by name (the tied embedding's sums
    its two uses) within BERT_TOL of the JAX package's (its forward and
    loss under ``jax.value_and_grad``, one jit); then the port's
    Trainer("sgd", momentum 0.9, lr 0.05) moves each weight to
    w - lr * g / B from the JAX gradient, within 1e-6 of the largest
    weight."""
    jnet, tnet, params = berts
    tokens, tt, vl = _bert_inputs(3)
    nsp = onp.array([0, 1], onp.int32)
    with no_pallas(), _untracked():
        fn, _ = jnet.functionalize(jmx.np.array(tokens))

        def loss_of(p):
            (mlm, nsp_logits), _ = fn(p, tokens, tt, vl)
            rows = (JLoss()(_wrap(mlm), _wrap(jnp.asarray(tokens)))
                    + JLoss()(_wrap(nsp_logits), _wrap(jnp.asarray(nsp))))
            return rows._data.sum(), rows._data

        (_, jl), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
            {n: jnp.asarray(v) for n, v in params.items()})
    trainer = Trainer(tnet.collect_params(), "sgd",
                      {"learning_rate": 0.05, "momentum": 0.9})
    with autograd.record():
        tmlm, tnsp = tnet(torch.from_numpy(tokens), torch.from_numpy(tt),
                          torch.from_numpy(vl))
        tl = (SoftmaxCrossEntropyLoss()(tmlm, torch.from_numpy(tokens))
              + SoftmaxCrossEntropyLoss()(tnsp, torch.from_numpy(nsp)))
    autograd.backward(tl)
    _close(tl, jl, BERT_TOL, "loss")
    tparams = tnet.collect_params()
    assert sorted(jgrads) == sorted(tparams)
    for name, g in jgrads.items():
        _close(tparams[name].grad(), g, BERT_TOL, name)
    trainer.step(B)
    for name, p in tparams.items():
        want = params[name] - 0.05 * onp.asarray(jgrads[name]) / B
        _close(p.data(), want, 1e-6, f"{name} after the step")
    from_jax_params(params, tnet)           # the fixture's weights again


def test_bert_tp_axis_raises():
    """Tensor parallelism is not ported: ``tp_axis`` raises, naming the
    roadmap item."""
    with pytest.raises(MXNetError, match="item 8"):
        tbert.bert_base(tp_axis="model")


# ---------------------------------------------------------------------------
# the vision families other than ResNet
# ---------------------------------------------------------------------------
# each family at its smallest admitted input (DenseNet's 7x7 and
# Inception's 8x8 final pools fix theirs)
FAMILIES = {"mobilenet0.25": 64, "mobilenetv2_0.25": 64,
            "squeezenet1.0": 64, "squeezenet1.1": 64, "alexnet": 64,
            "vgg11": 32, "vgg11_bn": 32, "densenet121": 224,
            "inceptionv3": 299}
WITH_BN = ("mobilenet0.25", "mobilenetv2_0.25", "vgg11_bn", "densenet121",
           "inceptionv3")
# In training mode the MobileNets run at 224, their goldens' size: at 64
# their last BatchNorms normalize 4 values a channel at batch 1, which
# amplifies float32 rounding to 4e-5 to 3e-4 of the logits (4 weight
# draws measured; 2e-6 at 224)
TRAIN_SIZE = {"mobilenet0.25": 224, "mobilenetv2_0.25": 224}
# f32 convolutions summed in another order than XLA's through up to 121
# layers: 3e-7 to 5e-6 of the largest logit in predict mode, up to 4e-5
# in training mode (Inception's last BatchNorms see 64 values a channel)
VISION_TOL = 1e-4


def _vision_weights(tnet, rng):
    """Seeded weights in the shapes of the port's net: convolutions and
    Dense layers at He scale (activations keep their size through 121
    layers), BatchNorm near identity."""
    params = {}
    for name, p in tnet.collect_params().items():
        shape = tuple(p.shape)
        if name.endswith("weight"):
            v = rng.standard_normal(shape, dtype=onp.float32) * onp.float32(
                onp.sqrt(2.0 / onp.prod(shape[1:])))
        elif name.endswith(("gamma", "running_var")):
            v = 1.0 + 0.1 * rng.random(shape, dtype=onp.float32)
        else:
            v = 0.1 * rng.standard_normal(shape, dtype=onp.float32)
        params[name] = v.astype(onp.float32)
    return params


_vision_cache = {}


def _vision(name):
    """(JAX net, its weights, port net, input) for a family, on one set
    of seeded weights; dropout rates are 0 in both, so a training-mode
    forward differs from predict mode only by BatchNorm's batch
    statistics."""
    if name not in _vision_cache:
        size = FAMILIES[name]
        x = onp.random.RandomState(5).uniform(
            -1, 1, (1, 3, size, size)).astype(onp.float32)
        tnet = tvision.get_model(name, classes=10)
        tnet.initialize(init="zeros", device="cpu")
        with torch.no_grad():
            tnet(torch.from_numpy(x))           # completes the shapes
        params = _vision_weights(tnet, onp.random.default_rng(6))
        from_jax_params(params, tnet)
        jnet = jvision.get_model(name, classes=10)
        assert list(tnet.collect_params()) == list(jnet.collect_params())
        for pname, p in jnet.collect_params().items():
            p.grad_req = "null"                 # no gradient buffers
            p.set_data(params[pname])
        for net in (jnet, tnet):
            for blk in _blocks(net):
                if type(blk).__name__ == "Dropout":
                    blk._rate = 0.0
        _vision_cache[name] = (jnet, params, tnet, x)
    return _vision_cache[name]


def _blocks(net):
    """Every block under ``net`` (either package's)."""
    kids = (net._children.values() if hasattr(net, "_children")
            else net.children())
    yield net
    for k in kids:
        yield from _blocks(k)


@pytest.mark.parametrize("mode,name", [("predict", n) for n in FAMILIES]
                         + [("train", n) for n in WITH_BN])
def test_vision_family_logits_match_jax(mode, name):
    """Each family's logits at batch 1, classes 10, in predict mode and
    (the nets with BatchNorm) in training mode, where BatchNorm takes the
    batch's statistics (the MobileNets at TRAIN_SIZE), within
    VISION_TOL. The JAX net runs its
    ``functionalize`` fn in that mode under one jit."""
    jnet, params, tnet, x = _vision(name)
    if mode == "train" and name in TRAIN_SIZE:
        x = onp.random.RandomState(5).uniform(
            -1, 1, (1, 3, TRAIN_SIZE[name], TRAIN_SIZE[name])
        ).astype(onp.float32)
    with _untracked():
        fn, _ = jnet.functionalize(jmx.np.array(x),
                                   training=mode == "train")
        want = onp.asarray(jax.jit(lambda p, x: fn(p, x)[0])(params, x))
    with (autograd.train_mode() if mode == "train"
          else autograd.predict_mode()), torch.no_grad():
        got = tnet(torch.from_numpy(x))
    assert tuple(got.shape) == (1, 10)
    _close(got, want, VISION_TOL, f"{name} {mode}")


# the port's forward completes the deferred shapes of these, at this size
# (ResNet's shapes are held by tests/test_torch_vision.py)
FORWARD_AT = {"vgg": 32, "mobilenet": 32, "squeezenet": 64, "alexnet": 64}


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_registry_builds_every_reference_name(name):
    """Every name the reference registers builds in the port, with the
    reference's collect_params() names in order; for the nets cheap to
    run, the port's shapes after a forward agree with every axis the
    reference knows before its own (a deferred axis, 0 there, is any
    width)."""
    jnet, tnet = jvision.get_model(name), tvision.get_model(name)
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    size = next((s for k, s in FORWARD_AT.items() if name.startswith(k)),
                None)
    if size is not None:
        tnet.initialize(init="zeros", device="cpu")
        with torch.no_grad():
            assert tnet(torch.zeros(1, 3, size, size)).shape == (1, 1000)
    got = {n: tuple(p.shape) for n, p in tnet.collect_params().items()}
    for n, p in jnet.collect_params().items():
        want = tuple(p.shape)
        assert len(got[n]) == len(want), n
        assert all(w in (0, g) for g, w in zip(got[n], want)), (n, got[n],
                                                                 want)


# ---------------------------------------------------------------------------
# threefry and the model store
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1801, 2010])
@pytest.mark.parametrize("shape", [(0,), (), (1,), (7,), (3, 5, 7),
                                   (1 << 20,)])
def test_threefry_matches_jax_random(seed, shape):
    """PRNGKey, split and uniform(float32, -0.07, 0.07) of the port's
    numpy threefry bitwise equal jax.random's (the JAX package's
    Uniform(0.07) draw), at the reference's key after one split."""
    key = _threefry.prng_key(seed)
    jkey = jax.random.PRNGKey(seed)
    onp.testing.assert_array_equal(key, onp.asarray(jkey))
    keys, jkeys = _threefry.split(key), jax.random.split(jkey)
    onp.testing.assert_array_equal(keys, onp.asarray(jkeys))
    got = _threefry.uniform(keys[1], shape, "float32", -0.07, 0.07)
    want = onp.asarray(jax.random.uniform(jkeys[1], shape, jnp.float32,
                                          -0.07, 0.07))
    assert got.shape == want.shape and got.dtype == want.dtype
    onp.testing.assert_array_equal(got.view(onp.uint32),
                                   want.view(onp.uint32))


STORE = ("resnet18_v1", "mobilenetv2_1.0")


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """A cache with both of the store's models, generated by the port."""
    root = str(tmp_path_factory.mktemp("models"))
    for name in STORE:
        tstore.get_model_file(name, root=root)
    return root


@pytest.mark.parametrize("name", STORE)
def test_store_generates_the_manifest_and_the_reference_serves_it(
        store_root, name):
    """The port's generated file hashes to the manifest (the JAX
    package's sha256, bit for bit its threefry draws), and the reference's
    own check accepts it: its get_model_file returns the port's file as
    it is, so the two packages share one cache."""
    path = os.path.join(store_root, f"{name}.params")
    assert tstore._file_sha256(path) == tstore._MODEL_SHA256[name]
    assert tstore._MODEL_SHA256 == jstore._MODEL_SHA256
    assert jstore._file_sha256(path) == jstore._MODEL_SHA256[name]
    stamp = os.stat(path).st_mtime_ns
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert jstore.get_model_file(name, root=store_root) == path
    assert os.stat(path).st_mtime_ns == stamp


@pytest.mark.parametrize("name,builder", [
    ("resnet18_v1", tvision.resnet18_v1),
    ("mobilenetv2_1.0", tvision.mobilenet_v2_1_0)])
def test_pretrained_matches_the_golden_logits(store_root, name, builder):
    """pretrained=True loads the store's weights; the logits in training
    mode (BatchNorm on the batch's statistics, as the goldens were taken)
    on the goldens' input match tests/golden at the reference's rtol and
    atol of 2e-4."""
    net = builder(pretrained=True, root=store_root, device="cpu")
    x = onp.random.RandomState(1234).uniform(
        -1, 1, size=(2, 3, 224, 224)).astype(onp.float32)
    with autograd.record():
        logits = net(torch.from_numpy(x)).detach().numpy()
    golden = onp.load(os.path.join(GOLDEN, f"{name}_logits.npz"))
    onp.testing.assert_allclose(logits, golden["logits"], rtol=2e-4,
                                atol=2e-4)


def test_store_regenerates_a_corrupted_file_and_keeps_the_callers_rng(
        tmp_path):
    """An unreadable cached file is regenerated to the manifest, and the
    generation leaves numpy's global state, torch's and the port's CPU
    generator as they were."""
    root = str(tmp_path)
    path = os.path.join(root, "mobilenetv2_1.0.params")
    with open(path, "wb") as f:
        f.write(b"garbage")
    np_state = onp.random.get_state()
    torch_state = torch.get_rng_state()
    gen_state = generator("cpu").get_state()
    assert tstore.get_model_file("mobilenetv2_1.0", root=root) == path
    assert tstore._file_sha256(path) == tstore._MODEL_SHA256[
        "mobilenetv2_1.0"]
    after = onp.random.get_state()
    assert after[0] == np_state[0] and all(
        onp.array_equal(a, b) for a, b in zip(after[1:], np_state[1:]))
    assert torch.equal(torch.get_rng_state(), torch_state)
    assert torch.equal(generator("cpu").get_state(), gen_state)


def test_store_keeps_a_users_file_with_a_warning(store_root, tmp_path):
    """A readable file whose hash differs from the manifest is the
    user's: returned with a warning, its bytes untouched."""
    path = os.path.join(str(tmp_path), "resnet18_v1.params")
    shutil.copy(os.path.join(store_root, "mobilenetv2_1.0.params"), path)
    before = open(path, "rb").read()
    with pytest.warns(UserWarning, match="user-supplied"):
        assert tstore.get_model_file("resnet18_v1",
                                     root=str(tmp_path)) == path
    assert open(path, "rb").read() == before


def test_store_refuses_other_names():
    """Names outside the store raise "no offline pretrained" from
    get_model_file and from the builders' pretrained=True."""
    assert tstore.supported_models() == ["mobilenetv2_1.0", "resnet18_v1"]
    with pytest.raises(MXNetError, match="no offline pretrained"):
        tstore.get_model_file("vgg11")
    with pytest.raises(MXNetError, match="no offline pretrained"):
        tvision.get_model("mobilenet1.0", pretrained=True, device="cpu")
    with pytest.raises(MXNetError, match="no offline pretrained"):
        tvision.vgg11_bn(pretrained=True, device="cpu")
