"""The detection slice against the JAX package, on the CPU, and the
three front-door faults it closes.

- SSD300's layout (Liu et al., ECCV 2016, §2.2-3): six maps of 38, 19,
  10, 5, 3 and 1 cells, sizes 30..315 over 300, 4 or 6 anchors a cell,
  8732 anchors. ``multibox_prior`` gives the reference's anchors;
  ``multibox_target`` (B 2, 8 ground truths an image, hard negatives at
  3:1) the reference's class targets and masks exactly and its offsets
  within 1e-5 of 1 + the largest magnitude; ``multibox_detection``
  (threshold 0.01, NMS 0.45, top 400) the reference's class ids exactly
  and its scores and boxes within 1e-5.
- The example's toy SSD (``example/gluon/ssd.py:160-222``: 32x32 images,
  2 classes) with the same weights in both packages: the loss within
  1e-5, every gradient within 1e-4, one Adam step of the Trainer, and
  the detections after it (class ids exactly).
- ``mx.nd`` serves every ``mx.np`` name; the device scope (``with
  mx.cpu():``) and ``context``'s names; ``gluon.model_zoo.get_model``.
"""
import importlib
import importlib.util
import math
import os
import threading

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EW, GRAD = 1e-5, 1e-4

# SSD300: feature maps, anchor sizes over 300, ratios per map
SSD_MAPS = (38, 19, 10, 5, 3, 1)
SSD_SIZES = (30, 60, 111, 162, 213, 264, 315)
SSD_RATIOS = [(1, 2, 0.5) if i in (0, 4, 5) else (1, 2, 0.5, 3, 1 / 3)
              for i in range(6)]


def ssd300_anchors(prior, zeros, concatenate):
    """The (1, 8732, 4) anchors through a package's multibox_prior."""
    out = []
    for i, cells in enumerate(SSD_MAPS):
        s = (SSD_SIZES[i] / 300,
             math.sqrt(SSD_SIZES[i] * SSD_SIZES[i + 1]) / 300)
        out.append(prior(zeros((1, 1, cells, cells)), sizes=s,
                         ratios=SSD_RATIOS[i]))
    return concatenate(out, axis=1)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def close(got, want, tol, what):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    onp.testing.assert_allclose(
        got, want, rtol=0, atol=tol * (1 + float(onp.abs(want).max())),
        err_msg=what)


def labels(rng, b, n_max, classes, full=False):
    """(b, n_max, 5) rows [cls, l, t, r, b] padded with -1."""
    lab = onp.full((b, n_max, 5), -1.0, onp.float32)
    for i in range(b):
        for j in range(n_max if full else rng.randint(1, n_max + 1)):
            w, h = rng.uniform(0.05, 0.5, 2)
            x, y = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            lab[i, j] = [rng.randint(classes), x, y, x + w, y + h]
    return lab


@pytest.fixture(scope="module")
def ssd300():
    rng = onp.random.RandomState(300)
    # the reference's npx.multibox_prior is ops.contrib's, here jitted
    jc = importlib.import_module("mxnet_tpu.ops.contrib")
    anchors = onp.asarray(jax.jit(lambda: ssd300_anchors(
        jc.multibox_prior, jax.numpy.zeros, jax.numpy.concatenate))())
    lab = labels(rng, 2, 8, 20, full=True)
    lab[1, [2, 5]] = -1.0                    # padding between rows
    cls_pred = rng.randn(2, 21, anchors.shape[1]).astype(onp.float32)
    loc_pred = (rng.randn(2, anchors.shape[1] * 4) * 0.5).astype(onp.float32)
    return anchors, lab, cls_pred, loc_pred


def test_ssd300_anchors_match_jax(ssd300):
    """SSD300's six maps give 8732 anchors, the reference's."""
    anchors = ssd300[0]
    got = ssd300_anchors(tmx.npx.multibox_prior, torch.zeros, torch.cat)
    assert anchors.shape == (1, 8732, 4)
    close(got, anchors, EW, "anchors")


@pytest.mark.parametrize("ratio", [3.0, -1.0])
def test_multibox_target_at_ssd300_layout(ssd300, ratio):
    """multibox_target over 8732 anchors, B 2, 8 ground truths an image:
    class targets and masks exactly the reference's (host numpy loops),
    offsets within 1e-5."""
    anchors, lab, cls_pred, _ = ssd300
    want = jmx.npx.multibox_target(anchors, lab, cls_pred,
                                   negative_mining_ratio=ratio)
    got = tmx.npx.multibox_target(*[torch.from_numpy(a) for a in (
        anchors, lab, cls_pred)], negative_mining_ratio=ratio)
    onp.testing.assert_array_equal(_host(got[2]), _host(want[2]))
    onp.testing.assert_array_equal(_host(got[1]), _host(want[1]))
    close(got[0], want[0], EW, "loc_target")
    assert (_host(got[2]) > 0).sum() >= 16


def test_multibox_detection_at_ssd300_layout(ssd300):
    """multibox_detection over 8732 anchors with phase 16's settings:
    class ids exactly the reference's, scores and boxes within 1e-5."""
    anchors, _, cls_pred, loc_pred = ssd300
    prob = torch.softmax(torch.from_numpy(cls_pred), 1).numpy()
    kw = dict(threshold=0.01, nms_threshold=0.45, nms_topk=400)
    want = _host(jmx.npx.multibox_detection(prob, loc_pred, anchors, **kw))
    got = _host(tmx.npx.multibox_detection(*[torch.from_numpy(a) for a in (
        prob, loc_pred, anchors)], **kw))
    onp.testing.assert_array_equal(got[..., 0], want[..., 0])
    close(got, want, EW, "detections")
    assert 0 < (got[..., 0] >= 0).sum() < 800


# ---------------------------------------------------------------------------
# the example's toy SSD through both packages
# ---------------------------------------------------------------------------
def _example():
    spec = importlib.util.spec_from_file_location(
        "ssd_example", os.path.join(ROOT, "example", "gluon", "ssd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SIZES, RATIOS, CLASSES = (0.35, 0.55), (1.0, 1.6), 2
N_ANCH = len(SIZES) + len(RATIOS) - 1


def toy_ssd(m):
    """The example's backbone and heads (ssd.py:160-172) in package m."""
    nn = m.gluon.nn
    backbone = nn.HybridSequential()
    backbone.add(nn.Conv2D(16, 3, padding=1, activation="relu"),
                 nn.MaxPool2D(2),
                 nn.Conv2D(32, 3, padding=1, activation="relu"),
                 nn.MaxPool2D(2),
                 nn.Conv2D(64, 3, padding=1, activation="relu"))
    return (backbone, nn.Conv2D(N_ANCH * (CLASSES + 1), 3, padding=1),
            nn.Conv2D(N_ANCH * 4, 3, padding=1))


def toy_forward(m, blocks, x):
    """The example's forward (ssd.py:177-186)."""
    backbone, cls_head, box_head = blocks
    feat = backbone(x)
    anchors = m.npx.multibox_prior(feat, sizes=SIZES, ratios=RATIOS)
    b = x.shape[0]
    cls_pred = cls_head(feat).transpose(0, 2, 3, 1).reshape(
        b, -1, CLASSES + 1) if m is jmx else cls_head(feat).permute(
        0, 2, 3, 1).reshape(b, -1, CLASSES + 1)
    bp = box_head(feat)
    box_pred = (bp.transpose(0, 2, 3, 1) if m is jmx
                else bp.permute(0, 2, 3, 1)).reshape(b, -1)
    return anchors.reshape(1, -1, 4), cls_pred, box_pred


def example_loss(m, cls_pred, box_pred, loc_t, loc_m, cls_t, loss_fn):
    """The example's loss (ssd.py:213-218): softmax cross entropy with the
    ignored anchors weighted 0, plus the masked L1 of the offsets."""
    cls_l = loss_fn(cls_pred.reshape(-1, CLASSES + 1), cls_t.reshape(-1))
    w = cls_t.reshape(-1) >= 0
    w = w.astype("float32") if m is jmx else w.float()
    cls_l = (cls_l * w).sum() / m.np.maximum(w.sum(), 1.0)
    loc_l = (m.np.abs((box_pred - loc_t) * loc_m)).sum() / \
        m.np.maximum(loc_m.sum(), 1.0)
    return cls_l + loc_l


class _JaxToy(jmx.gluon.HybridBlock):
    """The reference's three blocks and the example's loss as one block,
    so that its functionalize fn runs under jit (the example's eager
    tape compiles every op: seconds here)."""

    def __init__(self, blocks):
        super().__init__()
        self.backbone, self.cls_head, self.box_head = blocks
        self.loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward(self, x, loc_t, loc_m, cls_t):
        anchors, cls_pred, box_pred = toy_forward(
            jmx, (self.backbone, self.cls_head, self.box_head), x)
        return anchors, cls_pred, box_pred, example_loss(
            jmx, cls_pred, box_pred, loc_t, loc_m, cls_t, self.loss_fn)


def _params(blocks):
    return [(f"{k}.{n}", p) for k, blk in enumerate(blocks)
            for n, p in blk.collect_params().items()]


def test_toy_ssd_matches_jax_through_a_trainer_step():
    """The example's toy SSD, the same weights in both packages: loss
    within 1e-5, every gradient within 1e-4; after one Adam step (lr
    2e-3) every weight within 1e-5 and the held-out detections' class
    ids exactly the reference's (values within 1e-5). The port runs the
    example's loop (record, targets under pause, backward, step); the
    reference the same function as its jitted forward, its host
    multibox_target, its jitted loss gradient and its Trainer step."""
    ex = _example()
    imgs, labs = ex.synth_detection_data(16, 32, seed=0)
    val_imgs, _ = ex.synth_detection_data(16, 32, seed=1)
    tb, jb = toy_ssd(tmx), toy_ssd(jmx)
    for blk in tb:
        blk.initialize(device="cpu")
    toy_forward(tmx, tb, torch.from_numpy(imgs[:1]))
    rng = onp.random.RandomState(7)
    weights = {}
    for name, p in _params(tb):
        fan_in = int(onp.prod(p.shape[1:])) if len(p.shape) > 1 else 1
        weights[name] = (rng.randn(*p.shape) / math.sqrt(fan_in)).astype(
            onp.float32)
    for k, (t, j) in enumerate(zip(tb, jb)):
        mine = {n: weights[f"{k}.{n}"] for n in t.collect_params()}
        from_jax_params(mine, t)
        for n, p in j.collect_params().items():
            p.set_data(jmx.np.array(mine[n]))
    # the port: the example's loop
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    t_tr = tmx.gluon.Trainer(dict(_params(tb)), "adam",
                             {"learning_rate": 2e-3})
    x, y = torch.from_numpy(imgs), torch.from_numpy(labs)
    with tmx.autograd.record():
        anchors, cls_pred, box_pred = toy_forward(tmx, tb, x)
        with tmx.autograd.pause():
            loc_t, loc_m, cls_t = tmx.npx.multibox_target(
                anchors, y, cls_pred.transpose(1, 2),
                negative_mining_ratio=3.0)
        t_loss = example_loss(tmx, cls_pred, box_pred, loc_t, loc_m, cls_t,
                              loss_fn)
    tmx.autograd.backward(t_loss)
    # the reference: the same function, jitted around its host op
    jnet = _JaxToy(jb)
    zeros = [jmx.np.zeros((16, box_pred.shape[1]))] * 2 + [
        jmx.np.zeros((16, cls_pred.shape[1]))]
    fn, params = jnet.functionalize(jmx.np.array(imgs), *zeros)
    forward = jax.jit(lambda p, xx: fn(p, xx, *[z._data for z in zeros])[0])
    ja, jc_pred, _, _ = forward(params, imgs)
    targets = [_host(t) for t in jmx.npx.multibox_target(
        onp.asarray(ja), labs, onp.asarray(jc_pred).transpose(0, 2, 1),
        negative_mining_ratio=3.0)]
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: fn(p, imgs, *targets)[0][3]))(params)
    close(t_loss, onp.asarray(j_loss), EW, "loss")
    for name, t in (("loc_target", loc_t), ("loc_mask", loc_m),
                    ("cls_target", cls_t)):
        close(t, targets[("loc_target", "loc_mask",
                          "cls_target").index(name)], EW, name)
    prefix = ("backbone.", "cls_head.", "box_head.")
    jp = {f"{k}.{n}": (prefix[k] + n, p) for k, blk in enumerate(jb)
          for n, p in blk.collect_params().items()}
    for name, p in _params(tb):
        close(p.grad(), onp.asarray(j_grads[jp[name][0]]), GRAD,
              f"d{name}")
        jp[name][1].grad()[:] = jmx.np.array(onp.asarray(
            j_grads[jp[name][0]]))
    jmx.gluon.Trainer(dict(_params(jb)), "adam",
                      {"learning_rate": 2e-3}).step(1)
    t_tr.step(1)
    for name, p in _params(tb):
        close(p.data(), jp[name][1].data(), EW, name)
    _, params = jnet.functionalize(jmx.np.array(imgs), *zeros)
    ja, jc_pred, jb_pred, _ = forward(params, val_imgs)
    probs = onp.asarray(jax.nn.softmax(jc_pred, axis=-1)).transpose(0, 2, 1)
    want = _host(jmx.npx.multibox_detection(
        probs, onp.asarray(jb_pred), onp.asarray(ja), threshold=0.3,
        nms_threshold=0.45))
    with torch.no_grad():
        anchors, cls_pred, box_pred = toy_forward(
            tmx, tb, torch.from_numpy(val_imgs))
        probs = tmx.npx.softmax(cls_pred, axis=-1).transpose(1, 2)
        got = _host(tmx.npx.multibox_detection(probs, box_pred, anchors,
                                               threshold=0.3,
                                               nms_threshold=0.45))
    onp.testing.assert_array_equal(got[..., 0], want[..., 0])
    close(got, want, EW, "detections")
    assert (got[..., 0] >= 0).any()


# ---------------------------------------------------------------------------
# the three front-door faults
# ---------------------------------------------------------------------------
def test_nd_serves_every_np_name():
    """mx.nd.<name> is mx.np.<name> for every public name of mx.np that nd
    does not define itself, as the reference's __getattr__ gives;
    mx.nd.zeros, ones, array and dot agree with the reference's; Custom and the sparse names raise
    MXNetError naming their ROADMAP item instead of falling through."""
    names = [n for n in dir(tmx.np) if not n.startswith("_")
             and n not in vars(tmx.nd)]        # nd's own: array, ndarray
    assert len(names) > 300
    for n in names:
        assert getattr(tmx.nd, n) is getattr(tmx.np, n), n
    a = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    with tmx.cpu():
        pairs = [(tmx.nd.zeros(3), jmx.nd.zeros(3)),
                 (tmx.nd.ones((2, 2)), jmx.nd.ones((2, 2))),
                 (tmx.nd.array([[1.5, 2.0]]), jmx.nd.array([[1.5, 2.0]])),
                 (tmx.nd.dot(tmx.nd.array(a), tmx.nd.array(a.T)),
                  jmx.nd.dot(jmx.nd.array(a), jmx.nd.array(a.T)))]
    for got, want in pairs:
        close(got, want, 0.0, "nd")
    assert tmx.nd.attach_grad is not tmx.np.__dict__.get("attach_grad")
    for name, item in [("Custom", 11), ("cast_storage", 3),
                       ("csr_matrix", 3), ("row_sparse_array", 3),
                       ("CSRNDArray", 3), ("RowSparseNDArray", 3)]:
        with pytest.raises(MXNetError, match=f"item {item}"):
            getattr(tmx.nd, name)()
    with pytest.raises(AttributeError):
        tmx.nd.no_such_function


def test_device_scope_and_context_names(tmp_path):
    """with mx.cpu(): makes arrays, parameters and loaded parameters on the
    CPU where no device is given; scopes nest and are per thread;
    outside a scope the default stays gpu(0) and raises without a card.
    Context is usable wherever torch takes a device, and context's names
    are the reference's."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-card default; this host has a card")
    for n in ("Context", "Device", "device", "cpu", "cpu_pinned", "gpu",
              "num_gpus", "current_context", "current_device",
              "is_np_array", "set_np", "use_np"):
        assert hasattr(jmx, n) and hasattr(tmx, n), n
    for n in ("ctx_list",):
        assert hasattr(tmx.context, n)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.np.zeros(3)
    with tmx.cpu() as ctx:
        assert ctx is tmx.current_context() and repr(ctx) == "cpu(0)"
        assert tmx.np.zeros(3).device.type == "cpu"
        assert tmx.np.random.normal(size=(2,)).device.type == "cpu"
        assert tmx.npx.random.normal_n(batch_shape=2).device.type == "cpu"
        with tmx.gpu(0):
            assert tmx.current_context() == tmx.gpu(0)
            with pytest.raises(MXNetError, match="CUDA is not available"):
                tmx.np.ones(2)
        assert tmx.np.ones(2).device.type == "cpu"
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            tmx.current_context()))
        t.start()
        t.join(10)
        assert not t.is_alive() and seen == [tmx.gpu(0)]
        net = tmx.gluon.nn.Dense(3, in_units=2)
        net.initialize()
        assert net.weight.data().device.type == "cpu"
        p = tmx.gluon.Parameter("w")
        p.set_data(onp.ones((2, 2), onp.float32))
        assert p.data().device.type == "cpu"
        net.save_parameters(str(tmp_path / "n.params"))
        other = tmx.gluon.nn.Dense(3, in_units=2)
        other.load_parameters(str(tmp_path / "n.params"))
        assert other.weight.data().device.type == "cpu"
    assert tmx.current_context() == tmx.gpu(0)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.gluon.nn.Dense(3, in_units=2).initialize()
    c = tmx.Context("cpu")
    assert torch.zeros(2, device=c).device == torch.device("cpu")
    assert torch.ones(1).to(tmx.cpu()).device.type == "cpu"
    assert tmx.np.zeros(2, device=c).device.type == "cpu"
    assert tmx.cpu() == torch.device("cpu") and tmx.gpu(1) == torch.device(
        "cuda", 1)
    assert torch.device(tmx.gpu(2)) == torch.device("cuda", 2)
    assert {tmx.cpu(), tmx.Device("cpu", 0)} == {tmx.cpu()}
    # one identity, torch's spelling: equal values hash alike
    assert tmx.gpu(0) == "cuda:0" and hash(tmx.gpu(0)) == hash("cuda:0")
    assert str(tmx.gpu(1)) == "cuda:1" and tmx.gpu(1) != tmx.gpu(0)
    assert tmx.cpu_pinned() == tmx.cpu() == "cpu"
    assert {tmx.cpu_pinned(), tmx.cpu(), "cpu"} == {"cpu"}
    assert tmx.Context(tmx.gpu(3)).device_id == 3 and \
        tmx.gpu(3).device_typeid == 2
    assert repr(tmx.gpu(1)) == repr(jmx.gpu(1)) == "gpu(1)"
    assert tmx.cpu_pinned().device_type == "cpu_pinned"
    assert tmx.num_gpus() == 0
    assert tmx.context.ctx_list(tmx.cpu()) == [tmx.cpu()]
    with pytest.raises(MXNetError, match="unknown device type"):
        tmx.Context("tpu")


def test_model_zoo_get_model():
    """gluon.model_zoo.get_model is vision.get_model, re-exported as the
    reference does; resnet18_v1 builds (its parameters deferred)."""
    from mxnet_tpu_torch.gluon import model_zoo

    assert model_zoo.get_model is model_zoo.vision.get_model
    net = tmx.gluon.model_zoo.get_model("resnet18_v1", classes=10)
    assert type(net).__name__ == type(
        jmx.gluon.model_zoo.get_model("resnet18_v1")).__name__
    with tmx.cpu():
        net.initialize()
        assert net(torch.rand(1, 3, 32, 32)).shape == (1, 10)


@pytest.mark.parametrize("name", ["maximum", "minimum", "fmax", "fmin",
                                  "arctan2", "hypot", "logaddexp", "gcd",
                                  "lcm"])
def test_np_binary_ops_take_python_numbers(name):
    """mx.np's binary functions over torch ops that refuse a Python
    number (the example's ``mx.np.maximum(w.sum(), 1.0)``) take one on
    either side, with the reference's values and dtype."""
    x = (onp.array([4, 6, 9]) if name in ("gcd", "lcm")
         else onp.array([[-1.5, 0.5, 3.0]], onp.float32))
    num = 6 if name in ("gcd", "lcm") else 1.25
    for a, b in [(x, num), (num, x)]:
        got = getattr(tmx.np, name)(*[torch.from_numpy(v) if isinstance(
            v, onp.ndarray) else v for v in (a, b)])
        want = getattr(jmx.np, name)(*[jmx.np.array(v) if isinstance(
            v, onp.ndarray) else v for v in (a, b)])
        close(got, want, EW, name)


def test_chip_smoke_nms_diffs_allow_only_own_ties():
    """chip_smoke.py lets a row that the card's NMS keeps and its CPU
    copy suppresses (or the reverse) pass only where that row's own IoU
    with an earlier kept row of its class lies within DET_NEAR of the
    threshold, or where an earlier row so allowed suppresses it on one
    side only; a tie elsewhere in the image excuses nothing."""
    import chip_smoke

    x = 0.55 / 1.45                      # IoU (1 - x) / (1 + x) = 0.45
    boxes = torch.tensor([[0, 0, 1, 1], [x, 0, x + 1, 1],
                          [x + 0.05, 0, x + 1.05, 1], [5, 5, 6, 6]],
                         dtype=torch.float64)
    cpu = torch.tensor([True, False, True, True])
    card = torch.tensor([True, True, False, True])
    diff, bad = chip_smoke.nms_diffs(torch, "t", card, cpu, boxes, None, 0.45)
    assert diff == [1, 2] and bad == []           # a tie, then its cascade
    card = torch.tensor([True, False, True, False])
    diff, bad = chip_smoke.nms_diffs(torch, "t", card, cpu, boxes, None, 0.45)
    assert diff == [3] and bad == [3]             # the A-B tie is not row 3's
    card = torch.tensor([True, True, False, True])
    cls = torch.tensor([0.0, 1.0, 1.0, 2.0])
    diff, bad = chip_smoke.nms_diffs(torch, "t", card, cpu, boxes, cls, 0.45)
    assert bad == [1, 2]                          # the tie is across classes
    dets = torch.full((1, 4, 6), -1.0)
    dets[0, :, 1] = torch.tensor([0.9, 0.8, 0.7, 0.6])
    dets[0, :, 2:] = boxes.float()
    want, got = dets.clone(), dets.clone()
    want[0, :, 0] = torch.tensor([0.0, -1.0, 0.0, 0.0])
    got[0, :, 0] = torch.tensor([0.0, 0.0, -1.0, 0.0])
    assert chip_smoke.detection_diffs(torch, got, want, 0.45) == ([0], [])
    got[0, :, 0] = torch.tensor([0.0, -1.0, 0.0, -1.0])
    assert chip_smoke.detection_diffs(torch, got, want, 0.45) == ([0],
                                                                  [(0, 3)])
