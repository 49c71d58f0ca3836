"""The port's contrib family against the JAX package's, on the CPU:
``ops/contrib.py`` through ``mx.npx``, ``npx``'s control flow
(``foreach``, ``while_loop``, ``cond``), ``ops/dispatch.py``,
``mx.contrib.nd``'s aliases and ``gluon.contrib.cnn``'s blocks.

- Completeness of the new modules: every public callable of the
  reference module exists in the port, but the reasoned exclusions.
- Parity: one table of npx calls through both packages on seeded numpy
  inputs; shapes and dtypes equal, integer outputs, masks and NMS rows
  exact, float32 values within 1e-5 of 1 + the largest magnitude, 1e-4
  for the deformable products.
- Gradients: torch autograd against ``jax.vjp`` of the reference's
  ``ops.contrib`` function, within 1e-5 of 1 + the largest magnitude
  (1e-4 for the deformable products and the control flow).
- ``sync_batch_norm``'s training flag and in-place moving statistics;
  the blocks with the same weights through ``convert.from_jax_params``;
  the control flow eager, in a hybridized block and on its capture path
  (no host read), with ``while_loop``'s padding and ``cond``'s masked
  inputs.
"""
import importlib
import inspect
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_jax_params

jnpx, tnpx = jmx.npx, tmx.npx
jc = importlib.import_module("mxnet_tpu.ops.contrib")
tcf = importlib.import_module("mxnet_tpu_torch.numpy_extension.control_flow")

_IMPORT = "an import of the reference module, not its API"
EXCLUDED = {
    "ops.contrib": {
        "boolean_mask": "npx's (numpy_extension.boolean_mask), re-used and "
                        "not written twice",
        "index_copy": "npx's (numpy_extension.index_copy), re-used and not "
                      "written twice"},
    "ops.dispatch": dict(
        {n: _IMPORT for n in ("List", "MXNetError", "Tuple")},
        Tape="the tape is torch's autograd graph",
        TapeNode="a node of the tape is torch's autograd Node",
        backward="the sweep is torch's (mxnet_tpu_torch.autograd.backward)",
        failsoft_call="retries a JAX backend's first initialisation; "
                      "torch's CUDA has none to retry"),
    "numpy_extension.control_flow": {
        n: _IMPORT for n in ("Any", "List", "Sequence", "Tuple", "Union",
                             "apply_op", "ndarray")},
    "contrib.ndarray": {},
    "gluon.contrib.cnn": {},
}


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and callable(getattr(mod, n))
                  and not inspect.ismodule(getattr(mod, n)))


@pytest.mark.parametrize("name", sorted(EXCLUDED))
def test_every_public_callable_is_ported(name):
    """Every public callable of the reference module has a counterpart of
    the same name in the port, but the reasoned exclusions; each
    exclusion names a callable the reference has and the port lacks."""
    ref = importlib.import_module(f"mxnet_tpu.{name}")
    port = importlib.import_module(f"mxnet_tpu_torch.{name}")
    public = _public(ref)
    missing = [n for n in public if n not in EXCLUDED[name]
               and not hasattr(port, n)]
    assert not missing, f"{name}: not ported {missing}"
    for n in EXCLUDED[name]:
        assert n in public and not hasattr(port, n), n


# ---------------------------------------------------------------------------
# the parity table
# ---------------------------------------------------------------------------
R = onp.random.RandomState(16)
X = R.randn(4, 6).astype(onp.float32)
Y = R.randn(3, 5).astype(onp.float32)
DATA = R.randn(2, 6, 9, 11).astype(onp.float32)
PSDATA = R.randn(2, 3 * 2 * 2, 9, 11).astype(onp.float32)
ROIS = onp.array([[0, 1, 1, 7, 6], [1, 0, 0, 10, 8], [0, 3.4, 2.2, 5.1, 3.9],
                  [1, -2, -3, 20, 15], [0, 9, 7, 30, 30], [1, 5, 5, 5, 5],
                  [0, 2.5, 0.5, 8.5, 4.5]], onp.float32)


def _boxes(n):
    b = R.rand(n, 4).astype(onp.float32) * 0.6
    b[:, 2:] += b[:, :2] + 0.05
    return b


B1, B2 = _boxes(7), _boxes(5)
NMS = onp.concatenate([R.randint(0, 3, (40, 1)), R.rand(40, 1), _boxes(40)],
                      1).astype(onp.float32)
SM = R.rand(6, 4).astype(onp.float32)
FM = onp.zeros((1, 3, 5, 6), onp.float32)
DX = R.randn(2, 4, 7, 8).astype(onp.float32)
DOFF = (R.randn(2, 2 * 9 * 2, 7, 8) * 1.5).astype(onp.float32)
DMASK = R.rand(2, 9 * 2, 7, 8).astype(onp.float32)
DW = R.randn(6, 2, 3, 3).astype(onp.float32)
DB = R.randn(6).astype(onp.float32)
DCN = dict(kernel=(3, 3), pad=1, num_group=2, num_deformable_group=2)
HN, HK, HT = 3, 4, 6
HAWKES = ((R.rand(HN, HK) + 0.1).astype(onp.float32),
          (R.rand(HK) * 0.5).astype(onp.float32),
          (R.rand(HK) + 0.5).astype(onp.float32),
          R.rand(HN, HK).astype(onp.float32),
          R.rand(HN, HT).astype(onp.float32),
          R.randint(0, HK, (HN, HT)).astype(onp.int32),
          onp.array([6, 3, 0], onp.float32))
HAWKES += (HAWKES[4].sum(1) + 1.0,)
HALVES = onp.array([-2.5, -1.5, -0.5, 0.0, 0.5, 1.5, 2.5, 0.7, -0.7, 3.2],
                   onp.float32)
LAB = onp.full((2, 3, 5), -1.0, onp.float32)
LAB[0, :2] = [[0, 0.1, 0.1, 0.45, 0.5], [1, 0.5, 0.4, 0.9, 0.95]]
LAB[1, 1] = [1, 0.2, 0.3, 0.6, 0.7]
ANCH = onp.asarray(jc.multibox_prior(jnp.zeros((1, 1, 4, 4)), (0.3, 0.5),
                                     (1, 2, 0.5)))
CPRED = R.randn(2, 3, ANCH.shape[1]).astype(onp.float32)
CPROB = onp.asarray(jax.nn.softmax(jnp.asarray(CPRED), axis=1))
LPRED = (R.randn(2, ANCH.shape[1] * 4) * 0.5).astype(onp.float32)

EW, DEF, EXACT = 1e-5, 1e-4, 0.0
CASES = []


def add(name, *args, tol=EW, kw=None):
    CASES.append(pytest.param(len(CASES), name, args, kw or {}, tol,
                              id=f"{name}-{len(CASES)}"))


for scale in (1.0, 0.5):
    add("roi_pooling", DATA, ROIS, (3, 2), scale, tol=EXACT)
    add("roi_align", DATA, ROIS, (3, 2), scale)
    add("roi_align", DATA, ROIS, (2, 3), scale, kw=dict(sample_ratio=3,
                                                        aligned=True))
add("roi_align", DATA, ROIS, (2, 2), kw=dict(sample_ratio=0))
add("psroi_pooling", PSDATA, ROIS, 3, 2, 0.5)
add("psroi_pooling", PSDATA, ROIS, 3, 4, kw=dict(group_size=2))
add("count_sketch", X, R.randint(0, 4, 6), R.choice([-1.0, 1.0], 6), 4)
add("box_iou", B1, B2)
add("box_iou", B1, B2, kw=dict(fmt="center"))
add("box_nms", NMS, kw=dict(overlap_thresh=0.3, valid_thresh=0.2),
    tol=EXACT)
add("box_nms", NMS, kw=dict(topk=10), tol=EXACT)
add("box_nms", NMS[:, [1, 0, 2, 3, 4, 5]], kw=dict(score_index=0,
                                                   overlap_thresh=0.1),
    tol=EXACT)
add("bipartite_matching", SM, kw=dict(threshold=0.3))
add("bipartite_matching", SM, kw=dict(threshold=0.7, is_ascend=True))
add("bipartite_matching", SM.T.copy(), kw=dict(topk=2))
add("allclose", X, X + 1e-6, tol=EXACT)
add("allclose", X, X + 1.0, tol=EXACT)
add("index_array", X, tol=EXACT)
add("index_array", DATA, kw=dict(axes=(3, 1)), tol=EXACT)
add("multibox_prior", FM, kw=dict(sizes=(0.3, 0.5), ratios=(1, 2, 0.5),
                                  clip=True))
add("multibox_prior", FM, kw=dict(sizes=(0.2,), ratios=(1, 3),
                                  steps=(0.2, 0.15), offsets=(0.4, 0.6)))
add("multibox_target", ANCH, LAB, CPRED)
add("multibox_target", ANCH, LAB, CPRED,
    kw=dict(negative_mining_ratio=3.0, overlap_threshold=0.4))
add("multibox_detection", CPROB, LPRED, ANCH, kw=dict(nms_threshold=0.45))
add("multibox_detection", CPROB, LPRED, ANCH,
    kw=dict(threshold=0.2, force_suppress=True, nms_topk=20, clip=False))
add("deformable_convolution", DX, DOFF, DW, DB, kw=DCN, tol=DEF)
add("deformable_convolution", DX[:, :2], DOFF[:, :18, ::2, ::2][..., :4, :4],
    DW[:, :1].repeat(2, 1), kw=dict(kernel=(3, 3), stride=2, pad=1),
    tol=DEF)
add("modulated_deformable_convolution", DX, DOFF, DMASK, DW, DB, kw=DCN,
    tol=DEF)
add("hawkes_ll", *HAWKES)
add("round_ste", HALVES, tol=EXACT)
add("sign_ste", HALVES, tol=EXACT)
add("khatri_rao", X[:2], X[2:], X[1:4])
add("quadratic", X, kw=dict(a=1.5, b=-2.0, c=0.25))
add("all_finite", X, tol=EXACT)
add("all_finite", onp.array([1.0, onp.inf], onp.float32), tol=EXACT)
add("multi_all_finite", X, Y, tol=EXACT)
add("multi_all_finite", X, onp.array([onp.nan], onp.float32), tol=EXACT)
add("multi_sum_sq", X, Y)
add("nnz", onp.array([[0, 2, 0], [1, 0, 3]], onp.int64), tol=EXACT)
for ac in (True, False):
    add("bilinear_resize_2d", DATA, 13, 5, kw=dict(align_corners=ac))
    add("bilinear_resize_2d", DATA, kw=dict(scale_height=2.0,
                                            scale_width=1.5,
                                            align_corners=ac))
add("gradientmultiplier", X, kw=dict(scalar=-0.5), tol=EXACT)


def _ref(x):
    if isinstance(x, onp.ndarray):
        return jmx.np.array(x, dtype=x.dtype)
    return x


def _port(x):
    return torch.from_numpy(x.copy()) if isinstance(x, onp.ndarray) else x


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, (list, tuple)):
        return [_host(y) for y in x]
    return onp.asarray(x)


def compare(got, want, tol, what):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for g, w in zip(got, want):
            compare(g, w, tol, what)
        return
    want, got = onp.asarray(want), onp.asarray(got)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    if tol == EXACT or want.dtype.kind in "biu":
        onp.testing.assert_array_equal(got, want, err_msg=what)
    else:
        scale = float(onp.nanmax(onp.abs(want))) if want.size else 1.0
        onp.testing.assert_allclose(got, want, rtol=0, atol=tol * (1 + scale),
                                    err_msg=what)


# the reference computes these two on the host with numpy
_HOST_OPS = ("multibox_target", "multibox_detection")


def _reference(case):
    """The reference's ``ops.contrib`` function (what its npx name calls)
    on the case's arrays, under one ``jax.jit`` with the other arguments
    static: one compile a case instead of one an op."""
    _, name, args, kw, _ = case.values
    fn = getattr(jc, name)
    if name in _HOST_OPS:
        return _host(list(fn(*args, **kw)) if name == "multibox_target"
                     else fn(*args, **kw))
    at = [i for i, a in enumerate(args) if isinstance(a, onp.ndarray)]

    def call(*arrays):
        full = list(args)
        for i, a in zip(at, arrays):
            full[i] = a
        return fn(*full, **kw)

    out = jax.jit(call)(*[jnp.asarray(args[i]) for i in at])
    return _host(list(out) if isinstance(out, tuple) else out)


@pytest.fixture(scope="module")
def reference_table():
    """The reference's results of the whole table, computed once for the
    module by four threads (XLA compiles outside the GIL)."""
    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(_reference, CASES))


@pytest.mark.parametrize("idx,name,args,kw,tol", CASES)
def test_npx_contrib_matches_jax(reference_table, idx, name, args, kw, tol):
    """The npx call in the port equals the reference's: shape, dtype and
    values at the case's tolerance; class ids of the SSD outputs exactly.
    """
    want = reference_table[idx]
    got = _host(getattr(tnpx, name)(*[_port(a) for a in args],
                                    **{k: _port(v) for k, v in kw.items()}))
    if name == "multibox_detection":
        compare(got[..., 0], want[..., 0], EXACT, name)
    if name == "multibox_target":
        compare(got[1:], want[1:], EXACT, name)
    compare(got, want, tol, name)


# ---------------------------------------------------------------------------
# gradients: torch autograd against jax.vjp of the reference's function
# ---------------------------------------------------------------------------
GRADS = [
    ("roi_pooling", lambda m, d: m.roi_pooling(d, ROIS_[m], (3, 2), 0.5),
     (DATA,), EW),
    ("roi_align", lambda m, d: m.roi_align(d, ROIS_[m], (3, 2), 0.5, 2,
                                           True), (DATA,), EW),
    ("psroi_pooling", lambda m, d: m.psroi_pooling(d, ROIS_[m], 3, 2, 0.5),
     (PSDATA,), EW),
    ("deformable_convolution", lambda m, d, o, w, b: m.deformable_convolution(
        d, o, w, b, **DCN), (DX, DOFF, DW, DB), DEF),
    ("modulated_deformable_convolution",
     lambda m, d, o, k, w: m.modulated_deformable_convolution(
         d, o, k, w, None, **DCN), (DX, DOFF, DMASK, DW), DEF),
    ("bilinear_resize_2d", lambda m, d: m.bilinear_resize_2d(
        d, 13, 5, align_corners=False), (DATA,), EW),
    ("count_sketch", lambda m, d: m.count_sketch(
        d, ARR_[m](onp.array([0, 3, 1, 3, 2, 0])),
        ARR_[m](onp.array([1.0, -1, 1, 1, -1, 1], onp.float32)), 4), (X,),
     EW),
    ("hawkes_ll", lambda m, mu, a, b, s, lg: m.hawkes_ll(
        mu, a, b, s, lg, *[ARR_[m](v) for v in HAWKES[5:]])[0],
     HAWKES[:5], EW),
    ("sync_batch_norm", lambda m, x, g, b: m.sync_batch_norm(
        x, g, b, None, None)[0], (DATA, DATA[0, :, 0, 0].copy(),
                                  DATA[1, :, 0, 0].copy()), EW),
    ("box_iou", lambda m, a, b: m.box_iou(a, b), (B1, B2), EW),
    ("khatri_rao", lambda m, a, b: m.khatri_rao(a, b), (X[:2], X[2:]), EW),
    ("quadratic", lambda m, x: m.quadratic(x, 1.5, -2.0, 0.25), (X,), EW),
    ("round_ste", lambda m, x: m.round_ste(x), (HALVES,), EW),
    ("sign_ste", lambda m, x: m.sign_ste(x), (HALVES,), EW),
    ("gradientmultiplier", lambda m, x: m.gradientmultiplier(x, -0.5), (X,),
     EW),
]
ROIS_ = {jc: jnp.asarray(ROIS), tmx.ops.contrib: torch.from_numpy(ROIS)}
ARR_ = {jc: jnp.asarray, tmx.ops.contrib: torch.from_numpy}


def _weights(shape):
    return onp.linspace(0.5, 1.5, int(onp.prod(shape))).reshape(shape).astype(
        onp.float32)


def _reference_grad(f, xs):
    """(f(x), w, the vjp of w) of the reference's function, one jit."""
    xs = [jnp.asarray(x) for x in xs]
    w = _weights(jax.eval_shape(lambda *a: f(jc, *a), *xs).shape)

    @jax.jit
    def run(*a):
        y, pull = jax.vjp(lambda *b: f(jc, *b), *a)
        return y, pull(jnp.asarray(w))

    y, grads = run(*xs)
    return onp.asarray(y), w, [onp.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def reference_grads():
    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(lambda g: _reference_grad(g[1], g[2]), GRADS))


@pytest.mark.parametrize("idx", range(len(GRADS)),
                         ids=[g[0] for g in GRADS])
def test_gradients_match_jax(reference_grads, idx):
    """d/dx of sum(f(x) * w) by torch autograd against jax.vjp of the
    reference's function, for every differentiable input."""
    name, f, xs, tol = GRADS[idx]
    want_y, w, want_g = reference_grads[idx]
    txs = [torch.from_numpy(x.copy()).requires_grad_() for x in xs]
    ty = f(tmx.ops.contrib, *txs)
    (ty * torch.from_numpy(w)).sum().backward()
    compare(ty.detach().numpy(), want_y, tol, name)
    for t, g in zip(txs, want_g):
        compare(t.grad.numpy(), g, tol, name)


def test_sync_batch_norm_training_flag_and_moving_stats():
    """npx.sync_batch_norm normalizes with the batch statistics and writes
    the momentum-updated moving statistics in place under
    autograd.record(), with the moving statistics otherwise, as the
    reference; an axis_name raises (no mesh yet)."""
    x = DATA
    gamma, beta = R.rand(6).astype(onp.float32) + 0.5, R.randn(6).astype(
        onp.float32)
    mm, mv = R.randn(6).astype(onp.float32), R.rand(6).astype(onp.float32)
    jm, jv, tm, tv = _ref(mm), _ref(mv), _port(mm), _port(mv)
    with jmx.autograd.record():
        want = jnpx.sync_batch_norm(_ref(x), _ref(gamma), _ref(beta), jm, jv)
    with tmx.autograd.record():
        got = tnpx.sync_batch_norm(_port(x), _port(gamma), _port(beta), tm,
                                   tv)
    compare(_host(list(got)), _host(list(want)), EW, "train")
    compare(_host(tm), _host(jm), EW, "moving_mean")
    compare(_host(tv), _host(jv), EW, "moving_var")
    want = jnpx.sync_batch_norm(_ref(x), _ref(gamma), _ref(beta), jm, jv)
    got = tnpx.sync_batch_norm(_port(x), _port(gamma), _port(beta), tm, tv)
    compare(_host(list(got)), _host(list(want)), EW, "predict")
    with pytest.raises(MXNetError, match="item 8"):
        tnpx.sync_batch_norm(_port(x), _port(gamma), _port(beta), tm, tv,
                             axis_name="dp")


# ---------------------------------------------------------------------------
# mx.contrib.nd and gluon.contrib.cnn
# ---------------------------------------------------------------------------
def test_contrib_nd_aliases():
    """Every mx.contrib.nd name of the reference is npx's function of the
    same op in the port, the CamelCase ones included."""
    ref = importlib.import_module("mxnet_tpu.contrib.ndarray")
    port = tmx.contrib.nd
    for name in ref.__all__:
        target = getattr(ref, name)
        npx_name = next(n for n in dir(jnpx) if getattr(jnpx, n) is target)
        assert getattr(port, name) is getattr(tnpx, npx_name), name
    got = port.MultiBoxPrior(_port(FM), (0.3, 0.5), (1, 2))
    want = ref.MultiBoxPrior(_ref(FM), (0.3, 0.5), (1, 2))
    compare(_host(got), _host(want), EW, "MultiBoxPrior")


@pytest.mark.parametrize("cls", ["DeformableConvolution",
                                 "ModulatedDeformableConvolution"])
def test_deformable_blocks_match_jax(cls):
    """A deferred-shape block of each kind with the same weights in both
    packages (carried by convert.from_jax_params): the offsets start at
    zero (the reference's initializers), and the output and the
    gradients of the input and every parameter agree within 1e-4 (the
    reference's through its ``functionalize`` fn under one jit)."""
    kw = dict(channels=4, kernel_size=3, padding=1, num_deformable_group=2,
              groups=2, activation="relu")
    tb = getattr(tmx.gluon.contrib.cnn, cls)(**kw)
    jb = getattr(jmx.gluon.contrib.cnn, cls)(**kw)
    tb.initialize(device="cpu")
    x = R.randn(2, 4, 6, 7).astype(onp.float32)
    tb(_port(x))
    assert not tb.offset_weight.data().any() and not tb.offset_bias.data(
    ).any()
    rng = onp.random.RandomState(3)
    weights = {n: (rng.randn(*p.shape) * 0.3).astype(onp.float32)
               for n, p in tb.collect_params().items()}
    from_jax_params(weights, tb)
    for n, p in jb.collect_params().items():
        p.set_data(jmx.np.array(weights[n]))
    w = _weights((2, 4, 6, 7))
    fn, params = jb.functionalize(jmx.np.array(x))

    @jax.jit
    def run(p, xx):       # the reference block's output and its vjp of w
        y, pull = jax.vjp(lambda p_, x_: fn(p_, x_)[0], p, xx)
        return y, pull(jnp.asarray(w))

    jy, (jgp, jgx) = run(params, jnp.asarray(x))
    tx = _port(x).requires_grad_()
    with tmx.autograd.record():
        ty = tb(tx)
    tmx.autograd.backward((ty * torch.from_numpy(w)).sum())
    compare(_host(ty), onp.asarray(jy), DEF, cls)
    compare(_host(tx.grad), onp.asarray(jgx), DEF, cls + " dx")
    for n, p in tb.collect_params().items():
        compare(_host(p.grad()), onp.asarray(jgp[n]), DEF, f"{cls} d{n}")


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------
U_, T_, B_ = 3, 4, 2
CELL = (R.randn(2 * U_, 4 * U_) * 0.5).astype(onp.float32)
SEQ = R.randn(T_, B_, U_).astype(onp.float32)
H0 = R.randn(B_, U_).astype(onp.float32)
C0 = R.randn(B_, U_).astype(onp.float32)


def _lstm_body(m, w):
    """An LSTM-style cell over (B, U) states, its weight w closed over."""
    def body(x, states):
        h, c = states
        z = m.np.dot(m.np.concatenate([x, h], axis=1), w)
        i, f, o, g = [z[:, k * U_:(k + 1) * U_] for k in range(4)]
        c2 = m.npx.sigmoid(f) * c + m.npx.sigmoid(i) * m.np.tanh(g)
        h2 = m.npx.sigmoid(o) * m.np.tanh(c2)
        return h2, [h2, c2]
    return body


def _foreach_ref():
    w = jmx.np.array(CELL)
    xs, h0, c0 = _ref(SEQ), _ref(H0), _ref(C0)
    for a in (xs, h0, c0):
        a.attach_grad()
    with jmx.autograd.record():
        out, (h, c) = jnpx.foreach(_lstm_body(jmx, w), xs, [h0, c0])
        loss = (out * jmx.np.array(_weights(out.shape))).sum() + (
            h * c).sum()
        loss.backward()
    return [_host(v) for v in (out, h, c, xs.grad, h0.grad, c0.grad)]


def _foreach_port(call=None):
    w = torch.from_numpy(CELL)
    xs, h0, c0 = [_port(a).requires_grad_() for a in (SEQ, H0, C0)]
    body = _lstm_body(tmx, w)
    with tmx.autograd.record():
        out, (h, c) = (call or tnpx.foreach)(body, xs, [h0, c0])
        loss = (out * torch.from_numpy(_weights(tuple(out.shape)))).sum() \
            + (h * c).sum()
    tmx.autograd.backward(loss)
    return [_host(v) for v in (out, h, c, xs.grad, h0.grad, c0.grad)]


class _Foreach(tmx.gluon.HybridBlock):
    def __init__(self, w):
        super().__init__()
        self.w = w

    def forward(self, xs, h0, c0):
        out, (h, c) = tnpx.foreach(_lstm_body(tmx, self.w), xs, [h0, c0])
        return out, h, c


def test_foreach_matches_jax_eager_and_hybridized():
    """foreach over an LSTM-style cell: outputs, final states and the
    gradients of the data and initial states against the reference's
    autograd, eagerly and inside a hybridized block (within 1e-4)."""
    want = _foreach_ref()
    compare(_foreach_port(), want, DEF, "foreach eager")
    blk = _Foreach(torch.from_numpy(CELL))
    blk.hybridize()
    got = _foreach_port(lambda body, xs, st: (lambda o: (o[0], list(o[1:])))(
        blk(xs, *st)))
    compare(got, want, DEF, "foreach hybridized")


def _while_cases(m):
    def cond(i, s):
        return i < 3.5

    def func(i, s):
        return [s * 2, i + s], [i + 1, s + i]
    return cond, func


@pytest.mark.parametrize("capturing", [False, True], ids=["eager", "capture"])
@pytest.mark.parametrize("start,max_iterations", [(0.0, 6), (0.0, 2),
                                                  (5.0, 3)])
def test_while_loop_matches_jax(monkeypatch, capturing, start,
                                max_iterations):
    """while_loop's stacked outputs (padded with zeros to max_iterations)
    and final variables equal the reference's, eagerly (a host read of
    the predicate) and on the capture path (masked passes, no host read:
    a read there raises)."""
    cond, func = _while_cases(jmx)
    i0, s0 = onp.float32(start), onp.array([1.0, -2.0], onp.float32)
    want = _host(list(jnpx.while_loop(cond, func, [_ref(onp.array(i0)),
                                                   _ref(s0)],
                                      max_iterations)))
    if capturing:
        monkeypatch.setattr(tcf, "_capturing", lambda: True)
        monkeypatch.setattr(torch.Tensor, "__bool__", _no_host_read)
    got = tnpx.while_loop(cond, func, [torch.tensor(i0), _port(s0)],
                          max_iterations)
    monkeypatch.undo()
    compare(_host(list(got)), want, EXACT, "while_loop")


def _no_host_read(self):
    raise AssertionError("a host read on the capture path")


def test_while_loop_refuses_reverse_mode():
    """The reference's while_loop cannot be differentiated in reverse
    mode; the port raises rather than give a gradient."""
    cond, func = _while_cases(tmx)
    s = torch.ones(2, requires_grad=True)
    with pytest.raises(MXNetError, match="reverse mode"):
        tnpx.while_loop(cond, func, [torch.tensor(0.0), s], 4)
    with torch.no_grad():
        out, _ = tnpx.while_loop(cond, func, [torch.tensor(0.0), s], 4)
    assert not out[0].requires_grad


@pytest.mark.parametrize("capturing", [False, True], ids=["eager", "capture"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cond_matches_jax(monkeypatch, capturing, sign):
    """cond's outputs and input gradients against the reference's
    (lax.cond), eagerly (one branch) and on the capture path (both
    branches selected by torch.where, no host read)."""
    x0 = (onp.abs(X[0]) * sign).astype(onp.float32)

    def pred(a):
        return a.sum() > 0

    def then_f(a):
        return [a * a, a.sum()]

    def else_f(a):
        return [a - 1, (a * 3).sum()]

    jx = _ref(x0)
    jx.attach_grad()
    with jmx.autograd.record():
        jo = jnpx.cond(pred, then_f, else_f, [jx])
        (jo[0] * jmx.np.array(_weights(x0.shape))).sum().backward()
    if capturing:
        monkeypatch.setattr(tcf, "_capturing", lambda: True)
        monkeypatch.setattr(torch.Tensor, "__bool__", _no_host_read)
    tx = _port(x0).requires_grad_()
    to = tnpx.cond(pred, then_f, else_f, [tx])
    (to[0] * torch.from_numpy(_weights(x0.shape))).sum().backward()
    monkeypatch.undo()
    compare(_host(to), _host(jo), EW, "cond")
    compare(_host(tx.grad), jx.grad.asnumpy(), EW, "cond grad")


def test_cond_capture_masks_the_branch_not_taken(monkeypatch):
    """On the capture path the branch not taken runs on masked inputs: its
    infinite local derivative (sqrt at 0) leaves the inputs' gradient
    finite, equal to the branch taken's."""
    monkeypatch.setattr(tcf, "_capturing", lambda: True)
    x = torch.tensor([0.0, 1.0, 4.0], requires_grad=True)
    out = tnpx.cond(lambda a: a.sum() < 0, lambda a: torch.sqrt(a),
                    lambda a: a * 2, [x])
    out.sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_control_flow_in_a_hybridized_block():
    """while_loop and cond inside a hybridized block, called twice: the
    same values as eagerly (the CPU's recorded node replays the block)."""
    class Net(tmx.gluon.HybridBlock):
        def forward(self, s):
            out, (_, fin) = tnpx.while_loop(
                lambda i, v: i < 2.5, lambda i, v: ([v * 3], [i + 1, v + 1]),
                [torch.zeros(()), s], 4)
            return tnpx.cond(lambda v: v.sum() > 0, lambda v: v * 10,
                             lambda v: v - 10, [fin]) + out.sum(0)

    s = torch.tensor([1.0, -3.0])
    net = Net()
    want = net(s)
    net.hybridize()
    for _ in range(2):
        assert torch.equal(net(s), want)


# ---------------------------------------------------------------------------
# ops/dispatch.py
# ---------------------------------------------------------------------------
def test_apply_op_and_the_amp_hook(monkeypatch):
    """apply_op calls the function with its static attributes, returns a
    tuple for n_out > 1, and routes named ops through amp_policy's
    cast_inputs when it is set; is_recording/is_training are autograd's."""
    from mxnet_tpu_torch.ops import dispatch

    x = torch.arange(4.0)
    assert torch.equal(dispatch.apply_op(torch.mul, [x], {"other": 2.0}),
                       x * 2)
    outs = dispatch.apply_op(lambda a: (a + 1, a - 1), [x], n_out=2)
    assert isinstance(outs, tuple) and len(outs) == 2
    seen = []

    class Policy:
        def cast_inputs(self, name, arrays):
            seen.append(name)
            return [a.to(torch.float64) for a in arrays]

    monkeypatch.setattr(dispatch, "amp_policy", Policy())
    assert dispatch.apply_op(torch.neg, [x], name="neg").dtype == \
        torch.float64
    assert dispatch.apply_op(torch.neg, [x]).dtype == torch.float32
    assert seen == ["neg"]
    assert dispatch.is_recording is tmx.autograd.is_recording
    with tmx.autograd.record():
        assert dispatch.is_recording() and dispatch.is_training()
