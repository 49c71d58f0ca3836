"""The port's ``mx.npx`` (``mxnet_tpu_torch.numpy_extension`` with its
``random``), ``ops/nn.py``, initializers and ``util`` against the JAX
package's, on the CPU.

- Completeness: every public callable of the reference modules exists in
  the port, apart from the exclusions below, each with its reason.
- Parity: one table of npx cases through both packages on seeded numpy
  inputs; shapes and dtypes equal, values exact for integer, bool and
  index results, within rtol 1e-5 for float32 elementwise results and
  1e-4 for reductions and products.
- softmax's ``temperature``/``length``, log_softmax's ``temperature`` and
  pick's ``mode``; gradients of ``masked_softmax``, the interleaved
  products, ``gather_nd`` and ``topk`` values against the reference's
  autograd; out-of-range indices of ``pick``, ``gather_nd``,
  ``scatter_nd``, ``one_hot``, ``index_add``, ``index_update`` and
  ``index_copy``; the initializers ``Bilinear``, ``LSTMBias``, ``Load``
  and ``Mixed``; ``npx.save``/``load`` across the packages.
"""
import inspect
from concurrent.futures import ThreadPoolExecutor

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

jnpx, tnpx = jmx.npx, tmx.npx

_IMPORT = "an import of the reference module, not its API"
_KEYS = ("JAX PRNG-key plumbing; the port's draws take "
         "ops.nn.generator, scoped by ops.nn.using_generator")
_TPU = "a TPU/XLA-only helper"
EXCLUDED = {
    "numpy_extension": dict(
        {n: _IMPORT for n in ("apply_op", "dtype_from_any", "ndarray")},
        **{n: _KEYS for n in ("functional_mode", "rng_scope")},
        **{n: _TPU for n in ("tpu", "num_tpus")}),
    "numpy_extension.random": {"new_key": _KEYS},
    "ops.nn": dict(
        {n: _IMPORT for n in ("IntOrTuple", "Optional", "Sequence", "Tuple",
                              "Union")},
        mxu_pad_amount=_TPU + " (MXU tile padding)",
        pad_to_tile=_TPU + " (MXU tile padding)",
        unpad_slice=_TPU + " (MXU tile padding)",
        stem_s2d_cache_key=_TPU + " (the stem's space-to-depth rewrite)",
        no_pallas=_TPU + "; its counterpart is ops.nn.no_kernels"),
    "initializer": {n: _IMPORT for n in ("Optional", "dtype_from_any",
                                         "ndarray")},
    "util": {},
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
    ref = __import__(f"mxnet_tpu.{name}", fromlist=["_"])
    port = __import__(f"mxnet_tpu_torch.{name}", fromlist=["_"])
    public = _public(ref)
    missing = [n for n in public if n not in EXCLUDED[name]
               and not hasattr(port, n)]
    assert not missing, f"{name}: not ported {missing}"
    for n in EXCLUDED[name]:
        assert n in public and not hasattr(port, n), n


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------
R = onp.random.RandomState(1)
X = R.randn(4, 6).astype(onp.float32)
P = (R.rand(4, 6) + 0.5).astype(onp.float32)
U = (R.rand(4, 6) * 1.8 - 0.9).astype(onp.float32)
I = R.randint(-5, 6, (4, 6)).astype(onp.int64)
MASK = R.rand(4, 6) > 0.3
MASK[:, 0] = True
SEQ = R.randn(5, 3, 2).astype(onp.float32)          # (T, B, C)
SLEN = onp.array([2, 5, 3], onp.float32)
L, BB, H, D = 6, 2, 3, 4
QKV = R.randn(L, BB, H * 3 * D).astype(onp.float32)
Q = R.randn(L, BB, H * D).astype(onp.float32)
KV = R.randn(5, BB, H * 2 * D).astype(onp.float32)
ATT = R.rand(BB * H, L, L).astype(onp.float32)
ATT2 = R.rand(BB * H, L, 5).astype(onp.float32)
GIDX = onp.array([[0, 3, 1], [5, 2, 0]], onp.int64)
T3 = R.randn(2, 3, 4).astype(onp.float32)
LOGITS = R.randn(4, 7).astype(onp.float32)
LABEL = onp.array([1, 0, 6, 3], onp.int64)
CTC = R.randn(6, 2, 5).astype(onp.float32)
CTCL = onp.array([[1, 2, 2], [3, 4, 0]], onp.int64)

EW, RED, EXACT = 1e-5, 1e-4, 0.0
CASES = []


def add(name, *args, tol=EW, kw=None):
    CASES.append(pytest.param(len(CASES), name, args, kw or {}, tol,
                              id=f"{name}-{len(CASES)}"))


for n in ("relu", "sigmoid", "erf", "gammaln", "digamma", "log_sigmoid",
          "hard_sigmoid", "silu", "swish", "mish", "softplus", "smooth_l1"):
    add(n, X)
for n in ("rsqrt", "rcbrt", "gamma"):
    add(n, P)
add("erfinv", U)
add("smooth_l1", X, kw=dict(scalar=2.0))
add("gelu", X)
add("gelu", X, kw=dict(approximate=False))
add("softmax", X, kw=dict(axis=0))
add("softmax", X, kw=dict(temperature=2.5))
add("softmax", X, kw=dict(length=onp.array([1, 6, 3, 4])))
add("softmax", X, kw=dict(temperature=0.5, length=onp.array([2, 2, 5, 6])))
add("log_softmax", X, kw=dict(temperature=3.0))
add("masked_softmax", X, MASK)
add("masked_softmax", X, MASK.astype(onp.int64), kw=dict(axis=0,
                                                         temperature=2.0))
add("masked_log_softmax", X, MASK)
add("one_hot", onp.array([0, 3, 1, 2]), 4)
add("one_hot", onp.array([[0, 2], [1, 1]]), 3, kw=dict(on_value=5.0,
                                                       off_value=-1.0))
add("one_hot", onp.array([0, 2]), 3, kw=dict(dtype="int32"))
for rt in ("indices", "value", "both", "mask"):
    add("topk", X, kw=dict(k=3, ret_typ=rt), tol=EXACT)
add("topk", X, kw=dict(k=2, axis=0, is_ascend=True, ret_typ="both"),
    tol=EXACT)
add("topk", onp.array([[3, 1, 3, 2, 3]], onp.float32), kw=dict(
    k=3, ret_typ="indices", dtype="int64"), tol=EXACT)
add("topk", onp.array([[3, 1, 3, 2, 1]], onp.float32), kw=dict(
    k=3, ret_typ="both", is_ascend=True), tol=EXACT)
add("pick", X, onp.array([0, 5, 2, 1]), tol=EXACT)
add("pick", X, onp.array([0, 3, 2, 1, 0, 2]), kw=dict(axis=0,
                                                      keepdims=True), tol=EXACT)
add("gather_nd", X, GIDX, tol=EXACT)
add("gather_nd", T3, onp.array([[1, 0], [2, 1]]), tol=EXACT)
add("scatter_nd", onp.array([1.0, 2.0, 3.0], onp.float32),
    onp.array([[0, 1, 0], [2, 3, 2]]), (2, 4), tol=EXACT)
add("sequence_mask", SEQ, onp.array([2, 5, 3], onp.float32),
    kw=dict(use_sequence_length=True, value=-1.0), tol=EXACT)
add("sequence_mask", SEQ.transpose(1, 0, 2).copy(), SLEN,
    kw=dict(use_sequence_length=True, axis=1), tol=EXACT)
add("sequence_mask", SEQ, tol=EXACT)
add("sequence_last", SEQ, SLEN, kw=dict(use_sequence_length=True),
    tol=EXACT)
add("sequence_last", SEQ.transpose(1, 0, 2).copy(), SLEN,
    kw=dict(use_sequence_length=True, axis=1), tol=EXACT)
add("sequence_last", SEQ, tol=EXACT)
add("sequence_reverse", SEQ, SLEN, kw=dict(use_sequence_length=True),
    tol=EXACT)
add("sequence_reverse", SEQ, tol=EXACT)
add("interleaved_matmul_selfatt_qk", QKV, H, tol=RED)
add("interleaved_matmul_selfatt_valatt", QKV, ATT, H, tol=RED)
add("interleaved_matmul_encdec_qk", Q, KV, H, tol=RED)
add("interleaved_matmul_encdec_valatt", KV, ATT2, H, tol=RED)
add("multi_head_attention", Q.transpose(1, 0, 2).copy(),
    Q.transpose(1, 0, 2).copy() * 0.5, Q.transpose(1, 0, 2).copy(), H,
    tol=RED)
add("multi_head_attention", Q.transpose(1, 0, 2).copy(),
    Q.transpose(1, 0, 2).copy(), Q.transpose(1, 0, 2).copy() * 2, H,
    kw=dict(causal=True), tol=RED)
add("softmax_cross_entropy", LOGITS, LABEL, tol=RED)
add("softmax_cross_entropy", LOGITS, LABEL, kw=dict(per_example=True),
    tol=RED)
add("ctc_loss", CTC, CTCL, tol=RED)
add("ctc_loss", CTC, CTCL, onp.array([6, 4]), onp.array([3, 1]), tol=RED)
add("ctc_loss", CTC, CTCL, kw=dict(blank_label="last"), tol=RED)
add("arange_like", X, tol=EXACT)
add("arange_like", X, kw=dict(start=2.0, step=0.5, axis=1), tol=EXACT)
add("broadcast_like", X[:1], X, tol=EXACT)
add("slice_like", X, X[:2, :3], tol=EXACT)
add("slice_like", X, X[:2, :3], kw=dict(axes=(1,)), tol=EXACT)
add("reshape_like", X, X.reshape(3, 8), tol=EXACT)
add("batch_flatten", T3, tol=EXACT)
add("slice", X, (1, None), (3, None), tol=EXACT)
add("slice", X, (None, 5), (None, 0), (1, -2), tol=EXACT)
add("shape_array", T3, tol=EXACT)
for spec, rev in [((0, -1), False), ((-2,), False), ((-3, 4), False),
                  ((-4, 1, 2, 0, -1), False), ((0, 0, 2, 2), False),
                  ((-1, 0), True), ((0, -4, 3, -1, 0), False)]:
    add("reshape", T3, spec, kw=dict(reverse=rev), tol=EXACT)
add("index_add", X, onp.array([[0, 3, 3], [1, 5, 5]]),
    onp.array([1.0, 2.0, 3.0], onp.float32), tol=EXACT)
add("index_add", T3, onp.array([[1, 0]]), onp.ones((2, 3, 4), onp.float32),
    tol=EXACT)
add("index_update", X, onp.array([[0, 3], [1, 5]]),
    onp.array([7.0, 8.0], onp.float32), tol=EXACT)
add("index_copy", X, onp.array([2, 0]), X[:2] * 3, tol=EXACT)
add("boolean_mask", X, onp.array([1, 0, 1, 1]), tol=EXACT)
add("boolean_mask", X, MASK[0].astype(onp.int64), kw=dict(axis=1),
    tol=EXACT)
add("nonzero", I, tol=EXACT)
add("constraint_check", onp.array([True, True]), tol=EXACT)
add("adaptive_avg_pool2d", R.randn(2, 3, 4, 6).astype(onp.float32), (2, 3),
    tol=RED)
add("is_np_array", tol=EXACT)


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
    return x


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
        onp.testing.assert_allclose(got, want, rtol=tol,
                                    atol=tol * (1 + scale), err_msg=what)


def _reference(case):
    _, name, args, kw, _ = case.values
    return _host(getattr(jnpx, name)(*[_ref(a) for a in args],
                                     **{k: _ref(v) for k, v in kw.items()}))


@pytest.fixture(scope="module")
def reference_table():
    """The reference's results of the whole table, computed once for the
    module by four threads (XLA compiles outside the GIL)."""
    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(_reference, CASES))


@pytest.mark.parametrize("idx,name,args,kw,tol", CASES)
def test_npx_matches_jax(reference_table, idx, name, args, kw, tol):
    """The npx call in the port equals the reference's: shape, dtype and
    values at the case's tolerance."""
    want = reference_table[idx]
    got = _host(getattr(tnpx, name)(*[_port(a) for a in args],
                                    **{k: _port(v) for k, v in kw.items()}))
    compare(got, want, tol, name)


def test_softmax_temperature_length_and_pick_mode():
    """npx.softmax(temperature=, length=), log_softmax(temperature=) and
    pick(mode=) as the reference: pick clips whatever the mode."""
    x = X[:3]
    length = onp.array([2, 6, 4])
    for t in (None, 1.0, 0.25):
        compare(_host(tnpx.softmax(_port(x), temperature=t,
                                   length=_port(length))),
                _host(jnpx.softmax(_ref(x), temperature=t,
                                   length=_ref(length))), EW, "softmax")
        compare(_host(tnpx.log_softmax(_port(x), axis=0, temperature=t)),
                _host(jnpx.log_softmax(_ref(x), axis=0, temperature=t)),
                EW, "log_softmax")
    idx = onp.array([-3, 2, 9])
    for mode in ("clip", "wrap"):
        compare(_host(tnpx.pick(_port(x), _port(idx), mode=mode)),
                _host(jnpx.pick(_ref(x), _ref(idx), mode=mode)), EXACT,
                "pick")


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
def _arr(m, a):
    """``a`` as the array of the package ``m`` belongs to."""
    return jmx.np.array(a) if m is jnpx else torch.from_numpy(a)


GRADS = [
    ("masked_softmax", lambda m, x: m.masked_softmax(x, _arr(m, MASK)), X),
    ("interleaved_qk", lambda m, x: m.interleaved_matmul_selfatt_qk(x, H),
     QKV),
    ("interleaved_valatt", lambda m, x: m.interleaved_matmul_selfatt_valatt(
        x, _arr(m, ATT), H), QKV),
    ("interleaved_encdec_qk", lambda m, x: m.interleaved_matmul_encdec_qk(
        x, _arr(m, KV), H), Q),
    ("gather_nd", lambda m, x: m.gather_nd(x, _arr(m, GIDX)), X),
    ("topk_value", lambda m, x: m.topk(x, k=3, ret_typ="value"), X),
    ("softmax_length", lambda m, x: m.softmax(
        x, temperature=2.0, length=_arr(m, onp.array([2, 6, 3, 4]))), X),
]


def _reference_grad(f, x0):
    """(f(x), w, d/dx sum(f(x) * w)) by the reference's autograd."""
    jx = jmx.np.array(x0)
    jx.attach_grad()
    with jmx.autograd.record():
        jy = f(jnpx, jx)
        w = onp.linspace(0.5, 1.5, jy.size).reshape(jy.shape).astype(
            onp.float32)
        (jy * jmx.np.array(w)).sum().backward()
    return jy.asnumpy(), w, jx.grad.asnumpy()


@pytest.fixture(scope="module")
def reference_grads():
    """The reference's side of every gradient case, by four threads (the
    reference's autograd tape is per thread)."""
    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(lambda g: _reference_grad(g[1], g[2]), GRADS))


@pytest.mark.parametrize("idx,name,f,x0", [(i,) + g for i, g in
                                           enumerate(GRADS)],
                         ids=[g[0] for g in GRADS])
def test_gradients_match_jax(reference_grads, idx, name, f, x0):
    """d/dx of sum(f(x) * w) by torch autograd against the reference's
    autograd (its jax.vjp tape), within 1e-4."""
    want_y, w, want_g = reference_grads[idx]
    tx = torch.from_numpy(x0.copy()).requires_grad_()
    ty = f(tnpx, tx)
    (ty * torch.from_numpy(w)).sum().backward()
    onp.testing.assert_allclose(ty.detach().numpy(), want_y, rtol=RED,
                                atol=RED)
    onp.testing.assert_allclose(tx.grad.numpy(), want_g, rtol=RED, atol=RED)


# ---------------------------------------------------------------------------
# out-of-range indices
# ---------------------------------------------------------------------------
OOR = [
    ("pick", (X, onp.array([-1, 6, 100, -50])), {}),
    ("gather_nd", (X, onp.array([[-1, 4, -9, 2], [7, -2, 0, -100]])), {}),
    ("scatter_nd", (onp.array([1.0, 2.0, 3.0, 4.0], onp.float32),
                    onp.array([[-1, 4, -9, 0], [1, -2, 0, 9]]), (3, 4)), {}),
    ("one_hot", (onp.array([-1, 0, 4, 9, 3]), 4), {}),
    ("index_add", (X, onp.array([[-1, 4, -9, 0], [1, -2, 0, 9]]),
                   onp.array([1.0, 2.0, 3.0, 4.0], onp.float32)), {}),
    ("index_update", (X, onp.array([[-1, 9, -9, 0], [1, -2, 0, 9]]),
                      onp.array([5.0, 6.0, 7.0, 8.0], onp.float32)), {}),
]


@pytest.mark.parametrize("name,args,kw", OOR, ids=[o[0] for o in OOR])
def test_out_of_range_indices_match_jax(name, args, kw):
    """Negative and too-large indices give the reference's values: gathers
    clamp after one wrap of a negative index, scatters drop what is still
    out of range, one_hot gives an all-off row. torch's own indexing would
    raise (and assert on the card)."""
    want = _host(getattr(jnpx, name)(*[_ref(a) for a in args], **kw))
    got = _host(getattr(tnpx, name)(*[_port(a) for a in args], **kw))
    compare(got, want, EXACT, name)


def test_index_copy_out_of_range_raises_as_the_reference():
    """index_copy checks its indices eagerly and raises MXNetError in both
    packages; inside a CUDA-graph capture the port drops the row, as the
    reference's trace does."""
    idx = onp.array([0, 7])
    new = onp.ones((2, 6), onp.float32)
    with pytest.raises(jmx.base.MXNetError):
        jnpx.index_copy(_ref(X), _ref(idx), _ref(new))
    with pytest.raises(MXNetError, match="index_copy"):
        tnpx.index_copy(_port(X), _port(idx), _port(new))


def test_host_reads_raise_inside_a_capture(monkeypatch):
    """nonzero and boolean_mask refuse to read sizes inside a CUDA-graph
    capture (MXNetError naming them); index_copy drops out-of-range rows
    there instead of checking them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(MXNetError, match="nonzero"):
        tnpx.nonzero(_port(I))
    with pytest.raises(MXNetError, match="boolean_mask"):
        tnpx.boolean_mask(_port(X), torch.tensor([1, 0, 1, 1]))
    out = tnpx.index_copy(_port(X), torch.tensor([1, 9]),
                          torch.full((2, 6), 5.0))
    want = X.copy()
    want[1] = 5.0
    onp.testing.assert_array_equal(out.numpy(), want)


# ---------------------------------------------------------------------------
# initializers, util, files, npx.random
# ---------------------------------------------------------------------------
def _init_both(ref_init, port_init, name, shape):
    jarr = jmx.np.zeros(shape)
    ref_init.init_array(name, jarr)
    tarr = torch.zeros(shape)
    port_init.init_array(name, tarr)
    return tarr.numpy(), jarr.asnumpy()


def test_bilinear_and_lstm_bias_match_jax():
    got, want = _init_both(jmx.init.Bilinear(), tmx.init.Bilinear(),
                           "up_weight", (2, 1, 4, 4))
    onp.testing.assert_array_equal(got, want)
    got, want = _init_both(jmx.init.Bilinear(), tmx.init.Bilinear(),
                           "up_weight", (1, 1, 3, 5))
    onp.testing.assert_array_equal(got, want)
    got, want = _init_both(jmx.init.LSTMBias(2.5), tmx.init.LSTMBias(2.5),
                           "lstm_i2h_bias", (16,))
    onp.testing.assert_array_equal(got, want)
    assert tmx.init.create("bilinear").__class__ is tmx.init.Bilinear
    assert tmx.init.create("lstmbias").__class__ is tmx.init.LSTMBias


def test_load_and_mixed_initializers(tmp_path):
    """Load fills from a .params file of either package (arg:/aux:
    prefixes dropped), falls back to default_init, checks shapes; Mixed
    routes by the first matching pattern, as the reference."""
    w = R.randn(3, 2).astype(onp.float32)
    path = str(tmp_path / "p.params")
    jmx.serialization.save_params(path, {"arg:dense_weight": w})
    for fname_or_dict in (path, {"aux:dense_weight": torch.from_numpy(w)}):
        ld = tmx.init.Load(fname_or_dict, default_init=tmx.init.One())
        arr = torch.zeros(3, 2)
        ld.init_array("dense_weight", arr)
        onp.testing.assert_array_equal(arr.numpy(), w)
        other = torch.zeros(2)
        ld.init_array("other_weight", other)
        assert other.tolist() == [1.0, 1.0]
        with pytest.raises(MXNetError, match="shape"):
            ld.init_array("dense_weight", torch.zeros(2, 3))
    with pytest.raises(MXNetError, match="default_init"):
        tmx.init.Load({}).init_array("x_weight", torch.zeros(1))
    mixed = tmx.init.Mixed([".*bias", ".*"], [tmx.init.Constant(3.0),
                                              tmx.init.One()])
    jmixed = jmx.init.Mixed([".*bias", ".*"], [jmx.init.Constant(3.0),
                                               jmx.init.One()])
    for name in ("fc_bias", "fc_weight"):
        got, want = _init_both(jmixed, mixed, name, (2, 2))
        onp.testing.assert_array_equal(got, want)
    with pytest.raises(MXNetError, match="did not match"):
        tmx.init.Mixed(["^a$"], [tmx.init.One()]).init_array(
            "b", torch.zeros(1))


def test_util_switches_match_jax():
    for name in ("is_np_array", "is_np_shape", "set_np", "reset_np"):
        assert getattr(tmx.util, name)() == getattr(jmx.util, name)()
    f = lambda: 1  # noqa: E731
    assert tmx.util.use_np(f) is f and tmx.util.use_np_array(f) is f
    with tmx.util.np_array(), tmx.util.np_shape():
        pass
    tmx.util.setenv("MXNET_TPU_TEST_UTIL", "7")
    assert tmx.util.getenv("MXNET_TPU_TEST_UTIL") == "7"
    a = tmx.util.default_array([1.0, 2.0], device="cpu")
    assert a.dtype == torch.float32 and a.tolist() == [1.0, 2.0]


def test_npx_save_load_cross_package(tmp_path):
    """npx.save files (a list or a dict of arrays) load in the other
    package, dtypes and values exact."""
    arrays = {"a": X, "b": I}
    p1, p2 = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnpx.save(p1, {k: _ref(v) for k, v in arrays.items()})
    got = tnpx.load(p1, device="cpu")
    for k, v in arrays.items():
        onp.testing.assert_array_equal(got[k].numpy(), v)
    tnpx.save(p2, [_port(X), _port(I)])
    want = jnpx.load(p2)
    onp.testing.assert_array_equal(want[0].asnumpy(), X)
    assert want[1].asnumpy().dtype == onp.int64
    tnpx.save(p2, _port(X))
    assert len(tnpx.load(p2, device="cpu")) == 1


def test_npx_random_samplers():
    """bernoulli by prob or logit (exactly one), uniform_n and normal_n
    with the batch shape before the parameters' broadcast shape: shapes,
    dtypes, the CPU device and moments; npx.random re-exports np.random's
    samplers; a dlpack round trip shares memory."""
    tnpx.seed(5)
    b = tnpx.random.bernoulli(prob=0.25, size=(1 << 15,), device="cpu")
    assert b.dtype == torch.float32 and abs(b.mean().item() - 0.25) < 0.02
    bl = tnpx.bernoulli(logit=torch.tensor([0.0, 2.0]), size=(1 << 14, 2))
    onp.testing.assert_allclose(bl.mean(0).numpy(),
                                [0.5, 1 / (1 + onp.exp(-2.0))], atol=0.02)
    with pytest.raises(MXNetError):
        tnpx.random.bernoulli(prob=0.5, logit=0.0, device="cpu")
    u = tnpx.uniform_n(torch.tensor([0.0, 2.0]), 4.0, batch_shape=(8192, 3))
    assert tuple(u.shape) == (8192, 3, 2)
    onp.testing.assert_allclose(u.mean((0, 1)).numpy(), [2.0, 3.0],
                                atol=0.05)
    n = tnpx.normal_n(1.0, torch.tensor([1.0, 3.0]), batch_shape=8192,
                      dtype="float64")
    assert tuple(n.shape) == (8192, 2) and n.dtype == torch.float64
    onp.testing.assert_allclose(n.std(0).numpy(), [1.0, 3.0], rtol=0.05)
    for name in ("gamma", "choice", "permutation", "multinomial", "seed"):
        assert getattr(tnpx.random, name) is getattr(tmx.np.random, name)
    t = torch.arange(4.0)
    shared = tnpx.from_dlpack(tnpx.to_dlpack_for_write(t))
    shared[0] = 9.0
    assert t[0].item() == 9.0
    assert tnpx.from_dlpack(tnpx.to_dlpack_for_read(t)).tolist() == \
        t.tolist()
