"""Kernel modules of the PyTorch port against the JAX package, on the CPU.

Each port wrapper takes its plain PyTorch version for CPU tensors; the
JAX side runs its Pallas kernel in interpret mode (or its plain path),
as the JAX package's own tests do. Inputs come from a seeded numpy RNG
and reach both packages as numpy arrays. The CUDA kernels themselves run
only on the card and are held against these same plain versions by
``chip_smoke.py``.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops.pallas import fused_decode as jfused
from mxnet_tpu.ops.pallas import layer_norm as jln
from mxnet_tpu.ops.pallas import paged_attention as jpaged
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops.kernels import _build
from mxnet_tpu_torch.ops.kernels import fused_decode as tfused
from mxnet_tpu_torch.ops.kernels import layer_norm as tln
from mxnet_tpu_torch.ops.kernels import paged_attention as tpaged

_T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "int8": torch.int8}


def _t(a, dtype=None):
    """numpy -> CPU torch tensor (bfloat16 arrives as float32 numpy)."""
    t = torch.from_numpy(onp.array(a))
    return t.to(_T_DTYPES[dtype]) if dtype else t


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp_f32(a):
    return onp.asarray(jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# K2: LayerNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,d", [(8, 32), (13, 96), (1, 200)])
def test_layer_norm_matches_jax_kernel(n, d):
    """Port fused_layer_norm (plain version on CPU) against the Pallas
    _ln_kernel in interpret mode: y, mean and rstd, f32 at 2e-5."""
    rng = onp.random.RandomState(n * 1000 + d)
    x = (rng.randn(n, d) * 3 + 1).astype(onp.float32)
    g = rng.randn(d).astype(onp.float32)
    b = rng.randn(d).astype(onp.float32)
    want, (_, _, _, jmean, jrstd) = jln._ln_fwd(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5, True)
    y, mean, rstd = tln.fused_layer_norm(_t(x), _t(g), _t(b), 1e-5)
    assert y.dtype == torch.float32 and tuple(mean.shape) == (n,)
    onp.testing.assert_allclose(y.numpy(), onp.asarray(want), rtol=2e-5,
                                atol=2e-5)
    onp.testing.assert_allclose(mean.numpy(), onp.asarray(jmean), rtol=2e-5,
                                atol=2e-5)
    onp.testing.assert_allclose(rstd.numpy(), onp.asarray(jrstd), rtol=2e-5,
                                atol=2e-5)


def test_layer_norm_op_matches_jax_op_and_no_kernels_path():
    """ops.nn.layer_norm (kernel wrapper) and its no_kernels path both
    match the JAX op on a 3-D input."""
    rng = onp.random.RandomState(3)
    x = rng.randn(2, 5, 48).astype(onp.float32)
    g = rng.randn(48).astype(onp.float32)
    b = rng.randn(48).astype(onp.float32)
    want = onp.asarray(jnn.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                      jnp.asarray(b)))
    got = tnn.layer_norm(_t(x), _t(g), _t(b)).numpy()
    with tnn.no_kernels():
        plain = tnn.layer_norm(_t(x), _t(g), _t(b)).numpy()
    onp.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    onp.testing.assert_allclose(plain, want, rtol=2e-5, atol=2e-5)


def _ln_warp(x, g, b, eps, v):
    """The arithmetic of K2's warp route in torch (f32): vector j (``v``
    values) of a row lies on lane j % 32; each lane sums its values in
    order, vector by vector, and a butterfly over xor 16, 8, 4, 2, 1
    gives every lane the row sum; the mean, then the centred variance the
    same way, rstd = 1 / sqrt(var + eps), y = (x - mean) * rstd * g + b."""
    n, d = x.shape
    lane = (torch.arange(d) // v) % 32

    def warp_sum(t):
        s = torch.zeros(n, 32)
        for i in range(d):
            s[:, lane[i]] += t[:, i]
        for o in (16, 8, 4, 2, 1):
            s = s + s[:, torch.arange(32) ^ o]
        return s[:, 0]

    mean = warp_sum(x) / d
    c = x - mean[:, None]
    var = warp_sum(c * c) / d
    rstd = 1.0 / torch.sqrt(var + eps)
    return c * rstd[:, None] * g + b, mean, rstd


@pytest.mark.parametrize("n,d", [(8, 32), (13, 96), (5, 200), (3, 1024)])
def test_layer_norm_warp_layout_matches_jax_kernel(n, d):
    """K2's warp route (one warp per row, lane-strided 16-byte vectors,
    lane partials, butterfly sums), emulated in torch, against the Pallas
    _ln_kernel in interpret mode: y, mean and rstd, f32 at 2e-6. D 200
    leaves lanes with one vector and lanes with two; D 1024 is the widest
    row the route takes (8 vectors a lane)."""
    rng = onp.random.RandomState(n * 7 + d)
    x = (rng.randn(n, d) * 3 + 1).astype(onp.float32)
    g = rng.randn(d).astype(onp.float32)
    b = rng.randn(d).astype(onp.float32)
    want, (_, _, _, jmean, jrstd) = jln._ln_fwd(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5, True)
    y, mean, rstd = _ln_warp(_t(x), _t(g), _t(b), 1e-5, 4)
    for got, ref in ((y, want), (mean, jmean), (rstd, jrstd)):
        onp.testing.assert_allclose(got.numpy(), onp.asarray(ref),
                                    rtol=2e-6, atol=2e-6)


def test_layer_norm_route_by_width_dtype_and_alignment():
    """The K2 wrapper's choice between its two kernels: the warp route
    for rows of 16-byte multiples on 16-byte-aligned x, gamma and beta
    with D <= 1024, the block route otherwise; ln_launch calls the
    chosen C entry (a stand-in library here) with the row count, width
    and dtype code."""
    class Lib:
        def __init__(self):
            self.calls = []

        def mxt_layer_norm_fwd_warp(self, *args):
            self.calls.append(("warp", args[6], args[7], args[9]))
            return 0

        def mxt_layer_norm_fwd(self, *args):
            self.calls.append(("block", args[6], args[7], args[9]))
            return 0

    def rows(n, d, dtype, offset=0):
        return torch.zeros(n * d + offset, dtype=dtype)[offset:].view(n, d)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((768, f32, 0, 0), "warp"), ((768, bf16, 0, 0), "warp"),
             ((1024, f32, 0, 0), "warp"), ((8, bf16, 0, 0), "warp"),
             ((1028, f32, 0, 0), "block"), ((4096, f32, 0, 0), "block"),
             ((770, f32, 0, 0), "block"), ((772, bf16, 0, 0), "block"),
             ((776, bf16, 0, 0), "warp"), ((768, f32, 1, 0), "block"),
             ((768, bf16, 4, 0), "block"), ((768, f32, 0, 1), "block")]
    lib = Lib()
    for (d, dtype, x_off, g_off), route in cases:
        x = rows(3, d, dtype, x_off)
        gamma, beta = rows(1, d, dtype, g_off)[0], rows(1, d, dtype)[0]
        assert tln.ln_route(x, gamma, beta) == route, (d, dtype, x_off,
                                                       g_off)
        (y, mean, rstd), err = tln.ln_launch(lib, route, x, gamma, beta,
                                             1e-5, 0)
        assert err == 0 and y.shape == x.shape and mean.shape == (3,)
        assert lib.calls[-1] == (route, 3, d, _build.dtype_code(dtype))


# ---------------------------------------------------------------------------
# int8 KV layout
# ---------------------------------------------------------------------------
def _int8_rows_agree(got, want, d):
    """Pool rows [D int8 values | 4 scale bytes]: identical scale bytes,
    values within one quantization step. Returns the count of values that
    differ (near-tie roundings after a different f32 summation order)."""
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.dtype == onp.int8 and want.dtype == onp.int8
    assert got.shape == want.shape
    onp.testing.assert_array_equal(got[..., d:], want[..., d:])
    diff = onp.abs(got[..., :d].astype(onp.int32)
                   - want[..., :d].astype(onp.int32))
    assert diff.max() <= 1, diff.max()
    return int((diff > 0).sum())


def test_kv_cache_quantize_bytes_match_jax():
    """Same input -> byte-identical int8 rows (the scale's bitcast bytes
    included; no f32 sums are involved, so no value may differ), and the
    dequantized values match. The reference is compiled, as every caller
    in the JAX package runs it (XLA turns ``amax / 127`` into a multiply
    by the f32 reciprocal; the port follows the compiled form)."""
    rng = onp.random.RandomState(4)
    t = (rng.randn(3, 4, 5, 16) * 2).astype(onp.float32)
    t[0, 0, 0] = 0.0                          # the 1e-6 scale floor
    t[1, 1, 1, 3] = 127.0 * 0.5               # exact half -> round-to-even
    want = onp.asarray(jax.jit(jnn.kv_cache_quantize)(jnp.asarray(t)))
    got = tnn.kv_cache_quantize(_t(t)).numpy()
    assert got.shape == (3, 4, 5, 20)
    assert _int8_rows_agree(got, want, 16) == 0
    deq_want = onp.asarray(jnn.kv_cache_dequantize(jnp.asarray(want),
                                                   jnp.float32))
    deq_got = tnn.kv_cache_dequantize(_t(want), torch.float32).numpy()
    onp.testing.assert_array_equal(deq_got, deq_want)


# ---------------------------------------------------------------------------
# K4: paged attention
# ---------------------------------------------------------------------------
def _paged_inputs(seed, pool_dtype):
    rng = onp.random.RandomState(seed)
    r, h, d, bs, nb, mb = 3, 4, 16, 8, 10, 4
    q = rng.randn(r, h, d).astype(onp.float32)
    kp = rng.randn(nb, h, bs, d).astype(onp.float32)
    vp = rng.randn(nb, h, bs, d).astype(onp.float32)
    bt = rng.randint(0, nb, (r, mb)).astype(onp.int32)
    lens = onp.array([5, 17, 32], onp.int32)
    if pool_dtype == "int8":
        kp = onp.asarray(jnn.kv_cache_quantize(jnp.asarray(kp)))
        vp = onp.asarray(jnn.kv_cache_quantize(jnp.asarray(vp)))
    return q, kp, vp, bt, lens


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2),
                                       ("int8", 2e-5)])
def test_paged_attention_matches_jax(dtype, tol):
    """Port paged_attention_kernel (plain version on CPU) against the
    Pallas _paged_kernel in interpret mode, and the port's plain path
    against the JAX gather path (use_kernel=False), f32/bf16/int8 pools
    as in tests/test_llm_serving.py."""
    q, kp, vp, bt, lens = _paged_inputs(7, dtype)
    qdt = "float32" if dtype == "int8" else dtype
    jq = jnp.asarray(q, qdt)
    jk, jv = jnp.asarray(kp, dtype), jnp.asarray(vp, dtype)
    jbt, jlen = jnp.asarray(bt), jnp.asarray(lens)
    want_kernel = jpaged.paged_attention_kernel(jq, jk, jv, jbt, jlen,
                                                interpret=True)
    want_plain = jnn.paged_attention(jq, jk, jv, jbt, jlen, use_kernel=False)
    # the same (bf16-rounded) values on the port's side
    tq = _t(_jnp_f32(jq), qdt)
    if dtype == "int8":
        tk, tv = _t(kp), _t(vp)
    else:
        tk, tv = _t(_jnp_f32(jk), dtype), _t(_jnp_f32(jv), dtype)
    got_kernel = tpaged.paged_attention_kernel(tq, tk, tv, _t(bt), _t(lens))
    got_plain = tnn.paged_attention(tq, tk, tv, _t(bt), _t(lens),
                                    use_kernel=False)
    out_dtype = torch.float32 if dtype == "int8" else _T_DTYPES[dtype]
    assert got_kernel.dtype == out_dtype and got_plain.dtype == out_dtype
    for got, want in ((got_kernel, want_kernel), (got_plain, want_plain)):
        onp.testing.assert_allclose(_np(got), _jnp_f32(want), rtol=tol,
                                    atol=tol)


def _paged_split(q, k_pool, v_pool, block_table, lengths, span):
    """The arithmetic of the split K4 kernel in torch: for each (lane,
    head), each span of ``span`` pool blocks gives an exact-softmax
    partial (m, l, acc) over its positions, positions at or past the
    lane's length (capped at MB * bs) masked with the finite -1e30; the
    partials are merged in span order with a max(l, 1e-30) denominator.
    A lane of length 0 gives 0."""
    r, h, d = q.shape
    bs, mb = k_pool.shape[2], block_table.shape[1]
    if k_pool.dtype == torch.int8:
        kf = tnn.kv_cache_dequantize(k_pool, torch.float32)
        vf = tnn.kv_cache_dequantize(v_pool, torch.float32)
    else:
        kf, vf = k_pool.float(), v_pool.float()
    out = torch.zeros(r, h, d)
    for lane in range(r):
        n = min(int(lengths[lane]), mb * bs)
        parts = []
        for b0 in range(0, mb, span):
            if b0 * bs >= n:
                break
            blocks = block_table[lane, b0:b0 + span].long()
            k = kf[blocks].transpose(0, 1).reshape(h, -1, d)   # (H, P, D)
            v = vf[blocks].transpose(0, 1).reshape(h, -1, d)
            pos = b0 * bs + torch.arange(k.shape[1])
            s = torch.einsum("hd,hpd->hp", q[lane].float(), k) * d ** -0.5
            s = torch.where(pos < n, s, torch.full_like(s, -1e30))
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("hp,hpd->hd", p, v)))
        if not parts:
            continue
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        l_all, acc = torch.zeros(h, 1), torch.zeros(h, d)
        for m, l, a in parts:
            w = torch.exp(m - m_all)
            l_all, acc = l_all + l * w, acc + a * w
        out[lane] = acc / torch.clamp(l_all, min=1e-30)
    return out


_SPLIT_INPUTS = {}


def _paged_split_inputs(pool_dtype):
    """r 3, h 4, d 16, bs 8, mb 6 inputs, made once per pool dtype."""
    if pool_dtype not in _SPLIT_INPUTS:
        rng = onp.random.RandomState(31)
        r, h, d, bs, nb, mb = 3, 4, 16, 8, 20, 6
        q = rng.randn(r, h, d).astype(onp.float32)
        kp = rng.randn(nb, h, bs, d).astype(onp.float32)
        vp = rng.randn(nb, h, bs, d).astype(onp.float32)
        bt = rng.permutation(nb)[:r * mb].reshape(r, mb).astype(onp.int32)
        if pool_dtype == "int8":
            kp = onp.asarray(jnn.kv_cache_quantize(jnp.asarray(kp)))
            vp = onp.asarray(jnn.kv_cache_quantize(jnp.asarray(vp)))
        _SPLIT_INPUTS[pool_dtype] = (q, kp, vp, bt)
    return _SPLIT_INPUTS[pool_dtype]


@pytest.mark.parametrize("pool_dtype", ["float32", "int8"])
@pytest.mark.parametrize("span", [1, 2, 4])
def test_paged_split_merge_matches_jax_kernel(span, pool_dtype):
    """The split-and-merge arithmetic of the CUDA K4 kernel (a span of
    pool blocks per block of the grid, partials merged in span order),
    emulated in torch, against the Pallas _paged_kernel in interpret mode
    and the port's paged_attention_plain, at 2e-5: lengths 1, span - 1,
    span, span + 1 positions, MB * bs and above MB * bs (capped)."""
    q, kp, vp, bt = _paged_split_inputs(pool_dtype)
    bs, mb = kp.shape[2], bt.shape[1]
    sp = span * bs
    for lens in ([1, sp - 1, sp], [sp + 1, mb * bs, mb * bs + 5]):
        lens = onp.array(lens, onp.int32)
        want = jpaged.paged_attention_kernel(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(lens), interpret=True)
        tq, tk, tv, tbt, tl = _t(q), _t(kp), _t(vp), _t(bt), _t(lens)
        got = _paged_split(tq, tk, tv, tbt, tl, span)
        plain = tpaged.paged_attention_plain(tq, tk, tv, tbt, tl)
        onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                    rtol=2e-5, atol=2e-5)
        onp.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                                    atol=2e-5)


def test_paged_workspace_is_sized_by_the_span_and_kept():
    """The K4 wrapper's workspace: R*H*S*(D+2) f32 partials and R*H int32
    counters at 0, S = ceil(MB / span) from the library, one pair per
    device, stream and shape."""
    class Lib:
        _span_blocks = 8

    tpaged._WORKSPACES.clear()
    dev = torch.device("cpu")
    ws, cnt = tpaged._workspace(Lib, dev, 0, 96, 128, 64)
    assert ws.dtype == torch.float32 and ws.numel() == 96 * 16 * 66
    assert cnt.dtype == torch.int32 and cnt.numel() == 96
    assert not cnt.any()
    assert tpaged._workspace(Lib, dev, 0, 96, 128, 64)[0] is ws
    assert tpaged._workspace(Lib, dev, 0, 96, 129, 64)[0].numel() \
        == 96 * 17 * 66
    assert tpaged._workspace(Lib, dev, 1, 96, 128, 64)[0] is not ws
    tpaged._WORKSPACES.clear()


# ---------------------------------------------------------------------------
# K5a / K5b: fused projections
# ---------------------------------------------------------------------------
def _dyadic(rng, shape, denom):
    """Small multiples of 1/denom: every product and partial sum of the
    projections below is exact in f32, so any summation order gives the
    same bits (the K/V amax and hence the scale bytes included)."""
    return (rng.randint(-4, 5, shape) / denom).astype(onp.float32)


def _proj_inputs(seed, kind, n=5, u=32):
    rng = onp.random.RandomState(seed)
    if kind == "dyadic":
        return (_dyadic(rng, (n, u), 4), _dyadic(rng, (3 * u, u), 8),
                _dyadic(rng, (3 * u,), 4))
    return (rng.randn(n, u).astype(onp.float32),
            (rng.randn(3 * u, u) * 0.3).astype(onp.float32),
            rng.randn(3 * u).astype(onp.float32))


@pytest.mark.parametrize("store", ["float32", "int8"])
@pytest.mark.parametrize("kind", ["normal", "dyadic"])
def test_qkv_project_matches_jax(store, kind):
    """Port fused_qkv_project against the Pallas _qkv_kernel (interpret):
    q and f32 K/V at 2e-5. int8 K/V: on inputs whose projection is exact
    (dyadic) the rows are byte-identical, scale bytes included (0 of 320
    values differ). On normal inputs torch and XLA sum the f32 products
    in another order, so about half of the 40 scales differ in the last
    bit (rtol 1e-6) and values by at most one quantization step: 0 of the
    320 values differ at this seed, and the test allows 2."""
    x, w, b = _proj_inputs(11, kind)
    heads, d = 4, 8
    jd = jnp.int8 if store == "int8" else jnp.float32
    jq, jk, jv = jfused.fused_qkv_project(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), heads=heads,
        store_dtype=jd, interpret=True)
    q, k, v = tfused.fused_qkv_project(_t(x), _t(w), _t(b), heads=heads,
                                       store_dtype=_T_DTYPES[store])
    onp.testing.assert_allclose(q.numpy(), onp.asarray(jq), rtol=2e-5,
                                atol=2e-5)
    if store == "float32":
        for got, want in ((k, jk), (v, jv)):
            onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                        rtol=2e-5, atol=2e-5)
        return
    assert tuple(k.shape) == (5, heads, d + 4)
    if kind == "dyadic":
        # 2 * 5 * 4 * 8 = 320 values: none may differ
        assert _int8_rows_agree(k.numpy(), jk, d) == 0
        assert _int8_rows_agree(v.numpy(), jv, d) == 0
        return
    n_diff = 0
    for got, want in ((k, jk), (v, jv)):
        got, want = got.numpy(), onp.asarray(want)
        sg = got[..., d:].copy().view(onp.float32)
        sw = want[..., d:].copy().view(onp.float32)
        onp.testing.assert_allclose(sg, sw, rtol=1e-6, atol=0)
        steps = onp.abs(got[..., :d].astype(onp.int32)
                        - want[..., :d].astype(onp.int32))
        assert steps.max() <= 1, steps.max()
        n_diff += int((steps > 0).sum())
    assert n_diff <= 2, n_diff


def test_rounding_probe_rows_are_the_reference_rows():
    """chip_smoke.py holds the K5a kernel's int8 K/V to the rows of
    ``qkv_rounding_probe``, whose values lie on or one ulp beside
    half-way points. Those expected rows are the reference's, byte for
    byte: the JAX quantizer (compiled) and the Pallas _qkv_kernel
    (interpret) give them, and so does the port's plain K5a. Each wrong
    rounding the probe names would differ on at least 5% of the values."""
    import chip_smoke

    u, heads, n = 96, 4, 5
    d = u // heads
    x, w, b, q, rows, wrong = chip_smoke.qkv_rounding_probe(u, heads, n)
    vals = (x @ w.T + b)[:, u:].reshape(n, 2, heads, d)   # exact: one-hot x
    onp.testing.assert_array_equal(
        onp.asarray(jax.jit(jnn.kv_cache_quantize)(jnp.asarray(vals))), rows)
    jq, jk, jv = jfused.fused_qkv_project(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), heads=heads,
        store_dtype=jnp.int8, interpret=True)
    onp.testing.assert_array_equal(onp.asarray(jq), q)
    onp.testing.assert_array_equal(onp.asarray(jk), rows[:, 0])
    onp.testing.assert_array_equal(onp.asarray(jv), rows[:, 1])
    chip_smoke.rounding_probe_check(torch, torch.device("cpu"), u, heads, n)
    assert min(wrong.values()) >= 0.05 * vals.size, wrong


def _qkv_cluster(x, w, b, heads, c):
    """The arithmetic of K5a's cluster route in torch (f32): block k of
    a (Q|K|V, head) cluster of ``c`` owns features [k*D//c, (k+1)*D//c);
    each K or V block takes its partial amax per token over its features,
    the scale is max(the c partials, 1e-6) * f32(1/127), and each block
    quantizes its own features (round half to even of y / scale, clamped
    to ±127); rank 0 writes the scale's bytes."""
    n, u = x.shape
    d = u // heads
    y = (x @ w.T + b).reshape(n, 3, heads, d)
    q = y[:, 0]
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)
    rows = []
    for which in (1, 2):
        t = y[:, which]
        bounds = [k * d // c for k in range(c + 1)]
        parts = [t[..., lo:hi].abs().amax(-1)
                 for lo, hi in zip(bounds, bounds[1:]) if hi > lo]
        scale = torch.clamp(torch.stack(parts).amax(0), min=1e-6) * inv127
        vals = torch.empty(n, heads, d, dtype=torch.int8)
        for lo, hi in zip(bounds, bounds[1:]):
            vals[..., lo:hi] = torch.clamp(torch.round(
                t[..., lo:hi] / scale[..., None]), -127, 127).to(torch.int8)
        rows.append(torch.cat([vals, scale[..., None].contiguous()
                               .view(torch.int8)], -1))
    return q, rows[0], rows[1]


@pytest.mark.parametrize("kind", ["normal", "dyadic"])
@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_qkv_cluster_split_matches_jax_kernel(c, kind):
    """The cluster split of the CUDA K5a kernel (about D/C features a
    block, a partial amax per block, the max over the C partials, then
    the quantize), emulated in torch, against the Pallas _qkv_kernel in
    interpret mode, at D 12 (C 8 splits it unevenly: blocks of 1 and 2
    features). Dyadic inputs (exact in any summation order): q and the
    int8 K/V rows byte-identical, scale bytes included. Normal inputs:
    q at 2e-5, and the int8 rows as test_qkv_project_matches_jax holds
    them (scales within 1e-6 relative, values one step apart at most, at
    most 2 of 240 differing)."""
    x, w, b = _proj_inputs(17, kind, n=5, u=48)
    heads, d = 4, 12
    jq, jk, jv = jfused.fused_qkv_project(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), heads=heads,
        store_dtype=jnp.int8, interpret=True)
    q, k, v = _qkv_cluster(_t(x), _t(w), _t(b), heads, c)
    if kind == "dyadic":
        onp.testing.assert_array_equal(q.numpy(), onp.asarray(jq))
        onp.testing.assert_array_equal(k.numpy(), onp.asarray(jk))
        onp.testing.assert_array_equal(v.numpy(), onp.asarray(jv))
        return
    onp.testing.assert_allclose(q.numpy(), onp.asarray(jq), rtol=2e-5,
                                atol=2e-5)
    n_diff = 0
    for got, want in ((k, jk), (v, jv)):
        got, want = got.numpy(), onp.asarray(want)
        sg = got[..., d:].copy().view(onp.float32)
        sw = want[..., d:].copy().view(onp.float32)
        onp.testing.assert_allclose(sg, sw, rtol=1e-6, atol=0)
        steps = onp.abs(got[..., :d].astype(onp.int32)
                        - want[..., :d].astype(onp.int32))
        assert steps.max() <= 1, steps.max()
        n_diff += int((steps > 0).sum())
    assert n_diff <= 2, n_diff


def test_out_project_matches_jax():
    """Port fused_out_project against the Pallas _out_kernel (interpret),
    with and without bias, at 2e-5."""
    rng = onp.random.RandomState(12)
    a = rng.randn(6, 32).astype(onp.float32)
    w = (rng.randn(32, 32) * 0.3).astype(onp.float32)
    b = rng.randn(32).astype(onp.float32)
    for bias in (b, None):
        want = jfused.fused_out_project(
            jnp.asarray(a), jnp.asarray(w),
            None if bias is None else jnp.asarray(bias), interpret=True)
        got = tfused.fused_out_project(_t(a), _t(w),
                                       None if bias is None else _t(bias))
        onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                    rtol=2e-5, atol=2e-5)


def _out_ring(a, w, b, rows, stages, warps=8):
    """The arithmetic of K5b's ring route in torch (f32): block k owns
    weight rows [k*rows, (k+1)*rows) (the last block fewer), its row
    groups of 4 rows come in ``stages`` copies of whole groups, and warp
    p sums, over every row of a stage, the 16-byte vectors j of U_in with
    (j // 32) % warps == p. The warps' sums of a row are added in warp
    order, then the bias; tokens go in chunks of 8."""
    n, u_in = a.shape
    u_out = w.shape[0]
    groups = -(-rows // 4)
    cg = -(-groups // stages)                     # row groups a stage
    vec = 16 // a.element_size()
    share = torch.arange(u_in) // vec // 32 % warps
    out = torch.empty(n, u_out)
    for n0 in range(0, n, 8):
        x = a[n0:n0 + 8].float()
        for o0 in range(0, u_out, rows):
            slab = w[o0:o0 + rows].float()
            for r0 in range(0, slab.shape[0], cg * 4):     # a stage
                ws = slab[r0:r0 + cg * 4]
                y = torch.zeros(x.shape[0], ws.shape[0])
                for p in range(warps):
                    y = y + x[:, share == p] @ ws[:, share == p].T
                if b is not None:
                    y = y + b[o0 + r0:o0 + r0 + ws.shape[0]].float()
                out[n0:n0 + 8, o0 + r0:o0 + r0 + ws.shape[0]] = y
    return out.to(a.dtype)


@pytest.mark.parametrize("kind", ["normal", "dyadic"])
@pytest.mark.parametrize("n,u,rows,stages", [
    (5, 292, 6, 2), (20, 292, 8, 2), (20, 292, 12, 4), (5, 292, 4, 1),
    (20, 292, 16, 1)])
def test_out_project_split_matches_jax_kernel(n, u, rows, stages, kind):
    """The row ownership and share order of the CUDA K5b ring route,
    emulated in torch, against the Pallas _out_kernel in interpret mode
    at U 292 (no block size divides it: the last block is ragged; 73
    vectors a row, so three of the eight warps share a row's sum), 5
    tokens and 20 (three chunks of 8), one to three stages. Dyadic inputs
    (exact in any summation order): byte-identical. Normal inputs: f32
    sums of 292 terms in another order, at 2e-5."""
    rng = onp.random.RandomState(19)
    if kind == "dyadic":
        a, w, b = (_dyadic(rng, (n, u), 4), _dyadic(rng, (u, u), 64),
                   _dyadic(rng, (u,), 4))
    else:
        a = rng.randn(n, u).astype(onp.float32)
        w = (rng.randn(u, u) * 0.1).astype(onp.float32)
        b = rng.randn(u).astype(onp.float32)
    want = onp.asarray(jfused.fused_out_project(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = _out_ring(_t(a), _t(w), _t(b), rows, stages).numpy()
    if kind == "dyadic":
        onp.testing.assert_array_equal(got, want)
    else:
        onp.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_out_geometry_reports_the_route(monkeypatch):
    """out_geometry passes (U_in, U_out, dtype code) to mxt_out_geometry
    (a stand-in library here) and names what it reports: the ring route
    with its slab resident, the ring walking the rows (fewer slots than
    stages), the row route; a refused shape raises."""
    reports = {768: [1, 6, 1, 2, 2, 128, 50112, 256],
               4096: [1, 6, 1, 2, 1, 683, 198336, 256],
               8192: [0, 6, 0, 0, 0, 128, 0, 256]}

    class Lib:
        def __init__(self):
            self.calls = []

        def mxt_out_geometry(self, u_in, u_out, dtype, geo):
            self.calls.append((u_in, u_out, dtype))
            if u_in not in reports:
                return -1
            for i, v in enumerate(reports[u_in]):
                geo[i] = v
            return 0

    lib = Lib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    ring = tfused.out_geometry(768, 768, torch.float32)
    assert ring == dict(route="ring", rows=6, stage_groups=1, stages=2,
                        slots=2, blocks=128, smem=50112, threads=256,
                        walks=False)
    walking = tfused.out_geometry(4096, 4096, torch.bfloat16)
    assert walking["route"] == "ring" and walking["walks"]
    row = tfused.out_geometry(8192, 768, torch.float32)
    assert row["route"] == "row" and not row["walks"]
    assert lib.calls == [(768, 768, 0), (4096, 4096, 1), (8192, 768, 0)]
    with pytest.raises(Exception, match="out_geometry"):
        tfused.out_geometry(770, 768, torch.float32)


@pytest.mark.parametrize("store", ["float32", "int8"])
def test_fused_decode_step_matches_jax(store):
    """The whole fused sublayer step (K5a -> pool write -> K4 -> K5b)
    against the JAX fused_decode_step in interpret mode: output at 2e-5
    (f32) / 2e-4 (int8 round trip); the written pools agree (byte for
    byte for int8: the projection inputs are dyadic, see _dyadic)."""
    rng = onp.random.RandomState(13)
    r, u, heads, bs, nb, mb = 3, 32, 4, 4, 9, 4
    x = _dyadic(rng, (r, 1, u), 4)
    wq, bq = _dyadic(rng, (3 * u, u), 8), _dyadic(rng, (3 * u,), 4)
    wo = (rng.randn(u, u) * 0.3).astype(onp.float32)
    bo = rng.randn(u).astype(onp.float32)
    d = u // heads
    pool = rng.randn(nb, heads, bs, d).astype(onp.float32)
    if store == "int8":
        pool = onp.asarray(jnn.kv_cache_quantize(jnp.asarray(pool)))
    bt = onp.array([[0, 1, 8, 8], [2, 3, 4, 8], [5, 8, 8, 8]], onp.int32)
    pos = onp.array([2, 9, 0], onp.int32)
    jout, jpk, _ = jfused.fused_decode_step(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(bq), jnp.asarray(wo),
        jnp.asarray(bo), jnp.asarray(pool), jnp.asarray(pool),
        jnp.asarray(bt), jnp.asarray(pos), heads=heads, units=u,
        interpret=True)
    tpk, tpv = _t(pool.copy()), _t(pool.copy())
    out, tpk, _ = tfused.fused_decode_step(
        _t(x), _t(wq), _t(bq), _t(wo), _t(bo), tpk, tpv, _t(bt), _t(pos),
        heads=heads, units=u)
    tol = 2e-4 if store == "int8" else 2e-5
    onp.testing.assert_allclose(out.numpy(), onp.asarray(jout), rtol=tol,
                                atol=tol)
    if store == "int8":
        assert _int8_rows_agree(tpk.numpy(), jpk, d) == 0
    else:
        onp.testing.assert_allclose(tpk.numpy(), onp.asarray(jpk),
                                    rtol=2e-5, atol=2e-5)


def test_fused_gate(monkeypatch):
    """auto arms for CUDA devices and stays off on the CPU; env 0/1 win;
    no_kernels always disarms."""
    monkeypatch.setenv("MXNET_TPU_LLM_FUSED_DECODE", "auto")
    assert tfused.fused_decode_armed(torch.device("cpu")) is False
    assert tfused.fused_decode_armed(torch.device("cuda", 0)) is True
    monkeypatch.setenv("MXNET_TPU_LLM_FUSED_DECODE", "1")
    assert tfused.fused_decode_armed(torch.device("cpu")) is True
    with tnn.no_kernels():
        assert tfused.fused_decode_armed(torch.device("cuda", 0)) is False
    monkeypatch.setenv("MXNET_TPU_LLM_FUSED_DECODE", "0")
    assert tfused.fused_decode_armed(torch.device("cuda", 0)) is False


def test_wrappers_dispatch_by_device_and_count_only_launches():
    """CPU tensors take the plain version and count no launch; tensors on
    an unsupported device or on mixed devices raise instead of falling
    back."""
    before = tln.fused_layer_norm.launches
    x = torch.randn(4, 8)
    tln.fused_layer_norm(x, torch.ones(8), torch.zeros(8))
    assert tln.fused_layer_norm.launches == before
    with pytest.raises(Exception, match="no kernel for device"):
        _build.on_cpu("k", torch.empty(2, device="meta"))
    with pytest.raises(Exception, match="several devices"):
        _build.on_cpu("k", torch.empty(2), torch.empty(2, device="meta"))
