"""Speculative decoding and the shared-prefix block cache of the PyTorch
port against the JAX package, on the CPU.

At the reference tests' tiny sizes (``tests/test_llm_serving.py``: vocab
37, units 16, 4 heads, a 2-layer target and a 1-layer draft; engines of
4 lanes, block 4, ``max_context`` 32): the chain hashes, the multi-token
paged attention, the acceptance rule (greedy, and sampled on JAX's own
draws), the suffix-prefill, draft and verify programs, and whole
engines. Weights are drawn from a seeded numpy RNG, set into the JAX
models and carried into the port with ``from_jax_params``; the draft
shares the target's embeddings, layer 0 and final LayerNorm (the
truncated-stack draft of ``benchmark/llm_serve_bench.py`` ``make_draft``).
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo import generation as jgen
from mxnet_tpu.ops.nn import kv_cache_quantize as jquantize
from mxnet_tpu.ops.nn import paged_attention_multi as jmulti
from mxnet_tpu.serving import kv_hash as jhash
from mxnet_tpu.serving.llm import LLMEngine as JEngine
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import generation as tgen
from mxnet_tpu_torch.ops.nn import paged_attention_multi as tmulti
from mxnet_tpu_torch.serving import kv_hash as thash
from mxnet_tpu_torch.serving.llm import LLMEngine as TEngine

V = 37
CFG = dict(vocab_size=V, units=16, hidden_size=32, num_heads=4,
           max_length=64)
ENGINE = dict(max_running=4, block_size=4, max_context=32)
BS, NB, MB, K = 4, 24, 8, 3


def _t(a):
    return torch.from_numpy(onp.array(a))


@pytest.fixture(scope="module")
def models():
    """(JAX target, JAX draft, port target, port draft)."""
    jnet = jbert.gpt_like(num_layers=2, dropout=0.0, **CFG)
    rng = onp.random.RandomState(70)
    params = {}
    for name, p in jnet.collect_params().items():
        scale = 0.1 if name.endswith((".gamma", ".beta", ".bias")) else 0.3
        params[name] = (scale * rng.randn(*p.shape)
                        + name.endswith(".gamma")).astype(onp.float32)
        p.set_data(params[name])
    jdraft = jbert.gpt_like(num_layers=1, dropout=0.0, **CFG)
    dparams = {name: params[name]
               for name in jdraft.collect_params().keys()}
    for name, p in jdraft.collect_params().items():
        p.set_data(dparams[name])
    tnet = tbert.gpt_like(device="cpu", num_layers=2, **CFG)
    from_jax_params(params, tnet)
    tdraft = tbert.gpt_like(device="cpu", num_layers=1, **CFG)
    from_jax_params(dparams, tdraft)
    return jnet, jdraft, tnet, tdraft


def _pools(rng, layers, kv):
    """The same (L, NB+1, H, bs, D') K and V pools for both packages."""
    shape = (layers, NB + 1, 4, BS, 4)
    k, v = (rng.randn(*shape).astype(onp.float32) for _ in range(2))
    if kv == "int8":
        q = jax.jit(jquantize)
        k, v = onp.asarray(q(jnp.asarray(k))), onp.asarray(q(jnp.asarray(v)))
    return k, v


def _state(rng, r, lengths):
    """Block tables of distinct blocks per lane (trash NB past them)."""
    bt = onp.full((r, MB), NB, onp.int32)
    bt[:, :MB - 1] = rng.permutation(NB)[:r * (MB - 1)].reshape(r, -1)
    return bt, onp.asarray(lengths, onp.int32)


def _pools_close(got, want, kv):
    """f32 pools to 1e-5; int8 pools at most one quantization step
    apart, on at most 1% of the values, with scales to 1e-5."""
    got = onp.asarray(got)
    want = onp.asarray(want)
    if kv == "float32":
        onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    vals = got[..., :-4].astype(onp.int32) - want[..., :-4].astype(onp.int32)
    assert onp.abs(vals).max() <= 1
    assert (vals != 0).mean() <= 0.01, (vals != 0).mean()
    onp.testing.assert_allclose(
        got[..., -4:].copy().view(onp.float32),
        want[..., -4:].copy().view(onp.float32), rtol=1e-5, atol=1e-8)


def test_chain_hashes_and_prefix_key_are_the_reference_bytes():
    rng = onp.random.RandomState(1)
    for n, bs, limit in ((0, 4, None), (3, 4, None), (17, 4, None),
                         (40, 16, None), (33, 8, 2), (12, 4, 0)):
        prompt = rng.randint(0, 32000, (n,))
        for dtype in (onp.int64, onp.int32):
            got = thash.chain_hashes(prompt.astype(dtype), bs, limit=limit)
            assert got == jhash.chain_hashes(prompt, bs, limit=limit)
        for depth in (1, 4):
            assert thash.prefix_key(prompt, bs, depth) == \
                jhash.prefix_key(prompt, bs, depth)
    h = thash.chain_hashes(onp.arange(8), 4)
    assert [thash.hash_hex(x) for x in h] == [jhash.hash_hex(x) for x in h]
    with pytest.raises(ValueError):
        thash.chain_hashes([1, 2], 0)


@pytest.mark.parametrize("kernel", [None, True])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_paged_attention_multi_matches_jax(kv, kernel):
    """(R, T) queries through the pools: the gathered dense view
    (``use_kernel=None`` on the CPU) and the K4 wrapper's plain version
    over R*T virtual lanes (``True``) against the JAX function, 1e-5."""
    rng = onp.random.RandomState(2)
    k, v = _pools(rng, 1, kv)
    k, v = k[0], v[0]
    r, t = 3, 5
    q = rng.randn(r, t, 4, 4).astype(onp.float32)
    bt, pos = _state(rng, r, [0, 9, 22])
    want = onp.asarray(jmulti(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(bt), jnp.asarray(pos),
                              use_kernel=False))
    got = tmulti(_t(q), _t(k), _t(v), _t(bt), _t(pos), use_kernel=kernel)
    assert got.shape == (r, t, 4, 4)
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", [(True, 1.0, 0), (False, 1.0, 0),
                                    (False, 0.7, 5)])
def test_policy_probs_match_jax(policy):
    rng = onp.random.RandomState(3)
    lg = (rng.randn(3, 4, V) * 2).astype(onp.float32)
    want = onp.asarray(jgen._policy_probs(jnp.asarray(lg), *policy))
    got = tgen._policy_probs(_t(lg), *policy).numpy()
    onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _windows(seed, r):
    """Target and draft logits and draft tokens whose first few match
    the target's argmax in some lanes (every n_acc from 0 to K)."""
    rng = onp.random.RandomState(seed)
    tl = (rng.randn(r, K + 1, V) * 1.5).astype(onp.float32)
    dl = (rng.randn(r, K, V) * 1.5).astype(onp.float32)
    toks = rng.randint(0, V, (r, K)).astype(onp.int32)
    best = tl.argmax(-1)
    for i in range(r):
        m = i % (K + 1)
        toks[i, :m] = best[i, :m]
    return tl, dl, toks


# the reference's acceptance under one jit (its engine's programs run it
# compiled; op by op it compiles each op on its first call)
_jspec_accept = jax.jit(jgen._spec_accept, static_argnums=(4, 5, 6))


def test_spec_accept_greedy_exact():
    tl, dl, toks = _windows(4, 12)
    j_out, j_n = _jspec_accept(jnp.asarray(tl), jnp.asarray(dl),
                               jnp.asarray(toks), jax.random.PRNGKey(0),
                               True, 1.0, 0)
    t_out, t_n = tgen._spec_accept(_t(tl), _t(dl), _t(toks), None, True,
                                   1.0, 0)
    onp.testing.assert_array_equal(t_n.numpy(), onp.asarray(j_n))
    onp.testing.assert_array_equal(t_out.numpy(), onp.asarray(j_out))
    assert sorted(set(t_n.tolist())) == list(range(K + 1))


@pytest.mark.parametrize("policy", [(1.0, 0), (0.7, 5)])
def test_spec_accept_sampled_on_jax_draws_exact(policy):
    """The port's acceptance fed the uniform and Gumbel draws JAX takes
    from the same key: the same tokens and n_acc, lane by lane."""
    r = 64
    tl, dl, _ = _windows(5, r)
    q = onp.asarray(jgen._policy_probs(jnp.asarray(dl), False, *policy))
    rng = onp.random.RandomState(6)
    toks = onp.stack([[rng.choice(V, p=q[i, j] / q[i, j].sum())
                       for j in range(K)] for i in range(r)]).astype(onp.int32)
    key = jax.random.PRNGKey(11)
    j_out, j_n = _jspec_accept(jnp.asarray(tl), jnp.asarray(dl),
                               jnp.asarray(toks), key, False, *policy)
    _, ku, kr = jax.random.split(key, 3)
    # the reference runs with x64 on: u is float64; categorical's noise
    # takes the logits' float32
    u = onp.asarray(jax.random.uniform(ku, (r, K)))
    g = onp.asarray(jax.random.gumbel(kr, (r, V), jnp.float32))
    t_out, t_n = tgen._spec_accept_draws(_t(tl), _t(dl), _t(toks), _t(u),
                                         _t(g), False, *policy)
    onp.testing.assert_array_equal(t_n.numpy(), onp.asarray(j_n))
    onp.testing.assert_array_equal(t_out.numpy(), onp.asarray(j_out))
    assert len(set(t_n.tolist())) > 1


def test_spec_accept_sampled_marginal_is_the_target_policy():
    """Drawn from a torch.Generator over 4000 lanes in one call, the
    first emitted token follows the target's distribution within 0.03
    (the bound of the reference's test_spec_rejection_sampling_
    distribution), though the draft proposes from another."""
    rng = onp.random.RandomState(3)
    v, n = 8, 4000
    tl = torch.from_numpy((rng.randn(1, K, v) * 1.5).astype(onp.float32))
    dl = torch.from_numpy((rng.randn(1, K - 1, v) * 1.5).astype(onp.float32))
    p = tgen._policy_probs(tl, False, 1.0, 0)[0, 0]
    q = tgen._policy_probs(dl, False, 1.0, 0)[0]
    gen = torch.Generator().manual_seed(0)
    toks = torch.stack([torch.multinomial(q[j], n, replacement=True,
                                          generator=gen)
                        for j in range(K - 1)], 1).to(torch.int32)
    out, _ = tgen._spec_accept(tl.expand(n, -1, -1), dl.expand(n, -1, -1),
                               toks, gen, False, 1.0, 0)
    emp = torch.bincount(out[:, 0].long(), minlength=v).double() / n
    assert (emp - p.double()).abs().max().item() < 0.03, (emp, p)
    assert (q[0] - p).abs().max().item() > 0.1


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_programs_match_jax(models, kv):
    """The suffix-prefill, draft and verify programs on the same pools
    and lanes as the JAX programs: tokens, draft tokens, out and n_acc
    exact, draft logits to 1e-5, pools as :func:`_pools_close`."""
    jnet, jdraft, tnet, tdraft = models
    rng = onp.random.RandomState(7)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator()

    # suffix prefill: 8 tokens (bucket 8, 5 real) after 3 cached blocks
    pk, pv = _pools(rng, 2, kv)
    suffix = onp.zeros((1, 8), onp.int32)
    suffix[0, :5] = rng.randint(0, V, 5)
    table = onp.full((1, MB), NB, onp.int32)
    table[0, :6] = [3, 7, 1, 12, 5, 9]
    run, params = jgen.paged_suffix_prefill_program(
        jnet, suffix_len=8, num_blocks=NB + 1, block_size=BS,
        max_blocks_per_seq=MB, kv_cache_dtype=kv)
    j_first, j_pk, j_pv = run(params, suffix, onp.int32(12), onp.int32(4),
                              jnp.asarray(pk), jnp.asarray(pv), table, key)
    tp = tgen.paged_suffix_prefill_program(tnet, suffix_len=8, block_size=BS)
    t_pk, t_pv = _t(pk), _t(pv)
    t_first, _, _ = tp(_t(suffix), 12, 4, t_pk, t_pv, _t(table), gen)
    assert int(t_first) == int(j_first)
    _pools_close(t_pk, j_pk, kv)
    _pools_close(t_pv, j_pv, kv)

    # draft: K steps after re-forwarding the previous token, 3 lanes
    r = 3
    dk, dv = _pools(rng, 1, kv)
    bt, pos = _state(rng, r, [6, 13, 0])
    prev = rng.randint(0, V, (r, 1)).astype(onp.int32)
    last = rng.randint(0, V, (r, 1)).astype(onp.int32)
    run, params = jgen.paged_spec_draft_program(
        jdraft, max_running=r, draft_k=K, num_blocks=NB + 1, block_size=BS,
        max_blocks_per_seq=MB, kv_cache_dtype=kv)
    j_toks, j_lgs, j_dk, j_dv = run(params, prev, last, jnp.asarray(dk),
                                    jnp.asarray(dv), bt, pos, key)
    tp = tgen.paged_spec_draft_program(tdraft, draft_k=K)
    t_dk, t_dv = _t(dk), _t(dv)
    t_toks, t_lgs, _, _ = tp(_t(prev), _t(last), t_dk, t_dv, _t(bt),
                             _t(pos), gen)
    onp.testing.assert_array_equal(t_toks.numpy(), onp.asarray(j_toks))
    onp.testing.assert_allclose(t_lgs.numpy(), onp.asarray(j_lgs),
                                rtol=1e-5, atol=1e-5)
    _pools_close(t_dk, j_dk, kv)
    _pools_close(t_dv, j_dv, kv)

    # verify: the target scores [last, d_0 .. d_{K-1}] on its own pools
    run, params = jgen.paged_spec_verify_program(
        jnet, max_running=r, draft_k=K, num_blocks=NB + 1, block_size=BS,
        max_blocks_per_seq=MB, kv_cache_dtype=kv)
    j_out, j_n, j_pk, j_pv = run(params, last, j_toks, j_lgs,
                                 jnp.asarray(pk), jnp.asarray(pv), bt, pos,
                                 key)
    tp = tgen.paged_spec_verify_program(tnet, draft_k=K)
    t_pk, t_pv = _t(pk), _t(pv)
    t_out, t_n, _, _ = tp(_t(last), t_toks, t_lgs, t_pk, t_pv, _t(bt),
                          _t(pos), gen)
    onp.testing.assert_array_equal(t_n.numpy(), onp.asarray(j_n))
    onp.testing.assert_array_equal(t_out.numpy(), onp.asarray(j_out))
    _pools_close(t_pk, j_pk, kv)
    _pools_close(t_pv, j_pv, kv)


def _serve(cls, net, draft, reqs, kw, concurrent=False):
    """Serve ``reqs`` one at a time (or all submitted together); returns
    the tokens and the engine's stats after the last one."""
    extra = {"device": "cpu"} if cls is TEngine else {}
    with cls(net, draft_model=draft, **kw, **extra) as eng:
        if concurrent:
            hs = [eng.submit(p, n) for p, n in reqs]
            toks = [onp.asarray(h.wait(timeout=120)) for h in hs]
        else:
            toks = [onp.asarray(eng.generate(p, n)) for p, n in reqs]
        return toks, eng.stats()


def _shared_prefix_reqs(seed, shared_len, tails):
    rng = onp.random.RandomState(seed)
    shared = rng.randint(0, V, (shared_len,)).astype(onp.int32)
    return [(onp.concatenate([shared, rng.randint(0, V, (t,))
                              .astype(onp.int32)]), n) for t, n in tails]


CASES = {
    # name: (draft, prefix_cache, num_blocks, requests)
    "spec": (True, False, None, [
        (onp.arange(1, p + 1, dtype=onp.int32) % V, n)
        for p, n in ((4, 6), (5, 7), (3, 9), (8, 4), (1, 11))]),
    "prefix": (False, True, 24, _shared_prefix_reqs(
        8, 12, [(2, 6), (3, 6), (1, 6), (4, 6), (0, 5)])),
    "spec_prefix": (True, True, 32, _shared_prefix_reqs(
        9, 12, [(2, 6), (3, 6), (1, 6), (5, 7)])),
    # 5 shared blocks and a 9-token tail: the suffix's bucket (4 blocks)
    # would reach past the 8-block table, so both prefill in full
    "overflow": (False, True, 24, _shared_prefix_reqs(
        11, 20, [(9, 3), (9, 3), (2, 3)])),
    # 6 blocks: an 8-token prompt + 4 new (3 blocks) leaves 2 cached;
    # the third prompt hits the first's, and the fourth must evict
    "evict": (False, True, 6, [
        ((onp.arange(1, 9, dtype=onp.int32) * m) % V, 4)
        for m in (7, 11, 7, 5, 11)]),
}


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_the_jax_engine(models, case, kv):
    """The same requests, one at a time, through the port's engine and
    the JAX engine: the same tokens and the same speculative and prefix
    counters; afterwards every block is free or held by the cache
    alone."""
    jnet, jdraft, tnet, tdraft = models
    draft, prefix, num_blocks, reqs = CASES[case]
    kw = dict(ENGINE, kv_cache_dtype=kv, draft_k=K, prefix_cache=prefix,
              num_blocks=num_blocks)
    want, jst = _serve(JEngine, jnet, jdraft if draft else None, reqs, kw)
    got, tst = _serve(TEngine, tnet, tdraft if draft else None, reqs, kw)
    for g, w in zip(got, want):
        onp.testing.assert_array_equal(g, w)
    for section in ("speculative", "prefix_cache"):
        assert (section in tst) == (section in jst)
        if section in jst:
            assert tst[section] == jst[section], section
    if draft:
        assert tst["speculative"]["proposed"] > 0
        assert tst["counters"]["spec_steps"] == jst["counters"]["spec_steps"]
    cached = tst.get("prefix_cache", {}).get("cached_blocks", 0)
    if prefix:
        assert tst["prefix_cache"]["hit_requests"] > 0
    assert tst["pool_blocks_free"] + cached == tst["pool_blocks_total"]


def test_spec_prefix_engine_under_inflight_batching(models):
    """Requests submitted together (several lanes per round, admissions
    into a running draft-verify batch): greedy tokens equal the JAX
    engine's and the dense ``generate``'s."""
    jnet, jdraft, tnet, tdraft = models
    reqs = _shared_prefix_reqs(10, 8, [(3, 9), (1, 7), (6, 5), (2, 10),
                                       (4, 6), (0, 8)])
    kw = dict(ENGINE, kv_cache_dtype="float32", draft_k=K,
              prefix_cache=True, num_blocks=32)
    want, _ = _serve(JEngine, jnet, jdraft, reqs, kw, concurrent=True)
    got, st = _serve(TEngine, tnet, tdraft, reqs, kw, concurrent=True)
    for (p, n), g, w in zip(reqs, got, want):
        onp.testing.assert_array_equal(g, w)
        dense = tgen.generate(tnet, p[None], n, device="cpu").numpy()[0]
        onp.testing.assert_array_equal(g, dense)
    assert st["pool_blocks_free"] + st["prefix_cache"]["cached_blocks"] \
        == st["pool_blocks_total"]


def test_spec_engine_sampled_serves_from_its_generator(models):
    """A sampling spec engine serves tokens in the vocabulary, proposes
    and accepts drafts, and two engines of one seed agree."""
    _, _, tnet, tdraft = models
    outs = []
    for _ in range(2):
        with TEngine(tnet, device="cpu", draft_model=tdraft, draft_k=K,
                     greedy=False, temperature=1.0, top_k=8, seed=7,
                     **ENGINE) as eng:
            outs.append(eng.generate(onp.array([1, 2, 3]), 10))
            st = eng.stats()["speculative"]
    assert outs[0].shape == (10,) and ((outs[0] >= 0) & (outs[0] < V)).all()
    onp.testing.assert_array_equal(outs[0], outs[1])
    assert st["proposed"] > 0


def test_spec_prefix_engine_bounds_and_defaults(models, monkeypatch):
    """The speculative slack counts against ``max_context``; a draft of
    another vocabulary is refused; the engine defaults to the card and
    raises without one."""
    _, _, tnet, tdraft = models
    with TEngine(tnet, device="cpu", draft_model=tdraft, draft_k=K,
                 prefix_cache=True, **ENGINE) as eng:
        with pytest.raises(ValueError, match="speculative slack"):
            eng.submit(onp.arange(20) % V, 10)      # 20 + 10 + 3 > 32
        assert eng.generate(onp.arange(20) % V, 9).shape == (9,)
        assert eng.evictable_blocks() == 5
    other = tbert.gpt_like(device="cpu", num_layers=1,
                           **dict(CFG, vocab_size=V + 1))
    with pytest.raises(MXNetError, match="vocabulary"):
        TEngine(tnet, device="cpu", draft_model=other, **ENGINE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        TEngine(tnet, draft_model=tdraft, prefix_cache=True)
