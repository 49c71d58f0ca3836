"""LLMEngine's single-engine options on the PyTorch port against the
JAX package, on the CPU: weight-only int8 (the quantizer, ``generate``,
``beam_search`` and the engine), the KV codec, the spill tiers and the
engine's spill path, the telemetry registry and step spans, the fault
classifier, the step hook, the chaos sites and warmup manifests.

One tiny gpt_like (2 layers, units 32, vocab 64) and a 1-layer draft
sharing its embeddings and layer 0: weights drawn from a seeded numpy
RNG, set into the JAX models and carried into the port with
``from_jax_params``. The JAX engines run once per configuration, in
module fixtures.
"""
import importlib
import os
import threading

import numpy as onp
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import base as jbase
from mxnet_tpu.aot import WarmupManifest as JManifest
from mxnet_tpu.contrib import quantization as jquant
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo import generation as jgen
from mxnet_tpu.serving import kv_codec as jcodec
from mxnet_tpu.serving.kv_spill import KVSpillTier as JTier
from mxnet_tpu.serving.llm import LLMEngine as JEngine
from mxnet_tpu.telemetry import registry as jregistry
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.aot import WarmupManifest as TManifest
from mxnet_tpu_torch.contrib import quantization as tquant
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import generation as tgen
from mxnet_tpu_torch.resilience import chaos
from mxnet_tpu_torch.serving import kv_codec as tcodec
from mxnet_tpu_torch.serving.admission import ServerOverload
from mxnet_tpu_torch.serving.kv_spill import KVSpillTier as TTier
from mxnet_tpu_torch.serving.llm import LLMEngine as TEngine
from mxnet_tpu_torch.telemetry import registry as tregistry

# the JAX package's ``resilience`` exports a function named ``retry``
jretry = importlib.import_module("mxnet_tpu.resilience.retry")
tretry = importlib.import_module("mxnet_tpu_torch.resilience.retry")

V = 64
CFG = dict(vocab_size=V, units=32, hidden_size=64, num_heads=4,
           max_length=64)
ENGINE = dict(max_running=4, block_size=4, max_context=40)
SPILL = dict(ENGINE, kv_cache_dtype="float32", prefix_cache=True,
             kv_spill=True, num_blocks=10)


def _jnet(params=None, layers=2, seed=90):
    """A JAX gpt_like holding ``params``, or seeded numpy weights under
    the reference's names with one all-zero column in a Dense weight
    (its scale must be 1.0). Returns (net, params). ``set_data`` makes
    every parameter, so the net skips ``initialize()``'s random draws."""
    net = jbert.gpt_like(num_layers=layers, dropout=0.0, **CFG)
    if params is None:
        rng = onp.random.RandomState(seed)
        params = {}
        for name, p in net.collect_params().items():
            scale = 0.1 if name.endswith((".gamma", ".beta", ".bias")) \
                else 0.3
            params[name] = (scale * rng.randn(*p.shape)
                            + name.endswith(".gamma")).astype(onp.float32)
        params["encoder.layer0.ffn.ffn_1.weight"][:, 5] = 0.0
    _set(net, params)
    return net, params


def _set(net, params):
    for name, p in net.collect_params().items():
        p.set_data(params[name])


def _tnet(params, layers=2):
    net = tbert.gpt_like(device="cpu", num_layers=layers, **CFG)
    from_jax_params({n: params[n] for n in net.state_dict()}, net)
    return net


@pytest.fixture(scope="module")
def models():
    """(params, JAX target, JAX draft, port target, port draft)."""
    jnet, params = _jnet()
    return (params, jnet, _jnet(params, 1)[0], _tnet(params),
            _tnet(params, 1))


def _prompts(seed, lens):
    rng = onp.random.RandomState(seed)
    return [rng.randint(0, V, (n,)).astype(onp.int32) for n in lens]


# -- 1. the quantizer ------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizer_bitwise_equal_to_the_reference(models, dtype):
    """Codes, scales and the dequantized weights are bitwise the
    reference's on every parameter of the tiny net; the all-zero column
    gets scale 1.0; 1-D parameters pass through."""
    params = models[0]
    jq, js = jquant.quantize_weights_int8(
        {k: jnp.asarray(v).astype(dtype) for k, v in params.items()})
    tq, ts = tquant.quantize_weights_int8(
        {k: torch.from_numpy(v).to(getattr(torch, dtype))
         for k, v in params.items()})
    assert set(ts) == set(js) and set(tq) == set(jq)
    assert "pos_embed" in ts and "encoder.layer0.ln1.gamma" not in ts
    for k in ts:
        assert tq[k].dtype == torch.int8 and ts[k].shape == (1, js[k].shape[1])
        onp.testing.assert_array_equal(tq[k].numpy(), onp.asarray(jq[k]))
        onp.testing.assert_array_equal(
            ts[k].float().numpy(), onp.asarray(js[k].astype(jnp.float32)))
    assert float(ts["encoder.layer0.ffn.ffn_1.weight"][0, 5]) == 1.0
    jd = jquant.dequantize_weights_int8(jq, js)
    td = tquant.dequantize_weights_int8(tq, ts)
    for k in td:
        onp.testing.assert_array_equal(
            td[k].float().numpy(), onp.asarray(jd[k].astype(jnp.float32)))


# -- 2., 3. generate with int8 weights -------------------------------------
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_generate_int8_weights_equal_jax(models, kv):
    """Greedy tokens of ``generate(weight_dtype="int8")`` are the JAX
    package's, over f32 and int8 KV caches."""
    _, jnet, _, tnet, _ = models
    prompt = onp.stack(_prompts(1, (7, 7)))
    want = jgen.generate(jnet, prompt, 8, kv_cache_dtype=kv,
                         weight_dtype="int8").asnumpy()
    got = tgen.generate(tnet, prompt, 8, kv_cache_dtype=kv,
                        weight_dtype="int8", device="cpu").numpy()
    onp.testing.assert_array_equal(got, want)


def test_weight_dtype_int4_raises_as_the_reference(models):
    _, jnet, _, tnet, _ = models
    with pytest.raises(jbase.MXNetError) as je:
        jgen.generate(jnet, onp.ones((1, 3), onp.int32), 2,
                      weight_dtype="int4")
    with pytest.raises(tbase.MXNetError) as te:
        tgen.generate(tnet, onp.ones((1, 3), onp.int32), 2,
                      weight_dtype="int4", device="cpu")
    assert str(te.value) == str(je.value)
    with pytest.raises(tbase.MXNetError, match="int4"):
        tgen.paged_decode_program(tnet, weight_dtype="int4")


def test_int8_memo_requantizes_after_an_in_place_step(models, monkeypatch):
    """Two generate() calls quantize once; an in-place Trainer step
    bumps the weights' versions, the next call quantizes again, and its
    tokens are the JAX package's on the updated weights."""
    params, jnet = models[:2]
    tnet = _tnet(params)
    calls = []
    real = tgen.quantize_weights_int8
    monkeypatch.setattr(tgen, "quantize_weights_int8",
                        lambda p: calls.append(1) or real(p))
    # the shapes of the test above: the JAX program is compiled already
    prompt = onp.stack(_prompts(1, (7, 7)))
    a = tgen.generate(tnet, prompt, 8, weight_dtype="int8",
                      kv_cache_dtype="float32", device="cpu")
    b = tgen.generate(tnet, prompt, 8, weight_dtype="int8",
                      kv_cache_dtype="float32", device="cpu")
    assert len(calls) == 1 and torch.equal(a, b)
    tr = Trainer(tnet.collect_params(), "sgd", {"learning_rate": 0.5})
    x = torch.from_numpy(onp.stack(_prompts(3, (9, 9))).astype(onp.int64))
    loss = tnet(x).float().pow(2).mean()
    loss.backward()
    tr.step(1)
    got = tgen.generate(tnet, prompt, 8, weight_dtype="int8",
                        kv_cache_dtype="float32", device="cpu").numpy()
    assert len(calls) == 2
    assert not onp.array_equal(got, a.numpy())
    new = {n: p.data().detach().numpy()
           for n, p in tnet.collect_params().items()}
    _set(jnet, new)
    try:
        want = jgen.generate(jnet, prompt, 8, kv_cache_dtype="float32",
                             weight_dtype="int8").asnumpy()
    finally:
        _set(jnet, params)
    onp.testing.assert_array_equal(got, want)


# -- 4. beam search --------------------------------------------------------
@pytest.mark.parametrize("beam,alpha,wd", [(1, 0.0, "int8"),
                                           (3, 1.0, None),
                                           (3, 0.0, "int8")])
def test_beam_search_matches_jax(models, beam, alpha, wd):
    """Sequences equal and scores within 1e-5 of the JAX package's, with
    an eos (the first greedy token of row 0) that fires in a beam."""
    _, jnet, _, tnet, _ = models
    prompt = onp.stack(_prompts(4, (6, 6)))
    eos = int(tgen.generate(tnet, prompt, 1, device="cpu")[0, 0])
    js, jsc = jgen.beam_search(jnet, prompt, 6, beam_size=beam,
                               alpha=alpha, eos_token=eos, weight_dtype=wd)
    ts, tsc = tgen.beam_search(tnet, prompt, 6, beam_size=beam,
                               alpha=alpha, eos_token=eos, weight_dtype=wd,
                               device="cpu")
    assert ts.dtype == torch.int32 and ts.shape == (2, beam, 6)
    assert tsc.dtype == torch.float32
    onp.testing.assert_array_equal(ts.numpy(), js.asnumpy())
    onp.testing.assert_allclose(tsc.numpy(), jsc.asnumpy(), rtol=0,
                                atol=1e-5)
    seqs = ts.numpy()
    fired = (seqs[..., :-1] == eos) & (seqs[..., 1:] == eos)
    assert fired.any()
    # best-first
    assert (onp.diff(tsc.numpy(), axis=1) <= 0).all()


# -- 5. the int8-weight engine ---------------------------------------------
def _serve(eng, prompts, new=6):
    toks = [onp.asarray(eng.generate(p, new)) for p in prompts]
    return toks, eng.stats()


@pytest.fixture(scope="module")
def jax_int8_engines(models, tmp_path_factory):
    """The JAX int8-weight engines' tokens and stats: plain (warmed on
    one prompt length, its manifest saved) and with a draft model and
    the prefix cache."""
    _, jnet, jdraft, _, _ = models
    out = {}
    path = str(tmp_path_factory.mktemp("manifest") / "jax.json")
    with JEngine(jnet, weight_dtype="int8", **ENGINE) as eng:
        out["buckets"] = eng.warmup([5])
        out["plain"] = _serve(eng, PLAIN)
        eng.save_warmup_manifest(path)
    out["manifest"] = path
    with JEngine(jnet, weight_dtype="int8", draft_model=jdraft, draft_k=3,
                 prefix_cache=True, num_blocks=24, **ENGINE) as eng:
        out["spec_prefix"] = _serve(eng, SHARED)
    return out


PLAIN = _prompts(5, (5, 7, 3))
SHARED = [onp.concatenate([_prompts(6, (12,))[0], t])
          for t in _prompts(7, (2, 3, 1))]


@pytest.mark.parametrize("case", ["plain", "spec_prefix"])
def test_int8_engine_matches_the_jax_engine(models, jax_int8_engines, case):
    """The same requests through the port's and the JAX int8-weight
    engines: equal tokens and counters (verify and suffix prefill take
    int8 weights, the draft does not)."""
    _, _, _, tnet, tdraft = models
    kw = dict(ENGINE, weight_dtype="int8")
    if case == "spec_prefix":
        kw.update(draft_model=tdraft, draft_k=3, prefix_cache=True,
                  num_blocks=24)
    with TEngine(tnet, device="cpu", **kw) as eng:
        if case == "plain":
            assert eng.warmup([5]) == jax_int8_engines["buckets"]
        got, tst = _serve(eng, PLAIN if case == "plain" else SHARED)
    want, jst = jax_int8_engines[case]
    for g, w in zip(got, want):
        onp.testing.assert_array_equal(g, w)
    assert tst["counters"] == jst["counters"]
    assert tst["weight_dtype"] == "int8"
    assert tst["int8_weights"]["bytes"] > 0
    for section in ("speculative", "prefix_cache"):
        assert tst.get(section) == jst.get(section)
    for key in ("decode_step_ms", "prefill_ms", "token_latency_ms"):
        assert tst[key]["count"] == jst[key]["count"]


def test_int8_engine_tree_is_a_snapshot(models):
    """An int8 engine's tree is fixed when it is built: after an
    in-place SGD step on the model (which moves every parameter, the
    1-D gammas, betas and biases too) it serves the tokens of before
    the step, while an int8 engine built after it follows the new
    weights."""
    params = models[0]
    tnet = _tnet(params)
    with TEngine(tnet, device="cpu", weight_dtype="int8", **ENGINE) as eng:
        before, _ = _serve(eng, PLAIN)
        tr = Trainer(tnet.collect_params(), "sgd", {"learning_rate": 0.5})
        x = torch.from_numpy(onp.stack(_prompts(3, (9, 9))).astype(
            onp.int64))
        tnet(x).float().pow(2).mean().backward()
        tr.step(1)
        after, _ = _serve(eng, PLAIN)
    with TEngine(tnet, device="cpu", weight_dtype="int8", **ENGINE) as eng:
        moved, _ = _serve(eng, PLAIN)
    for a, b in zip(after, before):
        onp.testing.assert_array_equal(a, b)
    assert any(not onp.array_equal(m, b) for m, b in zip(moved, before))


def test_int8_steps_leave_other_threads_on_their_weights(models):
    """An int8 engine's steps substitute the dequantized weights on its
    scheduler thread only: f32 decode steps of the same model on this
    thread, made while the engine serves, give the f32 logits bit for
    bit."""
    params = models[0]
    tnet = _tnet(params)
    tok = torch.from_numpy(onp.stack(_prompts(8, (12,))).astype(onp.int32))

    def f32_logits():
        ck, cv = tnet.init_cache(1, 16)
        with torch.no_grad():
            return tnet.decode_step(tok, ck, cv, 0)[0]

    want = f32_logits()
    with TEngine(tnet, device="cpu", weight_dtype="int8", **ENGINE) as eng:
        handles = [eng.submit(p, 12) for p in PLAIN * 3]
        calls = 0
        while calls < 20 or not all(h.done for h in handles):
            assert torch.equal(f32_logits(), want), f"call {calls}"
            calls += 1
        for h in handles:
            h.wait(timeout=60)


# -- 6. the codec ----------------------------------------------------------
def test_kv_codec_blobs_cross_the_packages():
    rng = onp.random.RandomState(8)
    payload = {"k": rng.randint(-127, 127, (2, 4, 4, 12)).astype(onp.int8),
               "v": rng.randn(2, 4, 4, 8).astype(onp.float32)}
    for enc, dec in ((tcodec, jcodec), (jcodec, tcodec)):
        got = dec.decode_blocks(enc.encode_blocks(payload))
        assert set(got) == {"k", "v"}
        for k in payload:
            assert got[k].dtype == payload[k].dtype
            onp.testing.assert_array_equal(got[k], payload[k])
        assert dec.payload_nbytes(got) == enc.payload_nbytes(payload)
    blob = bytearray(tcodec.encode_blocks(payload))
    blob[40:80] = b"\x00" * 40
    assert tcodec.decode_blocks(bytes(blob)) is None
    assert tcodec.decode_blocks(b"not a blob") is None


# -- 7. the spill tier -----------------------------------------------------
def _payload(rng, nbytes=1024):
    return {"k": rng.randn(max(1, nbytes // 8)).astype(onp.float64)}


def test_spill_tier_bound_lru_and_disk(tmp_path):
    """Byte bound, LRU order, demotion to disk and promotion back, and
    dropping the overflow when there is no disk (the reference's tier
    tests)."""
    rng = onp.random.RandomState(0)
    tier = TTier(bytes_limit=4096, root=str(tmp_path / "spill"))
    payloads = {}
    for i in range(8):
        h = bytes([i]) * 16
        payloads[h] = _payload(rng)
        tier.put(h, payloads[h])
    assert tier.level() == (4, 4096)
    st = tier.stats()
    assert st["puts"] == 8 and st["demoted_to_disk"] == 4
    assert st["dropped"] == 0
    h0 = bytes([0]) * 16
    got, where = tier.get(h0)
    assert where == "disk"
    onp.testing.assert_array_equal(got["k"], payloads[h0]["k"])
    assert tier.get(h0)[1] == "host"          # promoted
    assert tier.level()[1] <= 4096
    # LRU: the promotion evicted the oldest resident (hash 4)
    assert tier.get(bytes([5]) * 16)[1] == "host"
    assert tier.get(b"\xff" * 16) == (None, None)
    tier.close()
    bare = TTier(bytes_limit=2048)
    for i in range(6):
        bare.put(bytes([i]) * 16, _payload(rng))
    assert bare.stats()["dropped"] == 4 and bare.level()[1] <= 2048
    assert bare.get(bytes([0]) * 16) == (None, None)
    assert bare.get(bytes([5]) * 16)[1] == "host"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spill_disk_root_crosses_the_packages(tmp_path, writer):
    """A disk root one package's tier wrote is read by the other's."""
    rng = onp.random.RandomState(1)
    root = str(tmp_path / "root")
    w_cls, r_cls = (TTier, JTier) if writer == "port" else (JTier, TTier)
    w = w_cls(bytes_limit=400, root=root)
    payloads = {bytes([i]) * 16: {"k": rng.randint(-9, 9, (2, 4, 4, 12))
                                  .astype(onp.int8)} for i in range(4)}
    for h, p in payloads.items():
        w.put(h, p)
    assert w.stats()["demoted_to_disk"] == 3
    r = r_cls(bytes_limit=400, root=root)
    for h in list(payloads)[:3]:
        got, where = r.get(h)
        assert where == "disk"
        onp.testing.assert_array_equal(got["k"], payloads[h]["k"])
    w.close()
    r.close()


# -- 8. the engine's spill path --------------------------------------------
RESUME = (onp.arange(1, 17, dtype=onp.int32) * 3) % V
FLOOD = _prompts(9, (16, 16, 16))


def _spill_workload(eng, grab_rows=None):
    """First turn, a flood that evicts it into the spill tier, then the
    resumed session. Returns (first, resumed)."""
    first = onp.asarray(eng.generate(RESUME, 5))
    if grab_rows is not None:
        grab_rows(eng)
    for p in FLOOD:
        eng.generate(p, 1)
    resumed = onp.asarray(eng.generate(RESUME, 5))
    return first, resumed


def _llm_values(reg, engine_id):
    """The ``llm_*`` counter and gauge values of one engine, and the
    counts of its histograms (not their timings; tok/s is a timing)."""
    out = {}
    for name, fam in reg.snapshot()["metrics"].items():
        if not name.startswith("llm_") or name == "llm_tok_s":
            continue
        for s in fam["series"]:
            if s["labels"].get("engine") != engine_id:
                continue
            key = (name, tuple(sorted(s["labels"].items())))
            out[key] = (s["summary"]["count"] if "summary" in s
                        else s["value"])
    return out


@pytest.fixture(scope="module")
def jax_spill(models):
    _, jnet, _, _, _ = models
    with JEngine(jnet, **SPILL) as eng:
        first, resumed = _spill_workload(eng)
        st = eng.stats()
        values = _llm_values(jregistry.get_registry(),
                             eng.metrics.engine_id)
    return first, resumed, st, values


def test_spill_engine_matches_the_jax_engine(models, jax_spill):
    """On one eviction workload: the port's tokens, re-attach counts by
    tier, counters, and every ``llm_*`` family's values equal the JAX
    engine's; re-attached pool rows are byte-equal to the first turn's,
    and the resumed tokens to the first turn's."""
    _, _, _, tnet, _ = models
    jfirst, jresumed, jst, jvalues = jax_spill
    rows = {}

    def grab(eng):
        hs = tbert_hashes(RESUME)
        rows["ids"] = [eng._prefix[h] for h in hs]
        rows["k"] = eng._pool_k[:, rows["ids"]].clone()

    with TEngine(tnet, device="cpu", **SPILL) as eng:
        first, resumed = _spill_workload(eng, grab)
        st = eng.stats()
        values = _llm_values(tregistry.get_registry(),
                             eng.metrics.engine_id)
        hs = tbert_hashes(RESUME)[:3]          # re-attached: all but the last
        now = eng._pool_k[:, [eng._prefix[h] for h in hs]]
    onp.testing.assert_array_equal(first, jfirst)
    onp.testing.assert_array_equal(resumed, first)
    onp.testing.assert_array_equal(resumed, jresumed)
    assert torch.equal(now, rows["k"][:, :3])
    assert st["counters"] == jst["counters"]
    assert st["prefix_cache"] == jst["prefix_cache"]
    reattach = {k: v for k, v in values.items()
                if k[0] == "llm_kv_reattach_total"}
    assert reattach and all(k[1][1] == ("tier", "host") for k in reattach)
    assert sum(reattach.values()) == 3
    assert {(n, tuple(x for x in lab if x[0] != "engine")): v
            for (n, lab), v in values.items()} == \
        {(n, tuple(x for x in lab if x[0] != "engine")): v
         for (n, lab), v in jvalues.items()}
    for key in ("host_blocks", "host_bytes", "puts", "demoted_to_disk",
                "dropped"):
        assert st["kv_spill"][key] == jst["kv_spill"][key], key
    assert st["kv_spill"]["save_bytes"] > 0
    assert st["kv_spill"]["reattach_bytes"] == 3 * 2 * 2 * 4 * 4 * 8 * 4


def tbert_hashes(prompt):
    from mxnet_tpu_torch.serving.kv_hash import chain_hashes

    return chain_hashes(prompt, ENGINE["block_size"])


def test_spill_survives_a_fault_reset_and_needs_the_prefix_cache(models):
    """A transient reset clears the pool's block ids and the prefix
    cache; the spill tier survives and the next admission re-attaches.
    ``kv_spill`` without ``prefix_cache`` raises."""
    _, _, _, tnet, _ = models
    with TEngine(tnet, device="cpu", **SPILL) as eng:
        first, _ = _spill_workload(eng)
        assert eng._spill.level()[0] > 0
        with eng._state_lock:
            assert eng._fault_locked(tbase.TransientError("drill"))
        assert len(eng._prefix) == 0 and eng._spill.level()[0] > 0
        before = eng.stats()["kv_spill"]["reattach_bytes"]
        onp.testing.assert_array_equal(eng.generate(RESUME, 5), first)
        assert eng.stats()["kv_spill"]["reattach_bytes"] > before
    with pytest.raises(ValueError, match="prefix_cache"):
        TEngine(tnet, device="cpu", **dict(SPILL, prefix_cache=False))


# -- 9. metrics and tracing ------------------------------------------------
def _exercise(reg):
    c = reg.counter("req_total", "Requests\nserved", ("route", "code"))
    c.labels(route="/a", code="200").inc()
    c.labels(route='/"b"', code="500").inc(3)
    g = reg.gauge("depth", "Queue depth")
    g.set(7)
    g.dec(2.5)
    h = reg.histogram("lat_ms", "Latency", ("op",), buckets=(1.0, 10.0))
    for v in (0.5, 3.0, 3.0, 12.0, 1e6):
        h.labels(op="x").observe(v)
    reg.counter(jregistry.sanitize_name("serving.queue_depth")).inc()
    return reg.prometheus_text(), reg.snapshot()["metrics"]


def test_registry_exposition_equals_the_reference():
    ttext, tsnap = _exercise(tregistry.MetricsRegistry())
    jtext, jsnap = _exercise(jregistry.MetricsRegistry())
    assert ttext == jtext
    assert tsnap == jsnap
    assert tregistry.sanitize_name("a.b-c") == jregistry.sanitize_name("a.b-c")


def test_trace_ids_reach_the_step_spans(models):
    """A ``trace_id`` given to submit, or bound by ``trace_scope``,
    annotates the request's ``llm_prefill`` span and the ``llm_decode``
    spans that served it."""
    _, _, _, tnet, _ = models
    with TEngine(tnet, device="cpu", **ENGINE) as eng:
        eng.submit(PLAIN[0], 3, trace_id="t-given").wait()
        with telemetry.trace_scope(telemetry.TraceContext("t-scoped")):
            eng.submit(PLAIN[1], 3).wait()
    events = telemetry.buffer().snapshot()
    for tid in ("t-given", "t-scoped"):
        pre = [e for e in events if e["name"] == "step[llm_prefill]"
               and e.get("args", {}).get("trace_id") == tid]
        dec = [e for e in events if e["name"] == "step[llm_decode]"
               and tid in e.get("args", {}).get("trace_ids", [])]
        assert len(pre) == 1 and len(dec) == 2, tid
        assert {"device", "host", "compile", "wall_ms"} <= set(
            dec[0]["args"])


# -- 10. faults, hooks, chaos, manifests -----------------------------------
_FAULTS = [
    lambda B: OSError("disk"), lambda B: ValueError("bad"),
    lambda B: MemoryError(), lambda B: TimeoutError("slow"),
    lambda B: FileNotFoundError("x"), lambda B: KeyError("k"),
    lambda B: RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"),
    lambda B: RuntimeError("RESOURCE_EXHAUSTED: x"),
    lambda B: RuntimeError("INVALID_ARGUMENT: out of memory"),
    lambda B: RuntimeError("plain"), lambda B: B.MXNetError("UNAVAILABLE"),
    lambda B: B.TransientError("t"), lambda B: B.FatalError("f"),
    lambda B: ConnectionResetError("peer"),
]


def test_classify_agrees_with_the_reference():
    for make in _FAULTS:
        assert tretry.classify(make(tbase)) == jretry.classify(make(jbase))
    assert tretry.classify(MemoryError()) == tretry.FATAL
    assert tretry.is_transient(RuntimeError("CUDA out of memory"))


@pytest.mark.parametrize("kind", ["transient", "fatal"])
def test_step_hook_faults_are_typed(models, kind):
    """A transient hook fault fails the in-flight request typed and the
    engine serves on; a fatal one stops it and submit sheds. The hook
    runs once per tick."""
    _, _, _, tnet, _ = models
    armed, ticks = [], []

    def hook():
        ticks.append(1)
        if armed:
            armed.clear()
            raise (tbase.TransientError("hook drill") if kind == "transient"
                   else ValueError("hook bug"))

    eng = TEngine(tnet, device="cpu", step_hook=hook, **ENGINE)
    try:
        h = eng.submit(PLAIN[1], 8, on_token=lambda t: armed.append(1))
        want = tbase.TransientError if kind == "transient" \
            else tbase.FatalError
        with pytest.raises(want):
            h.wait(timeout=60)
        assert eng.stats()["counters"]["resets"] == 1
        assert len(ticks) >= 2 and eng.last_tick > 0
        if kind == "transient":
            assert eng.alive
            out = eng.generate(PLAIN[0], 4)
            onp.testing.assert_array_equal(out, tgen.generate(
                tnet, PLAIN[0][None], 4, device="cpu").numpy()[0])
        else:
            assert not eng.alive
            with pytest.raises(ServerOverload):
                eng.submit(PLAIN[0], 4)
    finally:
        eng.close()


@pytest.mark.parametrize("site", ["serving.llm", "serving.llm.verify"])
def test_chaos_sites_fail_one_request_typed(models, site):
    """An armed site fails exactly the request it hits with a typed
    transient fault; the engine recovers with a full pool and serves
    the next request exactly (the reference's two chaos-site tests)."""
    _, _, _, tnet, tdraft = models
    kw = dict(ENGINE, kv_cache_dtype="float32")
    if site == "serving.llm.verify":
        kw.update(draft_model=tdraft, draft_k=3)
    prompt = PLAIN[2]
    try:
        with TEngine(tnet, device="cpu", **kw) as eng:
            with chaos.scope(site, fail="transient", times=1):
                h = eng.submit(prompt, 6)
                with pytest.raises(chaos.ChaosTransient) as ei:
                    h.wait(timeout=60)
                assert isinstance(ei.value, tbase.TransientError)
            ref = tgen.generate(tnet, prompt[None], 6,
                                device="cpu").numpy()[0]
            onp.testing.assert_array_equal(eng.generate(prompt, 6), ref)
            st = eng.stats()
        assert st["pool_blocks_free"] == st["pool_blocks_total"]
        assert st["counters"]["resets"] == 1
        assert chaos.stats()[site]["raise"] >= 1
    finally:
        chaos.clear()


def test_donate_is_accepted_and_a_prefill_fault_stays_contained(models):
    """``donate=True`` changes nothing: a prefill fault fails its own
    request, counts one reset, and a request in flight meanwhile
    finishes with the tokens of an unfaulted run."""
    _, _, _, tnet, _ = models
    kw = dict(ENGINE, kv_cache_dtype="float32", donate=True)
    started = threading.Event()
    try:
        with TEngine(tnet, device="cpu", **kw) as eng:
            a = eng.submit(PLAIN[0], 12, on_token=lambda t: started.set())
            assert started.wait(60)
            with chaos.scope("serving.llm", fail="transient", times=1):
                b = eng.submit(PLAIN[1], 6)
                with pytest.raises(chaos.ChaosTransient):
                    b.wait(timeout=60)
            got = a.wait(timeout=60)
            st = eng.stats()
        ref = tgen.generate(tnet, PLAIN[0][None], 12,
                            device="cpu").numpy()[0]
        onp.testing.assert_array_equal(got, ref)
        assert st["counters"]["resets"] == 1
        assert st["counters"]["failed"] == 1
    finally:
        chaos.clear()


def test_manifests_cross_the_packages(models, jax_int8_engines, tmp_path):
    """A manifest the JAX engine saved warms the port's engine to its
    prefill buckets; the port's file loads in the reference's
    ``WarmupManifest.load`` with the same entries."""
    _, _, _, tnet, _ = models
    jpath = jax_int8_engines["manifest"]
    jbuckets = sorted(e["bucket"] for e in JManifest.load(jpath).entries()
                      if e["label"] == "llm.prefill")
    assert set(jax_int8_engines["buckets"]) < set(jbuckets)
    with TEngine(tnet, device="cpu", weight_dtype="int8", **ENGINE) as eng:
        assert eng.warmup(manifest=jpath) == jbuckets
        _serve(eng, PLAIN)
        tpath = eng.save_warmup_manifest(str(tmp_path / "port.json"))
        assert len(eng.warmup_manifest()) == len(TManifest.load(tpath))
    def entries(path):
        return sorted(JManifest.load(path).entries(),
                      key=lambda e: (e["label"], e["bucket"]))

    assert entries(tpath) == entries(jpath)


def test_waiting_arguments_raise_naming_their_item(models):
    _, _, _, tnet, _ = models
    for kw, item in ((dict(role="prefill"), "item 7"),
                     (dict(kv_spill_serve=True), "item 7"),
                     (dict(kv_spill_peers=["127.0.0.1:1"]), "item 7"),
                     (dict(mesh=object()), "item 8"),
                     (dict(rules=[]), "item 8")):
        with pytest.raises(tbase.MXNetError, match=item):
            TEngine(tnet, device="cpu", **kw)
    for kw in (dict(serve=True), dict(peers=["127.0.0.1:1"])):
        with pytest.raises(tbase.MXNetError, match="item 7"):
            TTier(**kw)
    with TEngine(tnet, device="cpu", **SPILL) as eng:
        assert eng.kv_spill_endpoint is None
        eng.set_kv_spill_peers([])
        with pytest.raises(tbase.MXNetError, match="item 7"):
            eng.set_kv_spill_peers(["127.0.0.1:1"])
    assert os.environ.get("MXNET_TPU_CHAOS") is None
