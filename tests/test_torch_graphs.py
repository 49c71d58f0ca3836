"""The serving programs as CUDA graphs and ``LLMEngine.warmup`` of the
PyTorch port against the JAX package, on the CPU.

On a card each program captures its step once per key and replays it
(``gluon/model_zoo/generation.py`` ``GraphedProgram``); here, where the
caller asked for the CPU, the programs run eagerly. What the CPU can
show: the graph key follows every routing decision a capture freezes,
the capture's launch bookkeeping, the warmed buckets and the greedy
tokens against the JAX engine. Replays themselves run on the card
(``chip_smoke.py`` phases 3-5). Weights are drawn from a seeded numpy
RNG and carried into the port with ``from_jax_params``.
"""
from contextlib import nullcontext

import numpy as onp
import pytest
import torch

from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.serving.llm import LLMEngine as JEngine
from mxnet_tpu_torch import base
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import generation as tgen
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops.kernels import _build
from mxnet_tpu_torch.serving.llm import LLMEngine as TEngine

CFG = dict(vocab_size=53, units=32, hidden_size=64, num_layers=2,
           num_heads=4, max_length=96)
ENGINE = dict(max_running=3, block_size=4, max_context=48,
              kv_cache_dtype="float32")
LENGTHS = [3, 9, 30]


def _models(seed):
    jnet = jbert.gpt_like(dropout=0.0, **CFG)
    rng = onp.random.RandomState(seed)
    params = {}
    for name, p in jnet.collect_params().items():
        scale = 0.1 if name.endswith((".gamma", ".beta", ".bias")) else 0.2
        params[name] = (scale * rng.randn(*p.shape)
                        + name.endswith(".gamma")).astype(onp.float32)
        p.set_data(params[name])
    tnet = tbert.gpt_like(device="cpu", **CFG)
    from_jax_params(params, tnet)
    return jnet, tnet


@pytest.fixture(scope="module")
def models():
    return _models(41)


@pytest.fixture(scope="module")
def served(models):
    """Both engines warmed on ``LENGTHS``, then serving two prompts of
    lengths the warmed buckets hold (their first tokens come from the
    prefill at ``last_idx``)."""
    jnet, tnet = models
    rng = onp.random.RandomState(42)
    prompts = [rng.randint(0, 53, (n,)).astype(onp.int32) for n in (7, 27)]
    out = {}
    for name, cls, kw in (("jax", JEngine, {}), ("port", TEngine,
                                                 {"device": "cpu"})):
        net = jnet if name == "jax" else tnet
        with cls(net, **ENGINE, **kw) as eng:
            buckets = eng.warmup(LENGTHS)
            hs = [eng.submit(p, 6) for p in prompts]
            toks = [onp.asarray(h.wait(timeout=120)) for h in hs]
            out[name] = (buckets, toks, eng.stats())
    return out


def test_warmup_returns_the_jax_engines_buckets(served):
    """The same prompt lengths warm the same prefill buckets (smallest
    power-of-two count of blocks, capped at the context) in both
    engines; on the CPU no graph is captured."""
    (jb, _, _), (tb, _, st) = served["jax"], served["port"]
    assert tb == jb == [4, 16, 32]
    assert st["graphs"] == {"captures": 0, "replays": 0, "capture_s": 0.0,
                            "prefill_buckets": []}


def test_warmed_engine_tokens_equal_the_jax_engine(served):
    """After warmup, prompts whose first token is sampled at a device
    scalar ``last_idx`` give the JAX engine's greedy tokens."""
    (_, jt, _), (_, tt, st) = served["jax"], served["port"]
    for got, want in zip(tt, jt):
        onp.testing.assert_array_equal(got, want)
    assert st["counters"]["completed"] == 2


@pytest.mark.parametrize("last", ["int", "tensor"])
def test_prefill_reads_last_idx_on_the_device(models, last):
    """The prefill program takes ``last_idx`` as an int or a (1,) int64
    tensor (what a graph reads on the device) and samples the same first
    token, the greedy argmax of the dense step's logits at that
    position."""
    _, tnet = models
    prompt = onp.random.RandomState(43).randint(0, 53, (1, 16))
    p = 11
    padded = torch.from_numpy(prompt.astype(onp.int32))
    padded[0, p:] = 0
    pk, pv = tnet.init_block_pool(5, 4)
    run = tgen.paged_prefill_program(tnet, prefill_len=16, block_size=4)
    idx = p - 1 if last == "int" else torch.tensor([p - 1])
    first, _, _ = run(padded, idx, pk, pv, torch.arange(4), None)
    ck, cv = tnet.init_cache(1, 16)
    with torch.no_grad():
        logits, _, _ = tnet.decode_step(padded, ck, cv, 0)
    assert first.shape == () and int(first) == int(logits[0, p - 1].argmax())


def _decode_args(tnet):
    pk, pv = tnet.init_block_pool(7, 4)
    return (torch.zeros((3, 1), dtype=torch.int32), pk, pv,
            torch.full((3, 12), 6, dtype=torch.int32),
            torch.zeros((3,), dtype=torch.int32), torch.Generator())


@pytest.mark.parametrize("change", ["no_kernels", "fused_decode", "policy"])
def test_graph_key_follows_every_routing_decision(models, monkeypatch,
                                                  change):
    """A captured graph freezes what Python decided while it ran: the
    key changes inside ``no_kernels``, with ``MXNET_TPU_LLM_FUSED_DECODE``
    forced on, and under the other matmul precision policy, and comes
    back when the decision does."""
    _, tnet = models
    run = tgen.paged_decode_program(tnet)
    args = _decode_args(tnet)
    monkeypatch.setenv("MXNET_TPU_LLM_FUSED_DECODE", "auto")
    key = run.key(*args)
    other = "highest" if base.matmul_precision() == "default" else "default"
    ctx = {"no_kernels": tnn.no_kernels(),
           "policy": base.matmul_precision_scope(other)}.get(change,
                                                            nullcontext())
    with ctx:
        if change == "fused_decode":
            monkeypatch.setenv("MXNET_TPU_LLM_FUSED_DECODE", "1")
        changed = run.key(*args)
    monkeypatch.setenv("MXNET_TPU_LLM_FUSED_DECODE", "auto")
    assert changed != key
    assert run.key(*args) == key


def test_graph_key_follows_shapes_pools_and_settings(models):
    """New contents of the fed inputs keep the key; other pools (the
    graph writes where they lay), other shapes and other sampling
    settings change it; a greedy program's key ignores its generator."""
    _, tnet = models
    run = tgen.paged_decode_program(tnet)
    toks, pk, pv, bt, pos, gen = _decode_args(tnet)
    key = run.key(toks, pk, pv, bt, pos, gen)
    assert run.key(toks + 1, pk, pv, bt - 1, pos + 2,
                   torch.Generator()) == key
    assert run.key(toks, pk.clone(), pv, bt, pos, gen) != key
    assert run.key(toks[:2], pk, pv, bt[:2], pos[:2], gen) != key
    sampled = tgen.paged_decode_program(tnet, greedy=False, top_k=5)
    assert sampled.key(toks, pk, pv, bt, pos, gen) != key
    assert (sampled.key(toks, pk, pv, bt, pos, gen)
            != sampled.key(toks, pk, pv, bt, pos, torch.Generator()))


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    def register_generator_state(self, gen):
        pass


def test_capture_books_its_launches_for_the_replays(models, monkeypatch):
    """The capture bookkeeping with torch's CUDA calls stubbed out: the
    warm-up run's launches count (they ran), the capture's are taken
    back (a capture launches nothing) and kept per wrapper, for each
    replay to add."""
    monkeypatch.setattr(tgen, "_capture_stream", lambda dev: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev: None)
    counted = _build.COUNTED[0]
    per_step = 3

    def body(x, pool, generator):
        counted.launches += per_step
        return x + pool

    prog = tgen.GraphedProgram("test", body, (0,), (), False)
    start = counted.launches
    x, pool = torch.ones(2), torch.zeros(2)
    got = prog._capture([x, pool], [x], None, torch.device("cpu"))
    assert counted.launches == start + per_step        # the warm-up run
    assert got.launches == ((counted, per_step),)
    assert prog.captures == 1 and prog.capture_s > 0
    assert torch.equal(got.out, x + pool) and got.fed[0] is not x
