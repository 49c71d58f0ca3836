"""Autoregressive generation of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/generation.py``).

:func:`generate` is the dense-cache offline oracle, and
:func:`paged_decode_program` / :func:`paged_prefill_program` return the
two programs the serving engine calls (one decode step over the whole
lane set, one prefill-and-splice per prompt bucket). With the prefix
cache, :func:`paged_suffix_prefill_program` prefills only the uncached
tail of a prompt; with speculative decoding,
:func:`paged_spec_draft_program` proposes K tokens per lane and
:func:`paged_spec_verify_program` scores them in one target forward
(:func:`_spec_accept`). Sampling draws from an explicit
``torch.Generator``.

``weight_dtype="int8"`` (:func:`generate`, :func:`beam_search` and
every paged program but the draft's) runs the model on weight-only int8:
the weights are quantized once per weight version
(:func:`_int8_weights`, the reference's ``_apply_weight_dtype``) and
dequantized inside each step, which runs the model with every
parameter substituted (:func:`_with_weights`), so every kernel reads
the dequantized weights.

Where the reference compiles each program once per shape and memoizes
it (``_paged_jit``, ``:393``), a program here captures its step on a
CUDA device as a ``torch.cuda.CUDAGraph`` once per key and replays it
afterwards (:class:`GraphedProgram`). The key is the program, the shapes
and dtypes of its inputs, the addresses of the pools it updates in place
(the graph writes where they lay at capture), its sampling settings, and
every routing decision Python takes while the step is captured:
``kernels_enabled()``, ``fused_decode_armed()`` and the matmul precision
policy (cuBLAS reads TF32 at capture; the reference's AOT key carries
the matmul precision too, ``mxnet_tpu/aot/cache.py:277``). A capture
that fails raises. On the CPU the programs run eagerly, as the caller
asked for that device.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, Optional

import numpy as onp
import torch

from ...base import MXNetError, matmul_precision
from ...context import resolve_device
from ...contrib.quantization import (dequantize_weights_int8,
                                     quantize_weights_int8)
from ...ops.kernels import _build
from ...ops.kernels.fused_decode import fused_decode_armed
from ...ops.nn import kernels_enabled
from ...telemetry import tracing
from ..parameter import substituted

__all__ = ["generate", "beam_search", "paged_decode_program",
           "paged_prefill_program", "paged_suffix_prefill_program",
           "paged_spec_draft_program", "paged_spec_verify_program",
           "GraphedProgram"]

_KV_CACHE_DTYPES = (None, "int8", "float32", "bfloat16", "float16")

# model -> (weight-version key, (qparams, scales)): the weight-only int8
# tree, re-quantized only when a weight changes. Weak-keyed and off the
# model, as the reference's ``_INT8W_CACHES``
_INT8W_CACHES = weakref.WeakKeyDictionary()
_INT8W_LOCK = threading.Lock()


def _int8_weights(model):
    """The model's weight-only int8 tree ``(qparams, scales)``, memoized
    per weight version. The reference keys its memo on the identity of
    every parameter buffer, which a JAX update replaces; the port's
    Trainer and ``set_data`` write in place, so the key here is each
    tensor's address and its version counter (which every in-place
    write bumps): a generate() after a training step re-quantizes."""
    params = {n: p.data() for n, p in model.collect_params().items()}
    key = tuple((n, t.data_ptr(), t._version)
                for n, t in sorted(params.items()))
    with _INT8W_LOCK:
        cached = _INT8W_CACHES.get(model)
    if cached is not None and cached[0] == key:
        return cached[1]
    tree = quantize_weights_int8(params)
    with _INT8W_LOCK:
        _INT8W_CACHES[model] = (key, tree)
    return tree


def _resolve_weights(model, weight_dtype, int8_weights=None):
    """The int8 tree a program runs on: None for the model's own
    weights, ``int8_weights`` when given (an engine's tree, fixed when
    it was built), else the model's memoized tree."""
    if weight_dtype is None:
        return None
    if weight_dtype != "int8":
        raise MXNetError(
            f"weight_dtype {weight_dtype!r} not supported (int8)")
    return int8_weights if int8_weights is not None \
        else _int8_weights(model)


def _weights_key(tree):
    """The addresses of an int8 tree's tensors (part of a graph's key:
    the graph reads them where they lay at capture)."""
    if tree is None:
        return None
    q, scales = tree
    return tuple((n, t.data_ptr()) for n, t in sorted(q.items())) + \
        tuple((n, t.data_ptr()) for n, t in sorted(scales.items()))


def _with_weights(model, tree, fn, *args):
    """``fn(*args)`` with the model's weights dequantized from ``tree``
    (None: the model's own weights). Every ``Parameter.data()`` read
    returns the dequantized tensor (:func:`~..parameter.substituted`),
    on this thread only: the model's weights read that way, so no read
    serves the f32 weights, and another thread using the same model
    meanwhile sees its own. Inside a captured graph the dequantization
    is part of the step."""
    if tree is None:
        return fn(*args)
    deq = dequantize_weights_int8(*tree)
    named = model.collect_params()
    with substituted((p, deq[n]) for n, p in named.items()):
        return fn(*args)


def _sample(logits, generator, greedy, temperature, top_k):
    """Pick next tokens (int32) from (B, V) logits."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth,
                             torch.full_like(logits, float("-inf")), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _resolve_cache_dtype(model, kv_cache_dtype):
    """Validate + default the KV cache dtype (the model's dtype)."""
    if kv_cache_dtype not in _KV_CACHE_DTYPES:
        raise MXNetError(
            f"kv_cache_dtype {kv_cache_dtype!r} not supported "
            "(int8/float32/bfloat16/float16)")
    return kv_cache_dtype or str(model.word_embed.weight.dtype).replace(
        "torch.", "")


def _model_device(model, device):
    """The device an entry point runs on; the model must already be
    there (no silent moves of the caller's weights)."""
    dev = resolve_device(device)
    have = model.word_embed.weight.data().device
    if have.type != dev.type or (dev.type == "cuda"
                                 and have.index != dev.index):
        raise MXNetError(
            f"model parameters are on {have}, the entry point runs on "
            f"{dev}: move the model with model.to({str(dev)!r}) or pass "
            f"device={str(have)!r}")
    return dev


def _prep(model, prompt_ids, max_new_tokens, max_length, kv_cache_dtype,
          device):
    """Shared dense-decode setup: the prompt on the model's device, the
    length checks against the context window, and the caches."""
    dev = _model_device(model, device)
    if isinstance(prompt_ids, torch.Tensor):
        prompt = prompt_ids.to(device=dev, dtype=torch.int32)
    else:
        prompt = torch.as_tensor(onp.asarray(prompt_ids, onp.int32),
                                 device=dev)
    b, p = prompt.shape
    lmax = max_length or (p + max_new_tokens)
    if lmax < p + max_new_tokens:
        raise MXNetError(f"max_length {lmax} < prompt {p} + max_new_tokens "
                         f"{max_new_tokens}")
    rows = model.pos_embed.shape[0]
    if lmax > rows:
        raise MXNetError(f"generation length {lmax} exceeds the model's "
                         f"context window (max_length={rows})")
    ck, cv = model.init_cache(b, lmax,
                              dtype=_resolve_cache_dtype(model, kv_cache_dtype))
    return dev, prompt, b, p, ck, cv


def generate(model, prompt_ids, max_new_tokens: int,
             max_length: Optional[int] = None, greedy: bool = True,
             temperature: float = 1.0, top_k: int = 0, eos_token: int = -1,
             seed: int = 0, kv_cache_dtype: Optional[str] = None,
             weight_dtype: Optional[str] = None, device=None):
    """Generate ``max_new_tokens`` continuations of ``prompt_ids`` (B, P)
    through a dense per-batch KV cache. Returns a (B, max_new_tokens)
    int32 tensor on the model's device. Once a sequence emits
    ``eos_token``, its remaining positions repeat it.
    ``weight_dtype="int8"`` runs on the model's weight-only int8 tree
    (quantized once per weight version)."""
    dev, prompt, b, p, ck, cv = _prep(model, prompt_ids, max_new_tokens,
                                      max_length, kv_cache_dtype, device)
    tree = _resolve_weights(model, weight_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def run(ck, cv):
        logits, ck, cv = model.decode_step(prompt, ck, cv, 0)
        tok = _sample(logits[:, -1], gen, greedy, temperature, top_k)
        done = tok == eos_token
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, ck, cv = model.decode_step(tok[:, None], ck, cv, p + i)
            nxt = _sample(logits[:, -1], gen, greedy, temperature, top_k)
            nxt = torch.where(done, torch.full_like(nxt, eos_token), nxt)
            done = done | (nxt == eos_token)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1)

    with torch.no_grad():
        return _with_weights(model, tree, run, ck, cv)


def beam_search(model, prompt_ids, max_new_tokens: int, beam_size: int = 4,
                max_length: Optional[int] = None, alpha: float = 1.0,
                eos_token: int = -1, kv_cache_dtype: Optional[str] = None,
                weight_dtype: Optional[str] = None, device=None):
    """Beam-search decoding (reference ``generation.py:277``) through a
    dense KV cache of ``B * beam_size`` rows.

    The prompt prefills un-tiled at batch B and the caches are tiled K
    times after it; each step scores every beam's continuations, keeps
    the K best per batch row, and reorders the caches by parent beam (a
    gather on the cache's batch axis). A finished beam continues with
    ``eos_token`` at zero cost and nothing else. Returns ``(sequences
    (B, K, max_new_tokens) int32, scores (B, K) float32)`` ordered
    best-first, the scores length-normalized: ``logp / len**alpha``
    (``alpha=0`` gives the joint log-probability)."""
    k = int(beam_size)
    dev, prompt, b, p, ck, cv = _prep(model, prompt_ids, max_new_tokens,
                                      max_length, kv_cache_dtype, device)
    tree = _resolve_weights(model, weight_dtype)
    neg_inf = -1e9

    def run(ck, cv):
        logits, ck, cv = model.decode_step(prompt, ck, cv, 0)
        logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
        vocab = logp0.shape[-1]
        scores, first = torch.topk(logp0, k, dim=-1)    # (B, K)
        first = first.to(torch.int32)
        # (L, B, ...) -> (L, B*K, ...): each row's K beams side by side
        ck = ck.repeat_interleave(k, dim=1)
        cv = cv.repeat_interleave(k, dim=1)
        done = first == eos_token
        seqs = torch.zeros((b, k, max_new_tokens), dtype=torch.int32,
                           device=dev)
        seqs[:, :, 0] = first
        lengths = torch.ones((b, k), dtype=torch.int32, device=dev)
        frozen = torch.full((vocab,), neg_inf, device=dev)
        frozen[min(max(eos_token, 0), vocab - 1)] = 0.0
        rows = torch.arange(b, device=dev)[:, None] * k
        tok = first
        for step in range(1, max_new_tokens):
            lg, ck, cv = model.decode_step(tok.reshape(b * k, 1), ck, cv,
                                           p + step - 1)
            logp = torch.log_softmax(lg[:, -1].float(), dim=-1).reshape(
                b, k, vocab)
            # finished beams: eos at zero added cost, nothing else
            logp = torch.where(done[:, :, None], frozen[None, None], logp)
            total = scores[:, :, None] + logp               # (B, K, V)
            scores, idx = torch.topk(total.reshape(b, k * vocab), k,
                                     dim=-1)
            parent = torch.div(idx, vocab, rounding_mode="floor")
            new_tok = (idx % vocab).to(torch.int32)
            flat = (rows + parent).reshape(-1)
            ck = ck.index_select(1, flat)
            cv = cv.index_select(1, flat)
            done = torch.gather(done, 1, parent)
            lengths = torch.gather(lengths, 1, parent)
            seqs = torch.gather(seqs, 1, parent[:, :, None].expand(
                b, k, max_new_tokens))
            seqs[:, :, step] = torch.where(
                done, torch.full_like(new_tok, eos_token), new_tok)
            lengths = lengths + (~done).to(torch.int32)
            done = done | (new_tok == eos_token)
            tok = new_tok
        norm = torch.pow(lengths.float(), alpha)
        final = scores / torch.clamp(norm, min=1.0)
        order = torch.argsort(-final, dim=1, stable=True)
        return (torch.gather(seqs, 1, order[:, :, None].expand(
                    b, k, max_new_tokens)),
                torch.gather(final, 1, order))

    with torch.no_grad():
        return _with_weights(model, tree, run, ck, cv)


def routing_key(device) -> tuple:
    """The decisions Python takes while a step runs, which a captured
    graph freezes: kernels on or off (:class:`~...ops.nn.no_kernels`),
    the fused decode kernels armed (``MXNET_TPU_LLM_FUSED_DECODE``), and
    the matmul precision policy."""
    return (kernels_enabled(), fused_decode_armed(torch.device(device)),
            matmul_precision())


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device):
    """One side stream per device for the warm-up runs and captures."""
    st = _CAPTURE_STREAMS.get(device)
    if st is None:
        st = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return st


class _Captured:
    """One captured graph: its static inputs and outputs, and what its
    capture launched per counted wrapper."""

    __slots__ = ("graph", "fed", "out", "launches")

    def __init__(self, graph, fed, out, launches):
        self.graph, self.fed, self.out = graph, fed, out
        self.launches = launches


class GraphedProgram:
    """A step ``body(*args, generator)`` run as a CUDA graph per key.

    The arguments at positions ``fed`` (tokens, tables, positions,
    indices; a Python int becomes a (1,) int64 tensor) are copied on each
    call into static device buffers the graph owns, without blocking
    (from pinned host memory where the caller keeps them pinned); the
    others, the KV pools, are used where they lie and updated in place,
    so their addresses are part of the key. The first call of a key runs
    the body once on a side stream (the warm-up torch requires, which
    also loads every kernel and allocates K4's workspace), then captures
    it into the program's memory pool (``graph_pool``, which a caller
    may share between programs); the generator of a sampling program is
    registered with the graph, so each replay draws anew. Calls then
    replay it.

    The kernel wrappers count their launches in Python, so a replay adds
    what its capture launched to each wrapper's ``.launches``: counts
    stay exact per replayed step. Outputs are the graph's static
    tensors, overwritten by the next replay. The graph also reads the
    model's parameters where they lay at capture. ``state``, where
    given, returns the tensors the step updates in place that the
    warm-up run must leave as it found them (BatchNorm's running
    statistics in a training-mode forward), so that a call which
    captures updates them once, as a replay does. :meth:`eager` runs the
    body itself on the same inputs; on the CPU every call does.
    ``captures``, ``replays`` and ``capture_s`` count the program's
    graphs."""

    def __init__(self, label, body, fed, settings, sampling,
                 graph_pool=None, state=None):
        self.label = label
        self._body = body
        self._fed = tuple(fed)
        self._settings = settings
        self._sampling = sampling
        self._pool = graph_pool
        self._state = state
        self._graphs: Dict[tuple, _Captured] = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def _split(self, args):
        """(fed inputs as tensors, the held tensors, their device)."""
        fed = [a if isinstance(a, torch.Tensor)
               else torch.tensor([int(a)], dtype=torch.int64)
               for i, a in enumerate(args) if i in self._fed]
        held = [a for i, a in enumerate(args) if i not in self._fed]
        return fed, held, (held or fed)[0].device

    def _join(self, args, fed):
        it = iter(fed)
        return [next(it) if i in self._fed else a
                for i, a in enumerate(args)]

    def key(self, *args):
        """The graph key of a call with these inputs (and generator)."""
        *args, generator = args
        fed, held, dev = self._split(args)
        return (self.label, self._settings,
                tuple((tuple(t.shape), t.dtype) for t in fed),
                tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                      for t in held),
                id(generator) if self._sampling else None,
                routing_key(dev))

    def eager(self, *args):
        """One call of the step itself, its fed inputs moved to the
        pools' device."""
        *args, generator = args
        fed, _, dev = self._split(args)
        return self._body(*self._join(args, [t.to(dev) for t in fed]),
                          generator)

    def __call__(self, *args):
        *args, generator = args
        fed, _, dev = self._split(args)
        if dev.type != "cuda":
            return self.eager(*args, generator)
        key = self.key(*args, generator)
        got = self._graphs.get(key)
        if got is None:
            got = self._graphs[key] = self._capture(args, fed, generator,
                                                    dev)
        for buf, src in zip(got.fed, fed):
            buf.copy_(src, non_blocking=True)
        got.graph.replay()
        for wrapper, n in got.launches:
            wrapper.launches += n
        self.replays += 1
        return got.out

    def _capture(self, args, fed, generator, dev):
        t0 = time.perf_counter()
        static = [t.to(dev).clone() for t in fed]
        inputs = self._join(args, static)
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            kept = [(t, t.clone()) for t in
                    (self._state() if self._state else ())]
            self._body(*inputs, generator)
            for t, was in kept:
                t.copy_(was)
        torch.cuda.current_stream(dev).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if self._sampling:
            graph.register_generator_state(generator)
        before = [w.launches for w in _build.COUNTED]
        with torch.cuda.graph(graph, pool=self._pool, stream=side,
                              capture_error_mode="thread_local"):
            out = self._body(*inputs, generator)
        launches = []
        for w, n in zip(_build.COUNTED, before):
            if w.launches != n:         # the capture launched nothing
                launches.append((w, w.launches - n))
                w.launches = n
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.captures += 1
        self.capture_s += dt
        # a capture is the port's compile: the open step's compile bucket
        tracing.attribute("compile", dt)
        return _Captured(graph, static, out, tuple(launches))


def paged_decode_program(model, *, weight_dtype=None, int8_weights=None,
                         greedy=True, temperature=1.0, top_k=0,
                         graph_pool=None):
    """The continuous-batching decode step over the whole lane set.

    Returns a :class:`GraphedProgram` ``run(tokens (R, 1) i32, pool_k,
    pool_v, block_table (R, MB) i32, positions (R,) i32, generator) ->
    (next_tokens (R,) i32, pool_k, pool_v)``; the pools lie on the
    model's device, the other inputs may lie on the host. Lane ``r``'s
    token is written at ``positions[r]`` through its table row (pools
    updated in place), attended through the pool, and sampled. Inactive
    lanes point at a trash block; their outputs are ignored by the
    scheduler. On a CUDA device the step replays a graph captured once
    per key. ``weight_dtype="int8"`` runs on ``int8_weights`` (an
    engine's tree), else the model's memoized int8 tree as it is now:
    see :func:`_resolve_weights`."""
    tree = _resolve_weights(model, weight_dtype, int8_weights)

    def body(tokens, pool_k, pool_v, block_table, positions, generator):
        with torch.no_grad():
            logits, pool_k, pool_v = _with_weights(
                model, tree, model.decode_step_paged, tokens, pool_k,
                pool_v, block_table, positions)
            nxt = _sample(logits[:, -1], generator, greedy, temperature,
                          top_k)
        return nxt, pool_k, pool_v

    return GraphedProgram(
        "llm.decode", body, (0, 3, 4),
        (id(model), bool(greedy), float(temperature), int(top_k),
         weight_dtype, _weights_key(tree)), not greedy, graph_pool)


def paged_prefill_program(model, *, prefill_len, block_size,
                          kv_cache_dtype=None, weight_dtype=None,
                          int8_weights=None, greedy=True, temperature=1.0,
                          top_k=0, graph_pool=None):
    """The prefill-and-splice step for one prompt-length bucket.

    Returns a :class:`GraphedProgram` ``run(prompt (1, Pb) i32, last_idx,
    pool_k, pool_v, block_ids (Pb//bs,) i64, generator) -> (first_token
    () i32, pool_k, pool_v)``. The prompt (padded to the bucket ``Pb``)
    fills a dense cache, which is cut into ``Pb // block_size`` blocks
    and written into the pools at ``block_ids`` in place (ids past the
    prompt's real blocks point at the trash block, which may repeat);
    the first token is sampled from the logits at ``last_idx``, the last
    real prompt position: an int or a (1,) int64 tensor, read on the
    device, so that one graph serves every prompt of the bucket.
    ``graph_pool`` lets the buckets' graphs share one memory pool;
    ``weight_dtype`` / ``int8_weights`` as :func:`paged_decode_program`'s."""
    cache_dtype = _resolve_cache_dtype(model, kv_cache_dtype)
    tree = _resolve_weights(model, weight_dtype, int8_weights)
    pb, bs = int(prefill_len), int(block_size)
    if pb % bs:
        raise MXNetError(
            f"prefill bucket {pb} must be a multiple of block_size {bs}")
    nb = pb // bs

    def body(prompt, last_idx, pool_k, pool_v, block_ids, generator):
        with torch.no_grad():
            ck, cv = model.init_cache(1, pb, dtype=cache_dtype)
            logits, ck, cv = _with_weights(model, tree, model.decode_step,
                                           prompt, ck, cv, 0)
            lyr, _, heads, _, dp = ck.shape

            def blocks(c):              # (L,1,H,Pb,D') -> (L,nb,H,bs,D')
                return c[:, 0].reshape(lyr, heads, nb, bs, dp).permute(
                    0, 2, 1, 3, 4)

            pool_k[:, block_ids] = blocks(ck)
            pool_v[:, block_ids] = blocks(cv)
            last = logits.index_select(1, last_idx)[:, 0]
            first = _sample(last, generator, greedy, temperature, top_k)[0]
        return first, pool_k, pool_v

    return GraphedProgram(
        "llm.prefill", body, (0, 1, 4),
        (id(model), pb, bs, cache_dtype, bool(greedy), float(temperature),
         int(top_k), weight_dtype, _weights_key(tree)), not greedy,
        graph_pool)


def paged_suffix_prefill_program(model, *, suffix_len, block_size,
                                 weight_dtype=None, int8_weights=None,
                                 greedy=True, temperature=1.0, top_k=0,
                                 graph_pool=None):
    """The shared-prefix suffix prefill for one suffix-length bucket
    (``generation.py:520`` of the reference).

    Returns a :class:`GraphedProgram` ``run(suffix (1, Sb) i32,
    start_pos, last_idx, pool_k, pool_v, block_table (1, MB) i32,
    generator) -> (first_token () i32, pool_k, pool_v)``. The suffix runs
    as ONE paged step of T = Sb tokens from ``start_pos`` (block-aligned,
    the end of the cached prefix): its K/V are written through the
    lane's table and each token attends the pool up to its own position,
    so the cached prefix blocks feed attention without being computed
    again. The first token is sampled at ``last_idx``, the last real
    token's index within the suffix. ``start_pos`` and ``last_idx`` are
    ints or (1,) int64 tensors, read on the device. Pad tokens past
    ``last_idx`` write into lane-owned slots that decode overwrites
    later, or into the trash block where the table points there.
    ``weight_dtype`` / ``int8_weights`` as :func:`paged_decode_program`'s."""
    tree = _resolve_weights(model, weight_dtype, int8_weights)
    sb, bs = int(suffix_len), int(block_size)
    if sb % bs:
        raise MXNetError(
            f"suffix bucket {sb} must be a multiple of block_size {bs}")

    def body(suffix, start_pos, last_idx, pool_k, pool_v, block_table,
             generator):
        with torch.no_grad():
            pos = start_pos.reshape(1).to(torch.int32)
            logits, pool_k, pool_v = _with_weights(
                model, tree, model.decode_step_paged, suffix, pool_k,
                pool_v, block_table, pos)
            last = logits.index_select(1, last_idx)[:, 0]
            first = _sample(last, generator, greedy, temperature, top_k)[0]
        return first, pool_k, pool_v

    return GraphedProgram(
        "llm.prefill_suffix", body, (0, 1, 2, 5),
        (id(model), sb, bs, bool(greedy), float(temperature), int(top_k),
         weight_dtype, _weights_key(tree)), not greedy, graph_pool)


# -- speculative decoding (draft proposes, the target verifies) ------------
def _policy_probs(logits, greedy, temperature, top_k):
    """The :func:`_sample` policy as probabilities (..., V) f32: greedy
    is the argmax one-hot (verify then matches tokens exactly)."""
    logits = logits.float()
    if greedy:
        best = torch.argmax(logits, dim=-1)
        return torch.nn.functional.one_hot(best, logits.shape[-1]).float()
    logits = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth,
                             torch.full_like(logits, float("-inf")), logits)
    return torch.softmax(logits, dim=-1)


def _spec_accept_draws(target_logits, draft_logits, draft_toks, u, gumbel,
                       greedy, temperature, top_k):
    """Exact rejection sampling over one verified draft window
    (``generation.py:599`` of the reference), given its draws.

    ``target_logits`` (R, K+1, V): the target over ``[last, d_0 ..
    d_{K-1}]``, row ``i`` its distribution after ``i`` draft tokens;
    ``draft_logits`` (R, K, V); ``draft_toks`` (R, K). ``u`` (R, K) are
    uniform draws in [0, 1) and ``gumbel`` (R, V) Gumbel noise, the two
    draws the reference takes (``jax.random.uniform`` and the noise of
    ``jax.random.categorical``); greedy reads neither. Returns
    ``(out (R, K+1) i32, n_acc (R,) i32)``: ``out[:n_acc]`` are the
    accepted draft tokens and ``out[n_acc]`` the correction (or, after
    K acceptances, the bonus token).

    Greedy accepts while the draft equals the target argmax, so the
    emitted tokens are the plain greedy stream. Sampled accepts ``d_i``
    with probability ``min(1, p_i(d_i) / q_i(d_i))`` and draws the
    correction from ``norm(max(p - q, 0))`` (from ``p_K`` after K
    acceptances: q's zero-padded row), so the emitted tokens follow
    plain sampling exactly."""
    r, kp1, v = target_logits.shape
    k = kp1 - 1
    draft_toks = draft_toks.to(torch.int32)
    if greedy:
        tgt = torch.argmax(target_logits, dim=-1).to(torch.int32)
        acc = torch.cumprod((tgt[:, :k] == draft_toks).to(torch.int32), 1)
        n_acc = acc.sum(1).to(torch.int32)
        correction = torch.gather(tgt, 1, n_acc.long()[:, None])
    else:
        p = _policy_probs(target_logits, greedy, temperature, top_k)
        q = _policy_probs(draft_logits, greedy, temperature, top_k)
        idx = draft_toks.long()[:, :, None]
        p_d = torch.gather(p[:, :k], 2, idx)[..., 0]
        q_d = torch.gather(q, 2, idx)[..., 0]
        # u < p/q without the divide (q > 0 wherever the draft sampled)
        acc = torch.cumprod((u * q_d < p_d).to(torch.int32), 1)
        n_acc = acc.sum(1).to(torch.int32)
        qz = torch.cat([q, q.new_zeros((r, 1, v))], dim=1)
        sel = n_acc.long()[:, None, None].expand(r, 1, v)
        p_sel = torch.gather(p, 1, sel)[:, 0]
        q_sel = torch.gather(qz, 1, sel)[:, 0]
        resid = torch.clamp(p_sel - q_sel, min=0.0)
        tot = resid.sum(-1, keepdim=True)
        # p == q exactly: the residual underflows, and a draw from p is
        # then the right distribution
        resid = torch.where(tot > 1e-20,
                            resid / torch.clamp(tot, min=1e-20), p_sel)
        correction = torch.argmax(
            gumbel + torch.log(torch.clamp(resid, min=1e-30)),
            dim=-1).to(torch.int32)[:, None]
    cols = torch.arange(kp1, device=target_logits.device)[None]
    padded = torch.cat([draft_toks, draft_toks.new_zeros((r, 1))], dim=1)
    out = torch.where(cols < n_acc[:, None], padded,
                      correction.expand(r, kp1))
    return out.to(torch.int32), n_acc


def _spec_accept(target_logits, draft_logits, draft_toks, generator,
                 greedy, temperature, top_k):
    """:func:`_spec_accept_draws` with its draws taken from
    ``generator``: ``u`` uniform in [0, 1), float64 as the reference
    draws it (it runs with 64-bit types on), and float32 Gumbel noise
    ``-log(-log(U))``, U uniform in [tiny, 1), as ``jax.random.gumbel``
    draws it. Greedy draws nothing."""
    u = gumbel = None
    if not greedy:
        r, kp1, v = target_logits.shape
        dev = target_logits.device
        u = torch.rand((r, kp1 - 1), generator=generator, device=dev,
                       dtype=torch.float64)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(torch.rand(
            (r, v), generator=generator, device=dev), min=tiny)))
    return _spec_accept_draws(target_logits, draft_logits, draft_toks, u,
                              gumbel, greedy, temperature, top_k)


def paged_spec_draft_program(model, *, draft_k, greedy=True,
                             temperature=1.0, top_k=0, graph_pool=None):
    """The draft's proposal (``generation.py:664`` of the reference): K
    single-token steps of the draft model in ONE program.

    Returns a :class:`GraphedProgram` ``run(prev_tok (R, 1) i32,
    last_tok (R, 1) i32, pool_k, pool_v, block_table (R, MB) i32,
    positions (R,) i32, generator) -> (draft_toks (R, K) i32,
    draft_logits (R, K, V) f32, pool_k, pool_v)``. ``positions[r]`` is
    where ``last_tok`` is written (the lane's length); ``prev_tok``, the
    token at ``positions - 1``, is forwarded again first, to fill the
    draft pool's row a fully accepted round leaves unwritten (rewriting
    a row that is there already). The draft pools only move the
    acceptance rate: the target verifies every proposal."""
    kk = int(draft_k)
    if kk < 1:
        raise MXNetError(f"draft_k must be >= 1, got {kk}")

    def body(prev_tok, last_tok, pool_k, pool_v, block_table, positions,
             generator):
        with torch.no_grad():
            pos = positions.to(torch.int32)
            _, pool_k, pool_v = model.decode_step_paged(
                prev_tok, pool_k, pool_v, block_table,
                torch.clamp(pos - 1, min=0))
            tok = last_tok
            toks, lgs = [], []
            for i in range(kk):
                lg, pool_k, pool_v = model.decode_step_paged(
                    tok, pool_k, pool_v, block_table, pos + i)
                lg = lg[:, -1].float()
                nxt = _sample(lg, generator, greedy, temperature, top_k)
                toks.append(nxt)
                lgs.append(lg)
                tok = nxt[:, None]
        return torch.stack(toks, 1), torch.stack(lgs, 1), pool_k, pool_v

    return GraphedProgram(
        "llm.draft", body, (0, 1, 4, 5),
        (id(model), kk, bool(greedy), float(temperature), int(top_k)),
        not greedy, graph_pool)


def paged_spec_verify_program(model, *, draft_k, weight_dtype=None,
                              int8_weights=None, greedy=True,
                              temperature=1.0, top_k=0, graph_pool=None):
    """The target's verification (``generation.py:729`` of the
    reference): ``[last_tok, d_0 .. d_{K-1}]`` in ONE (R, K+1) paged
    forward, then :func:`_spec_accept`.

    Returns a :class:`GraphedProgram` ``run(last_tok (R, 1) i32,
    draft_toks (R, K) i32, draft_logits (R, K, V) f32, pool_k, pool_v,
    block_table (R, MB) i32, positions (R,) i32, generator) -> (out
    (R, K+1) i32, n_acc (R,) i32, pool_k, pool_v)``. The draft's tokens
    and logits are used where they lie (on the card, the draft graph's
    outputs: their addresses are part of the key). The forward writes
    K+1 rows per lane at ``positions + [0 .. K]``; rows past the
    accepted ones are masked by length until the next round writes them
    again, so a rollback is just not advancing ``positions``.
    ``weight_dtype`` / ``int8_weights`` as :func:`paged_decode_program`'s
    (the draft program never takes them, as the reference's)."""
    kk = int(draft_k)
    if kk < 1:
        raise MXNetError(f"draft_k must be >= 1, got {kk}")
    tree = _resolve_weights(model, weight_dtype, int8_weights)

    def body(last_tok, draft_toks, draft_logits, pool_k, pool_v,
             block_table, positions, generator):
        with torch.no_grad():
            tokens = torch.cat([last_tok.to(torch.int32),
                                draft_toks.to(torch.int32)], dim=1)
            logits, pool_k, pool_v = _with_weights(
                model, tree, model.decode_step_paged, tokens, pool_k,
                pool_v, block_table, positions.to(torch.int32))
            out, n_acc = _spec_accept(logits.float(), draft_logits,
                                      draft_toks, generator, greedy,
                                      temperature, top_k)
        return out, n_acc, pool_k, pool_v

    return GraphedProgram(
        "llm.verify", body, (0, 5, 6),
        (id(model), kk, bool(greedy), float(temperature), int(top_k),
         weight_dtype, _weights_key(tree)), not greedy, graph_pool)
