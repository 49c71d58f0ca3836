"""Autoregressive generation of the PyTorch port (counterpart of
``mxnet_tpu/gluon/model_zoo/generation.py``).

:func:`generate` is the dense-cache offline oracle, and
:func:`paged_decode_program` / :func:`paged_prefill_program` return the
two programs the serving engine calls (one decode step over the whole
lane set, one prefill-and-splice per prompt bucket). Sampling draws from
an explicit ``torch.Generator``.

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

import time
from typing import Dict, Optional

import numpy as onp
import torch

from ...base import MXNetError, matmul_precision
from ...context import resolve_device
from ...ops.kernels import _build
from ...ops.kernels.fused_decode import fused_decode_armed
from ...ops.nn import kernels_enabled

__all__ = ["generate", "paged_decode_program", "paged_prefill_program",
           "GraphedProgram"]

_KV_CACHE_DTYPES = (None, "int8", "float32", "bfloat16", "float16")


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


def generate(model, prompt_ids, max_new_tokens: int,
             max_length: Optional[int] = None, greedy: bool = True,
             temperature: float = 1.0, top_k: int = 0, eos_token: int = -1,
             seed: int = 0, kv_cache_dtype: Optional[str] = None,
             device=None):
    """Generate ``max_new_tokens`` continuations of ``prompt_ids`` (B, P)
    through a dense per-batch KV cache. Returns a (B, max_new_tokens)
    int32 tensor on the model's device. Once a sequence emits
    ``eos_token``, its remaining positions repeat it."""
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
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with torch.no_grad():
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
    model's parameters where they lay at capture. :meth:`eager` runs the
    body itself on the same inputs; on the CPU every call does.
    ``captures``, ``replays`` and ``capture_s`` count the program's
    graphs."""

    def __init__(self, label, body, fed, settings, sampling,
                 graph_pool=None):
        self.label = label
        self._body = body
        self._fed = tuple(fed)
        self._settings = settings
        self._sampling = sampling
        self._pool = graph_pool
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
        return fed, held, held[0].device

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
            self._body(*inputs, generator)
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
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return _Captured(graph, static, out, tuple(launches))


def paged_decode_program(model, *, greedy=True, temperature=1.0, top_k=0,
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
    per key."""

    def body(tokens, pool_k, pool_v, block_table, positions, generator):
        with torch.no_grad():
            logits, pool_k, pool_v = model.decode_step_paged(
                tokens, pool_k, pool_v, block_table, positions)
            nxt = _sample(logits[:, -1], generator, greedy, temperature,
                          top_k)
        return nxt, pool_k, pool_v

    return GraphedProgram(
        "llm.decode", body, (0, 3, 4),
        (id(model), bool(greedy), float(temperature), int(top_k)),
        not greedy, graph_pool)


def paged_prefill_program(model, *, prefill_len, block_size,
                          kv_cache_dtype=None, greedy=True, temperature=1.0,
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
    ``graph_pool`` lets the buckets' graphs share one memory pool."""
    cache_dtype = _resolve_cache_dtype(model, kv_cache_dtype)
    pb, bs = int(prefill_len), int(block_size)
    if pb % bs:
        raise MXNetError(
            f"prefill bucket {pb} must be a multiple of block_size {bs}")
    nb = pb // bs

    def body(prompt, last_idx, pool_k, pool_v, block_ids, generator):
        with torch.no_grad():
            ck, cv = model.init_cache(1, pb, dtype=cache_dtype)
            logits, ck, cv = model.decode_step(prompt, ck, cv, 0)
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
         int(top_k)), not greedy, graph_pool)
