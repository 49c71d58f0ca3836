"""``LLMEngine`` — continuous-batching autoregressive generation on the
PyTorch port (counterpart of ``mxnet_tpu/serving/llm.py``).

- **Paged KV-cache block pool** — the cache is a pool of fixed-size
  (block_size x heads x head_dim) blocks plus a per-lane block table;
  ``decode_step_paged`` writes and attends through the table (on the
  card: the K5a -> K4 -> K5b kernels per layer). int8 KV is the default.
  Blocks return to the free list the moment a sequence finishes.
- **Prefill/decode split** — prompts prefill padded to pow2 buckets of
  blocks into a dense cache whose blocks are spliced into the pool;
  decode runs ONE step over all ``max_running`` lanes, retired lanes
  pointed at a trash block.
- **In-flight (continuous) batching** — the scheduler thread admits new
  sequences into empty lanes every step, layered on :mod:`.admission`
  deadlines/shedding, with EOS/length retirement and per-token
  streaming.
- **Speculative decoding** (``draft_model``) — each round a small draft
  model proposes ``draft_k`` tokens per lane and the target scores them
  all in one (R, K+1) forward with exact rejection sampling, so a lane
  advances ``n_acc + 1`` tokens a round; the draft keeps its own pools
  under the same block ids.
- **Shared-prefix block cache** (``prefix_cache``) — blocks are
  refcounted; a prompt's full blocks stay resident under their chain
  hashes (:mod:`.kv_hash`), a later prompt with the same prefix shares
  them read-only and prefills only its suffix, and cache-only residents
  are evicted LRU when an admission needs blocks.
- **Tiered KV spill** (``kv_spill``) — an evicted prefix block's exact
  pool rows park in a host-RAM tier, optionally demoting to a disk tier
  (:mod:`.kv_spill`); a later prompt whose prefix hits a spill tier
  copies the rows back into fresh pool blocks instead of prefilling
  them again.
- **Weight-only int8** (``weight_dtype="int8"``) — the model is
  quantized once when the engine is built; every target program
  dequantizes inside its step.

The scheduler thread launches all device work on the engine's device
(on ``torch.cuda.current_stream(device)``); the sampled tokens come back
with ``.cpu()``, which is the step's synchronisation point. On a CUDA
device every program replays CUDA graphs (the counterpart of the
reference's compiled programs): :meth:`LLMEngine.warmup` captures the
decode step (and the draft and verify programs) and the prefill buckets
of given prompt lengths or of a :class:`~mxnet_tpu_torch.aot.WarmupManifest`
ahead of traffic, and a bucket not yet warmed (every suffix bucket) is
captured at its first use. The lane state (tokens, block table,
positions, the previous token) lives in pinned host memory that each
step copies into the graphs' static buffers.

Observability is the reference's: the ``llm_*`` families of
:class:`LLMMetrics` in the telemetry registry, the ``llm_prefill`` /
``llm_decode`` / ``llm_spec`` step spans (a ``device`` phase each,
annotated with the requests' trace ids), the chaos sites ``serving.llm``
(prefill splice) and ``serving.llm.verify`` (draft-verify), and faults
typed through :func:`~mxnet_tpu_torch.resilience.retry.classify`.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

import numpy as onp
import torch

from .. import telemetry
from ..aot import WarmupManifest
from ..base import FatalError, MXNetError, TransientError, env_float
from ..gluon.model_zoo.generation import (
    GraphedProgram, _model_device, _resolve_cache_dtype, _resolve_weights,
    paged_decode_program, paged_prefill_program, paged_spec_draft_program,
    paged_spec_verify_program, paged_suffix_prefill_program)
from ..resilience import chaos
from ..resilience.retry import TRANSIENT, classify
from ..telemetry import get_registry
from . import kv_hash
from .admission import (AdmissionQueue, DeadlineExceeded, Request,
                        RequestCancelled, ServerOverload)
from .kv_spill import KVSpillTier, spill_dir_from_env, spill_peers_from_env

__all__ = ["LLMEngine", "GenRequest", "LLMMetrics"]

_FLEET_WAITS = ("ROADMAP section 1 item 7 (the fleet and the "
                "disaggregation router)")


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at ``cap`` (cap itself is
    always a valid bucket even when not a power of two)."""
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


def _typed(exc: BaseException, what: str) -> MXNetError:
    """Type a fault through the classifier: the port's Transient/Fatal
    errors pass through, anything else becomes the one its class says
    (the reference's arithmetic at ``llm.py:1099, 1225, 1547``)."""
    if isinstance(exc, (TransientError, FatalError)):
        return exc
    cls = TransientError if classify(exc) == TRANSIENT else FatalError
    typed = cls(f"{what}: {exc!r}")
    typed.__cause__ = exc
    return typed


class GenRequest(Request):
    """One in-flight generation request.

    ``wait()`` returns the generated tokens as an int32 numpy array
    (length <= ``max_new_tokens``; generation stops after the first
    ``eos_token``, which is included). ``on_token`` (optional) streams
    each token from the scheduler thread as it is decoded — it must be
    cheap and must not raise (a raising callback fails the request).
    ``trace_id`` is the request's distributed-trace identity: the
    scheduler stamps it into the step spans of every step that served
    the request."""

    __slots__ = ("prompt", "max_new_tokens", "eos_token", "on_token",
                 "tokens", "prefill_s", "first_token_s", "trace_id")

    def __init__(self, prompt, max_new_tokens: int, eos_token: int,
                 deadline: Optional[float],
                 on_token: Optional[Callable[[int], None]] = None,
                 trace_id: Optional[str] = None):
        super().__init__(prompt, 1, ("llm",), deadline)
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token = int(eos_token)
        self.on_token = on_token
        self.tokens: List[int] = []
        self.prefill_s: Optional[float] = None
        self.first_token_s: Optional[float] = None
        self.trace_id = trace_id


class _Lane:
    """One decode lane: the request it carries + its block reservation."""

    __slots__ = ("req", "blocks", "pos", "last_token")

    def __init__(self, req: GenRequest, blocks: List[int], pos: int,
                 last_token: int):
        self.req = req
        self.blocks = blocks        # pool block ids owned by this lane
        self.pos = pos              # absolute position of the NEXT write
        self.last_token = last_token


class LLMMetrics:
    """Registry-backed metrics for one :class:`LLMEngine` (the
    reference's families, names and labels, so either package's
    exposition reads the same; labelled ``engine=`` so several engines
    expose side by side). It is also the :class:`.admission.AdmissionQueue`
    metrics seam (``count`` / ``observe_queue_depth``). The sharding and
    handoff families are registered, as the reference's are, and stay at
    one device and zero blocks until ROADMAP section 1 items 7 and 8."""

    _EVENTS = ("submitted", "admitted", "completed", "failed",
               "shed_overload", "shed_deadline", "retired_deadline",
               "cancelled", "prefills",
               "decode_steps", "spec_steps", "resets", "compiles")

    def __init__(self, engine_id: str):
        reg = get_registry()
        self.engine_id = engine_id
        eng = {"engine": engine_id}
        self._events = reg.counter(
            "llm_events_total", "LLM serving lifecycle events",
            ("engine", "event"))
        self._counters = {e: self._events.labels(engine=engine_id, event=e)
                         for e in self._EVENTS}
        self._tokens = reg.counter(
            "llm_tokens_total", "Generated tokens", ("engine", "phase"))
        self.tokens_prefill = self._tokens.labels(engine=engine_id,
                                                  phase="prefill")
        self.tokens_decode = self._tokens.labels(engine=engine_id,
                                                 phase="decode")
        self.lanes_active = reg.gauge(
            "llm_lanes_active", "Decode lanes currently generating",
            ("engine",)).labels(**eng)
        self.lanes_total = reg.gauge(
            "llm_lanes_total", "Configured decode lanes (max_running)",
            ("engine",)).labels(**eng)
        self.pool_free = reg.gauge(
            "llm_pool_blocks_free", "KV pool blocks on the free list",
            ("engine",)).labels(**eng)
        self.pool_total = reg.gauge(
            "llm_pool_blocks_total", "KV pool blocks (allocatable)",
            ("engine",)).labels(**eng)
        self.tok_s = reg.gauge(
            "llm_tok_s", "Aggregate decode tokens/s (rolling)",
            ("engine",)).labels(**eng)
        self.step_ms = reg.histogram(
            "llm_step_ms", "Wall ms per scheduler step",
            ("engine", "phase"))
        self.decode_ms = self.step_ms.labels(engine=engine_id,
                                             phase="decode")
        self.prefill_ms = self.step_ms.labels(engine=engine_id,
                                              phase="prefill")
        self.spec_ms = self.step_ms.labels(engine=engine_id,
                                           phase="draft_verify")
        # speculative decoding: proposed vs accepted draft tokens (the
        # acceptance-rate numerator/denominator, cumulative) + the gauge
        self._spec_tokens = reg.counter(
            "llm_spec_tokens_total",
            "Speculative-decode draft tokens", ("engine", "result"))
        self.spec_proposed = self._spec_tokens.labels(engine=engine_id,
                                                      result="proposed")
        self.spec_accepted = self._spec_tokens.labels(engine=engine_id,
                                                      result="accepted")
        self.draft_acceptance_rate = reg.gauge(
            "llm_draft_acceptance_rate",
            "Cumulative accepted/proposed draft-token ratio",
            ("engine",)).labels(**eng)
        # prefix cache: prompt tokens served from resident blocks vs
        # prefilled, + the cumulative hit-rate gauge
        self._prefix_tokens = reg.counter(
            "llm_prefix_tokens_total",
            "Prompt tokens by prefix-cache outcome", ("engine", "result"))
        self.prefix_hit_tokens = self._prefix_tokens.labels(
            engine=engine_id, result="hit")
        self.prefix_miss_tokens = self._prefix_tokens.labels(
            engine=engine_id, result="miss")
        self.prefix_hit_rate = reg.gauge(
            "llm_prefix_hit_rate",
            "Cumulative prefix-cache hit ratio over prompt tokens",
            ("engine",)).labels(**eng)
        self.prefix_cached_blocks = reg.gauge(
            "llm_prefix_cached_blocks",
            "Pool blocks resident in the prefix cache",
            ("engine",)).labels(**eng)
        # tiered KV spill: eviction no longer means re-prefill — count
        # what left the pool, what is parked in the host tier, and what
        # came back by a copy instead of compute (per source tier)
        self.prefix_evictions = reg.counter(
            "llm_prefix_evictions_total",
            "Prefix-cache blocks evicted from the HBM pool (spilled "
            "when the spill tier is armed, dropped otherwise)",
            ("engine",)).labels(**eng)
        self.kv_spill_blocks = reg.gauge(
            "llm_kv_spill_blocks",
            "KV blocks resident in the host-RAM spill tier",
            ("engine",)).labels(**eng)
        self.kv_spill_bytes = reg.gauge(
            "llm_kv_spill_bytes",
            "Bytes held by the host-RAM spill tier",
            ("engine",)).labels(**eng)
        self._kv_reattach = reg.counter(
            "llm_kv_reattach_total",
            "Spilled KV blocks re-attached into the pool by source tier",
            ("engine", "tier"))
        # sharding: mesh width + per-device KV footprint
        self.shard_devices = reg.gauge(
            "llm_shard_devices",
            "Devices in the serving mesh (1 = unsharded)",
            ("engine",)).labels(**eng)
        self.shard_pool_bytes = reg.gauge(
            "llm_shard_pool_bytes_per_device",
            "KV pool bytes resident per device (head-sharded over tp)",
            ("engine",)).labels(**eng)
        # disaggregated serving: blocks a prefill-role engine exported
        self.handoff_exported = reg.counter(
            "llm_handoff_exported_blocks_total",
            "KV blocks exported by a prefill-role engine for handoff",
            ("engine",)).labels(**eng)
        self.token_latency_ms = reg.histogram(
            "llm_token_latency_ms",
            "Per-token latency (decode step wall / tokens in step)",
            ("engine",)).labels(**eng)
        self.queue_depth = reg.histogram(
            "llm_queue_depth", "Queue depth at admission",
            ("engine",)).labels(**eng)

    def observe_spec(self, proposed: int, accepted: int) -> None:
        self.spec_proposed.inc(proposed)
        self.spec_accepted.inc(accepted)
        tot = float(self.spec_proposed.value)
        if tot > 0:
            self.draft_acceptance_rate.set(
                float(self.spec_accepted.value) / tot)

    def count_reattach(self, tier: str, n: int = 1) -> None:
        self._kv_reattach.labels(engine=self.engine_id, tier=tier).inc(n)

    def observe_prefix(self, hit: int, miss: int) -> None:
        self.prefix_hit_tokens.inc(hit)
        self.prefix_miss_tokens.inc(miss)
        tot = (float(self.prefix_hit_tokens.value)
               + float(self.prefix_miss_tokens.value))
        if tot > 0:
            self.prefix_hit_rate.set(
                float(self.prefix_hit_tokens.value) / tot)

    # AdmissionQueue calls these two (the ServingMetrics seam)
    def count(self, name: str, delta: int = 1) -> None:
        c = self._counters.get(name)
        if c is None:
            c = self._events.labels(engine=self.engine_id, event=name)
            self._counters[name] = c
        c.inc(delta)

    def observe_queue_depth(self, depth: int) -> None:
        self.queue_depth.observe(float(depth))

    def counters(self) -> Dict[str, int]:
        return {name: int(c.value) for name, c in self._counters.items()}



_engine_seq = itertools.count()


def _pool_to_host(rows: torch.Tensor) -> onp.ndarray:
    """Pool rows as a numpy array of the same bytes (bfloat16, which
    numpy lacks, as its int16 bit pattern)."""
    if rows.dtype == torch.bfloat16:
        rows = rows.view(torch.int16)
    return rows.numpy()


class LLMEngine:
    """Continuous-batching generation over a paged KV block pool.

    Parameters
    ----------
    model : causal LM with ``decode_step_paged`` / ``init_block_pool``
        and the dense ``decode_step`` / ``init_cache`` used by prefill
        (:class:`~mxnet_tpu_torch.gluon.model_zoo.bert._CausalLM`), whose
        parameters lie on ``device``.
    device : torch.device or str, optional
        Where the engine runs. Default ``gpu(0)``: without a card it
        raises; the CPU runs only when asked for (``device="cpu"``).
    max_running : int
        Decode lanes. Default ``MXNET_TPU_LLM_MAX_RUNNING`` (8).
    block_size : int
        Positions per KV block. Default ``MXNET_TPU_LLM_BLOCK_SIZE`` (16).
    max_context : int
        Longest prompt+generation a lane may hold. Defaults to the
        model's context window (``pos_embed`` rows), capped at 2048.
    num_blocks : int
        Pool capacity in blocks (+1 trash block is added internally).
        Default ``MXNET_TPU_LLM_POOL_BLOCKS``, else enough for every lane
        at ``max_context``. A request is admitted only when its
        worst-case ``ceil((prompt+max_new)/block_size)`` reservation
        fits the free list.
    kv_cache_dtype : str
        ``"int8"`` (default) or ``"float32"/"bfloat16"/"float16"``.
    weight_dtype : None | "int8"
        Weight-only int8 for the target's programs (decode, prefill,
        suffix prefill, verify; the draft keeps its weights): the model
        is quantized once, here, and each step dequantizes. The tree is
        fixed for the engine's life, as the reference's is.
    greedy / temperature / top_k / seed
        Sampling policy; ``seed`` seeds the engine's ``torch.Generator``.
    max_queue_size / timeout_ms
        Admission bound and default end-to-end deadline.
    donate : bool, optional
        Accepted for the reference's signature and ignored: the
        reference donates the pools to its programs, and escalates a
        prefill fault to the full reset because the donated buffers may
        be gone. The port updates its pools in place (every captured
        graph holds their addresses), so nothing is ever gone and a
        prefill fault stays contained to its request.
    draft_model : causal LM, optional
        Arms speculative decoding: a small model of the same vocabulary
        on the same device proposes ``draft_k`` tokens per lane each
        round and the target verifies them in one forward; its pools
        share the target's block ids. Greedy tokens are the plain
        engine's; sampled ones follow the same distribution.
    draft_k : int
        Tokens proposed per round. Default ``MXNET_TPU_LLM_DRAFT_K`` (4).
        A request reserves ``draft_k`` positions of slack (verify writes
        that far past the accepted length), counted against
        ``max_context``.
    prefix_cache : bool
        Share resident prompt-prefix blocks between requests (refcounted,
        read-only; LRU eviction of cache-only blocks). Default
        ``MXNET_TPU_LLM_PREFIX_CACHE`` (off).
    kv_spill : bool
        Arms the tiered KV spill (requires ``prefix_cache``): an evicted
        prefix block's exact rows park in a host-RAM tier
        (:class:`~.kv_spill.KVSpillTier`), optionally demoting to a
        disk tier, and a later admission whose prefix hits a tier
        re-attaches the rows instead of prefilling them (token-identical:
        the payload is the raw pool rows). Default
        ``MXNET_TPU_LLM_KV_SPILL`` (off).
    kv_spill_bytes / kv_spill_dir
        The host tier's byte bound (``MXNET_TPU_LLM_KV_SPILL_BYTES``,
        256 MiB) and the disk tier's root
        (``MXNET_TPU_LLM_KV_SPILL_DIR``).
    step_hook : callable, optional
        Called at the top of every scheduler tick, inside the fault
        containment: an exception it raises is typed through the
        classifier like a program fault. It must be cheap.
    metrics : LLMMetrics, optional
        The engine's metrics; default a new :class:`LLMMetrics` labelled
        with the next engine number.

    Not carried yet: ``kv_spill_serve``, ``kv_spill_peers`` and ``role``
    (the remote spill tier and disaggregated serving, ROADMAP section 1
    item 7), and ``mesh`` / ``rules`` (sharded serving, item 8). Each
    raises when asked for.

    A request's ``timeout_ms`` deadline is an end-to-end budget; a lane
    whose deadline passes mid-decode, or whose request was cancelled,
    is retired at the next tick.
    """

    def __init__(self, model, *, device=None,
                 max_running: Optional[int] = None,
                 block_size: Optional[int] = None,
                 max_context: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 kv_cache_dtype: Optional[str] = "int8",
                 weight_dtype: Optional[str] = None,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, seed: int = 0, eos_token: int = -1,
                 max_queue_size: int = 256,
                 timeout_ms: Optional[float] = None,
                 donate: Optional[bool] = None,
                 draft_model=None, draft_k: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 kv_spill: Optional[bool] = None,
                 kv_spill_bytes: Optional[int] = None,
                 kv_spill_dir: Optional[str] = None,
                 kv_spill_serve: Optional[bool] = None,
                 kv_spill_peers: Optional[List[str]] = None,
                 step_hook: Optional[Callable[[], None]] = None,
                 metrics: Optional[LLMMetrics] = None,
                 mesh=None, rules=None, role: Optional[str] = None):
        if role is not None:
            raise MXNetError(
                f"role={role!r}: disaggregated serving is not ported; it "
                f"waits for {_FLEET_WAITS}")
        if mesh is not None or rules is not None:
            raise MXNetError(
                "mesh= / rules=: sharded serving is not ported (ROADMAP "
                "section 1 item 8, parallel and distributed)")
        self.device = _model_device(model, device)
        if max_running is None:
            max_running = int(env_float("MXNET_TPU_LLM_MAX_RUNNING", 8))
        if block_size is None:
            block_size = int(env_float("MXNET_TPU_LLM_BLOCK_SIZE", 16))
        if max_running < 1 or block_size < 1:
            raise ValueError("max_running and block_size must be >= 1")
        self.max_running = int(max_running)
        self.block_size = int(block_size)
        model_ctx = int(model.pos_embed.shape[0])
        if max_context is None:
            max_context = min(model_ctx, 2048)
        if max_context > model_ctx:
            raise MXNetError(
                f"max_context {max_context} exceeds the model's context "
                f"window (pos_embed rows = {model_ctx})")
        self.max_context = int(max_context)
        self.max_blocks_per_seq = -(-self.max_context // self.block_size)
        if num_blocks is None:
            num_blocks = int(env_float("MXNET_TPU_LLM_POOL_BLOCKS", 0)) \
                or self.max_running * self.max_blocks_per_seq
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        self.num_blocks = int(num_blocks)
        self._kv_dtype = _resolve_cache_dtype(model, kv_cache_dtype)
        self._greedy = bool(greedy)
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._eos = int(eos_token)
        self._timeout_ms = timeout_ms
        self._model = model
        self._vocab = int(model.vocab_size)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # weight-only int8: quantized once, here; every target program
        # runs on this tree for the engine's life
        self._weight_dtype = weight_dtype
        t0 = time.perf_counter()
        self._int8 = _resolve_weights(model, weight_dtype)
        self._quantize_s = time.perf_counter() - t0

        # speculative decoding, armed by a draft model
        self._draft = draft_model
        self._spec = draft_model is not None
        if self._spec:
            _model_device(draft_model, self.device)
            if (int(draft_model.vocab_size) != self._vocab
                    or int(draft_model.pos_embed.shape[0])
                    < self.max_context):
                raise MXNetError(
                    "draft_model must share the target's vocabulary and "
                    f"hold max_context {self.max_context} positions")
        # positions a suffix bucket's pads may reach (every model's
        # pos_embed rows, and the block table)
        self._pad_end = min(
            [self.max_blocks_per_seq * self.block_size, model_ctx]
            + ([int(draft_model.pos_embed.shape[0])] if self._spec else []))
        if draft_k is None:
            draft_k = int(env_float("MXNET_TPU_LLM_DRAFT_K", 4))
        self._draft_k = max(int(draft_k), 1)
        # verify writes up to draft_k positions past the accepted
        # length: the block reservation carries that slack
        self._slack = self._draft_k if self._spec else 0
        # the shared-prefix block cache (off unless armed: with it off
        # the free list returns to full when every request is done)
        if prefix_cache is None:
            prefix_cache = bool(env_float("MXNET_TPU_LLM_PREFIX_CACHE", 0))
        self._prefix_on = bool(prefix_cache)

        # tiered KV spill under the pool, indexed by the same chain
        # hashes as the prefix cache
        if kv_spill is None:
            kv_spill = bool(env_float("MXNET_TPU_LLM_KV_SPILL", 0))
        self._spill: Optional[KVSpillTier] = None
        if kv_spill_serve or kv_spill_peers:
            raise MXNetError(
                "kv_spill_serve / kv_spill_peers (the remote spill tier) "
                f"are not ported; they wait for {_FLEET_WAITS}")
        if kv_spill:
            if not self._prefix_on:
                raise ValueError(
                    "kv_spill requires prefix_cache: spilled blocks are "
                    "indexed by the prefix cache's chain hashes")
            if kv_spill_serve is None:
                kv_spill_serve = bool(
                    env_float("MXNET_TPU_LLM_KV_SPILL_SERVE", 0))
            self._spill = KVSpillTier(
                bytes_limit=kv_spill_bytes,
                root=(kv_spill_dir if kv_spill_dir is not None
                      else spill_dir_from_env()),
                peers=spill_peers_from_env(), serve=bool(kv_spill_serve))
        # what the spill copies moved and took (host wall, synchronised)
        self._spill_io = {"save_bytes": 0, "save_s": 0.0,
                          "reattach_bytes": 0, "reattach_s": 0.0}
        # pool name -> block-major host staging rows of both spill
        # copies (pinned on a card), grown to the largest batch of blocks
        self._staging: Dict[str, torch.Tensor] = {}

        self.metrics = metrics or LLMMetrics(str(next(_engine_seq)))
        self.metrics.lanes_total.set(self.max_running)
        self.metrics.pool_total.set(self.num_blocks)
        self._decode_s = 0.0
        self._prefill_s = 0.0
        self._tokens_decode = 0

        # pool state: +1 trash block at index num_blocks — retired lanes
        # and pad splices write there, never into a live sequence
        self._trash = self.num_blocks
        self._pool_k, self._pool_v = model.init_block_pool(
            self.num_blocks + 1, self.block_size, dtype=self._kv_dtype)
        self._free: List[int] = list(range(self.num_blocks))
        self.metrics.pool_free.set(len(self._free))
        # per-block refcounts (lane ownership + prefix-cache residency):
        # a block returns to the free list only at refcount zero. Shared
        # blocks are never written (a suffix starts past them), so
        # sharing never copies
        self._ref: Dict[int, int] = {}
        # chain hash -> resident block id, in LRU order
        self._prefix: "OrderedDict[bytes, int]" = OrderedDict()
        self._prefix_hits = 0
        if self._spec:              # the draft's pools, same block ids
            self._dpool_k, self._dpool_v = draft_model.init_block_pool(
                self.num_blocks + 1, self.block_size, dtype=self._kv_dtype)
        self.metrics.shard_devices.set(1)
        self.metrics.shard_pool_bytes.set(sum(
            t.numel() * t.element_size() for t in self._pools()))

        # lane state on the host (pinned for a card), copied to the
        # device each step; the numpy arrays are views of the tensors
        self._lanes: List[Optional[_Lane]] = [None] * self.max_running
        pin = self.device.type == "cuda"
        self._bt_host = torch.full(
            (self.max_running, self.max_blocks_per_seq), self._trash,
            dtype=torch.int32, pin_memory=pin)
        self._pos_host = torch.zeros((self.max_running,), dtype=torch.int32,
                                     pin_memory=pin)
        self._toks_host = torch.zeros((self.max_running, 1),
                                      dtype=torch.int32, pin_memory=pin)
        # the token at positions - 1 of each lane (the draft's catch-up)
        self._prev_host = torch.zeros((self.max_running, 1),
                                      dtype=torch.int32, pin_memory=pin)
        self._bt = self._bt_host.numpy()
        self._pos = self._pos_host.numpy()
        self._toks = self._toks_host.numpy()
        self._prev = self._prev_host.numpy()

        self._sampling = dict(greedy=greedy, temperature=temperature,
                              top_k=top_k)
        self._decode_run = paged_decode_program(
            model, **self._target_weights(), **self._sampling)
        if self._spec:
            self._draft_run = paged_spec_draft_program(
                draft_model, draft_k=self._draft_k, **self._sampling)
            self._verify_run = paged_spec_verify_program(
                model, draft_k=self._draft_k, **self._target_weights(),
                **self._sampling)
        self._prefill_runs: Dict[int, GraphedProgram] = {}
        self._draft_prefill_runs: Dict[int, GraphedProgram] = {}
        self._suffix_runs: Dict[int, GraphedProgram] = {}
        self._draft_suffix_runs: Dict[int, GraphedProgram] = {}
        # one memory pool for every prefill-like graph (the target's and
        # the draft's prefill and suffix buckets)
        self._prefill_pool = (torch.cuda.graph_pool_handle() if pin
                              else None)
        self._warmup_manifest = WarmupManifest()
        self._warm: set = set()
        self._manifest_keyed: set = set()

        self._state_lock = threading.RLock()
        self._step_hook = step_hook
        self._step_seq = 0
        # scheduler liveness: monotonic stamp of the last completed tick
        # (a wedged scheduler stops advancing it)
        self.last_tick = time.monotonic()
        self._queue = AdmissionQueue(max_queue_size, self.metrics)
        self._closed = False
        self._broken: Optional[BaseException] = None
        self._close_lock = threading.Lock()
        # (t, n) of the last 5 s and the sum of their n: the rolling
        # tok/s gauge
        self._tok_window: deque = deque()
        self._tok_sum = 0
        # a step's bookkeeping, done while the card computes the next
        # step (:meth:`_flush`)
        self._deferred: List[tuple] = []
        self._thread = threading.Thread(target=self._loop,
                                        name="llm-scheduler", daemon=True)
        self._thread.start()

    def _target_weights(self) -> Dict:
        """The target programs' weight arguments (the engine's tree)."""
        return dict(weight_dtype=self._weight_dtype,
                    int8_weights=self._int8)

    def _pools(self) -> List[torch.Tensor]:
        pools = [self._pool_k, self._pool_v]
        if self._spec:
            pools += [self._dpool_k, self._dpool_v]
        return pools

    # -- prompt bucketing --------------------------------------------------
    def _prefill_bucket(self, p: int) -> int:
        """Smallest pow2 multiple of block_size >= p, capped at the
        block-covered context."""
        return self.block_size * _pow2_bucket(
            -(-p // self.block_size), self.max_blocks_per_seq)

    def _prefill_run(self, bucket: int, draft: bool = False
                     ) -> GraphedProgram:
        runs = self._draft_prefill_runs if draft else self._prefill_runs
        run = runs.get(bucket)
        if run is None:
            run = runs[bucket] = paged_prefill_program(
                self._draft if draft else self._model, prefill_len=bucket,
                block_size=self.block_size, kv_cache_dtype=self._kv_dtype,
                **({} if draft else self._target_weights()),
                **self._sampling, graph_pool=self._prefill_pool)
        return run

    def _suffix_run(self, bucket: int, draft: bool = False
                    ) -> GraphedProgram:
        runs = self._draft_suffix_runs if draft else self._suffix_runs
        run = runs.get(bucket)
        if run is None:
            run = runs[bucket] = paged_suffix_prefill_program(
                self._draft if draft else self._model, suffix_len=bucket,
                block_size=self.block_size,
                **({} if draft else self._target_weights()),
                **self._sampling, graph_pool=self._prefill_pool)
        return run

    # -- block accounting (refcounts + prefix cache) -----------------------
    def _incref(self, blk: int) -> None:
        self._ref[blk] = self._ref.get(blk, 0) + 1

    def _decref(self, blk: int) -> None:
        n = self._ref.get(blk, 0) - 1
        if n > 0:
            self._ref[blk] = n
            return
        self._ref.pop(blk, None)
        self._free.append(blk)

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks off the free list (refcount 1 each),
        evicting LRU prefix-cache entries nothing else references while
        the list is short; with the spill tier armed the evicted blocks'
        rows are saved there first. None when even that cannot cover
        ``n``."""
        evicted: List[tuple] = []
        while len(self._free) < n and self._prefix:
            for hsh, blk in self._prefix.items():   # LRU order
                if self._ref.get(blk, 0) == 1:      # cache-only resident
                    del self._prefix[hsh]
                    if self._spill is not None:
                        evicted.append((hsh, blk))
                    self.metrics.prefix_evictions.inc()
                    self._decref(blk)
                    break
            else:
                break                               # all cached blocks live
        if evicted:
            # the freed blocks' rows stay intact until this _alloc hands
            # them out below: _spill_save has copied them off by then
            self._spill_save(evicted)
        self.metrics.prefix_cached_blocks.set(len(self._prefix))
        if len(self._free) < n:
            return None
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._ref[b] = 1
        return got

    def evictable_blocks(self) -> int:
        """Prefix-cache residents nothing else references (refcount 1):
        the blocks ``_alloc`` reclaims on demand. An advisory read,
        taken without the scheduler's lock."""
        try:
            return sum(1 for b in list(self._prefix.values())
                       if self._ref.get(b, 0) == 1)
        except RuntimeError:
            return 0            # the snapshot raced a resize

    # -- tiered KV spill (host RAM / disk) ---------------------------------
    @property
    def kv_spill_endpoint(self) -> Optional[str]:
        """``host:port`` of this engine's spill server: None, as serving
        the tier to peers waits for ROADMAP section 1 item 7."""
        return None

    def set_kv_spill_peers(self, peers: List[str]) -> None:
        """(Re)wire the spill tier's remote peers: an empty list is a
        no-op, any peer raises (the remote tier waits for ROADMAP
        section 1 item 7)."""
        if peers:
            raise MXNetError(
                f"set_kv_spill_peers: the remote spill tier waits for "
                f"{_FLEET_WAITS}")

    def _stage(self, name: str, pool: torch.Tensor, n: int) -> torch.Tensor:
        """The first ``n`` blocks of ``name``'s host staging buffer,
        block-major ``(n, L, H, block_size, D')``: one contiguous
        region that each spill copy crosses in one DMA, pinned on a card
        so the copy runs at the link's rate. Kept for the engine's life
        and grown, at least twofold, to the largest batch of blocks
        asked for (pinning memory is slow: it happens a few times)."""
        buf = self._staging.get(name)
        if buf is None or buf.shape[0] < n:
            rows = n if buf is None else min(max(n, 2 * buf.shape[0]),
                                             pool.shape[1])
            buf = torch.empty((rows, pool.shape[0], *pool.shape[2:]),
                              dtype=pool.dtype,
                              pin_memory=self.device.type == "cuda")
            self._staging[name] = buf
        return buf[:n]

    def _spill_sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _spill_save(self, evicted: List[tuple]) -> None:
        """Copy the evicted blocks' exact pool rows (and the draft
        pools' when speculative decoding shares the block ids) into the
        spill tier: per pool one ``index_select`` on the block axis and
        one copy into the staging buffer, finished before the blocks are
        handed out again, then one numpy copy out of it. Each payload
        array is one block's ``(L, H, block_size, D')`` rows, int8's
        bitcast scale bytes included — the reference's layout, so blobs
        are the same bytes — and a view of that copy: one large array
        fills at the memory's rate, where a fresh array a block faults
        its pages in at a fraction of it. A save's blocks enter the
        tier together, next to each other in its LRU order."""
        t0 = time.perf_counter()
        ids = torch.tensor([blk for _, blk in evicted], dtype=torch.int64,
                           device=self.device)
        names = ("k", "v", "dk", "dv") if self._spec else ("k", "v")
        cols = {}
        for name, pool in zip(names, self._pools()):
            stage = self._stage(name, pool, len(evicted))
            stage.copy_(pool.transpose(0, 1).index_select(0, ids),
                        non_blocking=True)
            cols[name] = stage
        self._spill_sync()
        cols = {k: _pool_to_host(v).copy() for k, v in cols.items()}
        for i, (hsh, _) in enumerate(evicted):
            self._spill.put(hsh, {k: v[i] for k, v in cols.items()})
        self._spill_io["save_bytes"] += sum(int(v.nbytes)
                                            for v in cols.values())
        self._spill_io["save_s"] += time.perf_counter() - t0
        blocks, nbytes = self._spill.level()
        self.metrics.kv_spill_blocks.set(blocks)
        self.metrics.kv_spill_bytes.set(nbytes)

    def _reattach(self, ids: List[int], payloads: List[Dict],
                  tiers: List[str], hashes: List[bytes]) -> None:
        """Write re-attached payload rows into freshly allocated pool
        blocks, in place (``index_copy_``: every captured graph holds
        the pools' addresses), and admit them into the prefix cache as
        residents. Per pool the payloads are stacked into the staging
        buffer and cross in one copy."""
        t0 = time.perf_counter()
        idx = torch.tensor(ids, dtype=torch.int64, device=self.device)
        names = ("k", "v", "dk", "dv") if self._spec else ("k", "v")
        nbytes = 0
        for name, pool in zip(names, self._pools()):
            stage = self._stage(name, pool, len(ids))
            onp.stack([pl[name] for pl in payloads], axis=0,
                      out=_pool_to_host(stage))
            nbytes += stage.numel() * stage.element_size()
            rows = stage.to(self.device, non_blocking=True)
            pool.index_copy_(1, idx, rows.transpose(0, 1))
        # the staging rows are reused by the next copy only after this
        self._spill_sync()
        self._spill_io["reattach_bytes"] += nbytes
        self._spill_io["reattach_s"] += time.perf_counter() - t0
        for blk, hsh in zip(ids, hashes):
            if hsh not in self._prefix:
                self._prefix[hsh] = blk
                self._incref(blk)       # cache residency over the lane ref
        for t in tiers:
            self.metrics.count_reattach(t)
        self.metrics.prefix_cached_blocks.set(len(self._prefix))
        blocks, nbytes = self._spill.level()
        self.metrics.kv_spill_blocks.set(blocks)
        self.metrics.kv_spill_bytes.set(nbytes)

    # -- client surface ----------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               eos_token: Optional[int] = None, timeout_ms="default",
               on_token: Optional[Callable[[int], None]] = None,
               trace_id: Optional[str] = None) -> GenRequest:
        """Enqueue one prompt (1-D int sequence). Returns the
        :class:`GenRequest` handle; ``handle.wait()`` yields the
        generated int32 tokens. ``trace_id`` defaults to the thread's
        :func:`~mxnet_tpu_torch.telemetry.current_trace`. Raises
        :class:`ServerOverload` when the admission queue is full,
        ``ValueError`` for a request that could never run."""
        if self._closed:
            raise ServerOverload("LLM engine is closed")
        if self._broken is not None:
            raise ServerOverload(
                f"LLM engine stopped on a fatal fault: {self._broken!r}")
        prompt = onp.asarray(prompt_ids, onp.int32).reshape(-1)
        p = int(prompt.shape[0])
        if p < 1:
            raise ValueError("prompt must have >= 1 token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.min() < 0 or prompt.max() >= self._vocab:
            # an out-of-range id is a device-side assert on the card,
            # which would take the whole CUDA context down
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self._vocab})")
        # the host-side position bound: every position a lane writes
        # (verify's slack included) stays inside the context window
        slack_note = (f" (+ draft_k {self._slack} speculative slack)"
                      if self._slack else "")
        if p + max_new_tokens + self._slack > self.max_context:
            raise ValueError(
                f"prompt {p} + max_new_tokens {max_new_tokens}"
                f"{slack_note} exceeds max_context {self.max_context}")
        if -(-(p + max_new_tokens + self._slack) // self.block_size) \
                > self.num_blocks:
            raise ValueError(
                f"request needs more KV blocks than the whole pool holds "
                f"({self.num_blocks} x {self.block_size}){slack_note} — "
                "it could never be admitted")
        if timeout_ms == "default":
            timeout_ms = self._timeout_ms
        deadline = (time.monotonic() + timeout_ms / 1e3
                    if timeout_ms is not None else None)
        if trace_id is None:
            ctx = telemetry.current_trace()
            trace_id = ctx.trace_id if ctx is not None else None
        req = GenRequest(prompt, max_new_tokens,
                         self._eos if eos_token is None else eos_token,
                         deadline, on_token, trace_id=trace_id)
        self._queue.submit(req)         # may raise ServerOverload
        self.metrics.count("submitted")
        return req

    def generate(self, prompt_ids, max_new_tokens: int, **kw):
        """Blocking convenience: submit + wait."""
        return self.submit(prompt_ids, max_new_tokens, **kw).wait()

    # -- scheduler ---------------------------------------------------------
    def _loop(self) -> None:
        while True:
            try:
                idle = self._tick()
            except Exception as e:  # noqa: BLE001 — typed + contained
                self.last_tick = time.monotonic()
                if not self._fault(e):
                    return
                continue
            self.last_tick = time.monotonic()
            if idle is None:        # closed and drained
                return
            if idle:
                time.sleep(0.001)

    def _tick(self):
        """One scheduler iteration: the step hook, admit into free lanes,
        then run one decode step. Returns True when there is nothing to
        do, None when closed and drained."""
        with self._state_lock:
            if self._step_hook is not None:
                # inside the containment: a hook fault routes through
                # _fault like a program fault
                self._step_hook()
            self._sweep_lanes()
            active = [i for i in range(self.max_running)
                      if self._lanes[i] is not None]
            free = [i for i in range(self.max_running)
                    if self._lanes[i] is None]
            if free and (len(self._queue) or not active):
                got = self._queue.take(
                    max_items=len(free), max_wait_s=0.0,
                    poll_s=0.02 if not active else 1e-4)
                try:
                    while got:
                        self._admit(got.pop(0), free.pop(0))
                except Exception as e:
                    # siblings popped in the same take() are in neither a
                    # lane nor the queue: fail them typed, never orphan
                    for req in got:
                        req.fail(ServerOverload(
                            f"engine resetting mid-admission: {e!r}"))
                        self.metrics.count("failed")
                    raise
                active = [i for i in range(self.max_running)
                          if self._lanes[i] is not None]
            if not active:
                self._flush()
                if self._closed and not len(self._queue):
                    return None
                return True
            if self._spec:
                self._spec_step(active)
            else:
                self._decode_step(active)
            return False

    def _lanes_gauge(self) -> None:
        self.metrics.lanes_active.set(
            sum(1 for ln in self._lanes if ln is not None))

    def _sweep_lanes(self) -> None:
        """Retire lanes whose request was cancelled or whose end-to-end
        deadline passed mid-decode, freeing their blocks."""
        now = time.monotonic()
        retired = False
        for i in range(self.max_running):
            lane = self._lanes[i]
            if lane is None:
                continue
            req = lane.req
            if req.cancelled:
                retired = True
                self._release(lane, i)
                if req.fail(RequestCancelled(
                        "request cancelled mid-generation — lane "
                        f"retired after {len(req.tokens)} token(s)")):
                    self.metrics.count("cancelled")
                continue
            if req.deadline is not None and now > req.deadline:
                elapsed = now - req.enqueue_t
                budget = req.deadline - req.enqueue_t
                retired = True
                self._release(lane, i)
                if req.fail(DeadlineExceeded(
                        f"deadline passed mid-decode ({elapsed * 1e3:.1f} "
                        f"ms elapsed vs a {budget * 1e3:.1f} ms budget, "
                        f"{len(req.tokens)} token(s) generated) — lane "
                        "retired, remaining work not spent",
                        elapsed_s=elapsed, budget_s=budget)):
                    self.metrics.count("retired_deadline")
        if retired:
            self._lanes_gauge()

    def _prefix_lookup(self, prompt):
        """The prompt's full-block hashes, its longest resident prefix
        (hashes and block ids), and the spill tiers' payloads and tiers
        that extend it. The run never covers the whole prompt (the last
        real token must run: its logits sample the first token; the
        last spill payload goes first, as the reference's), and when the
        suffix's bucket would reach past the block table or a model's
        context window there are no hits (a full prefill)."""
        if not self._prefix_on:
            return [], [], [], [], []
        hashes = kv_hash.chain_hashes(prompt, self.block_size)
        hit_hashes, hit_blocks = [], []
        for hsh in hashes:
            blk = self._prefix.get(hsh)
            if blk is None:
                break
            hit_hashes.append(hsh)
            hit_blocks.append(blk)
        payloads, tiers = [], []
        if self._spill is not None:
            # extend the resident run from the spill tiers, in chain
            # order (the run must stay consecutive)
            for j in range(len(hit_blocks), len(hashes)):
                payload, tier = self._spill.get(hashes[j])
                if payload is None:
                    break
                if self._spec and ("dk" not in payload
                                   or "dv" not in payload):
                    break       # a draft-less payload cannot feed the draft
                payloads.append(payload)
                tiers.append(tier)
        p, bs = int(prompt.shape[0]), self.block_size
        run = len(hit_blocks) + len(payloads)
        if run and run * bs == p:
            if payloads:
                payloads.pop()
                tiers.pop()
            else:
                hit_blocks.pop()
                hit_hashes.pop()
            run -= 1
        if run and run * bs + self._prefill_bucket(p - run * bs) \
                > self._pad_end:
            return hashes, [], [], [], []
        return hashes, hit_hashes, hit_blocks, payloads, tiers

    def _admit(self, req: GenRequest, lane_idx: int) -> None:
        """Prefill ``req`` into ``lane_idx``, or shed it typed. A fault
        escaping :meth:`_admit_locked` (a bookkeeping bug) fails the
        request typed here first-wins, then propagates to
        :meth:`_fault`."""
        try:
            self._admit_locked(req, lane_idx)
        except Exception as e:  # noqa: BLE001 — typed + escalated
            if req.fail(_typed(e, "LLM admission fault")):
                self.metrics.count("failed")
            raise

    def _admit_locked(self, req: GenRequest, lane_idx: int) -> None:
        """Shed an expired or unplaceable request typed, else prefill
        it: the prompt's resident leading blocks are shared, blocks the
        spill tiers hold are re-attached, and only the rest prefills. A
        prefill fault fails THIS request and the engine keeps serving."""
        if req.expired(time.monotonic()):
            self.metrics.count("shed_deadline")
            req.fail(DeadlineExceeded(
                f"deadline passed while queued ({req.latency_s * 1e3:.1f} "
                "ms) — shed before prefill"))
            return
        p = int(req.prompt.shape[0])
        bs = self.block_size
        need = -(-(p + req.max_new_tokens + self._slack) // bs)
        hashes, hit_hashes, hit_blocks, payloads, tiers = \
            self._prefix_lookup(req.prompt)
        n_res = len(hit_blocks)                 # resident shared blocks
        n_hit = n_res + len(payloads)           # prefill skipped for these
        # pin the hits before allocating: the LRU eviction must never
        # hand out a block this admission is about to share
        for blk, hsh in zip(hit_blocks, hit_hashes):
            self._incref(blk)
            self._prefix.move_to_end(hsh)
        fresh = self._alloc(need - n_res)
        if fresh is None:
            for blk in hit_blocks:
                self._decref(blk)
            self.metrics.count("shed_overload")
            req.fail(ServerOverload(
                f"KV pool exhausted ({len(self._free)} free blocks, need "
                f"{need - n_res}) — back off and retry"))
            return
        if payloads:
            # the first len(payloads) fresh blocks receive the spilled
            # rows and become cache residents
            self._reattach(fresh[:len(payloads)], payloads, tiers,
                           hashes[n_res:n_hit])
        blocks = hit_blocks + fresh
        self.metrics.pool_free.set(len(self._free))
        if self._prefix_on:
            self.metrics.observe_prefix(n_hit * bs, p - n_hit * bs)
            self._prefix_hits += bool(n_hit)
        t0 = time.perf_counter()
        try:
            # the prefill-splice chaos site: an injected fault fails THIS
            # request typed, injected latency holds the scheduler
            chaos.site("serving.llm", phase="prefill_splice",
                       prefix_hit_blocks=n_hit)
            with telemetry.step("llm_prefill") as st:
                if req.trace_id is not None:
                    st.annotate("trace_id", req.trace_id)
                with st.phase("device", "llm.prefill"):
                    first = (self._suffix_prefill(req, blocks, n_hit)
                             if n_hit else self._full_prefill(req, blocks))
        except Exception as e:  # noqa: BLE001 — contained to the request
            for b in blocks:
                self._decref(b)
            self.metrics.pool_free.set(len(self._free))
            req.fail(_typed(e, "LLM prefill fault"))
            self.metrics.count("failed")
            self.metrics.count("resets")
            return
        dt = time.perf_counter() - t0
        self.metrics.count("prefills")
        self.metrics.prefill_ms.observe(dt * 1e3)
        self.metrics.tokens_prefill.inc()
        self._prefill_s += dt
        # the prompt's freshly computed full blocks join the cache (never
        # written again: decode writes land at positions >= p)
        if self._prefix_on:
            for j in range(n_hit, min(p // bs, len(hashes))):
                if hashes[j] not in self._prefix:
                    self._prefix[hashes[j]] = blocks[j]
                    self._incref(blocks[j])
            self.metrics.prefix_cached_blocks.set(len(self._prefix))
        req.prefill_s = dt
        req.first_token_s = req.latency_s
        lane = _Lane(req, blocks, pos=p, last_token=first)
        if not self._push_token(lane, first):
            self._release(lane, None)
            return
        if self._retire_if_done(lane, lane_idx=None):
            return
        self._lanes[lane_idx] = lane
        self._bt[lane_idx, :] = self._trash
        self._bt[lane_idx, :len(blocks)] = blocks
        self._pos[lane_idx] = lane.pos
        self._toks[lane_idx, 0] = lane.last_token
        self._prev[lane_idx, 0] = int(req.prompt[-1])
        self.metrics.count("admitted")
        self._lanes_gauge()

    def _full_prefill(self, req: GenRequest, blocks: List[int]) -> int:
        """Bucketed whole-prompt prefill spliced into ``blocks`` (and the
        draft model's into the same block ids of its pools)."""
        p = int(req.prompt.shape[0])
        bucket = self._prefill_bucket(p)
        nb_bucket = bucket // self.block_size
        nb_real = -(-p // self.block_size)
        ids = onp.full((nb_bucket,), self._trash, onp.int64)
        ids[:nb_real] = blocks[:nb_real]
        padded = onp.zeros((1, bucket), onp.int32)
        padded[0, :p] = req.prompt
        padded, ids = torch.from_numpy(padded), torch.from_numpy(ids)
        first, self._pool_k, self._pool_v = self._prefill_run(bucket)(
            padded, p - 1, self._pool_k, self._pool_v, ids, self._gen)
        self._record_manifest("llm.prefill", bucket)
        if self._spec:
            _, self._dpool_k, self._dpool_v = self._prefill_run(
                bucket, draft=True)(padded, p - 1, self._dpool_k,
                                    self._dpool_v, ids, self._gen)
            self._record_manifest("llm.draft_prefill", bucket)
        return int(first.cpu())

    def _suffix_prefill(self, req: GenRequest, blocks: List[int],
                        n_hit: int) -> int:
        """Prefill only the uncached suffix, from ``n_hit`` blocks on:
        one paged step of the suffix bucket attending the resident
        prefix through the lane's table (and the draft's the same)."""
        p = int(req.prompt.shape[0])
        start = n_hit * self.block_size
        s = p - start
        bucket = self._prefill_bucket(s)
        padded = onp.zeros((1, bucket), onp.int32)
        padded[0, :s] = req.prompt[start:]
        table = onp.full((1, self.max_blocks_per_seq), self._trash,
                         onp.int32)
        table[0, :len(blocks)] = blocks
        padded, table = torch.from_numpy(padded), torch.from_numpy(table)
        first, self._pool_k, self._pool_v = self._suffix_run(bucket)(
            padded, start, s - 1, self._pool_k, self._pool_v, table,
            self._gen)
        self._record_manifest("llm.prefill_suffix", bucket)
        if self._spec:
            _, self._dpool_k, self._dpool_v = self._suffix_run(
                bucket, draft=True)(padded, start, s - 1, self._dpool_k,
                                    self._dpool_v, table, self._gen)
            self._record_manifest("llm.draft_suffix", bucket)
        return int(first.cpu())

    def _lane_trace_ids(self, active: List[int]) -> List[str]:
        """The trace ids of the requests the active lanes carry (each
        decode/spec step span is annotated with them)."""
        out: List[str] = []
        for i in active:
            lane = self._lanes[i]
            tid = lane.req.trace_id if lane is not None else None
            if tid is not None:
                out.append(tid)
        return out

    def _decode_step(self, active: List[int]) -> None:
        t0 = time.perf_counter()
        self._step_seq += 1
        with telemetry.step("llm_decode", self._step_seq) as st:
            st.defer()
            tids = self._lane_trace_ids(active)
            if tids:
                st.annotate("trace_ids", tids)
            with st.phase("device", "llm.decode"):
                nxt, self._pool_k, self._pool_v = self._decode_run(
                    self._toks_host, self._pool_k, self._pool_v,
                    self._bt_host, self._pos_host, self._gen)
                self._flush()           # while the card computes
                # the step's synchronisation point: the host arrays are
                # written again only after it, when their copies landed
                nxt = nxt.cpu().numpy()
        dt = time.perf_counter() - t0
        n = len(active)
        self._decode_s += dt
        self.metrics.count("decode_steps")
        self.metrics.tokens_decode.inc(n)
        self._tokens_decode += n
        self._record_manifest("llm.decode", self.max_running)
        self._defer(st.finish)
        self._defer(self.metrics.decode_ms.observe, dt * 1e3)
        self._defer(self.metrics.token_latency_ms.observe, dt * 1e3 / n)
        self._defer(self._observe_tok_s, n, time.monotonic())
        for i in active:
            lane = self._lanes[i]
            tok = int(nxt[i])
            lane.pos += 1
            lane.last_token = tok
            if not self._push_token(lane, tok):
                self._release(lane, i)
                continue
            if self._retire_if_done(lane, lane_idx=i):
                continue
            self._pos[i] = lane.pos
            self._toks[i, 0] = tok
        self._lanes_gauge()

    def _spec_step(self, active: List[int]) -> None:
        """One speculative round over the whole lane set: the draft
        proposes K tokens per lane (K+1 draft steps in one program), the
        target verifies them in one (R, K+1) forward, and each live lane
        takes ``n_acc + 1`` tokens. Inactive lanes ride along on the
        trash block. One host sync per round."""
        t0 = time.perf_counter()
        self._step_seq += 1
        with telemetry.step("llm_spec", self._step_seq) as st:
            st.defer()
            tids = self._lane_trace_ids(active)
            if tids:
                st.annotate("trace_ids", tids)
            with st.phase("device", "llm.spec"):
                # the draft-verify chaos site: an injected fault reaches
                # _fault, which fails the in-flight requests typed
                chaos.site("serving.llm.verify", lanes=len(active))
                d_toks, d_lgs, self._dpool_k, self._dpool_v = \
                    self._draft_run(
                        self._prev_host, self._toks_host, self._dpool_k,
                        self._dpool_v, self._bt_host, self._pos_host,
                        self._gen)
                out, n_acc, self._pool_k, self._pool_v = self._verify_run(
                    self._toks_host, d_toks, d_lgs, self._pool_k,
                    self._pool_v, self._bt_host, self._pos_host, self._gen)
                self._flush()           # while the card computes
                # the round's synchronisation point: the host arrays are
                # written again only after it, when the copies into both
                # graphs landed
                both = torch.cat([out, n_acc[:, None]], dim=1).cpu().numpy()
        out, n_acc = both[:, :-1], both[:, -1]
        dt = time.perf_counter() - t0
        self._decode_s += dt
        self.metrics.count("spec_steps")
        self.metrics.count("decode_steps")
        self._record_manifest("llm.draft", self._draft_k)
        self._record_manifest("llm.verify", self._draft_k)
        self._defer(st.finish)
        self._defer(self.metrics.decode_ms.observe, dt * 1e3)
        self._defer(self.metrics.spec_ms.observe, dt * 1e3)
        emitted = accepted = 0
        for i in active:
            lane = self._lanes[i]
            n_take = int(n_acc[i]) + 1
            accepted += int(n_acc[i])
            prev_last = lane.last_token
            gone = False
            for j in range(n_take):
                tok = int(out[i, j])
                emitted += 1
                lane.last_token = tok
                if not self._push_token(lane, tok):
                    self._release(lane, i)
                    gone = True
                    break
                if self._retire_if_done(lane, lane_idx=i):
                    gone = True
                    break
            if gone:
                continue
            # KV of [last, d_0 .. d_{n_acc-1}] is at pos .. pos+n_acc;
            # the correction is the new last token (written next round),
            # and the token at the new pos-1 the last accepted one
            lane.pos += n_take
            self._pos[i] = lane.pos
            self._toks[i, 0] = lane.last_token
            self._prev[i, 0] = (int(out[i, n_take - 2]) if n_take >= 2
                                else prev_last)
        self.metrics.observe_spec(self._draft_k * len(active), accepted)
        self._tokens_decode += emitted
        if emitted:
            # after the pushes, as the reference's: immediate, so that
            # a finished request's round is counted when it wakes
            self.metrics.token_latency_ms.observe(dt * 1e3 / emitted)
            self.metrics.tokens_decode.inc(emitted)
            self._defer(self._observe_tok_s, emitted, time.monotonic())
        self._lanes_gauge()

    def _defer(self, fn: Callable, *args) -> None:
        """Queue one piece of a step's bookkeeping (its span's events
        and histograms, the latency histograms, the tok/s gauge) for
        :meth:`_flush`. Counters stay immediate."""
        self._deferred.append((fn, args))

    def _flush(self) -> None:
        """Run the queued bookkeeping. The next step runs it between its
        launch and its synchronisation, while the card computes, so it
        leaves the path between one step's end and the next one's
        start; a request finishing, an idle tick and a fault run it at
        once, so a finished request's steps are all recorded."""
        work, self._deferred = self._deferred, []
        for fn, args in work:
            fn(*args)

    def _push_token(self, lane: _Lane, tok: int) -> bool:
        """Record + stream one token. False when the request's
        ``on_token`` callback raised: the request is failed (typed FATAL,
        a client bug) and contained to its own lane."""
        lane.req.tokens.append(tok)
        cb = lane.req.on_token
        if cb is None:
            return True
        try:
            cb(tok)
            return True
        except Exception as e:  # noqa: BLE001 — client code
            err = FatalError(f"on_token callback raised: {e!r}")
            err.__cause__ = e
            lane.req.fail(err)
            self.metrics.count("failed")
            return False

    def _retire_if_done(self, lane: _Lane, lane_idx: Optional[int]) -> bool:
        req = lane.req
        done = (len(req.tokens) >= req.max_new_tokens
                or req.tokens[-1] == req.eos_token)
        if not done:
            return False
        self._flush()
        self._release(lane, lane_idx)
        req.finish(onp.asarray(req.tokens, onp.int32))
        self.metrics.count("completed")
        return True

    def _release(self, lane: _Lane, lane_idx: Optional[int]) -> None:
        """Drop the lane's block references the moment its sequence
        finishes (a block returns to the free list at refcount zero:
        cache residents and lanes sharing a prefix keep theirs), and
        point the lane at the trash block."""
        for b in lane.blocks:
            self._decref(b)
        lane.blocks = []
        self.metrics.pool_free.set(len(self._free))
        if lane_idx is not None:
            self._lanes[lane_idx] = None
            self._bt[lane_idx, :] = self._trash
            self._pos[lane_idx] = 0
            self._toks[lane_idx, 0] = 0
            self._prev[lane_idx, 0] = 0

    # -- fault handling ----------------------------------------------------
    def _fault(self, exc: Exception) -> bool:
        """Type the fault through the classifier, fail every in-flight
        request with it and reset the pool. Returns False (stop the
        scheduler) on a fatal fault."""
        with self._state_lock:
            return self._fault_locked(exc)

    def _fault_locked(self, exc: Exception) -> bool:
        self._flush()                   # the steps before the fault
        kind = classify(exc)
        typed = _typed(exc, f"LLM scheduler fault ({kind})")
        self.metrics.count("resets")
        fatal = kind != TRANSIENT
        if fatal:
            # broken BEFORE any request observes its failure: a caller
            # woken by req.fail must find submit() shedding
            self._broken = typed
            self._queue.close()
        for i, lane in enumerate(self._lanes):
            if lane is not None:
                self._release(lane, i)
                lane.req.fail(typed)
                self.metrics.count("failed")
        # the prefix cache indexes pool content: it resets with it. The
        # spill tier survives: it is content-addressed, so the first
        # admissions after the reset re-attach instead of prefilling
        self._free = list(range(self.num_blocks))
        self._ref.clear()
        self._prefix.clear()
        self.metrics.prefix_cached_blocks.set(0)
        self.metrics.pool_free.set(len(self._free))
        self.metrics.lanes_active.set(0)
        if not fatal:
            for pool in self._pools():      # in place: graphs hold them
                pool.zero_()
            return True             # keep serving new requests
        n = self._queue.fail_all(lambda: ServerOverload(
            f"LLM engine stopped on a fatal fault: {typed!r}"))
        self.metrics.count("failed", n)
        return False

    # -- misc --------------------------------------------------------------
    def _observe_tok_s(self, n: int, now: float) -> None:
        """The reference's rolling tok/s over the last 5 s, ``n`` tokens
        at ``now``: the tokens after the window's first entry over its
        span, from a running sum, so a step costs the same however full
        the window is."""
        w = self._tok_window
        w.append((now, n))
        self._tok_sum += n
        while now - w[0][0] > 5.0:
            self._tok_sum -= w.popleft()[1]
        span = now - w[0][0]
        if span > 0:
            self.metrics.tok_s.set((self._tok_sum - w[0][1]) / span)

    def _record_manifest(self, label: str, bucket: int) -> None:
        """Record one program signature in the warmup manifest (the
        reference's entry: label, bucket, cache dtype), once per
        ``(label, bucket)``; each first record counts a ``compiles``
        event, as the reference's does."""
        ident = (label, bucket)
        if ident in self._manifest_keyed:
            return
        self._manifest_keyed.add(ident)
        self._warmup_manifest.record(label=label, bucket=int(bucket),
                                     dtype=str(self._kv_dtype))
        self.metrics.count("compiles")

    # -- warmup / manifests ------------------------------------------------
    def warmup(self, prompt_lengths=None, manifest=None) -> List[int]:
        """Capture the decode step, the draft and verify programs (with a
        draft model), and the prefill buckets of ``prompt_lengths``
        (default: one, ``block_size``; the draft's too) or of
        ``manifest`` (a :class:`~mxnet_tpu_torch.aot.WarmupManifest` or
        the path of one, from either package: its ``llm.prefill``
        buckets) ahead of traffic, as the reference's ``warmup``
        compiles them: one call of each program on trash-table inputs,
        which on a card captures its graph (on the CPU the call just
        runs). Suffix buckets are captured at their first use. Returns
        the warmed prefill buckets."""
        if manifest is not None:
            if not isinstance(manifest, WarmupManifest):
                manifest = WarmupManifest.load(manifest)
            buckets = sorted({int(e["bucket"]) for e in manifest.entries()
                              if e.get("label") == "llm.prefill"
                              and e.get("bucket")})
        else:
            lens = (list(prompt_lengths) if prompt_lengths
                    else [self.block_size])
            buckets = sorted({self._prefill_bucket(int(p)) for p in lens})
        with self._state_lock:
            self._warmup_buckets(buckets)
        return buckets

    def _warmup_buckets(self, buckets) -> None:
        for b in buckets:
            if ("llm.prefill", b) in self._warm:
                continue
            ids = torch.full((b // self.block_size,), self._trash,
                             dtype=torch.int64)
            prompt = torch.zeros((1, b), dtype=torch.int32)
            self._prefill_run(b)(prompt, 0, self._pool_k, self._pool_v,
                                 ids, self._gen)
            self._warm.add(("llm.prefill", b))
            self._record_manifest("llm.prefill", b)
            if self._spec:
                self._prefill_run(b, draft=True)(
                    prompt, 0, self._dpool_k, self._dpool_v, ids,
                    self._gen)
                self._record_manifest("llm.draft_prefill", b)
        toks = torch.zeros_like(self._toks_host)
        trash_bt = torch.full_like(self._bt_host, self._trash)
        pos = torch.zeros_like(self._pos_host)
        if "decode" not in self._warm:
            self._decode_run(toks, self._pool_k, self._pool_v, trash_bt,
                             pos, self._gen)
            self._warm.add("decode")
            self._record_manifest("llm.decode", self.max_running)
        if self._spec and "spec" not in self._warm:
            d_toks, d_lgs, _, _ = self._draft_run(
                toks, toks, self._dpool_k, self._dpool_v, trash_bt, pos,
                self._gen)
            self._verify_run(toks, d_toks, d_lgs, self._pool_k,
                             self._pool_v, trash_bt, pos, self._gen)
            self._warm.add("spec")
            self._record_manifest("llm.draft", self._draft_k)
            self._record_manifest("llm.verify", self._draft_k)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup_manifest(self) -> WarmupManifest:
        """The live warmup manifest (it keeps growing)."""
        return self._warmup_manifest

    def save_warmup_manifest(self, path: str) -> str:
        return self._warmup_manifest.save(path)

    # -- stats / lifecycle -------------------------------------------------
    def stats(self) -> Dict:
        """The reference's keys and values (counters, lanes, pool,
        ``tok_s``, the ``decode_step_ms`` / ``prefill_ms`` /
        ``token_latency_ms`` histogram summaries, ``speculative``,
        ``prefix_cache`` and ``kv_spill`` when armed), and the port's
        own: ``device``, the totals ``decode_tokens`` / ``decode_s`` /
        ``prefill_s`` / ``decode_tok_s``, ``graphs`` (the CUDA graphs
        captured and replayed by every program, 0 on the CPU, and the
        prefill buckets captured), ``weight_dtype`` and, with int8
        weights, ``int8_weights`` (the tree's bytes and the quantize
        seconds). ``kv_spill`` adds the bytes and seconds of the spill
        copies. A speculative round counts as a decode step (and a
        ``spec_steps``)."""
        m = self.metrics
        progs = [self._decode_run, *self._prefill_runs.values(),
                 *self._draft_prefill_runs.values(),
                 *self._suffix_runs.values(),
                 *self._draft_suffix_runs.values()]
        if self._spec:
            progs += [self._draft_run, self._verify_run]
        out = {
            "counters": m.counters(),
            "lanes_active": int(m.lanes_active.get()),
            "max_running": self.max_running,
            "block_size": self.block_size,
            "pool_blocks_total": self.num_blocks,
            "pool_blocks_free": len(self._free),
            "kv_cache_dtype": self._kv_dtype,
            "tok_s": round(float(m.tok_s.get()), 2),
            "decode_step_ms": m.decode_ms.summary(),
            "prefill_ms": m.prefill_ms.summary(),
            "token_latency_ms": m.token_latency_ms.summary(),
            "queue_len": len(self._queue),
            "device": str(self.device),
            "weight_dtype": self._weight_dtype,
            "decode_tokens": self._tokens_decode,
            "decode_s": self._decode_s,
            "prefill_s": self._prefill_s,
            "decode_tok_s": (self._tokens_decode / self._decode_s
                             if self._decode_s else None),
            "graphs": {
                "captures": sum(p.captures for p in progs),
                "replays": sum(p.replays for p in progs),
                "capture_s": sum(p.capture_s for p in progs),
                "prefill_buckets": sorted(
                    b for b, p in self._prefill_runs.items() if p.captures),
            },
        }
        if self._int8 is not None:
            q, scales = self._int8
            out["int8_weights"] = {
                "bytes": sum(q[k].numel() for k in scales),
                "scale_bytes": sum(s.numel() * s.element_size()
                                   for s in scales.values()),
                "quantize_s": self._quantize_s,
            }
        if self._spec:
            out["speculative"] = {
                "draft_k": self._draft_k,
                "proposed": int(m.spec_proposed.value),
                "accepted": int(m.spec_accepted.value),
                "draft_acceptance_rate": round(
                    float(m.draft_acceptance_rate.get()), 4),
            }
        if self._prefix_on:
            out["prefix_cache"] = {
                "cached_blocks": len(self._prefix),
                "hit_requests": self._prefix_hits,
                "hit_tokens": int(m.prefix_hit_tokens.value),
                "miss_tokens": int(m.prefix_miss_tokens.value),
                "prefix_hit_rate": round(float(m.prefix_hit_rate.get()), 4),
            }
        if self._spill is not None:
            out["kv_spill"] = dict(self._spill.stats(), **self._spill_io)
        return out

    @property
    def alive(self) -> bool:
        """The scheduler loop is live: thread running, not stopped on a
        fatal fault, not closed (a wedged one shows in
        :attr:`last_tick`'s age)."""
        return (self._thread.is_alive() and self._broken is None
                and not self._closed)

    def close(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Stop admitting; finish in-flight and queued work
        (``drain=True``) or fail it, then stop the scheduler. Never
        leaves a queued request hanging. A closed engine's live-load
        gauges read 0."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.close()
            if not drain:
                self._queue.fail_all(
                    lambda: ServerOverload("engine closed without drain"))
                with self._state_lock:
                    for i, lane in enumerate(self._lanes):
                        if lane is not None:
                            self._release(lane, i)
                            lane.req.fail(ServerOverload(
                                "engine closed without drain"))
        self._thread.join(timeout_s)
        if len(self._queue):
            # the scheduler stopped (fatal fault) or is wedged past the
            # timeout with requests still queued: fail them typed
            n = self._queue.fail_all(lambda: ServerOverload(
                "engine closed before the queued request ran — resubmit "
                "elsewhere"))
            self.metrics.count("failed", n)
        m = self.metrics
        for g in (m.tok_s, m.lanes_active, m.lanes_total, m.pool_free,
                  m.pool_total, m.kv_spill_blocks, m.kv_spill_bytes,
                  m.shard_devices, m.shard_pool_bytes):
            g.set(0)
        if self._spill is not None:
            self._spill.close()

    def __enter__(self) -> "LLMEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
