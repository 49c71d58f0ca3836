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

The scheduler thread launches all device work on the engine's device
(on ``torch.cuda.current_stream(device)``); the sampled tokens come back
with ``.cpu()``, which is the step's synchronisation point. On a CUDA
device every program replays CUDA graphs (the counterpart of the
reference's compiled programs): :meth:`LLMEngine.warmup` captures the
decode step (and the draft and verify programs) and the prefill buckets
of given prompt lengths ahead of traffic, and a bucket not yet warmed
(every suffix bucket) is captured at its first use. The lane state
(tokens, block table, positions, the previous token) lives in pinned
host memory that each step copies into the graphs' static buffers.
Counters are plain integers (:meth:`LLMEngine.stats`).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as onp
import torch

from ..base import FatalError, MXNetError, TransientError, env_float
from ..gluon.model_zoo.generation import (
    GraphedProgram, _model_device, _resolve_cache_dtype,
    paged_decode_program, paged_prefill_program, paged_spec_draft_program,
    paged_spec_verify_program, paged_suffix_prefill_program)
from . import kv_hash
from .admission import (AdmissionQueue, DeadlineExceeded, Request,
                        RequestCancelled, ServerOverload)

__all__ = ["LLMEngine", "GenRequest"]


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at ``cap`` (cap itself is
    always a valid bucket even when not a power of two)."""
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


class GenRequest(Request):
    """One in-flight generation request.

    ``wait()`` returns the generated tokens as an int32 numpy array
    (length <= ``max_new_tokens``; generation stops after the first
    ``eos_token``, which is included). ``on_token`` (optional) streams
    each token from the scheduler thread as it is decoded — it must be
    cheap and must not raise (a raising callback fails the request)."""

    __slots__ = ("prompt", "max_new_tokens", "eos_token", "on_token",
                 "tokens", "prefill_s", "first_token_s")

    def __init__(self, prompt, max_new_tokens: int, eos_token: int,
                 deadline: Optional[float],
                 on_token: Optional[Callable[[int], None]] = None):
        super().__init__(prompt, 1, ("llm",), deadline)
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token = int(eos_token)
        self.on_token = on_token
        self.tokens: List[int] = []
        self.prefill_s: Optional[float] = None
        self.first_token_s: Optional[float] = None


class _Lane:
    """One decode lane: the request it carries + its block reservation."""

    __slots__ = ("req", "blocks", "pos", "last_token")

    def __init__(self, req: GenRequest, blocks: List[int], pos: int,
                 last_token: int):
        self.req = req
        self.blocks = blocks        # pool block ids owned by this lane
        self.pos = pos              # absolute position of the NEXT write
        self.last_token = last_token


class _Counters:
    """Plain integer event counters (the ``AdmissionQueue`` metrics seam:
    ``count`` and ``observe_queue_depth``), and the draft tokens proposed
    and accepted and the prompt tokens the prefix cache hit and missed
    (the reference's ``observe_spec`` / ``observe_prefix``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events: Dict[str, int] = {}
        self.spec_proposed = self.spec_accepted = 0
        self.prefix_hit_tokens = self.prefix_miss_tokens = 0

    def count(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self.events[name] = self.events.get(name, 0) + int(delta)

    def observe_spec(self, proposed: int, accepted: int) -> None:
        self.spec_proposed += int(proposed)
        self.spec_accepted += int(accepted)

    def observe_prefix(self, hit: int, miss: int) -> None:
        self.prefix_hit_tokens += int(hit)
        self.prefix_miss_tokens += int(miss)

    def observe_queue_depth(self, depth: int) -> None:
        pass

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.events)


def _typed(e: BaseException, what: str) -> MXNetError:
    """Type a fault: the port's Transient/Fatal errors pass through, a
    CUDA out-of-memory is transient, anything else fatal."""
    if isinstance(e, (TransientError, FatalError)):
        return e
    oom = getattr(torch.cuda, "OutOfMemoryError", MemoryError)
    cls = TransientError if isinstance(e, (oom, MemoryError)) else FatalError
    typed = cls(f"{what}: {e!r}")
    typed.__cause__ = e
    return typed


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
    greedy / temperature / top_k / seed
        Sampling policy; ``seed`` seeds the engine's ``torch.Generator``.
    max_queue_size / timeout_ms
        Admission bound and default end-to-end deadline.
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

    The reference engine's KV spill tiers, disaggregated roles, mesh
    sharding, int8 weights, step hook, telemetry spans, chaos sites and
    AOT warmup manifests are not carried yet.
    """

    def __init__(self, model, *, device=None,
                 max_running: Optional[int] = None,
                 block_size: Optional[int] = None,
                 max_context: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 kv_cache_dtype: Optional[str] = "int8",
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, seed: int = 0, eos_token: int = -1,
                 max_queue_size: int = 256,
                 timeout_ms: Optional[float] = None,
                 draft_model=None, draft_k: Optional[int] = None,
                 prefix_cache: Optional[bool] = None):
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

        self.metrics = _Counters()
        self._decode_s = 0.0
        self._prefill_s = 0.0
        self._tokens_decode = 0

        # pool state: +1 trash block at index num_blocks — retired lanes
        # and pad splices write there, never into a live sequence
        self._trash = self.num_blocks
        self._pool_k, self._pool_v = model.init_block_pool(
            self.num_blocks + 1, self.block_size, dtype=self._kv_dtype)
        self._free: List[int] = list(range(self.num_blocks))
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

        sampling = dict(greedy=greedy, temperature=temperature, top_k=top_k)
        self._decode_run = paged_decode_program(model, **sampling)
        if self._spec:
            self._draft_run = paged_spec_draft_program(
                draft_model, draft_k=self._draft_k, **sampling)
            self._verify_run = paged_spec_verify_program(
                model, draft_k=self._draft_k, **sampling)
        self._prefill_runs: Dict[int, GraphedProgram] = {}
        self._draft_prefill_runs: Dict[int, GraphedProgram] = {}
        self._suffix_runs: Dict[int, GraphedProgram] = {}
        self._draft_suffix_runs: Dict[int, GraphedProgram] = {}
        # one memory pool for every prefill-like graph (the target's and
        # the draft's prefill and suffix buckets)
        self._prefill_pool = (torch.cuda.graph_pool_handle() if pin
                              else None)

        self._state_lock = threading.RLock()
        self._queue = AdmissionQueue(max_queue_size, self.metrics)
        self._closed = False
        self._broken: Optional[BaseException] = None
        self._close_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop,
                                        name="llm-scheduler", daemon=True)
        self._thread.start()

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
                greedy=self._greedy, temperature=self._temperature,
                top_k=self._top_k, graph_pool=self._prefill_pool)
        return run

    def _suffix_run(self, bucket: int, draft: bool = False
                    ) -> GraphedProgram:
        runs = self._draft_suffix_runs if draft else self._suffix_runs
        run = runs.get(bucket)
        if run is None:
            run = runs[bucket] = paged_suffix_prefill_program(
                self._draft if draft else self._model, suffix_len=bucket,
                block_size=self.block_size, greedy=self._greedy,
                temperature=self._temperature, top_k=self._top_k,
                graph_pool=self._prefill_pool)
        return run

    # -- warmup ------------------------------------------------------------
    def warmup(self, prompt_lengths=None) -> List[int]:
        """Capture the decode step, the draft and verify programs (with a
        draft model), and the prefill buckets of ``prompt_lengths``
        (default: one, ``block_size``; the draft's too) ahead of traffic,
        as the reference's ``warmup`` compiles them: one call of each
        program on trash-table inputs, which on a card captures its
        graph (on the CPU the call just runs). Suffix buckets are
        captured at their first use. Returns the warmed prefill buckets,
        those the reference's engine gives for the same lengths."""
        lens = (list(prompt_lengths) if prompt_lengths
                else [self.block_size])
        buckets = sorted({self._prefill_bucket(int(p)) for p in lens})
        with self._state_lock:
            for b in buckets:
                ids = torch.full((b // self.block_size,), self._trash,
                                 dtype=torch.int64)
                prompt = torch.zeros((1, b), dtype=torch.int32)
                self._prefill_run(b)(prompt, 0, self._pool_k, self._pool_v,
                                     ids, self._gen)
                if self._spec:
                    self._prefill_run(b, draft=True)(
                        prompt, 0, self._dpool_k, self._dpool_v, ids,
                        self._gen)
            toks = torch.zeros_like(self._toks_host)
            trash_bt = torch.full_like(self._bt_host, self._trash)
            pos = torch.zeros_like(self._pos_host)
            self._decode_run(toks, self._pool_k, self._pool_v, trash_bt,
                             pos, self._gen)
            if self._spec:
                d_toks, d_lgs, _, _ = self._draft_run(
                    toks, toks, self._dpool_k, self._dpool_v, trash_bt,
                    pos, self._gen)
                self._verify_run(toks, d_toks, d_lgs, self._pool_k,
                                 self._pool_v, trash_bt, pos, self._gen)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return buckets

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
        the list is short. None when even that cannot cover ``n``."""
        while len(self._free) < n and self._prefix:
            for hsh, blk in self._prefix.items():   # LRU order
                if self._ref.get(blk, 0) == 1:      # cache-only resident
                    del self._prefix[hsh]
                    self._decref(blk)
                    break
            else:
                break                               # all cached blocks live
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
        return sum(1 for b in list(self._prefix.values())
                   if self._ref.get(b, 0) == 1)

    # -- client surface ----------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               eos_token: Optional[int] = None, timeout_ms="default",
               on_token: Optional[Callable[[int], None]] = None
               ) -> GenRequest:
        """Enqueue one prompt (1-D int sequence). Returns the
        :class:`GenRequest` handle; ``handle.wait()`` yields the
        generated int32 tokens. Raises :class:`ServerOverload` when the
        admission queue is full, ``ValueError`` for a request that could
        never run."""
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
        req = GenRequest(prompt, max_new_tokens,
                         self._eos if eos_token is None else eos_token,
                         deadline, on_token)
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
                if not self._fault(e):
                    return
                continue
            if idle is None:        # closed and drained
                return
            if idle:
                time.sleep(0.001)

    def _tick(self):
        """One scheduler iteration: admit into free lanes, then run one
        decode step. Returns True when there is nothing to do, None when
        closed and drained."""
        with self._state_lock:
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
                if self._closed and not len(self._queue):
                    return None
                return True
            if self._spec:
                self._spec_step(active)
            else:
                self._decode_step(active)
            return False

    def _sweep_lanes(self) -> None:
        """Retire lanes whose request was cancelled or whose end-to-end
        deadline passed mid-decode, freeing their blocks."""
        now = time.monotonic()
        for i in range(self.max_running):
            lane = self._lanes[i]
            if lane is None:
                continue
            req = lane.req
            if req.cancelled:
                self._release(lane, i)
                if req.fail(RequestCancelled(
                        "request cancelled mid-generation — lane "
                        f"retired after {len(req.tokens)} token(s)")):
                    self.metrics.count("cancelled")
                continue
            if req.deadline is not None and now > req.deadline:
                elapsed = now - req.enqueue_t
                budget = req.deadline - req.enqueue_t
                self._release(lane, i)
                if req.fail(DeadlineExceeded(
                        f"deadline passed mid-decode ({elapsed * 1e3:.1f} "
                        f"ms elapsed vs a {budget * 1e3:.1f} ms budget, "
                        f"{len(req.tokens)} token(s) generated) — lane "
                        "retired, remaining work not spent",
                        elapsed_s=elapsed, budget_s=budget)):
                    self.metrics.count("retired_deadline")

    def _prefix_lookup(self, prompt):
        """(hashes of the prompt's full blocks, the hashes and block ids
        of its longest resident prefix). When the hits cover the whole
        prompt the last one is dropped (its last token must run: its
        logits sample the first token), and when the suffix's bucket
        would reach past the block table or a model's context window,
        there are no hits (a full prefill)."""
        if not self._prefix_on:
            return [], [], []
        hashes = kv_hash.chain_hashes(prompt, self.block_size)
        hit_hashes, hit_blocks = [], []
        for hsh in hashes:
            blk = self._prefix.get(hsh)
            if blk is None:
                break
            hit_hashes.append(hsh)
            hit_blocks.append(blk)
        p, bs = int(prompt.shape[0]), self.block_size
        if hit_blocks and len(hit_blocks) * bs == p:
            hit_blocks.pop()
            hit_hashes.pop()
        if hit_blocks and len(hit_blocks) * bs + self._prefill_bucket(
                p - len(hit_blocks) * bs) > self._pad_end:
            return hashes, [], []
        return hashes, hit_hashes, hit_blocks

    def _admit(self, req: GenRequest, lane_idx: int) -> None:
        """Prefill ``req`` into ``lane_idx``, or shed it typed (expired
        deadline, or a pool that cannot hold its worst-case block
        reservation). With the prefix cache, the prompt's resident
        leading full blocks are shared and only the suffix prefills. A
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
        hashes, hit_hashes, hit_blocks = self._prefix_lookup(req.prompt)
        n_hit = len(hit_blocks)
        # pin the hits before allocating: the LRU eviction must never
        # hand out a block this admission is about to share
        for blk, hsh in zip(hit_blocks, hit_hashes):
            self._incref(blk)
            self._prefix.move_to_end(hsh)
        fresh = self._alloc(need - n_hit)
        if fresh is None:
            for blk in hit_blocks:
                self._decref(blk)
            self.metrics.count("shed_overload")
            req.fail(ServerOverload(
                f"KV pool exhausted ({len(self._free)} free blocks, need "
                f"{need - n_hit}) — back off and retry"))
            return
        blocks = hit_blocks + fresh
        if self._prefix_on:
            self.metrics.observe_prefix(n_hit * bs, p - n_hit * bs)
            self._prefix_hits += bool(n_hit)
        t0 = time.perf_counter()
        try:
            first = (self._suffix_prefill(req, blocks, n_hit) if n_hit
                     else self._full_prefill(req, blocks))
        except Exception as e:  # noqa: BLE001 — contained to the request
            for b in blocks:
                self._decref(b)
            req.fail(_typed(e, "LLM prefill fault"))
            self.metrics.count("failed")
            return
        dt = time.perf_counter() - t0
        self.metrics.count("prefills")
        self._prefill_s += dt
        # the prompt's freshly computed full blocks join the cache (never
        # written again: decode writes land at positions >= p)
        for j in range(n_hit, min(p // bs, len(hashes))):
            if hashes[j] not in self._prefix:
                self._prefix[hashes[j]] = blocks[j]
                self._incref(blocks[j])
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
        if self._spec:
            _, self._dpool_k, self._dpool_v = self._prefill_run(
                bucket, draft=True)(padded, p - 1, self._dpool_k,
                                    self._dpool_v, ids, self._gen)
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
        if self._spec:
            _, self._dpool_k, self._dpool_v = self._suffix_run(
                bucket, draft=True)(padded, start, s - 1, self._dpool_k,
                                    self._dpool_v, table, self._gen)
        return int(first.cpu())

    def _decode_step(self, active: List[int]) -> None:
        t0 = time.perf_counter()
        nxt, self._pool_k, self._pool_v = self._decode_run(
            self._toks_host, self._pool_k, self._pool_v, self._bt_host,
            self._pos_host, self._gen)
        # the step's synchronisation point: the host arrays are written
        # again only after it, when their copies have landed
        nxt = nxt.cpu().numpy()
        self._decode_s += time.perf_counter() - t0
        self.metrics.count("decode_steps")
        self._tokens_decode += len(active)
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

    def _spec_step(self, active: List[int]) -> None:
        """One speculative round over the whole lane set: the draft
        proposes K tokens per lane (K+1 draft steps in one program), the
        target verifies them in one (R, K+1) forward, and each live lane
        takes ``n_acc + 1`` tokens. Inactive lanes ride along on the
        trash block. One host sync per round."""
        t0 = time.perf_counter()
        d_toks, d_lgs, self._dpool_k, self._dpool_v = self._draft_run(
            self._prev_host, self._toks_host, self._dpool_k, self._dpool_v,
            self._bt_host, self._pos_host, self._gen)
        out, n_acc, self._pool_k, self._pool_v = self._verify_run(
            self._toks_host, d_toks, d_lgs, self._pool_k, self._pool_v,
            self._bt_host, self._pos_host, self._gen)
        # the round's synchronisation point: the host arrays are written
        # again only after it, when the copies into both graphs landed
        both = torch.cat([out, n_acc[:, None]], dim=1).cpu().numpy()
        out, n_acc = both[:, :-1], both[:, -1]
        self._decode_s += time.perf_counter() - t0
        self.metrics.count("spec_steps")
        self.metrics.count("decode_steps")
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
        if lane_idx is not None:
            self._lanes[lane_idx] = None
            self._bt[lane_idx, :] = self._trash
            self._pos[lane_idx] = 0
            self._toks[lane_idx, 0] = 0
            self._prev[lane_idx, 0] = 0

    # -- fault handling ----------------------------------------------------
    def _fault(self, exc: Exception) -> bool:
        """Fail every in-flight request with the typed fault and reset the
        pool. Returns False (stop the scheduler) on a fatal fault."""
        with self._state_lock:
            typed = _typed(exc, "LLM scheduler fault")
            self.metrics.count("resets")
            fatal = not isinstance(typed, TransientError)
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
            # the prefix cache indexes pool content: it resets with it
            self._free = list(range(self.num_blocks))
            self._ref.clear()
            self._prefix.clear()
            if not fatal:
                pools = [self._pool_k, self._pool_v]
                if self._spec:
                    pools += [self._dpool_k, self._dpool_v]
                for pool in pools:
                    pool.zero_()
                return True             # keep serving new requests
            n = self._queue.fail_all(lambda: ServerOverload(
                f"LLM engine stopped on a fatal fault: {typed!r}"))
            self.metrics.count("failed", n)
            return False

    # -- stats / lifecycle -------------------------------------------------
    def stats(self) -> Dict:
        """Counters, pool and timing state; ``graphs`` counts the CUDA
        graphs captured and replayed by every program (0 on the CPU) and
        lists the prefill buckets captured. A speculative
        round counts as a decode step (and a ``spec_steps``). With a
        draft model, ``speculative`` gives the draft tokens proposed and
        accepted; with the prefix cache, ``prefix_cache`` the resident
        blocks and the prompt tokens hit and missed (the reference's
        keys and arithmetic)."""
        c = self.metrics.snapshot()
        progs = [self._decode_run, *self._prefill_runs.values(),
                 *self._draft_prefill_runs.values(),
                 *self._suffix_runs.values(),
                 *self._draft_suffix_runs.values()]
        if self._spec:
            progs += [self._draft_run, self._verify_run]
        steps = c.get("decode_steps", 0)
        prefills = c.get("prefills", 0)
        out = {
            "counters": c,
            "device": str(self.device),
            "lanes_active": sum(1 for ln in self._lanes if ln is not None),
            "max_running": self.max_running,
            "block_size": self.block_size,
            "pool_blocks_total": self.num_blocks,
            "pool_blocks_free": len(self._free),
            "kv_cache_dtype": self._kv_dtype,
            "decode_tokens": self._tokens_decode,
            "decode_s": self._decode_s,
            "prefill_s": self._prefill_s,
            "decode_step_ms": 1e3 * self._decode_s / steps if steps else None,
            "prefill_ms": 1e3 * self._prefill_s / prefills if prefills else None,
            "decode_tok_s": (self._tokens_decode / self._decode_s
                             if self._decode_s else None),
            "queue_len": len(self._queue),
            "graphs": {
                "captures": sum(p.captures for p in progs),
                "replays": sum(p.replays for p in progs),
                "capture_s": sum(p.capture_s for p in progs),
                "prefill_buckets": sorted(
                    b for b, p in self._prefill_runs.items() if p.captures),
            },
        }
        m = self.metrics
        if self._spec:
            out["speculative"] = {
                "draft_k": self._draft_k,
                "proposed": m.spec_proposed,
                "accepted": m.spec_accepted,
                "draft_acceptance_rate": round(
                    m.spec_accepted / m.spec_proposed, 4)
                if m.spec_proposed else 0.0,
            }
        if self._prefix_on:
            seen = m.prefix_hit_tokens + m.prefix_miss_tokens
            out["prefix_cache"] = {
                "cached_blocks": len(self._prefix),
                "hit_requests": self._prefix_hits,
                "hit_tokens": m.prefix_hit_tokens,
                "miss_tokens": m.prefix_miss_tokens,
                "prefix_hit_rate": round(m.prefix_hit_tokens / seen, 4)
                if seen else 0.0,
            }
        return out

    def close(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Stop admitting; finish in-flight and queued work
        (``drain=True``) or fail it, then stop the scheduler. Never
        leaves a queued request hanging."""
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

    def __enter__(self) -> "LLMEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
