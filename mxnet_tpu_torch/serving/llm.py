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

The scheduler thread launches all device work on the engine's device
(on ``torch.cuda.current_stream(device)``); the sampled tokens come back
with ``.cpu()``, which is the step's synchronisation point. On a CUDA
device both programs replay CUDA graphs (the counterpart of the
reference's compiled programs): :meth:`LLMEngine.warmup` captures the
decode step and the prefill buckets of given prompt lengths ahead of
traffic, and a bucket not yet warmed is captured at its first use. The
lane state (tokens, block table, positions) lives in pinned host memory
that each step copies into the decode graph's static buffers. Counters
are plain integers (:meth:`LLMEngine.stats`).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as onp
import torch

from ..base import FatalError, MXNetError, TransientError, env_float
from ..gluon.model_zoo.generation import (
    GraphedProgram, _model_device, _resolve_cache_dtype,
    paged_decode_program, paged_prefill_program)
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
    ``count`` and ``observe_queue_depth``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events: Dict[str, int] = {}

    def count(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self.events[name] = self.events.get(name, 0) + int(delta)

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

    The reference engine's speculative decoding, prefix cache, KV spill
    tiers, disaggregated roles, mesh sharding, int8 weights, step hook,
    telemetry spans, chaos sites and AOT warmup manifests are not carried
    yet.
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
                 timeout_ms: Optional[float] = None):
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
        self._bt = self._bt_host.numpy()
        self._pos = self._pos_host.numpy()
        self._toks = self._toks_host.numpy()

        self._decode_run = paged_decode_program(
            model, greedy=greedy, temperature=temperature, top_k=top_k)
        self._prefill_runs: Dict[int, GraphedProgram] = {}
        # one memory pool for every prefill bucket's graph
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

    def _prefill_run(self, bucket: int) -> GraphedProgram:
        run = self._prefill_runs.get(bucket)
        if run is None:
            run = paged_prefill_program(
                self._model, prefill_len=bucket, block_size=self.block_size,
                kv_cache_dtype=self._kv_dtype, greedy=self._greedy,
                temperature=self._temperature, top_k=self._top_k,
                graph_pool=self._prefill_pool)
            self._prefill_runs[bucket] = run
        return run

    # -- warmup ------------------------------------------------------------
    def warmup(self, prompt_lengths=None) -> List[int]:
        """Capture the decode step and the prefill buckets of
        ``prompt_lengths`` (default: one, ``block_size``) ahead of
        traffic, as the reference's ``warmup`` compiles them: one call
        of each program on trash-table inputs, which on a card captures
        its graph (on the CPU the call just runs). Returns the warmed
        prefill buckets, those the reference's engine gives for the same
        lengths."""
        lens = (list(prompt_lengths) if prompt_lengths
                else [self.block_size])
        buckets = sorted({self._prefill_bucket(int(p)) for p in lens})
        with self._state_lock:
            for b in buckets:
                ids = torch.full((b // self.block_size,), self._trash,
                                 dtype=torch.int64)
                self._prefill_run(b)(
                    torch.zeros((1, b), dtype=torch.int32), 0, self._pool_k,
                    self._pool_v, ids, self._gen)
            trash_bt = torch.full_like(self._bt_host, self._trash)
            self._decode_run(
                torch.zeros_like(self._toks_host), self._pool_k,
                self._pool_v, trash_bt, torch.zeros_like(self._pos_host),
                self._gen)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return buckets

    # -- block accounting --------------------------------------------------
    def _alloc(self, n: int) -> Optional[List[int]]:
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

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
        # stays inside the context window (pos_embed rows)
        if p + max_new_tokens > self.max_context:
            raise ValueError(
                f"prompt {p} + max_new_tokens {max_new_tokens} exceeds "
                f"max_context {self.max_context}")
        if -(-(p + max_new_tokens) // self.block_size) > self.num_blocks:
            raise ValueError(
                f"request needs more KV blocks than the whole pool holds "
                f"({self.num_blocks} x {self.block_size}) — it could never "
                "be admitted")
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

    def _admit(self, req: GenRequest, lane_idx: int) -> None:
        """Prefill ``req`` into ``lane_idx``, or shed it typed (expired
        deadline, or a pool that cannot hold its worst-case block
        reservation). A prefill fault fails THIS request and the engine
        keeps serving."""
        if req.expired(time.monotonic()):
            self.metrics.count("shed_deadline")
            req.fail(DeadlineExceeded(
                f"deadline passed while queued ({req.latency_s * 1e3:.1f} "
                "ms) — shed before prefill"))
            return
        p = int(req.prompt.shape[0])
        need = -(-(p + req.max_new_tokens) // self.block_size)
        blocks = self._alloc(need)
        if blocks is None:
            self.metrics.count("shed_overload")
            req.fail(ServerOverload(
                f"KV pool exhausted ({len(self._free)} free blocks, need "
                f"{need}) — back off and retry"))
            return
        t0 = time.perf_counter()
        try:
            first = self._full_prefill(req, blocks)
        except Exception as e:  # noqa: BLE001 — contained to the request
            self._free.extend(blocks)
            req.fail(_typed(e, "LLM prefill fault"))
            self.metrics.count("failed")
            return
        dt = time.perf_counter() - t0
        self.metrics.count("prefills")
        self._prefill_s += dt
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
        self.metrics.count("admitted")

    def _full_prefill(self, req: GenRequest, blocks: List[int]) -> int:
        """Bucketed whole-prompt prefill spliced into ``blocks``."""
        p = int(req.prompt.shape[0])
        bucket = self._prefill_bucket(p)
        nb_bucket = bucket // self.block_size
        nb_real = -(-p // self.block_size)
        ids = onp.full((nb_bucket,), self._trash, onp.int64)
        ids[:nb_real] = blocks[:nb_real]
        padded = onp.zeros((1, bucket), onp.int32)
        padded[0, :p] = req.prompt
        run = self._prefill_run(bucket)
        first, self._pool_k, self._pool_v = run(
            torch.from_numpy(padded), p - 1, self._pool_k, self._pool_v,
            torch.from_numpy(ids), self._gen)
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
        """Return the lane's blocks to the free list the moment its
        sequence finishes, and point the lane at the trash block."""
        self._free.extend(lane.blocks)
        lane.blocks = []
        if lane_idx is not None:
            self._lanes[lane_idx] = None
            self._bt[lane_idx, :] = self._trash
            self._pos[lane_idx] = 0
            self._toks[lane_idx, 0] = 0

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
            self._free = list(range(self.num_blocks))
            if not fatal:
                self._pool_k.zero_()
                self._pool_v.zero_()
                return True             # keep serving new requests
            n = self._queue.fail_all(lambda: ServerOverload(
                f"LLM engine stopped on a fatal fault: {typed!r}"))
            self.metrics.count("failed", n)
            return False

    # -- stats / lifecycle -------------------------------------------------
    def stats(self) -> Dict:
        """Counters, pool and timing state; ``graphs`` counts the CUDA
        graphs captured and replayed by the decode and prefill programs
        (0 on the CPU) and lists the prefill buckets captured."""
        c = self.metrics.snapshot()
        progs = [self._decode_run, *self._prefill_runs.values()]
        steps = c.get("decode_steps", 0)
        prefills = c.get("prefills", 0)
        return {
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
