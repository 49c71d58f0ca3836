"""Admission control: bounded request queue, deadlines, load shedding
(the port's copy of ``mxnet_tpu/serving/admission.py``; it has no
framework code).

The serving analog of the reference engine's bounded task queues
(``dmlc::ConcurrentBlockingQueue`` under ``src/engine/threaded_engine.h``):
a server in overload must convert excess demand into *typed, immediate*
errors instead of unbounded queueing latency. Two shedding points:

- **admission time** — the queue is bounded; a full queue raises
  :class:`ServerOverload` in the submitting thread without enqueueing.
- **dequeue time** — each request carries an absolute deadline; the
  batcher sheds requests whose deadline already passed *before* spending
  accelerator time on them, completing them with :class:`DeadlineExceeded`.

Both errors subclass :class:`~mxnet_tpu_torch.base.MXNetError` so existing
``except MXNetError`` surfaces catch them.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

from ..base import TransientError

__all__ = ["ServerOverload", "DeadlineExceeded", "RequestCancelled",
           "Request", "AdmissionQueue"]


class ServerOverload(TransientError):
    """The serving queue is full (or closed) — request rejected at
    admission so the caller can back off / retry elsewhere. Subclasses
    :class:`~mxnet_tpu_torch.base.TransientError`: retryable, so a
    client's retry loop backs off and resubmits without
    special-casing."""


class DeadlineExceeded(TransientError):
    """The request's deadline budget ran out — at admission, at dequeue,
    or (for generation lanes) mid-execution, where the expired work is
    retired instead of streamed to a client that already gave up.
    Transient: a resubmission with a fresh deadline is always safe.

    ``elapsed_s`` / ``budget_s`` carry how long the request actually ran
    against how much it was given (None when unknown), so a client's
    retry loop can tell "shed instantly under load" from "my budget is
    simply too small for this request"."""

    def __init__(self, msg: str, elapsed_s: Optional[float] = None,
                 budget_s: Optional[float] = None):
        super().__init__(msg)
        self.elapsed_s = elapsed_s
        self.budget_s = budget_s

    def __reduce__(self):
        # args holds only msg; the extra attrs must survive pickling
        # across drill process boundaries like the rest of the taxonomy
        return (DeadlineExceeded,
                (self.args[0], self.elapsed_s, self.budget_s))


class RequestCancelled(TransientError):
    """The request was cancelled by its submitter (or by a fleet router
    whose hedged twin of this request already won) before it finished.
    Transient: cancellation says nothing about the server's health, and
    re-submission is always safe — though the canceller, by definition,
    no longer wants the result."""


class Request:
    """One in-flight inference request: payload + completion slot.

    ``payload`` carries the host-staged input array(s) with a leading
    batch axis of length ``n``; ``signature`` is the (trailing-shape,
    dtype) tuple the batcher groups on. Completion is a one-shot event:
    exactly one of :meth:`finish` / :meth:`fail` fires, and the
    submitting thread collects the outcome in :meth:`wait`.
    """

    __slots__ = ("payload", "n", "signature", "deadline", "enqueue_t",
                 "_event", "_result", "_error", "_cancelled")

    def __init__(self, payload: Any, n: int, signature: Tuple,
                 deadline: Optional[float]):
        self.payload = payload
        self.n = n
        self.signature = signature
        self.deadline = deadline          # absolute monotonic seconds
        self.enqueue_t = time.monotonic()
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._cancelled = False

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                > self.deadline)

    def cancel(self) -> None:
        """Ask the server to stop working on this request. Advisory and
        asynchronous: the serving loop retires the request (failing it
        with :class:`RequestCancelled`) at its next scheduling point —
        a request that completes first keeps its result (first
        completion wins). Safe from any thread, idempotent."""
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def done(self) -> bool:
        """True once exactly one of finish/fail has fired (non-blocking
        — the poll the fleet router's relay loop runs instead of parking
        a waiter thread per request)."""
        return self._event.is_set()

    def exception(self) -> Optional[BaseException]:
        """The failure, if this request is done and failed; None while
        pending or on success. Non-blocking."""
        return self._error if self._event.is_set() else None

    def result(self) -> Any:
        """The result, if done and successful (None otherwise) —
        non-blocking peek; use :meth:`wait` to block."""
        return self._result if self._event.is_set() else None

    def finish(self, result: Any) -> bool:
        """First completion wins; returns whether THIS call completed it
        (so callers can account exactly-once)."""
        if self._event.is_set():
            return False
        self._result = result
        self._event.set()
        return True

    def fail(self, error: BaseException) -> bool:
        if self._event.is_set():
            return False  # first completion wins
        self._error = error
        self._event.set()
        return True

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Block the submitting thread until completion; re-raise the
        batcher-side error (typed shedding errors included) in the
        caller. A client-side ``timeout`` expiring is NOT a shed — the
        request stays queued and may still execute — so it raises the
        builtin :class:`TimeoutError`, not :class:`DeadlineExceeded`
        (which promises no compute was spent)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                "request did not complete within the client-side wait "
                "budget; it is still queued/executing server-side (use "
                "timeout_ms at submission for true pre-execution "
                "shedding)")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> float:
        return time.monotonic() - self.enqueue_t


class AdmissionQueue:
    """Bounded FIFO with deadline-aware batched dequeue.

    ``submit`` never blocks: overload is an error, not latency (the
    load-shedding contract above). ``take`` blocks the batcher thread
    until at least one live request is available, then gathers more
    same-signature requests up to ``max_items`` / ``max_wait_s``.
    """

    def __init__(self, max_size: int, metrics=None):
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        self._max = max_size
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._metrics = metrics

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Stop admitting; wake the batcher so it can drain or exit."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def fail_all(self, error_factory: Callable[[], BaseException]) -> int:
        """Fail every queued request (non-drain shutdown). Returns the
        number of requests failed."""
        with self._cond:
            pending, self._q = list(self._q), deque()
        for req in pending:
            req.fail(error_factory())
        return len(pending)

    def submit(self, req: Request) -> None:
        with self._cond:
            if self._closed:
                raise ServerOverload("serving engine is closed")
            if len(self._q) >= self._max:
                if self._metrics is not None:
                    self._metrics.count("shed_overload")
                raise ServerOverload(
                    f"serving queue full ({self._max} requests queued); "
                    "shedding at admission — back off and retry")
            self._q.append(req)
            if self._metrics is not None:
                self._metrics.observe_queue_depth(len(self._q))
            self._cond.notify()

    # -- batcher side -----------------------------------------------------
    def _shed_expired_head(self, now: float) -> None:
        """Fail-and-drop expired/cancelled requests at the queue head
        (under lock)."""
        while self._q and (self._q[0].expired(now)
                           or self._q[0].cancelled):
            req = self._q.popleft()
            if req.cancelled and not req.expired(now):
                req.fail(RequestCancelled(
                    "request cancelled while queued — dropped before "
                    "execution"))
                continue
            if self._metrics is not None:
                self._metrics.count("shed_deadline")
            budget = (req.deadline - req.enqueue_t
                      if req.deadline is not None else None)
            req.fail(DeadlineExceeded(
                f"deadline passed while queued ({req.latency_s * 1e3:.1f} "
                f"ms in queue vs a "
                f"{budget * 1e3:.1f} ms budget) — shed before execution",
                elapsed_s=req.latency_s, budget_s=budget))

    def take(self, max_items: int, max_wait_s: float,
             poll_s: float = 0.05) -> List[Request]:
        """Gather the next micro-batch.

        Blocks (in ``poll_s`` slices so ``close()`` is honored promptly)
        until a live request arrives, then keeps gathering until the
        coalesced batch reaches ``max_items`` samples, ``max_wait_s``
        elapses since the first request was taken, or a request with a
        different signature is at the head (shape/dtype groups never
        mix in one executable). Returns [] only when closed-and-empty
        or after an idle poll slice (caller loops).
        """
        batch: List[Request] = []
        taken = 0
        first_t = None
        with self._cond:
            while True:
                now = time.monotonic()
                self._shed_expired_head(now)
                if self._q and (not batch
                                or self._q[0].signature == batch[0].signature):
                    head = self._q[0]
                    if batch and taken + head.n > max_items:
                        break  # would overflow the bucket — next cycle
                    self._q.popleft()
                    batch.append(head)
                    taken += head.n
                    if first_t is None:
                        first_t = now
                    if taken >= max_items:
                        break
                    continue
                if self._q and batch:
                    break  # signature change: flush what we have
                if self._closed:
                    break
                if batch:
                    remaining = max_wait_s - (now - first_t)
                    if remaining <= 0:
                        break
                    self._cond.wait(min(remaining, poll_s))
                else:
                    self._cond.wait(poll_s)
                    if not self._q:
                        break  # idle slice — let the caller re-loop
        return batch
