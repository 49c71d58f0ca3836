"""Retry/backoff and the transient-vs-fatal error classifier of the
PyTorch port (the port's own copy of ``mxnet_tpu/resilience/retry.py``).

The classifier maps the exceptions a serving process sees onto two buckets:

- **transient** (worth retrying): overload shedding, flaky IO
  (``OSError`` family), runtime errors whose text carries a retryable
  status (``RESOURCE_EXHAUSTED``, ``out of memory``, ...) — anything a
  fresh attempt against recovered capacity can clear;
- **fatal** (fail fast): shape/dtype mismatches, programming bugs, and
  every ``MXNetError`` that is not a ``TransientError``.

The tables are the reference's, so both packages type the same fault
the same way: a card's ``torch.cuda.OutOfMemoryError`` reads "CUDA out
of memory" and is transient, a host ``MemoryError`` is fatal.

:func:`retry` / :func:`call_with_retry` implement exponential backoff
with deterministic jitter and an overall deadline, the one retry loop
the DataLoader's batch fetch goes through. The reference leaves a
flight-recorder dump on a fatal fault; the port has no flight recorder,
so its loop only raises.
"""
from __future__ import annotations

import functools
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..base import FatalError, MXNetError, TransientError

__all__ = ["TRANSIENT", "FATAL", "classify", "is_transient",
           "RetryPolicy", "RetriesExhausted", "retry", "call_with_retry"]

TRANSIENT = "transient"
FATAL = "fatal"

# Substrings of runtime error text that mark a transient condition (the
# reference's table: runtime status codes folded into the message head,
# preemption notices, and "out of memory", which torch's CUDA
# OutOfMemoryError carries).
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "preempt",            # "preempted", "preemption notice"
    "Socket closed",
    "connection reset",
    "Connection reset",
    "temporarily unavailable",
    "out of memory",      # device OOM: retryable once pressure clears
    "OOM",
)

# Substrings marking a shape/type/tracing bug — fatal even when raised
# through an exception type the table below would otherwise retry.
_FATAL_MARKERS = (
    "INVALID_ARGUMENT",
    "Incompatible shapes",
    "incompatible shapes",
    "dtype mismatch",
    "rank mismatch",
    "TracerArrayConversionError",
    "ConcretizationTypeError",
)


def classify(exc: BaseException) -> str:
    """Return :data:`TRANSIENT` or :data:`FATAL` for ``exc``.

    Explicit taxonomy first (``TransientError`` / ``FatalError``), then
    builtin families, then message markers for the raw JAX/XLA runtime
    errors that arrive as plain ``RuntimeError``/``XlaRuntimeError``.
    Unknown errors default to FATAL — an unattended retry loop must not
    spin on a bug it cannot fix.
    """
    if isinstance(exc, FatalError):
        return FATAL
    if isinstance(exc, TransientError):
        return TRANSIENT
    if isinstance(exc, MXNetError):
        # framework errors declare transience by SUBCLASSING; the message
        # markers below must never apply to them — wrappers like
        # RetriesExhausted or the DataLoader's exhaustion error embed the
        # inner error's repr, and a leaked "UNAVAILABLE" substring would
        # flip an already-exhausted failure back to retryable
        return FATAL
    msg = str(exc)
    if any(m in msg for m in _FATAL_MARKERS):
        return FATAL
    if isinstance(exc, (TypeError, ValueError, KeyError, AttributeError,
                        NotImplementedError, AssertionError, ZeroDivisionError,
                        IndexError)):
        return FATAL
    if isinstance(exc, (FileNotFoundError, PermissionError, IsADirectoryError,
                        NotADirectoryError)):
        return FATAL  # deterministic filesystem errors: retry replays them
    if isinstance(exc, (OSError, TimeoutError, ConnectionError,
                        InterruptedError, BrokenPipeError)):
        return TRANSIENT  # flaky IO / filesystem / network
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return TRANSIENT  # XlaRuntimeError and friends carry the code in-text
    return FATAL


def is_transient(exc: BaseException) -> bool:
    return classify(exc) == TRANSIENT


class RetriesExhausted(MXNetError):
    """All attempts failed with transient errors. ``__cause__`` carries
    the last one; ``attempts`` how many were made."""

    def __init__(self, msg: str, attempts: int):
        super().__init__(msg)
        self.attempts = attempts

    def __reduce__(self):
        # args holds only msg, which breaks the default pickle path, and
        # this error crosses process boundaries (fork-pool loader workers)
        return (RetriesExhausted, (self.args[0], self.attempts))


@dataclass
class RetryPolicy:
    """Exponential backoff + jitter + deadline.

    Delay before attempt ``k`` (k >= 2) is
    ``min(base_delay_s * multiplier**(k-2), max_delay_s)`` scaled by a
    jitter factor in ``[1-jitter, 1]``. ``deadline_s`` bounds the whole
    call including sleeps: when the next sleep would cross it, the loop
    stops and raises :class:`RetriesExhausted`. ``seed`` None draws
    fresh entropy per loop (concurrent clients de-correlate); an int
    makes the schedule reproducible. ``rng``, a callable returning
    floats in [0, 1), wins over ``seed`` (``rng=lambda: 0.0`` pins the
    schedule to its upper envelope)."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline_s: Optional[float] = None
    seed: Optional[int] = None
    rng: Optional[Callable[[], float]] = None
    classify: Callable[[BaseException], str] = field(default=classify)
    sleep: Callable[[float], None] = field(default=time.sleep)

    def delays(self):
        """The backoff schedule (attempt 2, 3, ...) as a generator."""
        if self.rng is not None:
            draw = self.rng
        else:
            draw = (random.Random(self.seed) if self.seed is not None
                    else random.Random()).random
        d = self.base_delay_s
        while True:
            factor = 1.0 - self.jitter * draw() if self.jitter else 1.0
            yield min(d, self.max_delay_s) * factor
            d *= self.multiplier


def call_with_retry(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
                    on_retry: Optional[Callable] = None, **kwargs):
    """Run ``fn(*args, **kwargs)``, retrying transient failures.

    ``on_retry(attempt, exc, delay_s)`` is invoked before each backoff
    sleep. Fatal errors propagate untouched on the first occurrence;
    exhaustion raises :class:`RetriesExhausted` from the last transient
    error."""
    policy = policy or RetryPolicy()
    if policy.max_attempts < 1:
        raise ValueError("max_attempts must be >= 1")
    t0 = time.monotonic()
    delays = policy.delays()
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — classified below
            if policy.classify(e) != TRANSIENT:
                raise
            last = e
            if attempt >= policy.max_attempts:
                break
            delay = next(delays)
            if (policy.deadline_s is not None
                    and time.monotonic() - t0 + delay > policy.deadline_s):
                break
            if on_retry is not None:
                on_retry(attempt, e, delay)
            policy.sleep(delay)
    raise RetriesExhausted(
        f"{getattr(fn, '__name__', 'call')} failed after {attempt} "
        f"attempt(s); last transient error: {last!r}", attempt) from last


def retry(policy: Optional[RetryPolicy] = None, **overrides):
    """Decorator form of :func:`call_with_retry`: ``@retry()`` uses the
    defaults, keyword overrides build a policy
    (``@retry(max_attempts=5, base_delay_s=0.1)``)."""
    if policy is not None and overrides:
        raise ValueError("pass either a policy or keyword overrides, not both")
    pol = policy or RetryPolicy(**overrides)

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return call_with_retry(fn, *args, policy=pol, **kwargs)

        wrapped.retry_policy = pol
        return wrapped

    return deco
