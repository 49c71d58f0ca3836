"""The transient-vs-fatal error classifier of the PyTorch port (the
port's own copy of ``classify`` in ``mxnet_tpu/resilience/retry.py``).

It maps the exceptions a serving process sees onto two buckets:

- **transient** (worth retrying): overload shedding, flaky IO
  (``OSError`` family), runtime errors whose text carries a retryable
  status (``RESOURCE_EXHAUSTED``, ``out of memory``, ...) — anything a
  fresh attempt against recovered capacity can clear;
- **fatal** (fail fast): shape/dtype mismatches, programming bugs, and
  every ``MXNetError`` that is not a ``TransientError``.

The tables are the reference's, so both packages type the same fault
the same way: a card's ``torch.cuda.OutOfMemoryError`` reads "CUDA out
of memory" and is transient, a host ``MemoryError`` is fatal. The
reference's retry loops and policies are not carried.
"""
from __future__ import annotations

from ..base import FatalError, MXNetError, TransientError

__all__ = ["TRANSIENT", "FATAL", "classify", "is_transient"]

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
