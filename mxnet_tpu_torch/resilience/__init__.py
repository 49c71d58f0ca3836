"""Fault typing and fault injection of the PyTorch port (counterpart of
``mxnet_tpu/resilience``): the transient-vs-fatal classifier and the
retry loop (:mod:`.retry`) and the chaos sites (:mod:`.chaos`). The
reference's watchdog, supervisor and elastic cluster are not carried
(ROADMAP section 1 item 8)."""
from ..base import FatalError, TransientError  # noqa: F401
from . import chaos  # noqa: F401
from .retry import (FATAL, TRANSIENT, RetriesExhausted,  # noqa: F401
                    RetryPolicy, call_with_retry, classify, is_transient,
                    retry)

__all__ = ["FATAL", "TRANSIENT", "FatalError", "TransientError", "chaos",
           "classify", "is_transient", "RetryPolicy", "RetriesExhausted",
           "call_with_retry", "retry"]
