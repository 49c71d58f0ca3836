"""Fault typing and fault injection of the PyTorch port (counterpart of
``mxnet_tpu/resilience``): the transient-vs-fatal classifier
(:mod:`.retry`) and the chaos sites (:mod:`.chaos`). The reference's
retry loops, watchdog, supervisor and elastic cluster are not carried
(ROADMAP section 1 item 8)."""
from ..base import FatalError, TransientError  # noqa: F401
from . import chaos  # noqa: F401
from .retry import FATAL, TRANSIENT, classify, is_transient  # noqa: F401

__all__ = ["FATAL", "TRANSIENT", "FatalError", "TransientError", "chaos",
           "classify", "is_transient"]
