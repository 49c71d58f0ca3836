"""``mxnet_tpu_torch.telemetry`` — the observability layer of the
PyTorch port (counterpart of ``mxnet_tpu/telemetry``).

- :mod:`.registry` — process-wide Counter/Gauge/Histogram families with
  labels; JSON snapshot and Prometheus text exposition
  (:func:`snapshot` / :func:`prometheus_text`);
- :mod:`.tracing` — one bounded trace ring, the span API, request trace
  contexts and **step timelines** that attribute each step's wall time
  into compile / device / input-starved / host buckets;
  :func:`dump_chrome` writes a Perfetto-loadable ``trace_event`` JSON.

The reference's exporter, flight recorder, MFU gauges, SLO rules and
cluster scraper are not carried (ROADMAP section 1 item 9).
"""
from __future__ import annotations

from . import tracing  # noqa: F401
from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    sanitize_name,
)
from .tracing import (  # noqa: F401
    BUCKETS,
    StepTimeline,
    TraceContext,
    attribute,
    buffer,
    chrome_trace,
    current_step,
    current_trace,
    dump_chrome,
    new_trace_id,
    phase_if_active,
    span,
    step,
    trace_scope,
)

__all__ = [
    "BUCKETS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "StepTimeline", "TraceContext", "attribute", "buffer",
    "chrome_trace", "current_step", "current_trace", "dump_chrome",
    "get_registry", "new_trace_id", "phase_if_active", "prometheus_text",
    "sanitize_name", "snapshot", "span", "step", "trace_scope", "tracing",
]


def snapshot():
    """JSON-friendly snapshot of every registered metric."""
    return get_registry().snapshot()


def prometheus_text() -> str:
    """Prometheus text exposition of every registered metric."""
    return get_registry().prometheus_text()
