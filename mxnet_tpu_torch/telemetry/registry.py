"""Process-wide metrics registry of the PyTorch port (the port's own
copy of ``mxnet_tpu/telemetry/registry.py``): Counter / Gauge /
Histogram families with labels.

One :class:`MetricsRegistry` per process (:func:`get_registry`) that
the serving engine's :class:`~mxnet_tpu_torch.serving.llm.LLMMetrics`
registers into. The names, labels, summaries and the exposition are
the reference's, so either package's exposition of the same events
reads the same:

- :meth:`MetricsRegistry.snapshot` — one JSON-friendly dict,
- :meth:`MetricsRegistry.prometheus_text` — Prometheus text exposition
  (format 0.0.4),
- :meth:`MetricsRegistry.deltas_since` — counter movement between two
  snapshots.

Recording is host arithmetic under a per-family lock: no metric update
or gauge read touches the card. Callback gauges (:meth:`Gauge.set_fn`)
are read at snapshot time, so the callable must be host-cheap.

Metric names follow Prometheus rules (``[a-zA-Z_:][a-zA-Z0-9_:]*``);
:func:`sanitize_name` maps dotted names (``serving.queue_depth``) onto
that grammar.
"""
from __future__ import annotations

import math
import re
from bisect import bisect_left
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "sanitize_name", "DEFAULT_BUCKETS",
    "QUANTILE_GAUGES",
]

#: Default histogram buckets (upper bounds), tuned for millisecond-scale
#: latencies — the dominant unit in this codebase's histograms.
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0, 10000.0, float("inf"))

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Map an arbitrary metric name onto the Prometheus grammar
    (``serving.queue_depth`` -> ``serving_queue_depth``)."""
    out = _SANITIZE_RE.sub("_", str(name))
    if not out or not _NAME_RE.match(out):
        out = "_" + out
    return out


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    """``# HELP`` text escaping (exposition format 0.0.4: only ``\\``
    and ``\\n`` — a newline in help text would otherwise truncate the
    line and make the next fragment unparseable to real scrapers)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


#: The rolling quantiles every histogram additionally exports as gauge
#: series (``<name>_p50`` / ``_p95`` / ``_p99``) — ONE definition of
#: "p99" shared by the exposition, the Router's hedge threshold and the
#: bench rows, instead of each computing its own over private lists.
QUANTILE_GAUGES = ((0.50, "p50"), (0.95, "p95"), (0.99, "p99"))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotonic counter child (one label combination)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, delta: float = 1.0) -> None:
        if delta < 0:
            raise ValueError("Counter.inc delta must be >= 0")
        with self._lock:
            self.value += delta

    def get(self) -> float:
        return self.value


class Gauge:
    """Gauge child: a settable level, or a callback read at snapshot.

    A callback gauge (:meth:`set_fn`) must be host-cheap and must not
    touch device arrays — snapshot/exposition runs it on the exporter
    thread and a device sync there would serialize the hot loop.
    """

    __slots__ = ("_lock", "value", "_fn")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, delta: float = 1.0) -> None:
        with self._lock:
            self.value += delta

    def dec(self, delta: float = 1.0) -> None:
        with self._lock:
            self.value -= delta

    def set_fn(self, fn: Optional[Callable[[], float]]) -> None:
        with self._lock:
            self._fn = fn

    def get(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:  # noqa: BLE001 — a broken callback reads 0,
                return 0.0     # it must not take exposition down
        return self.value


class Histogram:
    """Histogram child: exact count/sum/min/max, cumulative Prometheus
    buckets, plus a bounded recency reservoir for quantiles — p99 should
    describe the current regime, not the warmup (the serving semantic
    this class was deduplicated from, ``serving/metrics.py``)."""

    __slots__ = ("_lock", "count", "total", "min", "max", "_recent",
                 "buckets", "bucket_counts")

    def __init__(self, lock: Optional[threading.Lock] = None,
                 cap: int = 4096,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self._lock = lock or threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._recent: deque = deque(maxlen=cap)
        b = tuple(sorted(float(x) for x in buckets))
        if not b or b[-1] != math.inf:
            b = b + (math.inf,)
        self.buckets = b
        self.bucket_counts = [0] * len(b)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._recent.append(v)
            # the first bucket whose upper bound is >= v
            self.bucket_counts[bisect_left(self.buckets, v)] += 1

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @staticmethod
    def _q(vals: List[float], q: float) -> float:
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
        return vals[idx]

    def quantile(self, q: float) -> float:
        with self._lock:
            vals = sorted(self._recent)
        return self._q(vals, q)

    def quantiles(self) -> Dict[str, float]:
        """The rolling :data:`QUANTILE_GAUGES` (p50/p95/p99) in ONE
        consistent sort pass — what the Prometheus exposition exports
        as ``<name>_p50``/``_p95``/``_p99`` gauge series."""
        with self._lock:
            vals = sorted(self._recent)
        return {label: self._q(vals, q) for q, label in QUANTILE_GAUGES}

    def summary(self) -> Dict[str, float]:
        """The serving-bench summary shape (count/mean/min/max/p50/90/99)
        — unchanged from the pre-telemetry ``serving.metrics.Histogram``
        so banked serve_bench rows keep their schema. All fields are
        read under the lock as ONE consistent snapshot (a scrape racing
        an observe must not pair a new count with an old sum)."""
        with self._lock:
            count, total = self.count, self.total
            mn, mx = self.min, self.max
            vals = sorted(self._recent)
        return {
            "count": count,
            "mean": round(total / count, 4) if count else 0.0,
            "min": round(mn, 4) if mn is not None else 0.0,
            "max": round(mx, 4) if mx is not None else 0.0,
            "p50": round(self._q(vals, 0.50), 4),
            "p90": round(self._q(vals, 0.90), 4),
            "p95": round(self._q(vals, 0.95), 4),
            "p99": round(self._q(vals, 0.99), 4),
        }

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        return self.scrape()[0]

    def scrape(self) -> Tuple[List[Tuple[float, int]], float, int]:
        """One consistent ``(cumulative_buckets, sum, count)`` triple
        for the Prometheus exposition — ``_count`` must agree with the
        ``+Inf`` bucket within a single scrape."""
        with self._lock:
            counts = list(self.bucket_counts)
            total, count = self.total, self.count
        out, acc = [], 0
        for ub, c in zip(self.buckets, counts):
            acc += c
            out.append((ub, acc))
        return out, total, count


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric with fixed label names; children per label
    values. The no-label child is the ``()`` entry."""

    __slots__ = ("name", "kind", "help", "label_names", "_children",
                 "_lock", "_hist_kwargs")

    def __init__(self, name: str, kind: str, help_: str,
                 label_names: Tuple[str, ...], **hist_kwargs):
        self.name = name
        self.kind = kind
        self.help = help_
        self.label_names = label_names
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        self._hist_kwargs = hist_kwargs

    def _make_child(self):
        if self.kind == "histogram":
            return Histogram(threading.Lock(), **self._hist_kwargs)
        return _KINDS[self.kind](threading.Lock())

    def labels(self, **labels):
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    self._children[key] = child
        return child

    def child(self):
        """The label-less child (only valid when the family has no
        label names)."""
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} has labels {self.label_names}; "
                "use .labels(...)")
        return self.labels()

    def series(self) -> List[Tuple[Dict[str, str], object]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.label_names, key)), child)
                for key, child in sorted(items)]

    # convenience pass-throughs for label-less families
    def inc(self, delta: float = 1.0) -> None:
        self.child().inc(delta)

    def set(self, v: float) -> None:
        self.child().set(v)

    def dec(self, delta: float = 1.0) -> None:
        self.child().dec(delta)

    def set_fn(self, fn) -> None:
        self.child().set_fn(fn)

    def observe(self, v: float) -> None:
        self.child().observe(v)

    def get(self) -> float:
        return self.child().get()

    def summary(self) -> Dict[str, float]:
        return self.child().summary()

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        return self.child().cumulative_buckets()


class MetricsRegistry:
    """Thread-safe named-family store + exposition.

    Registration is idempotent: re-registering an existing name with the
    same kind returns the existing family (subsystems can re-register at
    every construction — serving engines, prefetchers — and share
    series); a kind mismatch raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- registration -----------------------------------------------------
    def _register(self, kind: str, name: str, help_: str,
                  labels: Iterable[str] = (), **kwargs) -> _Family:
        name = str(name)
        if not _NAME_RE.match(name):
            raise ValueError(
                f"invalid metric name {name!r} (Prometheus grammar "
                "[a-zA-Z_:][a-zA-Z0-9_:]*); sanitize_name() maps legacy "
                "dotted names")
        label_names = tuple(str(x) for x in labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, cannot re-register as {kind}")
                if fam.label_names != label_names:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.label_names}, got {label_names}")
                return fam
            fam = _Family(name, kind, help_, label_names, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                labels: Iterable[str] = ()) -> _Family:
        return self._register("counter", name, help_, labels)

    def gauge(self, name: str, help_: str = "",
              labels: Iterable[str] = ()) -> _Family:
        return self._register("gauge", name, help_, labels)

    def histogram(self, name: str, help_: str = "",
                  labels: Iterable[str] = (), cap: int = 4096,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> _Family:
        return self._register("histogram", name, help_, labels,
                              cap=cap, buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._families)

    def unregister(self, name: str) -> None:
        """Drop a family (tests; production families live for the
        process)."""
        with self._lock:
            self._families.pop(name, None)

    # -- exposition -------------------------------------------------------
    def snapshot(self) -> Dict:
        """Everything, JSON-friendly: ``{name: {kind, help, series:
        [{labels, value | summary}]}}`` plus a timestamp."""
        with self._lock:
            fams = list(self._families.values())
        out: Dict = {"ts_unix": time.time(), "metrics": {}}
        for fam in sorted(fams, key=lambda f: f.name):
            series = []
            for labels, child in fam.series():
                if fam.kind == "histogram":
                    series.append({"labels": labels,
                                   "summary": child.summary()})
                else:
                    series.append({"labels": labels,
                                   "value": child.get()})
            out["metrics"][fam.name] = {
                "kind": fam.kind, "help": fam.help, "series": series}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            fams = list(self._families.values())
        lines: List[str] = []
        for fam in sorted(fams, key=lambda f: f.name):
            if fam.help:
                lines.append(
                    f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            quantile_lines: Dict[str, List[str]] = {}
            for labels, child in fam.series():
                lab = ",".join(f'{k}="{_escape_label(v)}"'
                               for k, v in labels.items())
                if fam.kind == "histogram":
                    cum_buckets, total, count = child.scrape()
                    for ub, cum in cum_buckets:
                        blab = (lab + "," if lab else "") + \
                            f'le="{_fmt(ub)}"'
                        lines.append(
                            f"{fam.name}_bucket{{{blab}}} {cum}")
                    suffix = f"{{{lab}}}" if lab else ""
                    lines.append(
                        f"{fam.name}_sum{suffix} {_fmt(total)}")
                    lines.append(
                        f"{fam.name}_count{suffix} {count}")
                    for q_label, v in child.quantiles().items():
                        quantile_lines.setdefault(q_label, []).append(
                            f"{fam.name}_{q_label}{suffix} {_fmt(v)}")
                else:
                    suffix = f"{{{lab}}}" if lab else ""
                    lines.append(
                        f"{fam.name}{suffix} {_fmt(child.get())}")
            # rolling-reservoir quantiles ride along as gauge families
            # (<name>_p50/_p95/_p99) — one shared p99 definition
            # instead of private sorted lists
            for _, q_label in QUANTILE_GAUGES:
                if quantile_lines.get(q_label):
                    lines.append(f"# TYPE {fam.name}_{q_label} gauge")
                    lines.extend(quantile_lines[q_label])
        return "\n".join(lines) + "\n"

    @staticmethod
    def deltas_since(prev: Dict, cur: Dict) -> Dict[str, Dict[str, float]]:
        """Counter/histogram-count movement between two :meth:`snapshot`
        payloads — the flight recorder's "what changed in the window
        before the crash". Gauges report their current value (a level
        has no meaningful delta)."""
        out: Dict[str, Dict[str, float]] = {}
        pm = prev.get("metrics", {})
        for name, fam in cur.get("metrics", {}).items():
            prev_series = {
                tuple(sorted(s["labels"].items())): s
                for s in pm.get(name, {}).get("series", [])}
            for s in fam["series"]:
                key = tuple(sorted(s["labels"].items()))
                ps = prev_series.get(key)
                lab = ",".join(f"{k}={v}" for k, v in sorted(
                    s["labels"].items()))
                sname = f"{name}{{{lab}}}" if lab else name
                if fam["kind"] == "histogram":
                    d = (s["summary"]["count"]
                         - (ps["summary"]["count"] if ps else 0))
                    if d:
                        out.setdefault(name, {})[sname] = d
                elif fam["kind"] == "counter":
                    d = s["value"] - (ps["value"] if ps else 0.0)
                    if d:
                        out.setdefault(name, {})[sname] = d
                else:  # gauge: current level
                    if s["value"] or ps is not None:
                        out.setdefault(name, {})[sname] = s["value"]
        return out


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem re-registers into."""
    return _default
