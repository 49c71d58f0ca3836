"""Step-timeline tracing of the PyTorch port (the port's own copy of
``mxnet_tpu/telemetry/tracing.py``): spans, a bounded trace ring,
request trace contexts and Chrome export.

The process keeps ONE bounded ring of ``trace_event`` dicts
(:func:`buffer`) that the serving engine's step spans, chaos fires and
any :class:`span` append into; :func:`dump_chrome` writes it as a
Chrome ``trace_event`` JSON loadable in Perfetto or chrome://tracing.

**Step timelines** (:func:`step`) attribute a step's wall time into four
buckets:

- ``compile`` — the seconds a program spent capturing its CUDA graph
  (:class:`~mxnet_tpu_torch.gluon.model_zoo.generation.GraphedProgram`
  attributes each capture to the open step: the port's counterpart of
  the reference's XLA compile listener, which has none here);
- ``device`` — time in an explicit ``st.phase("device")``, with the
  compile time that occurred inside the phase subtracted so the two
  buckets never count the same wall time;
- ``input_starved`` — time a consumer waited on an empty input queue;
- ``host`` — the remainder, ``wall - (compile + device +
  input_starved)``, so the buckets sum to the measured wall time.

Recording is host arithmetic and one bounded-deque append: nothing
here synchronises with the card.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .registry import get_registry

__all__ = [
    "BUCKETS", "StepTimeline", "TraceBuffer", "TraceContext", "buffer",
    "span", "step", "current_step", "attribute", "phase_if_active",
    "chrome_trace", "dump_chrome", "now_us", "emit_complete",
    "emit_counter", "emit_instant", "new_trace_id", "current_trace",
    "trace_scope", "bind_trace", "clock_anchor",
]

#: Step attribution buckets (``host`` is the computed remainder).
BUCKETS = ("compile", "device", "input_starved", "host")


def _env_int(name: str, default: int) -> int:
    """Malformed-knob contract: a typo'd value (unparseable OR negative
    — deque(maxlen=-5) raises) must not kill `import mxnet_tpu`."""
    try:
        v = int(os.environ.get(name, "") or default)
    except ValueError:
        return default
    return v if v >= 0 else default


def now_us() -> float:
    """The trace clock (µs), ``time.perf_counter``."""
    return time.perf_counter() * 1e6


def clock_anchor() -> Dict[str, float]:
    """One ``(trace clock, wall clock)`` sample — the monotonic-epoch
    anchor a process exports so a merger can shift each per-process
    trace onto ONE shared (unix-epoch µs) timeline. ``perf_counter`` has an arbitrary,
    per-process zero; the pair below is the bridge:
    ``ts_unix_us = ts + (anchor_unix_us - anchor_mono_us)``."""
    # read the two clocks back-to-back; the instruction gap between
    # them (sub-µs) is the alignment error floor
    mono_us = time.perf_counter() * 1e6
    unix_us = time.time() * 1e6
    return {"mono_us": mono_us, "unix_us": unix_us}


# ---------------------------------------------------------------------------
# request-scoped trace context
# ---------------------------------------------------------------------------
_trace_seq_lock = threading.Lock()
_trace_seq = 0


def new_trace_id(prefix: str = "t") -> str:
    """Mint a cluster-unique trace id (``<prefix>-<pid>-<seq>`` — the
    pid namespaces concurrent minters across processes sharing one
    telemetry root). Minted at the request's FIRST entry point and
    propagated — never re-mint for a request that already carries
    one."""
    global _trace_seq
    with _trace_seq_lock:
        _trace_seq += 1
        seq = _trace_seq
    return f"{prefix}-{os.getpid()}-{seq}"


class TraceContext:
    """One request's distributed-trace identity: the ``trace_id``
    minted at admission plus the identity of the process/component
    currently serving it. Carried across process boundaries as a plain
    dict (:meth:`to_dict` / :meth:`from_dict`), and
    stamped into span/step args so the merged cluster timeline can be
    filtered down to ONE request's path through N processes."""

    __slots__ = ("trace_id", "parent_span", "role", "rank", "replica")

    def __init__(self, trace_id: Optional[str] = None,
                 parent_span: Optional[str] = None,
                 role: Optional[str] = None, rank: Optional[int] = None,
                 replica: Optional[str] = None):
        self.trace_id = trace_id or new_trace_id()
        self.parent_span = parent_span
        self.role = role
        self.rank = rank
        self.replica = replica

    def to_dict(self) -> Dict:
        out: Dict = {"trace_id": self.trace_id}
        for k in ("parent_span", "role", "rank", "replica"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> Optional["TraceContext"]:
        if not isinstance(d, dict) or not d.get("trace_id"):
            return None
        return cls(trace_id=str(d["trace_id"]),
                   parent_span=d.get("parent_span"),
                   role=d.get("role"), rank=d.get("rank"),
                   replica=d.get("replica"))

    def child(self, parent_span: str) -> "TraceContext":
        """The same trace, one hop deeper (new parent span label)."""
        return TraceContext(self.trace_id, parent_span, self.role,
                            self.rank, self.replica)

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"TraceContext({self.to_dict()!r})"


def current_trace() -> Optional[TraceContext]:
    """The trace context bound to this thread (or None)."""
    return getattr(_tls, "trace", None)


def bind_trace(ctx: Optional[TraceContext]) -> None:
    """Bind ``ctx`` to this thread un-scoped — for worker processes
    whose whole lifetime serves one trace;
    request-scoped callers use :class:`trace_scope`."""
    _tls.trace = ctx


class trace_scope:
    """Bind a :class:`TraceContext` to the current thread for the
    duration of a ``with`` block — spans/steps recorded inside pick it
    up (``StepTimeline`` stamps the ambient trace id into its args)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self) -> Optional[TraceContext]:
        self._prev = getattr(_tls, "trace", None)
        _tls.trace = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> bool:
        _tls.trace = self._prev
        return False


class TraceBuffer:
    """Bounded, thread-safe ring of Chrome ``trace_event`` dicts."""

    def __init__(self, maxlen: int):
        self._dq: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.dropped = 0
        #: total events ever appended — a cheap change detector (the
        #: exporter skips rewriting trace.json when the ring hasn't
        #: moved since the last exposition; length alone can't tell,
        #: a full ring keeps the same length forever)
        self.seq = 0

    def append(self, ev: dict) -> None:
        with self._lock:
            if len(self._dq) == self._dq.maxlen:
                self.dropped += 1
            self._dq.append(ev)
            self.seq += 1

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._dq)

    def tail(self, n: int) -> List[dict]:
        with self._lock:
            if n >= len(self._dq):
                return list(self._dq)
            return list(self._dq)[-n:]

    def clear(self) -> None:
        with self._lock:
            self._dq.clear()
            self.dropped = 0

    def __len__(self) -> int:
        return len(self._dq)


#: Ring capacity: ~260k events ≈ a few hundred MB of JSON at most; the
#: ring bounds memory (``MXNET_TPU_TRACE_EVENTS``).
_buffer = TraceBuffer(_env_int("MXNET_TPU_TRACE_EVENTS", 262144))


def buffer() -> TraceBuffer:
    """The process trace ring."""
    return _buffer


def emit_complete(name: str, ts_us: float, dur_us: float,
                  cat: str = "telemetry",
                  args: Optional[dict] = None,
                  tid: Optional[int] = None) -> None:
    ev = {"name": name, "cat": cat, "ph": "X", "ts": ts_us,
          "dur": dur_us, "pid": os.getpid(),
          "tid": tid if tid is not None
          else threading.get_ident() % 10000}
    if args:
        ev["args"] = args
    _buffer.append(ev)


def emit_counter(name: str, value: float,
                 ts_us: Optional[float] = None) -> None:
    _buffer.append({"name": name, "ph": "C",
                    "ts": now_us() if ts_us is None else ts_us,
                    "pid": os.getpid(), "args": {"value": value}})


def emit_instant(name: str, cat: str = "telemetry",
                 args: Optional[dict] = None) -> None:
    ev = {"name": name, "cat": cat, "ph": "i", "ts": now_us(),
          "pid": os.getpid(), "tid": threading.get_ident() % 10000,
          "s": "p"}
    if args:
        ev["args"] = args
    _buffer.append(ev)


class span:
    """Context manager adding one named complete span to the ring."""

    __slots__ = ("name", "cat", "args", "_t0")

    def __init__(self, name: str, cat: str = "telemetry",
                 args: Optional[dict] = None):
        self.name, self.cat, self.args = name, cat, args

    def __enter__(self) -> "span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self._t0
        emit_complete(self.name, now_us() - dur * 1e6, dur * 1e6,
                      self.cat, self.args)
        return False


# ---------------------------------------------------------------------------
# step timelines
# ---------------------------------------------------------------------------
_tls = threading.local()

# registry families (registered once at import; children created lazily)
_reg = get_registry()
_steps_total = _reg.counter(
    "telemetry_steps_total", "Steps timed by telemetry.step", ("name",))
_step_ms = _reg.histogram(
    "telemetry_step_ms", "Step wall time (ms)", ("name",))
_bucket_ms = _reg.histogram(
    "telemetry_step_bucket_ms",
    "Per-step wall-time attribution (ms) by bucket", ("name", "bucket"))
# step name -> (its steps counter, step ms histogram, {bucket:
# histogram}): the families' children, looked up once per name
_step_children: Dict[str, tuple] = {}


def _children_of(name: str) -> tuple:
    got = _step_children.get(name)
    if got is None:
        got = _step_children[name] = (
            _steps_total.labels(name=name), _step_ms.labels(name=name),
            {b: _bucket_ms.labels(name=name, bucket=b)
             for b in ("compile", "device", "input_starved", "host")})
    return got

class _Phase:
    __slots__ = ("_st", "_bucket", "_label", "_t0", "_noop")

    def __init__(self, st: "StepTimeline", bucket: str, label: str):
        self._st = st
        self._bucket = bucket
        self._label = label

    def __enter__(self) -> "_Phase":
        # a phase nested inside an open phase records nothing — the
        # outer phase already owns this wall time (e.g. a bench wrapping
        # trainer.step + barrier in phase('device') around the Trainer's
        # own internal device phase must not double-count)
        self._noop = self._st._open_phase is not None
        if not self._noop:
            self._st._open_phase = self._bucket
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._noop:
            return False
        dur = time.perf_counter() - self._t0
        st = self._st
        st._open_phase = None
        st.add(self._bucket, dur)
        event = (self._label, self._t0 * 1e6, dur * 1e6,
                 f"step.{self._bucket}")
        if st._held is not None:        # a deferred step emits it
            st._held.append(event)
        else:
            emit_complete(*event[:3], cat=event[3])
        return False


class StepTimeline:
    """One step's wall-time attribution. Use via :func:`step`::

        with telemetry.step("train", i) as st:
            batch = next(prefetch)          # input_starved: automatic
            loss = trainer_driven_step(...) # device/compile: automatic

    or attribute manually with :meth:`phase` / :meth:`add`.
    """

    __slots__ = ("name", "index", "_t0", "_wall", "_end_us", "_buckets",
                 "_open_phase", "_compile_in_device", "_prev",
                 "_cancelled", "_held", "_annotations")

    def __init__(self, name: str = "step", index: Optional[int] = None):
        self.name = name
        self.index = index
        self._buckets: Dict[str, float] = {
            "compile": 0.0, "device": 0.0, "input_starved": 0.0}
        self._open_phase: Optional[str] = None
        self._compile_in_device = 0.0
        self._wall: Optional[float] = None
        self._prev = None
        self._cancelled = False
        # a deferred step's phase events, until finish()
        self._held: Optional[List[tuple]] = None
        self._annotations: Optional[Dict] = None

    # -- recording --------------------------------------------------------
    def phase(self, bucket: str, label: Optional[str] = None) -> _Phase:
        if bucket not in self._buckets:
            raise ValueError(
                f"unknown bucket {bucket!r} (one of "
                f"{tuple(self._buckets)}; 'host' is the remainder)")
        return _Phase(self, bucket, label or f"{self.name}.{bucket}")

    def add(self, bucket: str, dur_s: float) -> None:
        """Attribute ``dur_s`` seconds to ``bucket`` (hook entry point:
        a program's graph capture calls this through :func:`attribute`)."""
        if bucket not in self._buckets:
            return  # hooks must never raise into the training loop
        self._buckets[bucket] += dur_s
        if bucket == "compile" and self._open_phase == "device":
            # the capture happened inside a timed device phase (the
            # first call of a graphed step): subtract at finish so the
            # two buckets never double-count the same wall time
            self._compile_in_device += dur_s

    def annotate(self, key: str, value) -> None:
        """Attach a JSON-friendly key/value to the step's span args —
        how the LLM scheduler stamps the ``trace_ids`` of the lanes a
        ``step[llm_decode]`` served, so the merged cluster timeline can
        be filtered to one request's path. Never raises (hook
        discipline: instrumentation must not fault the loop)."""
        try:
            if self._annotations is None:
                self._annotations = {}
            self._annotations[str(key)] = value
        except Exception:  # noqa: BLE001 — annotation is best-effort
            pass

    def cancel(self) -> None:
        """Record nothing on exit — for a step opened around a data
        pull that turned out to be the iterator's exhaustion (loops
        open the step BEFORE ``next()`` so starved waits attribute;
        the final empty pull is not a step)."""
        self._cancelled = True

    def defer(self) -> None:
        """Record at :meth:`finish` instead of on exit: the step's and
        its phases' events and histograms. Their times are fixed when
        they close all the same; a loop that does its bookkeeping while
        the device computes its next step takes them off the path
        between the two."""
        self._held = []

    def finish(self) -> None:
        """Record a deferred step (its span and histograms)."""
        if not self._cancelled:
            self._finish()

    # -- context ----------------------------------------------------------
    def __enter__(self) -> "StepTimeline":
        self._prev = getattr(_tls, "step", None)
        _tls.step = self
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        self._wall = end - self._t0
        self._end_us = end * 1e6            # the trace clock, now_us()
        _tls.step = self._prev
        if not self._cancelled and self._held is None:
            self._finish()
        return False

    def _finish(self) -> None:
        for name, ts_us, dur_us, cat in self._held or ():
            emit_complete(name, ts_us, dur_us, cat=cat)
        att = self.attribution()
        args = {k: round(v * 1e3, 3) for k, v in att.items()}
        args["wall_ms"] = round(self._wall * 1e3, 3)
        if self.index is not None:
            args["step"] = self.index
        if self._annotations:
            args.update(self._annotations)
        ctx = getattr(_tls, "trace", None)
        if ctx is not None and "trace_id" not in args:
            args["trace_id"] = ctx.trace_id
        emit_complete(f"step[{self.name}]",
                      self._end_us - self._wall * 1e6, self._wall * 1e6,
                      cat="step", args=args)
        steps, step_ms, bucket_ms = _children_of(self.name)
        steps.inc()
        step_ms.observe(self._wall * 1e3)
        for bucket, dur in att.items():
            bucket_ms[bucket].observe(dur * 1e3)

    # -- reading ----------------------------------------------------------
    @property
    def wall_s(self) -> Optional[float]:
        return self._wall

    def attribution(self) -> Dict[str, float]:
        """Seconds per bucket. After the step closes, buckets sum to the
        measured wall time exactly (``host`` is the remainder, and
        compile observed inside a device phase is subtracted from
        ``device``); while the step is open, the measured buckets so
        far."""
        compile_s = self._buckets["compile"]
        device = max(0.0, self._buckets["device"] - self._compile_in_device)
        inp = self._buckets["input_starved"]
        out = {"compile": compile_s, "device": device,
               "input_starved": inp}
        if self._wall is not None:
            out["host"] = max(0.0, self._wall - compile_s - device - inp)
        return out


def step(name: str = "step", index: Optional[int] = None) -> StepTimeline:
    """A new :class:`StepTimeline` context for one step."""
    return StepTimeline(name, index)


def current_step() -> Optional[StepTimeline]:
    """The innermost open step on this thread (hooks attribute into
    it), or None."""
    return getattr(_tls, "step", None)


def attribute(bucket: str, dur_s: float) -> None:
    """Attribute ``dur_s`` to ``bucket`` of the current step, if any —
    the one-line hook instrumented code calls (never raises)."""
    st = getattr(_tls, "step", None)
    if st is not None:
        st.add(bucket, dur_s)


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


def phase_if_active(bucket: str, label: Optional[str] = None):
    """``current_step().phase(...)`` when a step is open on this thread,
    else a reusable no-op context — the cheap guard hot seams
    use."""
    st = getattr(_tls, "step", None)
    if st is None:
        return _NULL_PHASE
    return st.phase(bucket, label)


# ---------------------------------------------------------------------------
# Chrome export
# ---------------------------------------------------------------------------
def chrome_trace(events: Optional[List[dict]] = None) -> dict:
    """A Chrome ``trace_event`` JSON object (Perfetto/chrome://tracing
    loadable) of ``events`` (default: the whole ring)."""
    return {"traceEvents": _buffer.snapshot() if events is None
            else list(events),
            "displayTimeUnit": "ms"}


def dump_chrome(path: str, events: Optional[List[dict]] = None) -> str:
    """Write :func:`chrome_trace` to ``path`` atomically
    (tmp → ``os.replace``). Returns ``path``."""
    payload = chrome_trace(events)
    tmp = f"{path}.tmp.{os.getpid()}"
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path
