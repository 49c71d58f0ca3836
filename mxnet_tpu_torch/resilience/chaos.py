"""Fault injection of the PyTorch port (the port's own copy of
``mxnet_tpu/resilience/chaos.py``): a process-global registry of named
chaos sites.

Instrumented hot paths call :func:`site` with a well-known name; each
call is a **no-op costing one dict lookup** unless a rule is armed for
that name (env var or :func:`scope`). Armed rules can

- **raise** a typed fault (``transient`` / ``fatal`` / ``oserror``),
- **delay** the call (injected latency),
- **kill** the process after N calls (``os._exit(137)``).

Arming is either programmatic (tests)::

    with chaos.scope("serving.llm", fail="transient", times=1): ...

or environment-driven, with the reference's grammar::

    MXNET_TPU_CHAOS="serving.llm=raise:transient:0.5;serving.llm.verify=delay:0.2"

Rules split on ``;``, each ``site=action[:arg[:p]]`` with
``raise:<kind>[:p]`` / ``delay:<seconds>[:p]`` / ``kill[:after_n]``.
``p`` is a fire probability drawn from a **deterministic** per-site RNG
seeded by ``MXNET_TPU_CHAOS_SEED`` (default 0). Faults that fire are
counted in :func:`stats` and emitted as ``chaos[<site>]`` instants into
the telemetry trace ring.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional

from ..base import FatalError, MXNetError, TransientError

__all__ = [
    "ChaosFault", "ChaosTransient", "ChaosFatal", "ChaosGarble", "SITES",
    "site", "scope", "armed", "clear", "stats", "reset_stats",
    "refresh_from_env",
]

#: The injection sites instrumented in this codebase. ``site`` accepts any
#: name (tests/tools may add their own); env rules naming a site outside
#: this set warn once — it is almost always a typo.
SITES = (
    "checkpoint.write",   # CheckpointManager.save, between write and publish
    "dataloader.next",    # gluon DataLoader batch fetch
    "device.put",         # ndarray host<->device / cross-device transfer
    "serving.infer",      # InferenceEngine micro-batch execution
    "serving.llm",        # LLMEngine prefill-splice (admission into lanes)
    "serving.llm.verify", # LLMEngine speculative draft-verify splice
    "serving.fleet.replica",  # fleet replica step loop / dispatch (kill or
                          # fatal = dead replica, delay = wedged replica;
                          # per-replica variants fire as
                          # serving.fleet.replica.<name>)
    "compile",            # HybridBlock trace/compile path
    "aot.read",           # CompileCache entry lookup (before the read)
    "aot.write",          # CompileCache publish, payload staged, pre-rename
    "aot.deserialize",    # cached_jit payload deserialize on a store hit
    "telemetry.export",   # telemetry exporter exposition (file write/HTTP)
    "telemetry.scrape",   # ClusterScraper shared-root scrape (a faulting
                          # scraper degrades warn-once and never reaches
                          # the serving/training loop)
    "dist.heartbeat",     # elastic heartbeat beat loop (kill = dead rank,
                          # delay = wedged host whose peers see it stale)
    "dist.collective",    # elastic collective entry (kill:N = rank death
                          # mid-train, delay = slow-rank straggler)
    "ckpt.shard",         # coordinated save, between shard payload and
                          # its manifest (a fault = commit must refuse)
    "io.worker",          # dataset-service decode worker, per batch
                          # (kill = dead decoder mid-epoch, delay = a
                          # wedged decode whose progress-gated beats go
                          # stale and trigger range re-dispatch)
    "io.stream",          # dataset-service consumer fetch (a batch
                          # faulted in transit — the bounded retry loop
                          # must absorb it; delay = slow shared fs)
    "io.net.accept",      # BlockServer connection accept (raise = the
                          # just-accepted connection is dropped — the
                          # client sees a peer reset and fails over;
                          # delay = slow accept path)
    "io.net.frame",       # BlockServer response send (garble = payload
                          # bytes flipped on the wire AFTER the checksum
                          # is computed, so the client's verify-on-
                          # receive must reject the frame; raise/delay
                          # as usual)
)


class ChaosFault(MXNetError):
    """Base class of injected faults (never raised by real failures)."""


class ChaosTransient(ChaosFault, TransientError):
    """Injected fault the classifier must treat as retryable."""


class ChaosFatal(ChaosFault, FatalError):
    """Injected fault the classifier must treat as non-retryable."""


class ChaosGarble(ChaosFault):
    """Corruption marker: the instrumented site must CATCH this and
    corrupt its payload in place of raising (``BlockServer`` flips
    payload bytes after computing the checksum). Escaping to a caller
    means a site was armed with ``garble`` that doesn't implement it —
    loud by design."""


_FAULT_KINDS = {
    "transient": lambda site_: ChaosTransient(
        f"chaos: injected transient fault at {site_!r}"),
    "fatal": lambda site_: ChaosFatal(
        f"chaos: injected fatal fault at {site_!r}"),
    "oserror": lambda site_: OSError(
        f"chaos: injected OSError at {site_!r}"),
    "garble": lambda site_: ChaosGarble(
        f"chaos: injected frame corruption at {site_!r}"),
}


class _Rule:
    __slots__ = ("action", "arg", "p", "after", "times", "calls", "fired",
                 "_rng")

    def __init__(self, action: str, arg=None, p: float = 1.0, after: int = 0,
                 times: Optional[int] = None, seed: int = 0):
        self.action = action      # 'raise' | 'delay' | 'kill'
        self.arg = arg            # fault kind/exception | seconds | None
        self.p = float(p)
        self.after = int(after)   # skip the first `after` calls
        self.times = times        # max fires (None = unlimited)
        self.calls = 0
        self.fired = 0
        self._rng = random.Random(seed)


_lock = threading.Lock()
# site -> rules. EMPTY when disarmed: site() bails on one failed dict
# lookup, the zero-overhead guard the acceptance criteria pin.
_rules: Dict[str, List[_Rule]] = {}
_stats: Dict[str, Dict[str, int]] = {}
_warned_sites: set = set()


def site(name: str, **ctx) -> None:
    """A named injection point. No-op (one dict lookup) unless armed."""
    rules = _rules.get(name)
    if rules is None:
        return
    _visit(name, rules, ctx)


def armed() -> bool:
    return bool(_rules)


def _count(name: str, key: str, delta: int = 1) -> None:
    st = _stats.setdefault(name, {})
    st[key] = st.get(key, 0) + delta


def _emit_trace(name: str, action: str, dur_s: float) -> None:
    from ..telemetry import tracing

    tracing.emit_instant(f"chaos[{name}]:{action}", cat="chaos",
                         args={"dur_s": dur_s})


def _visit(name: str, rules: List[_Rule], ctx: dict) -> None:
    # bookkeeping under the lock: concurrent armed-site calls (batcher
    # thread + client threads in the serving drills) must not lose
    # counter increments or over-fire a times=N budget. Fault EXECUTION
    # happens after release — a delay must not hold the lock.
    to_fire: List[_Rule] = []
    with _lock:
        _count(name, "calls")
        for rule in rules:
            rule.calls += 1
            if rule.calls <= rule.after:
                continue
            if rule.times is not None and rule.fired >= rule.times:
                continue
            if rule.p < 1.0 and rule._rng.random() >= rule.p:
                continue
            rule.fired += 1
            _count(name, rule.action)
            to_fire.append(rule)
    for rule in to_fire:
        if rule.action == "delay":
            dur = float(rule.arg)
            _emit_trace(name, "delay", dur)
            # the sleep IS the injected fault — callers holding locks
            # through a chaos site are exercising, not leaking, latency
            time.sleep(dur)
            continue  # latency composes with later rules
        if rule.action == "kill":
            # pod-eviction semantics: no atexit, no buffers flushed. 137
            # = 128+SIGKILL, the exit code an OOM-killed / preempted
            # container reports, so harnesses can recognize chaos kills
            os._exit(137)
        # 'raise'
        _emit_trace(name, "raise", 0.0)
        arg = rule.arg
        if isinstance(arg, BaseException):
            raise arg
        if isinstance(arg, type) and issubclass(arg, BaseException):
            raise arg(f"chaos: injected {arg.__name__} at {name!r}")
        kind = _FAULT_KINDS.get(str(arg or "transient"))
        if kind is None:
            kind = _FAULT_KINDS["transient"]
        raise kind(name)


def _add_rule(name: str, rule: _Rule) -> None:
    with _lock:
        # site() reads _rules lock-free; CPython dict/list mutation is
        # atomic, so append-in-place never exposes a partial state
        _rules.setdefault(name, []).append(rule)


def _remove_rule(name: str, rule: _Rule) -> None:
    with _lock:
        lst = _rules.get(name)
        if lst is None:
            return
        lst = [r for r in lst if r is not rule]
        if lst:
            _rules[name] = lst
        else:
            _rules.pop(name, None)


def clear() -> None:
    """Disarm everything (env rules included) and reset per-rule state."""
    with _lock:
        _rules.clear()


def stats() -> Dict[str, Dict[str, int]]:
    """Per-site counters: ``calls`` seen while armed plus fires by action
    (``raise`` / ``delay`` / ``kill``)."""
    with _lock:
        return {k: dict(v) for k, v in _stats.items()}


def reset_stats() -> None:
    with _lock:
        _stats.clear()


class scope:
    """Context manager arming one rule for the ``with`` body (tests).

    Parameters
    ----------
    name : str
        Site name (one of :data:`SITES`, or any custom name).
    delay : float, optional
        Inject this many seconds of latency per call.
    fail : str | BaseException | type, optional
        Raise: a kind string (``transient`` / ``fatal`` / ``oserror``),
        an exception instance (raised as-is, so identity asserts work),
        or an exception class.
    kill_after : int, optional
        ``os._exit(137)`` on the Nth call (1-based).
    p : float
        Fire probability per eligible call (deterministic RNG).
    after : int
        Skip the first ``after`` calls.
    times : int, optional
        Stop firing after this many fires (latency/raise budgets).
    seed : int
        Seed for the probability RNG.
    """

    def __init__(self, name: str, *, delay: Optional[float] = None,
                 fail=None, kill_after: Optional[int] = None,
                 p: float = 1.0, after: int = 0,
                 times: Optional[int] = None, seed: int = 0):
        given = sum(x is not None for x in (delay, fail, kill_after))
        if given != 1:
            raise ValueError(
                "chaos.scope needs exactly one of delay= / fail= / "
                "kill_after=")
        self._name = name
        if delay is not None:
            self._rule = _Rule("delay", float(delay), p, after, times, seed)
        elif kill_after is not None:
            self._rule = _Rule("kill", None, p, int(kill_after) - 1, times,
                               seed)
        else:
            self._rule = _Rule("raise", fail, p, after, times, seed)

    @property
    def rule(self) -> _Rule:
        return self._rule

    def __enter__(self) -> "scope":
        _add_rule(self._name, self._rule)
        return self

    def __exit__(self, *exc) -> bool:
        _remove_rule(self._name, self._rule)
        return False


def _parse_rule(site_name: str, spec: str, seed: int) -> _Rule:
    parts = spec.split(":")
    action = parts[0]
    if action == "raise":
        kind = parts[1] if len(parts) > 1 and parts[1] else "transient"
        if kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(expected {'/'.join(_FAULT_KINDS)})")
        p = float(parts[2]) if len(parts) > 2 else 1.0
        return _Rule("raise", kind, p=p, seed=seed)
    if action == "delay":
        if len(parts) < 2:
            raise ValueError("delay needs seconds, e.g. delay:0.2")
        p = float(parts[2]) if len(parts) > 2 else 1.0
        return _Rule("delay", float(parts[1]), p=p, seed=seed)
    if action == "kill":
        after_n = int(parts[1]) if len(parts) > 1 else 1
        if after_n < 1:
            raise ValueError("kill:<n> needs n >= 1 (1-based call count)")
        return _Rule("kill", None, after=after_n - 1, seed=seed)
    if action == "garble":
        # sugar for raise:garble — same rule shape scope(fail="garble")
        # arms, so env-armed campaigns reach subprocess BlockServers
        p = float(parts[1]) if len(parts) > 1 else 1.0
        return _Rule("raise", "garble", p=p, seed=seed)
    raise ValueError(f"unknown chaos action {action!r} "
                     "(expected raise/delay/kill/garble)")


def refresh_from_env() -> int:
    """(Re)load rules from ``MXNET_TPU_CHAOS``; returns the number of
    rules armed. Called at import; tests call it after monkeypatching the
    env. A malformed rule warns (naming the fragment) and is skipped — a
    typo'd campaign must not silently run fault-free, and must not take
    the process down either."""
    import warnings

    spec = os.environ.get("MXNET_TPU_CHAOS", "")
    seed = 0
    raw_seed = os.environ.get("MXNET_TPU_CHAOS_SEED")
    if raw_seed:
        try:
            seed = int(raw_seed)
        except ValueError:
            warnings.warn(
                f"MXNET_TPU_CHAOS_SEED={raw_seed!r} is not an int; "
                "using seed 0", RuntimeWarning, stacklevel=2)
    clear()
    if not spec:
        return 0
    n = 0
    for frag in spec.replace(",", ";").split(";"):
        frag = frag.strip()
        if not frag:
            continue
        try:
            site_name, rule_spec = frag.split("=", 1)
            site_name = site_name.strip()
            rule = _parse_rule(site_name, rule_spec.strip(), seed)
        except Exception as e:  # noqa: BLE001 — malformed fragment
            warnings.warn(
                f"MXNET_TPU_CHAOS: skipping malformed rule {frag!r} ({e})",
                RuntimeWarning, stacklevel=2)
            continue
        if site_name not in SITES and site_name not in _warned_sites:
            _warned_sites.add(site_name)
            warnings.warn(
                f"MXNET_TPU_CHAOS: site {site_name!r} is not one of the "
                f"instrumented sites {SITES} — armed anyway (custom sites "
                "are allowed), but check for typos", RuntimeWarning,
                stacklevel=2)
        _add_rule(site_name, rule)
        n += 1
    return n


refresh_from_env()
