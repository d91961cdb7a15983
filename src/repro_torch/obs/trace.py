"""Span-based tracing + metrics for the port.

  * :class:`Tracer` — nested wall-time spans with typed attributes, plus
    counters, histograms, and events.  One process-global default
    (:func:`get_tracer`), **disabled by default**: every hot-path entry
    point is a single ``enabled`` check and the disabled ``span()``
    returns one shared no-op object (no allocation, no clock read).
  * :func:`tracing` — context manager installing an enabled tracer (and
    restoring the previous one), the ergonomic way to trace one workload.
  * structured warnings (:func:`warn_event`) — always surfaced as a Python
    :class:`ObsWarning` so nothing is silently dropped, and additionally
    recorded as a trace event when tracing is on.

Spans are pure host-side bookkeeping on the host clock: work enqueued on
the card is inside a span only where the caller synchronises before the
span ends.

This module depends only on the standard library.  It is the port's copy of
``repro/obs/trace.py``.
"""

from __future__ import annotations

import itertools
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Span", "Tracer", "ObsWarning", "DegradedWarning",
    "get_tracer", "set_tracer", "tracing", "warn_event",
]


class ObsWarning(UserWarning):
    """Structured warning raised through the observability layer."""


class DegradedWarning(ObsWarning):
    """The plan that ran is not the plan that was chosen.

    Raised by the driver's fallback chain (``repro_torch.robust.fallback``)
    when a cost-chosen candidate failed and a safer variant — or the interp
    tier — answered the query instead.  Catch it (or filter it) to detect
    degraded service; the paired ``robust.fallback.*`` counters carry the
    same signal into metrics."""


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


_ids = itertools.count(1)


class Span:
    """One timed interval with typed attributes; records itself on exit."""

    __slots__ = ("tracer", "name", "cat", "args", "span_id", "parent_id",
                 "tid", "t0", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]) -> None:
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.span_id = next(_ids)
        self.parent_id: Optional[int] = None
        self.tid = threading.get_ident()
        self.t0 = 0.0
        self.dur_s = 0.0

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes mid-span (e.g. results known only at the end)."""
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.dur_s = time.perf_counter() - self.t0
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer._record(self)
        return False


class _NullSpan:
    """Shared no-op span: the disabled-mode zero-allocation fast path."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


NULL_SPAN = _NullSpan()

#: cap on retained samples per histogram — count/sum keep accumulating
_MAX_HIST_SAMPLES = 65_536


class Tracer:
    """Collects spans, counters, histograms, and events for one workload."""

    def __init__(self, enabled: bool = True, max_events: int = 100_000) -> None:
        self.enabled = enabled
        self.max_events = max_events
        self.epoch = time.perf_counter()      # span timestamps are relative
        self.epoch_wall = time.time()
        self.spans: List[Span] = []
        self.events: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = {}
        self.histograms: Dict[str, List[float]] = {}
        self.dropped = 0
        self._hist_totals: Dict[str, Tuple[int, float]] = {}
        self._local = threading.local()
        self._lock = threading.Lock()

    # -- span lifecycle ------------------------------------------------------
    def span(self, name: str, cat: str = "", **attrs: Any):
        """``with tracer.span("lower", cat="compile.pass", target="spmd"):``"""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, attrs)

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) >= self.max_events:
                self.dropped += 1
                return
            self.spans.append(span)

    def record_complete(self, name: str, cat: str, t0: float, dur_s: float,
                        **attrs: Any) -> None:
        """Record an already-measured interval (e.g. a per-op span whose
        duration was derived outside the tracer, or a zero-duration
        cardinality annotation from a jitted body)."""
        if not self.enabled:
            return
        span = Span(self, name, cat, attrs)
        stack = self._stack()
        span.parent_id = stack[-1].span_id if stack else None
        span.t0 = t0
        span.dur_s = dur_s
        self._record(span)

    # -- metrics -------------------------------------------------------------
    def counter(self, name: str, value: float = 1.0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def observe(self, name: str, value: float) -> None:
        """Add one sample to a histogram (per-request latencies etc.)."""
        if not self.enabled:
            return
        with self._lock:
            n, total = self._hist_totals.get(name, (0, 0.0))
            self._hist_totals[name] = (n + 1, total + value)
            samples = self.histograms.setdefault(name, [])
            if len(samples) < _MAX_HIST_SAMPLES:
                samples.append(value)

    def event(self, name: str, **attrs: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append({"name": name,
                                "ts": time.perf_counter() - self.epoch,
                                **attrs})

    # -- summaries -----------------------------------------------------------
    def histogram_summary(self, name: str) -> Optional[Dict[str, float]]:
        samples = self.histograms.get(name)
        if not samples:
            return None
        n, total = self._hist_totals[name]
        s = sorted(samples)

        def pct(q: float) -> float:
            return s[min(len(s) - 1, int(q * len(s)))]

        return {"count": float(n), "sum": total, "mean": total / n,
                "min": s[0], "max": s[-1],
                "p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99)}

    def metrics(self) -> Dict[str, Any]:
        """Structured metrics dict: counters + histogram summaries + drops."""
        out: Dict[str, Any] = {"counters": dict(self.counters)}
        hists = {name: self.histogram_summary(name) for name in self.histograms}
        if hists:
            out["histograms"] = hists
        if self.dropped:
            out["dropped"] = self.dropped
        return out

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.events.clear()
            self.counters.clear()
            self.histograms.clear()
            self._hist_totals.clear()
            self.dropped = 0


# ---------------------------------------------------------------------------
# the process-global default
# ---------------------------------------------------------------------------

#: tracing is OFF by default; the disabled tracer's hot path is one
#: attribute check per instrumented site
_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    global _TRACER
    previous = _TRACER
    _TRACER = tracer
    return previous


class _TracingContext:
    """Context manager + handle returned by :func:`tracing`."""

    def __init__(self, tracer: Tracer) -> None:
        self.tracer = tracer
        self._previous: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        self._previous = set_tracer(self.tracer)
        return self.tracer

    def __exit__(self, *exc: Any) -> bool:
        if self._previous is not None:
            set_tracer(self._previous)
        return False


def tracing(enabled: bool = True, max_events: int = 100_000) -> _TracingContext:
    """``with tracing() as tracer: ...`` — installs (and restores) the
    process-global tracer around one traced workload."""
    return _TracingContext(Tracer(enabled=enabled, max_events=max_events))


# ---------------------------------------------------------------------------
# structured warnings
# ---------------------------------------------------------------------------


def warn_event(code: str, category: type = ObsWarning, **fields: Any) -> None:
    """Emit a structured warning through the obs layer.

    Always raises a Python warning of ``category`` (an :class:`ObsWarning`
    subclass — so the condition is visible even with tracing off; nothing is
    silently swallowed); when tracing is on, the same record lands in the
    trace as an event and bumps the ``warnings.<code>`` counter.
    """
    tracer = get_tracer()
    tracer.event(code, **fields)
    tracer.counter(f"warnings.{code}")
    detail = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
    warnings.warn(f"{code}: {detail}" if detail else code, category,
                  stacklevel=2)
