"""Retry, backoff, straggler and deadline primitives (the port's copy of
the part of ``repro/robust/retry.py`` that ``launch/serve.py`` and
``distributed/fault.py`` use):

* :class:`RetryPolicy` / :func:`call_with_retry` — bounded retries with
  exponential backoff around a flaky effect (a serve wave).  Every retry
  bumps ``robust.retry.<name>``.
* :class:`Ewma` / :class:`StragglerDetector` — flags steps slower than
  ``factor``× the running average (``robust.straggler``).
* :class:`Deadline` — absolute per-request deadlines on the monotonic
  clock, the primitive behind load shedding in ``launch/serve.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, TypeVar

from ..obs.trace import get_tracer

__all__ = [
    "RetryPolicy", "call_with_retry", "Ewma", "StragglerDetector", "Deadline",
]

T = TypeVar("T")


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff."""

    max_retries: int = 3
    backoff_s: float = 0.02
    backoff_factor: float = 2.0
    max_backoff_s: float = 1.0
    #: exception types worth retrying; anything else propagates immediately
    retry_on: Tuple[type, ...] = (Exception,)

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_s * self.backoff_factor ** attempt,
                   self.max_backoff_s)


def call_with_retry(fn: Callable[[], T], policy: Optional[RetryPolicy] = None,
                    *, name: str = "call",
                    on_failure: Optional[Callable[[int, Exception], None]] = None,
                    sleep: Callable[[float], None] = time.sleep) -> T:
    """Call ``fn`` under ``policy``; re-raise the last error when exhausted."""
    policy = policy or RetryPolicy()
    attempts = policy.max_retries + 1
    for attempt in range(attempts):
        try:
            return fn()
        except policy.retry_on as e:
            tracer = get_tracer()
            tracer.counter(f"robust.retry.{name}")
            tracer.event(f"robust.retry.{name}", attempt=attempt,
                         error=f"{type(e).__name__}: {e}")
            if on_failure is not None:
                on_failure(attempt, e)
            if attempt + 1 >= attempts:
                raise
            sleep(policy.backoff(attempt))
    raise AssertionError("unreachable")  # pragma: no cover


# ---------------------------------------------------------------------------
# EWMA / stragglers
# ---------------------------------------------------------------------------


@dataclass
class Ewma:
    """Exponential moving average (first observation seeds the value)."""

    alpha: float = 0.2
    value: Optional[float] = None
    n: int = 0

    def update(self, x: float) -> float:
        self.value = (x if self.value is None
                      else (1 - self.alpha) * self.value + self.alpha * x)
        self.n += 1
        return self.value


@dataclass
class StragglerDetector:
    """Flags observations slower than ``factor``× the running EWMA.

    The detector *observes first, updates second*: a straggler is judged
    against the history that preceded it, and still folds into the
    average (one slow step raises the bar rather than being forgotten).
    """

    factor: float = 3.0
    alpha: float = 0.2
    ewma: Ewma = field(default_factory=Ewma)
    stragglers: int = 0

    def __post_init__(self) -> None:
        self.ewma.alpha = self.alpha

    def observe(self, seconds: float) -> bool:
        straggler = (self.ewma.value is not None
                     and seconds > self.factor * self.ewma.value)
        if straggler:
            self.stragglers += 1
            get_tracer().counter("robust.straggler")
        self.ewma.update(seconds)
        return straggler


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Deadline:
    """An absolute point on the monotonic clock a request must beat."""

    at: float

    @staticmethod
    def after(seconds: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return Deadline(clock() + seconds)

    def remaining(self, clock: Callable[[], float] = time.monotonic) -> float:
        return self.at - clock()

    def expired(self, clock: Callable[[], float] = time.monotonic) -> bool:
        return clock() >= self.at
