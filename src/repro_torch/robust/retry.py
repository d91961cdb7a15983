"""Retry, backoff and deadline primitives (the port's copy of the part of
``repro/robust/retry.py`` that ``launch/serve.py`` uses):

* :class:`RetryPolicy` / :func:`call_with_retry` — bounded retries with
  exponential backoff around a flaky effect (a serve wave).  Every retry
  bumps ``robust.retry.<name>``.
* :class:`Deadline` — absolute per-request deadlines on the monotonic
  clock, the primitive behind load shedding in ``launch/serve.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, TypeVar

from ..obs.trace import get_tracer

__all__ = [
    "RetryPolicy", "call_with_retry", "Deadline",
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
