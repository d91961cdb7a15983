"""Deterministic, seeded fault injection for chaos testing.

The port's copy of ``repro/robust/inject.py``, cut to the one point the
port wires: the serve wave step (``serve.step``).  A wired site costs one
module-level list check when no fault is armed — the hot path stays free.

Chaos tests arm the point with :func:`inject`::

    with inject("serve.step", mode="raise", seed=7):
        serve_loop(requests, run_wave, batch=4)   # every wave fails

Two modes:

* ``raise`` — the site raises :class:`InjectedFault`;
* ``delay`` — the site sleeps ``delay_s`` (straggler / slow-step
  simulation for timeout and load-shedding paths).

Firing is decided by a ``random.Random(seed)`` stream per armed rule, so a
chaos run replays *exactly*: ``rate=1.0, times=1`` means "fail the first
arrival, then behave"; ``rate<1`` with a fixed seed yields the same firing
sequence every run.  Every firing bumps the ``robust.inject.<point>``
counter and records a trace event when tracing is on.
"""

from __future__ import annotations

import random
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..obs.trace import get_tracer

__all__ = ["InjectedFault", "FaultRule", "POINTS", "inject", "maybe_inject", "clear_faults"]


class InjectedFault(RuntimeError):
    """The exception raised by an armed ``raise``-mode injection point."""


#: the wired points and their modes: ``serve.step`` is launch/serve.py's
#: serve_loop, before each wave (slow-step / load-shedding simulation)
POINTS: Dict[str, Tuple[str, ...]] = {"serve.step": ("raise", "delay")}


# ---------------------------------------------------------------------------
# armed rules
# ---------------------------------------------------------------------------


@dataclass
class FaultRule:
    """One armed fault: where, how, and (seeded) when it fires."""

    point: str
    mode: str = "raise"
    rate: float = 1.0
    times: Optional[int] = 1          # max firings; None → unlimited
    delay_s: float = 0.05
    seed: int = 0
    fired: int = 0
    _rng: random.Random = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    def should_fire(self) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        # consume the stream even when the draw loses, so firing sequences
        # replay exactly for a given (seed, arrival order)
        return self._rng.random() < self.rate


#: armed rules — empty list means every wired site is one truthiness check
_ACTIVE: List[FaultRule] = []


def clear_faults() -> None:
    _ACTIVE.clear()


@contextmanager
def inject(point: str, mode: str = "raise", *, rate: float = 1.0,
           times: Optional[int] = 1, delay_s: float = 0.05,
           seed: int = 0) -> Iterator[FaultRule]:
    """Arm one fault rule for the scope of the ``with`` block."""
    modes = POINTS.get(point)
    if modes is None:
        raise KeyError(f"unknown injection point {point!r}; wired: {sorted(POINTS)}")
    if mode not in modes:
        raise ValueError(f"injection point {point!r} supports modes {modes}, not {mode!r}")
    rule = FaultRule(point=point, mode=mode, rate=rate, times=times,
                     delay_s=delay_s, seed=seed)
    _ACTIVE.append(rule)
    try:
        yield rule
    finally:
        try:
            _ACTIVE.remove(rule)
        except ValueError:  # pragma: no cover - cleared mid-scope
            pass


def maybe_inject(point: str, payload: Any = None, **attrs: Any) -> Any:
    """The wired-site entry: fire any armed rule for ``point``; returns
    ``payload``."""
    if not _ACTIVE:  # the hot path: one list truthiness check
        return payload
    for rule in list(_ACTIVE):
        if rule.point != point or not rule.should_fire():
            continue
        rule.fired += 1
        tracer = get_tracer()
        tracer.counter(f"robust.inject.{point}")
        tracer.event(f"robust.inject.{point}", mode=rule.mode,
                     seed=rule.seed, fired=rule.fired, **attrs)
        if rule.mode == "delay":
            time.sleep(rule.delay_s)
            continue
        raise InjectedFault(
            f"injected fault at {point} (mode={rule.mode}, seed={rule.seed}, "
            f"firing {rule.fired})")
    return payload
