"""Deterministic, seeded fault injection for chaos testing.

The port's copy of ``repro/robust/inject.py``.  A small registry of *named
injection points* is wired into the port where its failures surface: the
driver's pass loop, PlanStore I/O, backend compile, (first) execution,
the serve wave step, the stream consumer's batch, snapshot and restore,
and each rank's program evaluation in the spmd backend.
Each wired site costs one module-level list check when no fault is armed —
the hot path stays free.

Chaos tests arm points with :func:`inject`::

    with inject("backend.compile", mode="raise", seed=7):
        compile(program)                   # backend compile raises

Three modes:

* ``raise``   — the site raises :class:`InjectedFault`;
* ``corrupt`` — the site's payload is deterministically mangled (the pass
  loop truncates the rewritten program so verification fails; the plan
  store scribbles the record text so the JSON parse fails) — sites without
  a corruptor treat ``corrupt`` as ``raise``;
* ``delay``   — the site sleeps ``delay_s`` (straggler / slow-step
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
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..obs.trace import get_tracer

__all__ = [
    "InjectedFault", "InjectionPoint", "FaultRule",
    "register_point", "registered_points",
    "inject", "maybe_inject", "clear_faults",
]


class InjectedFault(RuntimeError):
    """The exception raised by an armed ``raise``-mode injection point."""


@dataclass(frozen=True)
class InjectionPoint:
    """One named place in the stack where faults can be injected."""

    name: str
    modes: Tuple[str, ...]
    description: str = ""


_POINTS: Dict[str, InjectionPoint] = {}


def register_point(name: str, modes: Tuple[str, ...] = ("raise", "delay"),
                   description: str = "") -> InjectionPoint:
    point = InjectionPoint(name, tuple(modes), description)
    _POINTS[name] = point
    return point


def registered_points() -> Dict[str, InjectionPoint]:
    """The injection-point catalog: the points the port wires."""
    return dict(sorted(_POINTS.items()))


# ---------------------------------------------------------------------------
# the canonical catalog — registered here, wired at the named sites
# ---------------------------------------------------------------------------

register_point(
    "driver.pass", ("raise", "corrupt", "delay"),
    "compiler/driver.py run_passes: after each rewrite pass; corrupt "
    "truncates the rewritten program so verification fails")
register_point(
    "store.load", ("raise", "corrupt", "delay"),
    "compiler/store.py PlanStore.load_plan: record read; corrupt mangles "
    "the JSON text (exercises quarantine)")
register_point(
    "store.save", ("raise", "delay"),
    "compiler/store.py PlanStore.save_plan: atomic record write")
register_point(
    "backend.compile", ("raise", "delay"),
    "compiler/driver.py: the target backend's compile() of the lowered "
    "program")
register_point(
    "backend.execute", ("raise", "delay"),
    "compiler/driver.py CompileResult.__call__: executable dispatch (the "
    "local, stream, spmd and interp backends route through it)")
register_point(
    "spmd.shard", ("raise", "delay"),
    "backends/spmd.py evaluate_spmd_program: each rank's evaluation of the "
    "plan and of each MeshExecute body (fires at the first call's start, "
    "before any collective)")
register_point(
    "serve.step", ("raise", "delay"),
    "launch/serve.py serve_loop: before each decode wave (slow-step / "
    "load-shedding simulation)")
register_point(
    "stream.batch", ("raise", "delay"),
    "launch/serve.py StreamConsumer.process: before a micro-batch is folded "
    "into the incremental state (kills the consumer mid-batch)")
register_point(
    "stream.snapshot", ("raise", "delay"),
    "launch/serve.py StreamConsumer.snapshot: before the CheckpointManager "
    "save (kills the consumer mid-snapshot; the atomic rename means the "
    "previous snapshot survives)")
register_point(
    "stream.restore", ("raise", "delay"),
    "launch/serve.py StreamConsumer.restore: before the checkpoint load "
    "(a recovery that itself fails)")


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
    reg = _POINTS.get(point)
    if reg is None:
        raise KeyError(f"unknown injection point {point!r}; registered: "
                       f"{sorted(_POINTS)}")
    if mode not in reg.modes:
        raise ValueError(f"injection point {point!r} supports modes "
                         f"{reg.modes}, not {mode!r}")
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


def maybe_inject(point: str, payload: Any = None,
                 corrupt: Optional[Callable[[Any, FaultRule], Any]] = None,
                 **attrs: Any) -> Any:
    """The wired-site entry: fire any armed rule for ``point``.

    Returns ``payload`` (possibly corrupted).  ``corrupt`` is the site's
    deterministic payload mangler; a ``corrupt``-mode rule at a site
    without one degenerates to ``raise`` so no armed fault is ever a
    silent no-op.
    """
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
        if rule.mode == "corrupt" and corrupt is not None:
            payload = corrupt(payload, rule)
            continue
        raise InjectedFault(
            f"injected fault at {point} (mode={rule.mode}, seed={rule.seed}, "
            f"firing {rule.fired})")
    return payload
