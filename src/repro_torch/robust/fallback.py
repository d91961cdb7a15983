"""The fallback ladder: progressively safer plans, ending at interp.

The port's copy of ``repro/robust/fallback.py``.  The driver walks it for
plan faults only: a missing card, a device mismatch, a kernel that does not
build or does not launch re-raise (``repro_torch.errors.CardError``), and a
plan for the card walks only for an injected fault (``compiler.driver._walks``).

When the cost-chosen candidate fails — verification breaks in a pass,
backend compile raises, or the first traced execution crashes — the driver
does not fail the query.  It walks a ladder of progressively *safer*
strategy bindings (Tupleware's conservative-plan fallback) and, when no
strategy on the requested target survives, re-targets the program at the
reference interpreter (Flare's always-correct unfused tier).

The ladder is derived from :data:`SAFE_VARIANTS`: each rung forces one more
strategy choice to its conservative variant, in order of how adventurous
the adventurous variant is —

    as chosen
      → encode=raw              (no dictionary rank tables; a crashing
                                 encoded plan keeps its direct tier first)
      → groupby=sorted          (no dense-bucket allocation)
      → join=sorted              (no direct-table join scratch)
      → fuse=unfused            (no fused CUDA kernels)
      → grouped-recombine=gather (no mesh exchange collective)
      → target=interp            (reference semantics, off the fast path)

Rungs that would not change the failing plan are skipped, so the ladder
never retries the identical strategy.  Every step emits a structured
:class:`DegradedWarning` plus ``robust.fallback.*`` counters through
``repro_torch.obs`` — degraded service is loud, never silent.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

from ..obs.trace import DegradedWarning, get_tracer, warn_event

__all__ = ["DegradedWarning", "SAFE_VARIANTS", "INTERP_RUNG",
           "fallback_ladder", "degrade"]

#: choice name → conservative variant, in ladder order: each successive
#: rung of the fallback chain forces one more of these
SAFE_VARIANTS: Tuple[Tuple[str, str], ...] = (
    ("encode", "raw"),
    ("groupby", "sorted"),
    ("join", "sorted"),
    ("fuse", "unfused"),
    ("grouped-recombine", "gather"),
)

#: the terminal rung: re-target at the reference interpreter
INTERP_RUNG = "interp"


def fallback_ladder(chosen: Mapping[str, str],
                    choice_names: Optional[Any] = None,
                    ) -> Iterator[Tuple[str, Optional[Dict[str, str]]]]:
    """Yield ``(rung_name, strategy)`` pairs, safest last.

    ``chosen`` is the strategy that just failed; ``choice_names`` restricts
    the ladder to choices the target actually declares (None → all of
    :data:`SAFE_VARIANTS`).  Each yielded strategy forces one more safe
    variant on top of the previous rung; rungs that would re-lower the
    identical strategy are skipped.  The final yield is
    ``(INTERP_RUNG, None)`` — the caller re-targets at interp.
    """
    names = (set(choice_names) if choice_names is not None
             else {k for k, _ in SAFE_VARIANTS})
    previous: Dict[str, str] = dict(chosen)
    for name, safe in SAFE_VARIANTS:
        if name not in names:
            continue
        # a choice absent from the failing strategy was at its default —
        # forcing the safe label would re-lower the identical plan
        if previous.get(name, safe) == safe:
            continue  # already at (or below) this rung — nothing new to try
        forced = dict(previous)
        forced[name] = safe
        previous = forced
        yield f"{name}={safe}", dict(forced)
    yield INTERP_RUNG, None


def degrade(rung: str, *, program: str, target: str, reason: str,
            error: Optional[BaseException] = None, **fields: Any) -> None:
    """Record one step down the ladder: warning + counters + trace event.

    Emits a :class:`DegradedWarning` (so callers can filter degraded
    service), bumps ``robust.fallback.step`` and the per-rung
    ``robust.fallback.<rung>`` counter, and attaches the triggering error.
    """
    tracer = get_tracer()
    tracer.counter("robust.fallback.step")
    tracer.counter(f"robust.fallback.{rung}")
    if error is not None:
        fields = dict(fields, error=f"{type(error).__name__}: {error}")
    warn_event("robust.fallback", category=DegradedWarning, rung=rung,
               program=program, target=target, reason=reason, **fields)
