"""The compile driver of the torch port: one entry point for its targets.

The port's copy of ``repro/compiler/driver.py`` for the ``local``,
``stream``, ``spmd``, ``multipod`` and ``interp`` targets.
``compile(program, catalog)`` looks up the registered
:class:`~repro_torch.compiler.targets.Target`, consults the plan cache
(keyed by the target, the device as named, the alpha-invariant program
fingerprint and the options), runs the target's lowering path with
per-pass instrumentation (wall time + IR-size delta) — or, under
``optimize="cost"``, lowers every candidate strategy and keeps the
cheapest under the cost model — admits the plan under a byte budget,
hands it to the backend, and caches the resulting :class:`CompileResult`.

Under ``guard`` (the default) a plan that fails to lower, to compile or at
its first execution walks the fallback ladder (``robust/fallback.py``):
safer strategies, then the numpy interpreter.  Faults of the card or of a
kernel (``repro_torch.errors``) re-raise instead: a safer plan cannot
repair them, and answering on the host would hide them.  A plan for the
card walks only for an injected fault or a strategy quarantined after one
(:func:`_walks`): any other failure there comes from the card's path, and
the plain version or the host must not answer for it.
"""

from __future__ import annotations

import itertools
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..core.program import Program
from ..core.verify import verify
from ..errors import is_card_fault
from ..obs.trace import get_tracer
from ..robust.admission import AdmissionError, admit, default_budget
from ..robust.fallback import degrade, fallback_ladder
from ..robust.inject import InjectedFault, maybe_inject
from .cost import CALIBRATION, Candidate, PlanDecision, estimate_cost
from .fingerprint import fingerprint, fingerprint_value
from .stats import Statistics
from .targets import (Choice, CompileOptions, DEFAULT_STRATEGY, StrategyStage,
                      get_target)

__all__ = [
    "compile", "run_passes", "program_size", "normalize_strategy",
    "CompileResult", "PassRecord", "PlanCache", "PLAN_CACHE",
    "enable_auto_replan", "disable_auto_replan",
]


def normalize_strategy(strategy: Any = None) -> Dict[str, str]:
    """The full choice → label binding of the ``local`` target: ``strategy``
    (a dict or pairs) over :data:`DEFAULT_STRATEGY`."""
    chosen = dict(DEFAULT_STRATEGY)
    chosen.update(_normalize_strategy(strategy, get_target("local")) or ())
    return chosen


# ---------------------------------------------------------------------------
# instrumentation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PassRecord:
    """One pass execution: where it ran, how long, and what it did to the IR."""

    stage: str
    name: str
    wall_s: float
    size_before: int
    size_after: int

    @property
    def delta(self) -> int:
        return self.size_after - self.size_before


def program_size(program: Program) -> int:
    """Total instruction count, including nested programs."""
    return sum(len(p.body) for p in program.walk())


def run_passes(program: Program, passes: Sequence[Any], stage: str = "pipeline",
               records: Optional[List[PassRecord]] = None,
               check: bool = True) -> Program:
    """Apply passes in order, timing each and verifying between them."""
    tracer = get_tracer()
    for p in passes:
        before = program_size(program)
        t0 = time.perf_counter()
        with tracer.span(p.name, cat="compile.pass", stage=stage) as sp:
            out = p.apply(program)
        wall = time.perf_counter() - t0
        out = maybe_inject("driver.pass", out, corrupt=_truncate_program,
                           pass_name=p.name, stage=stage)
        after = program_size(out)
        sp.set(size_before=before, size_after=after)
        if check:
            try:
                verify(out, allow_unknown_ops=True)
            except Exception as e:
                raise AssertionError(
                    f"pass {p.name!r} broke the program:\n{out.render()}"
                ) from e
        if records is not None:
            records.append(PassRecord(stage, p.name, wall, before, after))
        program = out
    return program


def _truncate_program(program: Program, rule: Any) -> Program:
    """``driver.pass`` corruptor: drop the last instruction so verification
    fails the way a buggy rewrite does (a result register goes undefined)."""
    if not program.body:
        raise InjectedFault("injected driver.pass corruption on empty program")
    return replace(program, body=program.body[:-1])


# ---------------------------------------------------------------------------
# compile results
# ---------------------------------------------------------------------------


@dataclass
class CompileResult:
    """A compiled plan: ``result(sources, *args) -> [results]``, with its
    compilation provenance."""

    target: str
    source: Program            # frontend program as handed to the driver
    program: Program           # final lowered program the backend consumed
    executable: Any            # backend-compiled callable
    records: Tuple[PassRecord, ...]
    fingerprint: str
    backend_s: float = 0.0
    cache_hit: bool = False
    #: (choice-name, variant) pairs the lowering actually used
    strategy: Tuple[Tuple[str, str], ...] = ()
    #: costed-search provenance (None for fixed-path compiles)
    decision: Optional[PlanDecision] = None
    #: the catalog statistics the plan was costed under
    stats: Optional[Statistics] = None
    #: where this result came from: "miss" (freshly compiled),
    #: "memory" (plan-cache hit), "store" (plan-store strategy replay)
    cache_source: str = "miss"
    #: latest traced execution's estimate-vs-actual profile
    #: (:class:`~repro_torch.obs.feedback.RuntimeProfile`; None until a traced run)
    profile: Optional[Any] = None
    #: fallback-ladder rungs this plan stepped down (compile- or exec-time);
    #: empty means the chosen plan is the plan that runs
    degraded: Tuple[str, ...] = ()
    #: resource-admission estimate (only computed when a byte budget is set)
    resources: Optional[Any] = None
    #: one-shot execution guard armed by the driver: catches the *first*
    #: execution's failure and walks the fallback ladder; disarmed after the
    #: first successful call
    _guard: Optional[Any] = None
    #: adaptive re-plan closure armed by the driver (see
    #: :func:`enable_auto_replan`)
    _replan: Optional[Any] = None

    def __call__(self, sources: Any = None, *args: Any) -> Any:
        guard = self._guard
        if guard is None:
            return self._dispatch(sources, *args)
        try:
            out = self._dispatch(sources, *args)
        except Exception as e:
            out = guard(self, e, sources, args)
        self._guard = None
        return out

    def _dispatch(self, sources: Any = None, *args: Any) -> Any:
        maybe_inject("backend.execute", target=self.target,
                     program=self.source.name)
        tracer = get_tracer()
        runner = getattr(self.executable, "run_traced", None)
        if not tracer.enabled or runner is None:
            # the hot path: plain dispatch, no span, no profile bookkeeping
            return self.executable(sources, *args)

        from ..obs import feedback as fb

        t0 = time.perf_counter()
        with tracer.span(f"execute:{self.source.name}", cat="execute",
                         target=self.target,
                         fingerprint=self.fingerprint[:12]) as sp:
            outs, cards, walls = runner(sources, *args)
        wall = time.perf_counter() - t0
        profile = fb.build_profile(self, cards, wall, wall_by_key=walls)
        sp.set(rows_measured=len(profile.observations))
        if not getattr(self.executable, "emits_op_spans", False):
            # the local backend does not time single operators (that would
            # sync the card after each); record zero-duration cardinality
            # annotations instead
            for o in profile.observations:
                tracer.record_complete(
                    o.opcode, cat="execute.op", t0=t0, dur_s=0.0,
                    register=o.register, rows_out=o.rows_out,
                    rows_in=o.rows_in, est_rows=o.est_rows,
                    rel_miss=o.rel_miss, table=o.table)
        self.profile = profile
        fb.FEEDBACK.record(profile)
        thresh = _AUTO_REPLAN[0]
        if (thresh is not None and self._replan is not None
                and any(f == self.fingerprint for f, _ in
                        fb.FEEDBACK.plans_over_threshold(thresh))):
            replan, self._replan = self._replan, None
            replan(self, profile)
        return outs

    @property
    def total_s(self) -> float:
        return self.backend_s + sum(r.wall_s for r in self.records)

    def explain(self) -> str:
        """Per-pass wall time, IR-size deltas, the plan decision, and —
        after a traced execution — the estimated-vs-actual cardinalities."""
        head = (f"compile[{self.target}] {self.source.name}: "
                + ("cache hit" if self.cache_hit
                   else f"{self.total_s * 1e3:.2f} ms")
                + f" (fingerprint {self.fingerprint[:12]})"
                + f" cache={'hit' if self.cache_hit else 'miss'}"
                + f" source={self.cache_source}")
        if self.strategy:
            head += (" strategy "
                     + ", ".join(f"{k}={v}" for k, v in self.strategy))
        if self.degraded:
            head += " DEGRADED via " + " → ".join(self.degraded)
        lines = [head,
                 "| stage | pass | wall ms | IR size | Δ |",
                 "|---|---|---:|---:|---:|"]
        for r in self.records:
            lines.append(f"| {r.stage} | {r.name} | {r.wall_s * 1e3:.3f} "
                         f"| {r.size_after} | {r.delta:+d} |")
        lines.append(f"| backend | {self.target} | {self.backend_s * 1e3:.3f} "
                     f"| {program_size(self.program)} | +0 |")
        if self.decision is not None:
            lines.append(self.decision.render())
        if self.profile is not None:
            lines.append(self.profile.render())
        return "\n".join(lines)

    def explain_records(self) -> List[Dict[str, Any]]:
        """The same data as :meth:`explain`, as JSON-ready records."""
        size = program_size(self.program)
        recs = [
            {"stage": r.stage, "pass": r.name, "wall_s": r.wall_s,
             "size_before": r.size_before, "size_after": r.size_after}
            for r in self.records
        ]
        recs.append({"stage": "backend", "pass": self.target,
                     "wall_s": self.backend_s,
                     "size_before": size, "size_after": size})
        return recs

    def metrics(self) -> Dict[str, Any]:
        """Structured metrics: compile provenance, runtime profile, and the
        active tracer's counters/histograms, in one JSON-ready dict."""
        out: Dict[str, Any] = {
            "target": self.target,
            "program": self.source.name,
            "fingerprint": self.fingerprint,
            "cache": "hit" if self.cache_hit else "miss",
            "cache_source": self.cache_source,
            "strategy": dict(self.strategy),
            "degraded": list(self.degraded),
            "compile": {"total_s": self.total_s,
                        "backend_s": self.backend_s,
                        "passes": self.explain_records()},
        }
        if self.resources is not None:
            out["resources"] = {"peak_bytes": self.resources.peak_bytes,
                                "peak_site": self.resources.peak_site}
        if self.decision is not None:
            out["decision"] = self.decision.records()
        if self.profile is not None:
            out["runtime"] = {
                "wall_s": self.profile.wall_s,
                "est_cost": self.profile.est_cost,
                "worst_miss": self.profile.worst_miss,
                "operators": self.profile.records(),
            }
        out["tracer"] = get_tracer().metrics()
        return out


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------


class PlanCache:
    """LRU cache of CompileResults keyed by (target, device, fingerprint,
    options)."""

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = capacity
        self._entries: "OrderedDict[Tuple, CompileResult]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, key: Tuple) -> Optional[CompileResult]:
        got = self._entries.get(key)
        if got is None:
            self.misses += 1
            get_tracer().counter("plan_cache.miss")
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        get_tracer().counter("plan_cache.hit")
        return got

    def store(self, key: Tuple, result: CompileResult) -> None:
        self._entries[key] = result
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
            get_tracer().counter("plan_cache.evict")

    def drop(self, key: Tuple) -> None:
        """Invalidate one entry (a cached plan whose execution crashed must
        not be served again — see the fallback chain)."""
        self._entries.pop(key, None)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self._entries)}


#: process-wide default cache: a repeated ``collect`` of the same frame
#: skips the lowering passes
PLAN_CACHE = PlanCache()


# ---------------------------------------------------------------------------
# adaptive re-planning
# ---------------------------------------------------------------------------


#: the armed auto-replan threshold (relative worst cardinality miss);
#: ``None`` → off.  A one-element list so closures see updates.
_AUTO_REPLAN: List[Optional[float]] = [None]


def enable_auto_replan(threshold: float = 1.0) -> None:
    """Arm adaptive re-planning for traced executions.

    After each traced run the driver asks the feedback catalog whether the
    plan's worst cardinality miss exceeds ``threshold``
    (``FEEDBACK.plans_over_threshold``); if so, it recompiles the program
    under ``Statistics.with_observed_rows`` (the measured base-table
    cardinalities) with the costed search and swaps the cached plan.
    """
    _AUTO_REPLAN[0] = float(threshold)


def disable_auto_replan() -> None:
    _AUTO_REPLAN[0] = None


def _make_replan(program: Program, tgt: Any, opts: CompileOptions,
                 check: bool, fp: str, plan_cache: Optional[PlanCache],
                 key: Tuple):
    """The re-plan closure armed on CompileResults (see
    :func:`enable_auto_replan`); mirrors the exec guard's splice-and-store
    so the caller's handle and the cache both serve the corrected plan."""

    def replan(result: CompileResult, profile: Any) -> None:
        from ..core.passes.lower_vec import Catalog
        from ..obs import feedback as fb

        tracer = get_tracer()
        observed = fb.FEEDBACK.observed_statistics(opts.stats())
        cat = opts.catalog
        new_cat = (replace(cat, stats=observed) if cat is not None
                   else Catalog(stats=observed))
        opts2 = replace(opts, catalog=new_cat, strategy=None,
                        optimize="cost" if tgt.choices() else opts.optimize)
        try:
            nxt = _build_plan(program, tgt, opts2, check, fp, None,
                              frozenset(), None, None, {})
        except Exception as e:
            from ..obs.trace import warn_event
            tracer.counter("driver.replan.failed")
            warn_event("replan.failed", program=program.name,
                       target=tgt.name, error=f"{type(e).__name__}: {e}")
            return
        tracer.counter("driver.replan")
        tracer.event("driver.replan", program=program.name, target=tgt.name,
                     worst_miss=profile.worst_miss,
                     old_strategy=dict(result.strategy),
                     new_strategy=dict(nxt.strategy))
        result.target = nxt.target
        result.program = nxt.program
        result.executable = nxt.executable
        result.strategy = nxt.strategy
        result.decision = nxt.decision
        result.stats = nxt.stats
        if plan_cache is not None:
            plan_cache.store(key, replace(result, cache_hit=False,
                                          cache_source="miss",
                                          _guard=None, _replan=None))

    return replan


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def _lower_with_strategy(program: Program, tgt: Any, opts: CompileOptions,
                         chosen: Dict[str, str], check: bool,
                         ) -> Tuple[Program, List[PassRecord]]:
    """Run the target's lowering path with each Choice bound to a variant."""
    records: List[PassRecord] = []
    lowered = program
    seen: set = set()
    for stage in tgt.lowering_path:
        if isinstance(stage, Choice):
            stage = stage.variant(chosen.get(stage.name, stage.default))
            if id(stage) in seen:
                continue  # several Choices may share one StrategyStage
            seen.add(id(stage))
        passes = (stage.build(opts, chosen) if isinstance(stage, StrategyStage)
                  else stage.build(opts))
        lowered = run_passes(lowered, passes, stage=stage.name,
                             records=records, check=check)
    return lowered, records


def _choose_strategy(program: Program, tgt: Any, opts: CompileOptions,
                     check: bool, stored: Optional[Dict[str, Any]],
                     poison: Any = frozenset(),
                     ) -> Tuple[Dict[str, str], Program, List[PassRecord],
                                Optional[PlanDecision]]:
    """Cost-based plan selection: enumerate the target's Choice points,
    lower each candidate, cost the final programs, keep the cheapest.

    A plan-store record from a previous process short-circuits the search:
    the recorded winner is re-lowered directly (source="store") — unless
    that strategy is marked poison, in which case the search runs again
    over the surviving candidates.  Candidates over the admission byte
    budget are dropped the same way.
    """
    choices = tgt.choices()
    forced = dict(opts.strategy or ())
    stats = opts.stats()
    budget = (opts.memory_budget if opts.memory_budget is not None
              else default_budget())

    if stored is not None and stored.get("strategy"):
        chosen = {str(k): str(v) for k, v in stored["strategy"]}
        chosen.update(forced)
        if tuple(sorted(chosen.items())) in poison:
            get_tracer().counter("robust.fallback.poison_skip")
        else:
            t0 = time.perf_counter()
            lowered, records = _lower_with_strategy(program, tgt, opts,
                                                    chosen, check)
            lower_s = time.perf_counter() - t0
            cand = Candidate(strategy=tuple(sorted(chosen.items())),
                             est_cost=estimate_cost(lowered, stats),
                             size=program_size(lowered), lower_s=lower_s)
            decision = PlanDecision(
                candidates=(cand,), chosen=0, source="store",
                est_seconds=CALIBRATION.seconds(cand.est_cost))
            return chosen, lowered, records, decision

    axes = []
    for c in choices:
        labels = (forced[c.name],) if c.name in forced else c.labels(opts)
        axes.append([(c.name, label) for label in labels])

    candidates: List[Candidate] = []
    lowerings: List[Tuple[Program, List[PassRecord]]] = []
    over_budget: List[Tuple[Any, Any]] = []
    for combo in itertools.product(*axes) if axes else [()]:
        chosen = dict(combo)
        strat = tuple(sorted(chosen.items()))
        if strat in poison:
            get_tracer().counter("robust.fallback.poison_skip")
            continue
        t0 = time.perf_counter()
        lowered, records = _lower_with_strategy(program, tgt, opts, chosen,
                                                check)
        lower_s = time.perf_counter() - t0
        if budget is not None:
            try:
                admit(lowered, budget, name=program.name)
            except AdmissionError as e:
                over_budget.append((strat, e))
                continue
        candidates.append(Candidate(
            strategy=strat,
            est_cost=estimate_cost(lowered, stats),
            size=program_size(lowered), lower_s=lower_s))
        lowerings.append((lowered, records))

    if not candidates:
        if over_budget:
            raise over_budget[0][1]
        raise RuntimeError(
            f"no admissible candidate plan for {program.name!r} on target "
            f"{tgt.name!r}: every strategy is poisoned "
            f"({sorted(poison)})")

    best = min(range(len(candidates)), key=lambda i: candidates[i].est_cost)
    decision = PlanDecision(
        candidates=tuple(candidates), chosen=best, source="search",
        est_seconds=CALIBRATION.seconds(candidates[best].est_cost))
    lowered, records = lowerings[best]
    return dict(candidates[best].strategy), lowered, records, decision


def compile(program: Program, catalog: Any = None, *,
            target: str = "local",
            use_kernels: bool = True,
            parallel: Optional[int] = None,
            optimize: Optional[str] = None,
            strategy: Any = None,
            device: Any = None,
            cache: Union[None, bool, PlanCache] = None,
            store: Any = None,
            guard: bool = True,
            memory_budget: Optional[int] = None,
            check: bool = True,
            stream_table: Optional[str] = None,
            batch_rows: Optional[int] = None,
            mesh: Any = None,
            axis: str = "workers",
            collectives: bool = True,
            parallelize_targets: Optional[Sequence[str]] = None,
            backend: Any = None) -> CompileResult:
    """Compile a frontend CVM program for a registered target.

    ``target``: ``"local"`` (the torch backend on ``device``, ``cuda``
    unless given, resolved when the plan runs), ``"stream"`` (the local
    path split for micro-batches, on ``device`` too), ``"spmd"`` or
    ``"multipod"`` (the local path lowered to the mesh flavor: call the plan
    on every rank of ``mesh`` with the same sources) or ``"interp"`` (the
    numpy interpreter on the host).  ``parallel=n`` splits the sources into
    ``n`` chunks (the paper's parallelization rewrite).

    ``mesh`` (a ``launch.mesh.Mesh``) is where an spmd plan runs; ``None``
    builds one of ``parallel`` ranks over the initialised default process
    group on ``device`` (none is needed for ``parallel`` None or 1), and a
    shortfall of ranks raises ``ValueError`` here.  ``axis`` names the mesh
    axis; ``collectives=False`` leaves every combine outside the mesh body
    (gathered, then folded as ``local`` folds).

    ``cache``: ``None``/``True`` → the process-wide :data:`PLAN_CACHE`;
    ``False`` → no caching; a :class:`PlanCache` → that cache.

    ``strategy={"groupby": "sorted", ...}`` forces variants of the
    target's Choices over :data:`DEFAULT_STRATEGY`; ``optimize="cost"``
    turns the fixed path into a costed search over the Choices not forced.
    ``store`` (a :class:`~repro_torch.compiler.store.PlanStore` or path)
    persists plan metadata across processes; ``None`` falls back to the
    ``REPRO_PLAN_STORE`` environment default, ``False`` disables.

    ``memory_budget`` (bytes; default ``REPRO_MEM_BUDGET_BYTES``) turns on
    resource admission: plans whose estimated peak working set exceeds the
    budget are degraded or rejected before they run.

    ``guard`` (default on) arms the fallback chain: when the chosen plan
    fails verification, lowering, backend compile, admission, or its first
    execution, the driver retries progressively safer strategies and
    finally the interp target, emitting a ``DegradedWarning``.  Invalid
    inputs and faults of the card or a kernel (``repro_torch.errors``)
    still raise.

    ``stream_table``/``batch_rows`` are for streaming targets
    (``target="stream"``): the named table is delivered as micro-batches
    of ``batch_rows`` rows and the executable folds them incrementally
    (see docs/streaming.md).

    ``parallelize_targets`` names the registers the parallelization
    rewrite splits (every absorbable source when ``None``); ``backend``
    replaces the target's own backend object (the ``pjit`` target's
    model-bound ``PjitBackend``), and such a compile bypasses the plan
    cache.
    """
    tracer = get_tracer()
    kw = dict(target=target, use_kernels=use_kernels, parallel=parallel,
              optimize=optimize, strategy=strategy, device=device, cache=cache,
              store=store, guard=guard, memory_budget=memory_budget, check=check,
              stream_table=stream_table, batch_rows=batch_rows, mesh=mesh, axis=axis,
              collectives=collectives, parallelize_targets=parallelize_targets,
              backend=backend)
    if not tracer.enabled:
        return _compile_impl(program, catalog, **kw)
    with tracer.span(f"compile:{program.name}", cat="compile",
                     target=target) as sp:
        result = _compile_impl(program, catalog, **kw)
        sp.set(cache="hit" if result.cache_hit else "miss",
               source=result.cache_source,
               fingerprint=result.fingerprint[:12])
        if result.degraded:
            sp.set(degraded=list(result.degraded))
    return result


class _PoisonedPlan(RuntimeError):
    """The requested strategy is quarantined: its compiled plan crashed
    before (plan-store poison mark) and must not be replayed from cache."""


def _walks(error: BaseException, opts: CompileOptions) -> bool:
    """Whether the fallback ladder may step down for ``error``.  Never for
    a fault of the card or of a kernel; for a plan on the card only for an
    injected fault or a quarantined strategy, since every other failure
    there is one of the card's path; for a plan on the host, as JAX does."""
    if is_card_fault(error):
        return False
    if opts.device is not None and opts.device.startswith("cuda"):
        return isinstance(error, (InjectedFault, _PoisonedPlan))
    return True


def _compile_impl(program: Program, catalog: Any, *, target: str,
                  use_kernels: bool, parallel: Optional[int],
                  optimize: Optional[str], strategy: Any, device: Any,
                  cache: Union[None, bool, PlanCache], store: Any, guard: bool,
                  memory_budget: Optional[int], check: bool,
                  stream_table: Optional[str],
                  batch_rows: Optional[int], mesh: Any, axis: str,
                  collectives: bool, parallelize_targets: Optional[Sequence[str]],
                  backend: Any) -> CompileResult:
    if optimize not in (None, "cost"):
        raise ValueError(f"unknown optimize mode {optimize!r}; "
                         "expected None or 'cost'")
    tgt = get_target(target)
    strat = _normalize_strategy(strategy, tgt)
    if tgt.streaming:
        if not stream_table:
            raise ValueError(
                f"target {tgt.name!r} is streaming: pass stream_table=... "
                "(the table delivered as micro-batches)")
        batch_rows = int(batch_rows or 256)  # normalized → stable cache key
        if batch_rows <= 0:
            raise ValueError(f"batch_rows must be positive, got {batch_rows}")
    elif stream_table is not None or batch_rows is not None:
        raise ValueError(
            f"stream_table/batch_rows only apply to streaming targets; "
            f"{tgt.name!r} is not one")
    dev = None
    if tgt.source_kind == "vec":
        import torch

        # the device as named, not resolved: a plan compiles where no card is
        dev = str(torch.device("cuda" if device is None else device))
    opts = CompileOptions(parallel=parallel, use_kernels=use_kernels, catalog=catalog,
                          optimize=optimize, strategy=strat, memory_budget=memory_budget,
                          device=dev, stream_table=stream_table, batch_rows=batch_rows,
                          axis=axis, collectives=collectives, mesh=mesh,
                          parallelize_targets=(tuple(sorted(parallelize_targets))
                                               if parallelize_targets else None))
    _check_parallel_divides(program, opts)
    _check_mesh_available(tgt, opts)
    if tgt.needs_mesh and mesh is None:
        # built here, not in the backend, so the plan-cache key holds its
        # ranks, backend and device
        from ..launch.mesh import make_mesh

        opts = replace(opts, mesh=make_mesh((parallel or 1,), (axis,), device=dev))

    # a compile with a caller's backend is never cached, as in the JAX
    # driver (its ``use_cache``): the key does not hold the backend
    if cache is False or backend is not None:
        plan_cache: Optional[PlanCache] = None
    elif cache is None or cache is True:
        plan_cache = PLAN_CACHE
    else:
        plan_cache = cache

    fp = fingerprint(program)
    key = (tgt.name, dev, fp, opts.cache_key())
    if plan_cache is not None:
        hit = plan_cache.lookup(key)
        if hit is not None:
            return replace(hit, cache_hit=True, cache_source="memory")

    plan_store = _resolve_store(store)
    store_key: Optional[str] = None
    stored: Optional[Dict[str, Any]] = None
    if plan_store is not None:
        store_key = fingerprint_value(key)
        _seed_calibration(plan_store)
        stored = plan_store.load_plan(store_key)
    poison = (plan_store.poisoned_strategies(stored)
              if plan_store is not None else set())

    attempt: Dict[str, Any] = {}
    try:
        result = _build_plan(program, tgt, opts, check, fp, stored,
                             poison, plan_store, store_key, attempt, backend)
    except Exception as e:
        if not guard or not _walks(e, opts):
            raise
        result = _fallback_compile(program, tgt, opts, check, fp, e,
                                   attempt, plan_store, store_key, poison, backend)
    if plan_cache is not None:
        plan_cache.store(key, result)
    if guard:
        result._guard = _make_exec_guard(
            program, tgt, opts, check, fp, plan_store, store_key,
            plan_cache, key, backend)
    result._replan = _make_replan(program, tgt, opts, check, fp, plan_cache, key)
    return result


def _build_plan(program: Program, tgt: Any, opts: CompileOptions, check: bool,
                fp: str, stored: Optional[Dict[str, Any]],
                poison: Any, plan_store: Any, store_key: Optional[str],
                attempt: Dict[str, Any], backend: Any = None) -> CompileResult:
    """One compile attempt down a fixed or costed path.

    ``attempt`` is filled with the chosen strategy as soon as it is known,
    so the fallback chain can poison the right plan when this raises.
    """
    decision: Optional[PlanDecision] = None
    budget = (opts.memory_budget if opts.memory_budget is not None
              else default_budget())
    if opts.optimize == "cost" and tgt.choices():
        chosen, lowered, records, decision = _choose_strategy(
            program, tgt, opts, check, stored, poison)
        attempt["strategy"] = tuple(sorted(chosen.items()))
    else:
        chosen = dict(opts.strategy or ())
        for c in tgt.choices():
            chosen.setdefault(c.name, c.default)
        strat_t = tuple(sorted(chosen.items()))
        attempt["strategy"] = strat_t
        if tgt.choices() and strat_t in poison:
            get_tracer().counter("robust.fallback.poison_skip")
            raise _PoisonedPlan(
                f"strategy {dict(strat_t)} for {program.name!r} is "
                f"quarantined (a previous compiled plan crashed)")
        lowered, records = _lower_with_strategy(program, tgt, opts, chosen,
                                                check)

    _check_flavors(lowered, tgt)

    resources = None
    if budget is not None:
        # the costed search already admitted its winner; fixed paths and
        # store replays are admitted here, before the backend allocates
        resources = admit(lowered, budget, name=program.name)

    be = backend if backend is not None else tgt.make_backend(opts)
    maybe_inject("backend.compile", target=tgt.name, program=program.name)
    t0 = time.perf_counter()
    with get_tracer().span(f"backend:{tgt.name}", cat="compile.backend"):
        executable = be.compile(lowered)
    backend_s = time.perf_counter() - t0

    if decision is not None:
        measured = backend_s + sum(r.wall_s for r in records)
        CALIBRATION.update(decision.winner.est_cost, measured)
        decision = replace(decision, measured_s=measured)

    result = CompileResult(
        target=tgt.name,
        source=program,
        program=getattr(executable, "program", lowered),
        executable=executable,
        records=tuple(records),
        fingerprint=fp,
        backend_s=backend_s,
        strategy=tuple(sorted(chosen.items())),
        decision=decision,
        stats=opts.stats(),
        cache_source=("store" if decision is not None
                      and decision.source == "store" else "miss"),
        resources=resources,
    )
    if plan_store is not None and store_key is not None:
        plan_store.save_plan(store_key, {
            "target": tgt.name,
            "fingerprint": fp,
            "strategy": sorted(chosen.items()),
            "optimize": opts.optimize,
            "records": result.explain_records(),
            "decision": decision.records() if decision is not None else None,
            "backend_s": backend_s,
        })
        # only persist calibration this compile actually updated — a plain
        # fixed-path compile must not clobber another process's learned scale
        if decision is not None and CALIBRATION.n:
            plan_store.save_calibration(CALIBRATION)
    return result


# ---------------------------------------------------------------------------
# the fallback chain
# ---------------------------------------------------------------------------


def _mark_poison(plan_store: Any, store_key: Optional[str],
                 strategy: Any, reason: str) -> None:
    if plan_store is None or not store_key or not strategy:
        return
    plan_store.mark_poison(store_key, tuple(strategy), reason=reason)


def _fallback_compile(program: Program, tgt: Any, opts: CompileOptions,
                      check: bool, fp: str,
                      error: BaseException, attempt: Dict[str, Any],
                      plan_store: Any, store_key: Optional[str],
                      poison: Any, backend: Any = None) -> CompileResult:
    """Walk the fallback ladder after a compile-time plan failure."""
    chosen = dict(attempt.get("strategy") or ())
    if not chosen:
        for c in tgt.choices():
            chosen.setdefault(c.name, c.default)
    if not isinstance(error, _PoisonedPlan):
        _mark_poison(plan_store, store_key, sorted(chosen.items()),
                     f"compile: {type(error).__name__}: {error}")
    last: BaseException = error
    walked: List[str] = []
    names = [c.name for c in tgt.choices()]
    for rung, forced in fallback_ladder(chosen, names):
        walked.append(rung)
        degrade(rung, program=program.name, target=tgt.name,
                reason="compile", error=last)
        try:
            if forced is None:
                result = _interp_fallback(program, fp, check)
            else:
                opts2 = replace(opts, strategy=tuple(sorted(forced.items())),
                                optimize=None)
                result = _build_plan(program, tgt, opts2, check, fp,
                                     None, poison, plan_store, store_key, {}, backend)
        except Exception as e:
            if not _walks(e, opts):
                raise
            last = e
            if forced is not None and not isinstance(e, _PoisonedPlan):
                _mark_poison(plan_store, store_key, sorted(forced.items()),
                             f"compile {rung}: {type(e).__name__}: {e}")
            continue
        result.degraded = tuple(walked)
        get_tracer().counter("robust.fallback.recovered")
        return result
    raise last


def _make_exec_guard(program: Program, tgt: Any, opts: CompileOptions,
                     check: bool, fp: str, plan_store: Any,
                     store_key: Optional[str],
                     plan_cache: Optional[PlanCache], key: Tuple, backend: Any = None):
    """The one-shot first-execution guard armed on guarded CompileResults.

    A plan that compiled fine can still die at its first call (a generated
    kernel's query shape, an operator's data-dependent path).  The guard
    poisons the crashed plan, invalidates its cache entry, walks the same
    ladder as the compile-time chain, *executes* each rung's plan on the
    caller's sources, and splices the surviving plan into the caller's
    CompileResult handle.  A failure the ladder does not walk for
    (:func:`_walks`) re-raises.
    """

    def exec_guard(result: CompileResult, error: BaseException,
                   sources: Any, args: Tuple) -> Any:
        if not _walks(error, opts):
            raise error
        if plan_cache is not None:
            plan_cache.drop(key)
        _mark_poison(plan_store, store_key, result.strategy,
                     f"execute: {type(error).__name__}: {error}")
        last: BaseException = error
        walked: List[str] = []
        names = [c.name for c in tgt.choices()]
        for rung, forced in fallback_ladder(dict(result.strategy), names):
            walked.append(rung)
            degrade(rung, program=program.name, target=result.target,
                    reason="execute", error=last)
            try:
                if forced is None:
                    nxt = _interp_fallback(program, fp, check)
                else:
                    opts2 = replace(opts,
                                    strategy=tuple(sorted(forced.items())),
                                    optimize=None)
                    nxt = _build_plan(program, tgt, opts2, check,
                                      fp, None, frozenset(), None, None, {}, backend)
                out = nxt._dispatch(sources, *args)
            except Exception as e:
                if not _walks(e, opts):
                    raise
                last = e
                if forced is not None:
                    _mark_poison(plan_store, store_key,
                                 sorted(forced.items()),
                                 f"execute {rung}: {type(e).__name__}: {e}")
                continue
            # splice the surviving plan into the caller's handle — later
            # calls dispatch straight to the safe executable
            result.target = nxt.target
            result.program = nxt.program
            result.executable = nxt.executable
            result.strategy = nxt.strategy
            result.profile = nxt.profile
            result.degraded = result.degraded + tuple(walked)
            get_tracer().counter("robust.fallback.recovered")
            if plan_cache is not None:
                plan_cache.store(key, replace(result, cache_hit=False,
                                              cache_source="miss",
                                              _guard=None))
            return out
        raise last

    return exec_guard


def _host(value: Any) -> Any:
    """A torch VecTable or tensor as the interpreter's numpy value."""
    if hasattr(value, "to_numpy"):
        return value.to_numpy()
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return value


class _NumpySourceAdapter:
    """Adapts the local target's sources to the interp backend's numpy-dict
    model: the fallback chain's terminal rung re-targets a query at interp,
    but the caller already passed VecTables.  This shim copies them to the
    host at dispatch so the degraded plan is a drop-in replacement (for a
    plan on the card, only after injected faults: :func:`_walks`)."""

    emits_op_spans = True

    def __init__(self, inner: Any) -> None:
        self.inner = inner
        self.program = getattr(inner, "program", None)

    @staticmethod
    def _convert(sources: Any, args: Tuple) -> Tuple[Any, List[Any]]:
        srcs = (None if sources is None
                else {k: _host(v) for k, v in dict(sources).items()})
        return srcs, [_host(a) for a in args]

    def __call__(self, sources: Any = None, *args: Any) -> Any:
        srcs, host_args = self._convert(sources, args)
        return self.inner(srcs, *host_args)

    def run_traced(self, sources: Any = None, *args: Any) -> Any:
        srcs, host_args = self._convert(sources, args)
        return self.inner.run_traced(srcs, *host_args)


def _interp_fallback(program: Program, fp: str, check: bool) -> CompileResult:
    """The terminal rung: compile ``program`` for the reference interpreter."""
    it = get_target("interp")
    iopts = CompileOptions()
    lowered, records = _lower_with_strategy(program, it, iopts, {}, check)
    be = it.make_backend(iopts)
    maybe_inject("backend.compile", target="interp", program=program.name)
    t0 = time.perf_counter()
    with get_tracer().span("backend:interp", cat="compile.backend"):
        executable = be.compile(lowered)
    backend_s = time.perf_counter() - t0
    return CompileResult(
        target="interp",
        source=program,
        program=lowered,
        executable=_NumpySourceAdapter(executable),
        records=tuple(records),
        fingerprint=fp,
        backend_s=backend_s,
    )


def _normalize_strategy(strategy: Any, tgt: Any,
                        ) -> Optional[Tuple[Tuple[str, str], ...]]:
    """Validate forced strategy overrides against the target's choices —
    a misspelled choice or variant must fail loudly, not silently compile
    the default plan under a polluted cache key."""
    if not strategy:
        return None
    try:
        pairs = sorted(strategy.items() if isinstance(strategy, dict)
                       else strategy)
        strat = tuple((str(k), str(v)) for k, v in pairs)
    except (TypeError, ValueError):
        raise ValueError(
            f"strategy must be a mapping or (choice, variant) pairs, "
            f"got {strategy!r}") from None
    known = {c.name: [label for label, _ in c.variants] for c in tgt.choices()}
    for name, label in strat:
        if name not in known:
            raise ValueError(
                f"target {tgt.name!r} declares no strategy choice {name!r}; "
                f"declared: {sorted(known) or 'none'}")
        if label not in known[name]:
            raise ValueError(
                f"choice {name!r} has no variant {label!r}; "
                f"known: {known[name]}")
    return strat


def _resolve_store(store: Any):
    """``False`` → off; ``None`` → env default; path/str → open; else as-is."""
    if store is False:
        return None
    from .store import PlanStore, default_store

    if store is None:
        return default_store()
    if isinstance(store, (str, bytes)) or hasattr(store, "__fspath__"):
        return PlanStore(store)
    return store


_CALIBRATION_SEEDED = False


def _seed_calibration(plan_store: Any) -> None:
    """Warm the in-process calibration from the store, once."""
    global _CALIBRATION_SEEDED
    if _CALIBRATION_SEEDED or CALIBRATION.n:
        return
    loaded = plan_store.load_calibration()
    if loaded.n:
        CALIBRATION.scale = loaded.scale
        CALIBRATION.n = loaded.n
    _CALIBRATION_SEEDED = True


def _check_parallel_divides(program: Program, opts: CompileOptions) -> None:
    """Fail early, with the table named, instead of deep inside the typing
    rules: a worker count must divide every scanned table's padded capacity."""
    catalog = opts.catalog
    if not opts.parallel or opts.parallel <= 1 or catalog is None:
        return
    capacities = getattr(catalog, "capacities", None) or {}
    scanned = [ins.param("table") for p in program.walk() for ins in p.body
               if ins.opcode in ("rel.Scan", "vec.ScanVec")]
    bad = {t: capacities[t] for t in scanned
           if t in capacities and capacities[t] % opts.parallel != 0}
    if bad:
        listing = ", ".join(f"{t} (capacity {c})" for t, c in sorted(bad.items()))
        raise ValueError(
            f"parallel={opts.parallel} does not divide the padded capacity of "
            f"{listing}; pick a worker count that divides the capacities or "
            "adjust Context(pad_to=...)")


def _check_mesh_available(tgt: Any, opts: CompileOptions) -> None:
    """Mesh-backed targets fail at the driver, naming the shortfall, rather
    than waiting in a rendezvous for ranks that never come."""
    if not tgt.needs_mesh or opts.mesh is not None:
        return
    from ..launch.mesh import world_size

    needed = opts.parallel or 1
    available = world_size()
    if needed > available:
        raise ValueError(
            f"target {tgt.name!r} needs a {needed}-rank mesh (one device process "
            f"per rank) but only {available} rank(s) are running; pass mesh=... "
            f"or start {needed} ranks (torchrun --nproc-per-node {needed}) and "
            "init_process_group before compiling")


def _check_flavors(program: Program, tgt: Any) -> None:
    """Soft check: the lowered program should only use flavors the target
    declared; unknown flavors warn rather than fail."""
    seen = {op.split(".", 1)[0] for op in program.opcodes() if "." in op}
    extra = seen - set(tgt.flavors)
    if extra:
        warnings.warn(
            f"target {tgt.name!r} received IR flavors {sorted(extra)} outside "
            f"its declared set {list(tgt.flavors)}",
            stacklevel=3,
        )
