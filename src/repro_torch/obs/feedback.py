"""Measured-cardinality feedback: runtime observations → catalog + cost model.

The cost-based driver plans with *estimates* (``compiler/stats.py``); this
module closes the loop with *measurements*:

  * backends tap the output cardinality of selected operators during a
    traced execution (``TAPPED_OPS``) — eagerly in the interpreter, via
    device-side counts in the port's eager local backend, read back once
    at the end of a traced run;
  * :func:`build_profile` joins those measurements against the propagated
    estimates of the *same lowered program* into a
    :class:`RuntimeProfile` — the estimated-vs-actual table that
    ``CompileResult.explain()`` renders;
  * :data:`FEEDBACK` accumulates observations across runs: measured base
    table row counts become *observed* ``TableStats``
    (:meth:`FeedbackCatalog.observed_statistics`), and measured wall time
    per estimated cost unit feeds :data:`~repro_torch.compiler.cost.EXEC_CALIBRATION`
    — the measurement substrate for the ROADMAP's re-planning trigger
    (:meth:`FeedbackCatalog.plans_over_threshold`).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .trace import get_tracer

# NOTE: repro_torch.compiler imports (cost, stats) are deferred to call sites —
# the compilation driver depends on repro_torch.robust which depends on
# repro_torch.obs,
# so a module-level compiler import here would close an import cycle.

__all__ = [
    "TAPPED_OPS", "tap_key", "TapRecord", "OpObservation", "RuntimeProfile",
    "build_profile", "FeedbackCatalog", "FEEDBACK",
]

#: operators whose output cardinality a traced execution measures — the
#: cardinality-carrying steps of a relational plan (selections, grouped and
#: scalar aggregations, joins, compaction/limits, scans for base-table truth,
#: and whole MeshExecute bodies on the spmd path)
TAPPED_OPS = frozenset({
    # vec flavor (the local backend)
    "vec.ScanVec", "vec.MaskSelect", "vec.GroupAggSorted",
    "vec.GroupAggDirect", "vec.FusedSelectAgg", "vec.AggrVec",
    "vec.MergeJoinSorted", "vec.HashJoinDirect", "vec.FusedJoinGroupAgg",
    "vec.Compact", "vec.TopKVec", "vec.LimitVec",
    # encode cardinality: rows flowing through the rank lookup (the encode
    # cost driver — dictionary card itself is a static instruction param)
    "vec.DictEncode",
    # rel flavor (interpreter)
    "rel.Scan", "rel.Select", "rel.GroupByAggr", "rel.Aggr", "rel.Join",
    "rel.Limit", "rel.Distinct",
    # mesh / control flow boundaries
    "mesh.MeshExecute", "mesh.ExchangeByKey",
})

_SCAN_OPS = ("rel.Scan", "vec.ScanVec")


def tap_key(program_name: str, index: int, opcode: str, register: str) -> str:
    """Stable identity of one instruction: body position + opcode + names.

    Keys must be static across runs of the same program and
    reconstructible by walking the lowered program (how estimates are
    joined back on).
    """
    return f"{index:03d}|{opcode}|{program_name}|{register}"


def _parse_key(key: str) -> Tuple[int, str, str, str]:
    index, opcode, program, register = key.split("|", 3)
    return int(index), opcode, program, register


@dataclass(frozen=True)
class TapRecord:
    """Aggregated measurement for one instruction across its executions
    (an op inside an unrolled ConcurrentExecute body taps once per chunk —
    row counts are summed, giving the global cardinality)."""

    occurrences: int
    rows_in: Optional[int]
    rows_out: int


@dataclass(frozen=True)
class OpObservation:
    """One operator's measured vs estimated cardinality."""

    key: str
    opcode: str
    program: str
    register: str
    occurrences: int
    rows_in: Optional[int]
    rows_out: int
    est_rows: Optional[float]
    wall_s: Optional[float] = None      # eager backends only (interpreter)
    table: Optional[str] = None         # scans: the base table measured

    @property
    def rel_miss(self) -> Optional[float]:
        """Signed relative estimation miss: (actual − est) / max(est, 1)."""
        if self.est_rows is None:
            return None
        return (self.rows_out - self.est_rows) / max(self.est_rows, 1.0)


@dataclass
class RuntimeProfile:
    """One traced execution: wall time + per-operator observations."""

    target: str
    program_name: str
    fingerprint: str
    wall_s: float
    observations: Tuple[OpObservation, ...]
    est_cost: float = 0.0

    @property
    def worst_miss(self) -> Optional[float]:
        misses = [abs(o.rel_miss) for o in self.observations
                  if o.rel_miss is not None]
        return max(misses) if misses else None

    def scan_rows(self) -> Dict[str, int]:
        """Measured base-table row counts (valid rows, not padded capacity)."""
        return {o.table: o.rows_out for o in self.observations
                if o.table is not None}

    def render(self) -> str:
        """The estimated-vs-actual cardinality table for ``explain()``."""
        head = (f"runtime[{self.target}] {self.program_name}: "
                f"{self.wall_s * 1e3:.3f} ms, "
                f"{len(self.observations)} measured op(s)")
        if self.worst_miss is not None:
            head += f", worst cardinality miss {self.worst_miss * 100:.0f}%"
        lines = [head,
                 "| op | register | est rows | actual rows | miss | wall ms |",
                 "|---|---|---:|---:|---:|---:|"]
        for o in self.observations:
            est = f"{o.est_rows:,.0f}" if o.est_rows is not None else "?"
            miss = (f"{o.rel_miss * 100:+.0f}%" if o.rel_miss is not None
                    else "—")
            wall = f"{o.wall_s * 1e3:.3f}" if o.wall_s is not None else "—"
            name = o.opcode + (f"[{o.table}]" if o.table else "")
            lines.append(f"| {name} | {o.register} | {est} | {o.rows_out:,} "
                         f"| {miss} | {wall} |")
        return "\n".join(lines)

    def records(self) -> List[Dict[str, Any]]:
        return [
            {"key": o.key, "op": o.opcode, "program": o.program,
             "register": o.register, "occurrences": o.occurrences,
             "rows_in": o.rows_in, "rows_out": o.rows_out,
             "est_rows": o.est_rows, "rel_miss": o.rel_miss,
             "wall_s": o.wall_s, "table": o.table}
            for o in self.observations
        ]


def build_profile(result: Any, cards: Mapping[str, TapRecord], wall_s: float,
                  wall_by_key: Optional[Mapping[str, float]] = None,
                  ) -> RuntimeProfile:
    """Join measured cardinalities against the lowered program's estimates.

    ``result`` is a :class:`~repro_torch.compiler.driver.CompileResult`; the taps
    were collected from ``result.program`` (the exact program the backend
    executed), so estimates and measurements line up by construction.
    """
    from ..compiler.cost import estimate_cost
    from ..compiler.stats import propagate, seq_chunks

    program = result.program
    stats = getattr(result, "stats", None)
    env = propagate(program, stats)

    est_by_key: Dict[str, float] = {}
    table_by_key: Dict[str, str] = {}
    for p in program.walk():
        for i, ins in enumerate(p.body):
            if ins.opcode not in TAPPED_OPS or not ins.outputs:
                continue
            key = tap_key(p.name, i, ins.opcode, ins.outputs[0].name)
            est = env.get(p, ins.outputs[0]).rows
            if ins.opcode == "mesh.MeshExecute":
                # outputs are stacked Seq[n] chunks and the measurement sums
                # across shards; the propagated estimate is per shard
                est *= float(seq_chunks(ins.outputs[0]))
            est_by_key[key] = est
            if ins.opcode in _SCAN_OPS:
                table_by_key[key] = ins.param("table")

    observations = []
    for key in sorted(cards):
        rec = cards[key]
        index, opcode, pname, register = _parse_key(key)
        est = est_by_key.get(key)
        if est is not None and rec.occurrences > 1:
            # per-chunk estimate × chunks ↔ summed per-chunk measurements
            est *= rec.occurrences
        observations.append(OpObservation(
            key=key, opcode=opcode, program=pname, register=register,
            occurrences=rec.occurrences, rows_in=rec.rows_in,
            rows_out=rec.rows_out, est_rows=est,
            wall_s=(wall_by_key or {}).get(key),
            table=table_by_key.get(key),
        ))
    return RuntimeProfile(
        target=result.target,
        program_name=result.source.name,
        fingerprint=result.fingerprint,
        wall_s=wall_s,
        observations=tuple(observations),
        est_cost=estimate_cost(program, stats),
    )


# ---------------------------------------------------------------------------
# the accumulating catalog
# ---------------------------------------------------------------------------


@dataclass
class FeedbackCatalog:
    """Cross-run accumulator of measured statistics.

    Thread-safe; bounded (``max_profiles`` most recent profiles kept).  The
    observed numbers are what adaptive re-optimization consumes: pass
    :meth:`observed_statistics` as the catalog stats of a re-compile and the
    costed search now ranks candidates under *measured* cardinalities.
    """

    max_profiles: int = 64
    table_rows: Dict[str, int] = field(default_factory=dict)
    profiles: "OrderedDict[str, RuntimeProfile]" = field(
        default_factory=OrderedDict)  # latest profile per fingerprint
    runs: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, profile: RuntimeProfile) -> None:
        with self._lock:
            self.runs += 1
            self.table_rows.update(profile.scan_rows())
            self.profiles[profile.fingerprint] = profile
            self.profiles.move_to_end(profile.fingerprint)
            while len(self.profiles) > self.max_profiles:
                self.profiles.popitem(last=False)
        if profile.est_cost > 0 and profile.wall_s > 0:
            from ..compiler.cost import EXEC_CALIBRATION

            # abstract plan-cost units → measured execution seconds: the
            # runtime sibling of the compile-time CALIBRATION EMA
            EXEC_CALIBRATION.update(profile.est_cost, profile.wall_s)
        tracer = get_tracer()
        tracer.counter("feedback.profiles")
        if profile.worst_miss is not None:
            tracer.counter("feedback.worst_miss_pct",
                           profile.worst_miss * 100.0)

    def observed_statistics(self, base: Any = None) -> Any:
        """Catalog statistics with measured base-table row counts folded in.

        ``base`` is the estimate-time :class:`~repro_torch.compiler.stats.Statistics`
        (or ``None``); measured scan cardinalities override its row counts —
        NDV and domain knowledge is preserved.
        """
        from ..compiler.stats import Statistics

        with self._lock:
            rows = dict(self.table_rows)
        base = base if base is not None else Statistics()
        return base.with_observed_rows(rows)

    def plans_over_threshold(self, threshold: float = 1.0,
                             ) -> List[Tuple[str, float]]:
        """Fingerprints whose worst cardinality miss exceeds ``threshold``
        (relative) — the candidates for adaptive re-planning."""
        with self._lock:
            out = [(fp, p.worst_miss) for fp, p in self.profiles.items()
                   if p.worst_miss is not None and p.worst_miss > threshold]
        return sorted(out, key=lambda kv: -kv[1])

    def clear(self) -> None:
        with self._lock:
            self.table_rows.clear()
            self.profiles.clear()
            self.runs = 0


#: process-wide feedback catalog — every traced execution lands here
FEEDBACK = FeedbackCatalog()
