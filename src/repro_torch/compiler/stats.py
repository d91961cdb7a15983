"""Statistics catalog + estimate propagation for cost-based plan selection.

The paper's rewriting pipelines are "highly flexible and configurable"; to
*choose* between two valid physical plans (Tupleware/Flare-style) the driver
needs cardinality estimates.  This module carries them:

  * :class:`TableStats` / :class:`Statistics` — the per-table catalog:
    row count, bytes per row, and per-column NDV (number of distinct
    values, i.e. key cardinality).  Frontends thread these into
    ``CompileOptions`` via ``Catalog.stats``.
  * :class:`RegStats` — the estimate attached to one register while
    propagating through a (possibly already rewritten) program.
  * :func:`propagate` — abstract interpretation of a CVM program under the
    catalog: every pass output stays estimable because the rules understand
    the rewritten forms too (``cf.Split``/``ConcurrentExecute`` chunks,
    ``mesh.MeshExecute`` bodies, fused ``vec.FusedSelectAgg``, collectives).
    Unknown instructions pass their first input's estimate through — the
    same "leave it as is" contract the rewrite rules follow.

Estimates are deliberately coarse (constant filter selectivity, independent
keys); they only need to rank alternative physical plans, not predict
runtimes.  Calibration against measured compiles lives in ``cost.py``.
"""

from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

from ..core.program import Program, Register
from ..core.types import CollectionType, item_nbytes, is_coll

__all__ = [
    "TableStats", "Statistics", "RegStats", "Dictionary", "propagate",
    "stats_from_columns", "selectivity_of",
    "DEFAULT_SELECTIVITY", "DICT_MAX_CARD", "seq_chunks",
]

#: fraction of rows assumed to survive a filter when the predicate is opaque
DEFAULT_SELECTIVITY = 0.5

#: largest dictionary the catalog will build/carry per column — beyond this
#: the rank tables stop paying for themselves (the dense direct tiers would
#: be bucket-bound anyway) and the sorted tiers keep the query
DICT_MAX_CARD = 1 << 16


@dataclass(frozen=True)
class Dictionary:
    """A sorted value→rank encoding dictionary for one column.

    ``values`` is the sorted tuple of distinct values, so rank order is
    value order: rank comparisons preserve ordering predicates and
    rank-sorted output matches value-sorted output row for row.  Catalog
    dictionaries hold *physical* key values — plain ints, since string
    columns are already global-rank i32 codes by the time they reach the
    vec flavor (the documented str→i32 TPU adaptation); the Context-level
    global string dictionary holds the strings themselves.

    ``digest`` is a deterministic content hash: Python's string hash is
    process-randomized, and dictionaries participate in cross-process
    plan-store cache keys.
    """

    values: Tuple[Any, ...]
    digest: str

    @staticmethod
    def make(values: Iterable[Any]) -> "Dictionary":
        vals = tuple(values)
        h = hashlib.sha256()
        for v in vals:
            h.update(repr(v).encode("utf-8"))
            h.update(b"\x1f")
        return Dictionary(vals, h.hexdigest())

    @property
    def card(self) -> int:
        return len(self.values)

    @property
    def lo(self) -> Any:
        return self.values[0]

    @property
    def hi(self) -> Any:
        return self.values[-1]

    @property
    def dense(self) -> bool:
        """Integer values forming a contiguous range — ranks are then just
        an offset and no encode instruction is needed at all."""
        if self.card == 0 or isinstance(self.values[0], str):
            return False
        return int(self.hi) - int(self.lo) + 1 == self.card

    def rank_of(self, value: Any) -> Optional[int]:
        i = bisect.bisect_left(self.values, value)
        if i < self.card and self.values[i] == value:
            return i
        return None

    def insertion(self, value: Any, side: str = "left") -> int:
        """Rank-space insertion point of ``value`` (for range predicates:
        ``x < v  ⟺  rank(x) < insertion(v, 'left')``)."""
        fn = bisect.bisect_left if side == "left" else bisect.bisect_right
        return fn(self.values, value)

    def merge(self, other: "Dictionary") -> "Dictionary":
        return Dictionary.make(sorted(set(self.values) | set(other.values)))


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TableStats:
    """Statistics for one base table."""

    rows: int
    bytes_per_row: float = 8.0
    ndv: Tuple[Tuple[str, int], ...] = ()  # per-column distinct-value counts
    #: per-column value bounds (lo, hi), integral columns only — these are
    #: what make *dense-bucket* physical operators (vec.GroupAggDirect,
    #: domain-packed composite join keys) plannable
    domains: Tuple[Tuple[str, Tuple[int, int]], ...] = ()
    #: per-column value→rank dictionaries for key columns whose raw domain
    #: is sparse or absent (string codes, wide ints) — what makes the dense
    #: direct tiers reachable *via encoding* when ``domains`` can't
    dicts: Tuple[Tuple[str, Dictionary], ...] = ()

    def ndv_of(self, column: str, default: Optional[int] = None) -> Optional[int]:
        for name, n in self.ndv:
            if name == column:
                return n
        return default

    def domain_of(self, column: str) -> Optional[Tuple[int, int]]:
        for name, d in self.domains:
            if name == column:
                return d
        return None

    def dict_of(self, column: str) -> Optional[Dictionary]:
        for name, d in self.dicts:
            if name == column:
                return d
        return None

    @staticmethod
    def make(rows: int, bytes_per_row: float = 8.0,
             ndv: Optional[Mapping[str, int]] = None,
             domains: Optional[Mapping[str, Tuple[int, int]]] = None,
             dicts: Optional[Mapping[str, Dictionary]] = None,
             ) -> "TableStats":
        return TableStats(int(rows), float(bytes_per_row),
                          tuple(sorted((ndv or {}).items())),
                          tuple(sorted((k, (int(lo), int(hi)))
                                       for k, (lo, hi) in (domains or {}).items())),
                          tuple(sorted((dicts or {}).items(),
                                       key=lambda kv: kv[0])))

    def with_rows(self, rows: int) -> "TableStats":
        """An *observed* copy: measured row count, everything else kept.

        NDV caps ride along — a measured table can't have more distinct
        values in a column than it has rows."""
        rows = int(rows)
        ndv = tuple((k, min(v, max(rows, 1))) for k, v in self.ndv)
        return replace(self, rows=rows, ndv=ndv)


@dataclass(frozen=True)
class Statistics:
    """Per-table statistics catalog (hashable: part of the plan-cache key)."""

    tables: Tuple[Tuple[str, TableStats], ...] = ()
    #: the session-wide string dictionary (``Context.statistics()`` builds
    #: it over *all* registered string values): physical string columns are
    #: its i32 rank codes, so cross-table joins compare consistently and
    #: string literals in predicates can be remapped into code space
    global_dict: Optional[Dictionary] = None

    @staticmethod
    def make(tables: Mapping[str, TableStats],
             global_dict: Optional[Dictionary] = None) -> "Statistics":
        return Statistics(tuple(sorted(tables.items())), global_dict)

    def table(self, name: str) -> Optional[TableStats]:
        for n, t in self.tables:
            if n == name:
                return t
        return None

    def cache_key(self) -> Tuple:
        return tuple((n, t.rows, t.bytes_per_row, t.ndv, t.domains,
                      tuple((c, d.digest) for c, d in t.dicts))
                     for n, t in self.tables) + (
            self.global_dict.digest if self.global_dict else None,)

    def with_observed_rows(self, rows: Mapping[str, int]) -> "Statistics":
        """Fold measured base-table cardinalities (from traced executions —
        see ``repro.obs.feedback``) into the catalog: measured row counts
        override the estimates, tables the catalog never saw are added with
        default per-row bytes, and NDV/domain knowledge is preserved."""
        tables = {n: t for n, t in self.tables}
        for name, n_rows in rows.items():
            base = tables.get(name)
            tables[name] = (base.with_rows(n_rows) if base is not None
                            else TableStats(int(n_rows)))
        return Statistics.make(tables, self.global_dict)


def stats_from_columns(columns: Mapping[str, Any],
                       global_dict: Optional[Dictionary] = None) -> TableStats:
    """Exact statistics from in-memory numpy columns (small-data frontends).

    String columns are measured in their *physical* representation — i32
    rank codes against ``global_dict`` (4 bytes/row, no raw domain entry:
    the raw string domain is unordered-from-the-planner's-view until
    encoded).  Per-column :class:`Dictionary` entries are built exactly
    when they could unlock the dense direct tiers: always for string
    columns, and for integer columns whose value range is sparse
    (span > NDV), capped at :data:`DICT_MAX_CARD` distinct values.
    """
    import numpy as np

    rows = len(next(iter(columns.values()))) if columns else 0
    bpr = float(sum(4.0 if np.asarray(v).dtype.kind in ("U", "S")
                    else np.asarray(v).dtype.itemsize
                    for v in columns.values())) or 8.0
    ndv = {k: int(np.unique(np.asarray(v)).size) for k, v in columns.items()}
    domains = {}
    dicts = {}
    for k, v in columns.items():
        a = np.asarray(v)
        if rows == 0:
            continue
        if a.dtype == np.bool_:
            domains[k] = (0, 1)
        elif np.issubdtype(a.dtype, np.integer):
            domains[k] = (int(a.min()), int(a.max()))
            uniq = np.unique(a)
            span = int(uniq[-1]) - int(uniq[0]) + 1
            if uniq.size <= DICT_MAX_CARD and span > uniq.size:
                dicts[k] = Dictionary.make(int(x) for x in uniq)
        elif a.dtype.kind in ("U", "S") and global_dict is not None:
            uniq = np.unique(a)
            if uniq.size <= DICT_MAX_CARD:
                gvals = np.asarray(global_dict.values)
                codes = np.searchsorted(gvals, uniq)
                dicts[k] = Dictionary.make(int(c) for c in codes)
    return TableStats.make(rows, bpr, ndv, domains, dicts)


# ---------------------------------------------------------------------------
# register estimates
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RegStats:
    """Estimated properties of one register's value.

    For split registers (``Seq[n]`` of chunks) the estimate is *per chunk*,
    matching how the backends execute them.
    """

    rows: float
    bytes_per_row: float = 8.0
    ndv: Tuple[Tuple[str, float], ...] = ()
    #: per-column integral value bounds, carried through rewrites so the
    #: lowering can plan dense-bucket operators on derived registers
    domains: Tuple[Tuple[str, Tuple[int, int]], ...] = ()
    #: per-column encoding dictionaries, carried through rewrites (incl.
    #: MeshExecute bodies) so derived registers keep their encodings
    dicts: Tuple[Tuple[str, Dictionary], ...] = ()

    @property
    def bytes(self) -> float:
        return self.rows * self.bytes_per_row

    def ndv_of(self, column: str, default: Optional[float] = None) -> Optional[float]:
        for name, n in self.ndv:
            if name == column:
                return n
        return default

    def domain_of(self, column: str) -> Optional[Tuple[int, int]]:
        for name, d in self.domains:
            if name == column:
                return d
        return None

    def dict_of(self, column: str) -> Optional[Dictionary]:
        for name, d in self.dicts:
            if name == column:
                return d
        return None

    def scaled(self, factor: float) -> "RegStats":
        rows = max(self.rows * factor, 1.0)
        ndv = tuple((k, min(v, rows)) for k, v in self.ndv)
        return replace(self, rows=rows, ndv=ndv)

    def group_rows(self, keys: Tuple[str, ...], cap: Optional[int] = None) -> float:
        """Estimated distinct groups for ``keys`` (independence assumption)."""
        est = 1.0
        for k in keys:
            est *= self.ndv_of(k) or min(self.rows, 64.0)
        est = min(est, self.rows)
        if cap is not None:
            est = min(est, float(cap))
        return max(est, 1.0)


def _bpr_of(reg: Register, default: float = 8.0) -> float:
    t = reg.type
    while is_coll(t) and isinstance(t, CollectionType) and is_coll(t.item):
        t = t.item  # unwrap Seq-of-chunks down to the element collection
    return float(item_nbytes(t, int(default)))


def _seq_n(reg: Register) -> int:
    t = reg.type
    if is_coll(t):
        n = t.attr("n")
        if n:
            return int(n)
    return 1


def seq_chunks(reg: Register) -> int:
    """Number of chunks of a split ``Seq[n]`` register (1 when unsplit) —
    how per-chunk estimates scale to the global cardinality."""
    return _seq_n(reg)


# ---------------------------------------------------------------------------
# predicate selectivity
# ---------------------------------------------------------------------------


def _col_bounds(rs: RegStats, name: str):
    """Integral (lo, hi) for a column: the raw domain when known, else the
    code-space bounds of its dictionary (post-lowering predicates compare
    against codes, so dictionary bounds are the right domain there)."""
    d = rs.domain_of(name)
    if d is not None:
        return int(d[0]), int(d[1])
    dc = rs.dict_of(name)
    if dc is not None and dc.card > 0 and not isinstance(dc.lo, str):
        return int(dc.lo), int(dc.hi)
    return None


def _cmp_selectivity(cmp_op: str, col: str, value: Any, rs: RegStats,
                     global_dict: Optional[Dictionary]) -> float:
    if isinstance(value, str):
        # string literal against an i32-coded column: translate the literal
        # into global-code space first (the same mapping the lowering's
        # predicate remap applies)
        if global_dict is None:
            return DEFAULT_SELECTIVITY
        if cmp_op in ("eq", "ne"):
            present = global_dict.rank_of(value) is not None
            if cmp_op == "eq" and not present:
                return 0.0
            if cmp_op == "ne" and not present:
                return 1.0
            ndv = rs.ndv_of(col) or global_dict.card
            return 1.0 / max(float(ndv), 1.0) if cmp_op == "eq" \
                else 1.0 - 1.0 / max(float(ndv), 1.0)
        # x < v ⟺ code < insertion_left(v); x <= v ⟺ code < insertion_right
        if cmp_op in ("lt", "le"):
            bound = global_dict.insertion(
                value, "left" if cmp_op == "lt" else "right")
            return _cmp_selectivity("lt", col, bound, rs, None)
        if cmp_op in ("gt", "ge"):
            bound = global_dict.insertion(
                value, "right" if cmp_op == "gt" else "left")
            return _cmp_selectivity("ge", col, bound, rs, None)
        return DEFAULT_SELECTIVITY

    bounds = _col_bounds(rs, col)
    if cmp_op in ("eq", "ne"):
        ndv = rs.ndv_of(col)
        if ndv is None and bounds is not None:
            ndv = bounds[1] - bounds[0] + 1
        if ndv is None:
            return DEFAULT_SELECTIVITY
        eq = 1.0 / max(float(ndv), 1.0)
        if bounds is not None and not (bounds[0] <= value <= bounds[1]):
            eq = 0.0  # min/max pruning: the literal is outside the domain
        return eq if cmp_op == "eq" else 1.0 - eq
    if bounds is None:
        return DEFAULT_SELECTIVITY
    lo, hi = bounds
    span = float(hi - lo + 1)
    try:
        v = float(value)
    except (TypeError, ValueError):
        return DEFAULT_SELECTIVITY
    if cmp_op == "lt":
        frac = (v - lo) / span
    elif cmp_op == "le":
        frac = (v - lo + 1) / span
    elif cmp_op == "gt":
        frac = (hi - v) / span
    elif cmp_op == "ge":
        frac = (hi - v + 1) / span
    else:
        return DEFAULT_SELECTIVITY
    return min(max(frac, 0.0), 1.0)


_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}


def selectivity_of(pred, rs: RegStats,
                   global_dict: Optional[Dictionary] = None) -> float:
    """Estimated fraction of rows satisfying ``pred`` under ``rs``.

    Range and equality predicates over columns with known domains (or
    dictionaries) get min/max pruning; conjunctions multiply under the
    independence assumption; anything opaque falls back to
    :data:`DEFAULT_SELECTIVITY`.  Works both on source programs (string
    literals resolve through ``global_dict``) and on lowered ones (integer
    code literals resolve through dictionary code bounds), so the estimate
    the optimizer prints matches the plan that ran.
    """
    from ..core.expr import BinOp, Col, Const, UnOp

    def sel(e) -> float:
        if isinstance(e, Const):
            return 1.0 if bool(e.value) else 0.0
        if isinstance(e, UnOp) and e.op == "not":
            return min(max(1.0 - sel(e.arg), 0.0), 1.0)
        if isinstance(e, BinOp):
            if e.op == "and":
                return sel(e.lhs) * sel(e.rhs)
            if e.op == "or":
                a, b = sel(e.lhs), sel(e.rhs)
                return min(a + b - a * b, 1.0)
            if e.op in _FLIP:
                lhs, rhs = e.lhs, e.rhs
                if isinstance(lhs, Col) and isinstance(rhs, Const):
                    return _cmp_selectivity(e.op, lhs.name, rhs.value, rs,
                                            global_dict)
                if isinstance(lhs, Const) and isinstance(rhs, Col):
                    return _cmp_selectivity(_FLIP[e.op], rhs.name, lhs.value,
                                            rs, global_dict)
        return DEFAULT_SELECTIVITY

    return min(max(sel(pred), 0.0), 1.0)


# ---------------------------------------------------------------------------
# propagation
# ---------------------------------------------------------------------------


class StatsEnv:
    """Register → RegStats over a program tree (nested scopes included)."""

    def __init__(self) -> None:
        self._env: Dict[Tuple[int, str], RegStats] = {}

    def get(self, program: Program, reg: Register) -> RegStats:
        got = self._env.get((id(program), reg.name))
        if got is not None:
            return got
        # total fallback: estimate from the type alone
        cap = reg.type.attr("max_count") if is_coll(reg.type) else None
        return RegStats(rows=float(cap or 64), bytes_per_row=_bpr_of(reg))

    def set(self, program: Program, reg: Register, s: RegStats) -> None:
        self._env[(id(program), reg.name)] = s


def propagate(program: Program, stats: Optional[Statistics] = None,
              input_stats: Optional[Mapping[str, RegStats]] = None,
              env: Optional[StatsEnv] = None) -> StatsEnv:
    """Propagate table statistics through a program (and nested programs).

    Works on any IR flavor mix, before or after rewriting: the rules cover
    the relational ops, their vec/mesh lowerings, and the control-flow
    scaffolding the parallelization rewrite introduces, so estimates
    "survive" ``Parallelize``, ``FuseSelectAgg``, and ``LowerToMesh``.
    """
    env = env or StatsEnv()
    for r in program.inputs:
        if input_stats and r.name in input_stats:
            env.set(program, r, input_stats[r.name])
    for ins in program.body:
        args = [env.get(program, r) for r in ins.inputs]
        outs = _propagate_ins(ins, args, stats, env, program)
        for reg, s in zip(ins.outputs, outs):
            env.set(program, reg, s)
    return env


def _scan_stats(table: str, reg: Register, stats: Optional[Statistics]) -> RegStats:
    ts = stats.table(table) if stats is not None else None
    if ts is None:
        cap = reg.type.attr("max_count") if is_coll(reg.type) else None
        return RegStats(rows=float(cap or 1024), bytes_per_row=_bpr_of(reg))
    return RegStats(rows=float(ts.rows), bytes_per_row=float(ts.bytes_per_row),
                    ndv=tuple((k, float(v)) for k, v in ts.ndv),
                    domains=tuple(ts.domains), dicts=tuple(ts.dicts))


def _propagate_ins(ins, args, stats, env: StatsEnv, program: Program):
    op = ins.opcode
    first = args[0] if args else RegStats(rows=1.0)

    if op in ("rel.Scan", "vec.ScanVec"):
        return [_scan_stats(ins.param("table"), ins.outputs[0], stats)]

    if op in ("rel.Select", "vec.MaskSelect"):
        gd = stats.global_dict if stats is not None else None
        return [first.scaled(selectivity_of(ins.param("pred"), first, gd))]

    if op in ("rel.Proj", "vec.ProjVec", "vec.SortByKey", "rel.OrderBy",
              "vec.Compact"):
        return [replace(first.scaled(1.0), bytes_per_row=_bpr_of(ins.outputs[0]))]

    if op in ("rel.ExProj", "vec.ExProjVec"):
        # computed columns invalidate their NDV/domain estimates: keep them
        # only where the expression is the identity Col — a stale domain
        # would make a downstream dense-bucket plan silently merge groups
        from ..core.expr import Col
        identity = {n for n, e in tuple(ins.param("exprs") or ())
                    if isinstance(e, Col) and e.name == n}
        return [replace(first.scaled(1.0), bytes_per_row=_bpr_of(ins.outputs[0]),
                        ndv=tuple((k, v) for k, v in first.ndv if k in identity),
                        domains=tuple((k, d) for k, d in first.domains
                                      if k in identity),
                        dicts=tuple((k, d) for k, d in first.dicts
                                    if k in identity))]

    if op in ("rel.Aggr", "vec.AggrVec", "vec.FusedSelectAgg",
              "vec.FinalizeSingle", "rel.CombinePartials"):
        return [RegStats(rows=1.0, bytes_per_row=_bpr_of(ins.outputs[0]))]

    if op in ("rel.GroupByAggr", "vec.GroupAggSorted", "vec.GroupAggDirect"):
        keys = tuple(ins.param("keys") or ())
        cap = ins.param("max_groups")
        groups = first.group_rows(keys, int(cap) if cap else None)
        ndv = tuple((k, min(first.ndv_of(k) or groups, groups)) for k in keys)
        domains = tuple((k, d) for k in keys
                        for d in (first.domain_of(k),) if d is not None)
        dicts = tuple((k, d) for k in keys
                      for d in (first.dict_of(k),) if d is not None)
        return [RegStats(rows=groups, bytes_per_row=_bpr_of(ins.outputs[0]),
                         ndv=ndv, domains=domains, dicts=dicts)]

    if op in ("rel.Join", "vec.MergeJoinSorted", "vec.HashJoinDirect"):
        left = args[0]
        out = replace(left.scaled(1.0), bytes_per_row=_bpr_of(ins.outputs[0]),
                      ndv=tuple(left.ndv) + tuple(args[1].ndv),
                      domains=tuple(left.domains) + tuple(args[1].domains),
                      dicts=tuple(left.dicts) + tuple(args[1].dicts))
        return [out]

    if op == "vec.DictEncode":
        # encoded key columns become dense ranks [0, card): their domain is
        # the rank space and their raw-value dictionary no longer applies
        cards = {c: int(n) for c, n in
                 zip(ins.param("cols"), ins.param("cards"))}
        domains = tuple((k, d) for k, d in first.domains if k not in cards)
        domains += tuple(sorted((c, (0, n - 1)) for c, n in cards.items()))
        ndv = tuple((k, min(v, cards[k]) if k in cards else v)
                    for k, v in first.ndv)
        return [replace(first, domains=domains, ndv=ndv,
                        dicts=tuple((k, d) for k, d in first.dicts
                                    if k not in cards))]

    if op == "vec.DictDecode":
        # ranks gathered back to raw values: the rank-space domains no
        # longer describe the column
        cols = set(ins.param("cols"))
        return [replace(first,
                        domains=tuple((k, d) for k, d in first.domains
                                      if k not in cols))]

    if op == "vec.FusedJoinGroupAgg":
        # select→join→group in one op: the grouping sees the joined columns
        left = args[0]
        gd = stats.global_dict if stats is not None else None
        pred = ins.param("pred")
        sel = selectivity_of(pred, left, gd) if pred is not None else 1.0
        joined = replace(left.scaled(sel),
                         ndv=tuple(left.ndv) + tuple(args[1].ndv),
                         domains=tuple(left.domains) + tuple(args[1].domains),
                         dicts=tuple(left.dicts) + tuple(args[1].dicts))
        keys = tuple(ins.param("keys") or ())
        cap = ins.param("max_groups")
        groups = joined.group_rows(keys, int(cap) if cap else None)
        ndv = tuple((k, min(joined.ndv_of(k) or groups, groups)) for k in keys)
        domains = tuple((k, d) for k in keys
                        for d in (joined.domain_of(k),) if d is not None)
        return [RegStats(rows=groups, bytes_per_row=_bpr_of(ins.outputs[0]),
                         ndv=ndv, domains=domains)]

    if op in ("rel.Limit", "vec.LimitVec", "vec.TopKVec"):
        k = float(ins.param("k", first.rows))
        return [first.scaled(min(1.0, k / max(first.rows, 1.0)))]

    if op == "cf.Split":
        n = int(ins.param("n"))
        return [first.scaled(1.0 / max(n, 1))]

    if op == "cf.Broadcast":
        return [first]

    if op == "cf.Merge":
        n = _seq_n(ins.inputs[0])
        return [first.scaled(float(n))]

    if op == "cf.CombineChunks":
        return [first]

    if op == "cf.TakeChunk":
        return [first]

    if op in ("cf.ConcurrentExecute", "mesh.MeshExecute"):
        inner: Program = ins.param("P")
        inner_in = {r.name: s for r, s in zip(inner.inputs, args)}
        propagate(inner, stats, inner_in, env)
        return [env.get(inner, r) for r in inner.results]

    if op == "mesh.AllReduce":
        return [first]

    if op == "mesh.AllGatherVec":
        n = int(ins.param("n", 1))
        return [first.scaled(float(n))]

    if op == "mesh.ExchangeByKey":
        # redistribution: per-shard row count is preserved on average, but
        # the key space is partitioned across the axis
        n = int(ins.param("n", 1))
        ndv = tuple((k, max(v / max(n, 1), 1.0)) for k, v in first.ndv)
        return [replace(first, ndv=ndv)]

    if op in ("cf.Loop", "cf.While", "cf.Cond", "cf.Call"):
        inner = ins.param("P") or ins.param("Pthen")
        if inner is not None:
            inner_in = {r.name: s for r, s in
                        zip(inner.inputs, args[1:] if op == "cf.Cond" else args)}
            propagate(inner, stats, inner_in, env)
        return [RegStats(rows=first.rows, bytes_per_row=_bpr_of(o))
                for o in ins.outputs]

    # unknown instruction: pass the first input's estimate through, one per
    # output (the "leave it as is" contract of the rewrite rules)
    return [replace(first, bytes_per_row=_bpr_of(o)) for o in ins.outputs]
