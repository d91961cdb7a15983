"""Lowering rewrite: abstract relational flavor → physical vec flavor.

This pass *changes the IR flavor* of a program (paper §3.1: "during the
rewriting, the program may change the IR flavor several times").  Because
physical types carry static capacities, the program is reconstructed
through a Builder so every register is re-typed by the typing rules.

Catalog decisions made here (the "physical optimizer"):
  * table scans get static capacities from the catalog;
  * GroupByAggr → SortByKey + GroupAggSorted(max_groups), or — under
    ``groupby="direct"``, when propagated catalog statistics bound the
    composite key domain — the sort-FREE ``vec.GroupAggDirect`` (dense
    bucket segment reduction, O(n)); the compilation driver exposes the
    two tiers as the ``groupby: sorted | direct`` strategy Choice and the
    cost model picks (NDV/domain decides, like gather-vs-exchange);
  * Join → SortByKey(build side) + MergeJoinSorted (sort-based PK-FK join —
    the TPU-native rewrite of BuildHTable/ProbeHTable, DESIGN.md §2), or —
    under ``join="hash"``, when the statistics bound the joint key domain —
    the sort-FREE ``vec.HashJoinDirect`` (dense direct-table probe, O(n));
    the driver exposes the tiers as the ``join: sorted | hash`` Choice;
    multi-column join keys get catalog-derived ``key_domains`` so the
    composite packing is collision-checked instead of 16-bit truncated;
  * higher-order instructions are reconstructed recursively with re-derived
    chunk types.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ...obs.trace import warn_event
from ..program import Builder, Instruction, Program, Register
from ..types import ItemType

#: dense-bucket plans beyond this domain size are never emitted — the
#: bucket table itself would dominate (the cost model would reject them
#: anyway; this is the hard memory guard)
MAX_DIRECT_BUCKETS = 1 << 20

#: composite-key packing budget of the sorted merge join (the runtime's
#: 32-bit packing limit):
#: under ``encode="dict"`` composites over this raw budget are packed as
#: dictionary *ranks* instead, lifting the 32-bit ceiling
PACK_LIMIT = 1 << 31


@dataclass
class Catalog:
    """Physical metadata for lowering.

    ``stats`` optionally carries a :class:`repro_torch.compiler.stats.Statistics`
    catalog (cardinality / NDV / bytes-per-row estimates); the compilation
    driver's cost model reads it to choose between alternative physical
    lowerings, and it is part of the plan-cache key.
    """

    capacities: Dict[str, int] = field(default_factory=dict)
    default_max_groups: int = 1024
    join_selectivity: float = 1.0  # output-capacity factor for joins
    stats: Optional[Any] = None   # repro_torch.compiler.stats.Statistics

    def capacity(self, table: str) -> int:
        if table not in self.capacities:
            raise KeyError(f"catalog has no capacity for table {table!r}")
        return self.capacities[table]


class LowerRelToVec:
    """Not a fixpoint rule: a single whole-program reconstruction.

    ``groupby`` selects the physical grouped-aggregation tier: ``"sorted"``
    (SortByKey + GroupAggSorted, always valid) or ``"direct"``
    (vec.GroupAggDirect dense buckets — used per instruction whenever the
    propagated statistics bound the key domain, falling back to sorted
    otherwise).

    ``join`` selects the physical join tier the same way: ``"sorted"``
    (SortByKey(build) + MergeJoinSorted, always valid) or ``"hash"``
    (vec.HashJoinDirect dense direct table — per instruction, when the
    statistics bound the joint key domain; unbounded-but-small domains get
    the dynamic-bounds variant with an in-trace fallback to sorted).

    ``encode`` extends both direct tiers to sparse and string keys:
    ``"raw"`` plans dense buckets only over raw catalog domain bounds
    (today's behavior), ``"dict"`` additionally re-encodes key columns to
    dense dictionary ranks ``[0, card)`` via ``vec.DictEncode`` whenever
    the raw domain is missing (string codes) or wider than the bucket
    budget, decoding only the surviving group/join key columns after the
    operator (decode-late).  A dictionary whose values are already
    contiguous needs no instructions at all — its bounds are used as the
    domain directly.  Under the sorted join tier, dictionary ranks also
    lift the 32-bit composite packing ceiling (``PACK_LIMIT``) by packing
    ranks instead of raw values.
    """

    name = "lower-rel-to-vec"

    def __init__(self, catalog: Catalog, groupby: str = "sorted",
                 join: str = "sorted", encode: str = "raw") -> None:
        if groupby not in ("sorted", "direct"):
            raise ValueError(f"unknown groupby tier {groupby!r}")
        if join not in ("sorted", "hash"):
            raise ValueError(f"unknown join tier {join!r}")
        if encode not in ("raw", "dict"):
            raise ValueError(f"unknown encode tier {encode!r}")
        self.catalog = catalog
        self.groupby = groupby
        self.join = join
        self.encode = encode
        self._env: Any = None  # StatsEnv over the SOURCE program tree

    def apply(self, program: Program, input_types: Optional[Sequence[ItemType]] = None) -> Program:
        if self.catalog.stats is not None:
            # propagate catalog statistics over the source tree once: the
            # per-register domain bounds are what make dense-bucket plans
            # (GroupAggDirect, packed join keys) derivable mid-program
            from ...compiler.stats import propagate
            self._env = propagate(program, self.catalog.stats)
        return self._lower(program, list(input_types or []) or None)

    # ------------------------------------------------------------------
    def _reg_domains(self, program: Program, reg: Register,
                     columns: Sequence[str]) -> Optional[Tuple[Tuple[int, int], ...]]:
        """Static (lo, hi) per column of a source-program register, if the
        propagated statistics bound every one of them."""
        if self._env is None:
            return None
        rs = self._env.get(program, reg)
        out = []
        for c in columns:
            d = rs.domain_of(c)
            if d is None:
                return None
            out.append((int(d[0]), int(d[1])))
        return tuple(out)

    # ------------------------------------------------------------------
    # dictionary-encoding planning
    # ------------------------------------------------------------------
    @staticmethod
    def _pick_size(pick) -> int:
        kind, val = pick
        return (int(val[1]) - int(val[0]) + 1) if kind == "raw" else val.card

    @staticmethod
    def _plan_from(cols, picks):
        """(specs, key_domains, num_buckets) from per-column picks.

        specs[i] is ``(col, Dictionary)`` when an encode instruction is
        needed, ``(col, None)`` when raw bounds (or a dense dictionary,
        whose ranks are just an offset) already give a dense domain."""
        specs, domains, nb = [], [], 1
        for c, (kind, val) in zip(cols, picks):
            if kind == "raw":
                domains.append((int(val[0]), int(val[1])))
                specs.append((c, None))
            elif val.dense:
                domains.append((int(val.lo), int(val.hi)))
                specs.append((c, None))
            else:
                domains.append((0, val.card - 1))
                specs.append((c, val))
            nb *= LowerRelToVec._pick_size((kind, val))
        return specs, tuple(domains), nb

    def _key_plan(self, cols, raws, dcs, budget, what="key"):
        """Choose per-column raw-bounds vs dictionary-rank domains.

        Raw bounds are preferred (no instructions); under ``encode="dict"``
        the smallest effective domain per column is tried when raw bounds
        are missing or the raw bucket product exceeds ``budget``.  Returns
        ``((specs, key_domains, num_buckets), None)`` on success, else
        ``(None, reason)`` — the reason states *why* encoding did not
        apply, so the downgrade is diagnosable from the warning alone.
        """
        nb_raw = None
        if all(c in raws for c in cols):
            picks = [("raw", raws[c]) for c in cols]
            nb_raw = 1
            for p in picks:
                nb_raw *= self._pick_size(p)
            if 0 < nb_raw <= budget:
                return self._plan_from(cols, picks), None
        if self.encode == "dict":
            picks, missing = [], None
            for c in cols:
                cands = []
                if c in raws:
                    cands.append(("raw", raws[c]))
                if c in dcs:
                    cands.append(("dict", dcs[c]))
                if not cands:
                    missing = c
                    break
                picks.append(min(cands, key=self._pick_size))
            if missing is None:
                nb = 1
                for p in picks:
                    nb *= self._pick_size(p)
                if 0 < nb <= budget:
                    return self._plan_from(cols, picks), None
                return None, (
                    f"{what} domain too large even as dictionary ranks "
                    f"({nb:,} buckets > {budget:,}) — dictionary over budget")
            return None, (f"unbounded {what} domain (no domain bounds or "
                          f"dictionary for {missing!r})")
        # encode == "raw": say whether "dict" would have helped
        if nb_raw is not None:
            hint = (" — dictionary available; strategy forced encode=raw"
                    if any(c in dcs for c in cols) else "")
            return None, (f"{what} domain too large ({nb_raw:,} buckets > "
                          f"{budget:,}){hint}")
        c = next(c for c in cols if c not in raws)
        if c in dcs:
            return None, (f"unbounded {what} domain (no raw bounds for "
                          f"{c!r}; dictionary available; strategy forced "
                          "encode=raw)")
        return None, (f"unbounded {what} domain (no domain bounds or "
                      f"dictionary for {c!r})")

    def _direct_key_plan(self, program: Program, reg: Register,
                         cols: Sequence[str], budget: int = MAX_DIRECT_BUCKETS,
                         what: str = "key"):
        if self._env is None:
            return None, f"unbounded {what} domain (no catalog statistics)"
        rs = self._env.get(program, reg)
        raws = {c: (int(d[0]), int(d[1]))
                for c in cols for d in (rs.domain_of(c),) if d is not None}
        dcs = {c: dc for c in cols
               for dc in (rs.dict_of(c),) if dc is not None and dc.card > 0}
        return self._key_plan(tuple(cols), raws, dcs, budget, what)

    def _join_key_plan(self, program: Program, ins: Instruction,
                       left_on: Sequence[str], right_on: Sequence[str],
                       budget: int):
        """Joint per-position plan over both join sides: raw bounds are the
        (min lo, max hi) envelope, dictionaries are the sorted union — the
        SAME static table on both sides, so equal values get equal ranks
        and probe keys missing from the build side simply find no match."""
        if self._env is None:
            return None, "unbounded join key domain (no catalog statistics)"
        ls = self._env.get(program, ins.inputs[0])
        rs = self._env.get(program, ins.inputs[1])
        labels = tuple(f"{lc}={rc}" for lc, rc in zip(left_on, right_on))
        raws, dcs = {}, {}
        for lab, lc, rc in zip(labels, left_on, right_on):
            ld, rd = ls.domain_of(lc), rs.domain_of(rc)
            if ld is not None and rd is not None:
                raws[lab] = (min(int(ld[0]), int(rd[0])),
                             max(int(ld[1]), int(rd[1])))
            dl, dr = ls.dict_of(lc), rs.dict_of(rc)
            if dl is not None and dr is not None:
                merged = dl.merge(dr)
                if merged.card > 0:
                    dcs[lab] = merged
        plan, reason = self._key_plan(labels, raws, dcs, budget,
                                      what="join key")
        if plan is None:
            return None, reason
        specs, domains, nb = plan
        enc_l = [(lc, d) for lc, (_, d) in zip(left_on, specs)]
        enc_r = [(rc, d) for rc, (_, d) in zip(right_on, specs)]
        return (enc_l, enc_r, domains, nb), None

    def _emit_encode(self, b: Builder, inp: Register, enc) -> Register:
        """vec.DictEncode for the (col, Dictionary) pairs that need one.

        Mode per column: a span-sized O(1) remap gather when the value
        range is small, log(card) searchsorted otherwise; the tables are
        static instruction params (they come from the catalog, not the
        data)."""
        import numpy as np
        cols, modes, tables, lows, cards = [], [], [], [], []
        for c, dc in [e for e in enc if e[1] is not None]:
            vals = np.asarray(dc.values)
            if vals.dtype.kind not in "iu":
                raise TypeError(
                    f"catalog dictionary for {c!r} holds non-integer values")
            fits32 = int(vals[0]) >= -(1 << 31) and int(vals[-1]) < (1 << 31)
            vals = vals.astype(np.int32 if fits32 else np.int64)
            span = int(dc.hi) - int(dc.lo) + 1
            if span <= MAX_DIRECT_BUCKETS:
                table = np.full(span, dc.card, np.int32)
                table[np.asarray(dc.values) - int(dc.lo)] = np.arange(
                    dc.card, dtype=np.int32)
                modes.append("remap")
                tables.append(table)
            else:
                modes.append("searchsorted")
                tables.append(vals)
            cols.append(c)
            lows.append(int(dc.lo))
            cards.append(dc.card)
        return b.emit1("vec.DictEncode", [inp], {
            "cols": tuple(cols), "modes": tuple(modes),
            "tables": tuple(tables), "lows": tuple(lows),
            "cards": tuple(cards)})

    @staticmethod
    def _emit_decode(b: Builder, out: Register, enc, src_schema) -> Register:
        """vec.DictDecode for surviving encoded key columns (decode-late:
        runs on the compacted operator output, never the full input)."""
        import numpy as np
        cols, tables, atoms = [], [], []
        for c, dc in [e for e in enc if e[1] is not None]:
            vals = np.asarray(dc.values)
            fits32 = int(vals[0]) >= -(1 << 31) and int(vals[-1]) < (1 << 31)
            cols.append(c)
            tables.append(vals.astype(np.int32 if fits32 else np.int64))
            atoms.append(src_schema.field(c))
        return b.emit1("vec.DictDecode", [out], {
            "cols": tuple(cols), "tables": tuple(tables),
            "atoms": tuple(atoms)})

    # ------------------------------------------------------------------
    def _remap_pred(self, e, schema):
        """Rewrite string-literal comparisons into global-code space.

        Physical string columns hold i32 global-dictionary rank codes, and
        rank order is lexicographic order, so every comparison maps to a
        code comparison: equality to the literal's exact rank (constant
        False/True when the literal is out of dictionary), ranges through
        the literal's insertion point.  Interp runs the un-lowered program
        and compares the raw strings directly — both paths agree.
        """
        from ...core.expr import _CMP, BinOp, Col, Const, UnOp
        from ...core.types import BOOL, I32

        stats = self.catalog.stats
        gd = getattr(stats, "global_dict", None) if stats is not None else None
        flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                "eq": "eq", "ne": "ne"}

        def is_str_col(x):
            return (isinstance(x, Col)
                    and getattr(schema.field(x.name), "domain", None) == "str")

        def remap(cmp_op, colx, lit):
            if gd is None:
                raise ValueError(
                    f"string literal {lit!r} in a predicate over physical "
                    "i32 codes needs the global string dictionary — compile "
                    "with catalog statistics (Context builds them "
                    "automatically for string tables)")
            if cmp_op in ("eq", "ne"):
                r = gd.rank_of(lit)
                if r is None:
                    return Const(cmp_op == "ne", BOOL)
                return BinOp(cmp_op, colx, Const(int(r), I32))
            if cmp_op in ("lt", "le"):
                bound = gd.insertion(lit, "left" if cmp_op == "lt" else "right")
                return BinOp("lt", colx, Const(int(bound), I32))
            bound = gd.insertion(lit, "right" if cmp_op == "gt" else "left")
            return BinOp("ge", colx, Const(int(bound), I32))

        def walk(x):
            if isinstance(x, BinOp):
                if x.op in _CMP:
                    l, r = x.lhs, x.rhs
                    if (is_str_col(l) and isinstance(r, Const)
                            and isinstance(r.value, str)):
                        return remap(x.op, l, r.value)
                    if (isinstance(l, Const) and isinstance(l.value, str)
                            and is_str_col(r)):
                        return remap(flip[x.op], r, l.value)
                return BinOp(x.op, walk(x.lhs), walk(x.rhs))
            if isinstance(x, UnOp):
                return UnOp(x.op, walk(x.arg))
            return x

        return walk(e)

    # ------------------------------------------------------------------
    def _check_pkfk(self, program: Program, ins: Instruction,
                    right_on: Sequence[str]) -> None:
        """Surface the physical joins' silent PK-FK assumption.

        Every vec join tier (sorted merge and dense direct table alike)
        produces at most ONE match per probe row — correct only when the
        build side's keys are unique.  When the propagated NDV says the
        build side has duplicate keys, or there are no statistics to check
        against, emit a structured warning instead of silently dropping
        matches (mirrors ``lower_vec.direct_unavailable``).
        """
        keys = ",".join(right_on)
        if self._env is None:
            warn_event("lower_vec.join_pkfk_unverified", keys=keys,
                       reason="no catalog statistics to verify build-side "
                              "key uniqueness")
            return
        rs = self._env.get(program, ins.inputs[1])
        distinct = 1.0
        for c in right_on:
            ndv = rs.ndv_of(c)
            if ndv is None:
                warn_event("lower_vec.join_pkfk_unverified", keys=keys,
                           reason=f"no NDV estimate for build key {c!r}")
                return
            distinct *= float(ndv)
        distinct = min(distinct, rs.rows)
        if distinct + 0.5 < rs.rows:
            warn_event(
                "lower_vec.join_pkfk_unverified", keys=keys,
                rows=int(rs.rows), distinct=int(distinct),
                reason=f"build side has ~{rs.rows:,.0f} rows but only "
                       f"~{distinct:,.0f} distinct keys — duplicate matches "
                       "will be dropped (PK-FK join keeps one per probe row)",
            )

    # ------------------------------------------------------------------
    def _lower(self, program: Program, new_input_types: Optional[List[ItemType]]) -> Program:
        b = Builder(program.name, prefix="v")
        regmap: Dict[str, Register] = {}
        for i, r in enumerate(program.inputs):
            t = new_input_types[i] if new_input_types else r.type
            regmap[r.name] = b.input(r.name, t)

        for ins in program.body:
            new_ins = [regmap[r.name] for r in ins.inputs]
            outs = self._lower_instruction(b, ins, new_ins, program)
            if len(outs) != len(ins.outputs):
                raise AssertionError(f"lowering {ins.opcode}: arity changed")
            for old, new in zip(ins.outputs, outs):
                regmap[old.name] = new

        return b.finish(*[regmap[r.name] for r in program.results])

    # ------------------------------------------------------------------
    def _lower_instruction(self, b: Builder, ins: Instruction,
                           inputs: List[Register], src_program: Program,
                           ) -> Sequence[Register]:
        params = dict(ins.params)
        op = ins.opcode

        if op == "rel.Scan":
            return b.emit("vec.ScanVec", [], {
                "table": params["table"],
                "schema": params["schema"],
                "max_count": self.catalog.capacity(params["table"]),
            })
        if op == "rel.Select":
            pred = self._remap_pred(params["pred"],
                                    ins.inputs[0].type.schema)
            return b.emit("vec.MaskSelect", inputs, {"pred": pred})
        if op == "rel.Proj":
            return b.emit("vec.ProjVec", inputs, {"names": tuple(params["names"])})
        if op == "rel.ExProj":
            schema = ins.inputs[0].type.schema
            exprs = tuple((n, self._remap_pred(e, schema))
                          for n, e in params["exprs"])
            if inputs[0].type.kind.name == "Single":
                return b.emit("vec.FinalizeSingle", inputs, {"exprs": exprs})
            return b.emit("vec.ExProjVec", inputs, {"exprs": exprs})
        if op == "rel.Aggr":
            return b.emit("vec.AggrVec", inputs, {"aggs": tuple(params["aggs"])})
        if op == "rel.GroupByAggr":
            keys = tuple(params["keys"])
            mg = int(params.get("max_groups") or self.catalog.default_max_groups)
            aggs = tuple(params["aggs"])
            if self.groupby == "direct":
                plan, reason = self._direct_key_plan(
                    src_program, ins.inputs[0], keys)
                if plan is not None:
                    specs, domains, n_buckets = plan
                    enc = [e for e in specs if e[1] is not None]
                    inp = inputs[0]
                    if enc:
                        inp = self._emit_encode(b, inp, enc)
                    out = b.emit1("vec.GroupAggDirect", [inp], {
                        "keys": keys, "aggs": aggs, "max_groups": mg,
                        "key_domains": domains, "num_buckets": n_buckets,
                    })
                    if enc:
                        out = self._emit_decode(
                            b, out, enc, ins.inputs[0].type.schema)
                    return [out]
                # unbounded / oversized key domain: the sorted tier is the
                # always-valid fallback — but the caller asked for direct, so
                # the downgrade is surfaced (with why encoding did not apply)
                # instead of happening silently
                warn_event(
                    "lower_vec.direct_unavailable",
                    keys=",".join(keys),
                    max_buckets=MAX_DIRECT_BUCKETS,
                    encode=self.encode,
                    reason=reason,
                )
            s = b.emit1("vec.SortByKey", inputs, {"keys": keys})
            return b.emit("vec.GroupAggSorted", [s], {
                "keys": keys, "aggs": aggs, "max_groups": mg,
            })
        if op == "rel.Join":
            left, right = inputs
            left_on = tuple(params["left_on"])
            right_on = tuple(params["right_on"])
            left_cap = left.type.attr("max_count")
            right_cap = right.type.attr("max_count")
            out_cap = int(left_cap * self.catalog.join_selectivity)
            self._check_pkfk(src_program, ins, right_on)
            join_params: Dict[str, Any] = {
                "left_on": left_on, "right_on": right_on, "max_count": out_cap,
            }
            # joint per-column bounds over both sides (packing must agree)
            ld = self._reg_domains(src_program, ins.inputs[0], left_on)
            rd = self._reg_domains(src_program, ins.inputs[1], right_on)
            joint = None
            if ld is not None and rd is not None:
                joint = tuple((min(a[0], c[0]), max(a[1], c[1]))
                              for a, c in zip(ld, rd))
            if self.join == "hash":
                jplan, jreason = self._join_key_plan(
                    src_program, ins, left_on, right_on, MAX_DIRECT_BUCKETS)
                if jplan is not None:
                    enc_l, enc_r, domains, n_buckets = jplan
                    need_l = [e for e in enc_l if e[1] is not None]
                    need_r = [e for e in enc_r if e[1] is not None]
                    probe = (self._emit_encode(b, left, need_l)
                             if need_l else left)
                    build = (self._emit_encode(b, right, need_r)
                             if need_r else right)
                    out = b.emit1("vec.HashJoinDirect", [probe, build], {
                        **join_params, "key_domains": domains,
                    })
                    if need_l:
                        # only the probe-side key columns survive the join
                        # schema — decode them back (decode-late)
                        out = self._emit_decode(
                            b, out, need_l, ins.inputs[0].type.schema)
                    return [out]
                if joint is None:
                    # unbounded raw domain and no static dictionary plan:
                    # dynamic-bounds variant — the bucket budget is static,
                    # the fit check and the fallback to the sorted merge
                    # happen inside the trace per instruction
                    budget = min(MAX_DIRECT_BUCKETS, max(4 * int(right_cap), 1024))
                    return b.emit("vec.HashJoinDirect", [left, right], {
                        **join_params, "num_buckets": budget,
                    })
                # bounded but oversized (even as dictionary ranks, or with
                # encoding forced off): surface the downgrade to sorted with
                # the reason (mirrors lower_vec.direct_unavailable)
                warn_event(
                    "lower_vec.hash_unavailable",
                    keys=",".join(left_on),
                    max_buckets=MAX_DIRECT_BUCKETS,
                    encode=self.encode,
                    reason=jreason,
                )
            if len(left_on) > 1:
                raw_fits = joint is not None
                if raw_fits:
                    nb = 1
                    for lo, hi in joint:
                        nb *= hi - lo + 1
                    raw_fits = 0 < nb <= PACK_LIMIT
                if raw_fits:
                    # catalog bounds let the composite key pack without
                    # 16-bit truncation (joint bounds over both sides)
                    join_params["key_domains"] = joint
                elif self.encode == "dict":
                    # raw product over the 32-bit packing ceiling (or
                    # unbounded): pack dictionary *ranks* instead — the rank
                    # product is the card product, which may fit where raw
                    # spans cannot
                    jplan, _ = self._join_key_plan(
                        src_program, ins, left_on, right_on, PACK_LIMIT)
                    if jplan is not None:
                        enc_l, enc_r, domains, _nb = jplan
                        need_l = [e for e in enc_l if e[1] is not None]
                        need_r = [e for e in enc_r if e[1] is not None]
                        if need_l:
                            left = self._emit_encode(b, left, need_l)
                        if need_r:
                            right = self._emit_encode(b, right, need_r)
                        join_params["key_domains"] = domains
                        rs = b.emit1("vec.SortByKey", [right],
                                     {"keys": right_on})
                        out = b.emit1("vec.MergeJoinSorted", [left, rs],
                                      join_params)
                        if need_l:
                            out = self._emit_decode(
                                b, out, need_l, ins.inputs[0].type.schema)
                        return [out]
            rs = b.emit1("vec.SortByKey", [right], {"keys": right_on})
            return b.emit("vec.MergeJoinSorted", [left, rs], join_params)
        if op == "rel.OrderBy":
            keys = tuple(params["keys"])
            asc = tuple(params.get("ascending") or (True,) * len(keys))
            return b.emit("vec.SortByKey", inputs, {"keys": keys, "ascending": asc})
        if op == "rel.Limit":
            return b.emit("vec.LimitVec", inputs, {"k": int(params["k"])})
        if op == "rel.CombinePartials":
            return b.emit(op, inputs, params)

        # higher-order instructions: reconstruct nested programs with the
        # chunk types of the (already lowered) new inputs
        if op in ("cf.ConcurrentExecute", "mesh.MeshExecute"):
            p: Program = params["P"]
            chunk_types = [r.type.item for r in inputs]
            params["P"] = self._lower(p, chunk_types)
            return b.emit(op, inputs, params)
        if op in ("cf.Loop", "cf.While"):
            p = params["P"]
            params["P"] = self._lower(p, [r.type for r in inputs])
            return b.emit(op, inputs, params)
        if op == "cf.Cond":
            then_types = [r.type for r in inputs[1:]]
            params["Pthen"] = self._lower(params["Pthen"], then_types)
            params["Pelse"] = self._lower(params["Pelse"], then_types)
            return b.emit(op, inputs, params)
        if op == "cf.Call":
            params["P"] = self._lower(params["P"], [r.type for r in inputs])
            return b.emit(op, inputs, params)
        if op == "df.Map":
            p = params["P"]
            params["P"] = self._lower(p, [inputs[0].type.item])
            return b.emit(op, inputs, params)

        # default: re-emit unchanged (cf.Split/Merge/Broadcast/CombineChunks,
        # la.*, unknown flavors) — typing rules recompute the physical types
        from .. import registry
        if registry.lookup(op) is None:
            return b.emit(op, inputs, params, out_types=[o.type for o in ins.outputs])
        return b.emit(op, inputs, params)
