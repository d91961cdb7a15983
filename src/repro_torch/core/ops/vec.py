"""Physical vector flavor (paper Table 2, bottom): backend building blocks.

Low-level philosophy (paper §3.4): operators as small as possible —
"cleverness as a sophisticated combination of simple operators".  Physical
collections are ``Vec``s: padded fixed-capacity column blocks with a count
(static shapes are the TPU adaptation; see DESIGN.md §2).

``BuildHTable``/``ProbeHTable`` exist for IR completeness (they are the
paper's canonical low-level pair); the TPU backend *rewrites* them into
sort/searchsorted sequences because random scatter is not MXU-friendly.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple

from ..expr import AggSpec, Expr
from ..registry import op
from ..types import (
    BAG, SEQ,
    Atom, CollectionType, HTab, I32, ItemType, Single, TupleType, Vec, is_coll,
)
from .controlflow import split_type
from .relational import join_schema


def _vec(t: ItemType) -> CollectionType:
    if not is_coll(t) or t.kind.name != "Vec":
        raise TypeError(f"expected Vec, got {t.render()}")
    return t  # type: ignore[return-value]


def _cap(t: CollectionType) -> int:
    c = t.attr("max_count")
    if c is None:
        raise TypeError(f"Vec without static capacity: {t.render()}")
    return int(c)


@op("vec.ScanVec", source=True)
def _scanvec(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ScanVec(table, schema, max_count) → Vec⟨T⟩ — materialized column block."""
    return [Vec(params["schema"], params["max_count"])]


@op("vec.MatVec")
def _matvec(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """MatVec()(C) → Vec — materialize any collection into a vector block."""
    (c,) = ins
    if not is_coll(c):
        raise TypeError("MatVec of non-collection")
    cap = params.get("max_count") or c.attr("max_count")
    return [Vec(c.item, cap)]


@op("vec.SplitVec")
def _splitvec(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """SplitVec(n)(Vec⟨I⟩) → Seq[n]⟨Vec⟨I⟩⟩ — even range partition."""
    v = _vec(ins[0])
    n = int(params["n"])
    cap = _cap(v)
    if cap % n != 0:
        raise TypeError(f"SplitVec: capacity {cap} not divisible by {n}")
    return [split_type(Vec(v.item, cap // n), n)]


@op("vec.ConcatVec")
def _concatvec(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ConcatVec()(Seq[n]⟨Vec⟨I⟩⟩) → Vec⟨I⟩."""
    (s,) = ins
    if not is_coll(s, SEQ) or not is_coll(s.item):
        raise TypeError("ConcatVec of non-split vec")
    inner = _vec(s.item)
    n = s.attr("n")
    return [Vec(inner.item, _cap(inner) * int(n))]


@op("vec.MaskSelect", elementwise=True)
def _maskselect(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """MaskSelect(pred)(Vec⟨T⟩) → Vec⟨T⟩ — late-materialized (predicated) select.

    Capacity unchanged; only the validity mask is narrowed.  This is the TPU
    analogue of the paper's "predicated scan" low-level technique.
    """
    v = _vec(ins[0])
    pred: Expr = params["pred"]
    if pred.infer(v.schema).domain != "bool":
        raise TypeError("MaskSelect predicate not boolean")
    return [v]


@op("vec.Compact")
def _compact(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Compact()(Vec⟨T⟩) → Vec⟨T⟩ — densify valid rows to the front.

    Inserted by the selectivity-aware rewrite when a selective filter pays
    for the shuffle (sort by ~validity).
    """
    v = _vec(ins[0])
    cap = params.get("max_count")
    return [Vec(v.item, int(cap) if cap else _cap(v))]


@op("vec.ProjVec", elementwise=True)
def _projvec(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ProjVec(names)(Vec⟨T⟩) → Vec⟨T'⟩ — drop columns (free: layout is SoA)."""
    v = _vec(ins[0])
    return [Vec(v.schema.project(tuple(params["names"])), _cap(v))]


@op("vec.ExProjVec", elementwise=True)
def _exprojvec(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ExProjVec(exprs)(Vec⟨T⟩) → Vec⟨T'⟩ — compute new columns."""
    v = _vec(ins[0])
    exprs: Tuple[Tuple[str, Expr], ...] = tuple(params["exprs"])
    fields = tuple((n, e.infer(v.schema)) for n, e in exprs)
    return [Vec(TupleType(fields), _cap(v))]


@op("vec.AggrVec", aggregation={"kind": "scalar"})
def _aggrvec(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """AggrVec(aggs)(Vec⟨T⟩) → Single⟨aggs⟩ — masked block aggregation."""
    v = _vec(ins[0])
    aggs: Tuple[AggSpec, ...] = tuple(params["aggs"])
    fields = tuple((a.name, a.result_atom(v.schema)) for a in aggs)
    return [Single(TupleType(fields))]


@op("vec.FusedSelectAgg", aggregation={"kind": "scalar"})
def _fused_select_agg(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """FusedSelectAgg(pred, aggs)(Vec⟨T⟩) → Single⟨aggs⟩.

    Single-pass select+project+aggregate pipeline — the shape JITQ compiles
    TPC-H Q6 into.  Lowered to the ``fused_select_agg`` CUDA kernel.
    """
    v = _vec(ins[0])
    pred: Expr = params["pred"]
    if pred.infer(v.schema).domain != "bool":
        raise TypeError("FusedSelectAgg predicate not boolean")
    aggs: Tuple[AggSpec, ...] = tuple(params["aggs"])
    fields = tuple((a.name, a.result_atom(v.schema)) for a in aggs)
    return [Single(TupleType(fields))]


@op("vec.FinalizeSingle")
def _finalize_single(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """FinalizeSingle(exprs)(Single⟨T⟩) → Single⟨T'⟩ — scalar post-arithmetic.

    Finalizes decomposed aggregates (avg = sum/count, ratios, ...)."""
    (s,) = ins
    if not is_coll(s) or s.kind.name != "Single":
        raise TypeError(f"FinalizeSingle of non-Single {s.render()}")
    exprs: Tuple[Tuple[str, Expr], ...] = tuple(params["exprs"])
    fields = tuple((n, e.infer(s.schema)) for n, e in exprs)
    return [Single(TupleType(fields))]


@op("vec.SortByKey")
def _sortbykey(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """SortByKey(keys)(Vec⟨T⟩) → Vec⟨T⟩ (valid rows first, stable)."""
    v = _vec(ins[0])
    return [v.with_kind(v.kind)]


@op("vec.GroupAggSorted", aggregation={"kind": "grouped"})
def _groupagg_sorted(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """GroupAggSorted(keys, aggs, max_groups)(Vec⟨T⟩) → Vec⟨keys+aggs⟩.

    Grouped aggregation over key-sorted input via segment reduction — the
    sort-based replacement for hash aggregation (the sorted tier, which
    this package does not execute yet).
    """
    v = _vec(ins[0])
    keys: Tuple[str, ...] = tuple(params["keys"])
    aggs: Tuple[AggSpec, ...] = tuple(params["aggs"])
    fields = tuple((k, v.schema.field(k)) for k in keys)
    fields += tuple((a.name, a.result_atom(v.schema)) for a in aggs)
    return [Vec(TupleType(fields), int(params["max_groups"]))]


@op("vec.GroupAggDirect", aggregation={"kind": "grouped"})
def _groupagg_direct(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """GroupAggDirect(keys, aggs, max_groups, key_domains, num_buckets[, pred])
    (Vec⟨T⟩) → Vec⟨keys+aggs⟩.

    The sort-FREE grouped aggregation: when catalog statistics bound the
    composite key domain (``key_domains`` = per-key (lo, hi)), each row's
    group is a static function of its key values, so the backend
    segment-reduces straight into ``num_buckets`` dense buckets — O(n), no
    sort, no gather — and compacts non-empty buckets to ``max_groups``.
    The optional ``pred`` is a fused MaskSelect predicate (lowered to the
    ``grouped_select_agg`` CUDA kernel under ``use_kernels``).
    """
    v = _vec(ins[0])
    keys: Tuple[str, ...] = tuple(params["keys"])
    key_domains = tuple(params["key_domains"])
    if len(key_domains) != len(keys):
        raise TypeError("GroupAggDirect: key_domains must match keys")
    n_buckets = 1
    for lo, hi in key_domains:
        n_buckets *= int(hi) - int(lo) + 1
    if int(params["num_buckets"]) != n_buckets:
        raise TypeError(
            f"GroupAggDirect: num_buckets {params['num_buckets']} does not "
            f"match key domain product {n_buckets}")
    pred = params.get("pred")
    if pred is not None and pred.infer(v.schema).domain != "bool":
        raise TypeError("GroupAggDirect predicate not boolean")
    aggs: Tuple[AggSpec, ...] = tuple(params["aggs"])
    fields = tuple((k, v.schema.field(k)) for k in keys)
    fields += tuple((a.name, a.result_atom(v.schema)) for a in aggs)
    return [Vec(TupleType(fields), int(params["max_groups"]))]


@op("vec.DictEncode", elementwise=True)
def _dictencode(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """DictEncode(cols, modes, tables, lows, cards)(Vec⟨T⟩) → Vec⟨T'⟩.

    Re-encodes key columns to dense dictionary ranks ``[0, card)`` so the
    sort-free direct tiers apply to sparse/wide key domains.  Per column:
    ``mode`` is ``"remap"`` (O(1) gather through a span-sized rank table)
    or ``"searchsorted"`` (log(card) binary search in the sorted value
    table); out-of-dictionary values get the sentinel rank ``card`` —
    outside every declared rank domain, so a direct probe can never alias a
    real bucket.  Encoded columns become i32.
    """
    v = _vec(ins[0])
    cols = tuple(params["cols"])
    if not cols:
        raise TypeError("DictEncode with no columns")
    for name in ("modes", "tables", "lows", "cards"):
        if len(tuple(params[name])) != len(cols):
            raise TypeError(f"DictEncode: {name} must match cols")
    for c in cols:
        v.schema.field(c)  # raises on unknown column
    enc = set(cols)
    fields = tuple((n, I32 if n in enc else t) for n, t in v.schema.fields)
    return [Vec(TupleType(fields), _cap(v))]


@op("vec.DictDecode", elementwise=True)
def _dictdecode(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """DictDecode(cols, tables, atoms)(Vec⟨T⟩) → Vec⟨T'⟩.

    Gathers ranks back to raw values through the sorted value tables —
    applied *decode-late*: only to surviving group/join key columns after
    compaction, never to full inputs.  ``atoms`` restores each column's
    pre-encoding atom.
    """
    v = _vec(ins[0])
    cols = tuple(params["cols"])
    atoms = tuple(params["atoms"])
    if len(tuple(params["tables"])) != len(cols) or len(atoms) != len(cols):
        raise TypeError("DictDecode: tables/atoms must match cols")
    back = dict(zip(cols, atoms))
    for c in cols:
        v.schema.field(c)
    fields = tuple((n, back.get(n, t)) for n, t in v.schema.fields)
    return [Vec(TupleType(fields), _cap(v))]


@op("vec.BuildHTable")
def _buildhtable(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """BuildHTable()(Vec⟨T⟩) → Single⟨HTab⟨T⟩⟩ (keys = params['keys'])."""
    v = _vec(ins[0])
    return [Single(HTab(v.item))]


@op("vec.ProbeHTable")
def _probehtable(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ProbeHTable(left_on, right_on, max_count)(Vec⟨T1⟩, Single⟨HTab⟨T2⟩⟩) → Vec⟨T3⟩."""
    probe = _vec(ins[0])
    ht = ins[1]
    if not is_coll(ht) or not is_coll(ht.item):
        raise TypeError("ProbeHTable second input must be Single⟨HTab⟩")
    build_item = ht.item.item
    schema = join_schema(probe.schema, build_item, tuple(params["left_on"]), tuple(params["right_on"]))
    return [Vec(schema, int(params["max_count"]))]


@op("vec.MergeJoinSorted")
def _mergejoin(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """MergeJoinSorted(left_on, right_on, max_count)(Vec⟨L⟩, Vec⟨R⟩) → Vec⟨L⋈R⟩.

    Sort-based equi-join (searchsorted + gather) — the TPU-native rewrite
    target of BuildHTable+ProbeHTable.  ``max_count`` is the static output
    bound (for FK joins: the probe-side capacity).
    """
    l, r = _vec(ins[0]), _vec(ins[1])
    schema = join_schema(l.schema, r.schema, tuple(params["left_on"]), tuple(params["right_on"]))
    return [Vec(schema, int(params["max_count"]))]


@op("vec.HashJoinDirect")
def _hashjoin_direct(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """HashJoinDirect(left_on, right_on, max_count[, key_domains | num_buckets])
    (Vec⟨L⟩, Vec⟨R⟩) → Vec⟨L⋈R⟩.

    Sort-free PK-FK equi-join: the build side scatters into a dense direct
    table over the composite key domain and every probe is one gather — no
    sort, no searchsorted (the join sibling of GroupAggDirect).  With static
    ``key_domains`` the table size is the domain product; without, the
    bounds are traced jointly from the data against a static ``num_buckets``
    budget, with a per-instruction in-trace fallback to the sorted merge.
    """
    l, r = _vec(ins[0]), _vec(ins[1])
    left_on = tuple(params["left_on"])
    right_on = tuple(params["right_on"])
    key_domains = params.get("key_domains")
    if key_domains is not None:
        if len(tuple(key_domains)) != len(left_on):
            raise TypeError("HashJoinDirect: key_domains must match join keys")
        n_buckets = 1
        for lo, hi in key_domains:
            n_buckets *= int(hi) - int(lo) + 1
        if n_buckets <= 0:
            raise TypeError("HashJoinDirect: empty key domain")
    elif params.get("num_buckets") is None:
        raise TypeError("HashJoinDirect needs key_domains or a num_buckets "
                        "budget for the dynamic-bounds variant")
    schema = join_schema(l.schema, r.schema, left_on, right_on)
    return [Vec(schema, int(params["max_count"]))]


@op("vec.FusedJoinGroupAgg", aggregation={"kind": "grouped"})
def _fused_join_group_agg(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """FusedJoinGroupAgg(pred, left_on, right_on, join_key_domains,
    join_num_buckets, keys, aggs, max_groups, key_domains, num_buckets)
    (Vec⟨L⟩, Vec⟨R⟩) → Vec⟨keys+aggs⟩.

    Whole-pipeline select→join→group operator: the probe-side predicate,
    the direct-table probe and the dense grouped reduction run in a single
    pass — the join result is never materialized (no intermediate Vec, no
    compact).  Both the join key domain and the group key domain must be
    statically bounded; the ``grouped_join_agg`` CUDA kernel backs it
    under ``use_kernels``.
    """
    l, r = _vec(ins[0]), _vec(ins[1])
    left_on = tuple(params["left_on"])
    right_on = tuple(params["right_on"])
    jkd = tuple(params["join_key_domains"])
    if len(jkd) != len(left_on):
        raise TypeError("FusedJoinGroupAgg: join_key_domains must match join keys")
    njb = 1
    for lo, hi in jkd:
        njb *= int(hi) - int(lo) + 1
    if int(params["join_num_buckets"]) != njb:
        raise TypeError(
            f"FusedJoinGroupAgg: join_num_buckets {params['join_num_buckets']} "
            f"does not match join key domain product {njb}")
    joined = join_schema(l.schema, r.schema, left_on, right_on)
    pred = params.get("pred")
    if pred is not None:
        if pred.infer(l.schema).domain != "bool":
            raise TypeError("FusedJoinGroupAgg predicate not boolean")
    keys: Tuple[str, ...] = tuple(params["keys"])
    key_domains = tuple(params["key_domains"])
    if len(key_domains) != len(keys):
        raise TypeError("FusedJoinGroupAgg: key_domains must match keys")
    ngb = 1
    for lo, hi in key_domains:
        ngb *= int(hi) - int(lo) + 1
    if int(params["num_buckets"]) != ngb:
        raise TypeError(
            f"FusedJoinGroupAgg: num_buckets {params['num_buckets']} does not "
            f"match group key domain product {ngb}")
    aggs: Tuple[AggSpec, ...] = tuple(params["aggs"])
    fields = tuple((k, joined.field(k)) for k in keys)
    fields += tuple((a.name, a.result_atom(joined)) for a in aggs)
    return [Vec(TupleType(fields), int(params["max_groups"]))]


@op("vec.LimitVec")
def _limitvec(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """LimitVec(k)(Vec⟨T⟩) → Vec⟨T⟩ — keep the first k valid rows."""
    v = _vec(ins[0])
    return [v]


@op("vec.TopKVec")
def _topk(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """TopKVec(keys, ascending, k)(Vec⟨T⟩) → Vec⟨T⟩[k]."""
    v = _vec(ins[0])
    return [Vec(v.item, int(params["k"]))]


@op("vec.HistogramPartition")
def _histpart(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """HistogramPartition(key, n)(Vec⟨T⟩) → Seq[n]⟨Vec⟨T⟩⟩.

    Radix/range partition by key — the building block of the distributed
    Exchange (paper: MPIHistogram + MPIExchange).  Per-partition capacity is
    the full input capacity (worst-case skew) unless ``per_cap`` given.
    """
    v = _vec(ins[0])
    n = int(params["n"])
    cap = int(params.get("per_cap") or _cap(v))
    return [split_type(Vec(v.item, cap), n)]


# ---------------------------------------------------------------------------
# streaming state (micro-batched incremental execution)
# ---------------------------------------------------------------------------


@op("vec.MergeGroupedState", aggregation={"kind": "grouped"})
def _merge_grouped_state(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """MergeGroupedState(keys, aggs, max_groups[, key_domains, num_buckets])
    (Vec⟨keys+aggs⟩, Vec⟨keys+aggs⟩) → Vec⟨keys+aggs⟩.

    The streaming merge op: fold a micro-batch's grouped *partial*
    aggregate (delta) into the running state.  Both operands and the result
    share one schema and capacity ``max_groups`` — the op is the carried
    accumulator of the streaming target's step function.  ``aggs`` are the
    ORIGINAL AggSpecs; the backend combines each partial column with its
    ``combine_fn`` (sum-of-sums, sum-of-counts, min-of-mins).  With
    ``key_domains``/``num_buckets`` the merge runs on the sort-free dense
    buckets (the GroupAggDirect accumulator carried across batches).
    """
    state, delta = _vec(ins[0]), _vec(ins[1])
    if state.item != delta.item:
        raise TypeError(
            f"MergeGroupedState: state schema {state.render()} != delta "
            f"schema {delta.render()}")
    keys: Tuple[str, ...] = tuple(params["keys"])
    aggs: Tuple[AggSpec, ...] = tuple(params["aggs"])
    names = set(state.schema.names)
    for k in keys:
        if k not in names:
            raise TypeError(f"MergeGroupedState: key {k!r} not in state schema")
    for a in aggs:
        if a.name not in names:
            raise TypeError(f"MergeGroupedState: agg {a.name!r} not in state schema")
    key_domains = params.get("key_domains")
    if key_domains is not None and len(tuple(key_domains)) != len(keys):
        raise TypeError("MergeGroupedState: key_domains must match keys")
    return [Vec(state.item, int(params["max_groups"]))]


@op("vec.MergeScalarState", aggregation={"kind": "scalar"})
def _merge_scalar_state(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """MergeScalarState(aggs)(Single⟨aggs⟩, Single⟨aggs⟩) → Single⟨aggs⟩.

    Scalar sibling of MergeGroupedState: combine two Single partial
    aggregates field-wise with each agg's ``combine_fn``.
    """
    state, delta = ins
    for s in (state, delta):
        if not is_coll(s) or s.kind.name != "Single":
            raise TypeError(f"MergeScalarState of non-Single {s.render()}")
    if state.item != delta.item:
        raise TypeError("MergeScalarState: state/delta schema mismatch")
    names = set(state.schema.names)
    for a in tuple(params["aggs"]):
        if a.name not in names:
            raise TypeError(f"MergeScalarState: agg {a.name!r} not in state schema")
    return [Single(state.schema)]
