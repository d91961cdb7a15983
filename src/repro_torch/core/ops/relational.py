"""Relational IR flavor (paper Table 2, top).

High-level, domain-specific instructions for (bag/set/seq) relational
algebra.  These are what the SQL/dataflow frontends produce; rewritings
lower them into ``vec.*`` physical instructions.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple

from ..expr import AggSpec, Expr
from ..registry import op
from ..types import (
    BAG, SEQ, SET,
    Atom, Bag, CollectionType, I64, ItemType, Single, TupleType,
    common_kind, is_coll, schema_of,
)


def _rel(t: ItemType) -> CollectionType:
    if not is_coll(t) or not isinstance(t.item, TupleType):  # type: ignore[union-attr]
        raise TypeError(f"expected a relation (collection of tuples), got {t.render()}")
    return t  # type: ignore[return-value]


@op("rel.Scan", source=True)
def _scan(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Scan(table, schema, kind) → relation. Data source (orchestration layer)."""
    schema: TupleType = params["schema"]
    kind = params.get("kind", BAG)
    return [CollectionType(kind, schema)]


@op("rel.Select", elementwise=True)
def _select(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Select(p)(C) → C — keep tuples where p holds; kind preserved."""
    c = _rel(ins[0])
    pred: Expr = params["pred"]
    if pred.infer(c.schema).domain != "bool":
        raise TypeError("Select predicate is not boolean")
    return [c]


@op("rel.Proj", elementwise=True)
def _proj(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Proj(A1..Ak)(C) — restrict to fields; Set→Set, Seq→Seq, else Bag."""
    c = _rel(ins[0])
    names: Tuple[str, ...] = tuple(params["names"])
    item = c.schema.project(names)
    kind = c.kind if c.kind in (SET, SEQ) else BAG
    return [CollectionType(kind, item)]


@op("rel.ExProj", elementwise=True)
def _exproj(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ExProj({A'i ← fi})(C) — compute new fields; Seq→Seq, Single→Single, else Bag."""
    c = _rel(ins[0])
    exprs: Tuple[Tuple[str, Expr], ...] = tuple(params["exprs"])
    fields = tuple((n, e.infer(c.schema)) for n, e in exprs)
    kind = SEQ if c.kind is SEQ else c.kind if c.kind.name == "Single" else BAG
    return [CollectionType(kind, TupleType(fields))]


@op("rel.Aggr", aggregation={"kind": "scalar"})
def _aggr(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Aggr({(fn, expr) → A})(C) → Single⟨A1,...⟩ — full-collection aggregation.

    Every agg is decomposable (see AggSpec); the parallelization rewrite
    copies this instruction inside ConcurrentExecute as a pre-aggregation and
    re-aggregates partials with the combine fns (paper Alg. 2).
    """
    c = _rel(ins[0])
    aggs: Tuple[AggSpec, ...] = tuple(params["aggs"])
    fields = tuple((a.name, a.result_atom(c.schema)) for a in aggs)
    return [Single(TupleType(fields))]


@op("rel.GroupByAggr", aggregation={"kind": "grouped"})
def _groupby(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """GroupByAggr(keys, aggs)(C) → Bag⟨keys..., aggs...⟩."""
    c = _rel(ins[0])
    keys: Tuple[str, ...] = tuple(params["keys"])
    aggs: Tuple[AggSpec, ...] = tuple(params["aggs"])
    fields = tuple((k, c.schema.field(k)) for k in keys)
    fields += tuple((a.name, a.result_atom(c.schema)) for a in aggs)
    return [Bag(TupleType(fields))]


def join_schema(left: TupleType, right: TupleType, left_on: Sequence[str],
                right_on: Sequence[str]) -> TupleType:
    """Left fields + right fields minus right keys; collisions suffixed ``_r``."""
    fields = list(left.fields)
    names = {n for n, _ in fields}
    for n, t in right.fields:
        if n in right_on:
            continue
        nn = n if n not in names else n + "_r"
        names.add(nn)
        fields.append((nn, t))
    return TupleType(tuple(fields))


@op("rel.Join")
def _join(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Join(left_on, right_on, how="inner")(L, R) → Bag⟨L ⋈ R⟩."""
    l, r = _rel(ins[0]), _rel(ins[1])
    left_on = tuple(params["left_on"])
    right_on = tuple(params["right_on"])
    if len(left_on) != len(right_on):
        raise TypeError("Join key arity mismatch")
    for lk, rk in zip(left_on, right_on):
        if l.schema.field(lk) != r.schema.field(rk):
            raise TypeError(f"Join key type mismatch on {lk}/{rk}")
    return [Bag(join_schema(l.schema, r.schema, left_on, right_on))]


@op("rel.CombinePartials")
def _combine_partials(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """CombinePartials(aggs)(Seq[n]⟨Single⟨T⟩⟩) → Single⟨T⟩.

    Re-aggregates per-worker scalar pre-aggregates with each agg's combine
    fn (count→sum, sum→sum, min→min, max→max).  Introduced by the
    pre-aggregation step of the parallelization rewrite (paper Alg. 2).
    """
    (s,) = ins
    if not is_coll(s, SEQ) or not is_coll(s.item):
        raise TypeError(f"CombinePartials of non-split type {s.render()}")
    return [s.item]


@op("rel.OrderBy")
def _orderby(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """OrderBy(keys, ascending)(C) → Seq⟨item⟩."""
    c = _rel(ins[0])
    return [CollectionType(SEQ, c.item)]


@op("rel.Limit")
def _limit(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Limit(k)(C) → C (first k; requires Seq for determinism)."""
    c = _rel(ins[0])
    return [c]


@op("rel.Distinct")
def _distinct(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Distinct()(C) → Set⟨item⟩."""
    c = _rel(ins[0])
    return [CollectionType(SET, c.item)]
