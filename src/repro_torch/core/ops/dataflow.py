"""Generic dataflow flavor — the paper's generic Python frontend.

Works on arbitrary item types (not just tuples of atoms); ``df.Map`` is the
higher-order workhorse.  The k-means frontend and the quickstart example use
this flavor mixed with ``rel.*``/``la.*`` instructions — mixing flavors in
one program is the point of the shared IR language.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from ..program import Program
from ..registry import op
from ..types import BAG, SEQ, CollectionType, ItemType, Single, is_coll


@op("df.Source", source=True)
def _source(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Source(name, type) — named external collection."""
    return [params["type"]]


@op("df.Literal", source=True)
def _literal(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Literal(value, type) — constant collection baked into the program."""
    return [params["type"]]


@op("df.Map", elementwise=True)
def _map(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Map(P: I1 → I2)(C) → Bag⟨I2⟩ (Seq→Seq) — per-item transformation."""
    (c,) = ins
    if not is_coll(c):
        raise TypeError(f"Map over non-collection {c.render()}")
    p: Program = params["P"]
    if len(p.inputs) != 1 or len(p.results) != 1:
        raise TypeError("Map program must be I1 → I2")
    if p.inputs[0].type != c.item:
        raise TypeError(
            f"Map program input {p.inputs[0].type.render()} != item {c.item.render()}"
        )
    kind = SEQ if c.kind is SEQ else BAG
    return [CollectionType(kind, p.results[0].type)]


@op("df.Reduce", aggregation={"kind": "generic"})
def _reduce(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Reduce(P: (I,I) → I [assoc+comm])(C) → Single⟨I⟩."""
    (c,) = ins
    if not is_coll(c):
        raise TypeError("Reduce over non-collection")
    p: Program = params["P"]
    ok = (
        len(p.inputs) == 2
        and len(p.results) == 1
        and p.inputs[0].type == p.inputs[1].type == p.results[0].type == c.item
    )
    if not ok:
        raise TypeError("Reduce program must be (I, I) → I over the item type")
    return [Single(c.item)]


@op("df.Zip")
def _zip(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Zip()(Seq⟨A⟩, Seq⟨B⟩) → Seq⟨⟨l:A, r:B⟩⟩."""
    from ..types import TupleType

    a, b = ins
    if not (is_coll(a, SEQ) and is_coll(b, SEQ)):
        raise TypeError("Zip requires Seq inputs")
    return [CollectionType(SEQ, TupleType.of(l=a.item, r=b.item))]


@op("df.Collect", sink=True)
def _collect(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Collect()(C) → C — marks a result for host materialization."""
    return [ins[0]]
