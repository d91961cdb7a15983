"""CVM item/collection type grammar.

The paper (§3.2) defines::

    item := atom | tuple of items | collection of items

where an *atom* is an indivisible value of a domain, a *tuple* is a mapping
from names to items, and a *collection* is any (abstract or physical) data
type holding a finite homogeneous multiset of items.

This module implements that grammar as immutable, hashable Python objects.
Collection *kinds* are open-ended (the IR language fixes *how* collection
types look, not *which* exist): new kinds register themselves via
``CollectionKind``.  Abstract kinds (Set/Bag/Seq/KDSeq) model frontend
domains; physical kinds (Vec/Single/ArrayN/HTab) model backend layouts;
``Tensor`` is the custom collection type used by the LM/tensor flavor
(a kDSeq with static shape + dtype, which is what XLA needs).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Atoms
# ---------------------------------------------------------------------------

#: atom domains understood by the JAX lowering.  ``date`` is an i32 epoch-day
#: and ``str`` a dictionary-encoded i32 (documented TPU adaptation).
ATOM_DOMAINS: Dict[str, str] = {
    "bool": "bool_",
    "i8": "int8",
    "i16": "int16",
    "i32": "int32",
    "i64": "int64",
    "u32": "uint32",
    "f16": "float16",
    "bf16": "bfloat16",
    "f32": "float32",
    "f64": "float64",
    "date": "int32",
    "str": "int32",
    "id": "int32",
    "num": "float32",
}


class ItemType:
    """Base class of all item types."""

    def is_atom(self) -> bool:
        return isinstance(self, Atom)

    def is_tuple(self) -> bool:
        return isinstance(self, TupleType)

    def is_collection(self) -> bool:
        return isinstance(self, CollectionType)

    # rendered by subclasses
    def __repr__(self) -> str:  # pragma: no cover - trivial
        return self.render()

    def render(self) -> str:
        raise NotImplementedError


@dataclass(frozen=True)
class Atom(ItemType):
    """An indivisible value of a particular domain."""

    domain: str

    def __post_init__(self) -> None:
        if self.domain not in ATOM_DOMAINS:
            raise TypeError(f"unknown atom domain {self.domain!r}")

    @property
    def np_dtype(self) -> str:
        return ATOM_DOMAINS[self.domain]

    def render(self) -> str:
        return self.domain


# common atoms
BOOL = Atom("bool")
I32 = Atom("i32")
I64 = Atom("i64")
F32 = Atom("f32")
F64 = Atom("f64")
BF16 = Atom("bf16")
DATE = Atom("date")
STR = Atom("str")
ID = Atom("id")
NUM = Atom("num")


# ---------------------------------------------------------------------------
# Tuples
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TupleType(ItemType):
    """A mapping from field names to item types.

    Field order is significant for *physical* layouts (the paper: "the
    lexicographical order of the field names defines the physical order");
    we keep declaration order and expose ``lex_fields`` for layouts.
    """

    fields: Tuple[Tuple[str, ItemType], ...]

    def __post_init__(self) -> None:
        names = [n for n, _ in self.fields]
        if len(set(names)) != len(names):
            raise TypeError(f"duplicate field names in tuple type: {names}")
        for _, t in self.fields:
            if not isinstance(t, ItemType):
                raise TypeError(f"tuple field must be ItemType, got {t!r}")

    @staticmethod
    def of(**fields: ItemType) -> "TupleType":
        return TupleType(tuple(fields.items()))

    @staticmethod
    def make(items: Mapping[str, ItemType] | Iterable[Tuple[str, ItemType]]) -> "TupleType":
        if isinstance(items, Mapping):
            return TupleType(tuple(items.items()))
        return TupleType(tuple(items))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.fields)

    @property
    def lex_fields(self) -> Tuple[Tuple[str, ItemType], ...]:
        return tuple(sorted(self.fields, key=lambda kv: kv[0]))

    def field(self, name: str) -> ItemType:
        for n, t in self.fields:
            if n == name:
                return t
        raise KeyError(name)

    def has_field(self, name: str) -> bool:
        return any(n == name for n, _ in self.fields)

    def project(self, names: Sequence[str]) -> "TupleType":
        return TupleType(tuple((n, self.field(n)) for n in names))

    def render(self) -> str:
        inner = ", ".join(f"{n}: {t.render()}" for n, t in self.fields)
        return f"⟨{inner}⟩"  # ⟨...⟩


# ---------------------------------------------------------------------------
# Collections
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CollectionKind:
    """A *kind* of collection (Set, Bag, Vec, ...).

    ``abstract`` kinds carry domain semantics only; physical kinds promise a
    memory layout to the lowering.  ``ordered`` distinguishes Seq-like kinds.
    Kinds form an open registry — frontends/backends add their own, which is
    the essence of the CVM IR *language* (the framework fixes the grammar,
    not the vocabulary).
    """

    name: str
    abstract: bool = True
    ordered: bool = False

    _registry: Dict[str, "CollectionKind"] = dataclasses.field(
        default=None, repr=False, compare=False
    )  # type: ignore[assignment]

    def __post_init__(self) -> None:
        KIND_REGISTRY[self.name] = self


KIND_REGISTRY: Dict[str, CollectionKind] = {}

SET = CollectionKind("Set", abstract=True, ordered=False)
BAG = CollectionKind("Bag", abstract=True, ordered=False)
SEQ = CollectionKind("Seq", abstract=True, ordered=True)
KDSEQ = CollectionKind("KDSeq", abstract=True, ordered=True)
VEC = CollectionKind("Vec", abstract=False, ordered=True)
SINGLE = CollectionKind("Single", abstract=False, ordered=True)
ARRAYN = CollectionKind("ArrayN", abstract=False, ordered=True)
HTAB = CollectionKind("HTab", abstract=False, ordered=False)
TENSOR = CollectionKind("Tensor", abstract=False, ordered=True)
STREAM = CollectionKind("Stream", abstract=True, ordered=True)  # unbounded data source


@dataclass(frozen=True)
class CollectionType(ItemType):
    """A finite homogeneous multiset of ``item`` with layout/semantic ``kind``.

    ``attrs`` carry kind-specific compile-time parameters:
      * KDSeq/Tensor: ``shape`` (tuple of ints, -1 for unknown dims)
      * ArrayN: ``n`` (compile-time length)
      * Tensor: ``dtype`` is in ``item`` (an Atom); optional ``spec``
        (sharding hint tuple, entries: mesh-axis name, tuple thereof, or None)
      * Vec: optional ``max_count`` (static padded capacity)
    """

    kind: CollectionKind
    item: ItemType
    attrs: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self) -> None:
        if not isinstance(self.item, ItemType):
            raise TypeError(f"collection item must be ItemType, got {self.item!r}")
        # canonicalize attr order so structural equality is insensitive to
        # the order in which attrs were attached
        object.__setattr__(self, "attrs", tuple(sorted(self.attrs, key=lambda kv: kv[0])))

    # -- attr helpers -----------------------------------------------------
    def attr(self, name: str, default: Any = None) -> Any:
        for k, v in self.attrs:
            if k == name:
                return v
        return default

    def with_attr(self, name: str, value: Any) -> "CollectionType":
        rest = tuple((k, v) for k, v in self.attrs if k != name)
        return CollectionType(self.kind, self.item, rest + ((name, value),))

    def with_item(self, item: ItemType) -> "CollectionType":
        return CollectionType(self.kind, item, self.attrs)

    def with_kind(self, kind: CollectionKind) -> "CollectionType":
        return CollectionType(kind, self.item, self.attrs)

    # -- convenience ------------------------------------------------------
    @property
    def schema(self) -> TupleType:
        if not isinstance(self.item, TupleType):
            raise TypeError(f"collection of {self.item.render()} has no schema")
        return self.item

    def render(self) -> str:
        extra = ""
        if self.attrs:
            extra = "[" + ", ".join(f"{k}={v}" for k, v in self.attrs) + "]"
        return f"{self.kind.name}{extra}⟨{self.item.render()}⟩"


# -- constructors ----------------------------------------------------------


def Set_(item: ItemType) -> CollectionType:
    return CollectionType(SET, item)


def Bag(item: ItemType) -> CollectionType:
    return CollectionType(BAG, item)


def Seq(item: ItemType) -> CollectionType:
    return CollectionType(SEQ, item)


def KDSeq(item: ItemType, shape: Tuple[int, ...]) -> CollectionType:
    return CollectionType(KDSEQ, item, (("shape", tuple(shape)),))


def Vec(item: ItemType, max_count: Optional[int] = None) -> CollectionType:
    attrs: Tuple[Tuple[str, Any], ...] = ()
    if max_count is not None:
        attrs = (("max_count", int(max_count)),)
    return CollectionType(VEC, item, attrs)


def Single(item: ItemType) -> CollectionType:
    return CollectionType(SINGLE, item)


def ArrayN(item: ItemType, n: int) -> CollectionType:
    return CollectionType(ARRAYN, item, (("n", int(n)),))


def HTab(item: ItemType) -> CollectionType:
    return CollectionType(HTAB, item)


def Tensor(dtype: Atom, shape: Sequence[int], spec: Optional[Tuple[Any, ...]] = None) -> CollectionType:
    attrs: Tuple[Tuple[str, Any], ...] = (("shape", tuple(int(s) for s in shape)),)
    if spec is not None:
        attrs += (("spec", tuple(spec)),)
    return CollectionType(TENSOR, dtype, attrs)


def Stream(item: ItemType) -> CollectionType:
    return CollectionType(STREAM, item)


# ---------------------------------------------------------------------------
# Structural helpers / matching
# ---------------------------------------------------------------------------


def atom_nbytes(a: Atom) -> int:
    """Storage bytes of one atom value (from its numpy dtype)."""
    import numpy as np

    return int(np.dtype(ATOM_DOMAINS[a.domain]).itemsize)


def item_nbytes(t: ItemType, default: int = 8) -> int:
    """Estimated bytes per item: the statistics/cost hooks of the type grammar.

    Atoms answer exactly; tuples sum their fields; collections answer per
    *element* of the collection (a row of a relation, a scalar of a tensor).
    Unknown/opaque items fall back to ``default``.
    """
    if isinstance(t, Atom):
        return atom_nbytes(t)
    if isinstance(t, TupleType):
        if not t.fields:
            return default
        return sum(item_nbytes(ft, default) for _, ft in t.fields)
    if isinstance(t, CollectionType):
        return item_nbytes(t.item, default)
    return default


def is_coll(t: ItemType, kind: Optional[CollectionKind] = None) -> bool:
    return isinstance(t, CollectionType) and (kind is None or t.kind is kind)


def is_tensor(t: ItemType) -> bool:
    return is_coll(t, TENSOR)


def tensor_shape(t: ItemType) -> Tuple[int, ...]:
    assert isinstance(t, CollectionType) and t.kind is TENSOR, t
    return t.attr("shape")


def tensor_dtype(t: ItemType) -> Atom:
    assert isinstance(t, CollectionType) and t.kind is TENSOR
    assert isinstance(t.item, Atom)
    return t.item


def common_kind(a: CollectionKind, b: CollectionKind) -> CollectionKind:
    """Join of two abstract kinds: Seq⊔Seq=Seq, Set⊔Set=Set, else Bag.

    Mirrors the paper's typing rules where e.g. Proj on a Seq yields a Seq,
    on a Set a Set, otherwise a Bag.
    """
    if a is b:
        return a
    return BAG


def schema_of(t: ItemType) -> TupleType:
    if not isinstance(t, CollectionType):
        raise TypeError(f"expected a collection type, got {t.render()}")
    return t.schema


def relation(kind: CollectionKind = BAG, **fields: ItemType) -> CollectionType:
    """Shorthand: a relation is a collection of tuples of atoms."""
    return CollectionType(kind, TupleType.of(**fields))


def substitute_item(t: ItemType, new_item: ItemType) -> ItemType:
    if isinstance(t, CollectionType):
        return t.with_item(new_item)
    raise TypeError("can only substitute item of a collection type")


def type_eq(a: ItemType, b: ItemType) -> bool:
    return a == b


def assert_type_eq(a: ItemType, b: ItemType, where: str = "") -> None:
    if a != b:
        raise TypeError(f"type mismatch{(' in ' + where) if where else ''}: "
                        f"{a.render()} vs {b.render()}")
