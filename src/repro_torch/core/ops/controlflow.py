"""Control-flow-like higher-order instructions (paper Table 2, middle).

CVM has no jumps by design; loops/conditionals/parallelism are higher-order
instructions parameterized by nested programs.  ``cf.Split`` /
``cf.ConcurrentExecute`` / ``cf.Merge`` are the generic parallelism trio the
parallelization rewrite introduces (Alg. 1 → Alg. 2).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from ..program import Program
from ..registry import op
from ..types import (
    BAG, SEQ, SINGLE, CollectionType, ItemType, Single, assert_type_eq, is_coll,
)


def chunk_type(c: CollectionType, n: int, axis: int = 0) -> CollectionType:
    """The per-chunk type of an n-way split of ``c``.

    Size-less abstract collections (Bag/Set/Seq of items) are unchanged;
    statically-sized collections divide: Tensor/KDSeq divide ``shape[axis]``,
    Vec divides ``max_count``.
    """
    shape = c.attr("shape")
    if shape is not None:
        if shape[axis] % n != 0:
            raise TypeError(f"cannot split shape {shape} axis {axis} into {n}")
        new_shape = tuple(s // n if i == axis else s for i, s in enumerate(shape))
        return c.with_attr("shape", new_shape)
    cap = c.attr("max_count")
    if cap is not None:
        if cap % n != 0:
            raise TypeError(f"cannot split capacity {cap} into {n}")
        return c.with_attr("max_count", cap // n)
    return c


def unchunk_type(c: CollectionType, n: int, axis: int = 0) -> CollectionType:
    """Inverse of ``chunk_type``: the type of n concatenated chunks."""
    shape = c.attr("shape")
    if shape is not None:
        new_shape = tuple(s * n if i == axis else s for i, s in enumerate(shape))
        return c.with_attr("shape", new_shape)
    cap = c.attr("max_count")
    if cap is not None:
        return c.with_attr("max_count", cap * n)
    return c


def split_type(inner: ItemType, n: int, axis: int = 0, bcast: bool = False) -> CollectionType:
    """The type of an n-way split: Seq[n]⟨inner⟩ (``inner`` = chunk type)."""
    attrs: tuple = (("n", int(n)), ("axis", int(axis)))
    if bcast:
        attrs += (("bcast", True),)
    return CollectionType(SEQ, inner, attrs)


@op("cf.Split", elementwise=False)
def _split(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Split(n[, axis])(C) → Seq[n]⟨chunk(C)⟩ — partition into n chunks.

    The partitioning is an implementation choice of the backend (range,
    round-robin, ...); semantics only promise that Merge(Split(C)) ≡ C as a
    multiset (and preserves order for Seq inputs).
    """
    (c,) = ins
    if not is_coll(c):
        raise TypeError(f"Split of non-collection {c.render()}")
    n = int(params["n"])
    axis = int(params.get("axis", 0))
    return [split_type(chunk_type(c, n, axis), n, axis)]


@op("cf.Broadcast")
def _broadcast(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Broadcast(n)(X) → Seq[n]⟨X⟩ — every worker receives the same value.

    Introduced by the parallelization rewrite for loop-invariant side inputs
    of absorbed instructions (e.g. k-means centroids, model parameters).
    """
    (x,) = ins
    return [split_type(x, int(params["n"]), bcast=True)]


@op("cf.Merge")
def _merge(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Merge()(Seq[n]⟨C⟩) → unchunk(C) — concatenate chunks (inverse of Split)."""
    (s,) = ins
    if not (is_coll(s, SEQ) and isinstance(s.item, CollectionType)):
        raise TypeError(f"Merge of non-split type {s.render()}")
    if s.attr("bcast"):
        raise TypeError("Merge of a Broadcast is ill-defined; use TakeChunk")
    n = s.attr("n")
    if n is None:
        raise TypeError(f"Merge of Seq without chunk count: {s.render()}")
    return [unchunk_type(s.item, int(n), int(s.attr("axis", 0)))]


@op("cf.ConcurrentExecute")
def _concurrent_execute(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ConcurrentExecute(P)(S1..Sk) — run P once per chunk, concurrently.

    Each input is a Seq[n]⟨Xi⟩; worker j receives element j of every input
    and produces element j of every output.  Workers may exchange data if P
    contains collective instructions (that is the difference to a plain Map).
    """
    p: Program = params["P"]
    n = None
    if not ins:
        raise TypeError("ConcurrentExecute needs at least one input")
    if len(ins) != len(p.inputs):
        raise TypeError(
            f"ConcurrentExecute: {len(ins)} inputs but program {p.name} takes {len(p.inputs)}"
        )
    for t, pin in zip(ins, p.inputs):
        if not is_coll(t, SEQ):
            raise TypeError(f"ConcurrentExecute input must be Seq-of-chunks, got {t.render()}")
        tn = t.attr("n")
        if n is None:
            n = tn
        elif tn != n:
            raise TypeError(f"ConcurrentExecute inputs disagree on worker count: {tn} vs {n}")
        assert_type_eq(t.item, pin.type, f"ConcurrentExecute input vs {p.name}")
    assert n is not None
    return [split_type(r.type, n) for r in p.results]


@op("cf.Loop")
def _loop(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Loop(n, P)(C1..Ck) — run P n times, feeding results back as inputs."""
    p: Program = params["P"]
    if list(p.input_types()) != list(ins):
        raise TypeError(f"Loop body {p.name} input types != loop inputs")
    if list(p.result_types()) != list(ins):
        raise TypeError(f"Loop body {p.name} must be type-preserving")
    return list(ins)


@op("cf.While")
def _while(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """While(P)(C1..Ck) — P returns (Single⟨bool⟩, C1..Ck); loop while true."""
    from ..types import Atom

    p: Program = params["P"]
    if list(p.input_types()) != list(ins):
        raise TypeError(f"While body {p.name} input types != inputs")
    res = list(p.result_types())
    cond, rest = res[0], res[1:]
    if not (is_coll(cond, SINGLE) and isinstance(cond.item, Atom) and cond.item.domain == "bool"):
        raise TypeError(f"While body must first return Single⟨bool⟩, got {cond.render()}")
    if rest != list(ins):
        raise TypeError("While body must be type-preserving on carried registers")
    return list(ins)


@op("cf.Cond")
def _cond(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Cond(Pthen, Pelse)(pred: Single⟨bool⟩, C1..Ck)."""
    pt: Program = params["Pthen"]
    pe: Program = params["Pelse"]
    if list(pt.result_types()) != list(pe.result_types()):
        raise TypeError("Cond branches disagree on result types")
    body_ins = list(ins[1:])
    if list(pt.input_types()) != body_ins or list(pe.input_types()) != body_ins:
        raise TypeError("Cond branch inputs must match instruction inputs (after pred)")
    return list(pt.result_types())


@op("cf.Call")
def _call(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Call(P)(C1..Ck) — straight nested-program invocation."""
    p: Program = params["P"]
    if list(p.input_types()) != list(ins):
        raise TypeError(f"Call of {p.name}: argument types mismatch")
    return list(p.result_types())


@op("cf.CombineChunks", barrier=True)
def _combine_chunks(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """CombineChunks(op)(Seq[n]⟨X⟩) → X — fold chunks with an elementwise op.

    ``op`` ∈ {"sum","min","max"}.  The generic combiner of per-worker partial
    results (gradients, LA partial aggregates).  The SPMD backend rewrites a
    CombineChunks that follows a MeshExecute into an AllReduce *inside* the
    mesh program (turning a centralized combine into a collective).
    """
    (s,) = ins
    if not is_coll(s, SEQ) or s.attr("n") is None:
        raise TypeError(f"CombineChunks of non-split type {s.render()}")
    return [s.item]


@op("cf.TakeChunk")
def _take_chunk(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """TakeChunk(i)(Seq[n]⟨X⟩) → X — select one chunk (e.g. a replicated result)."""
    (s,) = ins
    if not is_coll(s, SEQ) or s.attr("n") is None:
        raise TypeError(f"TakeChunk of non-split type {s.render()}")
    return [s.item]
