"""SPMD mesh backend flavor — the Modularis/Lambada analogue.

The port's copy of ``repro/core/ops/mesh.py``.  ``mesh.MeshExecute`` is the
platform-specific version of ``cf.ConcurrentExecute`` (paper: MPIExecutor /
ParallelLambdaMap): the chunk axis becomes a named mesh axis and the nested
program runs once per rank along that axis.  Collective instructions
appear *inside* the nested program and lower to ``torch.distributed``
collectives (``backends/spmd.py``).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from ..program import Program
from ..registry import op
from ..types import SEQ, CollectionType, ItemType, Vec, is_coll
from .controlflow import split_type


@op("mesh.MeshExecute")
def _mesh_execute(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """MeshExecute(P, axis)(S1..Sk) — ConcurrentExecute bound to a mesh axis."""
    p: Program = params["P"]
    n = None
    if len(ins) != len(p.inputs):
        raise TypeError("MeshExecute arity mismatch")
    for t, pin in zip(ins, p.inputs):
        if not is_coll(t, SEQ):
            raise TypeError(f"MeshExecute input must be Seq-of-chunks, got {t.render()}")
        tn = t.attr("n")
        n = tn if n is None else n
        if tn != n:
            raise TypeError("MeshExecute inputs disagree on worker count")
        if t.item != pin.type:
            raise TypeError(
                f"MeshExecute input {t.item.render()} != program input {pin.type.render()}"
            )
    return [split_type(r.type, n) for r in p.results]


@op("mesh.AllReduce", barrier=True)
def _allreduce(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """AllReduce(op, axis)(X) → X — reduce across the axis, replicate result."""
    return [ins[0]]


@op("mesh.AllGatherVec", barrier=True)
def _allgather(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """AllGatherVec(axis, n)(Vec⟨T⟩) → Vec⟨T⟩ with n× capacity."""
    (v,) = ins
    if not is_coll(v):
        raise TypeError("AllGatherVec of non-collection")
    cap = v.attr("max_count")
    n = int(params["n"])
    return [Vec(v.item, cap * n if cap else None)]


@op("mesh.ReduceScatter", barrier=True)
def _reducescatter(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ReduceScatter(op, axis, n)(X) → X/n — reduce and shard along the axis."""
    return [ins[0]]


@op("mesh.AllToAll", barrier=True)
def _alltoall(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """AllToAll(axis)(Seq[n]⟨Vec⟨T⟩⟩) → Seq[n]⟨Vec⟨T⟩⟩ — transpose chunks/devices."""
    (s,) = ins
    if not is_coll(s, SEQ):
        raise TypeError("AllToAll of non-split type")
    return [s]


@op("mesh.ExchangeByKey", barrier=True)
def _exchange(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ExchangeByKey(key, axis, n)(Vec⟨T⟩) → Vec⟨T⟩.

    Shuffle rows so equal keys land on the same device: histogram partition +
    all-to-all + concat (paper: MPIHistogram + MPIExchange).  Capacity grows
    by the skew factor (worst case n×; default 2× with runtime validity).
    """
    (v,) = ins
    cap = v.attr("max_count")
    skew = float(params.get("skew", 2.0))
    newcap = int(cap * skew) if cap else None
    return [Vec(v.item, newcap)]


@op("mesh.PPermute", barrier=True)
def _ppermute(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """PPermute(perm, axis)(X) → X — neighbor exchange (ring schedules)."""
    return [ins[0]]


@op("mesh.ShardConstraint")
def _shard_constraint(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """ShardConstraint(spec)(X) → X — annotate partitioning for the lowering."""
    return [ins[0]]
