"""Streaming lowering: split a lowered plan into static / per-batch / merge
/ finalize segments for micro-batched incremental execution (the port's
copy of ``repro/core/passes/lower_stream.py``, plain Python).

The streaming target compiles a relational program exactly like the local
target (same canonicalize + groupby/join/encode/fuse Choice machinery, but
with the stream table's capacity rebound to the micro-batch capacity), then
this module splits the final vec-flavor program at its terminal
aggregation:

* **static segment** — every instruction whose value does NOT depend on the
  stream scan (dimension-table scans, their selects/projections, the
  build-side ``SortByKey`` of a sorted join, build-side ``DictEncode``).
  It runs ONCE per consumer; its results — including the
  ``HashJoinDirect``/``MergeJoinSorted`` build tables — are carried across
  micro-batches instead of being recomputed per batch.
* **batch segment** — the stream-dependent pipeline up to and including the
  terminal aggregation.  Run per micro-batch, it produces a *partial*
  aggregate (every AggSpec is self-decomposable), reusing the ordinary
  physical operators — ``GroupAggDirect`` dense buckets included.
* **merge program** — one ``vec.MergeGroupedState``/``vec.MergeScalarState``
  instruction folding the batch partial into the running state: the
  checkpointable accumulator of the stream.
* **finalize segment** — everything after the aggregation (decode-late
  ``DictDecode``, ``FinalizeSingle`` avg arithmetic, order-by/limit),
  re-run on demand over the current state to answer the query.

Exactly-once recovery builds on this split: the state is a pure fold over
the micro-batch sequence, so ``state_after(seq)`` is deterministic and a
restored snapshot plus a replay of the uncommitted suffix reproduces the
batch oracle bit-for-bit (see docs/streaming.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from ..program import Builder, Instruction, Program, Register
from ..verify import verify

__all__ = ["StreamPlan", "lower_stream", "GROUPED_AGG_OPS", "SCALAR_AGG_OPS"]


#: terminal aggregation opcodes whose output is a bounded grouped state
GROUPED_AGG_OPS = ("vec.GroupAggSorted", "vec.GroupAggDirect",
                   "vec.FusedJoinGroupAgg")
#: terminal aggregation opcodes whose output is a Single scalar state
SCALAR_AGG_OPS = ("vec.AggrVec", "vec.FusedSelectAgg")


@dataclass(frozen=True)
class StreamPlan:
    """The four-way split of one lowered program (see module docstring)."""

    source: Program                       # the full lowered program
    stream_table: str
    state_kind: str                       # "grouped" | "scalar"
    agg: Instruction                      # the terminal aggregation
    static_program: Optional[Program]     # () → boundary values; run once
    #: static results consumed by the batch segment (program inputs, in
    #: ``static_program.results`` order)
    batch_boundary: Tuple[Register, ...]
    batch_program: Program                # per micro-batch → partial state
    merge_program: Program                # (state, delta) → state
    #: static results consumed by the finalize segment
    finalize_boundary: Tuple[Register, ...]
    finalize_program: Optional[Program]   # (state, *boundary) → query results

    def render(self) -> str:
        parts = [f"stream plan over table {self.stream_table!r} "
                 f"({self.state_kind} state via {self.agg.opcode})"]
        if self.static_program is not None:
            parts.append(self.static_program.render())
        parts.append(self.batch_program.render())
        parts.append(self.merge_program.render())
        if self.finalize_program is not None:
            parts.append(self.finalize_program.render())
        return "\n".join(parts)


def _stream_scans(program: Program, stream_table: str) -> List[Instruction]:
    return [ins for ins in program.body
            if ins.opcode == "vec.ScanVec"
            and ins.param("table") == stream_table]


def _merge_params(agg: Instruction) -> Dict[str, object]:
    """Parameters of the merge op, lifted off the terminal aggregation."""
    if agg.opcode in SCALAR_AGG_OPS:
        return {"aggs": tuple(agg.param("aggs"))}
    params: Dict[str, object] = {
        "keys": tuple(agg.param("keys")),
        "aggs": tuple(agg.param("aggs")),
        "max_groups": int(agg.param("max_groups")),
    }
    # the direct tiers carry their dense-bucket geometry into the merge so
    # the carried accumulator stays sort-free
    if agg.opcode in ("vec.GroupAggDirect", "vec.FusedJoinGroupAgg"):
        params["key_domains"] = tuple(agg.param("key_domains"))
        params["num_buckets"] = int(agg.param("num_buckets"))
    return params


def lower_stream(program: Program, stream_table: str) -> StreamPlan:
    """Split a lowered vec-flavor program for incremental execution.

    Raises ``ValueError`` with a named reason when the program shape is not
    streamable: no stream scan, no terminal aggregation over the stream, a
    second stream-dependent aggregation, or a post-aggregation instruction
    that consumes raw (pre-aggregation) stream rows.
    """
    scans = _stream_scans(program, stream_table)
    if not scans:
        known = sorted({ins.param("table") for ins in program.body
                        if ins.opcode == "vec.ScanVec"})
        raise ValueError(
            f"stream table {stream_table!r} is not scanned by "
            f"{program.name!r}; scanned tables: {known}")

    # -- dependence: which registers transitively read the stream scan ------
    stream_dep: Set[str] = set()
    for ins in program.body:
        if ins in scans or any(r.name in stream_dep for r in ins.inputs):
            stream_dep.update(r.name for r in ins.outputs)

    # -- the terminal aggregation ------------------------------------------
    agg_ops = GROUPED_AGG_OPS + SCALAR_AGG_OPS
    aggs = [ins for ins in program.body
            if ins.opcode in agg_ops
            and any(r.name in stream_dep for r in list(ins.inputs)
                    + list(ins.outputs))]
    if not aggs:
        raise ValueError(
            f"{program.name!r} has no aggregation over stream table "
            f"{stream_table!r}; unbounded state cannot stream "
            f"(add a group_by/agg, or run a batch target)")
    if len(aggs) > 1:
        raise ValueError(
            f"{program.name!r} has {len(aggs)} aggregations over the "
            f"stream; streaming supports exactly one terminal aggregation "
            f"({[i.opcode for i in aggs]})")
    agg = aggs[0]
    agg_idx = program.body.index(agg)
    agg_out = agg.outputs[0]
    state_kind = "scalar" if agg.opcode in SCALAR_AGG_OPS else "grouped"

    # -- partition the body -------------------------------------------------
    batch_body: List[Instruction] = []
    static_body: List[Instruction] = []
    suffix_body: List[Instruction] = []
    suffix_defined: Set[str] = {agg_out.name}
    for idx, ins in enumerate(program.body):
        dep = any(r.name in stream_dep for r in ins.outputs)
        if not dep:
            static_body.append(ins)
        elif idx <= agg_idx:
            batch_body.append(ins)
        else:
            for r in ins.inputs:
                if r.name in stream_dep and r.name not in suffix_defined:
                    raise ValueError(
                        f"{program.name!r}: {ins.opcode} after the "
                        f"aggregation consumes pre-aggregation stream "
                        f"register %{r.name}; only the aggregated state "
                        f"may flow past the aggregation")
            suffix_defined.update(r.name for r in ins.outputs)
            suffix_body.append(ins)

    for r in program.results:
        if r.name in stream_dep and r.name not in suffix_defined:
            raise ValueError(
                f"{program.name!r}: result %{r.name} is raw stream data; a "
                f"streaming program must return aggregated state")

    # -- boundary registers: static values the other segments consume ------
    static_defs = {r.name: r for ins in static_body for r in ins.outputs}

    def boundary(body: List[Instruction],
                 extra: Tuple[Register, ...] = ()) -> List[Register]:
        seen: Dict[str, Register] = {}
        for ins in body:
            for r in ins.inputs:
                if r.name in static_defs and r.name not in seen:
                    seen[r.name] = r
        for r in extra:
            if r.name in static_defs and r.name not in seen:
                seen[r.name] = r
        return list(seen.values())

    batch_boundary = boundary(batch_body)
    finalize_boundary = boundary(suffix_body, program.results)
    needed = list(batch_boundary)
    needed += [r for r in finalize_boundary
               if r.name not in {b.name for b in batch_boundary}]

    static_program: Optional[Program] = None
    if needed:
        # backward closure: only static instructions feeding a boundary reg
        live = {r.name for r in needed}
        keep: List[Instruction] = []
        for ins in reversed(static_body):
            if any(r.name in live for r in ins.outputs):
                keep.append(ins)
                live.update(r.name for r in ins.inputs)
        keep.reverse()
        static_program = Program(
            name=f"{program.name}__static",
            inputs=(), body=tuple(keep), results=tuple(needed))

    batch_program = Program(
        name=f"{program.name}__batch",
        inputs=tuple(batch_boundary),
        body=tuple(batch_body),
        results=(agg_out,))

    # -- merge: one instruction, built through the typed Builder ------------
    b = Builder(f"{program.name}__merge", prefix="m")
    s_in = b.input("state", agg_out.type)
    d_in = b.input("delta", agg_out.type)
    merge_op = ("vec.MergeScalarState" if state_kind == "scalar"
                else "vec.MergeGroupedState")
    merged = b.emit1(merge_op, [s_in, d_in], params=_merge_params(agg))
    merge_program = b.finish(merged)

    finalize_program: Optional[Program] = None
    if suffix_body or any(r.name != agg_out.name for r in program.results):
        finalize_program = Program(
            name=f"{program.name}__finalize",
            inputs=(agg_out,) + tuple(finalize_boundary),
            body=tuple(suffix_body),
            results=program.results)

    for p in filter(None, (static_program, batch_program, merge_program,
                           finalize_program)):
        verify(p, allow_unknown_ops=True)

    return StreamPlan(
        source=program,
        stream_table=stream_table,
        state_kind=state_kind,
        agg=agg,
        static_program=static_program,
        batch_boundary=tuple(batch_boundary),
        batch_program=batch_program,
        merge_program=merge_program,
        finalize_boundary=tuple(finalize_boundary),
        finalize_program=finalize_program,
    )
