"""Mesh-flavor lowering rules (the SPMD backend's pipeline stages).

The port's copy of ``repro/core/passes/mesh_lower.py``.

These are *backend-specific rewritings* (paper §3.6: every frontend/backend
combination gets the rewritings best suited for it).  They used to live
inside the SPMD backend's ``compile``; now they are ordinary passes that the
compilation driver registers as the tail of the ``spmd``/``multipod``
lowering paths (see ``repro_torch.compiler.targets``):

  * ``LowerToMesh`` — ``cf.ConcurrentExecute`` → ``mesh.MeshExecute(axis)``:
    the chunk axis becomes a named mesh axis, so the nested program runs
    as ONE SPMD program on every rank of the mesh.
  * ``PushCombineIntoMesh`` — a ``CombineChunks(sum)``/``CombinePartials``
    following a MeshExecute is pulled inside the nested program as a
    ``mesh.AllReduce`` — the paper's pre-aggregation becoming a collective
    instead of a gather+reduce.
  * ``PushGroupedCombineIntoMesh`` — the *grouped* recombine
    (``Merge → SortByKey → GroupAggSorted`` after a MeshExecute) is turned
    into ``mesh.ExchangeByKey`` + per-shard sort/aggregate inside the mesh
    program (MPIHistogram + MPIExchange): equal keys land on one device, so
    the final aggregation runs sharded instead of gathered onto one host.
    This is an *alternative* physical lowering, not an unconditional
    improvement — for low group cardinality the gather is cheaper — so the
    compilation driver exposes it as a selectable strategy
    (``grouped-recombine: gather | exchange``) and the cost model picks.
"""

from __future__ import annotations

from typing import Optional

from ..program import Instruction, Program, Register
from ..registry import infer_output_types
from .rewriter import ProgramRule


class LowerToMesh(ProgramRule):
    """cf.ConcurrentExecute → mesh.MeshExecute(axis)."""

    name = "lower-to-mesh"

    def __init__(self, axis: str = "workers") -> None:
        self.axis = axis

    def run(self, program: Program) -> Optional[Program]:
        changed = False
        body = []
        for ins in program.body:
            if ins.opcode == "cf.ConcurrentExecute":
                ins = ins.with_opcode("mesh.MeshExecute").with_params(axis=self.axis)
                changed = True
            body.append(ins)
        return program.with_body(body) if changed else None


class PushCombineIntoMesh(ProgramRule):
    """Pull a CombineChunks(sum)/CombinePartials following a MeshExecute into
    the nested program as a mesh.AllReduce — pre-aggregation as collective."""

    name = "push-combine-into-mesh"

    def run(self, program: Program) -> Optional[Program]:
        producers = program.producers()
        for y in program.body:
            if y.opcode not in ("cf.CombineChunks", "rel.CombinePartials"):
                continue
            if y.opcode == "cf.CombineChunks" and y.param("op") != "sum":
                continue
            src = y.inputs[0]
            me = producers.get(src.name)
            if me is None or me.opcode != "mesh.MeshExecute":
                continue
            if program.uses(src) != 1:
                continue
            idx = list(r.name for r in me.outputs).index(src.name)
            inner: Program = me.param("P")
            axis = me.param("axis")

            from ..ops.controlflow import split_type

            res = inner.results[idx]
            red = Register(res.name + "_ar", res.type)
            if y.opcode == "rel.CombinePartials":
                ar = Instruction("mesh.AllReduce", (res,), (red,),
                                 (("op", "combine_aggs"), ("axis", axis),
                                  ("aggs", y.param("aggs"))))
            else:
                ar = Instruction("mesh.AllReduce", (res,), (red,),
                                 (("op", "sum"), ("axis", axis)))
            new_inner = Program(
                name=inner.name, inputs=inner.inputs,
                body=inner.body + (ar,),
                results=tuple(red if i == idx else r for i, r in enumerate(inner.results)),
            )
            new_me_outs = list(me.outputs)
            new_me_outs[idx] = Register(src.name + "_rep", split_type(red.type, src.type.attr("n")))
            new_me = Instruction("mesh.MeshExecute", me.inputs, tuple(new_me_outs),
                                 (("P", new_inner), ("axis", axis)))
            take = Instruction("cf.TakeChunk", (new_me_outs[idx],), y.outputs, (("i", 0),))
            new_body = []
            for ins in program.body:
                if ins is me:
                    new_body.append(new_me)
                elif ins is y:
                    new_body.append(take)
                else:
                    if any(r.name == src.name for r in ins.inputs):
                        ins = ins.with_inputs([new_me_outs[idx] if r.name == src.name else r
                                               for r in ins.inputs])
                    new_body.append(ins)
            return program.with_body(new_body)
        return None


class PushGroupedCombineIntoMesh(ProgramRule):
    """A grouped recombine after a MeshExecute — ``Merge → SortByKey →
    GroupAggSorted`` or the sort-free ``Merge → GroupAggDirect`` — becomes
    ExchangeByKey + per-shard aggregation inside the mesh program.

    Correctness relies only on colocation: partitioning by the first group
    key sends every row of a group to the same device, so the per-shard
    aggregation produces each group exactly once and the outer Merge is a
    plain concatenation of disjoint group sets (compacted back to the
    original ``max_groups`` capacity).  ``skew=n`` reserves worst-case slots
    in the exchange so no rows are ever dropped.
    """

    name = "push-grouped-combine-into-mesh"

    def run(self, program: Program) -> Optional[Program]:
        producers = program.producers()
        for g in program.body:
            if g.opcode not in ("vec.GroupAggSorted", "vec.GroupAggDirect"):
                continue
            sort = None
            if g.opcode == "vec.GroupAggSorted":
                sort = producers.get(g.inputs[0].name)
                if (sort is None or sort.opcode != "vec.SortByKey"
                        or program.uses(g.inputs[0]) != 1):
                    continue
                if tuple(sort.param("keys")) != tuple(g.param("keys")):
                    continue
                merge = producers.get(sort.inputs[0].name)
                merge_out = sort.inputs[0]
            else:
                # the direct (dense-bucket) tier consumes the Merge directly:
                # there is no sort to elide, only the gather to replace
                merge = producers.get(g.inputs[0].name)
                merge_out = g.inputs[0]
            if (merge is None or merge.opcode != "cf.Merge"
                    or program.uses(merge_out) != 1):
                continue
            src = merge.inputs[0]
            me = producers.get(src.name)
            if me is None or me.opcode != "mesh.MeshExecute":
                continue
            if program.uses(src) != 1:
                continue

            idx = [r.name for r in me.outputs].index(src.name)
            inner: Program = me.param("P")
            axis = me.param("axis")
            n = int(src.type.attr("n"))
            keys = tuple(g.param("keys"))
            max_groups = int(g.param("max_groups"))

            # --- extend the nested program: exchange + shard-local re-agg --
            res = inner.results[idx]
            ex_params = {"key": keys[0], "axis": axis, "n": n, "skew": float(n)}
            (ex_t,) = infer_output_types("mesh.ExchangeByKey", ex_params,
                                         [res.type])
            ex = Register(res.name + "_ex", ex_t)
            if g.opcode == "vec.GroupAggSorted":
                sort_params = {"keys": keys}
                (s_t,) = infer_output_types("vec.SortByKey", sort_params, [ex_t])
                srt = Register(res.name + "_st", s_t)
                agg_params = dict(g.params)
                (a_t,) = infer_output_types("vec.GroupAggSorted", agg_params, [s_t])
                agg = Register(res.name + "_ag", a_t)
                tail = (
                    Instruction("mesh.ExchangeByKey", (res,), (ex,),
                                tuple(ex_params.items())),
                    Instruction("vec.SortByKey", (ex,), (srt,),
                                tuple(sort_params.items())),
                    Instruction("vec.GroupAggSorted", (srt,), (agg,),
                                tuple(agg_params.items())),
                )
            else:
                agg_params = dict(g.params)
                (a_t,) = infer_output_types("vec.GroupAggDirect", agg_params, [ex_t])
                agg = Register(res.name + "_ag", a_t)
                tail = (
                    Instruction("mesh.ExchangeByKey", (res,), (ex,),
                                tuple(ex_params.items())),
                    Instruction("vec.GroupAggDirect", (ex,), (agg,),
                                tuple(agg_params.items())),
                )
            new_inner = Program(
                name=inner.name, inputs=inner.inputs,
                body=inner.body + tail,
                results=tuple(agg if i == idx else r
                              for i, r in enumerate(inner.results)),
            )

            # --- rebuild the outer instructions ---------------------------
            me_params = dict(me.params)
            me_params["P"] = new_inner
            me_out_types = infer_output_types("mesh.MeshExecute", me_params,
                                              [r.type for r in me.inputs])
            new_me_outs = tuple(
                Register(src.name + "_gx", t) if i == idx else r
                for i, (r, t) in enumerate(zip(me.outputs, me_out_types)))
            new_me = Instruction("mesh.MeshExecute", me.inputs, new_me_outs,
                                 tuple(me_params.items()))
            (m_t,) = infer_output_types("cf.Merge", {}, [new_me_outs[idx].type])
            gathered = Register(src.name + "_gm", m_t)
            new_merge = Instruction("cf.Merge", (new_me_outs[idx],), (gathered,))
            compact = Instruction("vec.Compact", (gathered,), g.outputs,
                                  (("max_count", max_groups),))

            new_body = []
            for ins in program.body:
                if ins is me:
                    new_body.append(new_me)
                elif ins is merge:
                    new_body.append(new_merge)
                elif ins is sort:
                    continue
                elif ins is g:
                    new_body.append(compact)
                else:
                    if any(r.name == src.name for r in ins.inputs):
                        ins = ins.with_inputs(
                            [new_me_outs[idx] if r.name == src.name else r
                             for r in ins.inputs])
                    new_body.append(ins)
            results = tuple(new_me_outs[idx] if r.name == src.name else r
                            for r in program.results)
            return program.with_body(new_body).with_results(results)
        return None
