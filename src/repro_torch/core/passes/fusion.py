"""Fusion rewrites: combine producer-consumer chains into fused operators.

This is the paper's pipeline extraction in miniature: tree-shaped data paths
collapse into single instructions that the backend JIT-compiles as one unit
(here: one hand-written CUDA kernel).

* ``FuseSelectAgg`` — ``MaskSelect → [ExProjVec] → AggrVec`` becomes
  ``vec.FusedSelectAgg`` (the single-pass shape JITQ compiles TPC-H Q6 into).
* ``FuseSelectGroupAgg`` — ``MaskSelect → [ExProjVec] → GroupAggDirect``
  folds the predicate (and projected agg expressions) into the dense-bucket
  grouped aggregation, the TPC-H Q1 single-pass shape; under
  ``use_kernels`` the whole pipeline is one ``grouped_select_agg`` CUDA
  kernel launch.
* ``FuseJoinGroupAgg`` — ``[MaskSelect →] HashJoinDirect → GroupAggDirect``
  becomes ``vec.FusedJoinGroupAgg``: the whole select→join→group pipeline
  (the TPC-H Q3/Q12 shape) runs as one pass and the join result is never
  materialized; under ``use_kernels`` it is one ``grouped_join_agg`` CUDA
  kernel launch.
* ``FuseKMeansStep`` — ``CDist2 → ArgMinRow → SegSum + SegCount`` becomes
  ``la.KMeansStep`` (the "run-based aggregation" plan analysis the paper
  credits for matching hand-written C++ k-means); under ``use_kernels`` it
  is one ``kmeans_step`` CUDA kernel launch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..expr import AggSpec, Col, Const, Expr, col, substitute
from ..program import Instruction, Program
from ..types import BOOL
from .rewriter import ProgramRule

TRUE = Const(True, BOOL)


class FuseSelectAgg(ProgramRule):
    name = "fuse-select-agg"

    def run(self, program: Program) -> Optional[Program]:
        producers = program.producers()

        for y in program.body:
            if y.opcode != "vec.AggrVec":
                continue
            aggs = tuple(y.param("aggs"))
            src = y.inputs[0]
            chain: List[Instruction] = []
            exprs_map: Dict[str, Expr] = {}
            pred: Expr = TRUE

            cur = producers.get(src.name)
            # optional ExProj directly below the Aggr
            if cur is not None and cur.opcode == "vec.ExProjVec" and program.uses(cur.outputs[0]) == 1:
                exprs_map = {n: e for n, e in cur.param("exprs")}
                chain.append(cur)
                cur = producers.get(cur.inputs[0].name)
            # optional MaskSelect below that
            if cur is not None and cur.opcode == "vec.MaskSelect" and program.uses(cur.outputs[0]) == 1:
                pred = cur.param("pred")
                chain.append(cur)
                cur = producers.get(cur.inputs[0].name)

            if not chain:
                continue
            base = chain[-1].inputs[0]
            fused_aggs = tuple(
                AggSpec(a.fn, substitute(a.expr, exprs_map), a.name) for a in aggs
            )
            fused = Instruction(
                "vec.FusedSelectAgg",
                (base,),
                y.outputs,
                (("pred", pred), ("aggs", fused_aggs)),
            )
            dead = {id(c) for c in chain} | {id(y)}
            new_body = [fused if ins is y else ins for ins in program.body if id(ins) not in dead or ins is y]
            return program.with_body(new_body)
        return None


class FuseSelectGroupAgg(ProgramRule):
    """Fold MaskSelect → [ExProjVec] → GroupAggDirect into one instruction.

    MaskSelect only narrows the validity mask, so its predicate moves
    verbatim into GroupAggDirect's fused ``pred``; an intervening ExProjVec
    is absorbed by substituting its expressions into the agg specs, but only
    when every group key passes through as an identity column (a rename
    would change the output schema).  The sorted tier cannot fuse this way —
    the sort between select and aggregate forces materialization — which is
    part of why the direct tier wins on selective low-NDV queries.
    """

    name = "fuse-select-groupagg"

    def run(self, program: Program) -> Optional[Program]:
        producers = program.producers()

        for y in program.body:
            if y.opcode != "vec.GroupAggDirect":
                continue
            keys = tuple(y.param("keys"))
            aggs = tuple(y.param("aggs"))
            chain: List[Instruction] = []
            exprs_map: Dict[str, Expr] = {}
            pred: Optional[Expr] = y.param("pred")

            cur = producers.get(y.inputs[0].name)
            if (cur is not None and cur.opcode == "vec.ExProjVec"
                    and program.uses(cur.outputs[0]) == 1):
                exprs = {n: e for n, e in cur.param("exprs")}
                if all(isinstance(exprs.get(k), Col) and exprs[k].name == k
                       for k in keys):
                    exprs_map = exprs
                    if pred is not None:  # re-express over the base schema
                        pred = substitute(pred, exprs_map)
                    chain.append(cur)
                    cur = producers.get(cur.inputs[0].name)
            if (cur is not None and cur.opcode == "vec.MaskSelect"
                    and program.uses(cur.outputs[0]) == 1):
                sel = cur.param("pred")  # already over the base schema
                pred = sel if pred is None else (pred & sel)
                chain.append(cur)

            if not chain:
                continue
            base = chain[-1].inputs[0]
            fused_aggs = tuple(
                AggSpec(a.fn, substitute(a.expr, exprs_map), a.name)
                for a in aggs) if exprs_map else aggs
            params = dict(y.params)
            params["aggs"] = fused_aggs
            params["pred"] = pred
            fused = Instruction("vec.GroupAggDirect", (base,), y.outputs,
                                tuple(params.items()))
            dead = {id(c) for c in chain}
            new_body = [fused if ins is y else ins
                        for ins in program.body if id(ins) not in dead]
            return program.with_body(new_body)
        return None


class FuseJoinGroupAgg(ProgramRule):
    """Fold [MaskSelect →] HashJoinDirect → GroupAggDirect into one op.

    The whole-pipeline select→join→group shape (TPC-H Q3/Q12): the join
    result is never materialized — predicate, direct-table probe and dense
    grouped reduction become a single ``vec.FusedJoinGroupAgg`` instruction
    (one ``grouped_join_agg`` CUDA kernel under ``use_kernels``).

    Only the statically-bounded join variant fuses (``key_domains`` present;
    the dynamic-bounds variant carries an in-trace sorted fallback that the
    fused op cannot replicate).  A predicate already fused into the
    GroupAggDirect (by FuseSelectGroupAgg, which runs first) is absorbed
    when it only reads probe-side columns — left-column filters commute
    with a PK-FK inner join.  A MaskSelect feeding the join's probe side
    folds in the same way.  Column-name collisions between the sides would
    need the ``_r`` rename; the rule bails instead.
    """

    name = "fuse-join-groupagg"

    def run(self, program: Program) -> Optional[Program]:
        producers = program.producers()

        for y in program.body:
            if y.opcode != "vec.GroupAggDirect":
                continue
            join = producers.get(y.inputs[0].name)
            if (join is None or join.opcode != "vec.HashJoinDirect"
                    or program.uses(join.outputs[0]) != 1):
                continue
            if join.param("key_domains") is None:
                continue  # dynamic-bounds variant: in-trace fallback, no fuse
            left, right = join.inputs
            lnames = set(left.type.schema.names)
            right_on = tuple(join.param("right_on"))
            rnames = [n for n in right.type.schema.names if n not in right_on]
            if any(n in lnames for n in rnames):
                continue
            pred: Optional[Expr] = y.param("pred")
            if pred is not None and not set(pred.fields()) <= lnames:
                continue  # predicate reads a build-side column: can't hoist

            chain: List[Instruction] = []
            cur = producers.get(left.name)
            if (cur is not None and cur.opcode == "vec.MaskSelect"
                    and program.uses(cur.outputs[0]) == 1):
                sel = cur.param("pred")
                pred = sel if pred is None else (pred & sel)
                chain.append(cur)
                left = cur.inputs[0]

            jkd = tuple(join.param("key_domains"))
            njb = 1
            for lo, hi in jkd:
                njb *= int(hi) - int(lo) + 1
            fused = Instruction(
                "vec.FusedJoinGroupAgg",
                (left, right),
                y.outputs,
                (("pred", pred),
                 ("left_on", tuple(join.param("left_on"))),
                 ("right_on", right_on),
                 ("join_key_domains", jkd),
                 ("join_num_buckets", njb),
                 ("keys", tuple(y.param("keys"))),
                 ("aggs", tuple(y.param("aggs"))),
                 ("max_groups", int(y.param("max_groups"))),
                 ("key_domains", tuple(y.param("key_domains"))),
                 ("num_buckets", int(y.param("num_buckets")))),
            )
            dead = {id(c) for c in chain} | {id(join)}
            new_body = [fused if ins is y else ins
                        for ins in program.body if id(ins) not in dead]
            return program.with_body(new_body)
        return None


class FuseKMeansStep(ProgramRule):
    name = "fuse-kmeans-step"

    def run(self, program: Program) -> Optional[Program]:
        producers = program.producers()

        segsum = segcount = None
        for ins in program.body:
            if ins.opcode == "la.SegSum":
                segsum = ins
            if ins.opcode == "la.SegCount":
                segcount = ins
        if segsum is None or segcount is None:
            return None

        lab = segsum.inputs[1]
        if segcount.inputs[0].name != lab.name:
            return None
        argmin = producers.get(lab.name)
        if argmin is None or argmin.opcode != "la.ArgMinRow":
            return None
        if program.uses(argmin.outputs[0]) != 2:
            return None
        cdist = producers.get(argmin.inputs[0].name)
        if cdist is None or cdist.opcode != "la.CDist2":
            return None
        if program.uses(cdist.outputs[0]) != 1:
            return None
        x, c = cdist.inputs
        if segsum.inputs[0].name != x.name:
            return None

        fused = Instruction(
            "la.KMeansStep",
            (x, c),
            (segsum.outputs[0], segcount.outputs[0]),
        )
        dead = {id(cdist), id(argmin), id(segcount)}
        new_body = []
        for ins in program.body:
            if id(ins) in dead:
                continue
            if ins is segsum:
                new_body.append(fused)
                continue
            new_body.append(ins)
        return program.with_body(new_body)
