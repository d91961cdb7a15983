"""Generic parallelization rewrite (paper §3.6, Algorithms 1 → 2).

Three rules, applied to fixpoint:

* **Seed** — replace the use of a source collection ``r`` with
  ``s ← Split(n)(r); e ← ConcurrentExecute(identity)(s); m ← Merge(e)``
  (a logical no-op) and redirect r's consumers to ``m``.
* **AbsorbElementwise** — an instruction whose first input is a single-use
  ``Merge`` of a CE output moves *inside* the nested program; its other
  (loop-invariant) inputs are ``Broadcast`` into the CE.
* **AbsorbAggregation** — a decomposable aggregation is *copied* inside as a
  pre-aggregation; the outer instruction is replaced by the matching
  combiner (``rel.CombinePartials`` for scalar aggs, Merge+GroupByAggr with
  combine-fns for grouped aggs, ``cf.CombineChunks`` for segmented/LA aggs).

Instructions the rules don't understand are left as is (paper: "If an
unknown instruction had been encountered, then the rule would leave it as
is") — they simply stay outside the ConcurrentExecute.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .. import registry
from ..expr import AggSpec, col
from ..program import Instruction, Program, Register
from ..registry import infer_output_types
from ..types import BAG, SEQ, SET, CollectionType, is_coll
from .rewriter import ProgramRule

_FRESH = itertools.count()


def _fresh(taken: Set[str], hint: str) -> str:
    while True:
        name = f"{hint}{next(_FRESH)}"
        if name not in taken:
            taken.add(name)
            return name


def _all_names(p: Program) -> Set[str]:
    names = {r.name for r in p.inputs}
    for ins in p.body:
        names.update(r.name for r in ins.outputs)
    return names


class Parallelize(ProgramRule):
    """Parallelize a program over ``n`` workers.

    ``targets``: optional set of register names to seed; defaults to every
    program input / source-instruction output of an abstract collection type
    that has at least one absorbable consumer.
    """

    name = "parallelize"
    recurse = False

    def __init__(self, n: int, targets: Optional[Set[str]] = None) -> None:
        self.n = n
        self.targets = targets
        self._pending_broadcasts: List[Tuple[Register, Register]] = []

    # ------------------------------------------------------------------ run
    def run(self, program: Program) -> Optional[Program]:
        out = self._seed(program)
        if out is not None:
            return out
        out = self._absorb(program)
        if out is not None:
            return out
        return None

    # ----------------------------------------------------------------- seed
    def _seedable(self, program: Program) -> List[Tuple[int, Register]]:
        """(insert_position, register) pairs eligible for the seed rule."""
        consumers = program.consumers()
        producers = program.producers()
        positions = {id(ins): i for i, ins in enumerate(program.body)}
        found = []

        def absorbable_consumer(reg: Register) -> bool:
            for ins in consumers.get(reg.name, []):
                spec = registry.lookup(ins.opcode)
                if spec is None:
                    continue
                if (spec.elementwise or spec.aggregation) and ins.inputs and ins.inputs[0].name == reg.name:
                    return True
            return False

        def splittable(reg: Register) -> bool:
            t = reg.type
            if not is_coll(t):
                return False
            explicitly_targeted = self.targets is not None and reg.name in self.targets
            if (t.kind not in (BAG, SET, SEQ)
                    and t.kind.name not in ("Vec", "Tensor")
                    and not explicitly_targeted):
                return False
            if t.kind is SEQ and t.attr("n") is not None:
                return False  # already split
            # static sizes must divide
            for key in ("max_count",):
                v = t.attr(key)
                if v is not None and v % self.n != 0:
                    return False
            shape = t.attr("shape")
            if shape is not None and (not shape or shape[0] % self.n != 0):
                return False
            return True

        cands: List[Tuple[int, Register]] = []
        for r in program.inputs:
            cands.append((0, r))
        for i, ins in enumerate(program.body):
            spec = registry.lookup(ins.opcode)
            if spec is not None and spec.source:
                for r in ins.outputs:
                    cands.append((i + 1, r))

        for pos, r in cands:
            if self.targets is not None and r.name not in self.targets:
                continue
            if not splittable(r):
                continue
            if any(c.opcode == "cf.Split" for c in consumers.get(r.name, [])):
                continue  # already seeded
            if self.targets is None and not absorbable_consumer(r):
                continue
            found.append((pos, r))
        return found

    def _seed(self, program: Program) -> Optional[Program]:
        seeds = self._seedable(program)
        if not seeds:
            return None
        pos, r = seeds[0]
        taken = _all_names(program)

        from ..ops.controlflow import chunk_type, split_type, unchunk_type

        chunk = chunk_type(r.type, self.n)
        inner_in = Register("x0", chunk)
        identity = Program(name=f"par_{r.name}", inputs=(inner_in,), body=(), results=(inner_in,))

        s_reg = Register(_fresh(taken, "split"), split_type(chunk, self.n))
        e_reg = Register(_fresh(taken, "ce"), split_type(chunk, self.n))
        m_reg = Register(_fresh(taken, "merged"), r.type)

        split_ins = Instruction("cf.Split", (r,), (s_reg,), (("n", self.n),))
        ce_ins = Instruction("cf.ConcurrentExecute", (s_reg,), (e_reg,), (("P", identity),))
        merge_ins = Instruction("cf.Merge", (e_reg,), (m_reg,))

        body = list(program.body)
        new_body = body[:pos] + [split_ins, ce_ins, merge_ins] + body[pos:]

        # redirect consumers of r (except the new split) to m
        redirected = []
        for ins in new_body:
            if ins is split_ins:
                redirected.append(ins)
                continue
            if any(i.name == r.name for i in ins.inputs):
                ins = ins.with_inputs([m_reg if i.name == r.name else i for i in ins.inputs])
            redirected.append(ins)
        results = tuple(m_reg if x.name == r.name else x for x in program.results)
        return program.with_body(redirected).with_results(results)

    # --------------------------------------------------------------- absorb
    def _absorb(self, program: Program) -> Optional[Program]:
        producers = program.producers()
        positions: Dict[str, int] = {}
        for i, ins in enumerate(program.body):
            for r in ins.outputs:
                positions[r.name] = i

        def uses(reg: Register) -> int:
            return program.uses(reg)

        for yi, y in enumerate(program.body):
            spec = registry.lookup(y.opcode)
            if spec is None or not (spec.elementwise or spec.aggregation):
                continue
            if y.param("recombine"):
                # the combiner this rewrite itself emitted: absorbing it again
                # would ping-pong forever (pre-aggregate → recombine → ...)
                continue
            if not y.inputs:
                continue
            # first input must be a single-use Merge of a CE output
            a0 = y.inputs[0]
            merge0 = producers.get(a0.name)
            if merge0 is None or merge0.opcode != "cf.Merge" or uses(a0) != 1:
                continue
            if any(r.name == a0.name for r in program.results):
                continue
            e0 = merge0.inputs[0]
            ce = producers.get(e0.name)
            if ce is None or ce.opcode != "cf.ConcurrentExecute":
                continue
            ce_pos = positions[e0.name]

            # classify remaining inputs: merges of the SAME ce, or broadcasts
            merge_inputs: Dict[str, int] = {}  # y-input name -> ce result index
            bcast_inputs: List[Register] = []
            ok = True
            ce_out_names = [r.name for r in ce.outputs]
            merge_inputs[a0.name] = ce_out_names.index(e0.name)
            for a in y.inputs[1:]:
                prod = producers.get(a.name)
                if (
                    prod is not None
                    and prod.opcode == "cf.Merge"
                    and uses(a) == 1
                    and prod.inputs[0].name in ce_out_names
                    and not any(r.name == a.name for r in program.results)
                ):
                    merge_inputs[a.name] = ce_out_names.index(prod.inputs[0].name)
                elif positions.get(a.name, -1) < ce_pos:
                    bcast_inputs.append(a)  # defined before the CE (or an input)
                else:
                    ok = False
                    break
            if not ok:
                continue

            return self._do_absorb(program, y, ce, merge_inputs, bcast_inputs, spec)
        return None

    def _do_absorb(
        self,
        program: Program,
        y: Instruction,
        ce: Instruction,
        merge_inputs: Dict[str, int],
        bcast_inputs: List[Register],
        spec: registry.OpSpec,
    ) -> Program:
        from ..ops.controlflow import split_type

        taken = _all_names(program)
        inner: Program = ce.param("P")
        inner_taken = _all_names(inner)

        # --- extend the nested program ------------------------------------
        inner_inputs = list(inner.inputs)
        new_ce_inputs = list(ce.inputs)
        arg_regs: List[Register] = []
        for a in y.inputs:
            if a.name in merge_inputs:
                arg_regs.append(inner.results[merge_inputs[a.name]])
            else:
                ir = Register(_fresh(inner_taken, "b"), a.type)
                inner_inputs.append(ir)
                arg_regs.append(ir)
                # broadcast outer register into the CE
                br = Register(_fresh(taken, "bc"), split_type(a.type, self.n, bcast=True))
                new_ce_inputs.append(br)
                self._pending_broadcasts.append((a, br))

        inner_params = dict(y.params)
        inner_out_types = infer_output_types(y.opcode, inner_params, [r.type for r in arg_regs])
        inner_outs = tuple(Register(_fresh(inner_taken, "t"), t) for t in inner_out_types)
        inner_ins = Instruction(y.opcode, tuple(arg_regs), inner_outs, tuple(inner_params.items()))

        consumed = set(merge_inputs.values())
        kept_indices = [i for i in range(len(inner.results)) if i not in consumed]
        new_inner_results = tuple(inner.results[i] for i in kept_indices) + inner_outs
        new_inner = Program(
            name=inner.name,
            inputs=tuple(inner_inputs),
            body=inner.body + (inner_ins,),
            results=new_inner_results,
        )

        # --- rebuild the CE instruction ------------------------------------
        new_ce_outs = tuple(
            Register(_fresh(taken, "ce"), split_type(r.type, self.n))
            for r in new_inner.results
        )
        new_ce = Instruction(
            "cf.ConcurrentExecute",
            tuple(new_ce_inputs),
            new_ce_outs,
            (("P", new_inner),),
        )

        # map kept old ce outputs -> new ce outputs
        remap: Dict[str, Register] = {}
        for new_i, old_i in enumerate(kept_indices):
            remap[ce.outputs[old_i].name] = new_ce_outs[new_i]
        op_outs = new_ce_outs[len(kept_indices):]

        # --- outer replacement for y ---------------------------------------
        outer: List[Instruction] = []
        agg = spec.aggregation
        if agg is None:
            # elementwise: y becomes Merge(s) of the new outputs
            for yr, er in zip(y.outputs, op_outs):
                outer.append(Instruction("cf.Merge", (er,), (yr,)))
        elif agg["kind"] == "scalar":
            aggs: Tuple[AggSpec, ...] = tuple(y.param("aggs"))
            combine = tuple(AggSpec(a.combine_fn, col(a.name), a.name) for a in aggs)
            outer.append(
                Instruction("rel.CombinePartials", (op_outs[0],), (y.outputs[0],),
                            (("aggs", combine),))
            )
        elif agg["kind"] == "grouped":
            aggs = tuple(y.param("aggs"))
            keys = tuple(y.param("keys"))
            combine = tuple(AggSpec(a.combine_fn, col(a.name), a.name) for a in aggs)
            m = Register(_fresh(taken, "gm"), infer_output_types("cf.Merge", {}, [op_outs[0].type])[0])
            outer.append(Instruction("cf.Merge", (op_outs[0],), (m,)))
            recombine_params: Tuple[Tuple[str, Any], ...] = (
                ("keys", keys), ("aggs", combine), ("recombine", True))
            if y.param("max_groups"):
                recombine_params += (("max_groups", y.param("max_groups")),)
            outer.append(
                Instruction("rel.GroupByAggr", (m,), (y.outputs[0],),
                            recombine_params)
            )
        elif agg["kind"] == "segmented":
            for yr, er in zip(y.outputs, op_outs):
                outer.append(
                    Instruction("cf.CombineChunks", (er,), (yr,), (("op", "sum"),))
                )
        else:  # pragma: no cover - future kinds
            raise NotImplementedError(f"aggregation kind {agg['kind']}")

        # --- stitch the body -------------------------------------------------
        consumed_merge_names = set(merge_inputs.keys())
        new_body: List[Instruction] = []
        for ins in program.body:
            if ins is ce:
                for a, br in self._pending_broadcasts:
                    new_body.append(Instruction("cf.Broadcast", (a,), (br,), (("n", self.n),)))
                new_body.append(new_ce)
                continue
            if ins.opcode == "cf.Merge" and ins.outputs and ins.outputs[0].name in consumed_merge_names:
                continue  # absorbed merge disappears
            if ins is y:
                new_body.extend(outer)
                continue
            if any(r.name in remap for r in ins.inputs):
                ins = ins.with_inputs([remap.get(r.name, r) for r in ins.inputs])
            new_body.append(ins)
        self._pending_broadcasts = []
        results = tuple(remap.get(r.name, r) for r in program.results)
        return program.with_body(new_body).with_results(results)

    def apply(self, program: Program, max_iters: int = 200) -> Program:
        self._pending_broadcasts = []
        return super().apply(program, max_iters)
