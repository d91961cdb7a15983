"""Common subexpression elimination over pure instructions.

Two instructions are congruent if opcode, canonicalized inputs and params
match (params include nested programs — compared structurally, which frozen
dataclasses give us for free).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import registry
from ..program import Instruction, Program, Register
from .rewriter import ProgramRule


def _key(ins: Instruction) -> Tuple:
    return (ins.opcode, tuple(r.name for r in ins.inputs), ins.params)


class CommonSubexpressionElimination(ProgramRule):
    name = "cse"

    def run(self, program: Program) -> Optional[Program]:
        seen: Dict[Tuple, Instruction] = {}
        replace: Dict[str, Register] = {}
        new_body: List[Instruction] = []
        changed = False

        for ins in program.body:
            # apply pending substitutions to inputs first
            if any(r.name in replace for r in ins.inputs):
                ins = ins.with_inputs([replace.get(r.name, r) for r in ins.inputs])
                changed = True
            spec = registry.lookup(ins.opcode)
            cse_ok = spec is not None and spec.pure and not spec.source and not spec.barrier
            if not cse_ok:
                new_body.append(ins)
                continue
            k = _key(ins)
            prev = seen.get(k)
            if prev is None:
                seen[k] = ins
                new_body.append(ins)
            else:
                changed = True
                for old, new in zip(ins.outputs, prev.outputs):
                    replace[old.name] = new

        if not changed:
            return None
        results = tuple(replace.get(r.name, r) for r in program.results)
        return program.with_body(new_body).with_results(results)
