"""Dead code elimination: drop pure instructions whose outputs are unused."""

from __future__ import annotations

from typing import List, Optional, Set

from .. import registry
from ..program import Program
from .rewriter import ProgramRule


class DeadCodeElimination(ProgramRule):
    name = "dce"

    def run(self, program: Program) -> Optional[Program]:
        live: Set[str] = {r.name for r in program.results}
        keep = [False] * len(program.body)
        # backward liveness sweep
        for i in range(len(program.body) - 1, -1, -1):
            ins = program.body[i]
            spec = registry.lookup(ins.opcode)
            pure = spec.pure if spec is not None else False  # unknown ops: keep
            has_live_out = any(r.name in live for r in ins.outputs)
            if has_live_out or not pure or (spec is not None and spec.sink):
                keep[i] = True
                for r in ins.inputs:
                    live.add(r.name)
        if all(keep):
            return None
        return program.with_body([ins for ins, k in zip(program.body, keep) if k])
