"""The rewriter framework: rules, passes, fixpoints.

Two rule granularities:

* ``InstructionRule`` — local 1→N rewrites (lowering one instruction into a
  sequence of another flavor's instructions).  The rule must bind the same
  output registers (possibly re-typed via an explicit adapter).
* ``ProgramRule`` — whole-program restructurings (parallelization, fusion,
  pipeline extraction) that need to look at producer/consumer structure.

``PassManager`` runs passes in order, each to a fixpoint (bounded), recursing
into nested programs, verifying after each pass when ``check=True``.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from ..program import Instruction, Program
from ..verify import verify


class FixpointWarning(UserWarning):
    """A pass hit its iteration bound while still reporting changes."""


class Pass:
    """Base class: transform a program (or return None for no change)."""

    name: str = "pass"
    recurse: bool = True  # also apply inside nested programs?

    def run(self, program: Program) -> Optional[Program]:
        raise NotImplementedError

    # -- driver ------------------------------------------------------------
    def apply(self, program: Program, max_iters: int = 50) -> Program:
        cur = program
        if self.recurse:
            cur = self._recurse_nested(cur, max_iters)
        for _ in range(max_iters):
            nxt = self.run(cur)
            if nxt is None:
                return cur
            cur = nxt
            if self.recurse:
                cur = self._recurse_nested(cur, max_iters)
        # the loop exhausted its budget: a silent half-rewritten program is a
        # debugging trap, so probe once more and complain if still changing
        if self.run(cur) is not None:
            warnings.warn(
                f"pass {self.name!r} hit max_iters={max_iters} while still "
                "reporting changes; returning the partially rewritten program",
                FixpointWarning,
                stacklevel=2,
            )
        return cur

    def _recurse_nested(self, program: Program, max_iters: int) -> Program:
        def fix(ins: Instruction) -> Sequence[Instruction]:
            if ins.is_higher_order():
                return [ins.map_nested(lambda p: self.apply(p, max_iters))]
            return [ins]

        return program.map_instructions(fix)


class InstructionRule(Pass):
    """Rewrite single instructions; unknown instructions are left as is."""

    def rewrite(self, ins: Instruction, program: Program) -> Optional[Sequence[Instruction]]:
        raise NotImplementedError

    def run(self, program: Program) -> Optional[Program]:
        changed = False
        new_body: List[Instruction] = []
        for ins in program.body:
            repl = self.rewrite(ins, program)
            if repl is None:
                new_body.append(ins)
            else:
                changed = True
                new_body.extend(repl)
        if not changed:
            return None
        return program.with_body(new_body)


class ProgramRule(Pass):
    pass


@dataclass
class PassManager:
    passes: List[Pass]
    check: bool = True
    allow_unknown_ops: bool = True
    trace: Optional[Callable[[str, Program], None]] = None

    def run(self, program: Program) -> Program:
        cur = program
        if self.check:
            verify(cur, allow_unknown_ops=self.allow_unknown_ops)
        for p in self.passes:
            cur = p.apply(cur)
            if self.check:
                try:
                    verify(cur, allow_unknown_ops=self.allow_unknown_ops)
                except Exception as e:
                    raise AssertionError(
                        f"pass {p.name!r} broke the program:\n{cur.render()}"
                    ) from e
            if self.trace is not None:
                self.trace(p.name, cur)
        return cur


def pipeline(*passes: Pass, check: bool = True) -> PassManager:
    return PassManager(list(passes), check=check)
