"""Program verifier: SSA discipline + typing rules.

Any rewriting must leave programs verifiable — tests call ``verify`` after
every pass.  Semantics must be preserved "as if executed on the abstract
machine"; this checks the static half of that contract.
"""

from __future__ import annotations

from typing import List, Sequence, Set

from . import registry
from .program import Instruction, Program
from .types import ItemType


class VerificationError(Exception):
    pass


def verify(program: Program, *, allow_unknown_ops: bool = True) -> None:
    """Raise ``VerificationError`` on SSA or typing violations.

    Checks, per program (recursing into nested programs):
      * every register is assigned exactly once (SSA);
      * every use is dominated by its definition (linear order);
      * register types at use sites match their definitions;
      * output types match the opcode's typing rule (if registered);
      * results refer to defined registers.
    """
    _verify_one(program, allow_unknown_ops, path=program.name)


def _verify_one(program: Program, allow_unknown: bool, path: str) -> None:
    defined: Set[str] = set()
    types: dict = {}
    for r in program.inputs:
        if r.name in defined:
            raise VerificationError(f"{path}: duplicate input register {r.name}")
        defined.add(r.name)
        types[r.name] = r.type

    for idx, ins in enumerate(program.body):
        where = f"{path}[{idx}] {ins.opcode}"
        # uses
        for r in ins.inputs:
            if r.name not in defined:
                raise VerificationError(f"{where}: use of undefined register %{r.name}")
            if types[r.name] != r.type:
                raise VerificationError(
                    f"{where}: register %{r.name} used at type {r.type.render()} "
                    f"but defined at {types[r.name].render()}"
                )
        # typing rule
        spec = registry.lookup(ins.opcode)
        if spec is None:
            if not allow_unknown:
                raise VerificationError(f"{where}: unknown opcode")
        else:
            try:
                expected = list(spec.signature(dict(ins.params), [r.type for r in ins.inputs]))
            except Exception as e:  # typing rule rejected the inputs
                raise VerificationError(f"{where}: typing rule failed: {e}") from e
            actual = [r.type for r in ins.outputs]
            if len(expected) != len(actual):
                raise VerificationError(
                    f"{where}: arity mismatch, rule gives {len(expected)} outputs, "
                    f"instruction has {len(actual)}"
                )
            for i, (e, a) in enumerate(zip(expected, actual)):
                if e != a:
                    raise VerificationError(
                        f"{where}: output {i} type {a.render()} != rule type {e.render()}"
                    )
        # defs
        for r in ins.outputs:
            if r.name in defined:
                raise VerificationError(f"{where}: register %{r.name} assigned twice (SSA)")
            defined.add(r.name)
            types[r.name] = r.type
        # nested programs
        for pname, p in ins.nested_programs():
            _verify_one(p, allow_unknown, path=f"{path}/{ins.opcode}.{pname}:{p.name}")

    for r in program.results:
        if r.name not in defined:
            raise VerificationError(f"{path}: Return of undefined register %{r.name}")
        if types[r.name] != r.type:
            raise VerificationError(
                f"{path}: Return register %{r.name} at type {r.type.render()} "
                f"but defined at {types[r.name].render()}"
            )


def verify_types_only(types_a: Sequence[ItemType], types_b: Sequence[ItemType]) -> bool:
    return len(types_a) == len(types_b) and all(a == b for a, b in zip(types_a, types_b))
