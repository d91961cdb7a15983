"""CVM programs: SSA sequences of collection instructions.

The abstract machine (paper §3.2) has an unlimited number of immutable
registers holding collections and executes linear sequences of instructions::

    Out_1, ..., Out_m ← Instruction(Para_1, ..., Para_k)(In_1, ..., In_n)

Parameters are constant items *and nested programs* (higher-order
instructions).  Programs are always in SSA form; any transformation must
preserve behaviour *as if executed on that machine*.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

from .types import ItemType


# ---------------------------------------------------------------------------
# Registers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Register:
    """An immutable virtual register holding one collection."""

    name: str
    type: ItemType

    def render(self) -> str:
        return f"%{self.name}"

    def __repr__(self) -> str:  # pragma: no cover
        return f"%{self.name}: {self.type.render()}"


class _NameGen:
    def __init__(self, prefix: str = "r") -> None:
        self._c = itertools.count()
        self.prefix = prefix

    def fresh(self, hint: Optional[str] = None) -> str:
        return f"{hint or self.prefix}{next(self._c)}"


# ---------------------------------------------------------------------------
# Instructions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Instruction:
    """One CVM instruction.

    ``opcode`` is namespaced by IR flavor, e.g. ``rel.Select``,
    ``la.MMMult``, ``vec.ScanVec``, ``mesh.AllReduce``, ``df.Map``.
    ``params`` maps parameter names to constant items or nested ``Program``s.
    """

    opcode: str
    inputs: Tuple[Register, ...] = ()
    outputs: Tuple[Register, ...] = ()
    params: Tuple[Tuple[str, Any], ...] = ()

    # -- param helpers ------------------------------------------------------
    def param(self, name: str, default: Any = None) -> Any:
        for k, v in self.params:
            if k == name:
                return v
        return default

    def with_params(self, **updates: Any) -> "Instruction":
        d = dict(self.params)
        d.update(updates)
        return replace(self, params=tuple(d.items()))

    def with_inputs(self, inputs: Sequence[Register]) -> "Instruction":
        return replace(self, inputs=tuple(inputs))

    def with_outputs(self, outputs: Sequence[Register]) -> "Instruction":
        return replace(self, outputs=tuple(outputs))

    def with_opcode(self, opcode: str) -> "Instruction":
        return replace(self, opcode=opcode)

    @property
    def flavor(self) -> str:
        return self.opcode.split(".", 1)[0] if "." in self.opcode else ""

    @property
    def name(self) -> str:
        return self.opcode.split(".", 1)[-1]

    def nested_programs(self) -> Iterator[Tuple[str, "Program"]]:
        for k, v in self.params:
            if isinstance(v, Program):
                yield k, v

    def is_higher_order(self) -> bool:
        return any(True for _ in self.nested_programs())

    def map_nested(self, fn: Callable[["Program"], "Program"]) -> "Instruction":
        new_params = tuple(
            (k, fn(v) if isinstance(v, Program) else v) for k, v in self.params
        )
        return replace(self, params=new_params)

    def render(self) -> str:
        outs = ", ".join(r.render() for r in self.outputs)
        ins = ", ".join(r.render() for r in self.inputs)
        ps = []
        for k, v in self.params:
            if isinstance(v, Program):
                ps.append(f"{k}=@{v.name}")
            else:
                ps.append(f"{k}={v!r}")
        para = ", ".join(ps)
        head = f"{outs} ← " if outs else ""
        return f"{head}{self.opcode}({para})({ins})"


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Program:
    """An SSA sequence of instructions with declared inputs and results.

    ``results`` plays the role of the paper's ``Return`` instruction: the
    registers whose values the program yields.
    """

    name: str
    inputs: Tuple[Register, ...]
    body: Tuple[Instruction, ...]
    results: Tuple[Register, ...]

    # -- structural queries --------------------------------------------------
    def defs(self) -> Dict[str, Register]:
        d = {r.name: r for r in self.inputs}
        for ins in self.body:
            for r in ins.outputs:
                d[r.name] = r
        return d

    def producers(self) -> Dict[str, Instruction]:
        p: Dict[str, Instruction] = {}
        for ins in self.body:
            for r in ins.outputs:
                p[r.name] = ins
        return p

    def consumers(self) -> Dict[str, List[Instruction]]:
        c: Dict[str, List[Instruction]] = {}
        for ins in self.body:
            for r in ins.inputs:
                c.setdefault(r.name, []).append(ins)
        for r in self.results:
            c.setdefault(r.name, [])
        return c

    def uses(self, reg: Register) -> int:
        n = sum(1 for ins in self.body for r in ins.inputs if r.name == reg.name)
        n += sum(1 for r in self.results if r.name == reg.name)
        return n

    def result_types(self) -> Tuple[ItemType, ...]:
        return tuple(r.type for r in self.results)

    def input_types(self) -> Tuple[ItemType, ...]:
        return tuple(r.type for r in self.inputs)

    # -- rewriting helpers ---------------------------------------------------
    def with_body(self, body: Sequence[Instruction]) -> "Program":
        return replace(self, body=tuple(body))

    def with_results(self, results: Sequence[Register]) -> "Program":
        return replace(self, results=tuple(results))

    def with_name(self, name: str) -> "Program":
        return replace(self, name=name)

    def map_instructions(self, fn: Callable[[Instruction], Sequence[Instruction]]) -> "Program":
        """Replace each instruction by a sequence (1->n rewriting)."""
        new_body: List[Instruction] = []
        for ins in self.body:
            new_body.extend(fn(ins))
        return self.with_body(new_body)

    def substitute(self, mapping: Mapping[str, Register]) -> "Program":
        """Rename register *uses* (not defs) according to ``mapping``."""

        def sub(r: Register) -> Register:
            return mapping.get(r.name, r)

        body = tuple(
            ins.with_inputs([sub(r) for r in ins.inputs]) for ins in self.body
        )
        return replace(
            self,
            body=body,
            results=tuple(sub(r) for r in self.results),
        )

    def rename_all(self, suffix: str) -> "Program":
        """Alpha-rename every register (inputs, defs, uses) with a suffix.

        Used when inlining/copying programs so SSA names stay unique.
        """

        mapping = {r.name: Register(r.name + suffix, r.type) for r in self.inputs}
        for ins in self.body:
            for r in ins.outputs:
                mapping[r.name] = Register(r.name + suffix, r.type)

        def sub(r: Register) -> Register:
            return mapping.get(r.name, r)

        body = tuple(
            ins.with_inputs([sub(r) for r in ins.inputs]).with_outputs(
                [sub(r) for r in ins.outputs]
            )
            for ins in self.body
        )
        return Program(
            name=self.name,
            inputs=tuple(sub(r) for r in self.inputs),
            body=body,
            results=tuple(sub(r) for r in self.results),
        )

    def walk(self) -> Iterator["Program"]:
        """Yield this program and all nested programs, depth-first."""
        yield self
        for ins in self.body:
            for _, p in ins.nested_programs():
                yield from p.walk()

    def opcodes(self) -> List[str]:
        return [ins.opcode for p in self.walk() for ins in p.body]

    def render(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [
            f"{pad}program {self.name}("
            + ", ".join(f"{r.render()}: {r.type.render()}" for r in self.inputs)
            + ")"
        ]
        for ins in self.body:
            lines.append(pad + "  " + ins.render())
            for _, p in ins.nested_programs():
                lines.append(p.render(indent + 2))
        lines.append(pad + "  Return(" + ", ".join(r.render() for r in self.results) + ")")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        return self.render()


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


class Builder:
    """Imperative construction of SSA programs with automatic typing.

    Typing rules come from the instruction registry (``core.registry``): the
    builder calls the opcode's signature function to derive output types, so
    frontends never write types by hand.
    """

    def __init__(self, name: str, prefix: str = "r") -> None:
        self.name = name
        self._names = _NameGen(prefix)
        self._inputs: List[Register] = []
        self._body: List[Instruction] = []

    # -- inputs --------------------------------------------------------------
    def input(self, hint: str, type: ItemType) -> Register:
        r = Register(self._names.fresh(hint), type)
        self._inputs.append(r)
        return r

    def fresh(self, type: ItemType, hint: Optional[str] = None) -> Register:
        return Register(self._names.fresh(hint), type)

    # -- emission --------------------------------------------------------------
    def emit(
        self,
        opcode: str,
        inputs: Sequence[Register] = (),
        params: Optional[Mapping[str, Any]] = None,
        out_types: Optional[Sequence[ItemType]] = None,
        out_hints: Optional[Sequence[str]] = None,
    ) -> Tuple[Register, ...]:
        from .registry import infer_output_types  # local import to avoid cycle

        params = dict(params or {})
        if out_types is None:
            out_types = infer_output_types(opcode, params, [r.type for r in inputs])
        hints = list(out_hints or [])
        outs = tuple(
            Register(self._names.fresh(hints[i] if i < len(hints) else None), t)
            for i, t in enumerate(out_types)
        )
        self._body.append(
            Instruction(
                opcode=opcode,
                inputs=tuple(inputs),
                outputs=outs,
                params=tuple(params.items()),
            )
        )
        return outs

    def emit1(self, opcode: str, inputs: Sequence[Register] = (), params: Optional[Mapping[str, Any]] = None,
              out_type: Optional[ItemType] = None, hint: Optional[str] = None) -> Register:
        outs = self.emit(
            opcode, inputs, params,
            out_types=[out_type] if out_type is not None else None,
            out_hints=[hint] if hint else None,
        )
        if len(outs) != 1:
            raise ValueError(f"{opcode} produced {len(outs)} outputs, expected 1")
        return outs[0]

    def append(self, ins: Instruction) -> None:
        self._body.append(ins)

    def finish(self, *results: Register) -> Program:
        return Program(
            name=self.name,
            inputs=tuple(self._inputs),
            body=tuple(self._body),
            results=tuple(results),
        )


def subprogram(name: str, inputs: Sequence[Tuple[str, ItemType]],
               build: Callable[[Builder, Tuple[Register, ...]], Sequence[Register]]) -> Program:
    """Convenience for nested-program parameters of higher-order instructions."""
    b = Builder(name)
    regs = tuple(b.input(n, t) for n, t in inputs)
    results = build(b, regs)
    return b.finish(*results)
