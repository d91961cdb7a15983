"""Structural fingerprints for CVM programs (content-addressed plan keys).

The plan cache must recognise "the same program" across independent
constructions: builders and rewrites draw register names from global
counters, so two runs of the same frontend code produce programs that
differ only by alpha-renaming.  The fingerprint therefore never hashes
register *names*: registers are numbered by definition order (de Bruijn
style — program inputs first, then each instruction's outputs) and uses
hash as those indices.  Nested programs open a fresh scope, so
higher-order instructions (``ConcurrentExecute``, ``Loop``, ``df.Map``,
...) are fingerprinted structurally all the way down.

Everything that can change compiled behaviour *is* hashed: opcodes,
parameter values (expressions, agg specs, schemas, nested programs),
register types (static capacities live in types), and result order.
Program and register names are deliberately excluded.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict

import numpy as np

from ..core.program import Instruction, Program, Register
from ..core.types import Atom, CollectionKind, CollectionType, ItemType, TupleType

__all__ = ["fingerprint", "fingerprint_value", "canonicalize"]


def fingerprint(program: Program) -> str:
    """Hex digest of the program's canonical (alpha-invariant) structure."""
    if not isinstance(program, Program):
        raise TypeError(f"fingerprint() takes a Program, got {type(program).__name__}")
    return fingerprint_value(program)


def fingerprint_value(value: Any) -> str:
    """Hex digest of any parameter-like value (catalogs, options, ...)."""
    h = hashlib.sha256()
    h.update(repr(canonicalize(value)).encode("utf-8"))
    return h.hexdigest()


def canonicalize(value: Any) -> Any:
    """Canonical, name-free, repr-stable tree for a program or param value."""
    return _canon(value)


# ---------------------------------------------------------------------------
# canonical trees
# ---------------------------------------------------------------------------


def _canon_type(t: ItemType) -> Any:
    if isinstance(t, Atom):
        return ("atom", t.domain)
    if isinstance(t, TupleType):
        return ("tuple", tuple((n, _canon_type(ft)) for n, ft in t.fields))
    if isinstance(t, CollectionType):
        return (
            "coll",
            t.kind.name,
            tuple((k, _canon(v)) for k, v in t.attrs),
            _canon_type(t.item),
        )
    return ("type", type(t).__name__, repr(t))


def _canon_program(p: Program) -> Any:
    env: Dict[str, int] = {}
    for r in p.inputs:
        env[r.name] = len(env)

    def ref(r: Register) -> Any:
        idx = env.get(r.name)
        # a use of a register not defined in this scope (ill-formed SSA or a
        # cross-scope reference mid-rewrite): fall back to the name so the
        # fingerprint stays total rather than raising
        return idx if idx is not None else ("free", r.name)

    body = []
    for ins in p.body:
        in_refs = tuple(ref(r) for r in ins.inputs)
        for r in ins.outputs:
            env[r.name] = len(env)
        body.append((
            ins.opcode,
            in_refs,
            tuple(_canon_type(r.type) for r in ins.outputs),
            tuple(sorted(((k, _canon(v)) for k, v in ins.params),
                         key=lambda kv: kv[0])),
        ))
    return (
        "program",
        tuple(_canon_type(r.type) for r in p.inputs),
        tuple(body),
        tuple(ref(r) for r in p.results),
    )


def _canon(v: Any) -> Any:
    if isinstance(v, Program):
        return _canon_program(v)
    if isinstance(v, Instruction):
        return _canon_program(Program("_", (), (v,), ()))
    if isinstance(v, Register):
        return ("reg", _canon_type(v.type))
    if isinstance(v, ItemType):
        return _canon_type(v)
    if isinstance(v, CollectionKind):
        return ("kind", v.name)
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        return (type(v).__name__, v)
    if isinstance(v, (list, tuple)):
        return ("seq", tuple(_canon(x) for x in v))
    if isinstance(v, (set, frozenset)):
        return ("set", tuple(sorted(repr(_canon(x)) for x in v)))
    if isinstance(v, dict):
        return ("map", tuple(sorted(
            (repr(_canon(k)), _canon(val)) for k, val in v.items())))
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), tuple(v.shape),
                hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest())
    if isinstance(v, np.generic):
        return ("npscalar", str(v.dtype), v.item())
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        # Expr trees, AggSpec, and any frontend-defined frozen param records
        return ("obj", type(v).__name__, tuple(
            (f.name, _canon(getattr(v, f.name)))
            for f in dataclasses.fields(v) if f.compare
        ))
    if hasattr(v, "dtype") and hasattr(v, "shape"):  # jax arrays et al.
        return _canon(np.asarray(v))
    # last resort: type + repr (deterministic for anything sane enough to
    # appear as an instruction parameter)
    return ("repr", type(v).__name__, repr(v))
