"""Scalar expression language for instruction parameters.

``rel.Select`` predicates, ``rel.ExProj`` computations, join conditions and
the fused-kernel instruction all carry small scalar expressions over tuple
fields as *constant parameters* (the paper's "instructions may be
parameterized with constant items").  Expressions are immutable, hashable,
typeable against a tuple schema, and lowerable to jnp column arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

from .types import Atom, TupleType, BOOL, F32, F64, I32, I64, STR

# numeric promotion lattice
_RANK = {"bool": 0, "i8": 1, "i16": 2, "i32": 3, "date": 3, "str": 3, "id": 3,
         "u32": 3, "i64": 4, "f16": 5, "bf16": 5, "num": 6, "f32": 6, "f64": 7}
_RANK_TO_ATOM = {0: BOOL, 3: I32, 4: I64, 6: F32, 7: F64}


def _promote(a: Atom, b: Atom) -> Atom:
    r = max(_RANK[a.domain], _RANK[b.domain])
    while r not in _RANK_TO_ATOM:
        r += 1
    return _RANK_TO_ATOM[r]


class Expr:
    """Base class; combinators build the tree."""

    def infer(self, schema: TupleType) -> Atom:
        raise NotImplementedError

    def fields(self) -> Tuple[str, ...]:
        raise NotImplementedError

    # -- operator sugar ----------------------------------------------------
    def _bin(self, op: str, other: Any) -> "Expr":
        return BinOp(op, self, _as_expr(other))

    def __add__(self, o: Any) -> "Expr": return self._bin("add", o)
    def __radd__(self, o: Any) -> "Expr": return _as_expr(o)._bin("add", self)
    def __sub__(self, o: Any) -> "Expr": return self._bin("sub", o)
    def __rsub__(self, o: Any) -> "Expr": return _as_expr(o)._bin("sub", self)
    def __mul__(self, o: Any) -> "Expr": return self._bin("mul", o)
    def __rmul__(self, o: Any) -> "Expr": return _as_expr(o)._bin("mul", self)
    def __truediv__(self, o: Any) -> "Expr": return self._bin("div", o)
    def __lt__(self, o: Any) -> "Expr": return self._bin("lt", o)
    def __le__(self, o: Any) -> "Expr": return self._bin("le", o)
    def __gt__(self, o: Any) -> "Expr": return self._bin("gt", o)
    def __ge__(self, o: Any) -> "Expr": return self._bin("ge", o)
    def eq(self, o: Any) -> "Expr": return self._bin("eq", o)
    def ne(self, o: Any) -> "Expr": return self._bin("ne", o)
    def __and__(self, o: Any) -> "Expr": return self._bin("and", o)
    def __or__(self, o: Any) -> "Expr": return self._bin("or", o)
    def __invert__(self) -> "Expr": return UnOp("not", self)
    def isin(self, values: Tuple[Any, ...]) -> "Expr":
        e: Expr = self.eq(values[0])
        for v in values[1:]:
            e = e | self.eq(v)
        return e
    def between(self, lo: Any, hi: Any) -> "Expr":
        return (self >= lo) & (self <= hi)


@dataclass(frozen=True)
class Col(Expr):
    name: str

    def infer(self, schema: TupleType) -> Atom:
        t = schema.field(self.name)
        if not isinstance(t, Atom):
            raise TypeError(f"column {self.name} is not atomic: {t.render()}")
        return t

    def fields(self) -> Tuple[str, ...]:
        return (self.name,)

    def __repr__(self) -> str:
        return f"${self.name}"


@dataclass(frozen=True)
class Const(Expr):
    value: Any
    atom: Atom

    def infer(self, schema: TupleType) -> Atom:
        return self.atom

    def fields(self) -> Tuple[str, ...]:
        return ()

    def __repr__(self) -> str:
        return repr(self.value)


_CMP = {"lt", "le", "gt", "ge", "eq", "ne"}
_LOGIC = {"and", "or"}
_ARITH = {"add", "sub", "mul", "div", "min", "max"}


@dataclass(frozen=True)
class BinOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr

    def infer(self, schema: TupleType) -> Atom:
        lt, rt = self.lhs.infer(schema), self.rhs.infer(schema)
        if self.op in _CMP:
            return BOOL
        if self.op in _LOGIC:
            if lt != BOOL or rt != BOOL:
                raise TypeError(f"logic op {self.op} on non-bool {lt.render()},{rt.render()}")
            return BOOL
        if self.op in _ARITH:
            if self.op == "div":
                return _promote(_promote(lt, rt), F32)
            return _promote(lt, rt)
        raise TypeError(f"unknown binop {self.op}")

    def fields(self) -> Tuple[str, ...]:
        seen = []
        for f in self.lhs.fields() + self.rhs.fields():
            if f not in seen:
                seen.append(f)
        return tuple(seen)

    def __repr__(self) -> str:
        return f"({self.lhs!r} {self.op} {self.rhs!r})"


@dataclass(frozen=True)
class UnOp(Expr):
    op: str
    arg: Expr

    def infer(self, schema: TupleType) -> Atom:
        t = self.arg.infer(schema)
        if self.op == "not":
            if t != BOOL:
                raise TypeError("not on non-bool")
            return BOOL
        if self.op in ("neg", "abs"):
            return t
        raise TypeError(f"unknown unop {self.op}")

    def fields(self) -> Tuple[str, ...]:
        return self.arg.fields()

    def __repr__(self) -> str:
        return f"{self.op}({self.arg!r})"


def _as_expr(v: Any) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, bool):
        return Const(v, BOOL)
    if isinstance(v, int):
        return Const(v, I64 if abs(v) > 2**31 - 1 else I32)
    if isinstance(v, float):
        return Const(v, F64)
    if isinstance(v, str):
        # string literals stay raw here; the vec lowering remaps them into
        # global-dictionary code space (interp compares them directly)
        return Const(v, STR)
    raise TypeError(f"cannot lift {v!r} into an expression")


def col(name: str) -> Col:
    return Col(name)


def const(v: Any, atom: Atom | None = None) -> Const:
    e = _as_expr(v)
    if atom is not None:
        return Const(e.value, atom)  # type: ignore[union-attr]
    return e  # type: ignore[return-value]


def substitute(e: Expr, mapping: Dict[str, Expr]) -> Expr:
    """Replace column references by expressions (used by fusion rewrites)."""
    if isinstance(e, Col):
        return mapping.get(e.name, e)
    if isinstance(e, Const):
        return e
    if isinstance(e, UnOp):
        return UnOp(e.op, substitute(e.arg, mapping))
    if isinstance(e, BinOp):
        return BinOp(e.op, substitute(e.lhs, mapping), substitute(e.rhs, mapping))
    raise TypeError(f"cannot substitute into {e!r}")


# ---------------------------------------------------------------------------
# Evaluation over column dictionaries (used by lowering and by oracles)
# ---------------------------------------------------------------------------

def evaluate(e: Expr, cols: Dict[str, Any], np_mod: Any) -> Any:
    """Evaluate columnar: ``cols`` maps field name -> array (or scalar)."""
    if isinstance(e, Col):
        return cols[e.name]
    if isinstance(e, Const):
        return e.value
    if isinstance(e, UnOp):
        a = evaluate(e.arg, cols, np_mod)
        if e.op == "not":
            return np_mod.logical_not(a)
        if e.op == "neg":
            return -a
        if e.op == "abs":
            return np_mod.abs(a)
    if isinstance(e, BinOp):
        a = evaluate(e.lhs, cols, np_mod)
        b = evaluate(e.rhs, cols, np_mod)
        return {
            "add": lambda: a + b,
            "sub": lambda: a - b,
            "mul": lambda: a * b,
            "div": lambda: a / b,
            "min": lambda: np_mod.minimum(a, b),
            "max": lambda: np_mod.maximum(a, b),
            "lt": lambda: a < b,
            "le": lambda: a <= b,
            "gt": lambda: a > b,
            "ge": lambda: a >= b,
            "eq": lambda: a == b,
            "ne": lambda: a != b,
            "and": lambda: np_mod.logical_and(a, b),
            "or": lambda: np_mod.logical_or(a, b),
        }[e.op]()
    raise TypeError(f"cannot evaluate {e!r}")


# ---------------------------------------------------------------------------
# Aggregation specs (constant parameters of Aggr/GroupByAggr)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AggSpec:
    """``fn`` ∈ {sum,count,min,max}; ``expr`` the aggregated expression.

    ``avg`` is desugared by frontends into sum/count + a finalizing ExProj so
    that every AggSpec is *self-decomposable*: pre-aggregate per shard with
    ``fn``, combine partials with ``combine_fn`` (count combines with sum).
    This is what makes the paper's pre-aggregation rewrite (Alg. 2) generic.
    """

    fn: str
    expr: Expr
    name: str

    def __post_init__(self) -> None:
        if self.fn not in ("sum", "count", "min", "max"):
            raise ValueError(f"non-decomposable agg fn {self.fn!r}; desugar first")

    @property
    def combine_fn(self) -> str:
        return "sum" if self.fn == "count" else self.fn

    def result_atom(self, schema: TupleType) -> Atom:
        if self.fn == "count":
            return I64
        t = self.expr.infer(schema)
        if self.fn == "sum":
            if t == BOOL:
                return I64  # sum of a predicate = conditional count
            return _promote(t, t)  # canonicalized rank
        return t
