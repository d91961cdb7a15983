"""Lower ``Expr`` trees to typed postfix programs.

The Pallas kernels of the JAX package close over the query's expressions
and compile one kernel per query.  A program computes the predicate and
the aggregated values of one row: ``codegen`` turns it into straight-line
C++ for the kernels generated per query (``fused_select_agg``,
``grouped_select_agg``), and ``grouped_join_agg``, built once, carries it
to the card and interprets it (``csrc/exprvm.cuh``).

A program is an ``(n, 2)`` int32 array of ``(opcode, argument)`` pairs.
Its first ``n_pred`` instructions leave the predicate in output slot 0;
the rest leave aggregated value ``k`` (as f32) in slot ``1 + k``.

Types are fixed here, by the JAX package's promotion rules with x64 off:
columns are i32, f32 or bool; a Python int or float constant is weakly
typed and takes the other operand's type; int op float gives f32, ``div``
always gives f32, and an int compared with a Python float compares in
f32.  A float constant is rounded to f32 once, here, as JAX and numpy 2
round it: Q6's ``l_discount <= 0.07`` holds for the stored f32 0.07 only
against f32(0.07).

``interpret`` runs a program on numpy columns with the same 32-bit
arithmetic, so the lowering is testable without a card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.expr import BinOp, Col, Const, Expr, UnOp

#: kept in step with ``enum VmOp`` in csrc/exprvm.cuh (a test compares them)
OPCODES: Dict[str, int] = {
    "LOAD_I32": 1, "LOAD_F32": 2, "LOAD_U8": 3, "CONST": 4,
    "ADD_I": 5, "SUB_I": 6, "MUL_I": 7, "MIN_I": 8, "MAX_I": 9,
    "NEG_I": 10, "ABS_I": 11,
    "ADD_F": 12, "SUB_F": 13, "MUL_F": 14, "DIV_F": 15, "MIN_F": 16,
    "MAX_F": 17, "NEG_F": 18, "ABS_F": 19,
    "LT_I": 20, "LE_I": 21, "GT_I": 22, "GE_I": 23, "EQ_I": 24, "NE_I": 25,
    "LT_F": 26, "LE_F": 27, "GT_F": 28, "GE_F": 29, "EQ_F": 30, "NE_F": 31,
    "AND": 32, "OR": 33, "NOT": 34, "I2F": 35, "EMIT": 36,
}
_NAMES = {v: k for k, v in OPCODES.items()}

#: the interpreter's fixed limits (``VM_MAX_STACK`` / ``VM_MAX_ACC``); the
#: generated kernels have no stack and take ``max_stack=None``
MAX_STACK = 16
MAX_VALUES = 16

#: column type codes (``enum VmColType``)
COL_TYPES = {"i": 0, "f": 1, "b": 2}

_LOAD = {"i": "LOAD_I32", "f": "LOAD_F32", "b": "LOAD_U8"}
_ARITH = {"add", "sub", "mul", "min", "max"}
_CMP = {"lt", "le", "gt", "ge", "eq", "ne"}


@dataclass(frozen=True)
class ExprProgram:
    code: np.ndarray  # (n, 2) int32: (opcode, argument)
    n_pred: int       # instructions computing the predicate (slot 0)
    n_values: int     # aggregated values (slots 1..n_values)
    max_depth: int    # deepest stack the program reaches


def column_type(dtype: Any) -> str:
    """The VM type of a column dtype (torch or numpy): i, f or b."""
    name = str(dtype).replace("torch.", "")
    if name == "int32":
        return "i"
    if name == "float32":
        return "f"
    if name == "bool":
        return "b"
    raise TypeError(f"kernel columns must be int32, float32 or bool, not {name}")


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

# A lowered subtree is (code, type).  type ∈ {"i", "f", "b"} for values
# computed per row, or "wi" / "wf" / "wb" for a Python constant whose
# instruction is chosen only once the partner's type is known (code is then
# the constant itself).


def _f32_bits(v: float) -> int:
    return int(np.array([v], np.float32).view(np.int32)[0])


def _i32(v: int) -> int:
    if not -(1 << 31) <= int(v) < (1 << 31):
        raise OverflowError(f"integer constant {v} does not fit int32")
    return int(v)


def _as(sub: Tuple[Any, str], target: str) -> List[Tuple[str, int]]:
    """Code that leaves ``sub`` on the stack as ``target`` (i, f or b)."""
    code, t = sub
    if t in ("wi", "wf", "wb"):
        if target == "f":
            return [("CONST", _f32_bits(float(code)))]
        if target == "i":
            return [("CONST", _i32(int(code)))]
        return [("CONST", int(bool(code)))]
    if t == target or (t == "b" and target == "i"):
        return list(code)  # bools are 0/1 ints on the stack
    if target == "f":
        return list(code) + [("I2F", 0)]
    raise TypeError(f"cannot use a {t} value as {target}")


def _promote(lt: str, rt: str, what: str) -> str:
    """Operand type of a binary arithmetic or comparison op."""
    if "f" in (lt, rt) or "wf" in (lt, rt):
        return "f"
    if lt == "b" and rt == "b":
        raise TypeError(f"{what} on two bool operands is not supported by the kernels")
    return "i"


def _fold(op: str, a: Any, b: Any) -> Any:
    return {"add": lambda: a + b, "sub": lambda: a - b, "mul": lambda: a * b,
            "div": lambda: a / b, "min": lambda: min(a, b),
            "max": lambda: max(a, b), "lt": lambda: a < b,
            "le": lambda: a <= b, "gt": lambda: a > b, "ge": lambda: a >= b,
            "eq": lambda: a == b, "ne": lambda: a != b,
            "and": lambda: bool(a) and bool(b),
            "or": lambda: bool(a) or bool(b)}[op]()


def _weak(v: Any) -> Tuple[Any, str]:
    if isinstance(v, (bool, np.bool_)):
        return bool(v), "wb"
    if isinstance(v, (int, np.integer)):
        return int(v), "wi"
    if isinstance(v, (float, np.floating)):
        return float(v), "wf"
    raise TypeError(f"constant {v!r} cannot go into a kernel program")


def _lower(e: Expr, col_types: Mapping[str, str],
           slots: Mapping[str, int]) -> Tuple[Any, str]:
    if isinstance(e, Col):
        t = col_types[e.name]
        return [(_LOAD[t], slots[e.name])], t
    if isinstance(e, Const):
        return _weak(e.value)
    if isinstance(e, UnOp):
        sub = _lower(e.arg, col_types, slots)
        code, t = sub
        if t.startswith("w"):
            v = code
            folded = {"not": lambda: not v, "neg": lambda: -v,
                      "abs": lambda: abs(v)}[e.op]()
            return _weak(folded)
        if e.op == "not":
            return _as(sub, "b") + [("NOT", 0)], "b"
        if t == "b":
            raise TypeError(f"{e.op} on a bool is not supported by the kernels")
        suffix = "_F" if t == "f" else "_I"
        return list(code) + [(e.op.upper() + suffix, 0)], t
    if isinstance(e, BinOp):
        ls = _lower(e.lhs, col_types, slots)
        rs = _lower(e.rhs, col_types, slots)
        if ls[1].startswith("w") and rs[1].startswith("w"):
            return _weak(_fold(e.op, ls[0], rs[0]))
        if e.op in ("and", "or"):
            if ls[1] not in ("b", "wb") or rs[1] not in ("b", "wb"):
                raise TypeError(f"{e.op} needs bool operands")
            return _as(ls, "b") + _as(rs, "b") + [(e.op.upper(), 0)], "b"
        if e.op == "div":
            return _as(ls, "f") + _as(rs, "f") + [("DIV_F", 0)], "f"
        t = _promote(ls[1], rs[1], e.op)
        code = _as(ls, t) + _as(rs, t)
        suffix = "_F" if t == "f" else "_I"
        if e.op in _CMP:
            return code + [(e.op.upper() + suffix, 0)], "b"
        if e.op in _ARITH:
            return code + [(e.op.upper() + suffix, 0)], t
        raise TypeError(f"unknown binop {e.op}")
    raise TypeError(f"cannot lower {e!r}")


def _depth(code: Sequence[Tuple[str, int]]) -> int:
    sp = best = 0
    for op, _ in code:
        if op.startswith("LOAD") or op == "CONST":
            sp += 1
        elif op == "EMIT" or op in ("AND", "OR", "DIV_F") or op[:-2] in (
                {o.upper() for o in _ARITH | _CMP}):
            sp -= 1
        best = max(best, sp)
    return best


def compile_program(pred: Optional[Expr], values: Sequence[Expr],
                    col_types: Mapping[str, str], slots: Mapping[str, int],
                    max_stack: Optional[int] = MAX_STACK) -> ExprProgram:
    """One program: the predicate (``None`` → always true) into slot 0,
    then each of ``values`` as f32 into slots 1, 2, ...  Raises where the
    kernels cannot run it: too many values, or a stack deeper than
    ``max_stack`` (``None``: no limit, for the generated kernels)."""
    if len(values) > MAX_VALUES:
        raise ValueError(f"{len(values)} aggregated values; the kernels take "
                         f"at most {MAX_VALUES}")
    code: List[Tuple[str, int]] = []
    if pred is None:
        code.append(("CONST", 1))
    else:
        sub = _lower(pred, col_types, slots)
        if sub[1] not in ("b", "wb"):
            raise TypeError(f"predicate {pred!r} is not boolean")
        code += _as(sub, "b")
    code.append(("EMIT", 0))
    n_pred = len(code)
    for k, e in enumerate(values):
        code += _as(_lower(e, col_types, slots), "f")
        code.append(("EMIT", 1 + k))
    depth = _depth(code)
    if max_stack is not None and depth > max_stack:
        raise ValueError(f"expression needs a stack of {depth}; the interpreter "
                         f"holds {max_stack}")
    arr = np.array([(OPCODES[op], arg) for op, arg in code], dtype=np.int32)
    return ExprProgram(arr.reshape(-1, 2), n_pred, len(values), depth)


# ---------------------------------------------------------------------------
# reference interpreter (numpy, the VM's 32-bit arithmetic)
# ---------------------------------------------------------------------------


def interpret(prog: ExprProgram, cols: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Run ``prog`` over whole columns (``cols[j]`` is slot ``j``): the
    predicate as bool, then each value as f32 — what the kernels compute
    per row."""
    n = len(cols[0]) if cols else 1
    out: List[Any] = [None] * (1 + prog.n_values)
    st: List[np.ndarray] = []
    with np.errstate(all="ignore"):
        for op_code, arg in prog.code.tolist():
            op = _NAMES[op_code]
            if op == "LOAD_I32":
                st.append(np.asarray(cols[arg]).astype(np.int32))
            elif op == "LOAD_F32":
                st.append(np.asarray(cols[arg]).astype(np.float32))
            elif op == "LOAD_U8":
                st.append(np.asarray(cols[arg]).astype(np.int32))
            elif op == "CONST":
                st.append(np.full(n, arg, np.int32))
            elif op == "EMIT":
                out[arg] = st.pop()
            elif op == "I2F":
                st.append(st.pop().astype(np.float32))
            elif op == "NOT":
                st.append((1 - st.pop()).astype(np.int32))
            elif op in ("NEG_I", "ABS_I"):
                a = st.pop()
                st.append((-a if op == "NEG_I" else np.abs(a)).astype(np.int32))
            elif op in ("NEG_F", "ABS_F"):
                a = _f(st.pop())
                st.append(-a if op == "NEG_F" else np.abs(a))
            else:
                b, a = st.pop(), st.pop()
                st.append(_binary(op, a, b))
    pred = out[0].astype(bool)
    return [pred] + [_f(v) for v in out[1:]]


def _f(v: np.ndarray) -> np.ndarray:
    """Stack words as f32: CONST leaves float bits in an int32 word."""
    return v.view(np.float32) if v.dtype == np.int32 else v.astype(np.float32)


def _binary(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    kind = op[-1]
    name = op[:-2] if op[-2] == "_" else op
    if kind == "F":
        a, b = _f(a), _f(b)
        r = {"ADD": lambda: a + b, "SUB": lambda: a - b, "MUL": lambda: a * b,
             "DIV": lambda: a / b, "MIN": lambda: np.fmin(a, b),
             "MAX": lambda: np.fmax(a, b), "LT": lambda: a < b,
             "LE": lambda: a <= b, "GT": lambda: a > b, "GE": lambda: a >= b,
             "EQ": lambda: a == b, "NE": lambda: a != b}[name]()
        return r.astype(np.int32) if r.dtype == bool else r.astype(np.float32)
    if op in ("AND", "OR"):
        return (a & b) if op == "AND" else (a | b)
    a, b = a.astype(np.int32), b.astype(np.int32)
    r = {"ADD": lambda: a + b, "SUB": lambda: a - b, "MUL": lambda: a * b,
         "MIN": lambda: np.minimum(a, b), "MAX": lambda: np.maximum(a, b),
         "LT": lambda: a < b, "LE": lambda: a <= b, "GT": lambda: a > b,
         "GE": lambda: a >= b, "EQ": lambda: a == b, "NE": lambda: a != b}[name]()
    return r.astype(np.int32)
