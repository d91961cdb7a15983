"""The kernels' expression programs against the JAX package's evaluation.

``repro_torch.kernels.exprcode`` lowers an ``Expr`` to the typed postfix
program that ``codegen`` writes out as the CUDA kernels' row functions;
``exprcode.interpret`` runs it with the same 32-bit arithmetic on numpy.  Each case here evaluates the same
expression with ``repro.core.expr.evaluate`` on jax.numpy (x64 off) and
compares.  Predicates must agree exactly; values within rtol 1e-6, since
XLA may fuse a multiply and an add into one FMA where the program rounds
twice.
"""

import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import expr as jexpr  # noqa: E402
from repro_torch.core import expr as texpr  # noqa: E402
from repro_torch.kernels import exprcode  # noqa: E402

N = 257


@pytest.fixture(scope="module")
def columns():
    rng = np.random.default_rng(11)
    d = np.round(rng.uniform(0.0, 0.10, N), 2).astype(np.float32)
    d[:8] = np.float32(0.07)  # the f32-constant case must be exercised
    return {
        "i": rng.integers(-40, 40, N).astype(np.int32),
        "j": rng.integers(1, 9, N).astype(np.int32),
        "x": rng.uniform(-3, 3, N).astype(np.float32),
        "d": d,
        "b": rng.random(N) < 0.5,
    }


def _both(build):
    """The same expression in both packages' Expr classes."""
    return build(jexpr), build(texpr)


def _bin(m, op, a, b):
    return m.BinOp(op, a, b if isinstance(b, m.Expr) else m.const(b))


CASES = {
    "f32_const_rounding": lambda m: m.col("d") <= 0.07,
    "q6_between": lambda m: m.col("d").between(0.05, 0.07) & (m.col("x") < 2.4),
    "int_vs_float": lambda m: m.col("i") > 2.5,
    "int_vs_int_const": lambda m: m.col("i").isin((3, -7, 11)),
    "int_div_int": lambda m: m.col("i") / m.col("j"),
    "int_mul_plus_float": lambda m: m.col("i") * 3 + m.col("x"),
    "float_arith": lambda m: m.col("x") * (1.0 - m.col("d")) * (1.0 + m.col("d")),
    "neg_abs": lambda m: m.UnOp("abs", m.col("i")) - m.UnOp("neg", m.col("x")),
    "min_max": lambda m: _bin(m, "max", _bin(m, "min", m.col("i"), m.col("x")), -1),
    "int_min_const": lambda m: _bin(m, "min", m.col("i"), 5),
    "bool_logic": lambda m: ~m.col("b") & (m.col("i").ne(3) | (m.col("x") < 0.0)),
    "bool_times_float": lambda m: (m.col("i") < 30) * (m.col("x") * (1.0 - m.col("d"))),
    "bool_plus_int": lambda m: m.col("b") + 1,
    "bool_eq_const": lambda m: m.col("b").eq(True),
    "const_fold": lambda m: m.const(1.5) * 2 + m.col("x"),
    "float_const_first": lambda m: m.const(100.0) * m.col("x") / m.col("j"),
}


def _run(e_t, cols, as_pred):
    names = sorted(cols)
    types = {n: exprcode.column_type(cols[n].dtype) for n in names}
    slots = {n: k for k, n in enumerate(names)}
    if as_pred:
        prog = exprcode.compile_program(e_t, (), types, slots)
        return exprcode.interpret(prog, [cols[n] for n in names])[0]
    prog = exprcode.compile_program(None, (e_t,), types, slots)
    return exprcode.interpret(prog, [cols[n] for n in names])[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_matches_jax_evaluate(case, columns):
    e_j, e_t = _both(CASES[case])
    want = np.asarray(jexpr.evaluate(e_j, {k: jnp.asarray(v) for k, v in columns.items()},
                                     jnp))
    if want.ndim == 0:
        want = np.full(N, want)
    if want.dtype == bool:
        got = _run(e_t, columns, as_pred=True)
        np.testing.assert_array_equal(got, want)
    else:
        got = _run(e_t, columns, as_pred=False)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-6)


def test_f32_rounding_is_the_case_that_matters(columns):
    """Against double 0.07 the stored f32(0.07) fails ``<=``; the program
    compares against f32(0.07), as JAX does, and keeps those rows."""
    assert not float(np.float32(0.07)) <= 0.07
    got = _run(texpr.col("d") <= 0.07, columns, as_pred=True)
    assert got[:8].all()


def test_predicate_none_is_true_and_values_follow(columns):
    prog = exprcode.compile_program(None, (texpr.col("x"), texpr.col("i")),
                                    {"x": "f", "i": "i"}, {"x": 0, "i": 1})
    pred, x, i = exprcode.interpret(prog, [columns["x"], columns["i"]])
    assert pred.all()
    np.testing.assert_array_equal(x, columns["x"])
    np.testing.assert_array_equal(i, columns["i"].astype(np.float32))
    assert prog.n_values == 2 and prog.code.dtype == np.int32


def test_deep_stack_raises():
    e = texpr.col("x")
    for _ in range(20):
        e = texpr.col("x") + e  # right-leaning: every level stays on the stack
    with pytest.raises(ValueError, match="stack"):
        exprcode.compile_program(None, (e,), {"x": "f"}, {"x": 0})


def test_unsupported_forms_raise():
    with pytest.raises(TypeError):
        exprcode.compile_program(None, (texpr.col("b") + texpr.col("b"),),
                                 {"b": "b"}, {"b": 0})
    with pytest.raises(TypeError):
        exprcode.compile_program(texpr.col("x") + 1.0, (), {"x": "f"}, {"x": 0})
    with pytest.raises(TypeError):
        exprcode.column_type("int64")
    with pytest.raises(ValueError):
        exprcode.compile_program(None, (texpr.col("x"),) * 17, {"x": "f"}, {"x": 0})


def _one_op(op):
    """A program segment that runs ``op`` once on loaded operands of its
    type (slot 0 an i32 column, 1 an f32 one, 2 a bool one) and emits it."""
    load = {"i": ("LOAD_I32", 0), "f": ("LOAD_F32", 1), "b": ("LOAD_U8", 2)}
    kind = {"LOAD_I32": "i", "LOAD_F32": "f", "LOAD_U8": "b"}
    if op in kind:
        code, out = [load[kind[op]]], kind[op]
    elif op in ("CONST", "EMIT"):
        code, out = [("CONST", 1)] if op == "CONST" else [load["b"]], "b"
    elif op in ("AND", "OR", "NOT"):
        code, out = [load["b"]] * (1 if op == "NOT" else 2) + [(op, 0)], "b"
    elif op == "I2F":
        code, out = [load["i"], (op, 0)], "f"
    elif op in ("NEG_I", "ABS_I", "NEG_F", "ABS_F"):
        out = op[-1].lower()
        code = [load[out], (op, 0)]
    else:
        t = op[-1].lower()
        code = [load[t], load[t], (op, 0)]
        out = "b" if op[:-2] in ("LT", "LE", "GT", "GE", "EQ", "NE") else t
    if out == "i":
        code, out = code + [("I2F", 0)], "f"
    return code + [("EMIT", 0 if out == "b" else 1)]


def test_opcodes_match_the_cuda_header():
    """The generator has a case for every instruction of the programs, and
    each operation it writes is a macro of ``csrc/rowfn.cuh``, the header
    the generated code is compiled against."""
    from repro_torch.kernels import codegen

    header = (Path(exprcode.__file__).parent / "csrc" / "rowfn.cuh").read_text()
    defined = set(re.findall(r"#define (RF_\w+)", header))
    handled = (set(codegen._LOAD) | set(codegen._IBIN) | set(codegen._FBIN) | set(codegen._UN)
               | {c + t for c in codegen._CMP for t in ("_I", "_F")}
               | {"AND", "OR", "CONST", "EMIT"})
    assert handled == set(exprcode.OPCODES)
    for op in exprcode.OPCODES:
        lines, result, _ = codegen._segment(_one_op(op), ("i", "f", "b"))
        used = set(re.findall(r"\bRF_\w+", "\n".join(lines) + result))
        assert used <= defined, (op, used - defined)


def test_wrapper_limits_match_the_cuda_header():
    """Each generated family's template exports its scratch helper, which
    the wrapper reads to size the partials (and, for the join, the
    first-row table); the generated code encodes the aggregates as the
    atomic routes read them: 0 a sum (``fixsum.cuh``'s integers, in
    ``grouped.cuh``), 1 min and 2 max (``relagg.cuh``'s atomics)."""
    from repro_torch.kernels import codegen, ops

    csrc = Path(exprcode.__file__).parent / "csrc"
    prefix = {"fused_select_agg": "fsa", "grouped_select_agg": "gsa", "grouped_join_agg": "gja"}
    assert set(prefix) == set(codegen.FAMILIES)
    for family, pre in prefix.items():
        helper = f"{pre}_gen_scratch_bytes"
        assert f'extern "C" long long {helper}' in (csrc / f"{family}.cu").read_text()
        assert f".{helper}" in Path(ops.__file__).read_text()
    relagg = (csrc / "relagg.cuh").read_text()
    atomics = dict(re.findall(r"if \(fn == (\d)\) (\w+)\(", relagg))
    assert atomics == {"1": "rel_atomic_min"}
    assert "else rel_atomic_max(a, v);" in relagg
    grouped = (csrc / "grouped.cuh").read_text()
    assert "if (gen_fn(k) == 0) fix_add(" in grouped
    assert "else rel_atomic(gen_fn(k)," in grouped
    assert codegen._FN == {"sum": 0, "min": 1, "max": 2}
