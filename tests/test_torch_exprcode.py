"""The kernels' expression programs against the JAX package's evaluation.

``repro_torch.kernels.exprcode`` lowers an ``Expr`` to the typed postfix
program the CUDA kernels interpret; ``exprcode.interpret`` runs it with the
same 32-bit arithmetic on numpy.  Each case here evaluates the same
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


def test_opcodes_match_the_cuda_header():
    header = (Path(exprcode.__file__).parent / "csrc" / "exprvm.cuh").read_text()
    enum = dict(re.findall(r"OP_(\w+) = (\d+),", header))
    assert {k: int(v) for k, v in enum.items()} == exprcode.OPCODES
    assert f"#define VM_MAX_STACK {exprcode.MAX_STACK}" in header
    assert f"#define VM_MAX_ACC {exprcode.MAX_VALUES}" in header
    col_enum = dict(re.findall(r"COL_(\w+) = (\d+)", header))
    assert {"I32": 0, "F32": 1, "U8": 2} == {k: int(v) for k, v in col_enum.items()}
    assert exprcode.COL_TYPES == {"i": 0, "f": 1, "b": 2}


def test_wrapper_limits_match_the_cuda_header():
    """The wrappers check the column and key limits, and encode the
    aggregate functions, as the interpreting kernel is built with; the
    generated kernels' launch geometry is their own (each template
    exports its scratch size, which the wrapper reads to size the
    partials), and the generated code encodes the aggregates as the
    interpreter does."""
    from repro_torch.kernels import codegen, ops

    csrc = Path(exprcode.__file__).parent / "csrc"
    header = (csrc / "exprvm.cuh").read_text()
    assert "#define VM_MAX_COLS 32" in header and "#define VM_MAX_KEYS 8" in header
    for family, prefix in (("fused_select_agg", "fsa"), ("grouped_select_agg", "gsa")):
        helper = f"{prefix}_gen_scratch_bytes"
        assert f'extern "C" long long {helper}' in (csrc / f"{family}.cu").read_text()
        assert f".{helper}" in Path(ops.__file__).read_text()
    fns = dict(re.findall(r"ACC_(\w+) = (\d+)", header))
    assert {k.lower(): int(v) for k, v in fns.items()} == ops._FN == codegen._FN
