"""The per-query kernels' generated row functions, built and run on the CPU.

``repro_torch.kernels.codegen`` turns a query's expression program into
straight-line C++ over the macros of ``csrc/rowfn.cuh``.  Under nvcc the
macros are the device intrinsics; under a host C++ compiler (here ``g++
-O1 -ffp-contract=off``) they are plain IEEE single-precision operations,
which round the same way.  Each case builds the generated functions into
a small library, loads it with ``ctypes``, runs it over seeded numpy
columns and holds it bit for bit against ``exprcode.interpret`` (the
32-bit arithmetic the kernels and the plain versions share), and against
the JAX package's ``repro.core.expr.evaluate``: predicates exactly, values
within rtol 1e-6, since XLA may fuse a multiply and an add into one FMA
where the program rounds twice.  The cases: those of
``tests/test_torch_exprcode.py``, Q6's and Q19's predicates as the TPC-H
path hands them to ``fused_select_agg``, and a predicate deeper than the
interpreter's stack.  The tests skip where no ``g++`` is found.

Also here: the generated text and the generated library's path follow the
query, its constants and column types and the headers the text includes;
a failed nvcc build raises with nvcc's output; the wrappers build a
query's kernel once.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import expr as jexpr  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro_torch.convert import vectable_from_arrays  # noqa: E402
from repro_torch.core import expr as texpr  # noqa: E402
from repro_torch.kernels import build, codegen, exprcode, ops  # noqa: E402
from repro_torch.relational import tpch  # noqa: E402

from test_torch_exprcode import CASES, N  # noqa: E402

HARNESS = r"""
extern "C" void rows_eval(const void* const* cols, long long n, uint8_t* pred, float* vals,
                          long long* buckets) {
  const GenCols c = gen_cols(cols);
  for (long long i = 0; i < n; ++i) {
    GenRow r{};
    gen_load_pred(r, c, i);
    gen_load_rest(r, c, i);
    pred[i] = static_cast<uint8_t>(gen_pred(r));
    float v[GEN_NV1];
    gen_values(r, v);
    for (int k = 0; k < GEN_NV; ++k) vals[k * n + i] = v[k];
#ifdef GEN_NB
    buckets[i] = gen_bucket(r);
#endif
  }
}
"""


@pytest.fixture(scope="module")
def gxx():
    found = shutil.which("g++")
    if found is None:
        pytest.skip("needs a host C++ compiler (no g++ is found)")
    return found


def _host_rows(gxx, tmp, text):
    """The generated row functions ``text`` built for the host; returns a
    function of the columns (slot order) → (predicate, values, buckets)."""
    tmp.mkdir(parents=True, exist_ok=True)
    src, lib = tmp / "rows.cpp", tmp / "rows.so"
    src.write_text(text + HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(build.CSRC), "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).rows_eval
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
    fn.restype = None

    def run(cols, n_values):
        cols = [np.ascontiguousarray(c) for c in cols]
        n = len(cols[0]) if cols else N
        ptrs = np.array([c.ctypes.data for c in cols] or [0], np.uint64)
        pred = np.zeros(n, np.uint8)
        vals = np.zeros((max(n_values, 1), n), np.float32)
        buckets = np.zeros(n, np.int64)
        fn(ptrs.ctypes.data, n, pred.ctypes.data, vals.ctypes.data, buckets.ctypes.data)
        return pred.astype(bool), vals[:n_values], buckets

    return run


def _program(pred, values, cols, max_stack=None):
    names = sorted(cols)
    types = [exprcode.column_type(cols[n].dtype) for n in names]
    prog = exprcode.compile_program(pred, values, dict(zip(names, types)),
                                    {n: j for j, n in enumerate(names)}, max_stack=max_stack)
    return prog, names, types


def _check_generated(gxx, tmp, pred, values, cols, max_stack=None):
    """Generated functions against exprcode.interpret, bit for bit; returns
    (predicate, values) as the generated code gives them."""
    prog, names, types = _program(pred, values, cols, max_stack)
    run = _host_rows(gxx, tmp, codegen.row_source(prog, types, ["sum"] * len(values)))
    got_pred, got_vals, _ = run([cols[n] for n in names], len(values))
    want = exprcode.interpret(prog, [cols[n] for n in names])
    np.testing.assert_array_equal(got_pred, want[0])
    for g, w in zip(got_vals, want[1:]):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))  # the same bits
    return got_pred, got_vals


def _to_jax(e):
    """The same expression in the JAX package's Expr classes."""
    if isinstance(e, texpr.Col):
        return jexpr.Col(e.name)
    if isinstance(e, texpr.Const):
        return jexpr.Const(e.value, jtypes.Atom(e.atom.domain))
    if isinstance(e, texpr.UnOp):
        return jexpr.UnOp(e.op, _to_jax(e.arg))
    return jexpr.BinOp(e.op, _to_jax(e.lhs), _to_jax(e.rhs))


def _jax(e, cols):
    want = np.asarray(jexpr.evaluate(_to_jax(e), {k: jnp.asarray(v) for k, v in cols.items()},
                                     jnp))
    n = len(next(iter(cols.values())))
    return np.full(n, want) if want.ndim == 0 else want


@pytest.fixture(scope="module")
def columns():
    rng = np.random.default_rng(11)
    d = np.round(rng.uniform(0.0, 0.10, N), 2).astype(np.float32)
    d[:8] = np.float32(0.07)
    return {"i": rng.integers(-40, 40, N).astype(np.int32),
            "j": rng.integers(1, 9, N).astype(np.int32),
            "x": rng.uniform(-3, 3, N).astype(np.float32), "d": d,
            "b": rng.random(N) < 0.5}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generated_rows_match_interpreter_and_jax(case, columns, gxx, tmp_path):
    e = CASES[case](texpr)
    want = _jax(e, columns)
    if want.dtype == bool:
        got, _ = _check_generated(gxx, tmp_path, e, (), columns)
        np.testing.assert_array_equal(got, want)
    else:
        _, (got,) = _check_generated(gxx, tmp_path, None, (e,), columns)
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-6)


def _deep(m, depth):
    """A right-leaning chain of ``depth`` or-ed comparisons: every level
    stays on the interpreter's stack."""
    e = m.col("x") > 2.9
    for k in range(depth):
        e = (m.col("i").eq(k - 20) & (m.col("x") < k / 10 - 1.0)) | e
    return e


def test_deep_predicate_runs_generated(columns, gxx, tmp_path):
    e = _deep(texpr, 24)
    with pytest.raises(ValueError, match="stack"):
        _program(e, (), columns, max_stack=exprcode.MAX_STACK)
    got, _ = _check_generated(gxx, tmp_path, e, (texpr.col("x") * 2.0,), columns)
    np.testing.assert_array_equal(got, _jax(e, columns))
    assert 0 < got.sum() < N


@pytest.fixture(scope="module")
def tpch_calls():
    """The fused_select_agg calls of Q6 and Q19 on a small TPC-H, as the
    path makes them (on the CPU, so the plain version answers); at sf=0.05
    some rows pass Q19's predicate."""
    tables = tpch.generate(sf=0.05, seed=0)
    ctx = tpch.make_context(tables)
    calls, original = [], ops.fused_select_agg

    def record(table, pred, aggs):
        calls.append((table, pred, tuple(aggs)))
        return original(table, pred, aggs)

    ops.fused_select_agg = record
    out = {}
    try:
        for q in ("q6", "q19"):
            calls.clear()
            tpch.QUERIES[q](ctx).collect(device="cpu")
            out[q] = calls[-1]
    finally:
        ops.fused_select_agg = original
    return out


@pytest.mark.parametrize("q", ["q6", "q19"])
def test_tpch_predicates_match_interpreter_and_jax(q, tpch_calls, gxx, tmp_path):
    table, pred, aggs = tpch_calls[q]
    values = tuple(a.expr for a in aggs if a.fn != "count")
    fields = set(pred.fields()) | {f for v in values for f in v.fields()}
    cols = {f: table.cols[f].numpy() for f in fields}
    got, vals = _check_generated(gxx, tmp_path, pred, values, cols)
    np.testing.assert_array_equal(got, _jax(pred, cols))
    for v, g in zip(values, vals):
        np.testing.assert_allclose(g, _jax(v, cols).astype(np.float32), rtol=1e-6)
    assert got.any()


def test_bucket_ids_clip_and_rank_keys(gxx, tmp_path):
    """Bucket ids as the grouped kernel packs them: each key minus its
    domain's low end, clipped to the domain, ranked lexicographically;
    f32 keys by their bits, bools as 0/1."""
    rng = np.random.default_rng(4)
    n = 999
    cols = {"a": rng.integers(-5, 9, n).astype(np.int32),
            "f": rng.choice(np.array([0.5, 1.5, -2.0], np.float32), n),
            "g": rng.random(n) < 0.3}
    fbits = cols["f"].view(np.int32)
    doms = {"a": (0, 6), "f": (int(fbits.min()), int(fbits.max())), "g": (0, 1)}
    keys = ("a", "g", "f")
    prog, names, types = _program(texpr.col("a") > -3, (), cols)
    slots = [(names.index(k), doms[k][0], doms[k][1] - doms[k][0] + 1) for k in keys]
    text = codegen.row_source(prog, types, (), slots)
    run = _host_rows(gxx, tmp_path, text)
    pred, _, buckets = run([cols[n] for n in names], 0)
    want = np.zeros(n, np.int64)
    for k, word in (("a", cols["a"]), ("g", cols["g"].astype(np.int64)), ("f", fbits)):
        lo, hi = doms[k]
        want = want * (hi - lo + 1) + np.clip(word.astype(np.int64) - lo, 0, hi - lo)
    np.testing.assert_array_equal(buckets, want)
    np.testing.assert_array_equal(pred, cols["a"] > -3)
    assert f"#define GEN_NB {7 * 2 * (doms['f'][1] - doms['f'][0] + 1)}LL" in text


def _text(pred, values=(), types=("f", "i"), keys=None, fns=None):
    names = ("x", "a")
    prog = exprcode.compile_program(pred, values, dict(zip(names, types)), {"x": 0, "a": 1},
                                    max_stack=None)
    family = "fused_select_agg" if keys is None else "grouped_select_agg"
    return codegen.kernel_source(family, prog, types, fns or ["sum"] * len(values), keys)


def test_generated_text_follows_the_query():
    x, a = texpr.col("x"), texpr.col("a")
    base = _text((x < 0.5) & (a > 3), (x * 2.0,))
    assert base == _text((x < 0.5) & (a > 3), (x * 2.0,))
    assert base != _text((x < 0.25) & (a > 3), (x * 2.0,))          # a constant
    assert base != _text((x < 0.5) & (a > 3), (x * 2.0,), types=("f", "f"))  # a column type
    assert base != _text((x < 0.5) & (a > 3), (x * 2.0,), fns=["max"])       # an aggregate
    assert base.endswith('#include "fused_select_agg.cu"\n')
    assert "RF_F32(0x3f000000u)" in base  # 0.5 by its bits
    grouped = _text(x < 0.5, (x,), keys=[(1, 0, 5)])
    assert grouped != _text(x < 0.5, (x,), keys=[(1, 0, 6)])          # a key domain
    with pytest.raises(ValueError):
        _text(x < 0.5, (x,), keys=None, fns=["sum", "sum"])


def test_generated_library_path_follows_text_and_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    x = texpr.col("x")
    text = _text(x < 0.5, (x * 2.0,))
    p = build.generated_path("fused_select_agg", text)
    assert p.parent == tmp_path / "out" / "gen" and p.name.startswith("fused_select_agg-")
    assert p == build.generated_path("fused_select_agg", text)
    assert p != build.generated_path("fused_select_agg", _text(x < 0.25, (x * 2.0,)))
    assert [h.name for h in build._includes(text.encode())] == [
        "rowfn.cuh", "fused_select_agg.cu", "genrows.cuh", "relagg.cuh", "hopper.cuh"]
    for name in ("fused_select_agg.cu", "genrows.cuh", "relagg.cuh", "rowfn.cuh", "hopper.cuh"):
        (csrc / name).write_text((csrc / name).read_text() + "\n// edited\n")
        edited = build.generated_path("fused_select_agg", text)
        assert edited != p
        p = edited
    (csrc / "grouped_select_agg.cu").write_text("// not included\n")
    assert build.generated_path("fused_select_agg", text) == p


def test_default_generated_dir_is_ignored_by_git(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    root = Path(build.__file__).resolve().parents[3]
    p = build.generated_path("grouped_select_agg", _text(texpr.col("x") < 0.5, keys=[(1, 0, 5)]))
    assert p.parent == root / "build" / "repro_torch_kernels" / "gen"
    assert "build/" in (root / ".gitignore").read_text().split()


def test_failed_generated_build_raises_with_the_log(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic __bogus' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    text = _text(texpr.col("x") < 0.5, (texpr.col("x"),))
    with pytest.raises(RuntimeError, match="(?s)nvcc exit 3.*__bogus"):
        build.build_generated("fused_select_agg", text)
    p = build.generated_path("fused_select_agg", text)
    assert not p.exists() and p.with_suffix(".cu").read_text() == text


def test_wrappers_build_each_query_once(monkeypatch):
    """ops builds a query's kernel at its first call and reuses it; a
    query with another constant, or other column types, gets its own."""
    built = []

    class Lib:
        def __init__(self, text):
            built.append(text)
            self.gsa_gen_launch = self.gsa_gen_scratch_bytes = object()

        def gsa_gen_route(self):
            return 2

    from repro_torch.kernels import build as b

    monkeypatch.setattr(b, "build_generated", lambda family, text: Lib(text))
    monkeypatch.setattr(ops, "_QUERIES", {})
    x = texpr.col("x")
    aggs = (texpr.AggSpec("sum", x, "s"), texpr.AggSpec("count", texpr.const(1), "c"))

    def kernel(pred, types=("i", "f")):
        q = ops._query("grouped_select_agg", pred, aggs, ("a",), ((0, 9),))
        assert q.names == ("a", "x") and q.values == (("sum", x),)
        return ops._generated("grouped_select_agg", pred, q, types, ("a",), ((0, 9),))

    first = kernel(x > 0.5)
    assert kernel(x > 0.5) is first and len(built) == 1 and len(ops._QUERIES) == 1
    assert first.route == "gsa_global"
    kernel(x > 0.25)
    kernel(x > 0.5, ("i", "i"))
    assert len(built) == 3 and len(ops._QUERIES) == 2


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(0)
    t = vectable_from_arrays({"x": rng.uniform(-1, 1, 50).astype(np.float32),
                              "a": rng.integers(0, 3, 50).astype(np.int32)},
                             np.ones(50, bool), "cpu")
    ops.reset_launches()
    aggs = (texpr.AggSpec("sum", texpr.col("x"), "s"), texpr.AggSpec("count", texpr.const(1), "c"))
    ops.fused_select_agg(t, texpr.col("x") > 0.0, aggs)
    ops.grouped_select_agg(t, None, ("a",), aggs, 3, ((0, 2),), 3)
    assert ops.GEN_LAUNCHES == {r: 0 for r in ops.GEN_ROUTES}
