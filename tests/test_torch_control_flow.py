"""Control flow and the df flavor on the torch port, against the JAX package.

The same programs, built in each package from the same description, run
on the same seeded numpy inputs through

* the port's ``LocalBackend(device="cpu")`` and JAX's ``LocalBackend``
  (``cf.Loop`` at n = 3 takes JAX's unrolled path, n = 7 its ``lax.scan``;
  ``cf.While`` its ``while_loop``, ``cf.Cond`` its ``lax.cond``): floats
  within rtol 2e-4, integers and booleans exact;
* the port's numpy interpreter and JAX's, which must agree bit for bit;
* the port's compile driver with ``target="local"`` and ``"interp"``.

The k-means loop (``repro_torch.kmeans.loop_program``, the body fused and
split in 8) runs 5 steps at n = 2^12 and must give the bits of five calls
of the one-step program.
"""

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.backends.interp import InterpBackend as JInterp  # noqa: E402
from repro.backends.local import LocalBackend as JLocal  # noqa: E402
from repro.core import passes as jpasses, types as jtypes  # noqa: E402
from repro.compiler.fingerprint import fingerprint as jfingerprint  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import compiler as tcompiler, kmeans  # noqa: E402
from repro_torch.backends.interp import InterpBackend as TInterp  # noqa: E402
from repro_torch.backends.local import LocalBackend as TLocal  # noqa: E402
from repro_torch.compiler.fingerprint import fingerprint as tfingerprint  # noqa: E402
from repro_torch.core import passes as tpasses, types as ttypes  # noqa: E402

J = SimpleNamespace(core=jcore, types=jtypes, passes=jpasses)
T = SimpleNamespace(core=tcore, types=ttypes, passes=tpasses)
RTOL = 2e-4
SHAPE = (4, 3)


def _ew(b, op, *regs):
    return b.emit1("la.Ewise", list(regs), {"op": op})


def loop_prog(m, n):
    """(a, b) → Loop(n)[(a, b) → (b, a + b·0.5)]."""
    t = m.types.Tensor(m.types.F32, SHAPE)

    def body(b, regs):
        a, c = regs
        half = b.emit1("la.Literal", [], {"value": 0.5, "shape": (), "dtype": m.types.F32})
        return [c, _ew(b, "add", a, _ew(b, "mul", c, half))]

    p = m.core.subprogram("fib", [("a", t), ("b", t)], body)
    bld = m.core.Builder("looped")
    a, c = bld.input("a", t), bld.input("b", t)
    return bld.finish(*bld.emit("cf.Loop", [a, c], {"n": n, "P": p}))


def while_prog(m):
    """Carried (p, q, f, x): the body tests p and returns (q, f, f, 2x + 1),
    so it runs while the flags shift out: twice from (True, True, False)."""
    tb, t = m.types.Single(m.types.BOOL), m.types.Tensor(m.types.F32, SHAPE)

    def body(b, regs):
        p, q, f, x = regs
        one = b.emit1("la.Literal", [], {"value": 1.0, "shape": (), "dtype": m.types.F32})
        return [p, q, f, f, _ew(b, "add", _ew(b, "add", x, x), one)]

    p = m.core.subprogram("shift", [("p", tb), ("q", tb), ("f", tb), ("x", t)], body)
    bld = m.core.Builder("whiled")
    regs = [bld.input(h, ty) for h, ty in (("p", tb), ("q", tb), ("f", tb), ("x", t))]
    return bld.finish(*bld.emit("cf.While", regs, {"P": p}))


def cond_prog(m):
    """(pred, x, y) → then (x·y, x − y) | else (−x, y)."""
    tb, t = m.types.Single(m.types.BOOL), m.types.Tensor(m.types.F32, SHAPE)
    then = m.core.subprogram("then", [("x", t), ("y", t)], lambda b, r: [
        _ew(b, "mul", *r), _ew(b, "sub", *r)])
    other = m.core.subprogram("else", [("x", t), ("y", t)], lambda b, r: [
        _ew(b, "neg", r[0]), r[1]])
    bld = m.core.Builder("branched")
    regs = [bld.input("pred", tb), bld.input("x", t), bld.input("y", t)]
    return bld.finish(*bld.emit("cf.Cond", regs, {"Pthen": then, "Pelse": other}))


def call_prog(m):
    """(x, y) → Call[(x, y) → (x·yᵀ, |x − y|)]."""
    t = m.types.Tensor(m.types.F32, SHAPE)
    p = m.core.subprogram("callee", [("x", t), ("y", t)], lambda b, r: [
        b.emit1("la.MMMult", [r[0], b.emit1("la.Transpose", [r[1]])]),
        _ew(b, "abs", _ew(b, "sub", *r))])
    bld = m.core.Builder("caller")
    x, y = bld.input("x", t), bld.input("y", t)
    return bld.finish(*bld.emit("cf.Call", [x, y], {"P": p}))


def df_prog(m):
    """df.Source("t") → df.Collect."""
    t = m.types.Tensor(m.types.F32, SHAPE)
    bld = m.core.Builder("sourced")
    src = bld.emit1("df.Source", [], {"name": "t", "type": t})
    return bld.finish(bld.emit1("df.Collect", [src]))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=SHAPE).astype(np.float32) for _ in range(2)]


CASES = {
    "loop3": (lambda m: loop_prog(m, 3), lambda: ({}, _inputs())),
    "loop7": (lambda m: loop_prog(m, 7), lambda: ({}, _inputs())),
    "while": (while_prog, lambda: ({}, [np.array(True), np.array(True), np.array(False),
                                        _inputs()[0]])),
    "cond_then": (cond_prog, lambda: ({}, [np.array(True)] + _inputs())),
    "cond_else": (cond_prog, lambda: ({}, [np.array(False)] + _inputs())),
    "call": (call_prog, lambda: ({}, _inputs())),
    "df": (df_prog, lambda: ({"t": _inputs()[0]}, [])),
}


def _np(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def _close(got, want, what, exact=False):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if exact or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6, err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_program_in_both_packages(case):
    build, _ = CASES[case]
    assert tfingerprint(build(T)) == jfingerprint(build(J))


@pytest.mark.parametrize("case", sorted(CASES))
def test_local_matches_jax_local(case):
    build, data = CASES[case]
    srcs, args = data()
    got = TLocal(device="cpu").compile(build(T))(srcs, *args)
    want = JLocal().compile(build(J))(srcs, *args)
    _close(got, want, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_interp_matches_jax_interp_bit_for_bit(case):
    build, data = CASES[case]
    srcs, args = data()
    got = TInterp().compile(build(T))(srcs, *args)
    want = JInterp().compile(build(J))(srcs, *args)
    _close(got, want, case, exact=True)
    if case != "while":  # the reference's targets disagree there (below)
        _close(TLocal(device="cpu").compile(build(T))(srcs, *args), want, case)


@pytest.mark.parametrize("target", ["local", "interp"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_through_the_driver(case, target):
    build, data = CASES[case]
    srcs, args = data()
    res = tcompiler.compile(build(T), target=target, device="cpu", cache=False)
    assert not res.degraded and res.target == target
    jax_backend = JLocal() if target == "local" else JInterp()
    _close(res(srcs, *args), jax_backend.compile(build(J))(srcs, *args), case)


def test_while_quirk_of_the_reference_kept():
    """The host loop stops when the flag is false: two doublings on the
    local target, as JAX's ``while_loop`` does.  The numpy interpreters
    (JAX's and the port's) keep the carried values of the run whose test
    failed: three doublings (ROADMAP Queue 3 lists the quirk)."""
    srcs, args = CASES["while"][1]()
    x = args[3].astype(np.float64)
    for backend, doublings in ((TLocal(device="cpu"), 2), (JLocal(), 2),
                               (TInterp(), 3), (JInterp(), 3)):
        m = T if backend.__module__.startswith("repro_torch") else J
        *flags, got = backend.compile(while_prog(m))(srcs, *args)
        want = (2 ** doublings) * x + (2 ** doublings - 1)
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, err_msg=type(backend).__module__)
        assert [bool(_np(f)) for f in flags] == [False, False, False]


# ---------------------------------------------------------------------------
# the k-means loop
# ---------------------------------------------------------------------------


def jax_loop_program(n, d, k, steps, parallel):
    """The JAX package's counterpart of ``kmeans.loop_program``."""
    F32, Tensor = jtypes.F32, jtypes.Tensor
    tc = Tensor(F32, (k, d))
    names = {}

    def step(b, regs):
        (cr,) = regs
        xr = b.emit1("la.Literal", [], {"name": "X", "shape": (n, d), "dtype": F32})
        names["X"] = xr.name
        lab = b.emit1("la.ArgMinRow", [b.emit1("la.CDist2", [xr, cr])])
        sums = b.emit1("la.SegSum", [xr, lab], {"k": k})
        counts = b.emit1("la.SegCount", [lab], {"k": k})
        eps = b.emit1("la.Literal", [], {"value": 1e-9, "shape": (), "dtype": F32})
        denom = b.emit1("la.Ewise", [counts, eps], {"op": "add"})
        mean = b.emit1("la.Ewise", [b.emit1("la.Transpose", [sums]), denom], {"op": "div"})
        return [b.emit1("la.Transpose", [mean])]

    body = jcore.subprogram("kmeans_body", [("C", tc)], step)
    b = jcore.Builder("kmeans_loop")
    prog = b.finish(*b.emit("cf.Loop", [b.input("C", tc)], {"n": steps, "P": body}))
    if parallel:
        split = jpasses.Parallelize(n=parallel, targets={names["X"]})
        prog = jpasses.FuseKMeansStep().apply(prog).map_instructions(
            lambda ins: [ins.map_nested(split.apply)])
    return prog


N, D, K = 1 << 12, 8, 16


@pytest.fixture(scope="module")
def kmeans_data():
    return kmeans.make_data(N, D, K, 0)


@pytest.mark.parametrize("parallel", [0, 8])
def test_kmeans_loop_is_the_jax_program(parallel):
    assert tfingerprint(kmeans.loop_program(N, D, K, 5, parallel)) == \
        jfingerprint(jax_loop_program(N, D, K, 5, parallel))


def test_kmeans_loop_fuses_and_splits_the_body():
    prog = kmeans.loop_program(N, D, K, 5, parallel=8)
    (loop,) = prog.body
    body = loop.param("P")
    assert loop.opcode == "cf.Loop" and loop.param("n") == 5
    assert "cf.ConcurrentExecute" in body.opcodes()
    assert "la.KMeansStep" in [op for p in body.walk() for op in p.opcodes()]
    assert "la.CDist2" not in [op for p in body.walk() for op in p.opcodes()]


def test_kmeans_loop_matches_jax_and_the_interpreters(kmeans_data):
    x, c = kmeans_data
    got = TLocal(device="cpu").compile(kmeans.loop_program(N, D, K, 5, 8))({"X": x}, c)
    want = JLocal(use_kernels=True).compile(jax_loop_program(N, D, K, 5, 8))({"X": x}, c)
    _close(got, want, "kmeans loop vs JAX local")
    ti = TInterp().compile(kmeans.loop_program(N, D, K, 5, 8))({"X": x}, c)
    ji = JInterp().compile(jax_loop_program(N, D, K, 5, 8))({"X": x}, c)
    _close(ti, ji, "kmeans loop interp", exact=True)
    _close(got, ji, "kmeans loop vs interp")


def test_kmeans_loop_gives_the_bits_of_five_steps(kmeans_data):
    x, c = kmeans_data
    (looped,) = TLocal(device="cpu").compile(kmeans.loop_program(N, D, K, 5, 8))({"X": x}, c)
    one = TLocal(device="cpu").compile(kmeans.loop_program(N, D, K, 1, 8))
    stepped = c
    for _ in range(5):
        (stepped,) = one({"X": x}, stepped)
    assert _np(looped).tobytes() == _np(stepped).tobytes()
