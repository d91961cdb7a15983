"""The port's numpy interpreter (``target="interp"``) against the JAX
package's, bit for bit.

The interpreter is the JAX file copied (``repro_torch/backends/interp.py``,
numpy only): the ``interp`` target and the last rung of the fallback
ladder.  The same seeded tables go through both packages' ``Context`` with
``target="interp"``: the six TPC-H queries at sf = 0.01, sequential and
with ``parallel=4``, must give equal arrays (dtype, shape and bits), and so
must the LA programs (the k-means step, unfused and fused + split in 4,
and an ``MMMult``/``Transpose``/``ReduceSum`` chain).  The port's local
backend is held to the interpreter within the TPC-H tolerance (rtol 2e-4).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.backends.interp import InterpBackend as JInterp  # noqa: E402
from repro.core import passes as jpasses  # noqa: E402
from repro.core.types import F32 as JF32, Tensor as JTensor  # noqa: E402
from repro.relational import tpch as jtpch  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import kmeans  # noqa: E402
from repro_torch.backends.interp import InterpBackend as TInterp  # noqa: E402
from repro_torch.core.types import F32 as TF32, Tensor as TTensor  # noqa: E402
from repro_torch.relational import tpch as ttpch  # noqa: E402


@pytest.fixture(scope="module")
def ctxs():
    tables = jtpch.generate(sf=0.01, seed=0)
    return jtpch.make_context(tables), ttpch.make_context(tables)


def _bits(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), (what, k)


@pytest.mark.parametrize("parallel", [None, 4])
@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_tpch_interp_matches_jax_interp(qname, parallel, ctxs):
    jctx, tctx = ctxs
    got = ttpch.QUERIES[qname](tctx).collect(target="interp", parallel=parallel)
    want = jtpch.QUERIES[qname](jctx).collect(target="interp", parallel=parallel)
    _bits(got, want, qname)


@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_local_matches_the_interpreter(qname, ctxs):
    _, tctx = ctxs
    want = ttpch.QUERIES[qname](tctx).collect(target="interp")
    got = ttpch.QUERIES[qname](tctx).collect(device="cpu")
    keys = [k for k in want if np.asarray(want[k]).dtype.kind in "iub"]
    order_g = np.lexsort([np.asarray(got[k]) for k in reversed(keys)]) if keys else ...
    order_w = np.lexsort([np.asarray(want[k]) for k in reversed(keys)]) if keys else ...
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k])[order_g].astype(np.float64),
                                   np.asarray(want[k])[order_w].astype(np.float64),
                                   rtol=2e-4, err_msg=f"{qname}.{k}")


def _jax_kmeans(n, d, k, parallel):
    b = jcore.Builder("kmeans_iter")
    xr = b.input("X", JTensor(JF32, (n, d)))
    cr = b.input("C", JTensor(JF32, (k, d)))
    lab = b.emit1("la.ArgMinRow", [b.emit1("la.CDist2", [xr, cr])])
    prog = b.finish(b.emit1("la.SegSum", [xr, lab], {"k": k}),
                    b.emit1("la.SegCount", [lab], {"k": k}))
    if parallel:
        prog = jpasses.FuseKMeansStep().apply(prog)
        prog = jpasses.Parallelize(n=parallel, targets={xr.name}).apply(prog)
    return prog


def _chain(core, F32, Tensor):
    b = core.Builder("chain")
    a = b.input("A", Tensor(F32, (6, 4)))
    w = b.input("W", Tensor(F32, (5, 4)))
    prod = b.emit1("la.MMMult", [a, b.emit1("la.Transpose", [w])])
    sq = b.emit1("la.Ewise", [prod], {"op": "square"})
    two = b.emit1("la.Literal", [], {"value": 2.0, "shape": (), "dtype": F32})
    return b.finish(b.emit1("la.ReduceSum", [sq], {"axis": 0}),
                    b.emit1("la.Ewise", [prod, two], {"op": "div"}))


@pytest.mark.parametrize("parallel", [0, 4])
def test_kmeans_interp_matches_jax_interp(parallel):
    x, c = kmeans.make_data(1 << 10, 8, 16, 3)
    got = TInterp().compile(kmeans.program(1 << 10, 8, 16, parallel))({}, x, c)
    want = JInterp().compile(_jax_kmeans(1 << 10, 8, 16, parallel))({}, x, c)
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


def test_la_chain_interp_matches_jax_interp():
    rng = np.random.default_rng(1)
    a, w = rng.normal(size=(6, 4)).astype(np.float32), rng.normal(size=(5, 4)).astype(np.float32)
    got = TInterp().compile(_chain(tcore, TF32, TTensor))({}, a, w)
    want = JInterp().compile(_chain(jcore, JF32, JTensor))({}, a, w)
    for g, v in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(v).dtype
        assert np.asarray(g).tobytes() == np.asarray(v).tobytes()
