"""TPC-H end to end: the torch port against the JAX package and numpy.

The port's ``Frame.collect(device="cpu")`` (CUDA kernels replaced by their
plain versions on CPU tensors) runs the six queries under its one strategy
(``groupby=direct, join=hash, encode=raw, fuse=fused``, ``use_kernels``)
and is held against the JAX package's ``local`` target under the same
strategy — on its XLA operators, and with its Pallas kernels in interpret
mode — and against the numpy references.  Integers are exact; floats
within rtol 2e-4 (f32 sums against the f64 oracle, as tests/test_tpch.py
allows).  The lowered programs must
be the same instruction for instruction.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.relational import tpch as jtpch  # noqa: E402
from repro_torch import compiler as tcompiler  # noqa: E402
from repro_torch.relational import tpch as ttpch  # noqa: E402

STRATEGY = (("groupby", "direct"), ("join", "hash"))
GROUP_KEYS = {"q1": ("l_returnflag", "l_linestatus"), "q4": ("o_orderpriority",),
              "q12": ("l_shipmode",)}
PLAN_PARAMS = ("num_buckets", "join_num_buckets", "max_groups", "key_domains",
               "join_key_domains", "max_count", "keys", "left_on", "right_on")


@pytest.fixture(scope="module")
def tables():
    return jtpch.generate(sf=0.002, seed=7)


@pytest.fixture(scope="module")
def jctx(tables):
    return jtpch.make_context(tables)


@pytest.fixture(scope="module")
def tctx(tables):
    return ttpch.make_context(tables)


def _sorted(d, keys):
    if not keys:
        return d
    order = np.lexsort([np.asarray(d[k]) for k in reversed(keys)])
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _assert_close(got, want, keys, what):
    got, want = _sorted(got, keys), _sorted(want, keys)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                          err_msg=f"{what}.{k}")
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=2e-4, err_msg=f"{what}.{k}")


def test_generator_is_the_same(tables):
    mine = ttpch.generate(sf=0.002, seed=7)
    for t in tables:
        for c in tables[t]:
            np.testing.assert_array_equal(mine[t][c], tables[t][c])


@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_lowered_program_matches_jax(qname, jctx, tctx):
    jprog = jctx.compile(jtpch.QUERIES[qname](jctx), use_kernels=True,
                         strategy=STRATEGY).program
    tprog = tctx.compile(ttpch.QUERIES[qname](tctx)).program
    assert tprog.opcodes() == jprog.opcodes()
    for ji, ti in zip(jprog.body, tprog.body):
        for p in PLAN_PARAMS:
            assert ti.param(p) == ji.param(p), (ji.opcode, p)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_query_matches_jax_and_reference(qname, use_kernels, tables, jctx, tctx):
    """Against the numpy reference and the JAX ``local`` target under the
    same strategy on its XLA operators."""
    keys = GROUP_KEYS.get(qname, ())
    got = ttpch.QUERIES[qname](tctx).collect(device="cpu", use_kernels=use_kernels)
    _assert_close(got, jtpch.REFERENCES[qname](tables), keys, "reference")
    jax_out = jtpch.QUERIES[qname](jctx).collect(use_kernels=False, strategy=STRATEGY)
    _assert_close(got, jax_out, keys, "jax")
    for k in jax_out:  # same result types as the JAX package (x64 off)
        assert np.asarray(got[k]).dtype == np.asarray(jax_out[k]).dtype, k


#: Q4's outer join probes a compacted build side, where the JAX package's
#: grouped_join_agg loses matches (its presence table is gathered by
#: build-row index; ROADMAP Queue 3) — the port is held to the reference
#: and to the JAX operators there instead (above)
_JAX_KERNELS_AGREE = sorted(set(jtpch.QUERIES) - {"q4"})


@pytest.mark.parametrize("qname", _JAX_KERNELS_AGREE)
def test_query_matches_jax_pallas_kernels(qname, jctx, tctx):
    """Against the JAX package with its Pallas kernels (interpret mode)."""
    keys = GROUP_KEYS.get(qname, ())
    got = ttpch.QUERIES[qname](tctx).collect(device="cpu")
    jax_out = jtpch.QUERIES[qname](jctx).collect(use_kernels=True, strategy=STRATEGY)
    _assert_close(got, jax_out, keys, "jax kernels")


def test_sources_stay_on_the_device_per_session(tctx):
    a = tctx.sources("cpu")
    assert tctx.sources("cpu") is a
    assert a["lineitem"].capacity == tctx.capacity("lineitem")


@pytest.mark.parametrize("strategy,where", [
    ({"groupby": "sorted"}, "sorted tiers"),
    ({"join": "sorted"}, "sorted tiers"),
    ({"encode": "dict"}, "dict encode"),
    ({"fuse": "unfused"}, "fallback ladder"),
])
def test_strategies_not_ported_name_the_roadmap(strategy, where, tctx):
    with pytest.raises(NotImplementedError, match=where):
        tctx.compile(ttpch.q6(tctx), strategy=strategy)


def test_parallel_and_cost_search_not_ported(tctx):
    """parallel>1 is ported now (tests/test_torch_parallel.py holds it to
    the JAX package); the cost search is not."""
    seq = ttpch.q6(tctx).collect(device="cpu")
    par = ttpch.q6(tctx).collect(device="cpu", parallel=4)
    np.testing.assert_allclose(par["revenue"], seq["revenue"], rtol=1e-5)
    with pytest.raises(NotImplementedError, match="cost search"):
        ttpch.q6(tctx).collect(device="cpu", optimize="cost")
    with pytest.raises(ValueError):
        tcompiler.normalize_strategy({"groupby": "nope"})

