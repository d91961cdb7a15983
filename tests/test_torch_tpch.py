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

The JAX package's default ``collect()`` (no strategy: the sorted tiers,
``SortByKey + GroupAggSorted`` and ``MergeJoinSorted``, no kernels) is
held the same way against the port under ``groupby=sorted, join=sorted``,
sequential and with ``parallel=4``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.relational import tpch as jtpch  # noqa: E402
from repro_torch import compiler as tcompiler  # noqa: E402
from repro_torch.relational import tpch as ttpch  # noqa: E402

STRATEGY = (("groupby", "direct"), ("join", "hash"))
#: the port's strategy for the JAX package's default lowering path
SORTED = {"groupby": "sorted", "join": "sorted"}
GROUP_KEYS = {"q1": ("l_returnflag", "l_linestatus"), "q4": ("o_orderpriority",),
              "q12": ("l_shipmode",)}
PLAN_PARAMS = ("num_buckets", "join_num_buckets", "max_groups", "key_domains",
               "join_key_domains", "max_count", "keys", "left_on", "right_on", "n",
               "ascending", "k")


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


@pytest.mark.parametrize("parallel", [None, 4])
@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_sorted_tiers_lower_as_jax_default(qname, parallel, jctx, tctx):
    """The JAX default lowering (no statistics: the sorted tiers) and the
    port's under ``SORTED``, nested programs included."""
    jprog = jctx.compile(jtpch.QUERIES[qname](jctx), parallel=parallel).program
    tprog = tctx.compile(ttpch.QUERIES[qname](tctx), parallel=parallel,
                         strategy=SORTED).program
    assert tprog.opcodes() == jprog.opcodes()
    assert "vec.GroupAggDirect" not in tprog.opcodes()
    assert "vec.HashJoinDirect" not in tprog.opcodes()
    jins = [i for p in jprog.walk() for i in p.body]
    tins = [i for p in tprog.walk() for i in p.body]
    for ji, ti in zip(jins, tins):
        for p in PLAN_PARAMS:
            assert ti.param(p) == ji.param(p), (ji.opcode, p)


@pytest.mark.parametrize("parallel", [None, 4])
@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_sorted_tiers_match_jax_default_collect(qname, parallel, tables, jctx, tctx):
    """``collect(strategy=SORTED)`` against the JAX default ``collect()``
    (tests/test_tpch.py's headline) and the numpy reference, with the same
    result types."""
    keys = GROUP_KEYS.get(qname, ())
    got = ttpch.QUERIES[qname](tctx).collect(device="cpu", parallel=parallel,
                                             strategy=SORTED)
    _assert_close(got, jtpch.REFERENCES[qname](tables), keys, "reference")
    jax_out = jtpch.QUERIES[qname](jctx).collect(parallel=parallel)
    _assert_close(got, jax_out, keys, "jax default")
    for k in jax_out:
        assert np.asarray(got[k]).dtype == np.asarray(jax_out[k]).dtype, k


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
def test_strategies_not_ported_name_the_roadmap(strategy, where, jctx, tctx):
    """Every variant of the four choices compiles and gives Q6's answer,
    forced alone and under the cost search over the other choices; the
    search's decision table is the JAX package's."""
    want = ttpch.q6(tctx).collect(device="cpu", cache=False)
    got = ttpch.q6(tctx).collect(device="cpu", strategy=strategy, cache=False)
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=1e-5, err_msg=where)
    got = ttpch.q6(tctx).collect(device="cpu", strategy=strategy, optimize="cost",
                                 cache=False)
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=1e-5, err_msg=where)
    res = tctx.compile(ttpch.q6(tctx), strategy=strategy, optimize="cost", cache=False)
    jres = jctx.compile(jtpch.q6(jctx), strategy=strategy, optimize="cost", cache=False)
    assert _decision(res) == _decision(jres), where


def test_parallel_and_cost_search_not_ported(jctx, tctx):
    """parallel>1 and the cost search are both ported: Q6 under each, and
    under both, gives the sequential answer, and the search's decision
    table is the JAX package's (tests/test_torch_cost.py holds all six
    queries)."""
    seq = ttpch.q6(tctx).collect(device="cpu")
    par = ttpch.q6(tctx).collect(device="cpu", parallel=4)
    np.testing.assert_allclose(par["revenue"], seq["revenue"], rtol=1e-5)
    for parallel in (None, 4):
        got = ttpch.q6(tctx).collect(device="cpu", optimize="cost", parallel=parallel)
        np.testing.assert_allclose(got["revenue"], seq["revenue"], rtol=1e-5)
        res = tctx.compile(ttpch.q6(tctx), optimize="cost", parallel=parallel, cache=False)
        jres = jctx.compile(jtpch.q6(jctx), optimize="cost", parallel=parallel, cache=False)
        assert _decision(res) == _decision(jres)
    with pytest.raises(ValueError):
        tcompiler.normalize_strategy({"groupby": "nope"})


def _decision(res):
    """A cost search's candidates (strategy, estimated cost) and winner."""
    d = res.decision
    return [(c.strategy, c.est_cost) for c in d.candidates], d.chosen, res.strategy

