"""TPC-H with ``parallel=4``: the torch port against the JAX package.

The paper's parallelization rewrite (``Parallelize``) splits each table
into 4 chunks, runs the chunk-local operators once per chunk
(``cf.ConcurrentExecute``) and recombines the partials (``cf.Merge`` +
a second grouped aggregation, or ``rel.CombinePartials``).  The port's
``collect(parallel=4, device="cpu")`` runs the six queries with and
without ``use_kernels`` and is held against the JAX package's
``collect(parallel=4)`` under the same strategy and against the numpy
references: integers exact, floats within rtol 2e-4 (f32 sums against the
f64 oracle, as tests/test_tpch.py allows).  The lowered programs, nested
ones included, must be the same instruction for instruction.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.relational import tpch as jtpch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.relational import tpch as ttpch  # noqa: E402

STRATEGY = (("groupby", "direct"), ("join", "hash"))
GROUP_KEYS = {"q1": ("l_returnflag", "l_linestatus"), "q4": ("o_orderpriority",),
              "q12": ("l_shipmode",)}
PLAN_PARAMS = ("n", "num_buckets", "join_num_buckets", "max_groups", "key_domains",
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


def _same_plan(tprog, jprog):
    assert tprog.opcodes() == jprog.opcodes()
    for ti, ji in zip(tprog.body, jprog.body):
        for p in PLAN_PARAMS:
            assert ti.param(p) == ji.param(p), (ji.opcode, p)
        if ji.opcode == "cf.ConcurrentExecute":
            _same_plan(ti.param("P"), ji.param("P"))


@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_parallel_plan_matches_jax(qname, jctx, tctx):
    jprog = jctx.compile(jtpch.QUERIES[qname](jctx), parallel=4, use_kernels=True,
                         strategy=STRATEGY).program
    tprog = tctx.compile(ttpch.QUERIES[qname](tctx), parallel=4).program
    _same_plan(tprog, jprog)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_parallel_query_matches_jax_and_reference(qname, use_kernels, tables, jctx, tctx):
    keys = GROUP_KEYS.get(qname, ())
    got = ttpch.QUERIES[qname](tctx).collect(parallel=4, device="cpu",
                                             use_kernels=use_kernels)
    _assert_close(got, jtpch.REFERENCES[qname](tables), keys, "reference")
    jax_out = jtpch.QUERIES[qname](jctx).collect(parallel=4, use_kernels=False,
                                                 strategy=STRATEGY)
    _assert_close(got, jax_out, keys, "jax")
    for k in jax_out:  # the same result types (Q1's recombined count is f32 there too)
        assert np.asarray(got[k]).dtype == np.asarray(jax_out[k]).dtype, k


#: Q4's outer join probes a compacted build side, where the JAX package's
#: grouped_join_agg loses matches (ROADMAP Queue 3)
@pytest.mark.parametrize("qname", sorted(set(jtpch.QUERIES) - {"q4"}))
def test_parallel_query_matches_jax_pallas_kernels(qname, jctx, tctx):
    keys = GROUP_KEYS.get(qname, ())
    got = ttpch.QUERIES[qname](tctx).collect(parallel=4, device="cpu")
    jax_out = jtpch.QUERIES[qname](jctx).collect(parallel=4, use_kernels=True,
                                                 strategy=STRATEGY)
    _assert_close(got, jax_out, keys, "jax kernels")


def test_parallel_rewrite_fires_on_q6(tctx):
    """The parallel plan holds the Split / ConcurrentExecute structure."""
    ops_ = tctx.compile(ttpch.q6(tctx), parallel=4).program.opcodes()
    assert "cf.Split" in ops_ and "cf.ConcurrentExecute" in ops_
    assert "rel.CombinePartials" in ops_


@pytest.mark.parametrize("qname,wrapper,calls", [
    ("q6", "fused_select_agg", 4),      # once per chunk, partials combined
    ("q1", "grouped_select_agg", 5),    # once per chunk, then the recombine
])
def test_kernel_wrapper_runs_once_per_chunk(qname, wrapper, calls, tctx, monkeypatch):
    seen = []
    real = getattr(ops, wrapper)

    def spy(table, *a, **kw):
        seen.append(table.capacity)
        return real(table, *a, **kw)

    monkeypatch.setattr(ops, wrapper, spy)
    ttpch.QUERIES[qname](tctx).collect(parallel=4, device="cpu")
    lineitem = tctx.capacity("lineitem")
    assert len(seen) == calls
    assert seen[:4] == [lineitem // 4] * 4


def test_split_views_need_no_copy(tctx):
    from repro_torch.relational import runtime as rt

    t = tctx.sources("cpu")["lineitem"]
    chunks = rt.split(t, 4)
    col = next(iter(t.cols))
    assert all(c.cols[col].is_contiguous() for c in chunks)
    assert chunks[1].cols[col].data_ptr() == t.cols[col][t.capacity // 4:].data_ptr()
    back = rt.concat(chunks)
    assert all(bool((back.cols[k] == t.cols[k]).all()) for k in t.cols)
    with pytest.raises(ValueError, match="not divisible"):
        rt.split(t, 7 if t.capacity % 7 else 11)
