"""The torch port's plan cache (``repro_torch.compiler.PlanCache``).

A repeated ``collect`` of the same frame hits the cache: the hit carries
the miss's lowered program and gives the same bits.  A new device,
strategy, ``parallel``, ``use_kernels`` or ``register`` misses.  The
fingerprint the key holds is the JAX package's, for the same frontend
program built in each package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compiler.fingerprint import fingerprint as jfingerprint  # noqa: E402
from repro.frontends import sql as jsql  # noqa: E402
from repro.relational import tpch as jtpch  # noqa: E402
from repro_torch import compiler as tcompiler  # noqa: E402
from repro_torch.compiler import PLAN_CACHE, PlanCache  # noqa: E402
from repro_torch.compiler.fingerprint import fingerprint  # noqa: E402
from repro_torch.frontends import sql as tsql  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.relational import tpch as ttpch  # noqa: E402

STRATEGIES = [None, {"groupby": "sorted", "join": "sorted"}, {"encode": "dict"},
              {"fuse": "unfused"}]


@pytest.fixture(scope="module")
def tables():
    return jtpch.generate(sf=0.002, seed=7)


@pytest.fixture
def tctx(tables):
    return ttpch.make_context(tables)


def _bits(a, b):
    """Two results (dicts of numpy arrays) equal bit for bit."""
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("strategy", STRATEGIES, ids=["default", "sorted", "dict", "unfused"])
@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_hit_gives_the_misses_bits(qname, strategy, tctx):
    cache = PlanCache()
    frame = ttpch.QUERIES[qname](tctx)
    first = frame.collect(device="cpu", strategy=strategy, cache=cache)
    a = tctx.compile(frame, device="cpu", strategy=strategy, cache=cache)
    b = tctx.compile(ttpch.QUERIES[qname](tctx), device="cpu", strategy=strategy, cache=cache)
    assert cache.stats == {"hits": 2, "misses": 1, "evictions": 0, "entries": 1}
    assert a.cache_hit and b.cache_hit and b.program is a.program
    again = frame.collect(device="cpu", strategy=strategy, cache=cache)
    _bits(again, first)


def test_repeated_collect_hits_the_process_wide_cache(tctx):
    frame = ttpch.q6(tctx)
    frame.collect(device="cpu")
    before = dict(PLAN_CACHE.stats)
    frame.collect(device="cpu")
    assert PLAN_CACHE.stats["hits"] == before["hits"] + 1
    assert PLAN_CACHE.stats["misses"] == before["misses"]
    res = tctx.compile(frame, device="cpu")
    assert res.cache_hit and res.program.opcodes()


def test_no_cache_never_stores(tctx):
    before = dict(PLAN_CACHE.stats)
    r1 = tctx.compile(ttpch.q14(tctx), device="cpu", cache=False)
    r2 = tctx.compile(ttpch.q14(tctx), device="cpu", cache=False)
    assert not r1.cache_hit and not r2.cache_hit and r1.program is not r2.program
    assert PLAN_CACHE.stats == before


@pytest.mark.parametrize("change", [
    {"device": "cuda"},  # named, not resolved: compiles where no card is
    {"device": "cuda:1"},
    {"strategy": {"groupby": "sorted"}},
    {"strategy": {"join": "sorted"}},
    {"strategy": {"encode": "dict"}},
    {"strategy": {"fuse": "unfused"}},
    {"parallel": 4},
    {"parallel": 2},
    {"use_kernels": False},
])
def test_a_new_option_misses(change, tctx):
    cache = PlanCache()
    frame = ttpch.q1(tctx)
    base = dict(device="cpu", cache=cache)
    tctx.compile(frame, **base)
    res = tctx.compile(frame, **{**base, **change})
    assert not res.cache_hit
    assert cache.stats["misses"] == 2 and cache.stats["entries"] == 2
    assert tctx.compile(frame, **{**base, **change}).cache_hit


def test_register_misses(tables):
    """``register`` resets the statistics: where they change, their key
    changes and the old plan is not served.  Here a fourth return flag
    widens Q1's key domain, which a stale direct-tier plan would clip into
    the third flag's group.  Registering the same columns again keeps the
    statistics, and so the plan."""
    ctx = ttpch.make_context(tables)
    cache = PlanCache()
    ctx.compile(ttpch.q1(ctx), device="cpu", cache=cache)
    ctx.register("lineitem", dict(tables["lineitem"]))
    assert ctx.compile(ttpch.q1(ctx), device="cpu", cache=cache).cache_hit
    li = dict(tables["lineitem"])
    li["l_returnflag"] = np.where(np.arange(len(li["l_returnflag"])) % 7 == 0, 3,
                                  li["l_returnflag"]).astype(np.int32)
    ctx.register("lineitem", li)
    assert not ctx.compile(ttpch.q1(ctx), device="cpu", cache=cache).cache_hit
    got = ttpch.q1(ctx).collect(device="cpu", cache=cache)
    want = ttpch.REFERENCES["q1"]({**tables, "lineitem": li})
    assert 3 in got["l_returnflag"]
    order = np.lexsort((got["l_linestatus"], got["l_returnflag"]))
    w_order = np.lexsort((want["l_linestatus"], want["l_returnflag"]))
    for k in ("l_returnflag", "count_order"):
        np.testing.assert_array_equal(got[k][order], want[k][w_order])
    np.testing.assert_allclose(got["sum_qty"][order], want["sum_qty"][w_order], rtol=2e-4)


def test_stats_evictions_and_counters(tctx):
    cache = PlanCache(capacity=2)
    frames = [ttpch.q6(tctx), ttpch.q14(tctx), ttpch.q19(tctx)]
    with tracing() as tracer:
        for f in frames:
            tctx.compile(f, device="cpu", cache=cache)
        assert tctx.compile(frames[2], device="cpu", cache=cache).cache_hit
        assert not tctx.compile(frames[0], device="cpu", cache=cache).cache_hit
    assert cache.stats == {"hits": 1, "misses": 4, "evictions": 2, "entries": 2}
    assert len(cache) == 2
    counters = tracer.metrics()["counters"]
    assert counters["plan_cache.hit"] == 1
    assert counters["plan_cache.miss"] == 4
    assert counters["plan_cache.evict"] == 2
    cache.clear()
    assert cache.stats == {"hits": 0, "misses": 0, "evictions": 0, "entries": 0}


def test_drop_invalidates_one_entry(tctx):
    cache = PlanCache()
    frame = ttpch.q6(tctx)
    tctx.compile(frame, device="cpu", cache=cache)
    (key,) = list(cache._entries)
    cache.drop(key)
    assert len(cache) == 0
    assert not tctx.compile(frame, device="cpu", cache=cache).cache_hit


def test_cost_search_still_raises_before_the_cache(tables, tctx):
    """The cost search is ported: it gives Q6's answer, the JAX package's
    decision table, and its plan is cached under the key of its options."""
    cache = PlanCache()
    res = tctx.compile(ttpch.q6(tctx), device="cpu", optimize="cost", cache=cache)
    jctx = jtpch.make_context(tables)
    jres = jctx.compile(jtpch.q6(jctx), optimize="cost", cache=False)
    assert [(c.strategy, c.est_cost) for c in res.decision.candidates] == \
        [(c.strategy, c.est_cost) for c in jres.decision.candidates]
    assert res.strategy == jres.strategy and res.decision.chosen == jres.decision.chosen
    got = ttpch.q6(tctx).collect(device="cpu", optimize="cost", cache=cache)
    want = ttpch.q6(tctx).collect(device="cpu", cache=False)
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=1e-5)
    assert cache.stats["hits"] == 1 and cache.stats["entries"] == 1


def test_every_strategy_variant_is_accepted():
    for name, labels in (("groupby", ("direct", "sorted")), ("join", ("hash", "sorted")),
                         ("encode", ("raw", "dict")), ("fuse", ("fused", "unfused"))):
        for label in labels:
            assert tcompiler.normalize_strategy({name: label})[name] == label
    assert tcompiler.normalize_strategy([("join", "sorted")])["join"] == "sorted"
    with pytest.raises(ValueError, match="no variant"):
        tcompiler.normalize_strategy({"join": "nested-loop"})


# ---------------------------------------------------------------------------
# the fingerprint: the JAX package's, alpha-invariant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_fingerprint_equals_the_jax_packages(qname, tables, tctx):
    jctx = jtpch.make_context(tables)
    jp = jtpch.QUERIES[qname](jctx).program(qname)
    tp = ttpch.QUERIES[qname](tctx).program(qname)
    assert fingerprint(tp) == jfingerprint(jp)
    # a second construction, under another program name, is the same plan
    assert fingerprint(ttpch.QUERIES[qname](tctx).program("another")) == fingerprint(tp)


def test_fingerprint_of_sql_equals_the_jax_packages(tables, tctx):
    jctx = jtpch.make_context(tables)
    q = ("SELECT sum(l_extendedprice) AS s, count(*) AS n FROM lineitem "
         "WHERE l_quantity < 24 GROUP BY l_returnflag ORDER BY l_returnflag LIMIT 2")
    assert fingerprint(tsql.parse(q, tctx).program()) == \
        jfingerprint(jsql.parse(q, jctx).program())
    other = q.replace("< 24", "< 25")
    assert fingerprint(tsql.parse(other, tctx).program()) != \
        fingerprint(tsql.parse(q, tctx).program())
