"""The cost search, the cost-keyed plan cache, the plan store and predicate
selectivity on the torch port: the local-target cases of tests/test_cost.py,
and the decision tables of the six TPC-H queries against the JAX package's.

The cost model is pure Python (``repro_torch/compiler/cost.py`` is the JAX
file), so on the same statistics the port's search must lower the same
candidates in the same order, give each the same estimated cost, and pick
the same winner as the JAX package's — sequential and with ``parallel=4``.
Plans run on the CPU (``device="cpu"``).
"""

import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.frontends import dataflow as jdf  # noqa: E402
from repro.relational import tpch as jtpch  # noqa: E402
from repro_torch.compiler import (  # noqa: E402
    PlanCache,
    PlanStore,
    Statistics,
    TableStats,
    compile as tcompile,
    estimate_cost,
    propagate,
)
from repro_torch.compiler.store import CALIBRATION_FILE  # noqa: E402
from repro_torch.core.expr import col  # noqa: E402
from repro_torch.core.passes import FuseSelectAgg, Parallelize  # noqa: E402
from repro_torch.core.passes.lower_vec import Catalog, LowerRelToVec  # noqa: E402
from repro_torch.frontends import dataflow as tdf  # noqa: E402
from repro_torch.frontends.dataflow import count_, sum_  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.relational import tpch as ttpch  # noqa: E402


def _sales(m):
    rng = np.random.default_rng(3)
    n = 4096
    ctx = m.Context(pad_to=512)
    ctx.register("sales", {
        "k": rng.integers(0, 1024, n).astype(np.int32),
        "amount": rng.gamma(2.0, 50.0, n).astype(np.float32),
        "year": rng.integers(2018, 2026, n).astype(np.int32),
    })
    return ctx


@pytest.fixture()
def sales_ctx():
    return _sales(tdf)


def grouped_query(ctx, max_groups=1024, m=tdf):
    return (ctx.table("sales")
            .group_by("k", max_groups=max_groups)
            .agg(m.sum_("amount").as_("rev"), m.count_().as_("n")))


def scalar_query(ctx, c=col, m=tdf):
    return (ctx.table("sales")
            .filter(c("year") >= 2020)
            .agg(m.sum_("amount").as_("rev")))


def _decision(res):
    d = res.decision
    return [(c.strategy, c.est_cost, c.size) for c in d.candidates], d.chosen, res.strategy


# ---------------------------------------------------------------------------
# statistics propagation
# ---------------------------------------------------------------------------


class TestStatsPropagation:
    def test_context_statistics_are_exact(self, sales_ctx):
        ts = sales_ctx.statistics().table("sales")
        assert ts.rows == 4096
        assert 900 < ts.ndv_of("k") <= 1024  # exact distinct count of the draw
        assert ts.ndv_of("year") == 8
        assert ts.bytes_per_row == 12.0  # i32 + f32 + i32
        # the same statistics as the JAX package's, by their cache key
        assert sales_ctx.statistics().cache_key() == _sales(jdf).statistics().cache_key()

    def test_stats_survive_parallelize_and_lowering(self, sales_ctx):
        stats = sales_ctx.statistics()
        ndv_k = stats.table("sales").ndv_of("k")
        program = Parallelize(n=4).apply(grouped_query(sales_ctx).program())
        env = propagate(program, stats)
        assert env.get(program, program.results[0]).rows == pytest.approx(ndv_k, rel=0.01)
        program = LowerRelToVec(sales_ctx.catalog()).apply(program)
        env = propagate(program, stats)
        assert env.get(program, program.results[0]).rows == pytest.approx(ndv_k, rel=0.01)

    def test_stats_survive_fusion(self, sales_ctx):
        program = LowerRelToVec(sales_ctx.catalog()).apply(scalar_query(sales_ctx).program())
        program = FuseSelectAgg().apply(program)
        assert "vec.FusedSelectAgg" in program.opcodes()
        env = propagate(program, sales_ctx.statistics())
        assert env.get(program, program.results[0]).rows == 1.0

    def test_cost_scales_with_stats(self, sales_ctx):
        program = LowerRelToVec(sales_ctx.catalog()).apply(
            grouped_query(sales_ctx).program())
        small = Statistics.make({"sales": TableStats.make(512, 12.0, {"k": 4})})
        big = Statistics.make({"sales": TableStats.make(1 << 20, 12.0, {"k": 1 << 16})})
        assert estimate_cost(program, big) > estimate_cost(program, small)


# ---------------------------------------------------------------------------
# cost-keyed plan cache
# ---------------------------------------------------------------------------


class TestCostKeyedCache:
    def test_different_stats_never_hit_stale_plan(self, sales_ctx):
        cache = PlanCache()
        program = grouped_query(sales_ctx).program()
        caps = {"sales": sales_ctx.capacity("sales")}
        lo = Catalog(capacities=caps, stats=Statistics.make(
            {"sales": TableStats.make(4096, 12.0, {"k": 4})}))
        hi = Catalog(capacities=caps, stats=Statistics.make(
            {"sales": TableStats.make(4096, 12.0, {"k": 4096})}))
        kw = dict(parallel=4, optimize="cost", cache=cache, device="cpu")
        r1 = tcompile(program, lo, **kw)
        r2 = tcompile(program, hi, **kw)
        r3 = tcompile(program, lo, **kw)
        assert not r1.cache_hit
        assert not r2.cache_hit  # changed stats → different key → re-planned
        assert r3.cache_hit      # same stats → same plan served

    def test_forced_strategy_is_part_of_the_key(self, sales_ctx):
        cache = PlanCache()
        q = scalar_query(sales_ctx)
        r1 = sales_ctx.compile(q, cache=cache, strategy={"fuse": "fused"}, device="cpu")
        r2 = sales_ctx.compile(q, cache=cache, strategy={"fuse": "unfused"}, device="cpu")
        assert not r2.cache_hit
        assert dict(r1.strategy)["fuse"] == "fused"
        assert dict(r2.strategy)["fuse"] == "unfused"
        assert "vec.FusedSelectAgg" in r1.program.opcodes()
        assert "vec.FusedSelectAgg" not in r2.program.opcodes()

    def test_unknown_strategy_rejected(self, sales_ctx):
        q = scalar_query(sales_ctx)
        with pytest.raises(ValueError, match="no strategy choice"):
            sales_ctx.compile(q, strategy={"grouped_recombine": "exchange"})
        with pytest.raises(ValueError, match="no variant"):
            sales_ctx.compile(q, strategy={"fuse": "mega"})
        with pytest.raises(ValueError, match="mapping"):
            sales_ctx.compile(q, strategy="fused")

    def test_cost_mode_prefers_fusion(self, sales_ctx):
        res = sales_ctx.compile(scalar_query(sales_ctx), optimize="cost",
                                cache=PlanCache(), device="cpu")
        assert dict(res.strategy)["fuse"] == "fused"
        assert res.decision is not None
        assert res.decision.source == "search"
        labels = [c.label() for c in res.decision.candidates]
        assert any("unfused" in label for label in labels)
        assert "cost search" in res.explain()
        jctx = _sales(jdf)
        jres = jctx.compile(scalar_query(jctx, jdf.col, jdf), optimize="cost", cache=False)
        assert _decision(res) == _decision(jres)


# ---------------------------------------------------------------------------
# plan-store persistence
# ---------------------------------------------------------------------------


def _records(store):
    return [p for p in Path(store.root).glob("*.json") if p.name != CALIBRATION_FILE]


class TestPlanStore:
    def test_replan_from_store_skips_search(self, sales_ctx, tmp_path):
        store = PlanStore(tmp_path / "plans")
        program = grouped_query(sales_ctx).program()
        kw = dict(parallel=4, optimize="cost", store=store, device="cpu")
        r1 = tcompile(program, sales_ctx.catalog(), cache=PlanCache(), **kw)
        assert r1.decision.source == "search"
        assert len(store) == 1
        # "restart": fresh in-memory cache, same store directory
        r2 = tcompile(program, sales_ctx.catalog(), cache=PlanCache(), **kw)
        assert not r2.cache_hit
        assert r2.decision.source == "store" and r2.cache_source == "store"
        assert r2.strategy == r1.strategy
        (out,) = r2(sales_ctx.sources("cpu"))
        want = grouped_query(sales_ctx).collect(target="interp")
        np.testing.assert_allclose(np.sort(out.to_numpy()["rev"]), np.sort(want["rev"]),
                                   rtol=2e-4)

    def test_store_record_contents(self, sales_ctx, tmp_path):
        store = PlanStore(tmp_path / "plans")
        tcompile(grouped_query(sales_ctx).program(), sales_ctx.catalog(), parallel=4,
                 optimize="cost", cache=PlanCache(), store=store, device="cpu")
        (rec_path,) = _records(store)
        rec = json.loads(rec_path.read_text())
        assert rec["target"] == "local"
        assert rec["fingerprint"]
        assert dict(rec["strategy"])  # the chosen strategy is recorded
        assert rec["records"]         # pass records (PassRecord history)
        calib = store.load_calibration()
        assert calib.n >= 1 and calib.scale > 0
        # the port's calibration has its own file: the JAX package's is untouched
        assert (Path(store.root) / CALIBRATION_FILE).exists()
        assert not (Path(store.root) / "calibration.json").exists()

    def test_corrupt_record_is_ignored(self, sales_ctx, tmp_path):
        store = PlanStore(tmp_path / "plans")
        q = grouped_query(sales_ctx).program()
        kw = dict(parallel=4, optimize="cost", store=store, device="cpu")
        tcompile(q, sales_ctx.catalog(), cache=PlanCache(), **kw)
        for p in Path(store.root).glob("*.json"):
            p.write_text("{corrupt")
        with pytest.warns(Warning, match="plan_store.corrupt"):
            r = tcompile(q, sales_ctx.catalog(), cache=PlanCache(), **kw)
        assert r.decision.source == "search"  # fell back to a fresh search


# ---------------------------------------------------------------------------
# predicate selectivity
# ---------------------------------------------------------------------------


class TestPredicateSelectivity:
    def _select_est(self, ctx, q):
        program = LowerRelToVec(ctx.catalog()).apply(q.program())
        env = propagate(program, ctx.statistics())
        sel = next(i for i in program.body if i.opcode == "vec.MaskSelect")
        return env.get(program, sel.outputs[0]).rows

    def test_range_predicate_estimate_tracks_domain(self, sales_ctx):
        q = (sales_ctx.table("sales").filter(col("year") >= 2019)
             .agg(sum_("amount").as_("rev")))
        assert self._select_est(sales_ctx, q) == pytest.approx(4096 * 7 / 8, rel=0.02)

    def test_out_of_domain_predicate_estimates_empty(self, sales_ctx):
        q = (sales_ctx.table("sales").filter(col("year") >= 2030)
             .agg(sum_("amount").as_("rev")))
        assert self._select_est(sales_ctx, q) == 1.0

    def test_explain_miss_shrinks_vs_default_guess(self, sales_ctx):
        q = (sales_ctx.table("sales").filter(col("year") >= 2019)
             .group_by("k", max_groups=1024)
             .agg(sum_("amount").as_("rev"), count_().as_("n")))
        with tracing():
            res = sales_ctx.compile(q, strategy={"fuse": "unfused"}, cache=PlanCache(),
                                    device="cpu")
            res(sales_ctx.sources("cpu"))
        obs = next(o for o in res.profile.observations if o.opcode == "vec.MaskSelect")
        flat_miss = abs(obs.rows_out - 0.5 * 4096) / (0.5 * 4096)
        assert flat_miss > 0.5
        assert abs(obs.rel_miss) < 0.1
        assert "est rows" in res.explain() and "actual rows" in res.explain()


# ---------------------------------------------------------------------------
# the six TPC-H queries: the port's decision tables are the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_ctxs():
    tables = jtpch.generate(sf=0.002, seed=7)
    return jtpch.make_context(tables), ttpch.make_context(tables)


@pytest.mark.parametrize("parallel", [None, 4])
@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_decision_table_equals_jax(qname, parallel, tpch_ctxs):
    jctx, tctx = tpch_ctxs
    res = tctx.compile(ttpch.QUERIES[qname](tctx), optimize="cost", parallel=parallel,
                       cache=False, device="cpu")
    jres = jctx.compile(jtpch.QUERIES[qname](jctx), optimize="cost", parallel=parallel,
                        cache=False)
    assert len(res.decision.candidates) == 16
    assert _decision(res) == _decision(jres)
    assert [op for op in res.program.opcodes()] == [op for op in jres.program.opcodes()]


@pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
def test_cost_chosen_plan_gives_the_reference(qname, tpch_ctxs):
    jctx, tctx = tpch_ctxs
    got = ttpch.QUERIES[qname](tctx).collect(device="cpu", optimize="cost", cache=False)
    want = ttpch.REFERENCES[qname](jctx.tables)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.ndim and len(g) > 1:
            keys = [c for c in want if np.asarray(want[c]).dtype.kind in "iu"]
            g = g[np.lexsort([np.asarray(got[c]) for c in reversed(keys)])]
            w = w[np.lexsort([np.asarray(want[c]) for c in reversed(keys)])]
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=2e-4,
                                   err_msg=f"{qname}.{k}")
