"""Measured cardinalities, ``explain()``, plan-store observability and the
feedback loop on the torch port: tests/test_obs.py's
``TestMeasuredCardinalities``, ``TestExplain``, ``TestPlanStoreObs`` and
``TestFeedback``.

A traced run (``with tracing():``) of a compiled plan on the local backend
taps the output rows of every operator of ``TAPPED_OPS``; the counts stay
on the device until the end of the run and come back in one copy.  On TPC-H
Q1 (sf = 0.002) the measured rows must equal the numpy reference's, and the
interp target's (which times each operator too) and the JAX package's
local target's measurements of the same plan.
"""

import json
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.obs import tracing as jax_tracing  # noqa: E402
from repro.relational import tpch as jtpch  # noqa: E402
from repro_torch.backends import emit  # noqa: E402
from repro_torch.compiler import PlanCache, compile as tcompile  # noqa: E402
from repro_torch.compiler.cost import CALIBRATION, EXEC_CALIBRATION, CostCalibration  # noqa: E402
from repro_torch.compiler.store import CALIBRATION_FILE, PlanStore  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    FEEDBACK, FeedbackCatalog, ObsWarning, OpObservation, RuntimeProfile, chrome_trace,
    tracing)
from repro_torch.relational import tpch as ttpch  # noqa: E402

CPU = "cpu"
#: the JAX package's strategy of the port's default plan
PORT_DEFAULT = {"groupby": "direct", "join": "hash"}


@pytest.fixture(scope="module")
def q1_setup():
    tables = jtpch.generate(sf=0.002, seed=7)
    ctx = ttpch.make_context(tables, pad_to=256)
    frame = ttpch.QUERIES["q1"](ctx)
    li = tables["lineitem"]
    rf, ls = np.asarray(li["l_returnflag"]), np.asarray(li["l_linestatus"])
    n_groups = len(np.unique(np.rec.fromarrays([rf, ls], names=["a", "b"])))
    return tables, ctx, frame, len(rf), n_groups


def _traced(ctx, frame, target="local", **kw):
    with tracing():
        res = ctx.compile(frame, target=target, cache=PlanCache(), device=CPU, **kw)
        res(ctx.tables if target == "interp" else ctx.sources(CPU))
    return res


class TestMeasuredCardinalities:
    def test_q1_local_cardinalities(self, q1_setup):
        tables, ctx, frame, n_rows, n_groups = q1_setup
        prof = _traced(ctx, frame).profile
        assert prof is not None and prof.target == "local"
        by_op = {o.opcode: o for o in prof.observations}
        assert by_op["vec.ScanVec"].rows_out == n_rows
        assert by_op["vec.ScanVec"].table == "lineitem"
        agg = next(o for o in prof.observations
                   if o.opcode in ("vec.GroupAggSorted", "vec.GroupAggDirect"))
        assert agg.rows_out == n_groups
        assert all(o.est_rows is not None for o in prof.observations)
        assert all(o.rel_miss is not None for o in prof.observations)

    @pytest.mark.parametrize("strategy", [None, {"groupby": "sorted", "join": "sorted"},
                                          {"fuse": "unfused"}])
    @pytest.mark.parametrize("qname", sorted(jtpch.QUERIES))
    def test_local_taps_equal_jax_local(self, qname, strategy, q1_setup):
        """Every tapped operator measures the rows the JAX package's local
        target measures on the same plan (the same strategy, statistics on)."""
        tables, ctx, _, _, _ = q1_setup
        jctx = jtpch.make_context(tables, pad_to=256)
        jstrategy = dict(PORT_DEFAULT, **(strategy or {}))
        res = _traced(ctx, ttpch.QUERIES[qname](ctx), strategy=strategy)
        with jax_tracing():
            jres = jctx.compile(jtpch.QUERIES[qname](jctx), strategy=jstrategy,
                                cache=False)
            jres(jctx.sources())
        got = {o.key: (o.occurrences, o.rows_in, o.rows_out) for o in res.profile.observations}
        want = {o.key: (o.occurrences, o.rows_in, o.rows_out)
                for o in jres.profile.observations}
        assert got == want

    def test_q1_interp_cardinalities_and_walls(self, q1_setup):
        tables, ctx, frame, n_rows, n_groups = q1_setup
        prof = _traced(ctx, frame, target="interp").profile
        by_op = {o.opcode: o for o in prof.observations}
        assert by_op["rel.Scan"].rows_out == n_rows
        assert by_op["rel.GroupByAggr"].rows_out == n_groups
        assert all(o.wall_s is not None and o.wall_s >= 0.0 for o in prof.observations)

    def test_q1_interp_local_agree(self, q1_setup):
        tables, ctx, frame, _, _ = q1_setup
        local = _traced(ctx, frame, strategy={"fuse": "unfused"}).profile
        interp = _traced(ctx, frame, target="interp").profile
        sel_local = next(o.rows_out for o in local.observations
                         if o.opcode == "vec.MaskSelect")
        sel_interp = next(o.rows_out for o in interp.observations if o.opcode == "rel.Select")
        assert sel_local == sel_interp

    def test_q1_trace_has_nested_compile_and_execute_spans(self, q1_setup):
        tables, ctx, frame, _, _ = q1_setup
        with tracing() as tr:
            res = ctx.compile(frame, cache=PlanCache(), device=CPU)
            res(ctx.sources(CPU))
        by_cat = {}
        for e in chrome_trace(tr)["traceEvents"]:
            if e["ph"] == "X":
                by_cat.setdefault(e.get("cat"), []).append(e)
        assert len(by_cat["compile"]) == 1
        compile_id = by_cat["compile"][0]["id"]
        assert by_cat["compile.pass"]
        assert any(e["args"]["parent"] == compile_id for e in by_cat["compile.pass"])
        assert by_cat["execute"]
        assert by_cat["execute.op"] and all("rows_out" in e["args"]
                                            for e in by_cat["execute.op"])

    def test_untraced_call_attaches_no_profile(self, q1_setup):
        tables, ctx, frame, _, _ = q1_setup
        res = ctx.compile(frame, cache=PlanCache(), device=CPU)
        res(ctx.sources(CPU))
        assert res.profile is None

    def test_counts_stay_on_the_device_until_read(self):
        """``read_taps`` turns every tensor count into an int in one copy."""
        import torch

        taps = {"a": [1, torch.tensor(5), torch.tensor(3)], "b": [2, None, 7],
                "c": [1, 4, torch.tensor(2, dtype=torch.int32)]}
        assert emit.read_taps(taps) == {"a": [1, 5, 3], "b": [2, None, 7], "c": [1, 4, 2]}


class TestExplain:
    def test_cache_hit_source_memory(self, q1_setup):
        _, ctx, frame, _, _ = q1_setup
        cache = PlanCache()
        first = ctx.compile(frame, cache=cache, device=CPU)
        again = ctx.compile(frame, cache=cache, device=CPU)
        assert "cache=miss" in first.explain()
        assert again.cache_hit and again.cache_source == "memory"
        assert "cache=hit source=memory" in again.explain()
        assert cache.stats["hits"] == 1 and cache.stats["misses"] == 1

    def test_plan_cache_counters_reach_tracer(self, q1_setup):
        _, ctx, frame, _, _ = q1_setup
        with tracing() as tr:
            cache = PlanCache()
            ctx.compile(frame, cache=cache, device=CPU)
            ctx.compile(frame, cache=cache, device=CPU)
        assert tr.counters["plan_cache.miss"] == 1
        assert tr.counters["plan_cache.hit"] == 1

    def test_plan_cache_eviction_counted(self):
        cache = PlanCache(capacity=1)
        cache.store(("a",), "r1")
        cache.store(("b",), "r2")
        assert cache.stats["evictions"] == 1 and len(cache) == 1

    def test_estimate_vs_actual_table_in_explain(self, q1_setup):
        _, ctx, frame, n_rows, _ = q1_setup
        text = _traced(ctx, frame).explain()
        assert "| op | register | est rows | actual rows | miss | wall ms |" in text
        assert f"{n_rows:,}" in text
        assert "worst cardinality miss" in text

    def test_metrics_dict_is_json_ready(self, q1_setup):
        _, ctx, frame, _, _ = q1_setup
        with tracing():
            res = ctx.compile(frame, cache=PlanCache(), device=CPU)
            res(ctx.sources(CPU))
            m = res.metrics()
        json.dumps(m)
        assert m["cache_source"] == "miss"
        assert m["runtime"]["operators"]
        assert m["tracer"]["counters"]


class TestPlanStoreObs:
    def test_corrupt_plan_warns_with_path_and_reason(self, tmp_path):
        store = PlanStore(tmp_path)
        store.save_plan("abc", {"strategy": []})
        (tmp_path / "abc.json").write_text("{not json")
        with pytest.warns(ObsWarning, match="plan_store.corrupt") as rec:
            assert store.load_plan("abc") is None
        msg = str(rec[0].message)
        assert "abc.json" in msg and "reason=" in msg

    def test_corrupt_counter_and_event_when_tracing(self, tmp_path):
        store = PlanStore(tmp_path)
        (tmp_path / "bad.json").write_text("][")
        with tracing() as tr:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                store.load_plan("bad")
        assert tr.counters["plan_store.corrupt"] == 1
        events = [e for e in tr.events if e["name"] == "plan_store.corrupt"]
        assert events and "bad.json" in events[0]["path"]

    def test_missing_plan_is_a_miss_not_a_warning(self, tmp_path):
        store = PlanStore(tmp_path)
        with tracing() as tr:
            with warnings.catch_warnings():
                warnings.simplefilter("error", ObsWarning)
                assert store.load_plan("nope") is None
        assert tr.counters["plan_store.miss"] == 1

    def test_hit_counter(self, tmp_path):
        store = PlanStore(tmp_path)
        store.save_plan("k", {"strategy": [["groupby", "direct"]]})
        with tracing() as tr:
            assert store.load_plan("k")["strategy"]
        assert tr.counters["plan_store.hit"] == 1

    def test_corrupt_calibration_warns_and_defaults(self, tmp_path):
        store = PlanStore(tmp_path)
        (tmp_path / CALIBRATION_FILE).write_text("~~~")
        with pytest.warns(ObsWarning, match="plan_store.corrupt"):
            calib = store.load_calibration()
        assert calib.n == 0

    def test_jax_calibration_file_is_not_read(self, tmp_path):
        """One store directory can serve both packages: each reads its own
        calibration file."""
        store = PlanStore(tmp_path)
        (tmp_path / "calibration.json").write_text(json.dumps({"scale": 9.0, "n": 3}))
        assert store.load_calibration().n == 0
        assert len(store) == 1  # the JAX package's file counts as a record here
        store.save_calibration(CostCalibration(scale=2.0, n=1))
        assert store.load_calibration().scale == 2.0
        assert json.loads((tmp_path / "calibration.json").read_text())["scale"] == 9.0


class TestFeedback:
    def test_feedback_accumulates_scan_rows(self, q1_setup):
        _, ctx, frame, n_rows, _ = q1_setup
        FEEDBACK.clear()
        res = _traced(ctx, frame)
        assert FEEDBACK.runs == 1
        assert FEEDBACK.table_rows["lineitem"] == n_rows
        assert res.fingerprint in FEEDBACK.profiles

    def test_observed_statistics_override_rows(self, q1_setup):
        _, ctx, frame, n_rows, _ = q1_setup
        FEEDBACK.clear()
        _traced(ctx, frame)
        base = ctx.catalog().stats
        obs = FEEDBACK.observed_statistics(base)
        assert obs.table("lineitem").rows == n_rows
        assert dict(obs.table("lineitem").ndv).keys() == dict(base.table("lineitem").ndv).keys()

    def test_exec_calibration_updates(self, q1_setup):
        _, ctx, frame, _, _ = q1_setup
        n_before = EXEC_CALIBRATION.n
        res = _traced(ctx, frame)
        assert EXEC_CALIBRATION.n == n_before + 1
        assert EXEC_CALIBRATION.seconds(res.profile.est_cost) is not None

    def test_plans_over_threshold(self):
        cat = FeedbackCatalog()
        obs = OpObservation(key="k", opcode="vec.MaskSelect", program="p", register="v1",
                            occurrences=1, rows_in=100, rows_out=90, est_rows=10.0)
        cat.record(RuntimeProfile(target="local", program_name="p", fingerprint="fp1",
                                  wall_s=0.1, observations=(obs,)))
        assert cat.plans_over_threshold(threshold=1.0) == [("fp1", obs.rel_miss)]
        assert cat.plans_over_threshold(threshold=100.0) == []

    def test_replan_with_observed_stats_shifts_estimates(self, q1_setup):
        _, ctx, frame, n_rows, _ = q1_setup
        FEEDBACK.clear()
        res = _traced(ctx, frame)
        scan = next(o for o in res.profile.observations if o.opcode == "vec.ScanVec")
        catalog = ctx.catalog()
        catalog.stats = FEEDBACK.observed_statistics(catalog.stats)
        with tracing():
            res2 = tcompile(frame.program(), catalog, cache=PlanCache(), device=CPU)
            res2(ctx.sources(CPU))
        scan2 = next(o for o in res2.profile.observations if o.opcode == "vec.ScanVec")
        assert abs(scan2.rel_miss) <= abs(scan.rel_miss)
        assert scan2.rows_out == n_rows

    def test_auto_replan_swaps_a_missed_plan(self, q1_setup):
        """``enable_auto_replan``: a plan compiled on stale statistics (a
        lineitem of 64 rows) misses its scan estimate on the traced run, and
        re-plans by cost under the observed statistics."""
        from repro_torch.compiler import disable_auto_replan, enable_auto_replan

        _, ctx, frame, n_rows, _ = q1_setup
        FEEDBACK.clear()
        catalog = ctx.catalog()
        catalog.stats = catalog.stats.with_observed_rows({"lineitem": 64})
        cache = PlanCache()
        enable_auto_replan(threshold=1.0)
        try:
            with tracing() as tr:
                res = tcompile(frame.program(), catalog, cache=cache, device=CPU)
                (first,) = res(ctx.sources(CPU))
        finally:
            disable_auto_replan()
        assert res.profile.worst_miss > 1.0
        assert tr.counters.get("driver.replan", 0) == 1
        assert res.decision is not None and res.decision.source == "search"
        assert res.stats.table("lineitem").rows == n_rows
        (again,) = res(ctx.sources(CPU))
        np.testing.assert_array_equal(np.sort(again.to_numpy()["count_order"]),
                                      np.sort(first.to_numpy()["count_order"]))


def test_exec_calibration_is_not_compile_calibration():
    assert EXEC_CALIBRATION is not CALIBRATION
    assert isinstance(EXEC_CALIBRATION, CostCalibration)
