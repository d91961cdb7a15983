"""Chaos on the torch port: fault injection, the fallback ladder, poison
plans, plan-store chaos and admission — the local-target cases of
tests/test_robust.py — and the port's own rule that faults of the card or
of a kernel are not walked down the ladder.

Every plan runs on the CPU (``device="cpu"``; the kernels' plain versions).
The oracle is the port's numpy interpreter (``target="interp"``), itself
held to the JAX package's interpreter bit for bit.  An injected plan fault
must land on the oracle's answer through the ladder, loudly
(``DegradedWarning``, ``robust.fallback.*`` counters, ``degraded`` set).
A missing card, a kernel that does not build and a kernel launch that
fails must raise under ``guard=True`` instead.
"""

from __future__ import annotations

import json
import os
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.frontends import dataflow as jdf  # noqa: E402
from repro_torch import errors  # noqa: E402
from repro_torch.compiler import PlanCache, compile as tcompile  # noqa: E402
from repro_torch.compiler.store import CALIBRATION_FILE, PlanStore  # noqa: E402
from repro_torch.core.expr import col  # noqa: E402
from repro_torch.frontends.dataflow import Context, count_, sum_, _to_numpy  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.obs import DegradedWarning, tracing  # noqa: E402
from repro_torch.relational import tpch as ttpch  # noqa: E402
from repro_torch.robust.admission import AdmissionError, estimate_peak_bytes  # noqa: E402
from repro_torch.robust.fallback import fallback_ladder  # noqa: E402
from repro_torch.robust.inject import (  # noqa: E402
    InjectedFault, inject, maybe_inject, registered_points)

CHAOS_SEED = int(os.environ.get("REPRO_CHAOS_SEED", "0"))
CPU = "cpu"


def _sales_data():
    rng = np.random.default_rng(7)
    n = 2048
    return {"region": rng.integers(0, 6, n).astype(np.int32),
            "amount": rng.gamma(2.0, 50.0, n).astype(np.float32),
            "year": rng.integers(2018, 2026, n).astype(np.int32)}


def make_sales_ctx(m=None):
    ctx = (m or Context)(pad_to=256)
    ctx.register("sales", _sales_data())
    return ctx


def sales_query(ctx, c=col, s=sum_, n=count_):
    return (ctx.table("sales")
            .filter(c("year") >= 2020)
            .group_by("region", max_groups=8)
            .agg(s("amount").as_("rev"), n().as_("n")))


def run_compiled(ctx, result) -> dict:
    (out,) = result(ctx.sources(CPU))
    return _to_numpy(out)


def assert_matches_oracle(got, oracle, key="region"):
    assert set(got) == set(oracle)
    order_got = np.argsort(np.asarray(got[key]).ravel(), kind="stable")
    order_want = np.argsort(np.asarray(oracle[key]).ravel(), kind="stable")
    for k in oracle:
        np.testing.assert_allclose(
            np.asarray(got[k]).ravel()[order_got].astype(np.float64),
            np.asarray(oracle[k]).ravel()[order_want].astype(np.float64), rtol=1e-4)


@pytest.fixture()
def sales():
    ctx = make_sales_ctx()
    oracle = ctx.execute(sales_query(ctx), target="interp")
    jctx = make_sales_ctx(jdf.Context)
    jax_oracle = jctx.execute(sales_query(jctx, jdf.col, jdf.sum_, jdf.count_),
                              target="interp")
    for k in jax_oracle:
        assert np.asarray(oracle[k]).tobytes() == np.asarray(jax_oracle[k]).tobytes()
    return ctx, oracle


def _degraded(caught):
    return [w for w in caught if issubclass(w.category, DegradedWarning)]


# ---------------------------------------------------------------------------
# the injection registry
# ---------------------------------------------------------------------------


class TestInjectionRegistry:
    def test_catalog_covers_the_wired_points(self):
        points = registered_points()
        assert sorted(points) == sorted(["driver.pass", "store.load", "store.save",
                                         "backend.compile", "backend.execute",
                                         "serve.step", "stream.batch",
                                         "stream.snapshot", "stream.restore",
                                         "spmd.shard"])

    def test_unknown_point_and_mode_rejected(self):
        with pytest.raises(KeyError, match="unknown injection point"):
            with inject("pjit.step"):
                pass
        with pytest.raises(ValueError, match="modes"):
            with inject("backend.compile", mode="corrupt"):
                pass

    def test_unarmed_site_is_passthrough(self):
        payload = object()
        assert maybe_inject("backend.execute", payload) is payload

    def test_firing_sequence_replays_for_a_seed(self):
        def sequence(seed):
            fired = []
            with inject("backend.execute", rate=0.5, times=None, seed=seed):
                for _ in range(32):
                    try:
                        maybe_inject("backend.execute")
                        fired.append(False)
                    except InjectedFault:
                        fired.append(True)
            return fired

        assert sequence(CHAOS_SEED) == sequence(CHAOS_SEED)
        assert any(sequence(CHAOS_SEED)) and not all(sequence(CHAOS_SEED))

    def test_times_bounds_firings(self):
        with inject("backend.execute", times=2) as rule:
            for _ in range(2):
                with pytest.raises(InjectedFault):
                    maybe_inject("backend.execute")
            maybe_inject("backend.execute")
        assert rule.fired == 2

    def test_corrupt_without_corruptor_degenerates_to_raise(self):
        with inject("driver.pass", mode="corrupt"):
            with pytest.raises(InjectedFault):
                maybe_inject("driver.pass", "payload")


# ---------------------------------------------------------------------------
# the fallback chain
# ---------------------------------------------------------------------------


class TestFallbackChain:
    @pytest.mark.parametrize("point,mode", [
        ("driver.pass", "raise"),
        ("driver.pass", "corrupt"),
        ("backend.compile", "raise"),
        ("backend.execute", "raise"),
    ])
    def test_fault_degrades_to_oracle_correct(self, sales, point, mode):
        ctx, oracle = sales
        with tracing() as tr:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with inject(point, mode=mode, times=1, seed=CHAOS_SEED):
                    result = ctx.compile(sales_query(ctx), cache=PlanCache(), device=CPU)
                    got = run_compiled(ctx, result)
        assert_matches_oracle(got, oracle)
        assert _degraded(caught), "fallback must be loud, not silent"
        assert result.degraded, result.explain()
        assert result.degraded[0] == "groupby=sorted"  # the port's default is direct
        assert "DEGRADED" in result.explain()
        assert tr.counters.get("robust.fallback.step", 0) >= 1
        assert tr.counters.get("robust.fallback.recovered", 0) >= 1
        assert tr.counters.get(f"robust.inject.{point}", 0) >= 1

    def test_every_rung_down_to_interp(self, sales):
        """A fault at every rung's execution: the answer comes from numpy."""
        ctx, oracle = sales
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with inject("backend.execute", times=4, seed=CHAOS_SEED):
                result = ctx.compile(sales_query(ctx), cache=PlanCache(), device=CPU)
                got = run_compiled(ctx, result)
        assert result.degraded == ("groupby=sorted", "join=sorted", "fuse=unfused", "interp")
        assert result.target == "interp"
        assert len(_degraded(caught)) == 4
        assert_matches_oracle(got, oracle)

    def test_exec_guard_disarms_after_recovery(self, sales):
        ctx, oracle = sales
        with inject("backend.execute", times=1, seed=CHAOS_SEED):
            result = ctx.compile(sales_query(ctx), cache=PlanCache(), device=CPU)
            run_compiled(ctx, result)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = run_compiled(ctx, result)
        assert_matches_oracle(got, oracle)
        assert not _degraded(caught)

    def test_metrics_carry_degradation(self, sales):
        ctx, _ = sales
        with inject("backend.compile", times=1, seed=CHAOS_SEED):
            result = ctx.compile(sales_query(ctx), cache=PlanCache(), device=CPU)
        assert result.metrics()["degraded"] == list(result.degraded)

    def test_guard_off_raises(self, sales):
        ctx, _ = sales
        with inject("backend.compile", times=1, seed=CHAOS_SEED):
            with pytest.raises(InjectedFault):
                ctx.compile(sales_query(ctx), cache=PlanCache(), guard=False, device=CPU)

    def test_invalid_inputs_still_raise_under_guard(self, sales):
        ctx, _ = sales
        with pytest.raises(ValueError, match="sales"):
            ctx.compile(sales_query(ctx), parallel=3, cache=PlanCache(), device=CPU)

    def test_ladder_shape(self):
        chosen = {"groupby": "direct", "fuse": "fused", "grouped-recombine": "exchange"}
        assert [r for r, _ in fallback_ladder(chosen)] == [
            "groupby=sorted", "fuse=unfused", "grouped-recombine=gather", "interp"]
        assert list(fallback_ladder({"groupby": "sorted"}, choice_names={"groupby"})) \
            == [("interp", None)]


# ---------------------------------------------------------------------------
# faults of the card or of a kernel re-raise under the guard
# ---------------------------------------------------------------------------


class TestCardFaultsRaise:
    @pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
    def test_no_card_raises_under_guard(self, sales):
        ctx, _ = sales
        with warnings.catch_warnings():
            warnings.simplefilter("error", DegradedWarning)
            with pytest.raises(errors.NoCardError):
                sales_query(ctx).collect(cache=PlanCache())
            result = ctx.compile(sales_query(ctx), cache=PlanCache())  # device: cuda
            assert result._guard is not None
            with pytest.raises(errors.NoCardError):
                result(ctx.sources(CPU))
            assert not result.degraded

    def test_device_mismatch_raises_under_guard(self):
        from repro_torch import kmeans

        prog = kmeans.program(8, 2, 2)
        result = tcompile(prog, device=CPU, cache=False)
        with pytest.raises(errors.DeviceMismatchError):
            result({}, torch.empty((8, 2), device="meta"), np.zeros((2, 2), np.float32))
        assert not result.degraded

    def test_build_failure_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
        for var in ("CUDA_HOME", "CUDA_PATH"):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setattr(build.shutil, "which", lambda name: None)
        with pytest.raises(errors.KernelBuildError, match="nvcc not found"):
            build.build_generated("fused_select_agg", "// empty")

    @pytest.mark.parametrize("fault", ["build", "launch", "refused", "codegen", "cdll", "oom"])
    def test_kernel_faults_raise_under_guard(self, fault, monkeypatch, tmp_path, sales):
        """A wrapper that fails in any way — its build, its launch, its own
        check of the inputs, the code generator, loading its library, the
        card's memory — raises through the guard, not into the ladder."""
        ctx, _ = sales
        monkeypatch.setattr(build, "_LOADED", {})
        monkeypatch.setattr(build, "build",
                            lambda names=None: {"segsum": tmp_path / "not-a-library.so"})
        (tmp_path / "not-a-library.so").write_text("not an ELF file")

        def no_codegen(*args, **kw):
            raise TypeError("codegen: no C type for column type 'x'")

        def failing(table, pred, keys, aggs, mg, domains, nb):
            if fault == "build":
                raise errors.KernelBuildError("kernel build failed: nvcc exit 1")
            if fault == "launch":
                ops._raise_on(700, "grouped_select_agg")
            if fault == "refused":  # the wrapper's own check of the bucket count
                ops._grouped_select_launch(table, pred, tuple(keys), tuple(aggs), domains, nb + 1)
            if fault == "codegen":
                monkeypatch.setattr(ops.exprcode, "compile_program", no_codegen)
                ops._grouped_select_launch(table, pred, tuple(keys), tuple(aggs), domains, nb)
            if fault == "cdll":
                build.library("segsum")
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

        monkeypatch.setattr(ops, "grouped_select_agg", failing)
        want = errors.KernelBuildError if fault in ("build", "codegen", "cdll") \
            else errors.KernelLaunchError
        with warnings.catch_warnings():
            warnings.simplefilter("error", DegradedWarning)
            with pytest.raises(want):
                sales_query(ctx).collect(device=CPU, cache=PlanCache(), guard=True)

    @pytest.mark.parametrize("fault", ["execute", "oom", "admission"])
    def test_plan_on_the_card_reraises_what_was_not_injected(self, fault, sales):
        """A plan for the card walks for no failure but an injected one: a
        failure at its first execution (a plan fault on the host) and an
        over-budget plan (which degrades to sorted on the host) raise."""
        ctx, _ = sales
        with warnings.catch_warnings():
            warnings.simplefilter("error", DegradedWarning)
            if fault == "admission":
                big = make_big_domain_ctx()
                with pytest.raises(AdmissionError):
                    big.compile(events_query(big), cache=PlanCache(), device="cuda",
                                strategy={"groupby": "direct"},
                                memory_budget=TestAdmission.BUDGET)
                return
            result = ctx.compile(sales_query(ctx), cache=PlanCache(), device="cuda")
            boom = {"execute": ValueError("an operator refused its inputs"),
                    "oom": torch.OutOfMemoryError("CUDA out of memory")}[fault]

            def failing(sources=None, *args):
                raise boom

            result.executable = failing
            with pytest.raises(type(boom)):
                result(None)
        assert result.degraded == ()

    def test_plan_on_the_card_walks_for_injected_faults(self, sales):
        ctx, _ = sales
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with inject("backend.compile", times=1, seed=CHAOS_SEED):
                result = ctx.compile(sales_query(ctx), cache=PlanCache(), device="cuda")
        assert result.degraded == ("groupby=sorted",)
        assert len(_degraded(caught)) == 1

    def test_launch_error_class(self):
        with pytest.raises(errors.KernelLaunchError, match="CUDA error 700"):
            ops._raise_on(700, "fused_select_agg")
        ops._raise_on(0, "fused_select_agg")
        assert errors.is_card_fault(errors.NoCardError("x"))
        assert errors.is_card_fault(torch.OutOfMemoryError("CUDA out of memory"))
        assert errors.is_card_fault(torch.AcceleratorError("CUDA error: an illegal memory access"))
        assert not errors.is_card_fault(RuntimeError("CUDA error, by its text alone"))
        assert not errors.is_card_fault(InjectedFault("x"))


# ---------------------------------------------------------------------------
# poison plans
# ---------------------------------------------------------------------------


def _record_paths(root: Path):
    return [p for p in Path(root).glob("*.json") if p.name != CALIBRATION_FILE]


class TestPoisonPlans:
    def test_poison_prevents_second_crash_from_cache(self, sales, tmp_path):
        ctx, oracle = sales
        store = PlanStore(tmp_path)
        q = sales_query(ctx)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with inject("backend.execute", times=1, seed=CHAOS_SEED):
                first = ctx.compile(q, cache=PlanCache(), store=store, device=CPU)
                got = run_compiled(ctx, first)
        assert_matches_oracle(got, oracle)
        assert first.degraded
        poisons = [json.loads(p.read_text()).get("poison") or []
                   for p in _record_paths(tmp_path)]
        assert any(poisons), "crashed strategy must be poisoned"
        with tracing() as tr:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                second = ctx.compile(q, cache=PlanCache(), store=store, device=CPU)
                got = run_compiled(ctx, second)
        assert_matches_oracle(got, oracle)
        assert second.degraded
        assert tr.counters.get("robust.fallback.poison_skip", 0) >= 1
        assert _degraded(caught)

    def test_poisoned_strategies_roundtrip(self, tmp_path):
        store = PlanStore(tmp_path)
        store.mark_poison("k1", (("fuse", "fused"), ("groupby", "sorted")), reason="boom")
        got = PlanStore.poisoned_strategies(store._read_raw(store._plan_path("k1")))
        assert (("fuse", "fused"), ("groupby", "sorted")) in got
        store.mark_poison("k1", (("groupby", "sorted"), ("fuse", "fused")), reason="again")
        assert len(store._read_raw(store._plan_path("k1"))["poison"]) == 1


# ---------------------------------------------------------------------------
# plan-store chaos
# ---------------------------------------------------------------------------


class TestStoreChaos:
    def test_load_fault_degrades_to_miss(self, sales, tmp_path):
        ctx, oracle = sales
        store = PlanStore(tmp_path)
        q = sales_query(ctx)
        ctx.compile(q, cache=PlanCache(), store=store, device=CPU)
        (record,) = _record_paths(tmp_path)
        with tracing() as tr:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with inject("store.load", mode="raise", times=1, seed=CHAOS_SEED):
                    result = ctx.compile(q, cache=PlanCache(), store=store, device=CPU)
        assert_matches_oracle(run_compiled(ctx, result), oracle)
        assert tr.counters.get("plan_store.corrupt", 0) >= 1
        assert record.exists() and json.loads(record.read_text())

    def test_injected_corruption_quarantines(self, sales, tmp_path):
        ctx, _ = sales
        store = PlanStore(tmp_path)
        q = sales_query(ctx)
        ctx.compile(q, cache=PlanCache(), store=store, device=CPU)
        (record,) = _record_paths(tmp_path)
        with tracing() as tr:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with inject("store.load", mode="corrupt", times=1, seed=CHAOS_SEED):
                    ctx.compile(q, cache=PlanCache(), store=store, device=CPU)
        assert tr.counters.get("plan_store.quarantined", 0) == 1
        assert record.with_suffix(".corrupt").exists()
        assert json.loads(record.read_text())

    def test_on_disk_corruption_quarantined_once(self, sales, tmp_path):
        ctx, oracle = sales
        store = PlanStore(tmp_path)
        q = sales_query(ctx)
        ctx.compile(q, cache=PlanCache(), store=store, device=CPU)
        (record,) = _record_paths(tmp_path)
        record.write_text("{\"target\": \"local\", \"strate")  # torn write
        with tracing() as tr:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                r2 = ctx.compile(q, cache=PlanCache(), store=store, device=CPU)
            got = run_compiled(ctx, r2)
        assert_matches_oracle(got, oracle)
        assert tr.counters.get("plan_store.quarantined", 0) == 1
        with tracing() as tr2:
            ctx.compile(q, cache=PlanCache(), store=store, device=CPU)
        assert tr2.counters.get("plan_store.quarantined", 0) == 0

    def test_save_fault_is_nonfatal(self, sales, tmp_path):
        ctx, oracle = sales
        store = PlanStore(tmp_path)
        with tracing() as tr:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with inject("store.save", mode="raise", times=1, seed=CHAOS_SEED):
                    result = ctx.compile(sales_query(ctx), cache=PlanCache(), store=store,
                                         device=CPU)
        assert_matches_oracle(run_compiled(ctx, result), oracle)
        assert tr.counters.get("plan_store.save_failed", 0) >= 1
        assert not result.degraded


# ---------------------------------------------------------------------------
# resource admission
# ---------------------------------------------------------------------------


def make_big_domain_ctx() -> Context:
    rng = np.random.default_rng(CHAOS_SEED + 11)
    n = 4096
    ctx = Context(pad_to=512)
    ctx.register("events", {
        "user": rng.integers(0, 200_000, n).astype(np.int32),
        "val": rng.gamma(2.0, 10.0, n).astype(np.float32),
    })
    return ctx


def events_query(ctx):
    return ctx.table("events").group_by("user", max_groups=4096).agg(sum_("val").as_("total"))


class TestAdmission:
    BUDGET = 1_000_000

    def test_direct_estimate_dwarfs_sorted(self):
        ctx = make_big_domain_ctx()
        q = events_query(ctx)
        direct = ctx.compile(q, cache=False, strategy={"groupby": "direct"}, guard=False)
        sorted_ = ctx.compile(q, cache=False, strategy={"groupby": "sorted"}, guard=False)
        est_direct = estimate_peak_bytes(direct.program)
        est_sorted = estimate_peak_bytes(sorted_.program)
        assert est_direct.peak_site == "vec.GroupAggDirect"
        assert est_direct.peak_bytes > self.BUDGET
        assert est_sorted.peak_bytes < self.BUDGET
        assert "peak ≈" in est_direct.render()

    def test_over_budget_rejected_without_guard(self):
        ctx = make_big_domain_ctx()
        with pytest.raises(AdmissionError, match="resource admission"):
            ctx.compile(events_query(ctx), cache=False, strategy={"groupby": "direct"},
                        memory_budget=self.BUDGET, guard=False)

    def test_over_budget_degrades_to_sorted_with_guard(self):
        ctx = make_big_domain_ctx()
        oracle = ctx.execute(events_query(ctx), target="interp")
        with tracing() as tr:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                result = ctx.compile(events_query(ctx), cache=PlanCache(), device=CPU,
                                     strategy={"groupby": "direct"},
                                     memory_budget=self.BUDGET)
        assert ("groupby", "sorted") in result.strategy
        assert result.degraded
        assert result.resources is not None and result.resources.peak_bytes <= self.BUDGET
        assert tr.counters.get("robust.admission.reject", 0) >= 1
        assert _degraded(caught)
        assert_matches_oracle(run_compiled(ctx, result), oracle, key="user")

    def test_cost_search_drops_over_budget_candidates(self):
        ctx = make_big_domain_ctx()
        res = ctx.compile(events_query(ctx), cache=False, device=CPU, optimize="cost",
                          memory_budget=self.BUDGET)
        assert not res.degraded and dict(res.strategy)["groupby"] == "sorted"
        assert all(dict(c.strategy)["groupby"] == "sorted" for c in res.decision.candidates
                   if dict(c.strategy)["encode"] == "raw")

    def test_within_budget_admitted_with_provenance(self, sales):
        ctx, _ = sales
        result = ctx.compile(sales_query(ctx), cache=PlanCache(), memory_budget=1 << 30,
                             device=CPU)
        assert not result.degraded
        assert result.resources is not None
        assert result.metrics()["resources"]["peak_bytes"] == result.resources.peak_bytes


# ---------------------------------------------------------------------------
# the encode=raw rung
# ---------------------------------------------------------------------------


class TestEncodeRawRung:
    def _sparse_ctx(self):
        rng = np.random.default_rng(23)
        n, ndv = 2048, 200
        domain = rng.integers(0, 1_400_000_000, ndv).astype(np.int32)
        ctx = Context(pad_to=256)
        ctx.register("t", {"k": domain[rng.integers(0, ndv, n)],
                           "v": rng.normal(size=n).astype(np.float32)})
        return ctx

    def _query(self, ctx):
        return ctx.table("t").group_by("k", max_groups=256).agg(
            sum_("v").as_("s"), count_().as_("n"))

    def test_ladder_tries_encode_raw_first(self):
        chosen = {"groupby": "direct", "encode": "dict"}
        assert [r for r, _ in fallback_ladder(chosen)] == [
            "encode=raw", "groupby=sorted", "interp"]
        assert dict(next(fallback_ladder(chosen))[1]) == {"groupby": "direct",
                                                          "encode": "raw"}

    def test_crashed_dict_plan_degrades_through_encode_raw(self):
        ctx = self._sparse_ctx()
        q = self._query(ctx)
        oracle = ctx.execute(q, target="interp")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with inject("backend.execute", times=1, seed=CHAOS_SEED):
                result = ctx.compile(q, cache=PlanCache(), device=CPU,
                                     strategy={"groupby": "direct", "encode": "dict"})
                got = run_compiled(ctx, result)
        assert result.degraded and result.degraded[0] == "encode=raw"
        assert _degraded(caught)
        assert_matches_oracle(got, oracle, key="k")

    def test_poisoned_dict_strategy_not_replayed(self, tmp_path):
        ctx = self._sparse_ctx()
        q = self._query(ctx)
        store = PlanStore(tmp_path)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with inject("backend.execute", times=1, seed=CHAOS_SEED):
                first = ctx.compile(q, cache=PlanCache(), store=store, device=CPU,
                                    strategy={"groupby": "direct", "encode": "dict"})
                run_compiled(ctx, first)
        assert first.degraded
        poisons = [json.loads(p.read_text()).get("poison") or []
                   for p in _record_paths(tmp_path)]
        assert any(poisons)
        with tracing() as tr:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                second = ctx.compile(q, cache=PlanCache(), store=store, device=CPU,
                                     strategy={"groupby": "direct", "encode": "dict"})
                run_compiled(ctx, second)
        assert tr.counters.get("robust.fallback.poison_skip", 0) >= 1


def test_tpch_q1_recovers_from_an_execute_fault():
    """The chip smoke's fallback phase at sf = 0.002: Q1 with one injected
    execute fault gives the numpy reference's groups."""
    from repro.relational import tpch as jtpch

    tables = jtpch.generate(sf=0.002, seed=7)
    ctx = ttpch.make_context(tables)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with inject("backend.execute", times=1, seed=CHAOS_SEED):
            got = ttpch.q1(ctx).collect(device=CPU, cache=PlanCache())
    assert _degraded(caught)
    want = ttpch.REFERENCES["q1"](tables)
    og = np.lexsort((got["l_linestatus"], got["l_returnflag"]))
    ow = np.lexsort((want["l_linestatus"], want["l_returnflag"]))
    np.testing.assert_array_equal(got["count_order"][og], want["count_order"][ow])
    np.testing.assert_allclose(got["sum_qty"][og], want["sum_qty"][ow], rtol=2e-4)
