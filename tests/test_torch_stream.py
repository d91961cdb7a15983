"""The stream target on the torch port, held against the JAX package.

The cases of tests/test_stream.py, by name, on the port's
``target="stream"`` (``device="cpu"``: the kernels' plain versions):

* **lowering** — ``lower_stream`` splits the lowered program into static /
  batch / merge / finalize segments with the JAX package's named errors,
  and under an explicit strategy the four segments hold the JAX split's
  opcodes;
* **incremental equivalence** — folding micro-batches and finalizing
  gives the port's interp oracle and the JAX stream target's answer;
* **exactly-once chaos** — ``StreamConsumer``/``stream_loop`` killed at
  the three ``stream.*`` points still give that answer
  (``REPRO_CHAOS_SEED`` picks the firing pattern);
* the serve-loop ride-alongs: backpressure, watermark shedding, queue
  wait; and auto re-plan on the local target.

Then TPC-H at sf=0.01 in 1,024-row batches (Q1, Q6, Q12, Q14, Q19, the
per-order revenue state, Q4's error) against the JAX stream target, and
the port's own rule: a fault of the card raised inside a fold re-raises
from ``stream_loop`` with no restore.

Tolerance: integers exact, floats rtol 1e-4 (tests/test_stream.py's).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compiler import PlanCache as JPlanCache  # noqa: E402
from repro.core import expr as jexpr  # noqa: E402
from repro.frontends import dataflow as jdf  # noqa: E402
from repro.relational import tpch as jtpch  # noqa: E402
from repro_torch.compiler import PlanCache, compile as tcompile  # noqa: E402
from repro_torch.compiler.driver import (  # noqa: E402
    disable_auto_replan, enable_auto_replan)
from repro_torch.core.expr import col  # noqa: E402
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.errors import KernelLaunchError  # noqa: E402
from repro_torch.frontends.dataflow import (  # noqa: E402
    Context, avg_, count_, max_, sum_, _to_numpy)
from repro_torch.launch.serve import (  # noqa: E402
    AdmissionQueue, MicroBatch, Request, StreamConsumer, microbatches, stream_loop)
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.obs.feedback import FEEDBACK  # noqa: E402
from repro_torch.relational import tpch as ttpch  # noqa: E402
from repro_torch.robust.inject import (  # noqa: E402
    InjectedFault, inject, registered_points)

CHAOS_SEED = int(os.environ.get("REPRO_CHAOS_SEED", "0"))
CPU = "cpu"
RTOL = 1e-4


# ---------------------------------------------------------------------------
# data, queries and comparisons (the same query functions run in both packages)
# ---------------------------------------------------------------------------


def _sales_data():
    rng = np.random.default_rng(7)
    n = 2048
    return {"region": rng.integers(0, 6, n).astype(np.int32),
            "amount": rng.gamma(2.0, 50.0, n).astype(np.float32),
            "year": rng.integers(2018, 2026, n).astype(np.int32)}


def make_sales_ctx(m=None) -> Context:
    ctx = (m or Context)(pad_to=256)
    ctx.register("sales", _sales_data())
    return ctx


def _with_regions(ctx):
    ctx.register("regions", {
        "rid": np.arange(6, dtype=np.int32),
        "weight": np.linspace(1.0, 2.0, 6).astype(np.float32),
    })
    return ctx


class _Fns:
    """A package's expression and aggregate constructors."""

    def __init__(self, col, sum_, count_, max_, avg_):
        self.col, self.sum_, self.count_, self.max_, self.avg_ = col, sum_, count_, max_, avg_


PORT = _Fns(col, sum_, count_, max_, avg_)
JAX = _Fns(jexpr.col, jdf.sum_, jdf.count_, jdf.max_, jdf.avg_)


def fns(ctx) -> _Fns:
    """The constructors of the package ``ctx`` belongs to."""
    return JAX if isinstance(ctx, jdf.Context) else PORT


def sales_query(ctx):
    f = fns(ctx)
    return (ctx.table("sales")
            .filter(f.col("year") >= 2020)
            .group_by("region", max_groups=8)
            .agg(f.sum_("amount").as_("rev"), f.count_().as_("n")))


def scalar_query(ctx):
    f = fns(ctx)
    return (ctx.table("sales").filter(f.col("year") >= 2020)
            .agg(f.sum_("amount").as_("total"), f.count_().as_("n"),
                 f.max_("amount").as_("hi"), f.avg_("amount").as_("mean")))


def join_query(ctx):
    f = fns(ctx)
    return (ctx.table("sales")
            .join(ctx.table("regions"), left_on="region", right_on="rid")
            .group_by("region", max_groups=8)
            .agg(f.sum_("amount").as_("rev"), f.count_().as_("n")))


def _city_data():
    rng = np.random.default_rng(11)
    n = 1024
    cities = np.array([f"city-{i:02d}" for i in range(12)])
    return {"city": cities[rng.integers(0, 12, n)],
            "amount": rng.gamma(2.0, 50.0, n).astype(np.float32)}


def city_query(ctx):
    return (ctx.table("sales").group_by("city", max_groups=16)
            .agg(fns(ctx).sum_("amount").as_("rev"))
            .order_by("city").limit(5))


def compile_stream(ctx, q, batch_rows: int = 256, **kw):
    kw.setdefault("device", CPU)
    return ctx.compile(q, target="stream", stream_table="sales",
                       batch_rows=batch_rows, cache=PlanCache(), **kw)


def jax_stream(make_query, make_jctx=None, batch_rows: int = 256, **kw):
    """The JAX package's stream-target answer for the same query and data."""
    jctx = (make_jctx or (lambda: make_sales_ctx(jdf.Context)))()
    q = make_query(jctx)
    return jctx.execute(q, target="stream", stream_table="sales",
                        batch_rows=batch_rows, **kw)


def _assert_col(g, w, what):
    g, w = np.asarray(g).ravel(), np.asarray(w).ravel()
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype.kind in ("U", "S", "O"):
        assert list(g) == list(w), what
    elif w.dtype.kind in "iub" and g.dtype.kind in "iub":
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=what)
    else:
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=RTOL,
                                   err_msg=what)


def assert_matches(got: dict, want: dict, key=None) -> None:
    """Same columns; rows matched by ``key`` (or position): integers
    exactly, floats to rtol 1e-4."""
    assert set(got) == set(want)
    keys = (key,) if isinstance(key, str) else tuple(key or ())
    if keys:
        og = np.lexsort([np.asarray(got[k]).ravel() for k in reversed(keys)])
        ow = np.lexsort([np.asarray(want[k]).ravel() for k in reversed(keys)])
    for k in want:
        g, w = np.asarray(got[k]).ravel(), np.asarray(want[k]).ravel()
        if keys:
            g, w = g[og], w[ow]
        _assert_col(g, w, k)


def sales_batches(ctx, batch_rows: int = 256, **kw):
    return microbatches(ctx.tables["sales"], batch_rows, **kw)


@pytest.fixture(scope="module")
def jax_sales():
    """The JAX stream target's answer to the sales query (the batch face)."""
    return jax_stream(sales_query)


@pytest.fixture()
def sales(jax_sales):
    ctx = make_sales_ctx()
    oracle = ctx.execute(sales_query(ctx), target="interp")
    return ctx, oracle


def assert_matches_oracle(got, oracle, jax_answer, key="region"):
    """The port's answer against its interp oracle and the JAX stream
    target's answer."""
    assert_matches(got, oracle, key)
    assert_matches(got, jax_answer, key)


def split_opcodes(plan):
    return {seg: (None if p is None else [i.opcode for i in p.body])
            for seg, p in (("static", plan.static_program), ("batch", plan.batch_program),
                           ("merge", plan.merge_program),
                           ("finalize", plan.finalize_program))}


# ---------------------------------------------------------------------------
# the stream lowering split
# ---------------------------------------------------------------------------


class TestLowerStream:
    def test_grouped_split_shape(self, sales):
        ctx, _ = sales
        res = compile_stream(ctx, sales_query(ctx))
        plan = res.executable.plan
        assert plan.stream_table == "sales"
        assert plan.state_kind == "grouped"
        # the batch segment ends at the terminal aggregation...
        assert plan.batch_program.body[-1].opcode.startswith("vec.GroupAgg")
        # ...and the merge segment is the one state-combine instruction
        assert [i.opcode for i in plan.merge_program.body] == \
            ["vec.MergeGroupedState"]
        assert "stream plan" in plan.render()

    def test_scalar_split_shape(self, sales):
        ctx, _ = sales
        q = (ctx.table("sales").filter(col("year") >= 2020)
             .agg(sum_("amount").as_("total"), count_().as_("n")))
        plan = compile_stream(ctx, q).executable.plan
        assert plan.state_kind == "scalar"
        assert [i.opcode for i in plan.merge_program.body] == \
            ["vec.MergeScalarState"]

    def test_join_build_side_is_static(self):
        """The dimension-table build side runs once; only the stream probe
        side is folded per micro-batch."""
        ctx = _with_regions(make_sales_ctx())
        q = (ctx.table("sales")
             .join(ctx.table("regions"), left_on="region", right_on="rid")
             .group_by("region", max_groups=8)
             .agg(sum_("amount").as_("rev")))
        plan = compile_stream(ctx, q).executable.plan
        assert plan.static_program is not None
        assert plan.batch_boundary  # build table flows in as batch args
        ops = {i.opcode for i in plan.static_program.body}
        assert "vec.ScanVec" in ops

    def test_finalize_carries_the_suffix(self, sales):
        """avg desugars to sum/count + an ExProj division — the division
        must run at finalize time, not per micro-batch."""
        ctx, _ = sales
        q = (ctx.table("sales").group_by("region", max_groups=8)
             .agg(avg_("amount").as_("mean")))
        plan = compile_stream(ctx, q).executable.plan
        assert plan.finalize_program is not None
        assert plan.batch_program.body[-1].opcode.startswith("vec.GroupAgg")
        assert len(plan.finalize_program.body) >= 1

    def test_no_aggregation_is_an_error(self, sales):
        ctx, _ = sales
        q = ctx.table("sales").filter(col("year") >= 2020)
        with pytest.raises(ValueError, match="no aggregation over stream"):
            compile_stream(ctx, q, guard=False)
        jctx = make_sales_ctx(jdf.Context)
        with pytest.raises(ValueError, match="no aggregation over stream"):
            jctx.compile(jctx.table("sales").filter(jexpr.col("year") >= 2020), target="stream",
                         stream_table="sales", guard=False, cache=JPlanCache())

    def test_unknown_stream_table_is_an_error(self, sales):
        ctx, _ = sales
        with pytest.raises(ValueError, match="not scanned"):
            ctx.compile(sales_query(ctx), target="stream", device=CPU,
                        stream_table="clicks", guard=False,
                        cache=PlanCache())

    def test_driver_validates_stream_kwargs(self, sales):
        ctx, _ = sales
        q = sales_query(ctx)
        with pytest.raises(ValueError, match="pass stream_table"):
            ctx.compile(q, target="stream", device=CPU, cache=PlanCache())
        with pytest.raises(ValueError, match="batch_rows must be positive"):
            ctx.compile(q, target="stream", stream_table="sales", device=CPU,
                        batch_rows=-4, cache=PlanCache())
        with pytest.raises(ValueError, match="only apply to streaming"):
            ctx.compile(q, target="local", stream_table="sales", device=CPU,
                        cache=PlanCache())

    def test_batch_rows_is_part_of_the_cache_key(self, sales):
        ctx, _ = sales
        cache = PlanCache()
        q = sales_query(ctx)
        a = ctx.compile(q, target="stream", stream_table="sales", device=CPU,
                        batch_rows=128, cache=cache)
        b = ctx.compile(q, target="stream", stream_table="sales", device=CPU,
                        batch_rows=512, cache=cache)
        assert a.executable.batch_rows == 128
        assert b.executable.batch_rows == 512
        assert not b.cache_hit

    @pytest.mark.parametrize("strategy", [{"groupby": "sorted", "join": "sorted"},
                                          {"groupby": "direct", "join": "hash"}],
                             ids=["sorted", "direct"])
    @pytest.mark.parametrize("query", ["grouped", "scalar", "join", "strings"])
    def test_split_opcodes_match_jax(self, strategy, query):
        """Under one explicit strategy the port's four segments hold the
        JAX split's opcodes, and the same boundary and state kind."""
        cases = {"grouped": (make_sales_ctx, sales_query),
                    "scalar": (make_sales_ctx, scalar_query),
                    "join": (lambda m=None: _with_regions(make_sales_ctx(m)), join_query),
                    "strings": (lambda m=None: _city_ctx(m), city_query)}
        make, build = cases[query]
        ctx, jctx = make(), make(jdf.Context)
        got = compile_stream(ctx, build(ctx), strategy=strategy).executable.plan
        want = jctx.compile(build(jctx), target="stream", stream_table="sales",
                            batch_rows=256, strategy=strategy,
                            cache=JPlanCache()).executable.plan
        assert split_opcodes(got) == split_opcodes(want)
        assert got.state_kind == want.state_kind
        assert got.agg.opcode == want.agg.opcode
        assert len(got.batch_boundary) == len(want.batch_boundary)
        assert len(got.finalize_boundary) == len(want.finalize_boundary)


def _city_ctx(m=None):
    ctx = (m or Context)(pad_to=128)
    ctx.register("sales", _city_data())
    return ctx


# ---------------------------------------------------------------------------
# incremental == batch oracle (the exactly-once reference)
# ---------------------------------------------------------------------------


class TestIncrementalEquivalence:
    def test_batch_face_matches_interp_oracle(self, sales, jax_sales):
        ctx, oracle = sales
        res = compile_stream(ctx, sales_query(ctx))
        (out,) = res(ctx.sources(CPU))
        assert_matches_oracle(_to_numpy(out), oracle, jax_sales)

    @pytest.mark.parametrize("strategy", [{"groupby": "sorted"},
                                          {"groupby": "direct"}])
    def test_both_groupby_tiers_stream(self, sales, jax_sales, strategy):
        ctx, oracle = sales
        res = compile_stream(ctx, sales_query(ctx), strategy=strategy)
        (out,) = res(ctx.sources(CPU))
        assert_matches_oracle(_to_numpy(out), oracle, jax_sales)
        assert_matches(_to_numpy(out), jax_stream(sales_query, strategy=strategy), "region")

    def test_incremental_face_matches_oracle(self, sales, jax_sales):
        ctx, oracle = sales
        res = compile_stream(ctx, sales_query(ctx))
        ex = res.executable.bind(ctx.sources(CPU))
        state = ex.init_state()
        for mb in sales_batches(ctx):
            state = ex.step(state, mb.rows)
        (out,) = ex.finalize(state)
        assert_matches_oracle(_to_numpy(out), oracle, jax_sales)

    def test_ragged_and_empty_batches(self, sales, jax_sales):
        """A short final batch and interleaved empty batches are padded to
        capacity and fold as no-ops on the invalid rows."""
        ctx, oracle = sales
        ex = compile_stream(ctx, sales_query(ctx)).executable
        ex.bind(ctx.sources(CPU))
        state = ex.init_state()
        empty = {k: v[:0] for k, v in ctx.tables["sales"].items()}
        for mb in microbatches(ctx.tables["sales"], 100):  # 2048 % 100 != 0
            state = ex.step(state, mb.rows)
            state = ex.step(state, empty)
        (out,) = ex.finalize(state)
        assert_matches_oracle(_to_numpy(out), oracle, jax_sales)
        # int32 counts stay int32 across every merge
        assert out.cols["n"].dtype == torch.int32

    def test_scalar_and_avg_aggregates(self, sales):
        ctx, _ = sales
        q = scalar_query(ctx)
        oracle = ctx.execute(q, target="interp")
        got = ctx.execute(q, target="stream", stream_table="sales",
                          batch_rows=256, device=CPU)
        assert_matches(got, oracle)
        assert_matches(got, jax_stream(scalar_query))

    def test_join_against_static_build_side(self):
        ctx = _with_regions(make_sales_ctx())
        q = join_query(ctx)
        oracle = ctx.execute(q, target="interp")
        got = ctx.execute(q, target="stream", stream_table="sales",
                          batch_rows=256, device=CPU)
        assert_matches(got, oracle, key="region")
        want = jax_stream(join_query, lambda: _with_regions(make_sales_ctx(jdf.Context)))
        assert_matches(got, want, key="region")

    def test_string_keys_with_order_and_limit(self):
        """Dict-encoded string keys stream; the decode + order/limit suffix
        runs at finalize time over the merged state."""
        ctx = _city_ctx()
        q = city_query(ctx)
        oracle = ctx.execute(q, target="interp")
        got = ctx.execute(q, target="stream", stream_table="sales",
                          batch_rows=128, device=CPU)
        assert_matches(got, oracle)  # already ordered — compare positionally
        assert_matches(got, jax_stream(city_query, lambda: _city_ctx(jdf.Context),
                                       batch_rows=128))

    def test_costed_search_streams(self, sales, jax_sales):
        ctx, oracle = sales
        res = compile_stream(ctx, sales_query(ctx), optimize="cost")
        assert res.decision is not None and len(res.decision.candidates) > 1
        (out,) = res(ctx.sources(CPU))
        assert_matches_oracle(_to_numpy(out), oracle, jax_sales)


# ---------------------------------------------------------------------------
# the consumer protocol: sequencing, snapshots, dedup
# ---------------------------------------------------------------------------


class TestStreamConsumer:
    def test_fold_snapshot_restore_round_trip(self, sales, jax_sales, tmp_path):
        ctx, oracle = sales
        res = compile_stream(ctx, sales_query(ctx))
        ckpt = CheckpointManager(tmp_path, n_shards=1, keep=3)
        c = StreamConsumer(res, ctx.sources(CPU), checkpoint=ckpt,
                           snapshot_every=2)
        for mb in sales_batches(ctx):
            c.process(mb)
        c.snapshot()
        assert c.stats.batches == 8
        assert c.stats.snapshots >= 4
        assert c.snapshot_seq == c.committed_seq == 7
        assert_matches_oracle(_to_numpy(c.results()[0]), oracle, jax_sales)

    def test_redelivery_is_deduped(self, sales, jax_sales, tmp_path):
        ctx, oracle = sales
        res = compile_stream(ctx, sales_query(ctx))
        c = StreamConsumer(res, ctx.sources(CPU),
                           checkpoint=CheckpointManager(tmp_path))
        batches = sales_batches(ctx)
        for mb in batches:
            assert c.process(mb) is True
        for mb in batches:  # the upstream log replays everything
            assert c.process(mb) is False
        assert c.stats.deduped == len(batches)
        assert c.stats.batches == len(batches)  # folded once each
        assert_matches_oracle(_to_numpy(c.results()[0]), oracle, jax_sales)

    def test_process_death_new_consumer_restores_and_dedups(
            self, sales, jax_sales, tmp_path):
        """The crashed-consumer story: a new process restores the last
        snapshot and the upstream redelivers *everything*; dedup-by-seq
        keeps the fold exactly-once."""
        ctx, oracle = sales
        res = compile_stream(ctx, sales_query(ctx))
        ckpt = CheckpointManager(tmp_path, n_shards=1, keep=3)
        batches = sales_batches(ctx)

        first = StreamConsumer(res, ctx.sources(CPU), checkpoint=ckpt,
                               snapshot_every=2)
        for mb in batches[:5]:     # dies after folding 5 (snapshot at seq 3)
            first.process(mb)
        assert first.snapshot_seq == 3

        second = StreamConsumer(res, ctx.sources(CPU), checkpoint=ckpt,
                                snapshot_every=2)
        restored = second.restore()
        assert restored == 3
        for mb in batches:         # full redelivery from seq 0
            second.process(mb)
        assert second.stats.deduped == restored + 1
        assert second.stats.batches == len(batches) - restored - 1
        assert_matches_oracle(_to_numpy(second.results()[0]), oracle, jax_sales)

    def test_restore_without_snapshots_resets_to_initial(self, sales, jax_sales,
                                                         tmp_path):
        ctx, oracle = sales
        res = compile_stream(ctx, sales_query(ctx))
        c = StreamConsumer(res, ctx.sources(CPU),
                           checkpoint=CheckpointManager(tmp_path),
                           snapshot_every=10_000)
        batches = sales_batches(ctx)
        for mb in batches[:3]:
            c.process(mb)
        assert c.restore() == -1   # nothing durable: back to the identity
        for mb in batches:
            c.process(mb)
        assert_matches_oracle(_to_numpy(c.results()[0]), oracle, jax_sales)

    def test_non_stream_executable_is_rejected(self, sales):
        ctx, _ = sales
        res = ctx.compile(sales_query(ctx), target="local", device=CPU,
                          cache=PlanCache())
        with pytest.raises(TypeError, match="stream-target executable"):
            StreamConsumer(res, ctx.sources(CPU))


# ---------------------------------------------------------------------------
# chaos: kill the consumer at every stream.* transition
# ---------------------------------------------------------------------------


class TestExactlyOnceChaos:
    def run_loop(self, ctx, tmp_path, **kw):
        res = compile_stream(ctx, sales_query(ctx))
        ckpt = CheckpointManager(tmp_path, n_shards=1, keep=3)
        c = StreamConsumer(res, ctx.sources(CPU), checkpoint=ckpt,
                           snapshot_every=kw.pop("snapshot_every", 2))
        out = stream_loop(sales_batches(ctx), c, **kw)
        return c, _to_numpy(out[0])

    def test_stream_points_are_registered(self):
        points = registered_points()
        for name in ["stream.batch", "stream.snapshot", "stream.restore"]:
            assert name in points, sorted(points)
        from repro.robust.inject import registered_points as jax_points
        assert {k: (p.modes, p.description) for k, p in points.items()
                if k.startswith("stream.")} == \
            {k: (p.modes, p.description) for k, p in jax_points().items()
             if k.startswith("stream.")}

    def test_kill_mid_batch_recovers_exactly_once(self, sales, jax_sales, tmp_path):
        ctx, oracle = sales
        with inject("stream.batch", rate=1.0, times=1, seed=CHAOS_SEED):
            c, got = self.run_loop(ctx, tmp_path)
        assert c.stats.restores >= 1
        assert c.stats.replayed >= 1
        assert_matches_oracle(got, oracle, jax_sales)

    def test_kill_mid_snapshot_recovers_exactly_once(self, sales, jax_sales, tmp_path):
        ctx, oracle = sales
        with inject("stream.snapshot", rate=1.0, times=1, seed=CHAOS_SEED):
            c, got = self.run_loop(ctx, tmp_path)
        assert c.stats.failures >= 1
        assert_matches_oracle(got, oracle, jax_sales)
        # the final barrier still made everything durable
        assert c.snapshot_seq == c.committed_seq

    def test_failed_restore_retries_then_recovers(self, sales, jax_sales, tmp_path):
        ctx, oracle = sales
        with inject("stream.batch", rate=1.0, times=1, seed=CHAOS_SEED):
            with inject("stream.restore", rate=1.0, times=1,
                        seed=CHAOS_SEED):
                c, got = self.run_loop(ctx, tmp_path, max_recoveries=4)
        assert c.stats.failures >= 2   # the fold kill + the restore kill
        assert_matches_oracle(got, oracle, jax_sales)

    def test_seeded_random_kills_never_double_count(self, sales, jax_sales, tmp_path):
        """Whatever firing pattern the seed produces, the recovered output
        is element-identical to the batch oracle — the exactly-once
        property itself."""
        ctx, oracle = sales
        with inject("stream.batch", rate=0.3, times=3, seed=CHAOS_SEED):
            c, got = self.run_loop(ctx, tmp_path, max_recoveries=10)
        assert_matches_oracle(got, oracle, jax_sales)
        # rows counts folds (replays re-fold rolled-back state) — the
        # oracle equality above is what proves no *committed* double count
        assert c.stats.rows >= 2048

    def test_recovery_budget_exhaustion_reraises(self, sales, tmp_path):
        ctx, _ = sales
        with inject("stream.batch", rate=1.0, times=None, seed=CHAOS_SEED):
            with pytest.raises(InjectedFault):
                self.run_loop(ctx, tmp_path, max_recoveries=2)

    @pytest.mark.parametrize("fault", [
        lambda: KernelLaunchError("grouped_select_agg: refused (raised on purpose)"),
        lambda: torch.OutOfMemoryError("CUDA out of memory (raised on purpose)"),
    ], ids=["kernel_launch", "out_of_memory"])
    def test_card_fault_reraises_with_no_restore(self, sales, tmp_path, fault):
        """The port's rule: a fault of the card inside a fold re-raises
        from ``stream_loop`` at once (JAX semantics would restore up to
        ``max_recoveries`` times)."""
        ctx, _ = sales
        res = compile_stream(ctx, sales_query(ctx))
        c = StreamConsumer(res, ctx.sources(CPU),
                           checkpoint=CheckpointManager(tmp_path, n_shards=1),
                           snapshot_every=2)
        real, calls = c.exec.step, []

        def step(state, batch):
            calls.append(1)
            if len(calls) == 4:  # mid-stream, after a snapshot
                raise fault()
            return real(state, batch)

        c.exec.step = step
        with tracing() as tr, pytest.raises(type(fault())):
            stream_loop(sales_batches(ctx), c, max_recoveries=3)
        assert c.stats.restores == 0
        assert c.stats.failures == 1
        assert tr.counters["stream.card_fault"] == 1
        assert c.committed_seq == 2 and c.snapshot_seq == 1


# ---------------------------------------------------------------------------
# the serve loop: backpressure, watermarks, queue-wait latency
# ---------------------------------------------------------------------------


class TestStreamLoop:
    def test_backpressure_pauses_and_bounds_lag(self, sales, jax_sales, tmp_path):
        ctx, oracle = sales
        res = compile_stream(ctx, sales_query(ctx))
        c = StreamConsumer(res, ctx.sources(CPU),
                           checkpoint=CheckpointManager(tmp_path),
                           snapshot_every=10_000)  # only backpressure snaps
        out = stream_loop(sales_batches(ctx), c, inflight_cap=2)
        assert c.stats.paused >= 1
        assert c.stats.snapshots >= 3   # the pauses drained the window
        assert_matches_oracle(_to_numpy(out[0]), oracle, jax_sales)

    def test_watermark_shedding_drops_late_batches(self, sales, jax_sales, tmp_path):
        """A batch whose event-time watermark lags the consumer's high
        watermark by more than ``max_lag_s`` is shed, not folded."""
        ctx, oracle = sales
        res = compile_stream(ctx, sales_query(ctx))
        batches = sales_batches(ctx, watermark_col="year")
        late = MicroBatch(seq=len(batches),
                          rows=batches[0].rows, watermark=1900.0)
        c = StreamConsumer(res, ctx.sources(CPU),
                           checkpoint=CheckpointManager(tmp_path))
        out = stream_loop(batches + [late], c, max_lag_s=5.0)
        assert c.stats.shed_watermark == 1
        assert c.stats.batches == len(batches)
        # shedding the duplicate late batch keeps the oracle answer
        assert_matches_oracle(_to_numpy(out[0]), oracle, jax_sales)

    def test_queue_wait_is_observed(self, sales, tmp_path):
        ctx, _ = sales
        res = compile_stream(ctx, sales_query(ctx))
        c = StreamConsumer(res, ctx.sources(CPU),
                           checkpoint=CheckpointManager(tmp_path))
        with tracing() as tr:
            stream_loop(sales_batches(ctx), c)
        assert len(tr.histograms["stream.queue_wait_s"]) == 8
        assert tr.counters["stream.batches"] == 8

    def test_offer_stamps_queue_entry_time(self):
        q = AdmissionQueue(4)
        assert q.offer(Request(rid=0, prompt=None))
        (r,) = q.take(1)
        assert r.offered_at is not None


# ---------------------------------------------------------------------------
# auto-replan: a threshold miss recompiles under observed statistics
# ---------------------------------------------------------------------------


class TestAutoReplan:
    def test_threshold_miss_swaps_the_cached_plan(self, sales):
        """Compile against a catalog whose row counts are wrong by ~100×;
        the traced run misses the threshold, and the replan hook recompiles
        under ``FEEDBACK.observed_statistics`` — the swapped plan's next
        run estimates the scan correctly."""
        ctx, _ = sales
        program = sales_query(ctx).program()
        cat = ctx.catalog()
        cat.stats = cat.stats.with_observed_rows({"sales": 16})
        cache = PlanCache()
        FEEDBACK.clear()
        enable_auto_replan(threshold=1.0)
        try:
            with tracing() as tr:
                res = tcompile(program, cat, target="local", cache=cache, device=CPU)
                res(ctx.sources(CPU))
            assert tr.counters.get("driver.replan") == 1
            assert res._replan is None          # one-shot
            with tracing():
                res(ctx.sources(CPU))
            scan = next(o for o in res.profile.observations
                        if o.opcode == "vec.ScanVec")
            assert abs(scan.rel_miss) < 0.05    # estimates now observed
        finally:
            disable_auto_replan()
            FEEDBACK.clear()

    def test_no_replan_when_disabled(self, sales):
        ctx, _ = sales
        program = sales_query(ctx).program()
        cat = ctx.catalog()
        cat.stats = cat.stats.with_observed_rows({"sales": 16})
        FEEDBACK.clear()
        with tracing() as tr:
            res = tcompile(program, cat, target="local", cache=PlanCache(), device=CPU)
            res(ctx.sources(CPU))
        assert "driver.replan" not in tr.counters
        assert res._replan is not None          # armed but never fired
        FEEDBACK.clear()


# ---------------------------------------------------------------------------
# TPC-H streamed in 1,024-row batches, against the JAX stream target
# ---------------------------------------------------------------------------

TPCH_SF, TPCH_BATCH = 0.01, 1024
TPCH_KEYS = {"q1": ("l_returnflag", "l_linestatus"), "q12": ("l_shipmode",),
             "revenue": ("l_orderkey",)}


def order_revenue(ctx, n_orders: int):
    """Revenue per order: a continuous per-key aggregate whose state holds
    one group per order."""
    f = fns(ctx)
    return (ctx.table("lineitem").group_by("l_orderkey", max_groups=n_orders)
            .agg(f.sum_(f.col("l_extendedprice") * (1.0 - f.col("l_discount"))).as_("rev"),
                 f.count_().as_("n"), f.max_("l_shipdate").as_("last")))


def ref_order_revenue(t) -> dict:
    """numpy's answer in f64: the orders that have lines, in key order."""
    li = t["lineitem"]
    k = li["l_orderkey"].astype(np.int64)
    rev = np.bincount(k, li["l_extendedprice"].astype(np.float64)
                      * (1.0 - li["l_discount"].astype(np.float64)))
    n = np.bincount(k)
    last = np.full(len(n), -np.inf)
    np.maximum.at(last, k, li["l_shipdate"].astype(np.float64))
    has = np.nonzero(n)[0]
    return {"l_orderkey": has.astype(np.int32), "rev": rev[has], "n": n[has],
            "last": last[has]}


@pytest.fixture(scope="module")
def tpch_tables():
    return ttpch.generate(sf=TPCH_SF, seed=0)


@pytest.fixture(scope="module")
def tpch_ctxs(tpch_tables):
    return jtpch.make_context(tpch_tables), ttpch.make_context(tpch_tables)


def _tpch_stream(ctx, frame, **kw):
    return ctx.execute(frame, target="stream", stream_table="lineitem",
                       batch_rows=TPCH_BATCH, **kw)


class TestTpchStream:
    @pytest.mark.parametrize("q", ["q1", "q6", "q12", "q14", "q19"])
    def test_query_matches_jax_stream(self, tpch_tables, tpch_ctxs, q):
        jctx, ctx = tpch_ctxs
        got = _tpch_stream(ctx, ttpch.QUERIES[q](ctx), device=CPU, cache=PlanCache())
        want = _tpch_stream(jctx, jtpch.QUERIES[q](jctx))
        keys = TPCH_KEYS.get(q)
        assert_matches(got, want, keys)
        assert_matches(got, {k: np.asarray(v) for k, v in
                             ttpch.REFERENCES[q](tpch_tables).items()}, keys)

    def test_q4_is_not_streamable(self, tpch_ctxs):
        """Q4's inner semi-join count is a second aggregation over the
        stream: both packages raise lower_stream's named error."""
        jctx, ctx = tpch_ctxs
        with pytest.raises(ValueError, match="2 aggregations over the stream"):
            ctx.compile(ttpch.q4(ctx), target="stream", stream_table="lineitem",
                        batch_rows=TPCH_BATCH, device=CPU, guard=False, cache=PlanCache())
        with pytest.raises(ValueError, match="2 aggregations over the stream"):
            jctx.compile(jtpch.q4(jctx), target="stream", stream_table="lineitem",
                         batch_rows=TPCH_BATCH, guard=False, cache=JPlanCache())

    def test_order_revenue_state(self, tpch_tables, tpch_ctxs, tmp_path):
        """The per-order state (a GroupAggDirect accumulator with one group
        per order) through StreamConsumer with snapshots, against numpy and
        the JAX stream target."""
        jctx, ctx = tpch_ctxs
        n_orders = len(tpch_tables["orders"]["o_orderkey"])
        res = ctx.compile(order_revenue(ctx, n_orders), target="stream",
                          stream_table="lineitem", batch_rows=TPCH_BATCH, device=CPU,
                          cache=PlanCache())
        assert res.executable.plan.agg.opcode == "vec.GroupAggDirect"
        c = StreamConsumer(res, ctx.sources(CPU),
                           checkpoint=CheckpointManager(tmp_path, n_shards=1, keep=2),
                           snapshot_every=2)
        out = stream_loop(microbatches(ctx.tables["lineitem"], TPCH_BATCH), c)
        got = _to_numpy(out[0])
        assert c.state.capacity == n_orders and c.stats.snapshots >= 3
        assert_matches(got, ref_order_revenue(tpch_tables), "l_orderkey")
        want = _tpch_stream(jctx, order_revenue(jctx, n_orders))
        assert_matches(got, want, "l_orderkey")
