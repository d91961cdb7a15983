"""The sorted tiers, the dynamic hash join and the remaining vec operators
of the torch port, against the JAX package.

The port's ``repro_torch.relational.runtime`` runs the runtime cases of
tests/test_groupby_direct.py and tests/test_join.py on the same numpy
tables as ``repro.relational.runtime``: both hold the contracts those
files check, and each port result is held against the JAX one (integers,
keys and validity exact, floats within rtol 1e-5).  The forced-strategy
cases compile through the port's ``Context`` on the CPU and are held
against the JAX package's numpy interpreter (``target="interp"``) at the
tier suites' rtol 1e-4.  So are their cost-search (``optimize="cost"``)
and admission-budget cases, whose decision tables must also be the JAX
package's; the SPMD subprocess cases wait for ROADMAP Queue 1 item 7.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import expr as jexpr  # noqa: E402
from repro.frontends import dataflow as jdf  # noqa: E402
from repro.relational import runtime as jrt  # noqa: E402
from repro.robust.admission import estimate_peak_bytes as jax_peak_bytes  # noqa: E402
from repro_torch.compiler import PlanCache  # noqa: E402
from repro_torch.robust.admission import AdmissionError, estimate_peak_bytes  # noqa: E402
from repro_torch.convert import vectable_from_arrays  # noqa: E402
from repro_torch.core import expr as texpr  # noqa: E402
from repro_torch.frontends import dataflow as tdf  # noqa: E402
from repro_torch.relational import runtime as trt  # noqa: E402

J = SimpleNamespace(df=jdf, col=jexpr.col, AggSpec=jexpr.AggSpec, rt=jrt)
T = SimpleNamespace(df=tdf, col=texpr.col, AggSpec=texpr.AggSpec, rt=trt)
I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def both(data, cap=None, valid=None):
    """The same numpy columns as a JAX and a torch (CPU) VecTable."""
    n = len(next(iter(data.values())))
    cap = cap or n
    cols = {}
    for k, v in data.items():
        v = np.asarray(v)
        cols[k] = np.concatenate([v, np.zeros((cap - n,) + v.shape[1:], v.dtype)])
    mask = np.arange(cap) < n if valid is None else np.asarray(valid, bool)
    j = jrt.VecTable({k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(mask))
    return j, vectable_from_arrays(cols, mask, "cpu")


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def same(tt, jt):
    """A torch VecTable equal to a JAX one, invalid slots included."""
    _close(tt.valid.numpy(), np.asarray(jt.valid), "valid")
    assert set(tt.cols) == set(jt.cols)
    for k in jt.cols:
        _close(tt.cols[k].numpy(), np.asarray(jt.cols[k]), k)


def rows(t):
    """Valid rows of a VecTable of either package as numpy arrays."""
    v = np.asarray(t.valid)
    return {k: np.asarray(c)[v] for k, c in t.cols.items()}


def _sorted_rows(table, keys):
    order = np.lexsort(tuple(np.asarray(table[k]) for k in reversed(keys)))
    return {k: np.asarray(v)[order] for k, v in table.items()}


def assert_tables_equal(got, want, keys, rtol=1e-4):
    got, want = _sorted_rows(got, keys), _sorted_rows(want, keys)
    assert set(got) == set(want)
    for k in got:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if np.issubdtype(g.dtype, np.floating) or np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w.astype(g.dtype), rtol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def contexts(pad_to, **tables):
    """A JAX and a torch ``Context`` holding the same tables."""
    out = []
    for m in (J, T):
        ctx = m.df.Context(pad_to=pad_to)
        for name, data in tables.items():
            ctx.register(name, data)
        out.append(ctx)
    return out


def compiled_rows(ctx, q, **kw):
    """The port's CPU compile of ``q``: (lowered opcodes, numpy rows)."""
    res = ctx.compile(q, device="cpu", cache=PlanCache(), **kw)
    (out,) = res(ctx.sources("cpu"))
    return res.program.opcodes(), out.to_numpy()


def costed(jctx, tctx, jq, tq, **kw):
    """The port's cost search of ``tq`` on the CPU, after asserting that its
    decision table (candidates, estimated costs, winner) is the JAX
    package's for ``jq``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = tctx.compile(tq, optimize="cost", cache=PlanCache(), device="cpu", **kw)
        jres = jctx.compile(jq, optimize="cost", cache=False, **kw)
    table = [(c.strategy, c.est_cost) for c in res.decision.candidates]
    assert table == [(c.strategy, c.est_cost) for c in jres.decision.candidates]
    assert res.strategy == jres.strategy
    return res


def aggs(m):
    x = m.col("x")
    return (m.AggSpec("sum", x, "s"), m.AggSpec("count", x, "c"),
            m.AggSpec("min", x, "lo"), m.AggSpec("max", x, "hi"))


# ---------------------------------------------------------------------------
# runtime: group_agg_direct ≡ sort_by_key + group_agg_sorted, on both
# ---------------------------------------------------------------------------


class TestRuntimeDirect:
    def _table(self, keys_cols, n=500, cap=512, seed=0, valid=None):
        rng = np.random.default_rng(seed)
        data = dict(keys_cols)
        data["x"] = rng.normal(10.0, 5.0, n).astype(np.float32)
        return both(data, cap, valid)

    def _check(self, tabs, keys, domains, max_groups=64):
        j, t = tabs
        nb = int(np.prod([hi - lo + 1 for lo, hi in domains]))
        direct = trt.group_agg_direct(t, keys, aggs(T), max_groups, domains, nb)
        srt = trt.group_agg_sorted(trt.sort_by_key(t, keys), keys, aggs(T), max_groups)
        for k in list(keys) + [a.name for a in aggs(T)]:
            np.testing.assert_allclose(rows(direct)[k], rows(srt)[k], rtol=1e-5, err_msg=k)
        np.testing.assert_array_equal(direct.valid.numpy(), srt.valid.numpy())
        same(srt, jrt.group_agg_sorted(jrt.sort_by_key(j, keys), keys, aggs(J), max_groups))

    def test_int_keys(self):
        rng = np.random.default_rng(1)
        k1 = rng.integers(3, 11, 500).astype(np.int32)
        self._check(self._table({"k1": k1}), ("k1",), ((3, 10),))

    def test_multi_key_int_bool(self):
        rng = np.random.default_rng(2)
        k1 = rng.integers(0, 5, 500).astype(np.int32)
        k2 = rng.integers(0, 2, 500).astype(bool)
        self._check(self._table({"k1": k1, "k2": k2}), ("k1", "k2"), ((0, 4), (0, 1)))

    def test_large_key_values(self):
        rng = np.random.default_rng(3)
        k1 = (rng.integers(0, 4, 500) * 70_000 + 100_000).astype(np.int32)
        self._check(self._table({"k1": k1}), ("k1",), ((100_000, 310_000),))

    def test_all_invalid(self):
        j, t = self._table({"k1": np.zeros(500, np.int32)}, valid=np.zeros(512, bool))
        assert not trt.group_agg_direct(t, ("k1",), aggs(T), 8, ((0, 0),), 1).valid.any()
        srt = trt.group_agg_sorted(trt.sort_by_key(t, ("k1",)), ("k1",), aggs(T), 8)
        assert not srt.valid.any()
        same(srt, jrt.group_agg_sorted(jrt.sort_by_key(j, ("k1",)), ("k1",), aggs(J), 8))

    def test_max_groups_boundary(self):
        """Exactly max_groups groups, and more: both tiers keep the first
        max_groups groups in key order, the rest fall into the dump slot."""
        k1 = np.arange(500, dtype=np.int32) % 16
        tabs = self._table({"k1": k1})
        self._check(tabs, ("k1",), ((0, 15),), max_groups=16)
        self._check(tabs, ("k1",), ((0, 15),), max_groups=8)


# ---------------------------------------------------------------------------
# the sort chain and group_agg_sorted against JAX, keys of every kind
# ---------------------------------------------------------------------------


def _mixed(seed=4, n=600, cap=640):
    rng = np.random.default_rng(seed)
    data = {
        "i": rng.integers(-3, 3, n).astype(np.int32),
        "b": rng.random(n) < 0.4,
        "f": rng.choice(np.array([-1.5, 0.25, 2.0, 7.0], np.float32), n),
        "x": rng.normal(size=n).astype(np.float32),
    }
    data["i"][:5] = I32_MIN  # negation wraps at INT32_MIN on both sides
    return both(data, cap, np.r_[rng.random(n) < 0.8, np.zeros(cap - n, bool)])


SORTS = {
    "int_desc_at_int32_min": (("i",), (False,)),
    "bool_desc_int_asc": (("b", "i"), (False, True)),
    "bool_asc_float_desc": (("b", "f"), (True, False)),
    "float_int_bool": (("f", "i", "b"), (True, False, False)),
}


@pytest.mark.parametrize("sort", sorted(SORTS))
def test_sort_chain_matches_lexsort(sort):
    keys, asc = SORTS[sort]
    j, t = _mixed()
    same(trt.sort_by_key(t, keys, asc), jrt.sort_by_key(j, keys, asc))


@pytest.mark.parametrize("keys", [("i",), ("b",), ("f",), ("b", "i"), ("f", "b", "i")])
@pytest.mark.parametrize("max_groups", [64, 5])
def test_group_agg_sorted_matches_jax(keys, max_groups):
    """Int, bool and float keys, groups past max_groups dropped as JAX
    drops them; the empty groups' keys and aggregates match too."""
    j, t = _mixed()
    same(trt.group_agg_sorted(trt.sort_by_key(t, keys), keys, aggs(T), max_groups),
         jrt.group_agg_sorted(jrt.sort_by_key(j, keys), keys, aggs(J), max_groups))


def test_proj_keeps_validity():
    j, t = _mixed()
    same(trt.proj(t, ("x", "b")), jrt.proj(j, ("x", "b")))


# ---------------------------------------------------------------------------
# O(n) compact / limit
# ---------------------------------------------------------------------------


class TestCompact:
    def _rand_table(self, cap=257, seed=5):
        rng = np.random.default_rng(seed)
        return both({"a": rng.integers(0, 100, cap).astype(np.int32),
                     "b": rng.normal(size=cap).astype(np.float32)},
                    cap, rng.random(cap) < 0.35)

    def test_compact_matches_reference(self):
        j, t = self._rand_table()
        c = trt.compact(t)
        mask = t.valid.numpy()
        n = int(mask.sum())
        assert c.valid[:n].all() and not c.valid[n:].any()
        for k in t.cols:
            np.testing.assert_array_equal(c.cols[k][:n].numpy(), t.cols[k].numpy()[mask])
        same(c, jrt.compact(j))

    def test_compact_truncates_to_max_count(self):
        j, t = self._rand_table()
        c = trt.compact(t, max_count=16)
        assert c.capacity == 16
        mask = t.valid.numpy()
        keep = min(16, int(mask.sum()))
        assert c.valid[:keep].all()
        for k in t.cols:
            np.testing.assert_array_equal(c.cols[k][:keep].numpy(),
                                          t.cols[k].numpy()[mask][:keep])
        same(c, jrt.compact(j, max_count=16))

    def test_limit(self):
        j, t = self._rand_table(seed=6)
        out = trt.limit(t, 10)
        np.testing.assert_array_equal(rows(out)["a"], t.cols["a"].numpy()[t.valid.numpy()][:10])
        same(out, jrt.limit(j, 10))

    def test_compact_empty(self):
        j, t = self._rand_table()
        t = trt.VecTable(t.cols, torch.zeros(t.capacity, dtype=torch.bool))
        assert not trt.compact(t).valid.any()


# ---------------------------------------------------------------------------
# topk
# ---------------------------------------------------------------------------


class TestTopK:
    def _table(self, seed=9, cap=512, n=400):
        rng = np.random.default_rng(seed)
        return both({"k": rng.permutation(n * 4)[:n].astype(np.int32),
                     "f": rng.normal(size=n).astype(np.float32)}, cap)

    @pytest.mark.parametrize("ascending", [True, False])
    @pytest.mark.parametrize("key", ["k", "f"])
    def test_single_key_matches_sort(self, key, ascending):
        j, t = self._table()
        fast = trt.topk(t, (key,), (ascending,), 25)
        slow = trt.sort_by_key(t, (key,), (ascending,))
        for c in t.cols:
            np.testing.assert_array_equal(rows(fast)[c], slow.cols[c][:25].numpy())
        assert fast.valid.all()
        same(fast, jrt.topk(j, (key,), (ascending,), 25))

    def test_k_exceeds_valid_rows(self):
        j, t = self._table(n=20)
        out = trt.topk(t, ("k",), (True,), 50)
        assert int(out.valid.sum()) == 20
        same(out, jrt.topk(j, ("k",), (True,), 50))

    def test_ascending_includes_int32_min(self):
        j, t = both({"k": np.array([5, I32_MIN, 3], np.int32)}, 4)
        out = trt.topk(t, ("k",), (True,), 2)
        np.testing.assert_array_equal(rows(out)["k"], [I32_MIN, 3])
        same(out, jrt.topk(j, ("k",), (True,), 2))

    def test_multi_key_still_sorts(self):
        j, t = self._table()
        out = trt.topk(t, ("k", "f"), (True, True), 10)
        slow = trt.sort_by_key(t, ("k", "f"), (True, True))
        np.testing.assert_array_equal(rows(out)["k"], slow.cols["k"][:10].numpy())
        same(out, jrt.topk(j, ("k", "f"), (True, True), 10))

    @pytest.mark.parametrize("ascending", [True, False])
    @pytest.mark.parametrize("key", ["k", "f"])
    def test_ties_go_to_the_lowest_index(self, key, ascending):
        """Many equal keys among invalid rows: the rows kept and their order
        are JAX's (``lax.top_k`` keeps the lowest index of a tie)."""
        rng = np.random.default_rng(10)
        n = 300
        j, t = both({"k": rng.integers(0, 4, n).astype(np.int32),
                     "f": rng.integers(0, 4, n).astype(np.float32),
                     "row": np.arange(n, dtype=np.int32)}, n, rng.random(n) < 0.7)
        same(trt.topk(t, (key,), (ascending,), 40), jrt.topk(j, (key,), (ascending,), 40))

    def test_sentinel_quirk_kept(self):
        """Descending, a valid INT32_MIN scores as the sentinel and loses
        its slot to an earlier invalid row — in JAX and here alike."""
        j, t = both({"k": np.array([9, 7, I32_MIN], np.int32)}, 3,
                    np.array([False, True, True]))
        out = trt.topk(t, ("k",), (False,), 2)
        assert rows(out)["k"].tolist() == [7]
        same(out, jrt.topk(j, ("k",), (False,), 2))


# ---------------------------------------------------------------------------
# composite keys
# ---------------------------------------------------------------------------


class TestCompositeKeys:
    def test_grouped_agg_large_two_keys_match_oracle(self):
        rng = np.random.default_rng(11)
        n = 1000
        data = {"a": (rng.integers(0, 3, n) * 100_000).astype(np.int32),
                "b": (rng.integers(0, 3, n) * 90_001).astype(np.int32),
                "x": rng.normal(size=n).astype(np.float32)}
        jctx, tctx = contexts(256, t=data)

        def q(m, ctx):
            return (ctx.table("t").group_by("a", "b", max_groups=16)
                    .agg(m.df.sum_("x").as_("s"), m.df.count_().as_("c")))
        want = jctx.execute(q(J, jctx), target="interp")
        for strat in ({"groupby": "sorted"}, {"groupby": "direct"}):
            _, got = compiled_rows(tctx, q(T, tctx), strategy=strat)
            assert_tables_equal(got, want, ("a", "b"))

    @pytest.mark.parametrize("strategy,op", [
        ({"join": "sorted"}, "vec.MergeJoinSorted"),
        # the raw span is past the bucket budget: hash degrades to sorted
        ({"join": "hash"}, "vec.MergeJoinSorted"),
        ({"join": "hash", "encode": "dict"}, "vec.HashJoinDirect"),
    ])
    def test_multikey_join_large_values_match_oracle(self, strategy, op):
        rng = np.random.default_rng(12)
        n = 600
        right = np.stack(np.meshgrid(np.arange(20) * 70_000, np.arange(10)),
                         -1).reshape(-1, 2)
        jctx, tctx = contexts(
            256,
            probe={"a": (rng.integers(0, 20, n) * 70_000).astype(np.int32),
                   "b": rng.integers(0, 10, n).astype(np.int32),
                   "x": rng.normal(size=n).astype(np.float32)},
            build={"a2": right[:, 0].astype(np.int32), "b2": right[:, 1].astype(np.int32),
                   "y": np.arange(len(right)).astype(np.float32)})

        def q(ctx):
            return ctx.table("probe").join(ctx.table("build"), left_on=("a", "b"),
                                           right_on=("a2", "b2"))
        want = jctx.execute(q(jctx), target="interp")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ops, got = compiled_rows(tctx, q(tctx), strategy=strategy)
        assert op in ops
        assert_tables_equal(got, want, ("a", "b", "x"))

    def test_static_domain_overflow_raises(self):
        _, t = both({"a": np.zeros(8, np.int32), "b": np.zeros(8, np.int32)})
        with pytest.raises(ValueError, match="cannot be packed"):
            trt.merge_join_sorted(t, t, ("a", "b"), ("a", "b"), 8,
                                  key_domains=((0, 1 << 20), (0, 1 << 20)))

    def test_unpackable_without_bounds_raises(self):
        _, t = both({"a": np.zeros(8, np.int32)})
        with pytest.raises(ValueError, match="domain bounds"):
            trt._composite_key(t, ("a", "a"))

    def test_packings_match_jax(self):
        """Static (clipped), dynamic (wrapping i32) and single-column
        packings, an f32 key bit-cast, give JAX's values."""
        rng = np.random.default_rng(13)
        j, t = both({"a": rng.integers(-40, 40, 300).astype(np.int32),
                     "b": rng.integers(0, 1 << 30, 300).astype(np.int32),
                     "f": rng.normal(size=300).astype(np.float32)}, 320)
        _close(trt._composite_key(t, ("a", "b"), key_domains=((-10, 10), (0, 999))).numpy(),
               jrt._composite_key(j, ("a", "b"), key_domains=((-10, 10), (0, 999))), "static")
        lows, sizes = trt._joint_key_bounds(t, t, ("a", "b"), ("a", "b"))
        jl, js = jrt._joint_key_bounds(j, j, ("a", "b"), ("a", "b"))
        for g, w in zip(lows + sizes, jl + js):
            _close(g.numpy(), np.asarray(w), "bounds")
        _close(trt._composite_key(t, ("a", "b"), lows=lows, sizes=sizes).numpy(),
               jrt._composite_key(j, ("a", "b"), lows=jl, sizes=js), "dynamic")
        _close(trt._composite_key(t, ("f",)).numpy(), jrt._composite_key(j, ("f",)), "single")


# ---------------------------------------------------------------------------
# runtime: hash_join_direct ≡ sort_by_key + merge_join_sorted, on both
# ---------------------------------------------------------------------------


class TestRuntimeHashJoin:
    def _tables(self, lk_cols, rk_cols, n=400, m=64, lcap=512, rcap=64, seed=0,
                lvalid=None, rvalid=None):
        rng = np.random.default_rng(seed)
        ldata = dict(lk_cols)
        ldata["x"] = rng.normal(size=n).astype(np.float32)
        rdata = dict(rk_cols)
        rdata["y"] = rng.normal(size=m).astype(np.float32)
        return both(ldata, lcap, lvalid), both(rdata, rcap, rvalid)

    def _check(self, lefts, rights, left_on, right_on, domains):
        (jl, tl), (jr, tr) = lefts, rights
        cap = tl.capacity
        mkd = domains if len(left_on) > 1 else None
        hashed = trt.hash_join_direct(tl, tr, left_on, right_on, cap, key_domains=domains)
        srt = trt.merge_join_sorted(tl, trt.sort_by_key(tr, right_on), left_on, right_on,
                                    cap, key_domains=mkd)
        h, s = rows(hashed), rows(srt)
        assert set(h) == set(s)
        for k in h:
            np.testing.assert_allclose(h[k], s[k], rtol=1e-6, err_msg=k)
        same(srt, jrt.merge_join_sorted(jl, jrt.sort_by_key(jr, right_on), left_on,
                                        right_on, cap, key_domains=mkd))
        same(hashed, jrt.hash_join_direct(jl, jr, left_on, right_on, cap, key_domains=domains))
        return h

    def test_int_keys_duplicate_probe(self):
        rng = np.random.default_rng(1)
        lk = rng.integers(0, 64, 400).astype(np.int32)
        h = self._check(*self._tables({"k": lk}, {"k2": np.arange(64, dtype=np.int32)}),
                        ("k",), ("k2",), ((0, 63),))
        assert len(h["x"]) == 400

    def test_composite_keys(self):
        rng = np.random.default_rng(2)
        lk1 = rng.integers(0, 8, 400).astype(np.int32)
        lk2 = (rng.integers(0, 4, 400) * 70_000).astype(np.int32)
        grid = np.stack(np.meshgrid(np.arange(8), np.arange(4) * 70_000), -1).reshape(-1, 2)
        tabs = self._tables({"a": lk1, "b": lk2},
                            {"a2": grid[:, 0].astype(np.int32),
                             "b2": grid[:, 1].astype(np.int32)}, m=32, rcap=32)
        self._check(*tabs, ("a", "b"), ("a2", "b2"), ((0, 7), (0, 210_000)))

    def test_partial_match_and_out_of_domain(self):
        lk = np.array([0, 1, 5, 200, -3, 7] * 50, np.int32)
        tabs = self._tables({"k": lk}, {"k2": np.arange(8, dtype=np.int32)},
                            n=300, m=8, rcap=8)
        h = self._check(*tabs, ("k",), ("k2",), ((0, 7),))
        assert len(h["x"]) == 4 * 50
        assert set(h["k"].tolist()) == {0, 1, 5, 7}

    def test_duplicate_build_keys_first_occurrence(self):
        tabs = self._tables({"k": np.array([3, 3, 1], np.int32)},
                            {"k2": np.array([1, 3, 3, 1], np.int32)},
                            n=3, m=4, lcap=4, rcap=4)
        h = self._check(*tabs, ("k",), ("k2",), ((0, 3),))
        ry = tabs[1][1].cols["y"].numpy()
        np.testing.assert_allclose(h["y"], [ry[1], ry[1], ry[0]])

    def test_empty_and_all_invalid(self):
        tabs = self._tables({"k": np.zeros(16, np.int32)},
                            {"k2": np.arange(4, dtype=np.int32)},
                            n=16, m=4, lcap=16, rcap=4, lvalid=np.zeros(16, bool))
        assert len(self._check(*tabs, ("k",), ("k2",), ((0, 3),))["x"]) == 0
        tabs = self._tables({"k": np.zeros(16, np.int32)},
                            {"k2": np.arange(4, dtype=np.int32)},
                            n=16, m=4, lcap=16, rcap=4, rvalid=np.zeros(4, bool))
        assert len(self._check(*tabs, ("k",), ("k2",), ((0, 3),))["x"]) == 0

    def test_dynamic_bounds_both_branches(self):
        """When the measured key span fits ``num_buckets`` the direct
        branch runs, otherwise the sorted fallback — both equal the static
        answer, and JAX's ``lax.cond`` of the same inputs."""
        rng = np.random.default_rng(3)
        lk = rng.integers(0, 32, 200).astype(np.int32)
        (jl, tl), (jr, tr) = self._tables({"k": lk}, {"k2": np.arange(32, dtype=np.int32)},
                                          n=200, m=32, lcap=256, rcap=32)
        want = rows(trt.hash_join_direct(tl, tr, ("k",), ("k2",), 256,
                                         key_domains=((0, 31),)))
        for nb in (64, 8):  # fits / does not fit
            got = trt.hash_join_direct(tl, tr, ("k",), ("k2",), 256, num_buckets=nb)
            for k in want:
                np.testing.assert_allclose(rows(got)[k], want[k], rtol=1e-6, err_msg=k)
            same(got, jrt.hash_join_direct(jl, jr, ("k",), ("k2",), 256, num_buckets=nb))

    def test_dynamic_bounds_composite_keys(self):
        """Two key columns packed by bounds traced from both sides, on the
        direct branch and on the sorted one (whose packing wraps in i32)."""
        rng = np.random.default_rng(4)
        grid = np.stack(np.meshgrid(np.arange(6), np.arange(5) * 1000), -1).reshape(-1, 2)
        lefts, rights = self._tables(
            {"a": rng.integers(-1, 7, 300).astype(np.int32),
             "b": (rng.integers(0, 5, 300) * 1000).astype(np.int32)},
            {"a2": grid[:, 0].astype(np.int32), "b2": grid[:, 1].astype(np.int32)},
            n=300, m=30, lcap=320, rcap=32)
        (jl, tl), (jr, tr) = lefts, rights
        for nb in (1 << 16, 64):
            same(trt.hash_join_direct(tl, tr, ("a", "b"), ("a2", "b2"), 200, num_buckets=nb),
                 jrt.hash_join_direct(jl, jr, ("a", "b"), ("a2", "b2"), 200, num_buckets=nb))

    def test_requires_domains_or_buckets(self):
        (_, tl), (_, tr) = self._tables({"k": np.zeros(8, np.int32)},
                                        {"k2": np.zeros(4, np.int32)},
                                        n=8, m=4, lcap=8, rcap=4)
        with pytest.raises(ValueError, match="needs a static num_buckets"):
            trt.hash_join_direct(tl, tr, ("k",), ("k2",), 8)


def test_merge_join_casts_a_float_key():
    """A single f32 join key is cast to i32 (truncated), not bit-cast, and
    the cast saturates as XLA's does: 3e9 and +inf give INT32_MAX (the
    invalid build rows' sentinel, so they meet the invalid row here, as in
    JAX), -3e9 INT32_MIN, NaN 0."""
    (jl, tl) = both({"k": np.array([1.7, 2.2, 3.9, -0.5, 3e9, -3e9, np.nan, np.inf],
                                   np.float32)}, 8)
    (jr, tr) = both({"k2": np.array([0.0, 1.0, 2.0, 3.0, -2.0 ** 31, 5.0], np.float32),
                     "y": np.arange(6, dtype=np.float32)}, 7)
    got = trt.merge_join_sorted(tl, trt.sort_by_key(tr, ("k2",)), ("k",), ("k2",), 8)
    assert rows(got)["y"].tolist() == [1.0, 2.0, 3.0, 0.0, 0.0, 4.0, 0.0, 0.0]
    same(got, jrt.merge_join_sorted(jl, jrt.sort_by_key(jr, ("k2",)), ("k",), ("k2",), 8))


# ---------------------------------------------------------------------------
# forced strategies through the port's compile
# ---------------------------------------------------------------------------


def _sales():
    rng = np.random.default_rng(7)
    n = 4096
    return {"region": rng.integers(0, 12, n).astype(np.int32),
            "flag": rng.integers(0, 2, n).astype(bool),
            "amount": rng.gamma(2.0, 50.0, n).astype(np.float32),
            "year": rng.integers(2018, 2026, n).astype(np.int32)}


@pytest.fixture(scope="module")
def sales():
    return contexts(512, sales=_sales())


def grouped_query(m, ctx, *keys, max_groups=64):
    return (ctx.table("sales").group_by(*(keys or ("region",)), max_groups=max_groups)
            .agg(m.df.sum_("amount").as_("rev"), m.df.count_().as_("n"),
                 m.df.min_("amount").as_("lo"), m.df.max_("amount").as_("hi")))


class TestGroupByStrategy:
    @pytest.mark.parametrize("use_kernels", [False, True])
    def test_forced_direct_and_sorted_match_oracle(self, sales, use_kernels):
        jctx, tctx = sales
        want = jctx.execute(grouped_query(J, jctx, "region", "flag"), target="interp")
        progs = {}
        for label in ("sorted", "direct"):
            progs[label], got = compiled_rows(
                tctx, grouped_query(T, tctx, "region", "flag"),
                strategy={"groupby": label}, use_kernels=use_kernels)
            assert_tables_equal(got, want, ("region", "flag"))
        assert "vec.GroupAggSorted" in progs["sorted"]
        assert "vec.GroupAggDirect" not in progs["sorted"]
        assert "vec.GroupAggDirect" in progs["direct"]
        assert "vec.SortByKey" not in progs["direct"]

    def test_forced_direct_float_key_falls_back_to_sorted(self, sales):
        """The Motivation's third probe: a group-by on an f32 key lowers to
        the sorted tier and answers as JAX's interpreter does."""
        jctx, tctx = sales

        def q(m, ctx):
            return (ctx.table("sales").group_by("amount", max_groups=4096)
                    .agg(m.df.count_().as_("n")))
        with pytest.warns(UserWarning, match="direct_unavailable"):
            ops, got = compiled_rows(tctx, q(T, tctx), strategy={"groupby": "direct"})
        assert "vec.GroupAggSorted" in ops and "vec.GroupAggDirect" not in ops
        assert_tables_equal(got, jctx.execute(q(J, jctx), target="interp"), ("amount",))

    def test_cost_low_ndv_selects_direct(self, sales):
        jctx, tctx = sales
        res = costed(jctx, tctx, grouped_query(J, jctx, "region", "flag"),
                     grouped_query(T, tctx, "region", "flag"))
        assert dict(res.strategy)["groupby"] == "direct"
        assert "vec.GroupAggDirect" in res.program.opcodes()
        labels = [c.label() for c in res.decision.candidates]
        assert any("groupby=sorted" in label for label in labels)
        (out,) = res(tctx.sources("cpu"))
        want = jctx.execute(grouped_query(J, jctx, "region", "flag"), target="interp")
        assert_tables_equal(out.to_numpy(), want, ("region", "flag"))

    def test_cost_huge_domain_selects_sorted(self):
        """A key spread over a 2^17 domain: the dense bucket table would
        dwarf one pass over the rows, so the sorted tier must win."""
        rng = np.random.default_rng(13)
        n = 4096
        jctx, tctx = contexts(512, sales={
            "k": rng.integers(0, 1 << 17, n).astype(np.int32),
            "amount": rng.gamma(2.0, 50.0, n).astype(np.float32)})

        def q(m, ctx):
            return (ctx.table("sales").group_by("k", max_groups=4096)
                    .agg(m.df.sum_("amount").as_("rev")))
        res = costed(jctx, tctx, q(J, jctx), q(T, tctx))
        assert dict(res.strategy)["groupby"] == "sorted"
        assert "vec.GroupAggSorted" in res.program.opcodes()
        (out,) = res(tctx.sources("cpu"))
        assert_tables_equal(out.to_numpy(), jctx.execute(q(J, jctx), target="interp"), ("k",))

    def test_direct_strategy_is_cache_keyed(self, sales):
        _, tctx = sales
        cache = PlanCache()
        q = grouped_query(T, tctx)
        r1 = tctx.compile(q, strategy={"groupby": "direct"}, cache=cache)
        r2 = tctx.compile(q, strategy={"groupby": "sorted"}, cache=cache)
        r3 = tctx.compile(q, strategy={"groupby": "direct"}, cache=cache)
        assert not r1.cache_hit and not r2.cache_hit and r3.cache_hit

    def test_empty_selection_matches_oracle(self, sales):
        jctx, tctx = sales

        def q(m, ctx):
            return (ctx.table("sales").filter(m.col("year") >= 3000)
                    .group_by("region", max_groups=64).agg(m.df.count_().as_("n")))
        assert len(np.asarray(jctx.execute(q(J, jctx), target="interp")["n"]).ravel()) == 0
        for label in ("sorted", "direct"):
            got = q(T, tctx).collect(device="cpu", strategy={"groupby": label})
            assert len(got["n"]) == 0

    def test_redefined_key_column_invalidates_domain(self, sales):
        jctx, tctx = sales

        def q(m, ctx):
            return (ctx.table("sales").with_columns(region=m.col("region") * 10)
                    .group_by("region", max_groups=256).agg(m.df.count_().as_("n")))
        with pytest.warns(UserWarning, match="direct_unavailable"):
            ops, got = compiled_rows(tctx, q(T, tctx), strategy={"groupby": "direct"})
        assert "vec.GroupAggDirect" not in ops
        assert_tables_equal(got, jctx.execute(q(J, jctx), target="interp"), ("region",))

    @pytest.mark.parametrize("use_kernels", [False, True])
    def test_fused_predicate_in_direct_plan(self, sales, use_kernels):
        jctx, tctx = sales

        def q(m, ctx):
            return (ctx.table("sales").filter(m.col("year") >= 2020)
                    .group_by("region", max_groups=64)
                    .agg(m.df.sum_("amount").as_("rev"), m.df.count_().as_("n")))
        ops, got = compiled_rows(tctx, q(T, tctx), strategy={"groupby": "direct"},
                                 use_kernels=use_kernels)
        assert "vec.GroupAggDirect" in ops and "vec.MaskSelect" not in ops
        assert_tables_equal(got, jctx.execute(q(J, jctx), target="interp"), ("region",))


class TestFrontendProbes:
    """The Motivation's first two probes, through ``Frame.collect``, against
    the JAX package's default ``collect()``."""

    def test_select(self, sales):
        jctx, tctx = sales
        got = tctx.table("sales").select("region", "amount").collect(device="cpu")
        want = jctx.table("sales").select("region", "amount").collect()
        assert set(got) == {"region", "amount"}
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))

    @pytest.mark.parametrize("asc", [True, False])
    def test_order_by_limit(self, sales, asc):
        jctx, tctx = sales
        got = tctx.table("sales").order_by("amount", ascending=(asc,)).limit(5) \
            .collect(device="cpu")
        want = jctx.table("sales").order_by("amount", ascending=(asc,)).limit(5).collect()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# ---------------------------------------------------------------------------
# join strategies and the fused join-group-aggregate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def joins():
    rng = np.random.default_rng(7)
    n, m = 4096, 256
    return contexts(
        512,
        orders={"custkey": rng.integers(0, m, n).astype(np.int32),
                "price": rng.gamma(2.0, 100.0, n).astype(np.float32),
                "year": rng.integers(2018, 2026, n).astype(np.int32)},
        customer={"ckey": np.arange(m).astype(np.int32),
                  "nation": rng.integers(0, 8, m).astype(np.int32)})


def join_query(ctx):
    return ctx.table("orders").join(ctx.table("customer"), left_on=("custkey",),
                                    right_on=("ckey",))


def q3_query(m, ctx):
    """The TPC-H Q3/Q12 shape: select → join → group-aggregate."""
    return (ctx.table("orders").filter(m.col("year") >= 2020)
            .join(ctx.table("customer"), left_on=("custkey",), right_on=("ckey",))
            .group_by("nation", max_groups=16)
            .agg(m.df.sum_("price").as_("rev"), m.df.count_().as_("n")))


class TestJoinStrategy:
    def test_forced_hash_and_sorted_match_oracle(self, joins):
        jctx, tctx = joins
        want = jctx.execute(join_query(jctx), target="interp")
        progs = {}
        for label in ("sorted", "hash"):
            progs[label], got = compiled_rows(tctx, join_query(tctx), strategy={"join": label})
            assert_tables_equal(got, want, ("custkey", "price"))
        assert "vec.MergeJoinSorted" in progs["sorted"]
        assert "vec.HashJoinDirect" not in progs["sorted"]
        assert "vec.HashJoinDirect" in progs["hash"]
        assert "vec.SortByKey" not in progs["hash"]
        assert "vec.MergeJoinSorted" not in progs["hash"]

    def test_forced_raw_over_budget_degrades_to_sorted(self):
        """Join keys over a ~2^21 raw span: with encode=raw the hash tier
        warns and degrades to the sorted merge join, which still answers."""
        rng = np.random.default_rng(13)
        n, m = 4096, 2048
        jctx, tctx = contexts(
            512,
            probe={"k": (rng.integers(0, m, n) * 1024).astype(np.int32),
                   "x": rng.normal(size=n).astype(np.float32)},
            build={"bk": (np.arange(m) * 1024).astype(np.int32),
                   "y": rng.normal(size=m).astype(np.float32)})

        def q(ctx):
            return ctx.table("probe").join(ctx.table("build"), left_on=("k",),
                                           right_on=("bk",))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ops, got = compiled_rows(tctx, q(tctx), strategy={"join": "hash", "encode": "raw"})
        assert "vec.HashJoinDirect" not in ops and "vec.MergeJoinSorted" in ops
        assert any("hash_unavailable" in str(w.message) for w in caught)
        assert_tables_equal(got, jctx.execute(q(jctx), target="interp"), ("k", "x"))

    def test_cost_huge_domain_selects_sorted(self):
        """tests/test_join.py's costed half: the same ~2^21 raw span with
        2048 distinct keys; dictionary ranks fit the cap, so the costed
        search keeps the O(n) hash tier under ``encode=dict``."""
        jctx, tctx = _sparse_join_ctxs()
        res = costed(jctx, tctx, _probe_build(jctx), _probe_build(tctx))
        chosen = dict(res.strategy)
        assert chosen["join"] == "hash" and chosen["encode"] == "dict"
        assert "vec.HashJoinDirect" in res.program.opcodes()
        (out,) = res(tctx.sources("cpu"))
        assert_tables_equal(out.to_numpy(), jctx.execute(_probe_build(jctx), target="interp"),
                            ("k", "x"))

    def test_cost_low_ndv_selects_hash(self, joins):
        jctx, tctx = joins
        res = costed(jctx, tctx, join_query(jctx), join_query(tctx))
        assert dict(res.strategy)["join"] == "hash"
        assert "vec.HashJoinDirect" in res.program.opcodes()
        labels = [c.label() for c in res.decision.candidates]
        assert any("join=sorted" in label for label in labels)

    def test_unbounded_keys_take_the_dynamic_join(self, joins):
        """The Motivation's fourth probe: a join whose keys have no catalog
        bounds (a computed key) emits the dynamic HashJoinDirect, which
        answers as JAX's interpreter does."""
        jctx, tctx = joins

        def q(m, ctx):
            return (ctx.table("orders").with_columns(custkey=m.col("custkey") + 0)
                    .join(ctx.table("customer"), left_on=("custkey",), right_on=("ckey",)))
        res = tctx.compile(q(T, tctx), device="cpu", cache=False)
        hj = [i for i in res.program.body if i.opcode == "vec.HashJoinDirect"]
        assert hj and hj[0].param("key_domains") is None and hj[0].param("num_buckets")
        (out,) = res(tctx.sources("cpu"))
        assert_tables_equal(out.to_numpy(), jctx.execute(q(J, jctx), target="interp"),
                            ("custkey", "price"))

    def test_pkfk_unverified_warns(self):
        _, tctx = contexts(64, l={"k": (np.arange(32) % 4).astype(np.int32),
                                  "x": np.ones(32, np.float32)},
                           r={"k2": np.array([0, 1, 2, 3, 0, 1], np.int32),
                              "y": np.arange(6).astype(np.float32)})
        q = tctx.table("l").join(tctx.table("r"), left_on=("k",), right_on=("k2",))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tctx.compile(q, strategy={"join": "hash"}, cache=PlanCache())
        assert any("join_pkfk_unverified" in str(w.message) for w in caught)

    def test_join_strategy_is_cache_keyed(self, joins):
        _, tctx = joins
        cache = PlanCache()
        q = join_query(tctx)
        r1 = tctx.compile(q, strategy={"join": "hash"}, cache=cache)
        r2 = tctx.compile(q, strategy={"join": "sorted"}, cache=cache)
        r3 = tctx.compile(q, strategy={"join": "hash"}, cache=cache)
        assert not r1.cache_hit and not r2.cache_hit and r3.cache_hit

    def test_empty_selection_matches_oracle(self, joins):
        jctx, tctx = joins

        def q(m, ctx):
            return (ctx.table("orders").filter(m.col("year") >= 3000)
                    .join(ctx.table("customer"), left_on=("custkey",), right_on=("ckey",)))
        assert len(np.asarray(jctx.execute(q(J, jctx), target="interp")["price"]).ravel()) == 0
        for label in ("sorted", "hash"):
            assert len(q(T, tctx).collect(device="cpu", strategy={"join": label})["price"]) == 0


def _sparse_join_ctxs(seed=13, m=2048):
    rng = np.random.default_rng(seed)
    n = 4096
    return contexts(
        512,
        probe={"k": (rng.integers(0, m, n) * 1024).astype(np.int32),
               "x": rng.normal(size=n).astype(np.float32)},
        build={"bk": (np.arange(m) * 1024).astype(np.int32),
               "y": rng.normal(size=m).astype(np.float32)})


def _probe_build(ctx):
    return ctx.table("probe").join(ctx.table("build"), left_on=("k",), right_on=("bk",))


class TestJoinAdmission:
    """tests/test_join.py's ``TestJoinAdmission``: join keys over a ~2^19
    domain are admissible for lowering, but the ~2 MB direct table busts a
    1 MB budget."""

    BUDGET = 1_000_000

    def test_direct_table_priced(self, joins):
        jctx, tctx = joins
        res = tctx.compile(join_query(tctx), strategy={"join": "hash"}, cache=False,
                           guard=False)
        est = estimate_peak_bytes(res.program)
        assert est.peak_site == "vec.HashJoinDirect"
        assert dict(est.breakdown)["vec.HashJoinDirect"] > 256 * 4
        jres = jctx.compile(join_query(jctx), strategy={"join": "hash"}, cache=False,
                            guard=False)
        assert est.peak_bytes == jax_peak_bytes(jres.program).peak_bytes

    def test_over_budget_rejected_without_guard(self):
        _, tctx = _sparse_join_ctxs(seed=17, m=512)
        with pytest.raises(AdmissionError, match="resource admission"):
            tctx.compile(_probe_build(tctx), strategy={"join": "hash"}, cache=False,
                         memory_budget=self.BUDGET, guard=False)

    def test_over_budget_degrades_to_sorted_with_guard(self):
        jctx, tctx = _sparse_join_ctxs(seed=17, m=512)
        want = jctx.execute(_probe_build(jctx), target="interp")
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            res = tctx.compile(_probe_build(tctx), strategy={"join": "hash"},
                               cache=PlanCache(), memory_budget=self.BUDGET, device="cpu")
        assert ("join", "sorted") in res.strategy
        assert res.degraded
        assert "vec.MergeJoinSorted" in res.program.opcodes()
        (out,) = res(tctx.sources("cpu"))
        assert_tables_equal(out.to_numpy(), want, ("k", "x"))


class TestFusedJoinGroupAgg:
    def test_fused_equals_unfused_and_oracle(self, joins):
        jctx, tctx = joins
        want = jctx.execute(q3_query(J, jctx), target="interp")
        strat = {"join": "hash", "groupby": "direct"}
        ops, got = compiled_rows(tctx, q3_query(T, tctx), strategy=strat, use_kernels=False)
        assert "vec.FusedJoinGroupAgg" in ops
        assert not {"vec.HashJoinDirect", "vec.GroupAggDirect", "vec.MaskSelect"} & set(ops)
        assert_tables_equal(got, want, ("nation",))
        ops, got = compiled_rows(tctx, q3_query(T, tctx), strategy={**strat, "fuse": "unfused"})
        assert "vec.HashJoinDirect" in ops and "vec.FusedJoinGroupAgg" not in ops
        assert_tables_equal(got, want, ("nation",))

    def test_fused_kernel_matches_oracle(self, joins):
        jctx, tctx = joins
        ops, got = compiled_rows(tctx, q3_query(T, tctx),
                                 strategy={"join": "hash", "groupby": "direct"},
                                 use_kernels=True)
        assert "vec.FusedJoinGroupAgg" in ops
        assert_tables_equal(got, jctx.execute(q3_query(J, jctx), target="interp"), ("nation",))

    def test_fused_runtime_op_matches_composition(self):
        rng = np.random.default_rng(5)
        n, m = 512, 16
        jl, tl = both({"k": rng.integers(0, m, n).astype(np.int32),
                       "x": rng.normal(size=n).astype(np.float32)})
        jr, tr = both({"k2": np.arange(m).astype(np.int32),
                       "g": rng.integers(0, 4, m).astype(np.int32),
                       "w": rng.normal(size=m).astype(np.float32)})
        pred = texpr.col("x") > 0.0
        tags = (T.AggSpec("sum", T.col("x"), "sx"), T.AggSpec("count", T.col("x"), "c"),
                T.AggSpec("min", T.col("w"), "mw"))
        fused = trt.fused_join_group_agg(
            tl, tr, ("k",), ("k2",), join_key_domains=((0, m - 1),), join_num_buckets=m,
            keys=("g",), aggs=tags, max_groups=8, key_domains=((0, 3),), num_buckets=4,
            pred=pred)
        joined = trt.hash_join_direct(trt.mask_select(tl, pred), tr, ("k",), ("k2",), n,
                                      key_domains=((0, m - 1),))
        ref = trt.group_agg_direct(joined, ("g",), tags, 8, ((0, 3),), 4)
        f, r = rows(fused), rows(ref)
        for k in f:
            np.testing.assert_allclose(f[k], r[k], rtol=1e-5, err_msg=k)
