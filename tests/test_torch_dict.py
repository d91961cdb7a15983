"""Dictionary encoding (``encode=dict``) in the torch port, against the
JAX package.

The forced-strategy cases of tests/test_dict_encoding.py run through the
port's ``Context`` on the CPU, built from the same numpy tables as a JAX
``Context``, and are held against the JAX package's numpy interpreter
(``target="interp"``) at that file's rtol 1e-4; the lowered programs and
the warnings that name why encoding did not apply are checked as there.
``dict_encode`` and ``dict_decode`` are held against the JAX runtime's,
and a plan moves its dictionary tables to the device once.  The costed
search's cases pick the JAX package's strategy from the same decision
table; the SPMD subprocess cases of that file wait for ROADMAP Queue 1
item 7.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.frontends import dataflow as jdf  # noqa: E402
from repro.relational import runtime as jrt  # noqa: E402
from repro_torch.compiler import PlanCache, compile as tcompile  # noqa: E402
from repro_torch.convert import vectable_from_arrays  # noqa: E402
from repro_torch.core.expr import col  # noqa: E402
from repro_torch.core.passes.lower_vec import Catalog  # noqa: E402
from repro_torch.frontends import dataflow as tdf  # noqa: E402
from repro_torch.relational import runtime as trt  # noqa: E402

CITIES = ["athens", "berlin", "cairo", "dakar", "edinburgh", "florence",
          "geneva", "havana"]
DICT_DIRECT = {"groupby": "direct", "encode": "dict"}


def both(pad_to, **tables):
    """A JAX and a torch ``Context`` holding the same tables."""
    out = []
    for m in (jdf, tdf):
        ctx = m.Context(pad_to=pad_to)
        for name, data in tables.items():
            ctx.register(name, data)
        out.append(ctx)
    return out


def make_city_ctxs(n=2048, pad_to=256, seed=11):
    rng = np.random.default_rng(seed)
    return both(pad_to, sales={
        "city": np.array(CITIES, dtype=object)[rng.integers(0, len(CITIES), n)],
        "amount": rng.gamma(2.0, 50.0, n).astype(np.float32)})


def city_query(m, ctx, max_groups=16):
    return (ctx.table("sales").group_by("city", max_groups=max_groups)
            .agg(m.sum_("amount").as_("rev"), m.count_().as_("n")).order_by("city"))


def make_sparse_ctxs(n=4096, ndv=300, pad_to=512, seed=23):
    rng = np.random.default_rng(seed)
    domain = rng.integers(0, 1_500_000_000, ndv).astype(np.int32)
    return both(pad_to, t={"k": domain[rng.integers(0, ndv, n)],
                           "v": rng.normal(size=n).astype(np.float32)})


def sparse_query(m, ctx, max_groups=512):
    return (ctx.table("t").group_by("k", max_groups=max_groups)
            .agg(m.sum_("v").as_("s"), m.count_().as_("n")).order_by("k"))


def make_join_ctxs(n_probe=2048, n_build=64, pad_to=256, seed=5):
    rng = np.random.default_rng(seed)
    build_skus = np.array([f"sku-{i:04d}" for i in range(n_build)], dtype=object)
    extra = np.array([f"xsku-{i:04d}" for i in range(16)], dtype=object)
    pool = np.concatenate([build_skus, extra])
    return both(pad_to,
                orders={"sku": pool[rng.integers(0, len(pool), n_probe)],
                        "qty": rng.integers(1, 10, n_probe).astype(np.int32)},
                parts={"psku": build_skus,
                       "price": rng.gamma(2.0, 10.0, n_build).astype(np.float32)})


def sku_query(m, ctx):
    return (ctx.table("orders")
            .join(ctx.table("parts"), left_on=("sku",), right_on=("psku",))
            .group_by("sku", max_groups=128)
            .agg(m.sum_("qty").as_("q"), m.count_().as_("n")).order_by("sku"))


def assert_frames_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]).ravel(), np.asarray(want[k]).ravel()
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if g.dtype.kind in ("U", "S", "O"):
            np.testing.assert_array_equal(g.astype(str), w.astype(str))
        elif g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-4)
        else:
            np.testing.assert_array_equal(g, w)


def compiled(ctx, q, **kw):
    return ctx.compile(q, device="cpu", cache=PlanCache(), **kw)


def costed(jctx, tctx, jq, tq):
    """The port's cost search, its decision table held to the JAX package's."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = compiled(tctx, tq, optimize="cost")
        jres = jctx.compile(jq, optimize="cost", cache=False)
    assert [(c.strategy, c.est_cost) for c in res.decision.candidates] == \
        [(c.strategy, c.est_cost) for c in jres.decision.candidates]
    assert res.strategy == jres.strategy
    return res


# ---------------------------------------------------------------------------
# string group-by keys
# ---------------------------------------------------------------------------


class TestStringGroupBy:
    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_forced_dict_direct_matches_interp(self, use_kernels):
        jctx, tctx = make_city_ctxs()
        want = jctx.execute(city_query(jdf, jctx), target="interp")
        got = city_query(tdf, tctx).collect(device="cpu", strategy=DICT_DIRECT,
                                            use_kernels=use_kernels)
        assert np.asarray(got["city"]).dtype.kind in ("U", "S", "O")
        assert_frames_equal(got, want)

    def test_cost_search_picks_dict_direct_on_low_card_strings(self):
        jctx, tctx = make_city_ctxs()
        res = costed(jctx, tctx, city_query(jdf, jctx), city_query(tdf, tctx))
        chosen = dict(res.strategy)
        assert chosen["encode"] == "dict" and chosen["groupby"] == "direct"
        assert "vec.GroupAggDirect" in res.program.opcodes()
        want = jctx.execute(city_query(jdf, jctx), target="interp")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = city_query(tdf, tctx).collect(device="cpu", optimize="cost")
        assert_frames_equal(got, want)

    def test_string_predicate_remapped_to_code_space(self):
        jctx, tctx = make_city_ctxs()
        preds = (lambda c: c("city").eq("cairo"), lambda c: c("city") >= "dakar",
                 lambda c: c("city") < "cairo", lambda c: c("city").eq("zagreb"))
        from repro.core.expr import col as jcol
        for pred in preds:
            def q(m, ctx, c):
                return (ctx.table("sales").filter(pred(c)).group_by("city", max_groups=16)
                        .agg(m.count_().as_("n")).order_by("city"))
            want = jctx.execute(q(jdf, jctx, jcol), target="interp")
            got = q(tdf, tctx, col).collect(device="cpu", strategy=DICT_DIRECT)
            assert_frames_equal(got, want)


# ---------------------------------------------------------------------------
# sparse integer keys: the DictEncode sandwich
# ---------------------------------------------------------------------------


class TestSparseIntKeys:
    def test_dict_encode_sandwich_emitted(self):
        jctx, tctx = make_sparse_ctxs()
        res = compiled(tctx, sparse_query(tdf, tctx), strategy=DICT_DIRECT)
        body = [i.opcode for i in res.program.body]
        assert {"vec.DictEncode", "vec.GroupAggDirect", "vec.DictDecode"} <= set(body)
        assert body.index("vec.DictDecode") > body.index("vec.GroupAggDirect")
        (out,) = res(tctx.sources("cpu"))
        assert_frames_equal(out.to_numpy(), jctx.execute(sparse_query(jdf, jctx),
                                                         target="interp"))

    def test_cost_search_picks_dict_on_sparse_keys(self):
        jctx, tctx = make_sparse_ctxs()
        res = costed(jctx, tctx, sparse_query(jdf, jctx), sparse_query(tdf, tctx))
        assert dict(res.strategy)["encode"] == "dict"
        assert "vec.GroupAggDirect" in res.program.opcodes()
        (out,) = res(tctx.sources("cpu"))
        assert_frames_equal(out.to_numpy(), jctx.execute(sparse_query(jdf, jctx),
                                                         target="interp"))

    def test_forced_raw_warns_and_degrades_to_sorted(self):
        jctx, tctx = make_sparse_ctxs()
        strat = {"groupby": "direct", "encode": "raw"}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = compiled(tctx, sparse_query(tdf, tctx), strategy=strat)
        ops = res.program.opcodes()
        assert "vec.GroupAggDirect" not in ops and "vec.GroupAggSorted" in ops
        msgs = [str(w.message) for w in caught if "direct_unavailable" in str(w.message)]
        assert any("strategy forced encode=raw" in m for m in msgs), msgs
        (out,) = res(tctx.sources("cpu"))
        assert_frames_equal(out.to_numpy(), jctx.execute(sparse_query(jdf, jctx),
                                                         target="interp"))

    def test_tables_move_to_the_device_once_per_plan(self):
        """The encode and decode tables are numpy params of the plan: its
        first call moves them to the device, later calls reuse them."""
        _, tctx = make_sparse_ctxs()
        res = compiled(tctx, sparse_query(tdf, tctx), strategy=DICT_DIRECT)
        first = res(tctx.sources("cpu"))[0].to_numpy()
        held = dict(res.executable.consts)
        assert len(held) == 2  # one encode table, one decode table
        second = res(tctx.sources("cpu"))[0].to_numpy()
        assert res.executable.consts.keys() == held.keys()
        assert all(res.executable.consts[k][1] is held[k][1] for k in held)
        assert_frames_equal(second, first)


# ---------------------------------------------------------------------------
# string joins
# ---------------------------------------------------------------------------


class TestStringJoin:
    @pytest.mark.parametrize("strategy", [
        {"join": "hash", "encode": "dict"},
        {"join": "sorted", "encode": "dict"},
        {"join": "hash", "groupby": "direct", "encode": "dict"},
        None,  # the costed search
    ])
    def test_join_with_out_of_dictionary_probes(self, strategy):
        jctx, tctx = make_join_ctxs()
        want = jctx.execute(sku_query(jdf, jctx), target="interp")
        if strategy is None:
            costed(jctx, tctx, sku_query(jdf, jctx), sku_query(tdf, tctx))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = sku_query(tdf, tctx).collect(device="cpu", strategy=strategy,
                                               optimize=None if strategy else "cost")
        assert not any(str(s).startswith("xsku") for s in got["sku"])
        assert_frames_equal(got, want)

    def test_empty_join_result(self):
        rng = np.random.default_rng(2)
        jctx, tctx = both(64, l={"k": np.array(["a", "b", "c", "d"] * 8, dtype=object),
                                 "x": rng.normal(size=32).astype(np.float32)},
                          r={"k2": np.array(["w", "y", "z"], dtype=object),
                             "y": np.ones(3, np.float32)})

        def q(m, ctx):
            return (ctx.table("l").join(ctx.table("r"), left_on=("k",), right_on=("k2",))
                    .group_by("k", max_groups=8).agg(m.count_().as_("n")))
        got = q(tdf, tctx).collect(device="cpu", strategy={"join": "hash", "encode": "dict"})
        assert len(np.asarray(got["n"]).ravel()) == 0
        assert_frames_equal(got, jctx.execute(q(jdf, jctx), target="interp"))


# ---------------------------------------------------------------------------
# warning reasons
# ---------------------------------------------------------------------------


def _warn_msgs(caught, tag):
    return [str(w.message) for w in caught if tag in str(w.message)]


class TestWarningReasons:
    def test_no_stats_reason(self):
        _, tctx = make_sparse_ctxs()
        bare = Catalog(capacities={"t": tctx.capacity("t")})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tcompile(sparse_query(tdf, tctx).program(), catalog=bare, strategy=DICT_DIRECT,
                     cache=PlanCache())
        msgs = _warn_msgs(caught, "direct_unavailable")
        assert any("no catalog statistics" in m for m in msgs), msgs

    def test_dictionary_over_budget_reason(self):
        rng = np.random.default_rng(9)
        n, card = 4096, 2048
        d1 = rng.integers(0, 1_000_000_000, card).astype(np.int32)
        d2 = rng.integers(0, 1_000_000_000, card).astype(np.int32)
        _, tctx = both(512, t={"a": d1[rng.integers(0, card, n)],
                               "b": d2[rng.integers(0, card, n)],
                               "v": rng.normal(size=n).astype(np.float32)})
        q = tctx.table("t").group_by("a", "b", max_groups=4096).agg(tdf.sum_("v").as_("s"))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            compiled(tctx, q, strategy=DICT_DIRECT)
        msgs = _warn_msgs(caught, "direct_unavailable")
        assert any("dictionary over budget" in m for m in msgs), msgs

    def test_forced_raw_reason(self):
        _, tctx = make_sparse_ctxs()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            compiled(tctx, sparse_query(tdf, tctx),
                     strategy={"groupby": "direct", "encode": "raw"})
        msgs = _warn_msgs(caught, "direct_unavailable")
        assert any("strategy forced encode=raw" in m for m in msgs), msgs


# ---------------------------------------------------------------------------
# the 32-bit composite packing ceiling, lifted by packing ranks
# ---------------------------------------------------------------------------


def test_sorted_composite_join_packs_ranks():
    rng = np.random.default_rng(17)
    n, card = 2048, 64
    d1 = (rng.permutation(200_000)[:card] * 21_001).astype(np.int32)
    d2 = (rng.permutation(200_000)[:card] * 21_017).astype(np.int32)
    idx = rng.integers(0, card, n)
    pairs = rng.permutation(card)
    jctx, tctx = both(256, l={"a": d1[idx], "b": d2[idx],
                              "x": rng.normal(size=n).astype(np.float32)},
                      r={"a2": d1[pairs], "b2": d2[pairs],
                         "y": rng.normal(size=card).astype(np.float32)})

    def q(m, ctx):
        return (ctx.table("l").join(ctx.table("r"), left_on=("a", "b"), right_on=("a2", "b2"))
                .group_by("a", max_groups=128)
                .agg(m.sum_("y").as_("sy"), m.count_().as_("n")).order_by("a"))
    strat = {"join": "sorted", "encode": "dict"}
    res = compiled(tctx, q(tdf, tctx), strategy=strat)
    merge = next(i for i in res.program.body if i.opcode == "vec.MergeJoinSorted")
    domains = merge.param("key_domains")
    assert domains is not None
    assert np.prod([int(hi) - int(lo) + 1 for lo, hi in domains]) <= card * card
    (out,) = res(tctx.sources("cpu"))
    assert_frames_equal(out.to_numpy(), jctx.execute(q(jdf, jctx), target="interp"))


# ---------------------------------------------------------------------------
# the runtime operators against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["remap", "searchsorted"])
def test_dict_encode_decode_match_jax(mode):
    """Values in and out of the dictionary (the sentinel rank ``card``),
    invalid rows, both lookup modes; decoding clips sentinel ranks."""
    rng = np.random.default_rng(3)
    values = np.sort(rng.choice(np.arange(-500, 500), 40, replace=False)).astype(np.int32)
    lo, card = int(values[0]), len(values)
    if mode == "remap":
        table = np.full(int(values[-1]) - lo + 1, card, np.int32)
        table[values - lo] = np.arange(card, dtype=np.int32)
    else:
        table = values
    n = 300
    k = np.where(rng.random(n) < 0.7, values[rng.integers(0, card, n)],
                 rng.integers(-700, 700, n)).astype(np.int32)
    valid = rng.random(n) < 0.9
    j = jrt.VecTable({"k": jnp.asarray(k)}, jnp.asarray(valid))
    t = vectable_from_arrays({"k": k}, valid, "cpu")
    jenc = jrt.dict_encode(j, ("k",), (mode,), (table,), (lo,), (card,))
    tenc = trt.dict_encode(t, ("k",), (mode,), (torch.from_numpy(table),), (lo,), (card,))
    np.testing.assert_array_equal(tenc.cols["k"].numpy(), np.asarray(jenc.cols["k"]))
    assert tenc.cols["k"].dtype == torch.int32
    assert int((tenc.cols["k"] == card).sum()) > 0
    jdec = jrt.dict_decode(jenc, ("k",), (values,))
    tdec = trt.dict_decode(tenc, ("k",), (torch.from_numpy(values),))
    np.testing.assert_array_equal(tdec.cols["k"].numpy(), np.asarray(jdec.cols["k"]))
    hit = tenc.cols["k"].numpy() < card
    np.testing.assert_array_equal(tdec.cols["k"].numpy()[hit], k[hit])
