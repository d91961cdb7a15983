"""The SQL frontend of the torch port (``repro_torch.frontends.sql``)
against the JAX package's (``repro.frontends.sql``).

``TestSQL`` of tests/test_frontends.py, on the same tables: each query
through the port's ``sql.query(..., device="cpu")`` is held against numpy
and against the JAX package's ``sql.query`` (rtol 1e-4, integers exact),
and parses to the same ``rel`` program as in the JAX package.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.frontends import dataflow as jdf, sql as jsql  # noqa: E402
from repro_torch.core.expr import col  # noqa: E402
from repro_torch.frontends import dataflow as tdf, sql as tsql  # noqa: E402


def _tables():
    rng = np.random.default_rng(5)
    n = 3000
    return {
        "t": {"a": rng.integers(0, 20, n).astype(np.int32),
              "b": rng.uniform(0, 100, n).astype(np.float32),
              "c": rng.uniform(0, 1, n).astype(np.float32),
              "g": rng.integers(0, 4, n).astype(np.int32)},
        "dim": {"g": np.arange(4, dtype=np.int32),
                "label": np.asarray([10, 20, 30, 40], dtype=np.int32)},
    }


@pytest.fixture(scope="module")
def ctxs():
    out = []
    for m in (jdf, tdf):
        c = m.Context(pad_to=256)
        for name, data in _tables().items():
            c.register(name, data)
        out.append(c)
    return out


QUERIES = {
    "scalar_agg": "SELECT sum(b * c) AS s, count(*) AS n FROM t WHERE a < 10",
    "group_by_order_by": "SELECT sum(b) AS s FROM t GROUP BY g ORDER BY g",
    "join": "SELECT sum(label) AS s FROM t JOIN dim ON g = g WHERE b < 50",
    "between_and_arithmetic": "SELECT sum(b - 2 * c) AS s FROM t WHERE c BETWEEN 0.2 AND 0.4",
    "avg_desugars": "SELECT avg(b) AS m FROM t",
    "order_by_desc_limit": "SELECT sum(b) AS s, min(c) AS lo FROM t GROUP BY a, g "
                           "ORDER BY a DESC, g LIMIT 5",
    "projection_order_limit": "SELECT a, b * c AS p FROM t WHERE g = 2 ORDER BY p DESC LIMIT 7",
}


def _agree(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_jax_sql(name, ctxs):
    jctx, tctx = ctxs
    got = tsql.query(tctx, QUERIES[name], device="cpu")
    _agree(got, jsql.query(jctx, QUERIES[name]))


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_same_rel_program_as_jax(name, ctxs):
    jctx, tctx = ctxs
    jp = jsql.parse(QUERIES[name], jctx).program()
    tp = tsql.parse(QUERIES[name], tctx).program()
    assert [i.opcode for i in tp.body] == [i.opcode for i in jp.body]
    for ji, ti in zip(jp.body, tp.body):
        assert sorted(k for k, _ in ti.params) == sorted(k for k, _ in ji.params)
        for k, v in ji.params:
            if k != "schema":
                assert repr(ti.param(k)) == repr(v), (ji.opcode, k)


class TestSQL:
    def test_scalar_agg(self, ctxs):
        _, ctx = ctxs
        out = tsql.query(ctx, QUERIES["scalar_agg"], device="cpu")
        t = ctx.tables["t"]
        m = t["a"] < 10
        assert out["s"] == pytest.approx(float((t["b"] * t["c"])[m].sum()), rel=1e-4)
        assert int(out["n"]) == int(m.sum())

    def test_group_by_order_by(self, ctxs):
        _, ctx = ctxs
        out = tsql.query(ctx, QUERIES["group_by_order_by"], device="cpu")
        t = ctx.tables["t"]
        want = [float(t["b"][t["g"] == g].sum()) for g in range(4)]
        np.testing.assert_allclose(np.asarray(out["s"], dtype=np.float64), want, rtol=1e-4)

    def test_join(self, ctxs):
        _, ctx = ctxs
        out = tsql.query(ctx, QUERIES["join"], device="cpu")
        t, d = ctx.tables["t"], ctx.tables["dim"]
        m = t["b"] < 50
        assert int(out["s"]) == int(d["label"][t["g"][m]].sum())

    def test_between_and_arithmetic(self, ctxs):
        _, ctx = ctxs
        out = tsql.query(ctx, QUERIES["between_and_arithmetic"], device="cpu")
        t = ctx.tables["t"]
        m = (t["c"] >= 0.2) & (t["c"] <= 0.4)
        assert out["s"] == pytest.approx(float((t["b"] - 2 * t["c"])[m].sum()), rel=1e-4)

    def test_avg_desugars(self, ctxs):
        _, ctx = ctxs
        out = tsql.query(ctx, QUERIES["avg_desugars"], device="cpu")
        assert out["m"] == pytest.approx(float(ctx.tables["t"]["b"].mean()), rel=1e-4)

    def test_order_by_desc_limit(self, ctxs):
        """ORDER BY … LIMIT over a GROUP BY (max_groups=4096): the sort and
        the limit the port's emitters now run."""
        _, ctx = ctxs
        out = tsql.query(ctx, QUERIES["order_by_desc_limit"], device="cpu")
        t = ctx.tables["t"]
        pairs = sorted({(int(a), int(g)) for a, g in zip(t["a"], t["g"])},
                       key=lambda p: (-p[0], p[1]))[:5]
        assert list(zip(out["a"].tolist(), out["g"].tolist())) == pairs
        for i, (a, g) in enumerate(pairs):
            m = (t["a"] == a) & (t["g"] == g)
            assert out["s"][i] == pytest.approx(float(t["b"][m].sum()), rel=1e-4)

    def test_syntax_error(self, ctxs):
        _, ctx = ctxs
        with pytest.raises(SyntaxError):
            tsql.parse("SELECT FROM t", ctx)

    def test_same_ir_as_python_frontend(self, ctxs):
        _, ctx = ctxs
        q_sql = tsql.parse("SELECT sum(b) AS s FROM t WHERE a < 5", ctx)
        q_py = ctx.table("t").filter(col("a") < 5).agg(tdf.sum_("b").as_("s"))
        assert [i.opcode for i in q_sql.program().body] == \
               [i.opcode for i in q_py.program().body]

    @pytest.mark.parametrize("target,error,where", [
        ("interp", None, "the numpy interpreter, as JAX's"),
        ("spmd", None, "one rank, as JAX's spmd target on one device"),
        ("nope", KeyError, "unknown compile target"),
    ])
    def test_other_targets_name_their_roadmap_item(self, ctxs, target, error, where):
        """``interp`` is ported (it must give the JAX interpreter's answer
        bit for bit); ``spmd`` with no ``parallel`` runs on one rank with no
        process group, as the JAX package's runs on one device (held within
        the module's tolerance: the port binds its own default strategy);
        an unknown target names itself."""
        jctx, ctx = ctxs
        if error is None:
            for name, sql in QUERIES.items():
                got = tsql.query(ctx, sql, target=target, device="cpu")
                want = jsql.query(jctx, sql, target=target)
                assert set(got) == set(want), name
                if target != "interp":
                    _agree(got, want)
                    continue
                for k in want:
                    np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                                  err_msg=f"{name}.{k}: {where}")
            return
        with pytest.raises(error, match=where):
            tsql.query(ctx, QUERIES["scalar_agg"], target=target, device="cpu")
