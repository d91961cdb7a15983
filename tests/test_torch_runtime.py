"""The port's vec operators against ``repro.relational.runtime``.

Each operator on the torch port's path runs on the same numpy tables as
its JAX original (on the CPU).  Integers, keys and validity must match
exactly; floats within rtol 1e-5, since sums run in different orders.
Tables carry invalid rows throughout, so masking is exercised everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import expr as jexpr  # noqa: E402
from repro.relational import runtime as jrt  # noqa: E402
from repro_torch.convert import vectable_from_arrays  # noqa: E402
from repro_torch.core import expr as texpr  # noqa: E402
from repro_torch.relational import runtime as trt  # noqa: E402

RTOL = 1e-5


def _data(seed=9, n=777):
    rng = np.random.default_rng(seed)
    cols = {
        "i": rng.integers(-20, 20, n).astype(np.int32),
        "k": rng.integers(0, 5, n).astype(np.int32),
        "x": rng.uniform(-5, 5, n).astype(np.float32),
        "d": np.round(rng.uniform(0, 0.1, n), 2).astype(np.float32),
        "b": rng.random(n) < 0.3,
        "fk": rng.integers(-2, 25, n).astype(np.int32),
    }
    cols["x"][:10] = cols["x"][10:20]  # ties for the stable sort
    return cols, rng.random(n) < 0.85


def _both(cols, valid):
    j = jrt.VecTable({k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(valid))
    return j, vectable_from_arrays(cols, valid, "cpu")


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)


def _same(tt, jt):
    _close(tt.valid.numpy(), np.asarray(jt.valid), "valid")
    assert set(tt.cols) == set(jt.cols)
    for k in jt.cols:
        _close(tt.cols[k].numpy(), np.asarray(jt.cols[k]), k)


def _single(got, want):
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), np.asarray(want[k]), k)


PREDS = {
    "mixed": lambda m: (m.col("d") <= 0.07) & ~m.col("b") & (m.col("i") > -3.5),
    "none_pass": lambda m: m.col("i") > 100,
    "const": lambda m: m.const(True),
}


@pytest.mark.parametrize("pred", sorted(PREDS))
def test_mask_select(pred):
    j, t = _both(*_data())
    _same(trt.mask_select(t, PREDS[pred](texpr)), jrt.mask_select(j, PREDS[pred](jexpr)))


def test_exproj_types_follow_jax():
    j, t = _both(*_data())

    def exprs(m):
        return (("p", m.col("x") * (1.0 - m.col("d"))), ("q", m.col("i") / m.col("k")),
                ("r", m.col("b") + 1), ("s", m.const(7)), ("u", m.const(2.5)),
                ("v", (m.col("i") < 3) * m.col("x")), ("w", m.col("i") * 2))
    _same(trt.exproj(t, exprs(texpr)), jrt.exproj(j, exprs(jexpr)))


@pytest.mark.parametrize("pred", sorted(PREDS))
def test_aggr_masked(pred):
    j, t = _both(*_data())
    jt, tt = jrt.mask_select(j, PREDS[pred](jexpr)), trt.mask_select(t, PREDS[pred](texpr))

    def aggs(m):
        return (m.AggSpec("sum", m.col("x"), "s"), m.AggSpec("count", m.const(1), "c"),
                m.AggSpec("min", m.col("i"), "mn"), m.AggSpec("max", m.col("x"), "mx"),
                m.AggSpec("sum", m.col("b"), "sb"))
    got, want = trt.aggr(tt, aggs(texpr)), jrt.aggr(jt, aggs(jexpr))
    _single(got, want)
    if pred == "none_pass":  # empty min/max are ±inf
        assert float(got["mn"]) == np.inf and float(got["mx"]) == -np.inf


SORTS = {
    "one_int": (("k",), (True,)),
    "int_desc_float": (("k", "x"), (False, True)),
    "float_desc": (("x",), (False,)),
    "bool_then_int": (("b", "i"), (False, True)),
}


@pytest.mark.parametrize("sort", sorted(SORTS))
def test_sort_by_key_valid_first_and_stable(sort):
    keys, asc = SORTS[sort]
    j, t = _both(*_data())
    _same(trt.sort_by_key(t, keys, asc), jrt.sort_by_key(j, keys, asc))


@pytest.mark.parametrize("max_count", [None, 50, 2000])
def test_compact(max_count):
    j, t = _both(*_data())
    _same(trt.compact(t, max_count), jrt.compact(j, max_count))


def test_int_key_bitcasts_f32():
    x = np.array([1.5, -0.0, 3.25], np.float32)
    got = trt._int_key(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrt._int_key(jnp.asarray(x))))


@pytest.mark.parametrize("n,nseg", [(0, 3), (777, 5), (300_000, 4), (20_000, 1 << 20)])
def test_segment_sum_stays_accurate_in_f32(n, nseg):
    """The plain per-bucket sum is f32 and close to the f64 sum of the same
    f32 values, also where one bucket takes 10^5 rows (one f32 accumulator
    per bucket would lose ~1e-5 of it), and where the buckets are so many
    that the chunk partials are capped."""
    rng = np.random.default_rng(n)
    vals = rng.uniform(0, 100, n).astype(np.float32)
    seg = rng.integers(0, nseg, n)
    got = trt._segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), nseg)
    want = np.bincount(seg, vals.astype(np.float64), minlength=nseg)
    assert got.dtype == torch.float32 and got.shape == (nseg,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_bucket_ids_and_decode():
    j, t = _both(*_data())
    doms = ((0, 4), (-20, 19))
    _close(trt.bucket_ids(t, ("k", "i"), doms).numpy().astype(np.int32),
           np.asarray(jrt.bucket_ids(j, ("k", "i"), doms)))
    got = trt.decode_bucket_keys(("k", "i"), doms, (torch.int32, torch.int32), 200, "cpu")
    want = jrt.decode_bucket_keys(("k", "i"), doms, (jnp.int32, jnp.int32), 200)
    for k in want:
        _close(got[k].numpy(), np.asarray(want[k]), k)


def test_bucket_ids_checked_flags_out_of_domain():
    j, t = _both(*_data())
    tb, tok = trt._bucket_ids_checked(t, ("fk",), ((0, 20),))
    jb, jok = jrt._bucket_ids_checked(j, ("fk",), ((0, 20),))
    _close(tb.numpy().astype(np.int32), np.asarray(jb))
    _close(tok.numpy(), np.asarray(jok))
    assert not tok.all()


@pytest.mark.parametrize("pred", ["mixed", "none_pass", None])
@pytest.mark.parametrize("agg_fn", ["sum", "min", "max", "count"])
def test_group_agg_direct(pred, agg_fn):
    j, t = _both(*_data())

    def aggs(m):
        e = m.const(1) if agg_fn == "count" else m.col("x") * (1.0 - m.col("d"))
        return (m.AggSpec(agg_fn, e, "a"), m.AggSpec("count", m.const(1), "n"))
    keys, rest = ("k", "i"), (64, ((0, 4), (-20, 19)), 200)
    got = trt.group_agg_direct(t, keys, aggs(texpr), *rest,
                               pred=PREDS[pred](texpr) if pred else None)
    want = jrt.group_agg_direct(j, keys, aggs(jexpr), *rest,
                                pred=PREDS[pred](jexpr) if pred else None)
    _same(got, want)


def _build(seed=4, m=40, dup=True):
    rng = np.random.default_rng(seed)
    rk = rng.integers(0, 22, m) if dup else rng.permutation(22)[:m]
    cols = {"rk": rk.astype(np.int32), "g": rng.integers(0, 3, len(rk)).astype(np.int32),
            "w": rng.uniform(0, 4, len(rk)).astype(np.float32)}
    return cols, rng.random(len(rk)) < 0.9


@pytest.mark.parametrize("dup", [True, False])
@pytest.mark.parametrize("max_count", [777, 300])
def test_hash_join_direct_static(dup, max_count):
    jl, tl = _both(*_data())
    jr, tr = _both(*_build(dup=dup))
    args = (("fk",), ("rk",), max_count)
    _same(trt.hash_join_direct(tl, tr, *args, key_domains=((0, 21),)),
          jrt.hash_join_direct(jl, jr, *args, key_domains=((0, 21),)))


def test_hash_join_direct_dynamic_bounds_not_ported():
    _, tl = _both(*_data())
    _, tr = _both(*_build())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trt.hash_join_direct(tl, tr, ("fk",), ("rk",), 777, num_buckets=64)


@pytest.mark.parametrize("pred", ["mixed", None])
@pytest.mark.parametrize("keys", [("k",), ("g", "k")])
def test_fused_join_group_agg(pred, keys):
    jl, tl = _both(*_data())
    jr, tr = _both(*_build())
    doms = {"k": (0, 4), "g": (0, 2)}

    def kw(m):
        kd = tuple(doms[k] for k in keys)
        return dict(left_on=("fk",), right_on=("rk",), join_key_domains=((0, 21),),
                    join_num_buckets=22, keys=keys, max_groups=15, key_domains=kd,
                    num_buckets=int(np.prod([hi - lo + 1 for lo, hi in kd])),
                    pred=PREDS[pred](m) if pred else None,
                    aggs=(m.AggSpec("sum", m.col("w") * m.col("x"), "s"),
                          m.AggSpec("count", m.const(1), "c"),
                          m.AggSpec("max", m.col("i"), "mx")))
    _same(trt.fused_join_group_agg(tl, tr, **kw(texpr)),
          jrt.fused_join_group_agg(jl, jr, **kw(jexpr)))


def test_from_numpy_pads_and_drops_x64():
    t = trt.VecTable.from_numpy({"a": np.arange(5, dtype=np.int64),
                                 "f": np.linspace(0, 1, 5)}, capacity=8, device="cpu")
    assert t.capacity == 8 and int(t.count()) == 5
    assert t.cols["a"].dtype == torch.int32 and t.cols["f"].dtype == torch.float32
    assert t.to_numpy()["a"].tolist() == [0, 1, 2, 3, 4]


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        assert trt.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.VecTable.from_numpy({"a": np.arange(3, dtype=np.int32)})


def test_mid_pipeline_table_carries_over():
    """A JAX table with holes (after a MaskSelect) carries over through
    numpy with its validity; the next operator agrees on both sides."""
    j, _ = _both(*_data())
    js = jrt.mask_select(j, PREDS["mixed"](jexpr))
    ts = vectable_from_arrays({k: np.asarray(v) for k, v in js.cols.items()},
                              np.asarray(js.valid), "cpu")
    doms = ((0, 4),)
    aggs_t = (texpr.AggSpec("sum", texpr.col("x"), "s"),)
    aggs_j = (jexpr.AggSpec("sum", jexpr.col("x"), "s"),)
    _same(trt.group_agg_direct(ts, ("k",), aggs_t, 5, doms, 5),
          jrt.group_agg_direct(js, ("k",), aggs_j, 5, doms, 5))
