"""CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with ``nvcc``; elsewhere each test skips with
its reason (decided inside the fixture, never at import).  Run them on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integers exact; floats within rtol 1e-4 of the plain versions, which add
in another order.  Every route gives the same bits on two runs: the
tensor-core kmeans_step and segsum, fused_select_agg and the register
route of grouped_select_agg and grouped_join_agg add in a fixed order, the
atomic routes (grouped smem and global, kms_main, seg_main) add integers
(``csrc/fixsum.cuh``, held bit for bit to ``ref.fixed_sum``), and the
torch segment sums of the sorted tiers add the same integers
(``runtime.fixed_sum``).  k-means
steps go by the tie-margin rule of ``repro_torch.kmeans`` at rtol 1e-4:
counts add up to n and sums to Σx whatever the ties, and each count and
sum may move by what the points within a few f32 roundings of a tie carry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backends.local import LocalBackend  # noqa: E402
from repro_torch.convert import tensors_from_arrays, vectable_from_arrays  # noqa: E402
from repro_torch import kmeans  # noqa: E402
from repro_torch.core.expr import AggSpec, col, const  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.relational import runtime as rt, tpch  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (no CUDA device is visible)")
    return "cuda"


def _same(got, want):
    if isinstance(want, dict):
        pairs = [(k, got[k], want[k]) for k in want]
    else:
        pairs = [("valid", got.valid, want.valid)] + [
            (k, got.cols[k], want.cols[k]) for k in want.cols]
    for k, g, w in pairs:
        g, w = g.cpu(), w.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.is_floating_point():
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=k)
        else:
            assert torch.equal(g, w), k


def _table(card, n=100_003, seed=2):
    rng = np.random.default_rng(seed)
    cols = {"a": rng.integers(-50, 50, n).astype(np.int32),
            "x": rng.uniform(-2, 2, n).astype(np.float32),
            "k": rng.integers(0, 7, n).astype(np.int32),
            "fk": rng.integers(-3, 5000, n).astype(np.int32)}
    return vectable_from_arrays(cols, rng.random(n) < 0.9, card)


AGGS = (AggSpec("sum", col("x") * 2.0, "s"), AggSpec("min", col("a"), "mn"),
        AggSpec("max", col("x"), "mx"), AggSpec("count", const(1), "c"))


@pytest.mark.parametrize("pred", [col("a") > 10.5, col("a") > 1000])
def test_fused_select_agg_on_card(card, pred):
    t = _table(card)
    before = ops.LAUNCHES["fused_select_agg"]
    _same(ops.fused_select_agg(t, pred, AGGS), ref.fused_select_agg(t, pred, AGGS))
    assert ops.LAUNCHES["fused_select_agg"] == before + 1


@pytest.mark.parametrize("keys,doms", [(("k",), ((0, 6),)),
                                       (("fk", "k"), ((0, 4999), (0, 6)))])
def test_grouped_select_agg_on_card(card, keys, doms):
    t = _table(card)
    nb = int(np.prod([hi - lo + 1 for lo, hi in doms]))
    args = (t, col("a") > -20, keys, AGGS, min(nb, 4096), doms, nb)
    _same(ops.grouped_select_agg(*args), ref.grouped_select_agg(*args))


def _routed(fn, *args, **kw):
    """fn(*args, **kw) and the generated kernel route its one launch took."""
    before = dict(ops.GEN_LAUNCHES)
    out = fn(*args, **kw)
    took = [r for r in ops.GEN_LAUNCHES if ops.GEN_LAUNCHES[r] != before[r]]
    assert len(took) == 1 and ops.GEN_LAUNCHES[took[0]] == before[took[0]] + 1
    return out, took[0]


# AGGS has three values: 1 + 3 accumulators per bucket, so the reg route
# (64 registers) ends at 16 buckets and the smem route (48 KB) at 3072
@pytest.mark.parametrize("nb,route", [(16, "gsa_reg"), (17, "gsa_smem"),
                                      (3072, "gsa_smem"), (3073, "gsa_global")])
def test_grouped_select_agg_routes_at_their_borders_on_card(card, nb, route):
    t = _table(card)
    args = (t, col("a") > -20, ("fk",), AGGS, nb, ((-3, nb - 4),), nb)
    got, took = _routed(ops.grouped_select_agg, *args)
    assert took == route
    torch.cuda.synchronize()
    _same(got, ref.grouped_select_agg(*args))


def _deep_pred(depth=24):
    """Or-ed comparisons nested deeper than the interpreter's stack of 16."""
    e = col("x") > 1.9
    for k in range(depth):
        e = (col("k").eq(k % 7) & (col("a") < k - 12)) | e
    return e


def test_deep_predicate_through_both_generated_kernels_on_card(card):
    t = _table(card)
    pred = _deep_pred()
    _same(ops.fused_select_agg(t, pred, AGGS), ref.fused_select_agg(t, pred, AGGS))
    args = (t, pred, ("k",), AGGS, 7, ((0, 6),), 7)
    got, took = _routed(ops.grouped_select_agg, *args)
    assert took == "gsa_reg"
    _same(got, ref.grouped_select_agg(*args))


def test_generated_kernels_give_the_same_bits_twice_on_card(card):
    t = _table(card, n=2_000_003)
    pred = col("a") > -30
    first, took = _routed(ops.fused_select_agg, t, pred, AGGS)
    second, _ = _routed(ops.fused_select_agg, t, pred, AGGS)
    assert took == "fsa_gen"
    assert all(torch.equal(first[k], second[k]) for k in first)
    args = (t, pred, ("k",), AGGS, 7, ((0, 6),), 7)
    (g1, took), (g2, _) = _routed(ops.grouped_select_agg, *args), _routed(
        ops.grouped_select_agg, *args)
    assert took == "gsa_reg"
    assert torch.equal(g1.valid, g2.valid)
    assert all(torch.equal(g1.cols[k], g2.cols[k]) for k in g1.cols)
    _same(g1, ref.grouped_select_agg(*args))


@pytest.mark.parametrize("keys,doms", [
    (("k",), ((0, 6),)),
    # 400,000 buckets: past the 48 KB of shared accumulators, so the rows
    # add into global memory (the sign-aware min/max atomics included)
    (("fk", "a"), ((0, 99), (-2000, 1999))),
])
def test_grouped_join_agg_on_card(card, keys, doms):
    t = _table(card)
    rng = np.random.default_rng(3)
    right = vectable_from_arrays({"rk": rng.integers(0, 4000, 6000).astype(np.int32),
                                  "w": rng.uniform(0, 3, 6000).astype(np.float32)},
                                 rng.random(6000) < 0.95, card)
    nb = int(np.prod([hi - lo + 1 for lo, hi in doms]))
    kw = dict(left_on=("fk",), right_on=("rk",), join_key_domains=((0, 3999),),
              join_num_buckets=4000, keys=keys, max_groups=nb, key_domains=doms,
              num_buckets=nb, pred=col("a") < 30,
              aggs=(AggSpec("sum", col("w") * col("x"), "s"),
                    AggSpec("min", col("w") * col("x"), "mn"),
                    AggSpec("max", col("w"), "mx"), AggSpec("count", const(1), "c")))
    _same(ops.grouped_join_agg(t, right, **kw), ref.grouped_join_agg(t, right, **kw))


def _build_side(card, m=6000, keys=4000, seed=3):
    rng = np.random.default_rng(seed)
    return vectable_from_arrays({"rk": rng.integers(0, keys, m).astype(np.int32),
                                 "w": rng.uniform(0, 3, m).astype(np.float32),
                                 "g": rng.integers(0, 3, m).astype(np.int32)},
                                rng.random(m) < 0.95, card)


JOIN_AGGS = (AggSpec("sum", col("w") * col("x"), "s"), AggSpec("min", col("w") * col("x"), "mn"),
             AggSpec("max", col("w"), "mx"), AggSpec("count", const(1), "c"))


# JOIN_AGGS has three values: 1 + 3 accumulators per group bucket, so the
# reg route ends at 16 buckets and the smem route at 3072, as
# grouped_select_agg's
@pytest.mark.parametrize("nb,route", [(16, "gja_reg"), (17, "gja_smem"),
                                      (3072, "gja_smem"), (3073, "gja_global")])
def test_grouped_join_agg_routes_at_their_borders_on_card(card, nb, route):
    t = _table(card)
    kw = dict(left_on=("fk",), right_on=("rk",), join_key_domains=((0, 3999),),
              join_num_buckets=4000, keys=("a",), max_groups=nb, key_domains=((-50, nb - 51),),
              num_buckets=nb, pred=col("x") < 1.5, aggs=JOIN_AGGS)
    right = _build_side(card)
    got, took = _routed(ops.grouped_join_agg, t, right, **kw)
    assert took == route
    torch.cuda.synchronize()
    _same(got, ref.grouped_join_agg(t, right, **kw))


def test_grouped_join_agg_duplicate_and_out_of_domain_keys_on_card(card):
    """Duplicate and invalid build rows (first valid occurrence wins),
    build keys outside the join domain (dropped), probe keys outside it
    (dropped), a group key on the build side and one past its domain
    (clipped), on the reg route; then the smallest presence case (probe key
    0, build keys [2, 0]: one match)."""
    t = _table(card)
    rng = np.random.default_rng(4)
    right = vectable_from_arrays({"rk": rng.integers(-50, 1200, 3000).astype(np.int32),
                                  "w": rng.uniform(0, 3, 3000).astype(np.float32),
                                  "g": rng.integers(0, 4, 3000).astype(np.int32)},
                                 rng.random(3000) < 0.8, card)
    kw = dict(left_on=("fk",), right_on=("rk",), join_key_domains=((0, 999),),
              join_num_buckets=1000, keys=("g", "k"), max_groups=15, key_domains=((0, 2), (0, 4)),
              num_buckets=15, pred=col("a") > -40, aggs=JOIN_AGGS)
    got, took = _routed(ops.grouped_join_agg, t, right, **kw)
    assert took == "gja_reg"
    _same(got, ref.grouped_join_agg(t, right, **kw))
    left = vectable_from_arrays({"fk": np.array([0], np.int32)}, np.array([True]), card)
    right = vectable_from_arrays({"rk": np.array([2, 0], np.int32)}, np.ones(2, bool), card)
    out = ops.grouped_join_agg(left, right, left_on=("fk",), right_on=("rk",),
                               join_key_domains=((0, 2),), join_num_buckets=3, keys=(),
                               aggs=(AggSpec("count", const(1), "c"),), max_groups=1,
                               key_domains=(), num_buckets=1)
    assert out.to_numpy()["c"].tolist() == [1]


def _tpch_join_calls(card, sf=0.05):
    """The grouped_join_agg calls of Q4 and Q12 on a small TPC-H, as the
    path makes them on the card."""
    ctx = tpch.make_context(tpch.generate(sf=sf, seed=1))
    calls, original = {}, ops.grouped_join_agg

    def record(left, right, **kw):
        calls[q] = (left, right, kw)
        return original(left, right, **kw)

    ops.grouped_join_agg = record
    try:
        for q in ("q4", "q12"):
            tpch.QUERIES[q](ctx).collect(device=card)
    finally:
        ops.grouped_join_agg = original
    return calls


def test_grouped_join_agg_tpch_shapes_on_card_same_bits_twice(card):
    """Q4's join (its build side a compacted inner result) and Q12's, as
    the path makes them: the reg route, the plain version's result, the
    same bits on a second run."""
    for q, (left, right, kw) in _tpch_join_calls(card).items():
        (first, took), (second, _) = (_routed(ops.grouped_join_agg, left, right, **kw),
                                      _routed(ops.grouped_join_agg, left, right, **kw))
        assert took == "gja_reg", q
        _same(first, ref.grouped_join_agg(left, right, **kw))
        assert torch.equal(first.valid, second.valid)
        for k in first.cols:
            a, b = first.cols[k], second.cols[k]
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (q, k)


def test_tpch_on_card_matches_reference(card):
    tables = tpch.generate(sf=0.05, seed=1)
    ctx = tpch.make_context(tables)
    for q, f in tpch.QUERIES.items():
        got = f(ctx).collect(device=card)
        want = tpch.REFERENCES[q](tables)
        for k in want:  # grouped results come out ordered by key, as the references
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape, (q, k)
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g.astype(np.int64), w, err_msg=f"{q}.{k}")
            else:
                np.testing.assert_allclose(g.astype(np.float64), w, rtol=2e-4,
                                           err_msg=f"{q}.{k}")


def test_tpch_parallel_on_card_matches_reference(card):
    tables = tpch.generate(sf=0.05, seed=1)
    ctx = tpch.make_context(tables)
    for q, f in tpch.QUERIES.items():
        got = f(ctx).collect(device=card, parallel=4)
        want = tpch.REFERENCES[q](tables)
        for k in want:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape, (q, k)
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g.astype(np.int64), w, err_msg=f"{q}.{k}")
            else:
                np.testing.assert_allclose(g.astype(np.float64), w, rtol=2e-4,
                                           err_msg=f"{q}.{k}")


def _mixed_pair(card, n=50_003, seed=6):
    """The same table on the card and on the CPU: int keys reaching
    INT32_MIN, bool keys, f32 keys with ties, invalid rows."""
    rng = np.random.default_rng(seed)
    cols = {"i": rng.integers(-4, 4, n).astype(np.int32),
            "b": rng.random(n) < 0.4,
            "f": rng.choice(np.array([-1.5, 0.25, 2.0], np.float32), n),
            "fk": rng.integers(-3, 900, n).astype(np.int32),
            "x": rng.normal(size=n).astype(np.float32)}
    cols["i"][:7] = np.iinfo(np.int32).min
    valid = rng.random(n) < 0.85
    return vectable_from_arrays(cols, valid, card), vectable_from_arrays(cols, valid, "cpu")


@pytest.mark.parametrize("keys,asc", [(("i",), (False,)), (("b", "i"), (False, True)),
                                      (("f", "b", "i"), (True, True, False))])
def test_sort_chain_and_group_agg_sorted_on_card(card, keys, asc):
    """The chained stable sorts (bool keys cast, descending ints negated at
    INT32_MIN) and the sorted group-by on the card, against the CPU."""
    from repro_torch.relational import runtime as rt

    dev, cpu = _mixed_pair(card)
    _same(rt.sort_by_key(dev, keys, asc), rt.sort_by_key(cpu, keys, asc))
    aggs = (AggSpec("sum", col("x"), "s"), AggSpec("min", col("x"), "mn"),
            AggSpec("max", col("fk"), "mx"), AggSpec("count", const(1), "c"))
    _same(rt.group_agg_sorted(rt.sort_by_key(dev, keys), keys, aggs, 40),
          rt.group_agg_sorted(rt.sort_by_key(cpu, keys), keys, aggs, 40))


@pytest.mark.parametrize("nb", [4096, 64])
def test_merge_join_and_dynamic_hash_join_on_card(card, nb):
    """merge_join_sorted, and the dynamic hash_join_direct on its direct
    branch (4096 buckets hold the joint key span) and its sorted one (64
    do not), on the card against the CPU."""
    from repro_torch.relational import runtime as rt

    dev, cpu = _mixed_pair(card)
    rng = np.random.default_rng(8)
    build = {"rk": rng.permutation(900).astype(np.int32),
             "y": rng.normal(size=900).astype(np.float32)}
    rvalid = rng.random(900) < 0.9
    rdev, rcpu = (vectable_from_arrays(build, rvalid, d) for d in (card, "cpu"))
    _same(rt.merge_join_sorted(dev, rt.sort_by_key(rdev, ("rk",)), ("fk",), ("rk",), 30_000),
          rt.merge_join_sorted(cpu, rt.sort_by_key(rcpu, ("rk",)), ("fk",), ("rk",), 30_000))
    _same(rt.hash_join_direct(dev, rdev, ("fk",), ("rk",), 30_000, num_buckets=nb),
          rt.hash_join_direct(cpu, rcpu, ("fk",), ("rk",), 30_000, num_buckets=nb))


def test_plan_cache_hit_on_card(card):
    """A repeated collect on the card hits the plan cache and runs the
    miss's plan, with the same bits under the port's tiers, encode=dict
    and the sorted tiers (the generated kernels add in a fixed order or as
    integers; the sorted tiers' segment sums are integers too, ROADMAP
    Queue 3 item 17).  The CPU's plan is another entry."""
    from repro_torch.compiler import PlanCache

    tables = tpch.generate(sf=0.05, seed=1)
    ctx = tpch.make_context(tables)
    cache = PlanCache()
    strategies = (None, {"encode": "dict"}, {"groupby": "sorted", "join": "sorted"})
    for strategy in strategies:
        for q, f in tpch.QUERIES.items():
            first = f(ctx).collect(device=card, strategy=strategy, cache=cache)
            hit = ctx.compile(f(ctx), device=card, strategy=strategy, cache=cache)
            assert hit.cache_hit
            again = f(ctx).collect(device=card, strategy=strategy, cache=cache)
            for k in first:
                a, b = np.asarray(first[k]), np.asarray(again[k])
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (strategy, q, k)
            assert not ctx.compile(f(ctx), device="cpu", strategy=strategy,
                                   cache=cache).cache_hit
    assert cache.stats["hits"] == 2 * len(strategies) * len(tpch.QUERIES)


def _clusters(n, d, k, seed):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 5, (k, d))
    x = centres[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d))
    return x.astype(np.float32), rng.normal(0, 5, (k, d)).astype(np.float32)


def _assert_step_agrees(got, want, x, c):
    kmeans.check_step("kmeans_step", got, want, kmeans.reference_step(x, c), 1e-4)


def _routed_step(xt, ct):
    """ops.kmeans_step, and the route its one launch took."""
    before = dict(ops.KMEANS_LAUNCHES)
    got = ops.kmeans_step(xt, ct)
    took = [r for r in ops.KMEANS_LAUNCHES if ops.KMEANS_LAUNCHES[r] != before[r]]
    assert len(took) == 1 and ops.KMEANS_LAUNCHES[took[0]] == before[took[0]] + 1
    assert took[0] == ops.kmeans_step_route(xt.shape[1], ct.shape[0])
    return got, took[0]


@pytest.mark.parametrize("n,d,k,route", [
    (1003, 8, 16, "kms_tc"), (999, 3, 7, "kms_tc"), (1000, 8, 1, "kms_tc"),
    (2000, 128, 8, "kms_main"),
    (5000, 64, 256, "kms_main"),   # 128 KB of centroids and accumulators: dynamic shared memory
    (3000, 64, 512, "kms_main"),   # past the opt-in shared memory: global accumulators
])
def test_kmeans_step_on_card(card, n, d, k, route):
    x, c = _clusters(n, d, k, seed=n + k)
    xt, ct = tensors_from_arrays(x, c, device=card)
    before = ops.LAUNCHES["kmeans_step"]
    got, took = _routed_step(xt, ct)
    assert ops.LAUNCHES["kmeans_step"] == before + 1
    assert took == route
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    _assert_step_agrees(got, ref.kmeans_step(xt, ct), x, c)


def _offset_view(x, card, rows_before, floats_before):
    """x on the card as a contiguous view that starts ``rows_before`` rows
    and ``floats_before`` floats into a larger tensor (so, for a start
    that is not 16-byte aligned, like a chunk of a Split)."""
    n, d = x.shape
    flat = np.zeros((rows_before + n + 1) * d + floats_before, np.float32)
    at = rows_before * d + floats_before
    flat[at:at + n * d] = x.ravel()
    return torch.from_numpy(flat).to(card)[at:at + n * d].view(n, d)


@pytest.mark.parametrize("n,d,k,shift", [
    (100, 8, 16, (0, 0)),        # fewer points than one tile (512)
    (1001, 8, 16, (0, 0)),       # not a multiple of 8 or 16
    (4099, 8, 16, (0, 1)),       # starts 4 bytes into a 16-byte granule
    (4099, 8, 16, (0, 2)),       # 8-byte aligned, not 16
    (3001, 3, 7, (5, 0)),        # a chunk of rows of 12 bytes: starts 60 bytes in
    (2000, 1, 16, (0, 3)),
    (5000, 8, 1, (0, 0)),
    (6000, 8, 64, (0, 0)),       # the top of the range: KP·DP = 512
    (6000, 16, 32, (0, 1)),
    (6000, 32, 16, (0, 0)),
    (5000, 20, 13, (0, 0)),      # d padded to 32
    (3000, 8, 65, (0, 0)),       # past the range: the CUDA-core kernel
    (3000, 33, 4, (0, 0)),
    (3000, 17, 17, (0, 0)),
])
def test_kmeans_step_routes_at_their_borders_on_card(card, n, d, k, shift):
    x, c = _clusters(n, d, k, seed=n + d + k)
    xt = _offset_view(x, card, *shift)
    ct = torch.from_numpy(c).to(card)
    assert xt.is_contiguous() and torch.equal(xt.cpu(), torch.from_numpy(x))
    got, took = _routed_step(xt, ct)
    inside = d <= 32 and k <= 64 and ((k + 15) // 16 * 16 if k <= 32 else 64) * (
        8 if d <= 8 else 16 if d <= 16 else 32) <= 512
    assert took == ("kms_tc" if inside else "kms_main")
    torch.cuda.synchronize()
    _assert_step_agrees(got, ref.kmeans_step(xt, ct), x, c)


def test_kmeans_step_with_no_points_on_card(card):
    for d, k in ((8, 16), (3, 7), (64, 256)):
        xt = torch.zeros((0, d), dtype=torch.float32, device=card)
        ct = torch.ones((k, d), dtype=torch.float32, device=card)
        sums, counts = _routed_step(xt, ct)[0]
        assert sums.shape == (k, d) and counts.shape == (k,)
        assert not bool(sums.any()) and not bool(counts.any())


def test_kmeans_step_tensor_cores_are_deterministic_on_card(card):
    x, c = kmeans.make_data(1 << 21, 8, 16, 0)
    xt, ct = tensors_from_arrays(x, c, device=card)
    (s1, c1), took = _routed_step(xt, ct)
    (s2, c2), _ = _routed_step(xt, ct)
    assert took == "kms_tc"
    assert torch.equal(s1, s2) and torch.equal(c1, c2)


@pytest.mark.parametrize("n,d,k,offset", [
    (1 << 20, 8, 16, 0.0), (1 << 20, 8, 16, 1000.0), (100_003, 3, 7, 0.0),
    (200_001, 16, 32, 0.0), (150_000, 32, 16, 0.0), (99_999, 8, 64, 0.0),
    # d = 1, where the split's worst case fills the tie margin: centroids'
    # and points' low bits near half a TF32 unit, points at midpoints
    (256 * 49, 1, 16, "near ties"),
])
def test_kmeans_step_matches_its_recipe_on_card(card, n, d, k, offset):
    """The tensor-core kernel against ref.kmeans_step_tiled on the same
    inputs on the card, and both against the f64 step: sums within rtol
    1e-4, labels by the tie-margin rule (a TF32 product may round another
    way than torch's)."""
    if offset == "near ties":
        x, c = kmeans.near_ties(k, 256, 24, 0)
    else:
        x, c = kmeans.make_data(n, d, k, 1)
        x, c = x + np.float32(offset), c + np.float32(offset)
    xt, ct = tensors_from_arrays(x, c, device=card)
    got, took = _routed_step(xt, ct)
    assert took == "kms_tc"
    want = ref.kmeans_step_tiled(xt, ct, ops.onehot_tiling(n, d, k, xt.device))
    stats = kmeans.reference_step(x, c)
    kmeans.check_step("kms_tc vs recipe", got, want, stats, 1e-4)
    kmeans.check_step("kms_tc vs f64", got, (stats.sums, stats.counts), stats, 1e-4)


def test_kmeans_step_duplicate_and_far_centroids_on_card(card):
    x, c = _clusters(4099, 8, 6, seed=5)
    c[4] = c[2]      # exact copy: its points go to index 2, index 4 counts 0
    c[5] = 1e4       # far from every point: an empty cluster
    xt, ct = tensors_from_arrays(x, c, device=card)
    sums, counts = ops.kmeans_step(xt, ct)
    assert counts[4] == 0 and counts[2] > 0 and counts[5] == 0
    assert bool((sums[4] == 0).all()) and bool((sums[5] == 0).all())
    _assert_step_agrees((sums, counts), ref.kmeans_step(xt, ct), x, c)


def test_kmeans_step_refuses_a_table_past_shared_memory_on_card(card):
    # 1024 centroids of width 64 and their norms: 266 KB, past the 227 KB
    # of opt-in shared memory
    x, c = _clusters(100, 64, 1024, seed=6)
    with pytest.raises(ValueError, match="do not fit"):
        ops.kmeans_step(*tensors_from_arrays(x, c, device=card))


@pytest.mark.parametrize("n,d,k", [
    (1003, 8, 16), (777, 1, 3),
    (5000, 64, 256),   # 64 KB of accumulators: dynamic shared memory
    (3000, 64, 1024),  # 256 KB: global atomics
])
def test_segsum_on_card(card, n, d, k):
    rng = np.random.default_rng(n)
    data = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-2, k + 2, n).astype(np.int32)  # some out of range
    ids[:5] = k - 1
    ids[ids == 1] = 0  # segment 1 stays empty
    dt, it = tensors_from_arrays(data, ids, device=card)
    got, want = ops.segsum(dt, it, k), ref.segsum(dt, it, k)
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=1e-4, atol=1e-4)
    assert bool((got[1] == 0).all())


def _segsum_check(got, data, ids, k):
    """The check of chip_smoke.py's check_segsum: rtol 1e-4 plus 1e-5 of the
    segment's Σ|x| (another order's rounding)."""
    want = ref.segsum(data, ids, k)
    scale = ref.segsum(data.abs(), ids, k)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-5 * scale).all())


@pytest.mark.parametrize("n,d,k,shift", [
    (1 << 20, 8, 16, (0, 0)), (1003, 8, 16, (0, 0)), (100, 8, 16, (0, 0)),
    (777, 1, 3, (0, 1)),      # starts 4 bytes into a 16-byte granule
    (3001, 3, 7, (5, 0)),     # rows of 12 bytes from row 5: 60 bytes in
    (4099, 8, 64, (0, 0)), (6000, 16, 32, (0, 2)), (2000, 32, 16, (0, 3)), (0, 8, 16, (0, 0)),
    (1000, 8, 65, (0, 0)), (1000, 33, 4, (0, 0)),  # past the range: the CUDA-core kernel
])
def test_segsum_routes_and_recipe_on_card(card, n, d, k, shift):
    """seg_tc where the shape lies in kms_tc's range, seg_main elsewhere;
    seg_tc against its recipe (ref.segsum_tiled on the kernel's tiling)
    and both against the plain version; ids out of range dropped, the same
    bits twice.  Against the recipe, rtol 1e-5 plus 4e-6 of Σ|x|: the
    tensor cores sum a warp's slice of a tile, at most 64 rows, in another
    order than torch's, at most 64 roundings of 2^-24."""
    rng = np.random.default_rng(n + d + k)
    data = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-2, k + 2, n).astype(np.int32)
    dt = _offset_view(data, card, *shift)
    it = torch.from_numpy(ids).to(card)
    before = dict(ops.SEGSUM_LAUNCHES)
    got = ops.segsum(dt, it, k)
    took = [r for r in ops.SEGSUM_LAUNCHES if ops.SEGSUM_LAUNCHES[r] != before[r]]
    inside = d <= 32 and k <= 64 and ((k + 15) // 16 * 16 if k <= 32 else 64) * (
        8 if d <= 8 else 16 if d <= 16 else 32) <= 512
    assert took == ["seg_tc" if inside else "seg_main"] == [ops.segsum_route(d, k)]
    torch.cuda.synchronize()
    _segsum_check(got, dt, it, k)
    if inside:
        recipe = ref.segsum_tiled(dt, it, k, ops.onehot_tiling(n, d, k, dt.device))
        scale = ref.segsum(dt.abs(), it, k)
        assert bool(((got - recipe).abs() <= 1e-5 * recipe.abs() + 4e-6 * scale).all())
        assert torch.equal(got, ops.segsum(dt, it, k))


# ---------------------------------------------------------------------------
# the same bits on every run (ROADMAP Queue 3 item 17)
# ---------------------------------------------------------------------------


def _summands(kind, n, buckets, seed):
    """Values and bucket ids: ``ordered`` puts a wide dynamic range (1e8,
    v, −1e8, … with v normal times 10^U(−4, 8)) into four buckets, where
    a sum's bits depend on the order of its adds; ``random`` spreads
    normal values over every bucket."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=n).astype(np.float32), rng.integers(0, buckets, n)
    v = (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 8, n)).astype(np.float32)
    m = 3 * (n // 3)
    v[:m] = np.where(np.arange(m) % 3 == 1, v[:m], np.tile(np.float32([1e8, 0, -1e8]), n // 3))
    return v, rng.integers(0, min(buckets, 4), n)


def _against_f64(got, v, g, buckets, bound):
    """Each sum within ``bound`` of the Σ|v| of its bucket from the f64 sum."""
    want, scale = np.zeros(buckets), np.zeros(buckets)
    np.add.at(want, g, v.astype(np.float64))
    np.add.at(scale, g, np.abs(v.astype(np.float64)))
    got = np.asarray(got, np.float64).reshape(want.shape)
    assert np.all(np.abs(got - want) <= bound * scale), float(np.max(np.abs(got - want) / scale))


def _grouped_sums(r, nb):
    s = torch.zeros(nb, dtype=torch.float32, device=r.valid.device)
    n = int(r.valid.sum())
    s[r.cols["g"][:n].long()] = r.cols["s"][:n]
    return s


@pytest.mark.parametrize("kind", ["ordered", "random"])
@pytest.mark.parametrize("route,nb", [("gsa_smem", 1000), ("gsa_global", 750_000),
                                      ("gja_smem", 1000), ("gja_global", 750_000)])
def test_grouped_atomic_routes_give_the_same_bits_twice_on_card(card, route, nb, kind):
    """The grouped kernels' atomic routes at 2^20 rows: the same bits on
    two calls, the sums bit for bit ``ref.fixed_sum`` of the rows (the
    kernel's integers at the kernel's scale), within 1e-6 of Σ|v| of the
    f64 sums (an f32 sum in any order may be off by n·2^-24 of it)."""
    n = 1 << 20
    v, g = _summands(kind, n, nb, seed=nb + len(kind))
    aggs = (AggSpec("sum", col("v"), "s"), AggSpec("min", col("v"), "m"),
            AggSpec("count", const(1), "c"))
    cols = {"g": torch.from_numpy(g.astype(np.int32)).to(card), "v": torch.from_numpy(v).to(card)}
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=card)  # noqa: E731
    if route.startswith("gsa"):
        args = (rt.VecTable(cols, ones(n)), None, ("g",), aggs, nb, ((0, nb - 1),), nb)
        fn = ops.grouped_select_agg
    else:
        m = 1 << 16
        fk = np.random.default_rng(7).integers(0, m + 100, n).astype(np.int32)  # some unmatched
        left = rt.VecTable(dict(cols, fk=torch.from_numpy(fk).to(card)), ones(n))
        right = rt.VecTable({"rk": torch.arange(m, dtype=torch.int32, device=card)}, ones(m))
        args = (left, right)
        fn = lambda l, r: ops.grouped_join_agg(  # noqa: E731
            l, r, left_on=("fk",), right_on=("rk",), join_key_domains=((0, m - 1),),
            join_num_buckets=m, keys=("g",), aggs=aggs, max_groups=nb,
            key_domains=((0, nb - 1),), num_buckets=nb)
        keep = fk < m
        v, g = v[keep], g[keep]
    (first, took), (second, _) = _routed(fn, *args), _routed(fn, *args)
    assert took == route
    for k in first.cols:
        assert torch.equal(first.cols[k], second.cols[k]), k
    sums = _grouped_sums(first, nb)
    assert torch.equal(sums.cpu(), ref.fixed_sum(torch.from_numpy(v), torch.from_numpy(g), nb,
                                                 rows=n))
    _against_f64(sums.cpu(), v, g, nb, 1e-6)


@pytest.mark.parametrize("kind", ["ordered", "random"])
@pytest.mark.parametrize("n,d,k", [(1 << 18, 8, 100), (5000, 64, 256), (3000, 64, 1024)])
def test_seg_main_gives_the_same_bits_twice_on_card(card, kind, n, d, k):
    """seg_main (shared accumulators, and global ones past the opt-in
    shared memory): the same bits twice, bit for bit ``ref.fixed_sum``."""
    rng = np.random.default_rng(n + k)
    data = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-2, k + 2, n).astype(np.int32)
    if kind == "ordered":
        data *= (10.0 ** rng.uniform(-4, 8, (n, 1))).astype(np.float32)
        ids = rng.integers(0, 3, n).astype(np.int32)
    dt, it = tensors_from_arrays(data, ids, device=card)
    assert ops.segsum_route(d, k) == "seg_main"
    got = ops.segsum(dt, it, k)
    assert torch.equal(got, ops.segsum(dt, it, k))
    assert torch.equal(got.cpu(), ref.fixed_sum(dt.cpu(), it.cpu(), k))
    _segsum_check(got, dt, it, k)


@pytest.mark.parametrize("kind", ["ordered", "random"])
def test_kms_main_gives_the_same_bits_twice_on_card(card, kind):
    """kms_main at d = 64, k = 256: the same sums and counts twice, and
    the sums bit for bit ``ref.fixed_sum`` of the points by the kernel's
    labels, where the plain version's labels agree with them."""
    n, d, k = 1 << 16, 64, 256
    x, c = _clusters(n, d, k, seed=5)
    if kind == "ordered":
        x *= (10.0 ** np.random.default_rng(1).uniform(-4, 8, (n, 1))).astype(np.float32)
        c = x[np.random.default_rng(2).choice(n, k, replace=False)].copy()
    xt, ct = tensors_from_arrays(x, c, device=card)
    (first, took), (second, _) = _routed_step(xt, ct), _routed_step(xt, ct)
    assert took == "kms_main"
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    labels = torch.argmin(ref.cdist2(xt, ct), dim=1)
    if torch.equal(torch.bincount(labels, minlength=k).float(), first[1]):
        assert torch.equal(first[0].cpu(), ref.fixed_sum(xt.cpu(), labels.cpu(), k))
    _assert_step_agrees(first, ref.kmeans_step(xt, ct), x, c)


@pytest.mark.parametrize("kind", ["ordered", "random"])
def test_segment_sum_gives_the_same_bits_twice_on_card(card, kind):
    """``runtime._segment_sum`` (the sorted tiers' and the plain direct
    tier's sums) on the card: the same bits twice, bit for bit
    ``runtime.fixed_sum`` (which it runs there), within 2e-4 of Σ|v| of
    the f64 sums (the query tolerance)."""
    n = 1 << 20
    v, g = _summands(kind, n, 7, seed=3)
    vt, gt = torch.from_numpy(v).to(card), torch.from_numpy(g).to(card)
    got = rt._segment_sum(vt, gt, 7)
    assert torch.equal(got, rt._segment_sum(vt, gt, 7))
    assert torch.equal(got.cpu(), ref.fixed_sum(vt.cpu(), gt.cpu(), 7))
    _against_f64(got.cpu(), v, g, 7, 2e-4)


def test_kmeans_program_on_card_matches_cpu(card):
    n, d, k = 1 << 16, 8, 16
    x, c = _clusters(n, d, k, seed=9)
    before = ops.LAUNCHES["kmeans_step"]
    got = LocalBackend(device=card).compile(kmeans.program(n, d, k, parallel=8))({}, x, c)
    assert ops.LAUNCHES["kmeans_step"] == before + 8
    _assert_step_agrees(got, LocalBackend(device="cpu").compile(kmeans.program(n, d, k))(
        {}, x, c), x, c)


def _attention_inputs(card, b, hq, hkv, s, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(b, h, s, d)), dtype=dtype, device=card)
            for h in (hq, hkv, hkv)]


def _assert_attention_close(got, want, v):
    """bf16: within two bf16 roundings plus 1e-3 of max|v|; f32: rtol 1e-4,
    atol 1e-5 (the kernel adds its products in another order)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float().cpu(), want.float().cpu()
    if want.dtype == torch.bfloat16:
        bound = 2.0 ** -7 * w.abs() + 1e-3 * float(v.float().abs().max())
        assert bool(((g - w).abs() <= bound).all()), float((g - w).abs().max())
    else:
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s,d,group,dtype,causal,window,scale", [
    (1, 128, 6, torch.bfloat16, True, None, None),
    (77, 32, 1, torch.float32, True, None, None),
    (77, 64, 6, torch.bfloat16, False, None, None),
    (200, 128, 6, torch.float32, True, 64, None),
    (200, 64, 1, torch.bfloat16, False, 128, 0.3),
    (2048, 128, 6, torch.bfloat16, True, None, None),
    (2048, 32, 1, torch.float32, True, 128, 0.05),
    (129, 128, 48, torch.bfloat16, True, None, None),   # granite's MQA group
    # the tensor-core kernel around its 128-row tiles, long, windowed, narrow
    (127, 128, 6, torch.bfloat16, True, None, None),
    (128, 128, 6, torch.bfloat16, True, None, None),
    (129, 64, 1, torch.bfloat16, True, None, None),
    (4096, 128, 6, torch.bfloat16, True, None, None),
    (2048, 128, 6, torch.bfloat16, True, 128, None),
    (200, 32, 6, torch.bfloat16, True, None, None),
])
def test_flash_attention_on_card(card, s, d, group, dtype, causal, window, scale):
    q, k, v = _attention_inputs(card, 2, 2 * group, 2, s, d, dtype, seed=s + d + group)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window, sm_scale=scale)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.cuda.synchronize()
    _assert_attention_close(got, ref.flash_attention(q, k, v, causal=causal, window=window,
                                                     sm_scale=scale), v)


@pytest.mark.parametrize("s,group", [(1, 1), (200, 4), (2048, 1), (2048, 4)])
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_at_d112_on_card(card, dtype, window, s, group):
    """D = 112 (Zamba2-7B's shared attention): bf16 on the tensor cores in
    the D = 128 tile zero-filled by TMA, f32 on the CUDA cores; causal and
    windowed, S = 1, ragged and 2048."""
    q, k, v = _attention_inputs(card, 2, 2 * group, 2, s, 112, dtype, seed=s + group)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.cuda.synchronize()
    _assert_attention_close(got, ref.flash_attention(q, k, v, causal=True, window=window), v)


def _device_kernel_names(fn, windows=6, pad_s=2.0):
    """The device kernels ``fn`` launches, from torch.profiler: windows
    padded with idle seconds (a short window can lose its kernels on the
    card's machine), the first after a warm-up window that kept any."""
    import time

    from torch.profiler import ProfilerActivity, profile

    names = set()
    for window in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
        names = {e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and getattr(e, "self_device_time_total", 0) > 0}
        if names and window:
            break
    return names


def test_flash_attention_at_d112_runs_the_tensor_core_kernel_on_card(card):
    """The profiler shows ``fa_wgmma`` (not ``fa_main``) for a bf16 call at
    D = 112, and ``fa_main`` for an f32 one."""
    for dtype, want, not_want in ((torch.bfloat16, "fa_wgmma", "fa_main"),
                                  (torch.float32, "fa_main", "fa_wgmma")):
        q, k, v = _attention_inputs(card, 1, 4, 4, 256, 112, dtype, seed=3)
        names = _device_kernel_names(lambda: [ops.flash_attention(q, k, v) for _ in range(3)])
        assert any(want in n for n in names) and not any(not_want in n for n in names), names


def test_flash_attention_refuses_what_it_does_not_take_on_card(card):
    q, k, v = _attention_inputs(card, 1, 4, 2, 64, 48, torch.float32, seed=1)
    with pytest.raises(ValueError, match="D in"):
        ops.flash_attention(q, k, v)
    q, k, v = _attention_inputs(card, 1, 4, 2, 64, 64, torch.float32, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="kv heads"):
        ops.flash_attention(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1))


def test_serve_wave_on_card_matches_plain_attention(card):
    """The reduced Qwen2 (f32) served on the card: the kernel's path and the
    plain path give the same greedy tokens, and the kernel ran once per
    layer per wave."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import Request, make_run_wave, serve_loop
    from repro_torch.models.api import build_model

    cfg = get_reduced("qwen2-1.5b")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (8, 16))
    outs = {}
    for mode in ("pallas", "ref"):
        model = build_model(dataclasses.replace(cfg, attn_mode=mode))
        params = model.init(torch.Generator(card).manual_seed(0))
        run_wave = make_run_wave(model, params, batch=4, prompt_len=16, gen=4, cache_cap=24,
                                 device=card)
        before = ops.LAUNCHES["flash_attention"]
        outs[mode] = serve_loop([Request(rid=i, prompt=prompts[i]) for i in range(8)],
                                run_wave, batch=4)
        launched = ops.LAUNCHES["flash_attention"] - before
        assert launched == (2 * cfg.n_layers if mode == "pallas" else 0)
    assert sorted(outs["pallas"]) == list(range(8))
    for rid, toks in outs["ref"].items():
        np.testing.assert_array_equal(outs["pallas"][rid], toks)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------


def test_pallas_attention_refuses_grad_on_card(card):
    """Under grad the kernel refuses on the card as on the CPU, rather than
    return an output with no gradient; under no_grad it launches."""
    q = torch.randn(1, 2, 64, 64, device=card, requires_grad=True)
    with pytest.raises(ValueError, match="forward-only"):
        ops.attention(q, q, q, mode="pallas")
    before = ops.LAUNCHES["flash_attention"]
    with torch.no_grad():
        ops.attention(q, q, q, mode="pallas")
    assert ops.LAUNCHES["flash_attention"] == before + 1


def _loss_and_grads(model, params, batch, microbatch=1):
    from repro_torch.models.api import make_train_step
    from repro_torch.train.optimizer import Optimizer

    step, _ = make_train_step(model, Optimizer(lambda p: {}, lambda g, st, p: (g, st)),
                              microbatch=microbatch)
    grads, _, met = step(params, {}, batch)
    return float(met["loss"]), grads


def test_train_gradients_on_card_match_cpu(card):
    """The reduced Qwen2 (f32, remat on) on the card against the same code
    on the CPU: loss rtol 1e-5, each gradient leaf ‖Δ‖/‖g‖ ≤ 1e-4 (full-f32
    products: TF32 off)."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import tree_leaves, tree_map

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = build_model(dataclasses.replace(get_reduced("qwen2-1.5b"), remat=True,
                                                loss_chunk=32))
        params = model.init(torch.Generator(card).manual_seed(0))
        batch = TokenPipeline(vocab=model.cfg.vocab, seq_len=64, global_batch=4).batch_at(0)
        got = _loss_and_grads(model, params, {k: torch.from_numpy(v).to(card)
                                              for k, v in batch.items()}, microbatch=2)
        want = _loss_and_grads(model, tree_map(lambda t: t.cpu(), params),
                               {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    for g, w in zip(tree_leaves(got[1]), tree_leaves(want[1])):
        assert g.device.type == "cuda"
        rel = torch.linalg.vector_norm(g.cpu() - w) / torch.linalg.vector_norm(w)
        assert rel <= 1e-4


def test_bf16_checkpoint_round_trip_on_card(card, tmp_path):
    from repro_torch.distributed import CheckpointManager

    tree = {"w": torch.randn(5, 7, device=card).to(torch.bfloat16),
            "m": torch.randn(5, 7, device=card), "step": torch.tensor(4, device=card,
                                                                      dtype=torch.int32)}
    CheckpointManager(tmp_path, n_shards=2).save(4, tree, extra={"step": 4})
    got, extra = CheckpointManager(tmp_path).restore(
        {k: torch.zeros_like(v) for k, v in tree.items()})
    assert extra == {"step": 4}
    for k, v in tree.items():
        assert got[k].device == v.device and got[k].dtype == v.dtype
        assert torch.equal(got[k], v), k


def test_step_runner_times_the_device_on_card(card, tmp_path):
    """A step's recorded seconds cover its device work (CUDA events), not
    only the launches."""
    from repro_torch.distributed import CheckpointManager, StepRunner

    a = torch.randn(4096, 4096, device=card)

    def step_fn(x, batch):
        for _ in range(40):
            x = torch.tanh(a @ x)
        return x, {"loss": x.sum()}

    step_fn(a, None)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    step_fn(a, None)
    end.record()
    torch.cuda.synchronize()
    device_s = start.elapsed_time(end) / 1e3
    runner = StepRunner(step_fn, CheckpointManager(tmp_path, n_shards=1), ckpt_every=100)
    runner.run((a,), iter(lambda: None, 1), num_steps=3)
    assert min(h.seconds for h in runner.history) >= 0.8 * device_s


def test_train_driver_on_card(card, tmp_path):
    from repro_torch.launch import train as train_mod

    common = ["--arch", "qwen2-1.5b", "--reduced", "--device", card, "--batch", "4",
              "--seq", "32", "--ckpt-dir", str(tmp_path)]
    losses = train_mod.main(common + ["--steps", "12", "--ckpt-every", "6"])
    assert losses[-1] < losses[0]
    losses2 = train_mod.main(common + ["--steps", "4", "--ckpt-every", "100", "--resume"])
    assert losses2[0] < losses[0]


# ---------------------------------------------------------------------------
# the MoE and VLM families on the card
# ---------------------------------------------------------------------------


def _moe_inputs(card, dtype, seed=0, t=2048, d=256, f=128, e=64):
    """Layer weights as ``init_moe`` makes them (the router f32) and
    rmsnorm-scaled rows (B=4), from a seed."""
    from repro_torch.models import layers

    gen = torch.Generator(card).manual_seed(seed)
    p = layers.init_moe(gen, d, f, e, dtype=dtype)
    x = torch.randn((4, t // 4, d), generator=gen, device=card).to(dtype)
    return p, x


def test_moe_block_gives_the_same_bits_twice_on_card(card):
    """bf16 at Moonlight's 64 experts, top-6, capacity 1.25 (choices
    dropped): the dispatch places unique slots and the combine adds in k
    order, so no atomic sum makes two runs differ."""
    from repro_torch.models import layers

    p, x = _moe_inputs(card, torch.bfloat16)
    kw = dict(n_experts=64, top_k=6, capacity_factor=1.25)
    (y1, a1), (y2, a2) = layers.moe_block(p, x, **kw), layers.moe_block(p, x, **kw)
    assert y1.dtype == torch.bfloat16 and y1.device.type == torch.device(card).type
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
    assert torch.equal(a1.view(torch.int32), a2.view(torch.int32))
    *_, keep = layers.moe_route(p, x.reshape(-1, x.shape[-1]), n_experts=64, top_k=6,
                                capacity=layers.moe_capacity(2048, 6, 64, 1.25))
    assert not bool(keep.all())


def test_moe_block_f32_matches_f64_on_card(card):
    """f32 on the card against the same function in f64 on the card (TF32
    off): the same routing wherever the f64 top-k margin is above 1e-5, the
    agreeing tokens' outputs within ‖Δ‖ ≤ 1e-5·‖y‖, aux rtol 1e-5."""
    from repro_torch.models import layers

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p, x = _moe_inputs(card, torch.float32, seed=1)
        p64 = {k: v.double() for k, v in p.items()}
        kw = dict(n_experts=64, top_k=6, capacity_factor=1.25)
        y32, a32 = layers.moe_block(p, x, **kw)
        y64, a64 = layers.moe_block(p64, x.double(), **kw)
        cap = layers.moe_capacity(2048, 6, 64, 1.25)
        r32 = layers.moe_route(p, x.reshape(2048, -1), n_experts=64, top_k=6, capacity=cap)
        r64 = layers.moe_route(p64, x.double().reshape(2048, -1), n_experts=64, top_k=6,
                               capacity=cap)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert r64[0].dtype == torch.float64 and y64.dtype == torch.float64
    sets32, sets64 = r32[2].sort(-1).values, r64[2].sort(-1).values
    same = (sets32 == sets64).all(-1)
    top = r64[0].sort(-1, descending=True).values
    margin = top[:, 5] - top[:, 6]
    assert bool((margin[~same] <= 1e-5).all())
    agree = same & (r32[4].view(2048, 6) == r64[4].view(2048, 6)).all(-1)
    assert int(agree.sum()) >= 2000
    a, b = y32.reshape(2048, -1)[agree].double(), y64.reshape(2048, -1)[agree]
    assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) <= 1e-5
    assert abs(float(a32) - float(a64)) <= 1e-5 * abs(float(a64))


def test_moe_and_vlm_serve_waves_on_card(card):
    """The reduced Moonlight and Qwen2-VL (f32) served on the card: the
    kernel's path and the plain path give the same greedy tokens, the
    kernel once per layer per prefilled wave (the VLM's waves decode from an
    empty cache and launch none)."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import Request, make_run_wave, serve_loop
    from repro_torch.models.api import build_model

    for arch in ("moonshot-v1-16b-a3b", "qwen2-vl-7b"):
        cfg = get_reduced(arch)
        prompts = np.random.default_rng(0).integers(0, cfg.vocab, (8, 16))
        outs = {}
        for mode in ("pallas", "ref"):
            model = build_model(dataclasses.replace(cfg, attn_mode=mode))
            params = model.init(torch.Generator(card).manual_seed(0))
            run_wave = make_run_wave(model, params, batch=4, prompt_len=16, gen=4,
                                     cache_cap=24, device=card)
            before = ops.LAUNCHES["flash_attention"]
            outs[mode] = serve_loop([Request(rid=i, prompt=prompts[i]) for i in range(8)],
                                    run_wave, batch=4)
            launched = ops.LAUNCHES["flash_attention"] - before
            prefilled = mode == "pallas" and cfg.family == "moe"
            assert launched == (2 * cfg.n_layers if prefilled else 0), arch
        assert sorted(outs["pallas"]) == list(range(8))
        for rid, toks in outs["ref"].items():
            np.testing.assert_array_equal(outs["pallas"][rid], toks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_prefill_on_card_launches_the_kernel_and_matches_plain(card, dtype):
    """The reduced Zamba2 at Zamba2-7B's head width (d_head 112) prefilled
    on the card with attn_mode "pallas": flash_attention once per attention
    point (fa_main in f32, fa_wgmma in bf16); the f32 logits and state
    within tests/test_models_smoke.py's 2e-3 of the plain attention's, the
    bf16 ones finite (its rounding grows through the Mamba layers)."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_reduced("zamba2-7b"), d_head=112, n_heads=2, n_kv_heads=2,
                              dtype=dtype)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 200))).to(card)
    params = build_model(cfg).init(torch.Generator(card).manual_seed(0))
    outs = {}
    for mode in ("pallas", "ref"):
        before = ops.LAUNCHES["flash_attention"]
        with torch.inference_mode():
            outs[mode] = build_model(dataclasses.replace(cfg, attn_mode=mode)).prefill(
                params, {"tokens": toks[:, :192]}, 208)
        assert ops.LAUNCHES["flash_attention"] - before == (
            cfg.n_attn_points if mode == "pallas" else 0)
    (lp, sp), (lr, sr) = outs["pallas"], outs["ref"]
    assert bool(torch.isfinite(lp).all())
    if dtype == "float32":
        torch.testing.assert_close(lp, lr, rtol=2e-3, atol=2e-3)
        for key in ("conv", "ssm", "k", "v"):
            torch.testing.assert_close(sp[key], sr[key], rtol=2e-3, atol=2e-3, msg=key)


def test_hybrid_and_rwkv_serve_waves_on_card(card):
    """The reduced Zamba2 and RWKV6 (f32) served on the card through
    make_run_wave's else branch: no prefill and no kernel launch, and every
    request the same tokens (each wave decodes from the same empty state
    and zero token)."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import Request, make_run_wave, serve_loop
    from repro_torch.models.api import build_model

    for arch in ("zamba2-7b", "rwkv6-1.6b"):
        cfg = get_reduced(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator(card).manual_seed(0))
        prompts = np.random.default_rng(0).integers(0, cfg.vocab, (8, 16))
        run_wave = make_run_wave(model, params, batch=4, prompt_len=16, gen=4, cache_cap=24,
                                 device=card)
        before = dict(ops.LAUNCHES)
        out = serve_loop([Request(rid=i, prompt=prompts[i]) for i in range(8)], run_wave,
                         batch=4)
        assert ops.LAUNCHES == before, arch
        assert sorted(out) == list(range(8)), arch
        for toks in out.values():
            np.testing.assert_array_equal(toks, out[0])


# ---------------------------------------------------------------------------
# the enc-dec family on the card (Whisper-base)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,dtype", [(16, torch.bfloat16), (2, torch.float32)])
def test_flash_attention_non_causal_at_whisper_encoders_shape_on_card(card, b, dtype):
    """Whisper-base's encoder call: (B, 8, 1500, 64), group 1, non-causal,
    1500 frames a multiple of no tile (every kv tile visited, the last
    partial); bf16 on the tensor cores, f32 on the CUDA cores."""
    q, k, v = _attention_inputs(card, b, 8, 8, 1500, 64, dtype, seed=15)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=False)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.cuda.synchronize()
    _assert_attention_close(got, ref.flash_attention(q, k, v, causal=False), v)


def _whisper_cut(dtype, **over):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("whisper-base"), n_layers=2, n_enc_layers=2,
                               dtype=dtype, **over)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_encoder_pallas_matches_plain_on_card(card, dtype):
    """Whisper-base's widths at 2 encoder layers, 2 × 1500 frames: the
    encoder with attn_mode "pallas" launches flash_attention once a layer
    and gives the plain attention's states: f32 within rtol/atol 1e-4, bf16
    within 2⁻⁵ of their largest magnitude (tests/test_torch_whisper.py's
    bf16 rule)."""
    import dataclasses

    from repro_torch.models import whisper
    from repro_torch.models.api import build_model

    cfg = _whisper_cut(dtype)
    params = build_model(cfg).init(torch.Generator(card).manual_seed(0))
    frames = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 1500, cfg.d_model))
                              .astype(np.float32)).to(card)
    outs = {}
    for mode in ("pallas", "ref"):
        before = ops.LAUNCHES["flash_attention"]
        with torch.inference_mode():
            outs[mode] = whisper.encode(params, dataclasses.replace(cfg, attn_mode=mode), frames)
        assert ops.LAUNCHES["flash_attention"] - before == (
            cfg.n_enc_layers if mode == "pallas" else 0)
    got, want = outs["pallas"].float().cpu(), outs["ref"].float().cpu()
    assert bool(torch.isfinite(got).all())
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert float((got - want).abs().max()) <= 2.0 ** -5 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen2-vl-7b", "zamba2-7b",
                                  "rwkv6-1.6b"])
def test_two_train_steps_of_each_family_on_card_match_cpu(card, arch):
    """Two AdamW steps of the reduced MoE, VLM, hybrid and RWKV configs (f32,
    remat on; the VLM on the launcher's stub embeddings and positions3),
    each taken on the card and on the CPU from the CPU's parameters and
    state before it: the loss rtol 1e-5, the new parameters by
    tests/test_torch_train.py's update rule (‖Δ‖ ≤ 2e-3·‖u‖ + 1e-2·lr·√n
    per leaf, u the CPU's update: AdamW sends g/(|g| + 1e-8), so a
    gradient element near 1e-8 moves its update by up to lr, and a second
    step from the card's own parameters would start that far apart),
    full-f32 products (TF32 off).  Then the card's own second step, from
    its own first step's state, against the CPU's step from that state:
    the loss rtol 1e-5 (the two trajectories part by that first step's
    rounding, which AdamW amplifies within the update rule above, and not
    by the card's second step)."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.train.optimizer import AdamW, tree_leaves, tree_map

    lr = 3e-3
    model = build_model(dataclasses.replace(get_reduced(arch), remat=True, loss_chunk=16))
    step, opt = make_train_step(model, AdamW(lr=lr))
    params0 = params = model.init(torch.Generator().manual_seed(0))
    state0 = state = opt.init(params)
    pipe = TokenPipeline(vocab=model.cfg.vocab, seq_len=32, global_batch=2, seed=0)
    to_card = lambda tree: tree_map(lambda t: t.to(card) if isinstance(t, torch.Tensor) else t,
                                    tree)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(2):
            got_p, _, got = step(to_card(params), to_card(state),
                                 make_batch_fn(model.cfg, pipe, card)(i))
            new_p, state, want = step(params, state, make_batch_fn(model.cfg, pipe, "cpu")(i))
            g, w = float(got["loss"]), float(want["loss"])
            assert abs(g - w) <= 1e-5 * abs(w), (i, g, w)
            for a, b, p0 in zip(tree_leaves(got_p), tree_leaves(new_p), tree_leaves(params)):
                assert a.device.type == "cuda"
                u = (b - p0).double()
                d = (a.cpu() - b).double()
                assert float(d.norm()) <= 2e-3 * float(u.norm()) + 1e-2 * lr * u.numel() ** 0.5
            params = new_p

        to_cpu = lambda tree: tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                                       tree)
        batch_at = {dev: make_batch_fn(model.cfg, pipe, dev) for dev in (card, "cpu")}
        p1, s1, _ = step(to_card(params0), to_card(state0), batch_at[card](0))
        _, _, got = step(p1, s1, batch_at[card](1))
        _, _, want = step(to_cpu(p1), to_cpu(s1), batch_at["cpu"](1))
        g, w = float(got["loss"]), float(want["loss"])
        assert abs(g - w) <= 1e-5 * abs(w), (g, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_whisper_train_step_on_card_matches_host_f64(card):
    """A Whisper-base train step (AdamW, remat, chunked attention) at its
    widths and 2 + 2 layers in f32 on the card: its loss finite and within
    rtol 1e-5 of the same step's in f64 on the host (TF32 off), and the
    updated parameters finite."""
    import dataclasses

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.train.optimizer import AdamW, tree_leaves, tree_map

    cfg = _whisper_cut("float32")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=0)
    init = build_model(cfg).init(torch.Generator(card).manual_seed(0))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        losses = {}
        for dev, dtype in ((card, "float32"), ("cpu", "float64")):
            model = build_model(dataclasses.replace(cfg, dtype=dtype))
            params = tree_map(lambda t: t.to(dev, getattr(torch, dtype)), init)
            step, opt = make_train_step(model, AdamW(lr=3e-3))
            new, _, met = step(params, opt.init(params), make_batch_fn(cfg, pipe, dev)(0))
            losses[dev] = float(met["loss"])
            assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert np.isfinite(losses[card])
    assert abs(losses[card] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])


# ---------------------------------------------------------------------------
# the compile driver on the card: cost search, the fallback ladder, taps
# ---------------------------------------------------------------------------


def _by_keys(d):
    keys = [k for k in d if np.asarray(d[k]).ndim and np.asarray(d[k]).dtype.kind in "iu"]
    if not keys or len(np.asarray(d[keys[0]])) < 2:
        return {k: np.asarray(v) for k, v in d.items()}
    order = np.lexsort([np.asarray(d[k]) for k in reversed(keys)])
    return {k: np.asarray(v)[order] for k, v in d.items()}


def test_cost_chosen_plan_equals_the_forced_plan_on_card(card):
    """The plan the cost search picks answers as the same strategy forced."""
    from repro_torch.compiler import PlanCache

    ctx = tpch.make_context(tpch.generate(sf=0.05, seed=1))
    for q, f in tpch.QUERIES.items():
        res = ctx.compile(f(ctx), device=card, optimize="cost", cache=PlanCache())
        chosen = dict(res.strategy)
        got = _by_keys(f(ctx).collect(device=card, optimize="cost", cache=PlanCache()))
        want = _by_keys(f(ctx).collect(device=card, strategy=chosen, cache=PlanCache()))
        for k in want:
            if want[k].dtype.kind == "f":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"{q}.{k}")
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{q}.{k}")


def test_injected_execute_fault_recovers_on_card(card):
    """One injected execute fault walks the ladder on the card (the first
    rung, groupby=sorted, runs there) and gives the numpy reference's Q1."""
    import warnings

    from repro_torch.compiler import PlanCache
    from repro_torch.obs import DegradedWarning
    from repro_torch.robust.inject import inject

    tables = tpch.generate(sf=0.05, seed=1)
    ctx = tpch.make_context(tables)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with inject("backend.execute", times=1):
            res = ctx.compile(tpch.q1(ctx), device=card, cache=PlanCache())
            (out,) = res(ctx.sources(card))
    assert res.degraded == ("groupby=sorted",) and res.target == "local"
    assert any(issubclass(w.category, DegradedWarning) for w in caught)
    got, want = _by_keys(out.to_numpy()), _by_keys(tpch.REFERENCES["q1"](tables))
    np.testing.assert_array_equal(got["count_order"], want["count_order"])
    np.testing.assert_allclose(got["sum_qty"], want["sum_qty"], rtol=2e-4)


def test_traced_cardinalities_equal_the_cpus(card):
    """A traced run on the card measures each tapped operator's rows as the
    same plan's run on the CPU does."""
    from repro_torch.compiler import PlanCache
    from repro_torch.obs import tracing

    ctx = tpch.make_context(tpch.generate(sf=0.05, seed=1))
    for q, f in tpch.QUERIES.items():
        profiles = []
        for dev in (card, "cpu"):
            with tracing():
                res = ctx.compile(f(ctx), device=dev, cache=PlanCache())
                res(ctx.sources(dev))
            profiles.append({o.key: (o.occurrences, o.rows_in, o.rows_out)
                             for o in res.profile.observations})
        assert profiles[0] == profiles[1], q


@pytest.mark.parametrize("fault", ["refused", "oom"])
def test_kernel_path_failure_raises_on_card(card, fault, monkeypatch):
    """On the card a wrapper that refuses its inputs (its own bucket check)
    or runs out of memory raises KernelLaunchError under guard=True: no
    rung is walked, so neither the plain version nor the host answers."""
    import warnings

    from repro_torch.compiler import PlanCache
    from repro_torch.errors import KernelLaunchError
    from repro_torch.obs import DegradedWarning

    real = ops.grouped_select_agg

    def failing(t, pred, keys, aggs, mg, domains, nb):
        if fault == "refused":
            return real(t, pred, keys, aggs, mg, domains, nb + 1)
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(ops, "grouped_select_agg", failing)
    ctx = tpch.make_context(tpch.generate(sf=0.01, seed=1))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DegradedWarning)
        with pytest.raises(KernelLaunchError):
            tpch.q1(ctx).collect(device=card, cache=PlanCache(), guard=True)


# ---------------------------------------------------------------------------
# the stream target on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_stream_fold_on_card_matches_cpu(card, q):
    """Q1 and Q6 streamed in 4,096-row batches from the host through a
    StreamConsumer on the card (one kernel launch a batch plus
    init_state's) answer as the same fold on the CPU."""
    from repro_torch.compiler import PlanCache
    from repro_torch.frontends.dataflow import _to_numpy
    from repro_torch.launch.serve import StreamConsumer, microbatches

    ctx = tpch.make_context(tpch.generate(sf=0.05, seed=1))
    batches = microbatches(ctx.tables["lineitem"], 4096)
    outs = {}
    for dev in (card, "cpu"):
        res = ctx.compile(tpch.QUERIES[q](ctx), target="stream", stream_table="lineitem",
                          batch_rows=4096, device=dev, cache=PlanCache())
        before = dict(ops.LAUNCHES)
        c = StreamConsumer(res, ctx.sources(dev))
        for mb in batches:
            c.process(mb)
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before if ops.LAUNCHES[k] != before[k]}
        outs[dev] = _by_keys(_to_numpy(c.results()[0]))
        if dev == card:
            kname = "grouped_select_agg" if q == "q1" else "fused_select_agg"
            assert launched == {kname: len(batches) + 1}
    for k, want in outs["cpu"].items():
        if want.dtype.kind == "f":
            np.testing.assert_allclose(outs[card][k], want, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(outs[card][k], want, err_msg=k)


# ---------------------------------------------------------------------------
# the spmd target: two gloo ranks sharing the card
# ---------------------------------------------------------------------------

#: two ranks on ``cuda:0`` over gloo: Q1 and Q6 at sf=0.01 under both
#: grouped recombines, and one ``mesh.ExchangeByKey`` of a seeded table
#: against the numpy partition (each rank checks its own block)
SPMD_CARD_SCRIPT = '''
import datetime, json, os
import numpy as np
import torch.distributed as dist

dist.init_process_group("gloo", init_method="file://" + os.environ["INIT_FILE"],
                        rank=int(os.environ["RANK"]),
                        world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=120))

from repro_torch.backends import spmd
from repro_torch.convert import vectable_from_arrays
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.relational import tpch

rank, n_ranks = dist.get_rank(), dist.get_world_size()
ctx = tpch.make_context(tpch.generate(sf=0.01, seed=0))
out = {"launches": {}}
for q in ("q1", "q6"):
    for label in ("gather", "exchange"):
        ops.reset_launches()
        got = tpch.QUERIES[q](ctx).collect(target="spmd", parallel=n_ranks,
                                           strategy={"grouped-recombine": label})
        out[q + "/" + label] = {k: np.asarray(v).ravel().tolist() for k, v in got.items()}
        out["launches"][q + "/" + label] = dict(ops.LAUNCHES)

mesh = make_mesh((n_ranks,), ("workers",))
rng = np.random.default_rng(3)
n = 4096
keys = [rng.integers(-50, 1000, n).astype(np.int32) for _ in range(n_ranks)]
xs = [rng.normal(size=n).astype(np.float32) for _ in range(n_ranks)]
valid = [rng.random(n) < 0.8 for _ in range(n_ranks)]
got = spmd.exchange_by_key(spmd.Collectives(mesh), vectable_from_arrays(
    {"k": keys[rank], "x": xs[rank]}, valid[rank], device=mesh.device), "k", n_ranks, 2.0)
per = n
want_k, want_x, want_v = [], [], []
for j in range(n_ranks):
    mine = valid[j] & ((keys[j].astype(np.int64) & 0xFFFFFFFF) % n_ranks == rank)
    k, x = keys[j][mine][:per], xs[j][mine][:per]
    pad = per - len(k)
    want_k.append(np.concatenate([k, np.zeros(pad, np.int32)]))
    want_x.append(np.concatenate([x, np.zeros(pad, np.float32)]))
    want_v.append(np.arange(per) < len(k))
out["exchange_device"] = str(got.valid.device)
out["exchange_ok"] = bool(
    np.array_equal(got.cols["k"].cpu().numpy(), np.concatenate(want_k))
    and np.array_equal(got.cols["x"].cpu().numpy(), np.concatenate(want_x))
    and np.array_equal(got.valid.cpu().numpy(), np.concatenate(want_v)))
out["calls"] = dict(spmd.CALLS)
print("RESULTS" + json.dumps(out))
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def spmd_on_card(tmp_path_factory):
    """Two rank processes sharing the card over gloo, once per module."""
    import json
    import os
    from pathlib import Path

    from repro_torch.launch.hermetic import run_ranks

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (no CUDA device is visible)")
    root = Path(__file__).resolve().parents[1]
    passed = {k: os.environ[k] for k in ("CUDA_HOME", "LD_LIBRARY_PATH",
                                         "REPRO_TORCH_BUILD_DIR") if k in os.environ}
    ranks = run_ranks(SPMD_CARD_SCRIPT, 2, tmp_path_factory.mktemp("spmd_card"), root,
                      timeout=600, **passed)
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
    line = [ln for ln in ranks[0][1].splitlines() if ln.startswith("RESULTS")][0]
    return json.loads(line[len("RESULTS"):])


@pytest.mark.parametrize("label", ["gather", "exchange"])
@pytest.mark.parametrize("q", ["q1", "q6"])
def test_spmd_two_ranks_on_one_card_match_numpy(spmd_on_card, q, label):
    """Q1 and Q6 at sf=0.01 across two ranks on ``cuda:0`` answer as numpy
    does, each rank launching its query's kernel on its chunk."""
    keys = ("l_returnflag", "l_linestatus") if q == "q1" else ()
    got = spmd_on_card[f"{q}/{label}"]
    want = tpch.REFERENCES[q](tpch.generate(sf=0.01, seed=0))
    order_g = np.lexsort([np.asarray(got[k]) for k in reversed(keys)]) if keys else [0]
    order_w = np.lexsort([want[k] for k in reversed(keys)]) if keys else [0]
    for k, w in want.items():
        g, w = np.asarray(got[k])[order_g], np.asarray(w).ravel()[order_w]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=2e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    kname = "grouped_select_agg" if q == "q1" else "fused_select_agg"
    assert spmd_on_card["launches"][f"{q}/{label}"][kname] >= 1


def test_exchange_by_key_on_card_matches_numpy_partition(spmd_on_card):
    """Each rank's block of an exchange on the card is the numpy partition:
    key mod 2 as uint32, the rows of each source rank in their order."""
    assert spmd_on_card["exchange_device"].startswith("cuda")
    assert spmd_on_card["exchange_ok"]
    assert spmd_on_card["calls"]["all_to_all"] >= 2


def test_one_rank_mesh_places_the_tree_on_card_and_keeps_the_steps_bits(card, tmp_path):
    """``placements`` and ``shard_tree`` put the reduced Qwen2's tree on the
    card as DTensors of a one-rank (data 1, model 1) mesh over a gloo group,
    and the step on them (microbatch 2, the ZeRO-2 constraint, AdamW) gives
    the plain step's bits: loss and every new parameter."""
    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.train.optimizer import AdamW, tree_leaves

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        model = build_model(get_reduced("qwen2-1.5b"))
        params = model.init(torch.Generator(card).manual_seed(0))
        mesh = Mesh(dist.group.WORLD, (0,), ("data", "model"), (1, 1), torch.device(card, 0),
                    "gloo")
        dm = shd.device_mesh(mesh)
        pspecs = shd.tree_param_specs(params, mesh)
        placed = shd.shard_tree(params, pspecs, dm)

        def check(spec, t):
            assert t.to_local().device.type == "cuda"
            assert tuple(t.placements) == shd.placements(dm, spec)

        shd._map_specs(check, pspecs, placed)
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(rng.integers(0, 512, (4, 32)).astype(np.int32)),
                 "labels": torch.from_numpy(rng.integers(0, 512, (4, 32)).astype(np.int32)),
                 "mask": torch.ones((4, 32), dtype=torch.float32)}
        batch = {k: v.to(card) for k, v in batch.items()}
        opt = AdamW(lr=3e-3)
        state = opt.init(params)
        ospecs = shd.tree_opt_specs(state, pspecs, mesh)
        bspecs = shd.batch_specs({k: (v.shape, v.dtype) for k, v in batch.items()}, mesh)
        gspecs = shd.tree_grad_specs(params, pspecs, mesh)
        sharded, _ = make_train_step(model, shd.zero1_optimizer(opt, pspecs, ospecs, dm),
                                     microbatch=2,
                                     grad_constraint=lambda g: shd.redistribute_tree(g, gspecs, dm))
        plain, _ = make_train_step(model, opt, microbatch=2)
        with shd.dtensor_scope(placed):
            got = sharded(placed, shd.shard_tree(state, ospecs, dm),
                          shd.shard_tree(batch, bspecs, dm))
        want = plain(params, state, batch)
        assert torch.equal(got[2]["loss"].full_tensor(), want[2]["loss"])
        for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
            assert torch.equal(a.to_local(), b)
    finally:
        dist.destroy_process_group()
