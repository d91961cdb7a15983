"""CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with ``nvcc``; elsewhere each test skips with
its reason (decided inside the fixture, never at import).  Run them on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integers exact; floats within rtol 1e-4, because the kernels add float
sums with atomics, in an order that changes from run to run (the
tensor-core kmeans_step and segsum, fused_select_agg and the register
route of grouped_select_agg and grouped_join_agg add in a fixed order: two
runs agree bit for bit).  k-means
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
from repro_torch.relational import tpch  # noqa: E402

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
