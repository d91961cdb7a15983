"""CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with ``nvcc``; elsewhere each test skips with
its reason (decided inside the fixture, never at import).  Run them on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integers exact; floats within rtol 1e-4, because the kernels add float
sums with atomics, in an order that changes from run to run.  k-means
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


@pytest.mark.parametrize("n,d,k", [
    (1003, 8, 16), (999, 3, 7), (1000, 8, 1), (2000, 128, 8),
    (5000, 64, 256),   # 128 KB of centroids and accumulators: dynamic shared memory
    (3000, 64, 512),   # past the opt-in shared memory: global accumulators
])
def test_kmeans_step_on_card(card, n, d, k):
    x, c = _clusters(n, d, k, seed=n + k)
    xt, ct = tensors_from_arrays(x, c, device=card)
    before = ops.LAUNCHES["kmeans_step"]
    got = ops.kmeans_step(xt, ct)
    assert ops.LAUNCHES["kmeans_step"] == before + 1
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    _assert_step_agrees(got, ref.kmeans_step(xt, ct), x, c)


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


def test_kmeans_program_on_card_matches_cpu(card):
    n, d, k = 1 << 16, 8, 16
    x, c = _clusters(n, d, k, seed=9)
    before = ops.LAUNCHES["kmeans_step"]
    got = LocalBackend(device=card).compile(kmeans.program(n, d, k, parallel=8))({}, x, c)
    assert ops.LAUNCHES["kmeans_step"] == before + 8
    _assert_step_agrees(got, LocalBackend(device="cpu").compile(kmeans.program(n, d, k))(
        {}, x, c), x, c)
