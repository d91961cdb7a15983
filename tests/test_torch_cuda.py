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
