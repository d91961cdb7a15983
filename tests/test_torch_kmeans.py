"""k-means through the LA flavor: the torch port against the JAX package.

The same numpy points and centroids go through both packages:

* the port's plain ``kmeans_step`` and ``segsum`` (which its wrappers take
  for CPU tensors) against the JAX wrappers over the Pallas kernels, in
  interpret mode as ``tests/test_kernels.py`` runs them, over a sweep of
  (n, d, k) with ragged n;
* the k-means program, unfused and ``FuseKMeansStep`` + ``Parallelize(4)``,
  through the port's ``LocalBackend(device="cpu")`` against the JAX
  ``LocalBackend(use_kernels=True)`` on the same program.

Tolerances.  The points lie in well-separated clusters, and each test
asserts that no point is ambiguous by the tie-margin rule of
``repro_torch.kmeans`` (another centroid's f64 d² within a few f32
roundings of the nearest one's), so labels, and counts, must match
exactly.  Sums: within rtol 1e-4 of the JAX value plus 1e-5 of the sum of
|x| over the segment (and, where the JAX wrapper padded the rows with
copies of c[0] and took them off again, of that padding), since the two
add f32 values in other orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.backends.local import LocalBackend as JaxBackend  # noqa: E402
from repro.core import passes as jpasses  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import kmeans  # noqa: E402
from repro_torch.backends import emit  # noqa: E402
from repro_torch.backends.local import LocalBackend  # noqa: E402
from repro_torch.convert import tensors_from_arrays  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SUM_RTOL = 1e-4
SUM_ABS = kmeans.SUM_ABS  # of the sum of |x| over the segment


def clustered(n, d, k, seed=0, spread=5.0):
    """Points around k well-separated centres, and centroids near them."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, spread, (k, d))
    x = centres[rng.integers(0, k, n)] + rng.normal(0, 0.3, (n, d))
    c = centres + rng.normal(0, 0.1, (k, d))
    return x.astype(np.float32), c.astype(np.float32)


def unambiguous(x, c):
    """The f64 reference step, asserting that no point is ambiguous."""
    stats = kmeans.reference_step(x, c)
    assert stats.n_amb == 0
    return stats


def assert_step_close(got, want, stats, pad_c0=0.0):
    (gs, gc), (ws, wc) = [tuple(np.asarray(v, np.float64) for v in p) for p in (got, want)]
    assert gs.shape == ws.shape and gc.shape == wc.shape
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gc, stats.counts)
    scale = stats.abs_sums.copy()
    scale[0] += pad_c0
    assert np.all(np.abs(gs - ws) <= SUM_RTOL * np.abs(ws) + SUM_ABS * scale + 1e-6), \
        np.abs(gs - ws).max()


@pytest.mark.parametrize("n,d,k", [(1000, 8, 5), (1024, 8, 16), (777, 3, 7),
                                   (2050, 32, 16), (300, 8, 1)])
def test_kmeans_step_plain_version_matches_pallas(n, d, k):
    x, c = clustered(n, d, k, seed=n + d + k)
    stats = unambiguous(x, c)
    want = jops.kmeans_step(jnp.asarray(x), jnp.asarray(c), interpret=True)
    pad = -(-n // 1024) * 1024 - n
    xt, ct = tensors_from_arrays(x, c, device="cpu")
    for fn in (ref.kmeans_step, ops.kmeans_step):
        got = fn(xt, ct)
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
        assert_step_close(got, want, stats, pad_c0=pad * np.abs(c[0]))


def test_duplicate_centroids_go_to_the_lower_index():
    x, c = clustered(600, 4, 5, seed=11)
    c[3] = c[1]  # the points of centre 1 tie between 1 and 3
    xt, ct = tensors_from_arrays(x, c, device="cpu")
    want = jops.kmeans_step(jnp.asarray(x), jnp.asarray(c), interpret=True)
    for fn in (ref.kmeans_step, ops.kmeans_step):
        sums, counts = fn(xt, ct)
        assert counts[3] == 0 and counts[1] > 0
        assert torch.all(sums[3] == 0)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n,d,k", [(256, 8, 4), (1000, 16, 17), (777, 1, 2), (2048, 8, 64)])
def test_segsum_plain_version_matches_pallas(n, d, k):
    rng = np.random.default_rng(n + d + k)
    data = rng.normal(size=(n, d)).astype(np.float32)
    seg = rng.integers(0, k, n).astype(np.int32)
    want = np.asarray(jops.segsum(jnp.asarray(data), jnp.asarray(seg), k, interpret=True))
    dt, st = tensors_from_arrays(data, seg, device="cpu")
    for fn in (ref.segsum, ops.segsum):
        got = fn(dt, st, k)
        assert got.dtype == torch.float32 and got.shape == (k, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_segsum_drops_ids_out_of_range():
    data = np.arange(12, dtype=np.float32).reshape(6, 2)
    seg = np.array([0, 2, 3, -1, 2, 7], np.int32)  # 3, -1 and 7 lie outside [0, 3)
    dt, st = tensors_from_arrays(data, seg, device="cpu")
    got = ops.segsum(dt, st, 3).numpy()
    np.testing.assert_array_equal(got, [[0, 1], [0, 0], [2 + 8, 3 + 9]])


# ---------------------------------------------------------------------------
# the k-means program through both backends
# ---------------------------------------------------------------------------


def jax_program(variant, n, d, k):
    """The JAX package's counterpart of ``repro_torch.kmeans.program``
    (``examples/kmeans.py``)."""
    types = jcore.types
    b = jcore.Builder("kmeans_iter")
    xr = b.input("X", types.Tensor(types.F32, (n, d)))
    cr = b.input("C", types.Tensor(types.F32, (k, d)))
    lab = b.emit1("la.ArgMinRow", [b.emit1("la.CDist2", [xr, cr])])
    prog = b.finish(b.emit1("la.SegSum", [xr, lab], {"k": k}),
                    b.emit1("la.SegCount", [lab], {"k": k}))
    if variant == "fused_parallel4":
        prog = jpasses.FuseKMeansStep().apply(prog)
        prog = jpasses.Parallelize(n=4, targets={xr.name}).apply(prog)
    jcore.verify(prog)
    return prog


PARALLEL = {"unfused": 0, "fused_parallel4": 4}


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("variant", ["unfused", "fused_parallel4"])
def test_kmeans_program_matches_jax(variant, use_kernels):
    n, d, k = 4000, 8, 16  # chunks of 1000 rows: the Pallas wrapper pads each to 1024
    x, c = clustered(n, d, k, seed=3)
    jprog = jax_program(variant, n, d, k)
    tprog = kmeans.program(n, d, k, parallel=PARALLEL[variant])
    assert tprog.opcodes() == jprog.opcodes()
    if variant == "fused_parallel4":
        ce = next(i for i in tprog.body if i.opcode == "cf.ConcurrentExecute")
        assert ce.param("P").opcodes() == ["la.KMeansStep"]
    jrun = JaxBackend(use_kernels=True).compile(jprog)
    trun = LocalBackend(use_kernels=use_kernels, device="cpu").compile(tprog)
    pad = 4 * 24 if variant == "fused_parallel4" else 0  # rows the Pallas wrapper pads
    for _ in range(2):  # two steps, each from the port's centroids
        stats = unambiguous(x, c)
        want = jrun({}, jnp.asarray(x), jnp.asarray(c))
        got = trun({}, x, c)
        assert_step_close(got, want, stats, pad_c0=pad * np.abs(c[0]))
        sums, counts = (v.numpy() for v in got)
        c = (sums / np.maximum(counts, 1e-9)[:, None]).astype(np.float32)


def test_fused_step_calls_the_wrapper_once_per_chunk(monkeypatch):
    n, d, k = 4000, 8, 16
    x, c = clustered(n, d, k, seed=4)
    calls = []
    real = ops.kmeans_step
    monkeypatch.setattr(ops, "kmeans_step", lambda *a: calls.append(a[0].shape) or real(*a))
    prog = kmeans.program(n, d, k, parallel=4)
    LocalBackend(device="cpu").compile(prog)({}, x, c)
    assert calls == [(1000, d)] * 4


def test_la_emitters_match_jax():
    """Literal, MMMult, Transpose, Ewise, ReduceSum and a CombineChunks(max)
    after Parallelize, on both backends."""
    rng = np.random.default_rng(9)
    a = rng.normal(size=(8, 4)).astype(np.float32)
    lit = rng.normal(size=(4,)).astype(np.float32).tolist()
    outs = []
    for core in (jcore, tcore):
        types = core.types
        b = core.Builder("la_mix")
        ar = b.input("A", types.Tensor(types.F32, (8, 4)))
        lr = b.emit1("la.Literal", [], {"shape": (4,), "value": lit})
        at = b.emit1("la.Transpose", [ar])
        g = b.emit1("la.MMMult", [at, ar])
        e = b.emit1("la.Ewise", [g, lr], {"op": "mul"})
        sq = b.emit1("la.Ewise", [e], {"op": "square"})
        r = b.emit1("la.ReduceSum", [sq], {"axis": 0})
        outs.append((b.finish(r, e), ar.name))
    (jprog, _), (tprog, _) = outs
    want = JaxBackend().compile(jprog)({}, jnp.asarray(a))
    got = LocalBackend(device="cpu").compile(tprog)({}, a)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_combine_chunks_over_tensors_and_dicts(op):
    chunks = [torch.tensor([1.0, 5.0, -2.0]), torch.tensor([3.0, -1.0, 4.0])]
    fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
    ins = tcore.Instruction("cf.CombineChunks", (), (), (("op", op),))
    (t,) = emit._EMIT["cf.CombineChunks"](None, ins, [chunks])
    (dd,) = emit._EMIT["cf.CombineChunks"](None, ins, [[{"a": v} for v in chunks]])
    want = fn(chunks[0].numpy(), chunks[1].numpy())
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(dd["a"].numpy(), want)


def test_backend_moves_numpy_inputs_and_refuses_other_devices():
    prog = kmeans.program(8, 2, 2)
    run = LocalBackend(device="cpu").compile(prog)
    x, c = clustered(8, 2, 2, seed=1)
    sums, counts = run({}, x.astype(np.float64), c)  # x64 off: f64 points become f32
    assert sums.dtype == torch.float32 and int(counts.sum()) == 8
    meta = torch.zeros((8, 2), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="backend runs on cpu"):
        run({}, meta, c)


def test_tensors_from_arrays_keeps_x64_off():
    a, b, c = tensors_from_arrays(np.zeros((2, 3)), np.arange(4), np.ones(2, np.float32),
                                  device="cpu")
    assert (a.dtype, b.dtype, c.dtype) == (torch.float32, torch.int32, torch.float32)
    assert a.is_contiguous() and a.shape == (2, 3)


def test_kernel_wrappers_reject_other_devices():
    x = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.kmeans_step(x, x)
    with pytest.raises(ValueError, match="several devices"):
        ops.segsum(torch.zeros((4, 2)), torch.zeros(4, dtype=torch.int32, device="meta"), 2)


def test_cpu_wrappers_do_not_count_launches():
    x, c = clustered(64, 2, 3)
    ops.reset_launches()
    xt, ct = tensors_from_arrays(x, c, device="cpu")
    ops.kmeans_step(xt, ct)
    ops.segsum(xt, torch.zeros(64, dtype=torch.int32), 3)
    assert ops.LAUNCHES["kmeans_step"] == 0 and ops.LAUNCHES["segsum"] == 0


# ---------------------------------------------------------------------------
# the tie-margin rule of repro_torch.kmeans
# ---------------------------------------------------------------------------


def test_plain_step_on_examples_data_agrees_with_f64_by_tie_margin():
    """``examples/kmeans.py``'s data, where clusters overlap and some points
    lie within the margin of a tie."""
    x, c = kmeans.make_data(1 << 15, 8, 16, 0)
    stats = kmeans.reference_step(x, c)
    assert stats.n == 1 << 15 and stats.counts.sum() == stats.n
    got = ref.kmeans_step(*tensors_from_arrays(x, c, device="cpu"))
    kmeans.check_step("plain", got, (stats.sums, stats.counts), stats, 2e-4)


def test_reference_step_marks_both_sides_of_a_tie():
    c = np.array([[0.0, 0.0], [2.0, 0.0], [0.0, 9.0]], np.float32)
    x = np.array([[1.0, 0.0], [0.1, 0.0], [0.0, 8.0]], np.float32)  # x[0] ties 0 and 1
    stats = kmeans.reference_step(x, c)
    assert stats.n_amb == 1
    np.testing.assert_array_equal(stats.cand, [1, 1, 0])
    np.testing.assert_array_equal(stats.cand_abs, [[1, 0], [1, 0], [0, 0]])
    # the tied point may go either way; nothing else may move
    moved = (stats.sums + [[-1, 0], [1, 0], [0, 0]], stats.counts + [-1, 1, 0])
    kmeans.check_step("moved", moved, (stats.sums, stats.counts), stats, 1e-4)


@pytest.mark.parametrize("fault", ["lost point", "double count", "moved twice", "sum off"])
def test_check_step_catches_faults_whatever_the_ties(fault):
    x, c = kmeans.make_data(1 << 14, 8, 16, 1)
    stats = kmeans.reference_step(x, c)
    assert stats.n_amb > 0
    sums, counts = stats.sums.copy(), stats.counts.copy()
    j = int(np.argmax(stats.cand))  # the centroid with the most slack
    if fault == "lost point":
        counts[j] -= 1
    elif fault == "double count":
        counts[j] += 1
    elif fault == "moved twice":  # more than its candidates allow
        i = (j + 1) % len(counts)
        counts[j] -= stats.cand[j] + 1
        counts[i] += stats.cand[j] + 1
    else:
        sums[j] += 1.0 + 1e-3 * np.abs(stats.sums).sum()
    with pytest.raises(AssertionError):
        kmeans.check_step(fault, (sums, counts), (stats.sums, stats.counts), stats, 1e-4)
