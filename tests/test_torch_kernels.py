"""The port's kernel wrappers and plain versions against the JAX kernels.

On the CPU a wrapper in ``repro_torch.kernels.ops`` takes its plain
version (``ref``), since the CUDA kernels run only on a card.  Here both
are held against ``repro.kernels.ops`` — the Pallas kernels, in interpret
mode as ``tests/test_kernels.py`` runs them — on the same numpy tables:
empty selections, ragged capacities, join keys outside the declared domain
and duplicate build keys included.  Integers (keys, counts, validity) must
match exactly; floats within rtol 1e-5, since the two sum in different
orders.  The ctypes bindings are checked against the C signatures.
"""

import re
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import expr as jexpr  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.relational import runtime as jrt  # noqa: E402
from repro_torch.convert import vectable_from_arrays  # noqa: E402
from repro_torch.core import expr as texpr  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.relational import runtime as trt  # noqa: E402

RTOL = 1e-5


def _tables(seed=3, n=1003, m=61):
    rng = np.random.default_rng(seed)
    left = {
        "a": rng.integers(-50, 50, n).astype(np.int32),
        "x": rng.uniform(-2, 2, n).astype(np.float32),
        "d": np.round(rng.uniform(0, 0.1, n), 2).astype(np.float32),
        "k": rng.integers(0, 7, n).astype(np.int32),
        "fk": rng.integers(-3, 40, n).astype(np.int32),  # partly out of domain
    }
    lvalid = rng.random(n) < 0.9
    right = {
        "rk": rng.integers(0, 30, m).astype(np.int32),  # duplicate keys
        "g": rng.integers(0, 3, m).astype(np.int32),
        "w": rng.uniform(0, 5, m).astype(np.float32),
    }
    rvalid = rng.random(m) < 0.9
    return (left, lvalid), (right, rvalid)


def _jax_table(cols, valid):
    return jrt.VecTable({k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(valid))


def _torch_table(cols, valid):
    return vectable_from_arrays(cols, valid, "cpu")


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if np.issubdtype(want.dtype, np.floating) or np.issubdtype(got.dtype, np.floating):
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                                   rtol=RTOL, atol=1e-5, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _same_table(got, want):
    _close(got.valid.numpy(), np.asarray(want.valid), "valid")
    assert set(got.cols) == set(want.cols)
    for k in want.cols:
        _close(got.cols[k].numpy(), np.asarray(want.cols[k]), k)


PREDS = {
    "mixed": lambda m: (m.col("d") <= 0.07) & (m.col("a") > -10.5),
    "empty": lambda m: m.col("a") > 1000,
    "true": lambda m: m.const(True),
}


def _aggs(m):
    return (m.AggSpec("sum", m.col("x") * (1.0 - m.col("d")), "s"),
            m.AggSpec("min", m.col("x"), "mn"),
            m.AggSpec("max", m.col("a") / 3, "mx"),
            m.AggSpec("count", m.const(1), "c"))


@pytest.mark.parametrize("pred", sorted(PREDS))
def test_fused_select_agg_matches_pallas(pred):
    (lc, lv), _ = _tables()
    want = jops.fused_select_agg(_jax_table(lc, lv), PREDS[pred](jexpr), _aggs(jexpr))
    t = _torch_table(lc, lv)
    for fn in (ref.fused_select_agg, ops.fused_select_agg):
        got = fn(t, PREDS[pred](texpr), _aggs(texpr))
        assert got["c"].dtype == torch.int32  # exact count, not the TPU's f32 lane
        for k in want:
            _close(got[k].numpy(), np.asarray(want[k]), k)
    if pred == "empty":
        assert float(got["mn"]) == np.inf and float(got["mx"]) == -np.inf


GROUPINGS = {
    "one_key": (("k",), ((0, 6),)),
    "two_keys": (("k", "a"), ((0, 6), (-50, 49))),
    "clipped_keys": (("fk",), ((0, 29),)),  # keys outside the domain clip
}


@pytest.mark.parametrize("pred", ["mixed", "empty"])
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_grouped_select_agg_matches_pallas(pred, grouping):
    (lc, lv), _ = _tables()
    keys, doms = GROUPINGS[grouping]
    nb = int(np.prod([hi - lo + 1 for lo, hi in doms]))
    mg = min(nb, 40)  # fewer groups than buckets: compaction drops the rest
    want = jops.grouped_select_agg(_jax_table(lc, lv), PREDS[pred](jexpr), keys,
                                   _aggs(jexpr), mg, doms, nb)
    t = _torch_table(lc, lv)
    for fn in (ref.grouped_select_agg, ops.grouped_select_agg):
        got = fn(t, PREDS[pred](texpr), keys, _aggs(texpr), mg, doms, nb)
        _same_table(got, want)


JOIN_GROUPINGS = {
    "probe_key": (("k",), ((0, 6),)),
    "build_key": (("g", "k"), ((0, 2), (0, 6))),
}


def _join_kw(m, pred, grouping):
    keys, doms = JOIN_GROUPINGS[grouping]
    nb = int(np.prod([hi - lo + 1 for lo, hi in doms]))
    p = None if pred == "none" else PREDS[pred](m)
    return dict(left_on=("fk",), right_on=("rk",), join_key_domains=((0, 29),),
                join_num_buckets=30, keys=keys, max_groups=nb, key_domains=doms,
                num_buckets=nb, pred=p,
                aggs=(m.AggSpec("count", m.const(1), "c"),
                      m.AggSpec("sum", m.col("w") * m.col("x"), "s"),
                      m.AggSpec("max", m.col("w"), "mx"),
                      m.AggSpec("min", m.col("a"), "mn")))


@pytest.mark.parametrize("pred", ["mixed", "empty", "none"])
@pytest.mark.parametrize("grouping", sorted(JOIN_GROUPINGS))
def test_grouped_join_agg_matches_pallas(pred, grouping):
    """A primary-key build side (every key of the domain once, shuffled),
    probe keys partly outside the domain: the TPC-H orders shape."""
    (lc, lv), (rc, _) = _tables()
    rng = np.random.default_rng(5)
    rc = {"rk": rng.permutation(30).astype(np.int32),
          "g": rng.integers(0, 3, 30).astype(np.int32),
          "w": rng.uniform(0, 5, 30).astype(np.float32)}
    rv = np.ones(30, bool)
    want = jops.grouped_join_agg(_jax_table(lc, lv), _jax_table(rc, rv),
                                 **_join_kw(jexpr, pred, grouping))
    for fn in (ref.grouped_join_agg, ops.grouped_join_agg):
        got = fn(_torch_table(lc, lv), _torch_table(rc, rv),
                 **_join_kw(texpr, pred, grouping))
        _same_table(got, want)


@pytest.mark.parametrize("pred", ["mixed", "none"])
@pytest.mark.parametrize("grouping", sorted(JOIN_GROUPINGS))
def test_grouped_join_agg_duplicate_build_keys(pred, grouping):
    """Duplicate and invalid build rows, keys missing from the build side:
    held against the JAX runtime's fused_join_group_agg, the semantics the
    Pallas kernel implements — that kernel's presence table is gathered by
    build-row index instead of bucket (ROADMAP Queue 3) and drops matches
    on this input."""
    (lc, lv), (rc, rv) = _tables()
    want = jrt.fused_join_group_agg(_jax_table(lc, lv), _jax_table(rc, rv),
                                    **_join_kw(jexpr, pred, grouping))
    for fn in (ref.grouped_join_agg, ops.grouped_join_agg):
        got = fn(_torch_table(lc, lv), _torch_table(rc, rv),
                 **_join_kw(texpr, pred, grouping))
        _same_table(got, want)


def test_grouped_join_agg_smallest_presence_case():
    """Probe key 0, build keys [2, 0]: one match.  (The Pallas kernel
    finds none here; see ROADMAP Queue 3.)"""
    left = vectable_from_arrays({"fk": np.array([0], np.int32)}, np.array([True]), "cpu")
    right = vectable_from_arrays({"rk": np.array([2, 0], np.int32)}, np.ones(2, bool), "cpu")
    out = ops.grouped_join_agg(left, right, left_on=("fk",), right_on=("rk",),
                               join_key_domains=((0, 2),), join_num_buckets=3, keys=(),
                               aggs=(texpr.AggSpec("count", texpr.const(1), "c"),),
                               max_groups=1, key_domains=(), num_buckets=1)
    assert out.to_numpy()["c"].tolist() == [1]


def test_build_tables_first_occurrence_wins():
    """The first-row table that grouped_join_agg's build kernel makes, in
    its plain version (``runtime.build_first_index``): the lowest valid
    row of each join bucket, the build side's capacity where a bucket is
    empty; a row outside the key domain falls away.  A join then reads the
    build values at that row."""
    right = vectable_from_arrays(
        {"rk": np.array([5, 2, 5, 9, 2, 40], np.int32),
         "v": np.array([10, 20, 30, 40, 50, 60], np.int32)},
        np.array([True, True, True, False, True, True]), "cpu")
    first = trt.build_first_index(right, ("rk",), ((0, 9),), 10)
    # first valid occurrence; 9 is invalid, 40 out of domain
    assert first.tolist() == [6, 6, 1, 6, 6, 0, 6, 6, 6, 6]
    left = vectable_from_arrays({"fk": np.array([5, 2, 9, 7, 40], np.int32)},
                                np.ones(5, bool), "cpu")
    out = ops.grouped_join_agg(left, right, left_on=("fk",), right_on=("rk",),
                               join_key_domains=((0, 9),), join_num_buckets=10, keys=(),
                               aggs=(texpr.AggSpec("sum", texpr.col("v"), "s"),
                                     texpr.AggSpec("max", texpr.col("v"), "mx"),
                                     texpr.AggSpec("count", texpr.const(1), "c")),
                               max_groups=1, key_domains=(), num_buckets=1).to_numpy()
    assert out["s"].tolist() == [30] and out["mx"].tolist() == [20] and out["c"].tolist() == [2]


def test_cpu_wrappers_do_not_count_launches():
    (lc, lv), _ = _tables()
    ops.reset_launches()
    ops.fused_select_agg(_torch_table(lc, lv), PREDS["mixed"](texpr), _aggs(texpr))
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def test_wrappers_reject_other_devices():
    t = vectable_from_arrays({"a": np.zeros(4, np.int32)}, np.ones(4, bool), "cpu")
    meta = type(t)({"a": torch.zeros(4, dtype=torch.int32, device="meta")},
                   torch.ones(4, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.fused_select_agg(meta, texpr.col("a") > 0, ())
    with pytest.raises(ValueError, match="several devices"):
        ops.grouped_join_agg(t, meta, left_on=("a",), right_on=("a",),
                             join_key_domains=((0, 3),), join_num_buckets=4, keys=(),
                             aggs=(), max_groups=1, key_domains=(), num_buckets=1)


#: every entry point: the kernels built once, and the fixed one of each
#: family generated per query (defined by its template, csrc/<family>.cu)
ENTRIES = {**build.ENTRY, **build.GEN_ENTRY}
HELPERS = {**build.HELPERS, **build.GEN_HELPERS}


def _c_params(kernel, fn=None):
    src = (build.CSRC / f"{kernel}.cu").read_text()
    if fn is None:
        fn = ENTRIES[kernel][0]
        m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", src, re.S)
    else:  # a helper inside an extern "C" block, or declared extern "C" itself
        m = re.search(r'\n(?:extern "C" )?(?:int|long long) ' + fn + r"\((.*?)\)\s*\{",
                      src, re.S)
    params = [p.strip() for p in m.group(1).split(",") if p.strip() not in ("", "void")]
    kinds = []
    for p in params:
        if "*" in p:
            kinds.append(build._P)
        elif p.startswith("long long"):
            kinds.append(build._L)
        elif p.startswith("float "):
            kinds.append(build._F)
        else:
            assert p.startswith("int "), p
            kinds.append(build._I)
    return kinds


@pytest.mark.parametrize("kernel", build.KERNELS + tuple(build.GEN_ENTRY))
def test_ctypes_bindings_match_c_signatures(kernel):
    assert _c_params(kernel) == ENTRIES[kernel][1]


@pytest.mark.parametrize("kernel,helper", [(k, h) for k, hs in HELPERS.items() for h in hs])
def test_ctypes_helpers_match_c_signatures(kernel, helper):
    args, result = HELPERS[kernel][helper]
    src = (build.CSRC / f"{kernel}.cu").read_text()
    assert re.search(r'\n(?:extern "C" )?' + {build._I: "int", build._L: "long long"}[result]
                     + " " + helper + r"\(", src), f"{helper} returns another type"
    assert _c_params(kernel, helper) == args


def test_library_path_tracks_sources(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    p = build.library_path("kmeans_step")
    assert p.parent == tmp_path and p.name.startswith("kmeans_step-")
    assert p == build.library_path("kmeans_step")
    assert p != build.library_path("segsum")


def test_library_path_tracks_local_headers(tmp_path, monkeypatch):
    """Editing a header of ``csrc/`` that a source includes, directly or
    through another header, renames the library; a header it does not
    include, or an include of a system header, does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    (csrc / "inner.cuh").write_text("#pragma once\n#define INNER 1\n")
    (csrc / "outer.cuh").write_text('#pragma once\n#include <cuda.h>\n#include "inner.cuh"\n')
    (csrc / "other.cuh").write_text("#define OTHER 1\n")
    (csrc / "probe.cu").write_text('#include "outer.cuh"\nextern "C" int probe() { return 0; }\n')
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    assert [h.name for h in build.local_headers(csrc / "probe.cu")] == ["outer.cuh", "inner.cuh"]
    before = build.library_path("probe")
    (csrc / "other.cuh").write_text("#define OTHER 2\n")
    assert build.library_path("probe") == before
    (csrc / "inner.cuh").write_text("#pragma once\n#define INNER 2\n")
    edited = build.library_path("probe")
    assert edited != before and edited.name.startswith("probe-")
    # the port's own sources: the attention kernel's wgmma/TMA header counts
    assert [h.name for h in build.local_headers(csrc / "flash_attention.cu")] == ["hopper.cuh"]
    old = build.library_path("flash_attention")
    (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text() + "\n// edited\n")
    assert build.library_path("flash_attention") != old


def test_default_build_dir_is_ignored_by_git(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    root = Path(build.__file__).resolve().parents[3]
    assert build.build_dir() == root / "build" / "repro_torch_kernels"
    assert "build/" in (root / ".gitignore").read_text().split()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_chip_smoke_builds_each_distinct_kernel_once_and_at_once(monkeypatch):
    """``chip_smoke.py``'s ``build_at_once`` builds the kernel each
    relational call would build at its first launch, each distinct text
    once and all at once (each build here waits at a barrier for the
    others), and leaves the builder as it found it.  Two calls whose
    queries differ only in an aggregate's name give one text and one
    build; a call whose kernel is loaded already runs whole."""
    import importlib.util
    import threading

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    (lcols, lvalid), (rcols, rvalid) = _tables()
    left, right = _torch_table(lcols, lvalid), _torch_table(rcols, rvalid)
    pred = (texpr.col("d") <= 0.07) & (texpr.col("a") > -10.5)
    one = (texpr.AggSpec("sum", texpr.col("x"), "a"),)
    two = one + (texpr.AggSpec("sum", texpr.col("x"), "b"),)
    jkw = dict(left_on=("fk",), right_on=("rk",), join_key_domains=((0, 29),),
               join_num_buckets=30, keys=("g",), aggs=one, max_groups=3,
               key_domains=((0, 2),), num_buckets=3, pred=pred)
    calls = [lambda: ops.fused_select_agg(left, pred, one),
             lambda: ops.fused_select_agg(left, pred, two),  # the same text as the first
             lambda: ops.grouped_select_agg(left, pred, ("k",), one, 7, ((0, 6),), 7),
             lambda: ops.grouped_join_agg(left, right, **jkw)]
    built = []
    barrier = threading.Barrier(3, timeout=30)

    def fake_build(family, text):
        barrier.wait()  # returns only once all three builds run at once
        built.append((family, text))
        raise RuntimeError("built, not loaded")

    monkeypatch.setattr(ops, "_QUERIES", {})
    monkeypatch.setattr(ops, "_on_card", lambda *tables: True)
    monkeypatch.setattr(build, "build_generated", fake_build)
    with pytest.raises(RuntimeError, match="built, not loaded"):
        smoke.build_at_once(calls)
    assert build.build_generated is fake_build
    assert sorted(f for f, _ in built) == ["fused_select_agg", "grouped_join_agg",
                                           "grouped_select_agg"]
    assert len({build.generated_path(*b) for b in built}) == 3
    ran = []
    assert smoke.build_at_once([lambda: ran.append(1)]) == 0 and ran == [1]


# ---------------------------------------------------------------------------
# segsum on the tensor cores: its recipe against the Pallas kernel
# ---------------------------------------------------------------------------


def _tc_tiling(n, d, k, sms=132):
    """The tensor-core kernels' tiling (``oh_grid`` in ``csrc/onehot.cuh``)
    on a card of ``sms`` SMs: 16 KB tiles, 8 warps, two blocks an SM where
    KP·DP ≤ 256, at most 512 blocks, groups of 32."""
    dp = 8 if d <= 8 else 16 if d <= 16 else 32
    kp = 16 if k <= 16 else 32 if k <= 32 else 64
    tile = max(16384 // (4 * dp), 128)
    tiles = -(-n // tile)
    grid = max(1, min(tiles, sms * (2 if kp * dp <= 256 else 1), 512))
    return ref.KmsTiling(tile=tile, warps=8, grid=grid, group=32)


#: label: (n, d, K, (rows, floats) before the view's start)
SEG_CASES = {
    "ids at K-1, negative and past K": (1003, 8, 16, (0, 0)),
    "ragged tail, several tiles a block": (20_011, 8, 16, (0, 0)),
    "d=1 view 4 bytes into a granule": (777, 1, 3, (0, 1)),
    "d=3 view from row 5 (60 bytes in)": (3001, 3, 7, (5, 0)),
    "top of the range, K=64 d=8": (4099, 8, 64, (0, 0)),
    "d=32 K=16": (2000, 32, 16, (0, 3)),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
@pytest.mark.parametrize("small", [False, True])
def test_segsum_tiled_matches_pallas(case, small):
    """``ref.segsum_tiled`` (seg_tc's arithmetic: TF32 hi + lo one-hot
    products per warp slice, added in the tiling's fixed order) against the
    JAX Pallas segsum in interpret mode and the plain ``ref.segsum``, on
    the card's tiling and on a small one (several tiles a block, several
    groups): within rtol 1e-4 of the sum plus 1e-5 of the segment's Σ|x|
    (the other order's rounding, as ``chip_smoke.py``'s check_segsum)."""
    n, d, k, (rows, floats) = SEG_CASES[case]
    rng = np.random.default_rng(n + d + k)
    data = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-2, k + 2, n).astype(np.int32)  # some out of range
    ids[:5] = k - 1
    ids[ids == 1] = 0  # segment 1 stays empty
    flat = np.zeros((rows + n + 1) * d + floats, np.float32)
    at = rows * d + floats
    flat[at:at + n * d] = data.ravel()
    dt = torch.from_numpy(flat)[at:at + n * d].view(n, d)
    tiling = ref.KmsTiling(tile=128, warps=8, grid=7, group=4) if small else _tc_tiling(n, d, k)
    got = ref.segsum_tiled(dt, torch.from_numpy(ids), k, tiling).numpy()
    pallas = np.asarray(jops.segsum(jnp.asarray(data), jnp.asarray(ids), k, interpret=True))
    plain = ref.segsum(dt, torch.from_numpy(ids), k).numpy()
    keep = (ids >= 0) & (ids < k)
    scale = np.zeros((k, d), np.float64)
    np.add.at(scale, ids[keep], np.abs(data[keep]).astype(np.float64))
    for want in (pallas, plain):
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-5 * scale)
    assert not got[1].any()
