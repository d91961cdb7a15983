#!/usr/bin/env python3
"""On-card check of the torch port: TPC-H and k-means through ``repro_torch``
on one GPU.

    python3 chip_smoke.py [--sf 5] [--reps 5] [--profile]

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. each CUDA kernel against its plain PyTorch version on edge cases
   (empty selection, ragged capacity, out-of-domain and duplicate join
   keys, more buckets than shared memory holds; for k-means ragged n,
   k = 1, duplicate and far centroids, centroid tables past 48 KB and past
   the opt-in shared memory; for segsum ids at K−1 and out of range, empty
   segments, accumulators past 48 KB and past the opt-in shared memory);
3. the TPC-H path: TPC-H at ``--sf`` (seed 0), the six queries through
   ``Frame.collect(device="cuda")``, each held against the numpy
   reference, with the kernels' launch counts read around that one run;
4. the k-means path: 2^24 points, d = 8, k = 16 (seed 0, made as
   ``examples/kmeans.py`` makes them), the program built with ``Builder``,
   then ``FuseKMeansStep`` and ``Parallelize(8)``, run on
   ``LocalBackend(use_kernels=True)`` for a warm-up and 5 steps,
   ``kmeans_step`` launched 8 times per step; each step held against a
   numpy f64 step from the same centroids, and the unfused program against
   the fused one;
5. ``segsum`` on the unfused program's ``la.SegSum`` inputs (the JAX
   package's emitters never call its segsum kernel either), counted alone;
6. the TPC-H path with ``parallel=4``: the six queries again, split into
   four chunks, against the references; Q1 and Q6 launch their kernel
   once per chunk; each kernel call of this path (chunk views, Q1's
   recombine, Q4's split inner aggregation) against its plain version;
7. each kernel against its plain version on the inputs the paths gave it,
   both timed with CUDA events, with its bound and, for ``segsum``, the
   one PyTorch call (``index_add_``) that computes the same function;
8. per-query latency (median over ``--reps`` after a warm-up), sequential
   and with ``parallel=4``, lineitem rows/s, and the k-means step time and
   points/s; with ``--profile``, device time by kernel and busy share.

Then the card's line, the ``kernels`` JSON line and, last,
``{"ok": true, "device": ...}``.  Any failed check raises, so the exit code
is not 0 and no result line is printed; without a visible CUDA device the
script exits with code 2.

Tolerances.  Kernel against plain version: integers (keys, counts,
validity) exact; floats within rtol 1e-4 of the plain value, because the
kernels add float sums with atomics and per-block partials, in another
order than torch's reductions (each order has error of order
sqrt(n)·2^-24 on n ≈ 10^6 terms).  Query against the numpy reference:
integers exact, floats rtol 2e-4 (tests/test_tpch.py's tolerance: f32
accumulation against an f64 oracle).  Segment sums: a sum may also
differ by 1e-5 of the sum of |x| over its segment, since a sum whose terms
cancel has a rounding error that scales with Σ|x| and not with the result.
k-means steps go by the tie-margin rule of ``repro_torch.kmeans`` (counts
add up to n and sums to Σx whatever the ties; each count and sum may move
by what the points within a few f32 roundings of a tie carry): steps
against numpy f64 at rtol 2e-4, kernel against plain version at rtol 1e-4.
Kernel calls on the ``parallel=4`` path are held against their plain
versions too, but timed and counted only on the sequential path.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

KERNEL_RTOL = 1e-4
QUERY_RTOL = 2e-4
STEP_RTOL = 2e-4
#: H100 SXM data-sheet peaks: HBM bytes/s and f32 (non-tensor-core) op/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

#: the k-means path: examples/kmeans.py's d and k at 512 times its n
KMEANS_N, KMEANS_D, KMEANS_K, KMEANS_SEED, KMEANS_PARALLEL = 1 << 24, 8, 16, 0, 8
#: timed k-means steps after the warm-up
KMEANS_STEPS = 5
#: chunks of the TPC-H path with parallelism
PARALLEL = 4

TPCH_KERNELS = ("fused_select_agg", "grouped_select_agg", "grouped_join_agg")
REPLACES = {
    "fused_select_agg": "src/repro/kernels/fused_select_agg.py:84",
    "grouped_select_agg": "src/repro/kernels/grouped_select_agg.py:110",
    "grouped_join_agg": "src/repro/kernels/grouped_join_agg.py:158",
    "kmeans_step": "src/repro/kernels/kmeans_step.py:59",
    "segsum": "src/repro/kernels/segsum.py:47",
}
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}
#: which queries' plans launch which kernel
EXPECTED = {
    "fused_select_agg": ("q6", "q14", "q19"),
    "grouped_select_agg": ("q1", "q4"),
    "grouped_join_agg": ("q4", "q12"),
}
GROUP_KEYS = {"q1": ("l_returnflag", "l_linestatus"), "q4": ("o_orderpriority",),
              "q12": ("l_shipmode",)}


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _errors(got, want):
    """(max abs error, max error relative to rtol·max(|want|, 1)) of two
    float arrays; equal values (infinities too) count as 0."""
    import numpy as np

    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    with np.errstate(invalid="ignore"):
        diff = np.where(same, 0.0, np.abs(g - w))
    scale = np.maximum(np.abs(np.where(np.isfinite(w), w, 0.0)), 1.0)
    if diff.size == 0:
        return 0.0, 0.0
    return float(diff.max()), float((diff / scale).max())


def compare_outputs(name: str, got, want) -> float:
    """Kernel output against the plain version's: ints exact, floats
    within KERNEL_RTOL.  Returns the max absolute float error."""
    import numpy as np
    import torch

    from repro_torch.relational.runtime import VecTable

    if isinstance(want, VecTable):
        pairs = [("valid", got.valid, want.valid)]
        pairs += [(k, got.cols[k], want.cols[k]) for k in want.cols]
    else:
        pairs = [(k, got[k], want[k]) for k in want]
    worst = 0.0
    for k, g, w in pairs:
        g, w = g.detach().cpu(), w.detach().cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}.{k}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if not w.is_floating_point():
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{name}.{k}: {bad} integer values differ")
            continue
        abs_err, rel = _errors(g.numpy(), w.numpy())
        if rel > KERNEL_RTOL or np.isnan(rel):
            raise AssertionError(f"{name}.{k}: error {abs_err} (relative {rel}) "
                                 f"over rtol {KERNEL_RTOL}")
        worst = max(worst, abs_err)
    return worst


def check_query(qname: str, got, want) -> None:
    import numpy as np

    keys = GROUP_KEYS.get(qname, ())
    if keys:
        def order(d):
            o = np.lexsort([np.asarray(d[k]) for k in reversed(keys)])
            return {k: np.asarray(v)[o] for k, v in d.items()}
        got, want = order(got), order(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.shape != w.shape:
            raise AssertionError(f"{qname}.{k}: shape {g.shape} vs {w.shape}")
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                          err_msg=f"{qname}.{k}")
        else:
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=QUERY_RTOL,
                                       err_msg=f"{qname}.{k}")


def check_segsum(what: str, got, data, ids, k) -> float:
    """segsum kernel against its plain version: rtol 1e-4 plus SUM_ABS of
    the segment's Σ|x|."""
    from repro_torch.kernels import ref
    from repro_torch.kmeans import SUM_ABS

    want = ref.segsum(data, ids, k)
    scale = ref.segsum(data.abs(), ids, k)
    err = (got - want).abs()
    if got.shape != want.shape or got.dtype != want.dtype or not bool(
            (err <= KERNEL_RTOL * want.abs() + SUM_ABS * scale).all()):
        raise AssertionError(f"{what}: differs from its plain version by {float(err.max())}")
    return float(err.max())


@contextlib.contextmanager
def recording(names):
    """Record each call of the ``ops`` wrappers ``names`` as (name, args,
    kw), to replay them against the plain versions afterwards (the emitters
    look the wrappers up on the module)."""
    from repro_torch.kernels import ops

    captured = []
    originals = {k: getattr(ops, k) for k in names}

    def recorder(name):
        def call(*args, **kw):
            captured.append((name, args, kw))
            return originals[name](*args, **kw)
        return call

    for k in names:
        setattr(ops, k, recorder(k))
    try:
        yield captured
    finally:
        for k, fn in originals.items():
            setattr(ops, k, fn)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device-clock ms of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def work(name: str, args: tuple, kw: dict):
    """(bytes, operations) the call's function needs on this data.  k-means:
    the points and centroids read once, sums and counts written once, and
    n·k·(2d+3) f32 operations; segsum: rows and ids read once, the sums
    written once, an add per element.  The relational kernels: every
    column the predicate reads and the validity over all rows; columns
    read only by the aggregated values or keys, over the rows that pass;
    the build side of a join once; the result once.  Operations: the
    program's instructions per row evaluated (the cost of a VM step is not
    counted)."""
    from repro_torch.kernels import exprcode
    from repro_torch.kernels.ops import _value_aggs
    from repro_torch.relational import runtime as rt

    if name == "kmeans_step":  # points and centroids in, sums and counts out
        x, c = args
        (n, d), k = x.shape, c.shape[0]
        return (n * d + 2 * k * d + k) * 4, n * k * (2 * d + 3)
    if name == "segsum":  # rows and ids in, the segment sums out
        data, ids, k = args
        n, d = data.shape
        return (n * (d + 1) + k * d) * 4, n * d
    if name == "grouped_join_agg":
        table, right = args
        pred, aggs = kw["pred"], kw["aggs"]
        keys = kw["keys"]
    else:
        table, pred, *rest = args
        aggs = rest[0] if name == "fused_select_agg" else rest[1]
        keys = () if name == "fused_select_agg" else rest[0]
        right = None
    vaggs = _value_aggs(aggs)
    pred_fields = set(pred.fields()) if pred is not None else set()
    value_fields = {f for a in vaggs for f in a.expr.fields()} | set(keys)
    passing = rt.mask_select(table, pred).valid if pred is not None else table.valid
    n_pass = int(passing.sum())
    cap = table.capacity
    nbytes = _bytes(table.valid) + sum(_bytes(table.cols[f]) for f in pred_fields)
    left_rest = [f for f in value_fields - pred_fields if f in table.cols]
    if right is not None:
        left_rest = sorted(set(left_rest) | (set(kw["left_on"]) - pred_fields))
        need = (value_fields & set(right.cols)) | set(kw["right_on"])
        nbytes += _bytes(right.valid) + sum(_bytes(right.cols[f]) for f in need)
    nbytes += sum(n_pass * table.cols[f].element_size() for f in left_rest)
    dtypes = {**({k: c.dtype for k, c in right.cols.items()} if right is not None else {}),
              **{k: c.dtype for k, c in table.cols.items()}}
    fields = pred_fields | value_fields
    prog = exprcode.compile_program(
        pred, [a.expr for a in vaggs],
        {f: exprcode.column_type(dtypes[f]) for f in fields}, {f: 0 for f in fields})
    ops = cap * prog.n_pred + n_pass * (len(prog.code) - prog.n_pred)
    return nbytes, ops


def result_bytes(out) -> int:
    from repro_torch.relational.runtime import VecTable

    if isinstance(out, VecTable):
        return _bytes(out.valid) + sum(_bytes(c) for c in out.cols.values())
    return sum(_bytes(v) for v in out.values())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card() -> str:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build()
    for name in build.KERNELS:
        build.library(name)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, one process per source)")
    for name, p in paths.items():
        lines = [ln.strip() for ln in p.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        for ln in lines:
            log(f"  ptxas {name}: {ln}")


def phase_edges() -> None:
    """Kernels against plain versions on small cases at the edges."""
    import numpy as np

    from repro_torch.convert import vectable_from_arrays
    from repro_torch.core.expr import AggSpec, col, const
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(1)
    n = 1003  # not a multiple of the block size
    cols = {
        "a": rng.integers(-50, 50, n).astype(np.int32),
        "x": rng.uniform(-2, 2, n).astype(np.float32),
        "d": np.round(rng.uniform(0, 0.1, n), 2).astype(np.float32),
        "k": rng.integers(0, 7, n).astype(np.int32),
        "fk": rng.integers(-3, 40, n).astype(np.int32),  # partly out of domain
        "flag": rng.random(n) < 0.5,
    }
    valid = rng.random(n) < 0.9
    t = vectable_from_arrays(cols, valid, "cuda")
    aggs = (AggSpec("sum", col("x") * (1.0 - col("d")), "s"),
            AggSpec("min", col("x"), "mn"), AggSpec("max", col("a") / 3, "mx"),
            AggSpec("count", const(1), "c"), AggSpec("sum", col("flag"), "sf"))
    preds = {
        "mixed": (col("d") <= 0.07) & (col("a") > -10.5) & ~col("flag"),
        "empty": col("a") > 1000,
    }
    checked = 0
    for label, pred in preds.items():
        got = ops.fused_select_agg(t, pred, aggs)
        want = ref.fused_select_agg(t, pred, aggs)
        compare_outputs(f"fused_select_agg[{label}]", got, want)
        checked += 1
        if label == "empty" and not (float(got["mn"]) == float("inf")
                                     and float(got["mx"]) == float("-inf")):
            raise AssertionError("empty selection must give min=+inf, max=-inf")
        for nb_keys, doms in ((("k",), ((0, 6),)),
                              (("k", "a"), ((0, 6), (-50, 49))),
                              (("fk", "a"), ((0, 99), (-2000, 1999)))):
            nb = 1
            for lo, hi in doms:
                nb *= hi - lo + 1
            args = (t, pred, nb_keys, aggs, min(nb, 64), doms, nb)
            compare_outputs(f"grouped_select_agg[{label},nb={nb}]",
                            ops.grouped_select_agg(*args), ref.grouped_select_agg(*args))
            checked += 1
    # build side: duplicate keys (first occurrence wins), keys outside the
    # probe's domain, a group key and a value on the build side
    m = 64
    rkeys = rng.integers(0, 30, m).astype(np.int32)
    right = vectable_from_arrays(
        {"rk": rkeys, "g": rng.integers(0, 3, m).astype(np.int32),
         "w": rng.uniform(0, 5, m).astype(np.float32)},
        rng.random(m) < 0.9, "cuda")
    jaggs = (AggSpec("count", const(1), "c"), AggSpec("sum", col("w") * col("x"), "s"),
             AggSpec("max", col("w"), "mx"), AggSpec("min", col("a"), "mn"))
    # the last grouping has 400,000 buckets, past the 48 KB of shared
    # accumulators, so rows add into the global accumulators
    for label, pred in (("mixed", preds["mixed"]), ("none", None), ("empty", preds["empty"])):
        for keys, doms in ((("k",), ((0, 6),)), (("g", "k"), ((0, 2), (0, 6))),
                           (("fk", "a"), ((0, 99), (-2000, 1999)))):
            nb = 1
            for lo, hi in doms:
                nb *= hi - lo + 1
            kw = dict(left_on=("fk",), right_on=("rk",), join_key_domains=((0, 29),),
                      join_num_buckets=30, keys=keys, aggs=jaggs, max_groups=nb,
                      key_domains=doms, num_buckets=nb, pred=pred)
            compare_outputs(f"grouped_join_agg[{label},{'+'.join(keys)}]",
                            ops.grouped_join_agg(t, right, **kw),
                            ref.grouped_join_agg(t, right, **kw))
            checked += 1
    log(f"edge cases: {checked} kernel calls match their plain versions")


def phase_edges_la(pool) -> None:
    """kmeans_step and segsum against their plain versions at the edges."""
    import numpy as np
    import torch

    from repro_torch.convert import tensors_from_arrays
    from repro_torch.kernels import ops, ref
    from repro_torch.kmeans import check_step, reference_step

    def clusters(n, d, k, seed):
        rng = np.random.default_rng(seed)
        centres = rng.normal(0, 5, (k, d))
        x = centres[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d))
        return x.astype(np.float32), rng.normal(0, 5, (k, d)).astype(np.float32)

    cases = {
        "ragged n": clusters(1003, 8, 16, 1),       # n not a multiple of any block
        "k=1": clusters(1000, 8, 1, 2),
        "d=3": clusters(999, 3, 7, 3),
        "d=128": clusters(2000, 128, 8, 4),         # the widest point the kernel takes
        "k*d past 48 KB": clusters(5000, 64, 256, 5),    # dynamic shared memory
        "k*d past opt-in": clusters(3000, 64, 512, 6),   # global accumulators
    }
    x, c = clusters(4099, 8, 6, 7)
    c[4] = c[2]   # an exact copy: its points go to index 2, index 4 counts 0
    c[5] = 1e4    # far from every point: an empty cluster, zero sums
    cases["duplicate and far centroids"] = (x, c)
    for label, (x, c) in cases.items():
        xt, ct = tensors_from_arrays(x, c, device="cuda")
        got = ops.kmeans_step(xt, ct)
        check_step(f"kmeans_step[{label}]", got, ref.kmeans_step(xt, ct),
                   reference_step(x, c, pool.map), KERNEL_RTOL)
        if label.startswith("duplicate"):
            sums, counts = got
            if not (counts[4] == 0 and counts[2] > 0 and counts[5] == 0
                    and bool((sums[4] == 0).all()) and bool((sums[5] == 0).all())):
                raise AssertionError(f"kmeans_step: copies and empty clusters: {counts.tolist()}")
    rng = np.random.default_rng(8)
    seg_cases = {"ragged n": (1003, 8, 16), "d=1": (777, 1, 3),
                 "K*d past 48 KB": (5000, 64, 256), "K*d past opt-in": (3000, 64, 1024)}
    for label, (n, d, k) in seg_cases.items():
        data = rng.normal(size=(n, d)).astype(np.float32)
        ids = rng.integers(-2, k + 2, n).astype(np.int32)  # some out of range
        ids[:5] = k - 1
        ids[ids == 1] = 0  # segment 1 stays empty
        dt, it = tensors_from_arrays(data, ids, device="cuda")
        got = ops.segsum(dt, it, k)
        check_segsum(f"segsum[{label}]", got, dt, it, k)
        if not bool((got[1] == 0).all()):
            raise AssertionError("segsum: an empty segment is not zero")
    torch.cuda.synchronize()
    log(f"edge cases: {len(cases)} kmeans_step and {len(seg_cases)} segsum calls match "
        "their plain versions")


def phase_main_path(sf: float):
    """Generate TPC-H, run the six queries once through Frame.collect on
    the card with the launch counts set to 0 just before, and hold each
    result against the numpy reference."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.relational import tpch

    t0 = time.perf_counter()
    tables = tpch.generate(sf=sf, seed=0)
    ctx = tpch.make_context(tables)
    ctx.statistics()
    srcs = ctx.sources("cuda")
    torch.cuda.synchronize()
    sizes = {k: len(next(iter(v.values()))) for k, v in tables.items()}
    dev_bytes = sum(c.numel() * c.element_size() + t.valid.numel()
                    for t in srcs.values() for c in t.cols.values())
    log(f"tpch sf={sf} seed=0: {sizes}; {dev_bytes / 1e6:.1f} MB of columns on the card; "
        f"set-up {time.perf_counter() - t0:.1f} s")
    frames = {q: f(ctx) for q, f in tpch.QUERIES.items()}

    per_query = {}
    results = {}
    with recording(TPCH_KERNELS) as captured:
        ops.reset_launches()
        for q, frame in frames.items():
            before = dict(ops.LAUNCHES)
            results[q] = frame.collect(device="cuda")
            per_query[q] = {k: ops.LAUNCHES[k] - before[k] for k in before}
        launches = dict(ops.LAUNCHES)

    for q, got in results.items():
        check_query(q, got, tpch.REFERENCES[q](tables))
    log(f"TPC-H path: six queries match the numpy references; launches {launches}")
    for kname, queries in EXPECTED.items():
        for q in queries:
            if per_query[q][kname] < 1:
                raise AssertionError(f"{q} did not launch {kname}: {per_query[q]}")
    return tables, ctx, frames, launches, captured


def phase_kmeans(pool):
    """The k-means path at full width: FuseKMeansStep + Parallelize(8) on
    LocalBackend(use_kernels=True), a warm-up and KMEANS_STEPS steps with the
    launch counts set to 0 just before and read just after; each step held
    against a numpy f64 step from the same centroids; then the unfused
    program (plain torch) from the last step's centroids, its la.SegSum
    inputs recorded.  Returns (launches, the last step's kmeans_step calls,
    the SegSum inputs, step ms, a function that runs one more step)."""
    import numpy as np
    import torch

    from repro_torch.backends import emit
    from repro_torch.backends.local import LocalBackend
    from repro_torch.convert import tensors_from_arrays
    from repro_torch.kernels import ops
    from repro_torch.kmeans import check_step, make_data, program, reference_step

    n, d, k = KMEANS_N, KMEANS_D, KMEANS_K
    t0 = time.perf_counter()
    x, c0 = make_data(n, d, k, KMEANS_SEED)
    X, C = tensors_from_arrays(x, c0, device="cuda")
    torch.cuda.synchronize()
    log(f"k-means n={n} d={d} k={k} seed={KMEANS_SEED}: {X.numel() * 4 / 2 ** 20:.0f} MiB "
        f"of points on the card; set-up {time.perf_counter() - t0:.1f} s")
    fused = LocalBackend(use_kernels=True, device="cuda").compile(
        program(n, d, k, parallel=KMEANS_PARALLEL))

    steps, times = [], []
    with recording(("kmeans_step",)) as captured:
        ops.reset_launches()
        fused({}, X, C)  # warm-up
        for _ in range(KMEANS_STEPS):
            captured.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sums, counts = fused({}, X, C)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            steps.append((C, sums, counts))
            C = sums / counts.clamp_min(1e-9)[:, None]
        launches = dict(ops.LAUNCHES)
    expect = KMEANS_PARALLEL * (KMEANS_STEPS + 1)
    if launches["kmeans_step"] != expect:
        raise AssertionError(f"kmeans_step launched {launches['kmeans_step']} times, not {expect}")

    for i, (c_in, sums, counts) in enumerate(steps):
        stats = reference_step(x, c_in.cpu().numpy(), pool.map)
        err = check_step(f"k-means step {i}", (sums, counts), (stats.sums, stats.counts),
                         stats, STEP_RTOL)
        dc = np.abs(counts.cpu().numpy() - stats.counts)
        log(f"  step {i}: matches numpy f64; {stats.n_amb} ambiguous points (at most "
            f"{int(stats.cand.max())} per centroid); counts differ by {int(dc.sum())} in all, "
            f"at most {int(dc.max())}; largest |sum difference| {err:.6g}")

    # the unfused program, from the last step's centroids
    seg_inputs = []
    segsum_emitter = emit._EMIT["la.SegSum"]

    def seg_recorder(ctx, ins, args):
        seg_inputs.append((args[0], args[1], int(ins.param("k"))))
        return segsum_emitter(ctx, ins, args)

    emit._EMIT["la.SegSum"] = seg_recorder
    try:
        unfused = LocalBackend(use_kernels=True, device="cuda").compile(
            program(n, d, k))
        c_in, sums, counts = steps[-1]
        got = unfused({}, X, c_in)
    finally:
        emit._EMIT["la.SegSum"] = segsum_emitter
    check_step("unfused program vs fused", got, (sums, counts), stats, KERNEL_RTOL)
    log(f"k-means path: {KMEANS_STEPS} steps match numpy f64, the unfused program matches the "
        f"fused one; launches {launches}")
    return launches, list(captured), seg_inputs, times, lambda: fused({}, X, c_in)


def phase_segsum(seg_inputs):
    """segsum on the unfused program's la.SegSum inputs, counted alone."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launches()
    outs = [ops.segsum(*a) for a in seg_inputs]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches["segsum"] != len(seg_inputs):
        raise AssertionError(f"segsum launched {launches['segsum']} times")
    for i, (out, a) in enumerate(zip(outs, seg_inputs)):
        check_segsum(f"segsum#{i}", out, *a)
    log(f"segsum on the SegSum inputs of the unfused k-means program: matches its plain "
        f"version; launches {launches}")
    return launches, [("segsum", a, {}) for a in seg_inputs]


def phase_parallel(tables, frames) -> None:
    """The six queries with ``parallel=4``, counts set to 0 just before and
    read just after; Q1 and Q6 launch their kernel once per chunk.  Then
    each kernel call of this run against its plain version on the same
    inputs (replays, not counted)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.relational import tpch

    results, per_query = {}, {}
    with recording(TPCH_KERNELS) as captured:
        ops.reset_launches()
        for q, frame in frames.items():
            before = dict(ops.LAUNCHES)
            results[q] = frame.collect(device="cuda", parallel=PARALLEL)
            per_query[q] = {k: ops.LAUNCHES[k] - before[k] for k in before}
        launches = dict(ops.LAUNCHES)
    for q, got in results.items():
        check_query(q, got, tpch.REFERENCES[q](tables))
    # Q6: once per chunk; Q1: once per chunk, then once for the recombine
    for q, kname, want in (("q6", "fused_select_agg", PARALLEL),
                           ("q1", "grouped_select_agg", PARALLEL + 1)):
        if per_query[q][kname] != want:
            raise AssertionError(f"{q} with parallel={PARALLEL} launched {kname} "
                                 f"{per_query[q][kname]} times, not {want}")
    log(f"TPC-H path with parallel={PARALLEL}: six queries match the numpy references; "
        f"launches {launches}; per query {json.dumps(per_query)}")
    if len(captured) != sum(launches.values()):
        raise AssertionError(f"{len(captured)} wrapper calls recorded, {launches} launches")
    worst = {}
    for i, (name, args, kw) in enumerate(captured):
        err = compare_outputs(f"parallel {name}#{i}", getattr(ops, name)(*args, **kw),
                              getattr(ref, name)(*args, **kw))
        worst[name] = max(worst.get(name, 0.0), err)
    log(f"TPC-H path with parallel={PARALLEL}: its {len(captured)} kernel calls match their "
        f"plain versions; max abs error {json.dumps(worst)}")


def _library_ms(name: str, args: tuple):
    """The one PyTorch call that computes the kernel's function, timed,
    where there is one: ``index_add_`` for segsum (ids in range here)."""
    import torch

    if name != "segsum":
        return None
    data, ids, k = args
    if not bool(((ids >= 0) & (ids < k)).all()):
        return None
    return cuda_ms(lambda: torch.zeros((k, data.shape[1]), dtype=data.dtype,
                                       device=data.device).index_add_(0, ids, data))


def phase_kernels(captured, launches, pool):
    """Each kernel against its plain version on the paths' inputs."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kmeans import check_step, reference_step

    rows = []
    agg = {}
    for i, (name, args, kw) in enumerate(captured):
        kern, plain = getattr(ops, name), getattr(ref, name)
        got, want = kern(*args, **kw), plain(*args, **kw)
        if name == "kmeans_step":
            x, c = (a.cpu().numpy() for a in args)
            err = check_step(f"kmeans_step#{i}", got, want, reference_step(x, c, pool.map),
                             KERNEL_RTOL)
        elif name == "segsum":
            err = check_segsum(f"segsum#{i}", got, *args)
        else:
            err = compare_outputs(f"{name}#{i}", got, want)
        ms = cuda_ms(lambda: kern(*args, **kw))
        pms = cuda_ms(lambda: plain(*args, **kw))
        lib = _library_ms(name, args)
        nbytes, nops = work(name, args, kw)
        if name in TPCH_KERNELS:
            nbytes += result_bytes(want)
            shape = {"rows": args[0].capacity, "join_buckets": kw.get("join_num_buckets"),
                     "buckets": kw.get("num_buckets",
                                       args[-1] if name == "grouped_select_agg" else None)}
        else:
            shape = {"shapes": [list(a.shape) for a in args if hasattr(a, "shape")]}
        rows.append({"kernel": name, "call": i, **shape, "ms": ms, "plain_ms": pms,
                     "library_ms": lib, "bytes": nbytes, "ops": nops, "max_abs_err": err})
        a = agg.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bytes": 0,
                                  "ops": 0, "err": 0.0})
        a["ms"] += ms
        a["plain_ms"] += pms
        if lib is not None:
            a["library_ms"] = (a["library_ms"] or 0.0) + lib
        a["bytes"] += nbytes
        a["ops"] += nops
        a["err"] = max(a["err"], err)
    log("kernel calls: " + json.dumps(rows))
    out = []
    for name in REPLACES:
        a = agg[name]
        t_bytes, t_ops = a["bytes"] / PEAK_BYTES * 1e3, a["ops"] / PEAK_F32 * 1e3
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": a["library_ms"],
        })
    log("kernels vs plain versions on the paths' inputs: all match")
    return out


def phase_queries(tables, frames, reps: int) -> None:
    """End-to-end latency of ``Frame.collect`` per query, sequential and
    with ``parallel=4`` in turns, and each run split into its compile
    (lowering, host only) and execute (operators, kernels and the copy of
    the result to the host) parts."""
    import torch

    from repro_torch.frontends.dataflow import _to_numpy

    n_li = len(tables["lineitem"]["l_orderkey"])
    summary = {"sequential": {}, f"parallel{PARALLEL}": {}}
    for q, frame in frames.items():
        ctx = frame._ctx
        for par, mode in ((None, "sequential"), (PARALLEL, f"parallel{PARALLEL}")):
            frame.collect(device="cuda", parallel=par)  # warm-up
            times, comp, run = [], [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frame.collect(device="cuda", parallel=par)
                t1 = time.perf_counter()
                compiled = ctx.compile(frame, parallel=par, device="cuda")
                t2 = time.perf_counter()
                _to_numpy(compiled(ctx.sources("cuda"))[0])
                t3 = time.perf_counter()
                times.append((t1 - t0) * 1e3)
                comp.append((t2 - t1) * 1e3)
                run.append((t3 - t2) * 1e3)
            med = statistics.median(times)
            summary[mode][q] = {"median_ms": med, "min_ms": min(times), "max_ms": max(times),
                                "compile_ms": statistics.median(comp),
                                "execute_ms": statistics.median(run),
                                "lineitem_rows_per_s": n_li / (med / 1e3)}
            log(f"query {q} {mode}: median {med:.3f} ms over {reps} runs "
                f"(min {min(times):.3f}, max {max(times):.3f}; compile "
                f"{statistics.median(comp):.3f}, execute {statistics.median(run):.3f}); "
                f"{n_li / (med / 1e3):.4g} lineitem rows/s")
    log("queries: " + json.dumps(summary))


def report_kmeans(times) -> None:
    med = statistics.median(times)
    log(f"k-means step (FuseKMeansStep + Parallelize({KMEANS_PARALLEL}), n={KMEANS_N}): "
        f"median {med:.3f} ms over {len(times)} steps (min {min(times):.3f}, max "
        f"{max(times):.3f}); {KMEANS_N / (med / 1e3):.4g} points/s")
    log("kmeans: " + json.dumps({"median_ms": med, "min_ms": min(times),
                                 "max_ms": max(times), "steps": len(times),
                                 "points_per_s": KMEANS_N / (med / 1e3)}))


#: name fragments of this package's CUDA kernels in a profiler trace
OUR_KERNELS = ("fsa_main", "fsa_finalize", "gsa_main", "gja_main", "vm_init_accumulators",
               "kms_main", "seg_main")


def _device_events(prof):
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0]


def phase_profile(workloads, captured) -> None:
    """torch.profiler over each workload (after a profiled warm-up run):
    device time by kernel and the device's busy share of the traced span;
    then each path kernel call's own kernels alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, run in workloads.items():
        for _ in range(2):  # the first run warms the profiler up
            with profile(activities=acts) as prof:
                run()
                torch.cuda.synchronize()
        spans = [e.time_range for e in prof.events()]
        span_ms = (max(r.end for r in spans) - min(r.start for r in spans)) / 1e3
        events = _device_events(prof)
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        ours = sum(e.self_device_time_total for e in events
                   if any(k in e.key for k in OUR_KERNELS)) / 1e3
        log(f"profile: {label}, traced span {span_ms:.3f} ms, device kernels "
            f"{dev_ms:.3f} ms (this package's CUDA kernels {ours:.3f} ms), "
            f"busy share {dev_ms / span_ms:.4f}")
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        log(f"profile top ({label}): " + json.dumps([
            {"name": e.key[:70], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3} for e in top]))
    iters, rows = 10, []
    for i, (name, args, kw) in enumerate(captured):
        kern = getattr(ops, name)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                kern(*args, **kw)
            torch.cuda.synchronize()
        own = sum(e.self_device_time_total for e in _device_events(prof)
                  if any(k in e.key for k in OUR_KERNELS)) / 1e3 / iters
        rows.append({"kernel": name, "call": i, "kernel_device_ms": own})
    log("kernel device time (own launches only, mean of 10): " + json.dumps(rows))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=5.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from concurrent.futures import ThreadPoolExecutor

    smi = phase_card()
    phase_build()
    with ThreadPoolExecutor(8) as pool:
        phase_edges()
        phase_edges_la(pool)
        tables, ctx, frames, launches, captured = phase_main_path(a.sf)
        km_launches, km_captured, seg_inputs, km_times, km_step = phase_kmeans(pool)
        seg_launches, seg_captured = phase_segsum(seg_inputs)
        phase_parallel(tables, frames)
        launches.update(kmeans_step=km_launches["kmeans_step"], segsum=seg_launches["segsum"])
        captured += km_captured + seg_captured
        kernels = phase_kernels(captured, launches, pool)
    phase_queries(tables, frames, a.reps)
    report_kmeans(km_times)
    if a.profile:
        phase_profile({
            "one pass over the six queries": lambda: [f.collect(device="cuda")
                                                      for f in frames.values()],
            f"one pass over the six queries with parallel={PARALLEL}":
                lambda: [f.collect(device="cuda", parallel=PARALLEL) for f in frames.values()],
            "one k-means step": km_step,
        }, captured)
    del captured, km_captured, seg_captured, seg_inputs
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
