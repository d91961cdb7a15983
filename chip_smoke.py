#!/usr/bin/env python3
"""On-card check of the torch port: TPC-H, k-means and serving Qwen2-1.5B
through ``repro_torch`` on one GPU.

    python3 chip_smoke.py [--sf 5] [--reps 5] [--profile]

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   kernels built once (``fused_select_agg``, ``grouped_select_agg`` and
   ``grouped_join_agg`` are generated per query and built at their first
   call; their builds, reuses and nvcc seconds are printed after the edge
   cases, the TPC-H path and at the end);
2. each CUDA kernel against its plain PyTorch version on edge cases
   (empty selection, ragged capacity, out-of-domain and duplicate join
   keys, more buckets than shared memory holds, ``grouped_select_agg`` at
   the borders of its routes (reg, smem, global) and ``grouped_join_agg``
   on each, printing the route each took, a predicate deeper than the old
   interpreter's stack through both select kernels, and the generated
   kernels' fixed-order routes run twice for the same bits; for k-means
   ragged n, a d = 1 case at adversarial near-ties,
   n = 0, fewer points than a tile, k = 1, d = 3, the top of the
   tensor-core route's range and just past it, chunk views that start
   inside a 16-byte granule, duplicate and far centroids, centroid tables
   past 48 KB and past the opt-in shared memory, each printing the route it
   took; for segsum ids at K−1 and out of range, empty segments, d = 1 and
   d = 3 views that start mid-granule, accumulators past 48 KB and past the
   opt-in shared memory, each printing its route);
3. the TPC-H path: TPC-H at ``--sf`` (seed 0), the six queries through
   ``Frame.collect(device="cuda")``, each held against the numpy
   reference, with the kernels' launch counts and the generated kernels'
   routes read around that one run (Q1 on ``gsa_reg``, Q4's inner count
   on an atomic route, Q4's and Q12's join on ``gja_reg``); the path's
   calls on a fixed-order route run twice more, for the same bits; one
   pass under ``torch.profiler``, which must show the generated kernels
   (the join's build and probe among them) and no kernel of the old
   expression interpreter (``fsa_main``, ``fsa_finalize``, ``gsa_main``
   and the join's: every relational kernel a generated one); the ``grouped_select_agg`` wrapper's time of Q1 and Q4
   split into the generated launch, ``decode_bucket_keys`` and ``compact``,
   and the ``grouped_join_agg`` wrapper's of Q4 and Q12 into the build
   launch, the probe launch and the epilogue;
4. the k-means path: 2^24 points, d = 8, k = 16 (seed 0, made as
   ``examples/kmeans.py`` makes them), the program built with ``Builder``,
   then ``FuseKMeansStep`` and ``Parallelize(8)``, run on
   ``LocalBackend(use_kernels=True)`` for a warm-up and 5 steps,
   ``kmeans_step`` launched 8 times per step, every call on the
   tensor-core route (``kms_tc``, the route line); each step held against a
   numpy f64 step from the same centroids, and the unfused program against
   the fused one; one path call under ``torch.profiler``, which must show
   ``kms_tc`` and not ``kms_main``, then run twice more: the same bits;
5. ``segsum`` on the unfused program's ``la.SegSum`` inputs (the JAX
   package's emitters never call its segsum kernel either), counted alone,
   printing its route (``seg_tc``, checked, and under ``torch.profiler``
   ``seg_tc`` and not ``seg_main``), then run twice more: the same bits;
6. the TPC-H path with ``parallel=4``: the six queries again, split into
   four chunks, against the references; Q1 and Q6 launch their kernel
   once per chunk; the route of every ``grouped_select_agg`` call; each
   kernel call of this path (chunk views, Q1's recombine, Q4's split inner
   aggregation) against its plain version;
7. the serving path: Qwen2-1.5B (``configs/qwen2_1_5b.py`` ``CONFIG``, 28
   layers at full width, bf16, parameters from ``model.init`` with seed 0)
   with ``attn_mode="pallas"``, 8 requests of 2048 prompt tokens (made as
   ``launch/serve.py`` makes them) in waves of 4, 32 greedy tokens each,
   a cache of 2080, through ``launch.serve``'s ``make_run_wave`` and
   ``serve_loop`` after one warm-up wave; ``flash_attention`` launched 28
   times per wave; then the same parameters and prompts with the plain
   attention (``ref``) and with ``chunked``, each path held against the
   plain one; the kernel against its plain version on edge cases first
   (S ∈ {1, 77, 200, 2048}, D ∈ {32, 64, 128}, group ∈ {1, 6}, f32 on the
   CUDA-core kernel and bf16 on the tensor-core one, non-causal, windows
   64 and 128, a non-default scale), each with its share of the bound and,
   in bf16, its distance from the tensor-core recipe
   (``ref.flash_attention_tiled``);
8. each kernel against its plain version on the inputs the paths gave it,
   both timed with CUDA events, with its bound (operations at the peak
   rate of the operands' type: bf16 on the tensor cores, else f32) and,
   for ``segsum`` and ``flash_attention``, the one PyTorch call
   (``index_add_``, ``scaled_dot_product_attention``) that computes the
   same function; for ``kmeans_step`` the read floor, ``torch.sum`` over
   each call's points (the card's achieved read rate, not a library call); each served attention call's distance from the
   tensor-core recipe beside its distance from the plain version; then one
   served call under ``torch.profiler``, which must show the tensor-core
   kernel (``fa_wgmma``) and not the CUDA-core one (``fa_main``);
9. per-query latency (median over ``--reps`` after a warm-up), sequential
   and with ``parallel=4``, lineitem rows/s, the k-means step time and
   points/s, and the serving numbers (prefill ms per wave, decode ms per
   step, tokens/s, request latency p50/p99 from the port's tracer); with
   ``--profile``, device time by kernel and busy share, one serving wave
   included.

Then the card's line, the ``kernels`` JSON line and, last,
``{"ok": true, "device": ...}``.  Any failed check raises, so the exit code
is not 0 and no result line is printed; without a visible CUDA device the
script exits with code 2.

Tolerances.  Kernel against plain version: integers (keys, counts,
validity) exact; floats within rtol 1e-4 of the plain value, because the
kernels add float sums with atomics and per-block partials, in another
order than torch's reductions (each order has error of order
sqrt(n)·2^-24 on n ≈ 10^6 terms); ``fused_select_agg`` and the reg route
of ``grouped_select_agg`` add in a fixed order, so two runs give the same
bits.  Query against the numpy reference: integers exact, floats rtol
2e-4 (tests/test_tpch.py's tolerance: f32
accumulation against an f64 oracle).  Segment sums: a sum may also
differ by 1e-5 of the sum of |x| over its segment, since a sum whose terms
cancel has a rounding error that scales with Σ|x| and not with the result.
k-means steps go by the tie-margin rule of ``repro_torch.kmeans`` (counts
add up to n and sums to Σx whatever the ties; each count and sum may move
by what the points within a few f32 roundings of a tie carry): steps
against numpy f64 at rtol 2e-4, kernel against plain version at rtol 1e-4.
Kernel calls on the ``parallel=4`` path are held against their plain
versions too, but timed and counted only on the sequential path.
``flash_attention`` against its plain version: bf16 outputs within two
bf16 roundings, |got − want| ≤ 2^-7·|want| + 1e-3·max|v| (both sum in f32
in different orders, then round); f32 outputs within rtol 1e-4, atol
1e-5.  The serving path against the plain path: the logits of the
prefill and of every decode step both paths were fed the same tokens
differ by at most the larger of 5 % of the prefill logits' standard
deviation and 1.5 times the noise floor, the same largest |Δ| between the
plain path and a run whose prefill attention is computed in f64 and
rounded once (exactly rounded).  In bf16 a rounding flip in one attention
output grows through 28 layers: that floor was 9.0 % of the std on the
H100, so 5 % alone holds no bf16 path, the exact one included.  Each
path's own distance from the exact run is printed beside it.  That logits
check is what holds decode: a step's greedy tokens can differ only where
the plain path's top-2 gap is under twice the logits' |Δ|, and random
weights make gaps of that order, so the tokens are checked only to be
their logits' argmax, and where each request's tokens first leave the
plain path's is printed with the plain path's top-2 gap there.
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
#: H100 SXM data-sheet peaks: HBM bytes/s, f32 (non-tensor-core) op/s and
#: dense bf16 tensor-core op/s; a call's operations are bounded at the rate
#: of its operands' type (``ops_peak``)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16_TC = 989e12
#: flash_attention against its plain version (see the docstring)
ATTN_F32_RTOL, ATTN_F32_ATOL = 1e-4, 1e-5
ATTN_BF16_REL, ATTN_BF16_VMAX = 2.0 ** -7, 1e-3
#: the serving path against the plain path: logits within the larger of
#: LOGIT_STD_SHARE of their std and NOISE_FACTOR times the plain path's own
#: distance from exactly rounded attention
LOGIT_STD_SHARE, NOISE_FACTOR = 0.05, 1.5

#: the k-means path: examples/kmeans.py's d and k at 512 times its n
KMEANS_N, KMEANS_D, KMEANS_K, KMEANS_SEED, KMEANS_PARALLEL = 1 << 24, 8, 16, 0, 8
#: timed k-means steps after the warm-up
KMEANS_STEPS = 5
#: chunks of the TPC-H path with parallelism
PARALLEL = 4
#: the serving path: Qwen2-1.5B at full width and depth, its traffic
SERVE_ARCH = "qwen2-1.5b"
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_CAP = 8, 4, 2048, 32, 2080

TPCH_KERNELS = ("fused_select_agg", "grouped_select_agg", "grouped_join_agg")
REPLACES = {
    "fused_select_agg": "src/repro/kernels/fused_select_agg.py:84",
    "grouped_select_agg": "src/repro/kernels/grouped_select_agg.py:110",
    "grouped_join_agg": "src/repro/kernels/grouped_join_agg.py:158",
    "kmeans_step": "src/repro/kernels/kmeans_step.py:59",
    "segsum": "src/repro/kernels/segsum.py:47",
    "flash_attention": "src/repro/kernels/flash_attention.py:100",
}
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}
#: the kernels generated per query: their sources above are templates that
#: follow the query's row functions, which this module writes
GENERATED_BY = {k: "src/repro_torch/kernels/codegen.py"
                for k in ("fused_select_agg", "grouped_select_agg", "grouped_join_agg")}
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


def check_attention(what: str, got, want, v):
    """flash_attention against its plain version: bf16 within two bf16
    roundings plus 1e-3 of max|v|; f32 within rtol 1e-4, atol 1e-5.
    Returns (the max absolute error, the largest share of the bound)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.bfloat16:
        bound = ATTN_BF16_REL * w.abs() + ATTN_BF16_VMAX * float(v.float().abs().max())
    else:
        bound = ATTN_F32_RTOL * w.abs() + ATTN_F32_ATOL
    if not bool((err <= bound).all()):
        raise AssertionError(f"{what}: differs from its plain version by {float(err.max())}")
    return float(err.max()), float((err / bound).max())


def tiled_gap(got, args, kw) -> float:
    """A bf16 attention output's largest distance from the tensor-core
    kernel's recipe (``ref.flash_attention_tiled``) on the same inputs."""
    from repro_torch.kernels import ref

    return float((got.float() - ref.flash_attention_tiled(*args, **kw).float()).abs().max())


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
    program's instructions per row evaluated (the cost of a VM step, where
    the kernel interprets it, is not counted)."""
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
    if name == "flash_attention":  # q, k, v in, o out; two products per unmasked pair
        q, k, v = args
        b, hq, s, d = q.shape
        return _bytes(q) * 2 + _bytes(k) + _bytes(v), 4 * b * hq * d * attention_pairs(s, kw)
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
        {f: exprcode.column_type(dtypes[f]) for f in fields}, {f: 0 for f in fields},
        max_stack=None)
    ops = cap * prog.n_pred + n_pass * (len(prog.code) - prog.n_pred)
    return nbytes, ops


def attention_pairs(s: int, kw: dict) -> int:
    """(query, key) pairs the mask keeps, out of s²."""
    from repro_torch.kernels import ref

    return int(ref.attention_mask(s, kw.get("causal", True), kw.get("window"), "cpu").sum())


def ops_peak(args: tuple) -> float:
    """The card's peak op/s for the call's operands: the bf16 tensor-core
    rate where its float tensors are all bf16, else f32 outside the tensor
    cores (tables, f32 tensors)."""
    import torch

    dtypes = {a.dtype for a in args if isinstance(a, torch.Tensor) and a.is_floating_point()}
    return PEAK_BF16_TC if dtypes == {torch.bfloat16} else PEAK_F32


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
    log(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, one process per source; "
        f"{', '.join(build.KERNELS)}; fused_select_agg, grouped_select_agg and "
        "grouped_join_agg are generated per query at their first call)")
    for name, p in paths.items():
        entry = "?"
        for ln in p.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in ln:  # the mangled kernel the lines below describe
                entry = ln.split("'")[1] if "'" in ln else ln.strip()
            elif "registers" in ln or "spill" in ln:
                log(f"  ptxas {name} {entry}: {ln.strip()}")


def report_generated(when: str) -> None:
    """The generated kernels' libraries so far: built (and nvcc's seconds),
    reused from an earlier build, distinct queries in this process."""
    from repro_torch.kernels import build, ops

    g = build.GEN_STATS
    kernels = sum(len(q.kernels) for q in ops._QUERIES.values())
    per = g["nvcc_s"] / g["built"] if g["built"] else 0.0
    log(f"generated kernels {when}: {int(g['built'])} libraries built, {int(g['reused'])} "
        f"reused, {kernels} distinct query kernels; nvcc {g['nvcc_s']:.2f} s in all, "
        f"{per:.2f} s per library, slowest {g['nvcc_max_s']:.2f} s")
    log("generated: " + json.dumps({"when": when, **g, "queries": kernels}))


def routed(fn, *args, **kw):
    """fn(*args, **kw) and the generated kernel routes it launched."""
    from repro_torch.kernels import ops

    before = dict(ops.GEN_LAUNCHES)
    out = fn(*args, **kw)
    return out, [r for r in before for _ in range(ops.GEN_LAUNCHES[r] - before[r])]


def same_bits(name: str, a, b) -> None:
    """Two outputs of a kernel (dicts or VecTables) must be bit-identical."""
    import torch

    from repro_torch.relational.runtime import VecTable

    if isinstance(a, VecTable):
        pairs = [("valid", a.valid, b.valid)] + [(k, a.cols[k], b.cols[k]) for k in a.cols]
    else:
        pairs = [(k, a[k], b[k]) for k in a]
    for k, x, y in pairs:
        if not torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y):
            raise AssertionError(f"{name}.{k}: two runs give different bits")


#: grouped_select_agg's routes at their borders: with three values (1 + 3
#: accumulators a bucket), reg ends at 16 buckets and smem at 3072 (48 KB)
GSA_BORDERS = ((16, "gsa_reg"), (17, "gsa_smem"), (3072, "gsa_smem"), (3073, "gsa_global"))


def deep_predicate(depth: int = 24):
    """Or-ed comparisons nested deeper than the interpreter's stack of 16."""
    from repro_torch.core.expr import col

    e = col("x") > 1.9
    for k in range(depth):
        e = (col("k").eq(k % 7) & (col("a") < k - 12)) | e
    return e


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
    routes = {}
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
            got, took = routed(ops.grouped_select_agg, *args)
            compare_outputs(f"grouped_select_agg[{label},nb={nb}]", got,
                            ref.grouped_select_agg(*args))
            routes[f"{label}, nb={nb}"] = took
            checked += 1
    # the routes at their borders, a predicate deeper than the interpreter's
    # stack, and the fixed-order kernels run twice
    aggs3 = (AggSpec("sum", col("x") * 2.0, "s"), AggSpec("min", col("a"), "mn"),
             AggSpec("max", col("x"), "mx"), AggSpec("count", const(1), "c"))
    for nb, route in GSA_BORDERS:
        args = (t, col("a") > -20, ("fk",), aggs3, nb, ((-3, nb - 4),), nb)
        got, took = routed(ops.grouped_select_agg, *args)
        if took != [route]:
            raise AssertionError(f"grouped_select_agg with {nb} buckets took {took}, not {route}")
        compare_outputs(f"grouped_select_agg[border nb={nb}]", got, ref.grouped_select_agg(*args))
        routes[f"border, nb={nb}"] = took
        checked += 1
    deep = deep_predicate()
    compare_outputs("fused_select_agg[deep predicate]", ops.fused_select_agg(t, deep, aggs3),
                    ref.fused_select_agg(t, deep, aggs3))
    args = (t, deep, ("k",), aggs3, 7, ((0, 6),), 7)
    got, took = routed(ops.grouped_select_agg, *args)
    compare_outputs("grouped_select_agg[deep predicate]", got, ref.grouped_select_agg(*args))
    routes["deep predicate, nb=7"] = took
    checked += 2
    same_bits("fused_select_agg[mixed]", ops.fused_select_agg(t, preds["mixed"], aggs),
              ops.fused_select_agg(t, preds["mixed"], aggs))
    args = (t, preds["mixed"], ("k",), aggs, 7, ((0, 6),), 7)
    same_bits("grouped_select_agg[mixed, reg]", ops.grouped_select_agg(*args),
              ops.grouped_select_agg(*args))
    log(f"edge cases, grouped_select_agg routes: {json.dumps(routes)}")
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
    # with three values, 7 groups take the reg route, 21 the smem one, and
    # 400,000 (past the 48 KB of shared accumulators) the global one
    join_routes = {}
    for label, pred in (("mixed", preds["mixed"]), ("none", None), ("empty", preds["empty"])):
        for keys, doms in ((("k",), ((0, 6),)), (("g", "k"), ((0, 2), (0, 6))),
                           (("fk", "a"), ((0, 99), (-2000, 1999)))):
            nb = 1
            for lo, hi in doms:
                nb *= hi - lo + 1
            kw = dict(left_on=("fk",), right_on=("rk",), join_key_domains=((0, 29),),
                      join_num_buckets=30, keys=keys, aggs=jaggs, max_groups=nb,
                      key_domains=doms, num_buckets=nb, pred=pred)
            got, took = routed(ops.grouped_join_agg, t, right, **kw)
            compare_outputs(f"grouped_join_agg[{label},{'+'.join(keys)}]", got,
                            ref.grouped_join_agg(t, right, **kw))
            join_routes[f"{label}, nb={nb}"] = took
            checked += 1
            if label == "mixed" and took == ["gja_reg"]:
                same_bits(f"grouped_join_agg[{label}, reg]", got,
                          ops.grouped_join_agg(t, right, **kw))
    want = {"gja_reg", "gja_smem", "gja_global"}
    if {r for took in join_routes.values() for r in took} != want:
        raise AssertionError(f"grouped_join_agg's edge cases took {join_routes}, not all of {want}")
    log(f"edge cases, grouped_join_agg routes: {json.dumps(join_routes)}")
    log(f"edge cases: {checked} kernel calls match their plain versions; fused_select_agg "
        "and the reg routes of grouped_select_agg and grouped_join_agg give the same bits "
        "twice")
    report_generated("after the edge cases")


def phase_edges_la(pool) -> None:
    """kmeans_step and segsum against their plain versions at the edges."""
    import numpy as np
    import torch

    from repro_torch.convert import tensors_from_arrays
    from repro_torch.kernels import ops, ref
    from repro_torch.kmeans import check_step, near_ties, reference_step

    def clusters(n, d, k, seed):
        rng = np.random.default_rng(seed)
        centres = rng.normal(0, 5, (k, d))
        x = centres[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d))
        return x.astype(np.float32), rng.normal(0, 5, (k, d)).astype(np.float32)

    # label: (points, centroids, (rows, floats) before the view's start)
    cases = {
        "ragged n": clusters(1003, 8, 16, 1),       # n not a multiple of any block
        "n < one tile": clusters(100, 8, 16, 9),
        "n not a multiple of 8 or 16": clusters(1001, 8, 16, 10),
        "k=1": clusters(1000, 8, 1, 2),
        "d=3": clusters(999, 3, 7, 3),
        "k=64 d=8 (top of the tensor-core range)": clusters(6000, 8, 64, 11),
        "k=32 d=16 (top of the tensor-core range)": clusters(6000, 16, 32, 12),
        "k=16 d=32 (top of the tensor-core range)": clusters(6000, 32, 16, 13),
        "k=65 d=8 (past the tensor-core range)": clusters(3000, 8, 65, 14),
        "d=128": clusters(2000, 128, 8, 4),         # the widest point the kernel takes
        "k*d past 48 KB": clusters(5000, 64, 256, 5),    # dynamic shared memory
        "k*d past opt-in": clusters(3000, 64, 512, 6),   # global accumulators
    }
    cases["d=1 at adversarial near-ties"] = near_ties(16, 256, 24, 0)
    cases = {label: (x, c, (0, 0)) for label, (x, c) in cases.items()}
    # chunk views whose start is not 16-byte aligned, as a Split makes them
    cases["view 4 bytes into a 16-byte granule"] = (*clusters(4099, 8, 16, 15), (0, 1))
    cases["view of d=3 rows from row 5 (60 bytes in)"] = (*clusters(3001, 3, 7, 16), (5, 0))
    x, c = clusters(4099, 8, 6, 7)
    c[4] = c[2]   # an exact copy: its points go to index 2, index 4 counts 0
    c[5] = 1e4    # far from every point: an empty cluster, zero sums
    cases["duplicate and far centroids"] = (x, c, (0, 0))
    routes = {}
    for label, (x, c, (rows, floats)) in cases.items():
        n, d = x.shape
        flat = np.zeros((rows + n + 1) * d + floats, np.float32)
        at = rows * d + floats
        flat[at:at + n * d] = x.ravel()
        xt = torch.from_numpy(flat).to("cuda")[at:at + n * d].view(n, d)
        ct = torch.from_numpy(c).to("cuda")
        before = dict(ops.KMEANS_LAUNCHES)
        got = ops.kmeans_step(xt, ct)
        routes[label] = [r for r in before if ops.KMEANS_LAUNCHES[r] != before[r]][0]
        check_step(f"kmeans_step[{label}]", got, ref.kmeans_step(xt, ct),
                   reference_step(x, c, pool.map), KERNEL_RTOL)
        if label.startswith("duplicate"):
            sums, counts = got
            if not (counts[4] == 0 and counts[2] > 0 and counts[5] == 0
                    and bool((sums[4] == 0).all()) and bool((sums[5] == 0).all())):
                raise AssertionError(f"kmeans_step: copies and empty clusters: {counts.tolist()}")
    before = dict(ops.KMEANS_LAUNCHES)
    sums, counts = ops.kmeans_step(torch.zeros((0, 8), device="cuda"),
                                   torch.ones((16, 8), device="cuda"))
    routes["n=0"] = [r for r in before if ops.KMEANS_LAUNCHES[r] != before[r]][0]
    if bool(sums.any()) or bool(counts.any()):
        raise AssertionError("kmeans_step: no points must give zero sums and counts")
    log(f"kmeans_step edge cases' routes: {json.dumps(routes)}")
    rng = np.random.default_rng(8)
    # label: (n, d, K, (rows, floats) before the view's start)
    seg_cases = {"ragged n": (1003, 8, 16, (0, 0)), "d=1": (777, 1, 3, (0, 0)),
                 "d=1 view 4 bytes into a 16-byte granule": (777, 1, 3, (0, 1)),
                 "d=3 view from row 5 (60 bytes in)": (3001, 3, 7, (5, 0)),
                 "K=64 d=8 (top of the tensor-core range)": (4099, 8, 64, (0, 0)),
                 "K=65 d=8 (past the tensor-core range)": (3000, 8, 65, (0, 0)),
                 "K*d past 48 KB": (5000, 64, 256, (0, 0)),
                 "K*d past opt-in": (3000, 64, 1024, (0, 0))}
    seg_routes = {}
    for label, (n, d, k, (rows, floats)) in seg_cases.items():
        data = rng.normal(size=(n, d)).astype(np.float32)
        ids = rng.integers(-2, k + 2, n).astype(np.int32)  # some out of range
        ids[:5] = k - 1
        ids[ids == 1] = 0  # segment 1 stays empty
        flat = np.zeros((rows + n + 1) * d + floats, np.float32)
        at = rows * d + floats
        flat[at:at + n * d] = data.ravel()
        dt = torch.from_numpy(flat).to("cuda")[at:at + n * d].view(n, d)
        it = torch.from_numpy(ids).to("cuda")
        before = dict(ops.SEGSUM_LAUNCHES)
        got = ops.segsum(dt, it, k)
        seg_routes[label] = [r for r in before if ops.SEGSUM_LAUNCHES[r] != before[r]][0]
        check_segsum(f"segsum[{label}]", got, dt, it, k)
        if not bool((got[1] == 0).all()):
            raise AssertionError("segsum: an empty segment is not zero")
    torch.cuda.synchronize()
    log(f"segsum edge cases' routes: {json.dumps(seg_routes)}")
    log(f"edge cases: {len(cases) + 1} kmeans_step and {len(seg_cases)} segsum calls match "
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

    per_query, routes = {}, {}
    results = {}
    with recording(TPCH_KERNELS) as captured:
        ops.reset_launches()
        for q, frame in frames.items():
            before = dict(ops.LAUNCHES)
            results[q], routes[q] = routed(frame.collect, device="cuda")
            per_query[q] = {k: ops.LAUNCHES[k] - before[k] for k in before}
        launches = dict(ops.LAUNCHES)
        gen_launches = dict(ops.GEN_LAUNCHES)

    for q, got in results.items():
        check_query(q, got, tpch.REFERENCES[q](tables))
    log(f"TPC-H path: six queries match the numpy references; launches {launches}")
    for kname, queries in EXPECTED.items():
        for q in queries:
            if per_query[q][kname] < 1:
                raise AssertionError(f"{q} did not launch {kname}: {per_query[q]}")
    check_routes("TPC-H path", launches, gen_launches, routes)
    report_generated("after the TPC-H path")
    same_bits_on_path(captured)
    phase_tpch_route(frames)
    gsa_split(captured)
    gja_split(captured)
    return tables, ctx, frames, launches, captured


def check_routes(what: str, launches, gen_launches, routes) -> None:
    """Every relational kernel call of a TPC-H run launched a generated
    kernel; Q1 took grouped_select_agg's reg route and Q4 an atomic one,
    and Q4's and Q12's joins took grouped_join_agg's reg route.  Prints
    each query's routes."""
    gsa = sum(gen_launches[r] for r in ("gsa_reg", "gsa_smem", "gsa_global"))
    gja = sum(gen_launches[r] for r in ("gja_reg", "gja_smem", "gja_global"))
    if gen_launches["fsa_gen"] != launches["fused_select_agg"] or gsa != launches[
            "grouped_select_agg"] or gja != launches["grouped_join_agg"]:
        raise AssertionError(f"{what}: generated routes {gen_launches} for launches {launches}")
    joins = [r for q in ("q4", "q12") for r in routes[q] if r.startswith("gja")]
    if "gsa_reg" not in routes["q1"] or any(
            r not in ("gsa_global", "gsa_smem") for r in routes["q4"] if r.startswith("gsa")
    ) or not joins or any(r != "gja_reg" for r in joins):
        raise AssertionError(f"{what}: Q1 took {routes['q1']}, Q4 {routes['q4']}, "
                             f"Q12 {routes['q12']}")
    log(f"{what}, generated kernel routes per query: {json.dumps(routes)}; in all "
        f"{json.dumps(gen_launches)}")


def same_bits_on_path(captured) -> None:
    """The path's fused_select_agg calls and its grouped_select_agg and
    grouped_join_agg calls on the reg route, run twice more: the same bits
    (replays, not counted)."""
    from repro_torch.kernels import ops

    n = 0
    for name, args, kw in captured:
        first, took = routed(getattr(ops, name), *args, **kw)
        if took[0] not in ("fsa_gen", "gsa_reg", "gja_reg"):
            continue
        same_bits(f"{name} on the path", first, getattr(ops, name)(*args, **kw))
        n += 1
    log(f"TPC-H path: its {n} fused_select_agg and reg-route grouped_select_agg and "
        "grouped_join_agg calls give the same bits when run again")


#: the generated kernels a TPC-H pass must run (fragments of their names:
#: fused_select_agg; grouped_select_agg's reg and atomic routes; the join's
#: build and its probe on the reg route)
TPCH_GENERATED = ("fsa_gen", "grp_reg<GsaRows>", "grp_atomic<GsaRows", "gja_gen_fill",
                  "gja_gen_build", "grp_reg<GjaRows>")
#: the prefixes of the relational kernels' names, the old expression
#: interpreter's among them (fsa_main, gsa_main, vm_init_accumulators, ...):
#: a kernel of a TPC-H pass that bears one must be a generated one
RELATIONAL_PREFIXES = ("fsa_", "gsa_", "gja_", "vm_")


def _kernel_name(event_key: str) -> str:
    """A profiler kernel's function name: its key without the return type
    and the arguments (``void grp_reg<GjaRows>(...)`` → ``grp_reg<GjaRows>``)."""
    return event_key.split("(")[0].split()[-1]


def phase_tpch_route(frames) -> None:
    """One pass over the six queries under torch.profiler (after a warm-up
    window): the generated kernels ran, and no kernel of the expression
    interpreter that the relational kernels used to run."""
    names = device_kernels(lambda: [f.collect(device="cuda") for f in frames.values()], reps=1)
    ours = [n for n in names if any(k in n for k in OUR_KERNELS)]
    missing = [k for k in TPCH_GENERATED if not any(k in n for n in names)]
    stale = [n for n in names if _kernel_name(n).startswith(RELATIONAL_PREFIXES)
             and not any(k in n for k in TPCH_GENERATED)]
    if missing or stale:
        raise AssertionError(f"profiled TPC-H pass: missing {missing}, interpreter kernels "
                             f"{stale}; ran {ours}")
    log(f"profiled TPC-H pass: this package's kernels {json.dumps(ours)} (every "
        f"{', '.join(RELATIONAL_PREFIXES)} kernel a generated one: none of the interpreter's)")


@contextlib.contextmanager
def _epilogue_inputs():
    """Records, during grouped_select_agg calls, the inputs of its
    epilogue's decode_bucket_keys and compact."""
    from repro_torch.relational import runtime as rt

    seen = {}
    orig_decode, orig_compact = rt.decode_bucket_keys, rt.compact

    def decode(*a, **kw):
        seen["decode"] = (a, kw)
        return orig_decode(*a, **kw)

    def compact(*a, **kw):
        seen["compact"] = (a, kw)
        return orig_compact(*a, **kw)

    rt.decode_bucket_keys, rt.compact = decode, compact
    try:
        yield seen
    finally:
        rt.decode_bucket_keys, rt.compact = orig_decode, orig_compact


def gsa_split(captured) -> None:
    """The grouped_select_agg wrapper's time on Q1's and Q4's path calls
    (CUDA events, mean of 10), beside its parts alone on the same inputs:
    the launch (checks, the generated kernel's ctypes call and the kernel),
    the epilogue's decode_bucket_keys and compact.  Measured only."""
    from repro_torch.kernels import ops
    from repro_torch.relational import runtime as rt

    rows = []
    for name, args, kw in captured:
        if name != "grouped_select_agg":
            continue
        table, pred, keys, aggs, _, doms, nb = args
        with _epilogue_inputs() as seen:
            ops.grouped_select_agg(*args, **kw)
        (da, dkw), (ca, ckw) = seen["decode"], seen["compact"]
        row = {"buckets": nb, "rows": table.capacity,
               "wrapper_ms": cuda_ms(lambda: ops.grouped_select_agg(*args, **kw)),
               "launch_ms": cuda_ms(lambda: ops._grouped_select_launch(
                   table, pred, tuple(keys), tuple(aggs),
                   tuple((int(lo), int(hi)) for lo, hi in doms), nb)),
               "decode_bucket_keys_ms": cuda_ms(lambda: rt.decode_bucket_keys(*da, **dkw)),
               "compact_ms": cuda_ms(lambda: rt.compact(*ca, **ckw))}
        row["rest_ms"] = row["wrapper_ms"] - row["launch_ms"] - row[
            "decode_bucket_keys_ms"] - row["compact_ms"]
        rows.append(row)
    log("grouped_select_agg wrapper split (Q1, Q4): " + json.dumps(rows))


def gja_split(captured) -> None:
    """The grouped_join_agg wrapper's time on Q4's and Q12's path calls
    (CUDA events, mean of 10), beside its parts alone on the same inputs:
    the build launch and the probe launch (each a generated kernel's ctypes
    call and its kernels), the epilogue's decode_bucket_keys and compact;
    the rest is the checks, the query's lookup and the epilogue's sentinel
    mapping.  Measured only."""
    from repro_torch.kernels import ops
    from repro_torch.relational import runtime as rt

    rows = []
    for name, args, kw in captured:
        if name != "grouped_join_agg":
            continue
        left, right = args
        with _epilogue_inputs() as seen:
            ops.grouped_join_agg(*args, **kw)
        (da, dkw), (ca, ckw) = seen["decode"], seen["compact"]
        call = ops._join_call(left, right, kw["pred"], tuple(kw["left_on"]),
                              tuple(kw["right_on"]),
                              tuple((int(lo), int(hi)) for lo, hi in kw["join_key_domains"]),
                              int(kw["join_num_buckets"]), tuple(kw["keys"]), tuple(kw["aggs"]),
                              tuple((int(lo), int(hi)) for lo, hi in kw["key_domains"]),
                              int(kw["num_buckets"]))
        row = {"rows": left.capacity, "build_rows": right.capacity,
               "join_buckets": kw["join_num_buckets"], "buckets": kw["num_buckets"],
               "wrapper_ms": cuda_ms(lambda: ops.grouped_join_agg(*args, **kw)),
               "build_ms": cuda_ms(lambda: ops._join_build(call)),
               "probe_ms": cuda_ms(lambda: ops._join_probe(call)),
               "decode_bucket_keys_ms": cuda_ms(lambda: rt.decode_bucket_keys(*da, **dkw)),
               "compact_ms": cuda_ms(lambda: rt.compact(*ca, **ckw))}
        row["rest_ms"] = row["wrapper_ms"] - row["build_ms"] - row["probe_ms"] - row[
            "decode_bucket_keys_ms"] - row["compact_ms"]
        rows.append(row)
    log("grouped_join_agg wrapper split (Q4, Q12): " + json.dumps(rows))


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
        routes = dict(ops.KMEANS_LAUNCHES)
    expect = KMEANS_PARALLEL * (KMEANS_STEPS + 1)
    if launches["kmeans_step"] != expect:
        raise AssertionError(f"kmeans_step launched {launches['kmeans_step']} times, not {expect}")
    if routes != {"kms_tc": expect, "kms_main": 0}:
        raise AssertionError(f"the k-means path's kmeans_step calls took {routes}, not all "
                             "the tensor-core route")
    log(f"k-means path routes: {json.dumps(routes)} (all {expect} kmeans_step calls on the "
        "tensor cores, kms_tc)")

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
    phase_kmeans_route(captured)
    return launches, list(captured), seg_inputs, times, lambda: fused({}, X, c_in)


def phase_kmeans_route(calls) -> None:
    """One k-means path call under torch.profiler (after a warm-up window):
    its device kernel must be the tensor-core kms_tc and not kms_main; then
    two more runs of it, which must give the same bits (the fixed-order
    sum)."""
    import torch

    from repro_torch.kernels import ops

    _, args, kw = calls[0]
    names = device_kernels(lambda: ops.kmeans_step(*args, **kw))
    if not any(KMS_TENSOR_CORE in n for n in names) or any(KMS_CUDA_CORE in n for n in names):
        raise AssertionError(f"a k-means path kmeans_step call ran {names}, not {KMS_TENSOR_CORE}")
    log(f"k-means path kmeans_step call (x {tuple(args[0].shape)}) ran on the card as: {names}")
    first, second = ops.kmeans_step(*args, **kw), ops.kmeans_step(*args, **kw)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("two runs of a k-means path kmeans_step call differ")
    log("k-means path kmeans_step call run twice: sums and counts bit-identical")


def phase_segsum(seg_inputs):
    """segsum on the unfused program's la.SegSum inputs, counted alone:
    every call on the tensor-core route (``seg_tc``); one of them under
    torch.profiler, which must show seg_tc and not seg_main, then run twice
    more: the same bits."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launches()
    outs = [ops.segsum(*a) for a in seg_inputs]
    torch.cuda.synchronize()
    launches, routes = dict(ops.LAUNCHES), dict(ops.SEGSUM_LAUNCHES)
    if launches["segsum"] != len(seg_inputs):
        raise AssertionError(f"segsum launched {launches['segsum']} times")
    if routes != {"seg_tc": len(seg_inputs), "seg_main": 0}:
        raise AssertionError(f"the SegSum calls took {routes}, not all the tensor-core route")
    for i, (out, a) in enumerate(zip(outs, seg_inputs)):
        check_segsum(f"segsum#{i}", out, *a)
    log(f"segsum on the SegSum inputs of the unfused k-means program: matches its plain "
        f"version; launches {launches}; routes {json.dumps(routes)}")
    names = device_kernels(lambda: ops.segsum(*seg_inputs[0]))
    if not any("seg_tc" in n for n in names) or any("seg_main" in n for n in names):
        raise AssertionError(f"a SegSum segsum call ran {names}, not seg_tc")
    log(f"SegSum segsum call (data {tuple(seg_inputs[0][0].shape)}) ran on the card as: {names}")
    if not torch.equal(ops.segsum(*seg_inputs[0]), ops.segsum(*seg_inputs[0])):
        raise AssertionError("two runs of a SegSum segsum call differ")
    log("SegSum segsum call run twice: sums bit-identical")
    return launches, [("segsum", a, {}) for a in seg_inputs]


def phase_parallel(tables, frames) -> None:
    """The six queries with ``parallel=4``, counts set to 0 just before and
    read just after; Q1 and Q6 launch their kernel once per chunk.  Then
    each kernel call of this run against its plain version on the same
    inputs (replays, not counted)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.relational import tpch

    results, per_query, routes = {}, {}, {}
    with recording(TPCH_KERNELS) as captured:
        ops.reset_launches()
        for q, frame in frames.items():
            before = dict(ops.LAUNCHES)
            results[q], routes[q] = routed(frame.collect, device="cuda", parallel=PARALLEL)
            per_query[q] = {k: ops.LAUNCHES[k] - before[k] for k in before}
        launches = dict(ops.LAUNCHES)
        gen_launches = dict(ops.GEN_LAUNCHES)
    for q, got in results.items():
        check_query(q, got, tpch.REFERENCES[q](tables))
    check_routes(f"TPC-H path with parallel={PARALLEL}", launches, gen_launches, routes)
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


def phase_edges_attention() -> None:
    """flash_attention against its plain version at the edges: S ∈ {1, 77,
    200, 2048}, D ∈ {32, 64, 128}, group ∈ {1, 6}, f32 and bf16, causal or
    not, windows 64 and 128, non-default scales."""
    import itertools

    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref

    variants = [(True, None, None), (False, None, None), (True, 64, None),
                (False, 128, 0.3), (True, 128, None), (True, None, 0.05)]
    rng = np.random.default_rng(9)
    cases = list(itertools.product((1, 77, 200, 2048), (32, 64, 128), (1, 6)))
    shares = []
    for i, (s, d, group) in enumerate(cases):
        causal, window, scale = variants[i % len(variants)]
        dtype = (torch.float32, torch.bfloat16)[(i // len(variants)) % 2]
        q, k, v = (torch.tensor(rng.normal(size=(2, h, s, d)), dtype=dtype, device="cuda")
                   for h in (2 * group, 2, 2))
        kw = dict(causal=causal, window=window, sm_scale=scale)
        what = f"flash_attention[S={s},D={d},group={group},{dtype},{kw}]"
        got = ops.flash_attention(q, k, v, **kw)
        err, share = check_attention(what, got, ref.flash_attention(q, k, v, **kw), v)
        row = {"case": what, "max_abs_err": err, "bound_share": share}
        if dtype == torch.bfloat16:
            row["max_abs_from_tiled"] = tiled_gap(got, (q, k, v), kw)
        shares.append(row)
    torch.cuda.synchronize()
    log("edge cases, flash_attention: " + json.dumps(shares))
    worst = {t: max(r["bound_share"] for r in shares if t in r["case"])
             for t in ("float32", "bfloat16")}
    log(f"edge cases: {len(cases)} flash_attention calls match their plain version; worst share "
        f"of the bound: f32 (fa_main) {worst['float32']:.4f}, bf16 (fa_wgmma) "
        f"{worst['bfloat16']:.4f}")


def _watched(model):
    """The model with its prefill and decode wrapped to keep each call's
    logits (B, V) in ``calls``, one list per wave: the logits are made
    anyway, so this adds no device work."""
    from dataclasses import replace

    calls = []

    def prefill(p, b, cap):
        logits, cache = model.prefill(p, b, cap)
        calls.append([logits])
        return logits, cache

    def decode(p, cache, toks):
        logits, cache = model.decode(p, cache, toks)
        calls[-1].append(logits)
        return logits, cache

    return replace(model, prefill=prefill, decode=decode), calls


def _serve_once(model, params, requests):
    """One traced ``serve_loop`` over ``requests`` through ``make_run_wave``;
    returns (outputs, the logits of each call per wave, tracer, wall s)."""
    import torch

    from repro_torch.launch.serve import make_run_wave, serve_loop
    from repro_torch.obs.trace import tracing

    watched, calls = _watched(model)
    run_wave = make_run_wave(watched, params, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                             gen=SERVE_GEN, cache_cap=SERVE_CAP, device="cuda")
    with tracing() as tracer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve_loop(requests, run_wave, batch=SERVE_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, calls, tracer, wall


def path_gap(glog, wlog):
    """Two serving runs' logits (per wave, per call (B, V)): (largest |Δ| of
    the prefill logits, largest |Δ| over every step both paths were fed
    the same tokens — the prefill, then each decode step while their
    greedy tokens agree —, the number of such steps, the std of the second
    run's prefill logits)."""
    import torch

    pre = worst = 0.0
    same = 0
    for g, w in zip(glog, wlog):
        gl, wl = torch.stack(g), torch.stack(w)                     # (steps, B, V)
        pre = max(pre, float((gl[0] - wl[0]).abs().max()))
        differ = gl.argmax(-1) != wl.argmax(-1)                     # (steps, B)
        for j in range(gl.shape[1]):
            bad = differ[:, j].nonzero()
            fed = int(bad[0]) + 1 if len(bad) else gl.shape[0]      # step t saw tokens < t
            worst = max(worst, float((gl[:fed, j] - wl[:fed, j]).abs().max()))
            same += fed
    std = float(torch.cat([w[0].flatten() for w in wlog]).std())
    return pre, worst, same, std


def exact_attention(q, k, v, *, causal=True, window=None, sm_scale=None):
    """Attention in f64, rounded once to q's dtype: the exactly rounded
    answer, the yardstick of how far correct bf16 paths drift apart."""
    import math

    import torch

    from repro_torch.kernels import ref

    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    logits = (q.double() * scale) @ k.double().repeat_interleave(group, 1).transpose(-1, -2)
    mask = ref.attention_mask(q.shape[2], causal, window, q.device)
    p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return (p @ v.double().repeat_interleave(group, 1)).to(q.dtype)


def compare_paths(label: str, got, want, exact, noise: float) -> dict:
    """One serving run (outputs, per-wave logits) against the plain path's:
    the logits of every step both were fed the same tokens within the
    larger of LOGIT_STD_SHARE of the prefill logits' std and NOISE_FACTOR ×
    ``noise``, and each request's tokens its logits' argmax.  Reports the
    run's own distance from the ``exact`` run, and per request the step at
    which its tokens first leave the plain path's with the plain path's
    top-2 logit gap there."""
    import torch

    (gout, glog), (wout, wlog) = got, want
    pre, worst, same, std = path_gap(glog, wlog)
    limit = max(LOGIT_STD_SHARE * std, NOISE_FACTOR * noise)
    if not worst <= limit:
        raise AssertionError(f"{label}: logits differ by {worst} over {same} steps fed the same "
                             f"tokens, over {limit} (the larger of {LOGIT_STD_SHARE} of their "
                             f"std {std} and {NOISE_FACTOR} × the noise floor {noise})")
    _, to_exact, exact_steps, _ = path_gap(glog, exact)
    diverged = []
    for wave, (g, w) in enumerate(zip(glog, wlog)):
        gl, wl = torch.stack(g), torch.stack(w)                     # (steps, B, V)
        top2 = wl.topk(2, dim=-1).values
        gaps = (top2[..., 0] - top2[..., 1]).cpu()                  # (steps, B)
        gseq, wseq = gl.argmax(-1).cpu(), wl.argmax(-1).cpu()
        for j in range(gseq.shape[1]):
            rid = wave * SERVE_BATCH + j
            # the decode steps' tokens are what serve_loop returned
            if not (gseq[1:, j].numpy() == gout[rid]).all() or not (
                    wseq[1:, j].numpy() == wout[rid]).all():
                raise AssertionError(f"{label}: request {rid}'s tokens are not its logits' argmax")
            bad = (gseq[:, j] != wseq[:, j]).nonzero()
            if len(bad):
                diverged.append((rid, int(bad[0]), round(float(gaps[int(bad[0]), j]), 6)))
    steps = len(gout) * (SERVE_GEN + 1)
    log(f"serving path {label}: logits max |Δ| {worst:.6g} over the {same} of {steps} steps fed "
        f"the same tokens (limit {limit:.6g}; std {std:.6g}, {worst / std:.4f} of it; noise "
        f"floor {noise:.6g}); prefill logits max |Δ| {pre:.6g}; from the exact run "
        f"{to_exact:.6g} over {exact_steps} steps; tokens leave the plain path's in "
        f"{len(diverged)} of {len(gout)} requests, (request, step, plain top-2 gap): {diverged}")
    return {"prefill_max_abs": pre, "logit_std": std, "limit": limit, "max_abs": worst,
            "same_token_steps": same, "max_abs_from_exact": to_exact,
            "same_token_steps_exact": exact_steps, "diverged": diverged}


def phase_serve():
    """The serving path at full width and depth with attn_mode="pallas",
    after a warm-up wave, with the launch counts set to 0 just before and
    read just after; then the plain path (``ref``) and ``chunked`` on the
    same parameters and prompts, each held against the plain one.  Returns
    (launches, the kernel's calls, the serving report, one wave to
    profile)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, make_run_wave
    from repro_torch.models.api import build_model

    base = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = build_model(replace(base, attn_mode="pallas"))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = np.random.default_rng(0).integers(0, base.vocab, (SERVE_REQUESTS, SERVE_PROMPT))

    def requests():
        return [Request(rid=i, prompt=prompts[i]) for i in range(SERVE_REQUESTS)]

    log(f"serving {base.arch}: {n_params / 1e9:.4f} B parameters ({base.dtype}, "
        f"{sum(_bytes(t) for t in _leaves(params)) / 1e9:.3f} GB) on the card; "
        f"{SERVE_REQUESTS} requests × {SERVE_PROMPT} prompt tokens, batch {SERVE_BATCH}, "
        f"{SERVE_GEN} generated, cache {SERVE_CAP}; set-up {time.perf_counter() - t0:.1f} s")
    wave = make_run_wave(model, params, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                         gen=SERVE_GEN, cache_cap=SERVE_CAP, device="cuda")
    wave(requests()[:SERVE_BATCH])  # warm-up: library handles, the allocator, first launches
    torch.cuda.reset_peak_memory_stats()
    with recording(("flash_attention",)) as captured:
        ops.reset_launches()
        out, logits, tracer, wall = _serve_once(model, params, requests())
        launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    waves = -(-SERVE_REQUESTS // SERVE_BATCH)
    if sorted(out) != list(range(SERVE_REQUESTS)):
        raise AssertionError(f"served {sorted(out)} of {SERVE_REQUESTS} requests")
    for rid, toks in out.items():
        if toks.shape != (SERVE_GEN,) or not ((toks >= 0) & (toks < base.vocab)).all():
            raise AssertionError(f"request {rid}: tokens {toks}")
    if not all(bool(torch.isfinite(x).all()) for w in logits for x in w):
        raise AssertionError("the serving path gave non-finite logits")
    if launches["flash_attention"] != base.n_layers * waves or len(captured) != base.n_layers * waves:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} times, "
                             f"not {base.n_layers} per wave")
    log(f"serving path (pallas): {len(out)} requests served, {waves} waves; launches "
        f"{ {k: v for k, v in launches.items() if v} }; peak device memory {peak / 1e9:.3f} GB")

    report = {"pallas": _serve_numbers(tracer, wall, len(out))}
    plain_model = build_model(replace(base, attn_mode="ref"))
    plain = _serve_once(plain_model, params, requests())
    report["ref"] = _serve_numbers(plain[2], plain[3], len(plain[0]))
    # the noise floor: the plain path against exactly rounded prefill attention
    exact = _serve_once(build_model(replace(base, attn_mode=exact_attention)), params,
                        requests())
    _, noise, same, std = path_gap(plain[1], exact[1])
    report["noise_floor"] = {"max_abs": noise, "same_token_steps": same, "logit_std": std}
    log(f"serving path noise floor: the plain path's logits differ from those with exactly "
        f"rounded (f64) prefill attention by up to {noise:.6g} ({noise / std:.4f} of their std "
        f"{std:.6g}) over the {same} steps fed the same tokens")
    report["pallas_vs_ref"] = compare_paths("pallas vs ref", (out, logits), plain[:2],
                                            exact[1], noise)
    chunked = _serve_once(build_model(replace(base, attn_mode="chunked")), params, requests())
    report["chunked"] = _serve_numbers(chunked[2], chunked[3], len(chunked[0]))
    report["chunked_vs_ref"] = compare_paths("chunked vs ref", chunked[:2], plain[:2],
                                             exact[1], noise)
    return launches, list(captured), report, lambda: wave(requests()[:SERVE_BATCH])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _serve_numbers(tracer, wall: float, served: int) -> dict:
    """The serving numbers of one run from the port's tracer: medians over
    the waves (prefill) and the steps (decode), latency percentiles."""
    prefill = tracer.histograms["serve.prefill_s"]
    decode = tracer.histograms["serve.decode_step_s"]
    lat = tracer.histogram_summary("serve.request_latency_s")
    return {"prefill_ms_per_wave": statistics.median(prefill) * 1e3,
            "prefill_ms_all": [x * 1e3 for x in prefill],
            "decode_ms_per_step": statistics.median(decode) * 1e3,
            "decode_ms_min": min(decode) * 1e3, "decode_ms_max": max(decode) * 1e3,
            "tokens_per_s": served * SERVE_GEN / wall,
            "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / statistics.median(prefill),
            "wall_s": wall, "latency_p50_s": lat["p50"], "latency_p99_s": lat["p99"]}


def _library_ms(name: str, args: tuple, kw: dict):
    """The one PyTorch call that computes the kernel's function, timed,
    where there is one: ``index_add_`` for segsum (ids in range here),
    ``scaled_dot_product_attention`` for flash_attention (the window as a
    boolean mask)."""
    import torch

    if name == "flash_attention":
        from repro_torch.kernels import ref

        q, k, v = args
        causal, window = kw.get("causal", True), kw.get("window")
        sdpa = dict(scale=kw.get("sm_scale"), enable_gqa=True)
        if window is None:
            sdpa["is_causal"] = causal
        else:
            sdpa["attn_mask"] = ref.attention_mask(q.shape[2], causal, window, q.device)
        return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, **sdpa))
    if name != "segsum":
        return None
    data, ids, k = args
    if not bool(((ids >= 0) & (ids < k)).all()):
        return None
    return cuda_ms(lambda: torch.zeros((k, data.shape[1]), dtype=data.dtype,
                                       device=data.device).index_add_(0, ids, data))


def phase_kernels(captured, launches, pool):
    """Each kernel against its plain version on the paths' inputs; then
    which kernel a served attention call runs (``phase_attention_route``)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kmeans import check_step, reference_step

    rows = []
    agg = {}
    for i, (name, args, kw) in enumerate(captured):
        kern, plain = getattr(ops, name), getattr(ref, name)
        (got, took), want = routed(kern, *args, **kw), plain(*args, **kw)
        extra = {}
        if name == "kmeans_step":
            x, c = (a.cpu().numpy() for a in args)
            err = check_step(f"kmeans_step#{i}", got, want, reference_step(x, c, pool.map),
                             KERNEL_RTOL)
            # the card's read rate on the same bytes: a floor, not a library call
            extra = {"read_floor_ms": cuda_ms(lambda: torch.sum(args[0]))}
        elif name == "segsum":
            err = check_segsum(f"segsum#{i}", got, *args)
            took = [ops.segsum_route(args[0].shape[1], args[2])]
        elif name == "flash_attention":
            err, share = check_attention(f"flash_attention#{i}", got, want, args[2])
            extra = {"bound_share": share}
            if args[0].dtype == torch.bfloat16:
                extra["max_abs_from_tiled"] = tiled_gap(got, args, kw)
        else:
            err = compare_outputs(f"{name}#{i}", got, want)
        ms = cuda_ms(lambda: kern(*args, **kw))
        pms = cuda_ms(lambda: plain(*args, **kw))
        lib = _library_ms(name, args, kw)
        nbytes, nops = work(name, args, kw)
        if name in TPCH_KERNELS:
            nbytes += result_bytes(want)
            shape = {"rows": args[0].capacity, "join_buckets": kw.get("join_num_buckets"),
                     "buckets": kw.get("num_buckets",
                                       args[-1] if name == "grouped_select_agg" else None)}
        else:
            shape = {"shapes": [list(a.shape) for a in args if hasattr(a, "shape")]}
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / ops_peak(args) * 1e3
        if took:
            shape["route"] = took[0]
        rows.append({"kernel": name, "call": i, **shape, "ms": ms, "plain_ms": pms,
                     "library_ms": lib, "bytes": nbytes, "ops": nops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_f32_ms": max(t_bytes, nops / PEAK_F32 * 1e3), "max_abs_err": err,
                     **extra})
        a = agg.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                                  "bytes_ms": 0.0, "ops_ms": 0.0, "ops_f32_ms": 0.0,
                                  "err": 0.0})
        a["ms"] += ms
        a["plain_ms"] += pms
        if lib is not None:
            a["library_ms"] = (a["library_ms"] or 0.0) + lib
        a["bytes_ms"] += t_bytes
        a["ops_ms"] += t_ops
        a["ops_f32_ms"] += nops / PEAK_F32 * 1e3
        a["err"] = max(a["err"], err)
        for key, x in extra.items():
            a[key] = a.get(key, 0.0) + x if key == "read_floor_ms" else max(a.get(key, 0.0), x)
    log("kernel calls: " + json.dumps(rows))
    out = []
    for name in REPLACES:
        a = agg[name]
        t_bytes, t_ops = a["bytes_ms"], a["ops_ms"]
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": a["library_ms"],
        })
        if name in GENERATED_BY:
            out[-1]["generated_by"] = GENERATED_BY[name]
        if a["ops_f32_ms"] != t_ops:  # bf16 operands: the f32 convention's bound beside
            out[-1]["bound_f32_ms"] = max(t_bytes, a["ops_f32_ms"])
        out[-1].update({k: a[k] for k in ("bound_share", "max_abs_from_tiled", "read_floor_ms")
                        if k in a})
    log("kernels vs plain versions on the paths' inputs: all match")
    km = agg["kmeans_step"]
    log(f"read floor: torch.sum over the points of the {launches['kmeans_step'] // (KMEANS_STEPS + 1)}"
        f" k-means path calls of a step, {km['read_floor_ms']:.4f} ms "
        f"({km['bytes_ms'] * PEAK_BYTES / 1e3 / km['read_floor_ms'] / 1e9:.4g} TB/s); "
        f"kmeans_step wrapper {km['ms']:.4f} ms, {km['ms'] / km['read_floor_ms']:.3f}x the floor, "
        f"bound {km['bytes_ms']:.4f} ms")
    phase_attention_route([c for c in captured if c[0] == "flash_attention"])
    return out


def phase_attention_route(calls) -> None:
    """One served flash_attention call (bf16) under torch.profiler, after a
    warm-up window: its device kernels must be the tensor-core kernel and
    not the CUDA-core one."""
    from repro_torch.kernels import ops

    _, args, kw = calls[0]
    names = device_kernels(lambda: ops.flash_attention(*args, **kw))
    if not any(FA_TENSOR_CORE in n for n in names) or any(FA_CUDA_CORE in n for n in names):
        raise AssertionError(f"a served flash_attention call ran {names}, not {FA_TENSOR_CORE}")
    log(f"served flash_attention call (q {tuple(args[0].shape)}, {args[0].dtype}) ran on the "
        f"card as: {names}")


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


def report_serve(report) -> None:
    for mode in ("pallas", "ref", "chunked"):
        r = report[mode]
        log(f"serving {SERVE_ARCH} ({mode} attention): prefill {r['prefill_ms_per_wave']:.3f} ms "
            f"per wave of {SERVE_BATCH}×{SERVE_PROMPT} (median of {len(r['prefill_ms_all'])}), "
            f"{r['prefill_tokens_per_s']:.6g} prompt tokens/s; decode {r['decode_ms_per_step']:.3f} "
            f"ms per step of {SERVE_BATCH} tokens (min {r['decode_ms_min']:.3f}, max "
            f"{r['decode_ms_max']:.3f}); {r['tokens_per_s']:.6g} generated tokens/s over "
            f"{r['wall_s']:.3f} s; request latency p50 {r['latency_p50_s']:.4f} s, p99 "
            f"{r['latency_p99_s']:.4f} s")
    log("serve: " + json.dumps(report))


#: name fragments of this package's CUDA kernels in a profiler trace
OUR_KERNELS = ("fsa_gen", "grp_reg", "grp_atomic", "grp_init", "gja_gen_fill", "gja_gen_build",
               "kms_main", "kms_tc", "seg_main", "seg_tc", "fa_main", "fa_wgmma")
#: flash_attention's kernels: bf16 on the tensor cores, f32 on the CUDA cores
FA_TENSOR_CORE, FA_CUDA_CORE = "fa_wgmma", "fa_main"
#: kmeans_step's kernels: the path's shape on the tensor cores, others on the CUDA cores
KMS_TENSOR_CORE, KMS_CUDA_CORE = "kms_tc", "kms_main"


#: profiler windows a measurement may take: the first warms the profiler
#: up, and a window can come back with none of its device launches (seen
#: on the H100's machine, now and then), so the next one is taken
PROFILE_WINDOWS = 6


def _profiled(fn, activities):
    """torch.profiler over ``fn()`` (which ends in a synchronise): the
    first window after the warm-up that recorded a device kernel (or the
    last one)."""
    from torch.profiler import profile

    for window in range(PROFILE_WINDOWS):
        with profile(activities=activities) as prof:
            fn()
        if window and _device_events(prof):
            break
    return prof


def device_kernels(fn, reps: int = 3):
    """The names of the device kernels that ``reps`` calls of ``fn``
    launch, from torch.profiler after a warm-up window."""
    import torch
    from torch.profiler import ProfilerActivity

    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    return sorted({e.key for e in _device_events(_profiled(run, [ProfilerActivity.CUDA]))})


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
    from torch.profiler import ProfilerActivity

    from repro_torch.kernels import ops

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, run in workloads.items():
        prof = _profiled(lambda: (run(), torch.cuda.synchronize()), acts)
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

        def calls():
            for _ in range(iters):
                kern(*args, **kw)
            torch.cuda.synchronize()

        prof = _profiled(calls, [ProfilerActivity.CUDA])
        # each wrapper call launches each of its kernels once: the mean per
        # recorded launch, summed over its kernels (the trace may lose some
        # of a window's launches, so dividing by iters would undercount)
        ours = [e for e in _device_events(prof) if any(k in e.key for k in OUR_KERNELS)]
        rows.append({"kernel": name, "call": i,
                     "kernel_device_ms": sum(e.self_device_time_total / e.count
                                             for e in ours) / 1e3,
                     "recorded": min((e.count for e in ours), default=0)})
    log(f"kernel device time (own launches only, mean per recorded launch of {iters}): "
        + json.dumps(rows))


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

    # full-f32 products in the plain versions: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    with ThreadPoolExecutor(8) as pool:
        phase_edges()
        phase_edges_la(pool)
        phase_edges_attention()
        tables, ctx, frames, launches, captured = phase_main_path(a.sf)
        km_launches, km_captured, seg_inputs, km_times, km_step = phase_kmeans(pool)
        seg_launches, seg_captured = phase_segsum(seg_inputs)
        phase_parallel(tables, frames)
        fa_launches, fa_captured, serve_report, serve_wave = phase_serve()
        launches.update(kmeans_step=km_launches["kmeans_step"], segsum=seg_launches["segsum"],
                        flash_attention=fa_launches["flash_attention"])
        captured += km_captured + seg_captured + fa_captured
        kernels = phase_kernels(captured, launches, pool)
    phase_queries(tables, frames, a.reps)
    report_kmeans(km_times)
    report_serve(serve_report)
    if a.profile:
        phase_profile({
            "one pass over the six queries": lambda: [f.collect(device="cuda")
                                                      for f in frames.values()],
            f"one pass over the six queries with parallel={PARALLEL}":
                lambda: [f.collect(device="cuda", parallel=PARALLEL) for f in frames.values()],
            "one k-means step": km_step,
            f"one serving wave ({SERVE_BATCH}×{SERVE_PROMPT} prefill, {SERVE_GEN} steps)":
                serve_wave,
        }, captured)
    del captured, km_captured, seg_captured, seg_inputs, fa_captured
    report_generated("at the end")
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
