#!/usr/bin/env python3
"""On-card check of the torch port: TPC-H through ``repro_torch`` on one GPU.

    python3 chip_smoke.py [--sf 5] [--reps 5] [--profile]

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. each CUDA kernel against its plain PyTorch version on edge cases
   (empty selection, ragged capacity, out-of-domain and duplicate join
   keys, more buckets than shared memory holds);
3. the main path: TPC-H at ``--sf`` (seed 0), the six queries through
   ``Frame.collect(device="cuda")``, each held against the numpy
   reference, with the kernels' launch counts read around that one run;
4. each kernel against its plain version on the inputs the main path gave
   it, both timed with CUDA events;
5. per-query latency (median over ``--reps`` after a warm-up) and
   lineitem rows/s; with ``--profile``, device time by kernel.

Then the ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the exit code is not 0 and no result line is
printed; without a visible CUDA device the script exits with code 2.

Tolerances.  Kernel against plain version: integers (keys, counts,
validity) exact; floats within rtol 1e-4 of the plain value, because the
kernels add float sums with atomics and per-block partials, in another
order than torch's reductions (each order has error of order
sqrt(n)·2^-24 on n ≈ 10^6 terms).  Query against the numpy reference:
integers exact, floats rtol 2e-4 (tests/test_tpch.py's tolerance: f32
accumulation against an f64 oracle).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

KERNEL_RTOL = 1e-4
QUERY_RTOL = 2e-4
#: H100 SXM data-sheet peaks: HBM bytes/s and f32 (non-tensor-core) op/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

REPLACES = {
    "fused_select_agg": "src/repro/kernels/fused_select_agg.py:84",
    "grouped_select_agg": "src/repro/kernels/grouped_select_agg.py:110",
    "grouped_join_agg": "src/repro/kernels/grouped_join_agg.py:158",
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
    """(bytes, operations) the call's function needs on this data: every
    column the predicate reads and the validity over all rows; columns
    read only by the aggregated values or keys, over the rows that pass;
    the build side of a join once; the result once.  Operations: the
    program's instructions per row evaluated (the cost of a VM step is not
    counted)."""
    from repro_torch.kernels import exprcode
    from repro_torch.kernels.ops import _value_aggs
    from repro_torch.relational import runtime as rt

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

    # record each wrapper call's inputs, to replay them against the plain
    # versions afterwards (the emitters look the wrappers up on the module)
    captured = []
    originals = {k: getattr(ops, k) for k in REPLACES}

    def recorder(name):
        def call(*args, **kw):
            captured.append((name, args, kw))
            return originals[name](*args, **kw)
        return call

    per_query = {}
    results = {}
    for k in REPLACES:
        setattr(ops, k, recorder(k))
    try:
        ops.reset_launches()
        for q, frame in frames.items():
            before = dict(ops.LAUNCHES)
            results[q] = frame.collect(device="cuda")
            per_query[q] = {k: ops.LAUNCHES[k] - before[k] for k in before}
        launches = dict(ops.LAUNCHES)
    finally:
        for k, fn in originals.items():
            setattr(ops, k, fn)

    for q, got in results.items():
        check_query(q, got, tpch.REFERENCES[q](tables))
    log(f"main path: six queries match the numpy references; launches {launches}")
    for kname, queries in EXPECTED.items():
        for q in queries:
            if per_query[q][kname] < 1:
                raise AssertionError(f"{q} did not launch {kname}: {per_query[q]}")
    return tables, ctx, frames, launches, captured


def phase_kernels(captured, launches):
    """Each kernel against its plain version on the main path's inputs."""
    from repro_torch.kernels import ops, ref

    rows = []
    agg = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "err": 0.0}
           for k in REPLACES}
    for i, (name, args, kw) in enumerate(captured):
        kern, plain = getattr(ops, name), getattr(ref, name)
        got, want = kern(*args, **kw), plain(*args, **kw)
        err = compare_outputs(f"{name}#{i}", got, want)
        ms = cuda_ms(lambda: kern(*args, **kw))
        pms = cuda_ms(lambda: plain(*args, **kw))
        nbytes, nops = work(name, args, kw)
        nbytes += result_bytes(want)
        shape = (args[0].capacity, kw.get("join_num_buckets"),
                 kw.get("num_buckets", args[-1] if name == "grouped_select_agg" else None))
        rows.append({"kernel": name, "call": i, "rows": shape[0],
                     "join_buckets": shape[1], "buckets": shape[2], "ms": ms,
                     "plain_ms": pms, "bytes": nbytes, "max_abs_err": err})
        a = agg[name]
        a["ms"] += ms
        a["plain_ms"] += pms
        a["bytes"] += nbytes
        a["ops"] += nops
        a["err"] = max(a["err"], err)
    log("kernel calls: " + json.dumps(rows))
    out = []
    for name, a in agg.items():
        t_bytes, t_ops = a["bytes"] / PEAK_BYTES * 1e3, a["ops"] / PEAK_F32 * 1e3
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    log("kernels vs plain versions on the main path's inputs: all match")
    return out


def phase_queries(tables, frames, reps: int) -> None:
    """End-to-end latency of ``Frame.collect`` per query, and the same run
    split into its compile (lowering, host only) and execute (operators,
    kernels and the copy of the result to the host) parts."""
    import torch

    from repro_torch.frontends.dataflow import _to_numpy

    n_li = len(tables["lineitem"]["l_orderkey"])
    summary = {}
    for q, frame in frames.items():
        ctx = frame._ctx
        frame.collect(device="cuda")  # warm-up
        times, comp, run = [], [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame.collect(device="cuda")
            t1 = time.perf_counter()
            compiled = ctx.compile(frame)
            t2 = time.perf_counter()
            _to_numpy(compiled(ctx.sources("cuda"))[0])
            t3 = time.perf_counter()
            times.append((t1 - t0) * 1e3)
            comp.append((t2 - t1) * 1e3)
            run.append((t3 - t2) * 1e3)
        med = statistics.median(times)
        summary[q] = {"median_ms": med, "min_ms": min(times), "max_ms": max(times),
                      "compile_ms": statistics.median(comp),
                      "execute_ms": statistics.median(run),
                      "lineitem_rows_per_s": n_li / (med / 1e3)}
        log(f"query {q}: median {med:.3f} ms over {reps} runs "
            f"(min {min(times):.3f}, max {max(times):.3f}; compile "
            f"{statistics.median(comp):.3f}, execute {statistics.median(run):.3f}); "
            f"{n_li / (med / 1e3):.4g} lineitem rows/s")
    log("queries: " + json.dumps(summary))


#: name fragments of this package's CUDA kernels in a profiler trace
OUR_KERNELS = ("fsa_main", "fsa_finalize", "gsa_main", "gja_main", "vm_init_accumulators")


def _device_events(prof):
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0]


def phase_profile(frames, captured) -> None:
    """torch.profiler over one pass of the six queries (after a profiled
    warm-up pass): device time by kernel and the device's busy share of the
    traced span; then each main-path kernel call's own kernels alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):  # the first pass warms the profiler up
        with profile(activities=acts) as prof:
            for frame in frames.values():
                frame.collect(device="cuda")
            torch.cuda.synchronize()
    spans = [e.time_range for e in prof.events()]
    span_ms = (max(r.end for r in spans) - min(r.start for r in spans)) / 1e3
    events = _device_events(prof)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    ours = sum(e.self_device_time_total for e in events
               if any(k in e.key for k in OUR_KERNELS)) / 1e3
    log(f"profile: one pass over the six queries, traced span {span_ms:.3f} ms, "
        f"device kernels {dev_ms:.3f} ms (this package's CUDA kernels {ours:.3f} ms), "
        f"busy share {dev_ms / span_ms:.4f}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    log("profile top: " + json.dumps([
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

    smi = phase_card()
    phase_build()
    phase_edges()
    tables, ctx, frames, launches, captured = phase_main_path(a.sf)
    kernels = phase_kernels(captured, launches)
    phase_queries(tables, frames, a.reps)
    if a.profile:
        phase_profile(frames, captured)
    del captured
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
