"""Run each f32-summing route of the port twice on the same inputs and
compare the bits; time each route.

Run on a CUDA card from the repository root:

    python3 tools/determinism_probe.py [--src PATH] [--reps 10]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees can be probed in one call on
one card.  The routes, each at an input that fills many blocks and chunks
(``INPUTS``):

* ``segment_sum``: ``relational/runtime.py:_segment_sum`` on the card, as
  the sorted tiers and the plain direct tier run it;
* ``gsa_smem``, ``gsa_global``, ``gja_smem``, ``gja_global``: the grouped
  kernels' atomic routes (``grouped_select_agg``, ``grouped_join_agg``),
  one sum, a min and a count per bucket;
* ``kms_main``: ``kmeans_step`` at d = 64, k = 256;
* ``seg_main``: ``segsum`` at d = 8, K = 100.

Each route runs on two inputs: ``ordered`` puts rows of a wide dynamic
range (1e8, 1, −1e8, … and normals scaled by 10^U(−4, 8)) into a handful
of buckets, so a sum's bits depend on the order of its adds; ``random``
spreads normal values over every bucket.  For each it prints the first
element whose bits differ between the two calls (got, got) or none, the
largest difference of the sums against an f64 sum on the host (relative
to the sum of |v|), the wrapper's ms (CUDA events, mean of ``--reps``
after a warm-up) and the device ms of its kernels (the profiler's, same
calls; "not measured" where a window kept no kernel).  The last line is
one JSON object, with the card's name and power limit.

With ``--smallest`` it looks, per route, for the smallest ``ordered``
input at which two calls give other bits: rows (points, for
``kms_main``) of 2^6, 2^8, … 2^20 (four buckets; kms_main 8 centroids of
width 64), each size called ``--tries`` times against its first call;
it prints the first size that differed, with the first (got, got).
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: rows of the grouped routes' inputs (the stream's micro-batch is 65,536;
#: lineitem at sf=5 about 3.0 million), buckets per route
GROUPED_ROWS = 1 << 21
INPUTS = {"gsa_smem": 1000, "gsa_global": 750_000, "gja_smem": 1000, "gja_global": 750_000}
KMS_SHAPE = (1 << 18, 64, 256)
SEG_SHAPE = (1 << 20, 8, 100)
SEGSUM_ROWS = 1 << 20


def _ordered(rng, n, buckets):
    import numpy as np

    v = (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 8, n)).astype(np.float32)
    v[: 3 * (n // 3)] = np.where(np.arange(3 * (n // 3)) % 3 == 1, v[: 3 * (n // 3)],
                                 np.tile(np.float32([1e8, 0, -1e8]), n // 3))
    return v, rng.integers(0, min(buckets, 4), n)


def _random(rng, n, buckets):
    import numpy as np

    return rng.normal(size=n).astype(np.float32), rng.integers(0, buckets, n)


def _bits(x):
    import numpy as np

    a = np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _first_diff(a, b):
    import numpy as np

    a, b = _bits(a).ravel(), _bits(b).ravel()
    bad = np.flatnonzero(a != b)
    if bad.size == 0:
        return None
    i = int(bad[0])
    f = lambda w: float(np.array([w], np.uint32).view(np.float32)[0])
    return {"at": i, "got": [f(a[i]), f(b[i])], "differ": int(bad.size)}


def _cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(1.0)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(1.0)
    us = sum(e.device_time_total for e in prof.key_averages())
    return round(us / 1000 / reps, 4) if us else "not measured"


def _cases(ops, rt, torch, np, dev):
    """(route, input kind) → (a call that returns the sums, the host's f64
    sums and the sum of |v| per element, the launch counts to check)."""
    from repro_torch.core.expr import AggSpec, col, const

    rng = np.random.default_rng(0)
    aggs = (AggSpec("sum", col("v"), "s"), AggSpec("min", col("v"), "m"),
            AggSpec("count", const(1), "c"))
    out = {}
    for route, nb in INPUTS.items():
        for kind, make in (("ordered", _ordered), ("random", _random)):
            v, g = make(rng, GROUPED_ROWS, nb)
            want = np.zeros(nb)
            np.add.at(want, g, v.astype(np.float64))
            absum = np.zeros(nb)
            np.add.at(absum, g, np.abs(v.astype(np.float64)))
            if route.startswith("gsa"):
                t = rt.VecTable({"g": torch.from_numpy(g.astype(np.int32)).to(dev),
                                 "v": torch.from_numpy(v).to(dev)},
                                torch.ones(len(v), dtype=torch.bool, device=dev))

                def call(t=t, nb=nb):
                    r = ops.grouped_select_agg(t, None, ("g",), aggs, nb, ((0, nb - 1),), nb)
                    return _dense(r, nb, torch)
            else:
                m = 1 << 16
                fk = rng.integers(0, m, len(v)).astype(np.int32)
                left = rt.VecTable({"fk": torch.from_numpy(fk).to(dev),
                                    "g": torch.from_numpy(g.astype(np.int32)).to(dev),
                                    "v": torch.from_numpy(v).to(dev)},
                                   torch.ones(len(v), dtype=torch.bool, device=dev))
                right = rt.VecTable({"rk": torch.arange(m, dtype=torch.int32, device=dev)},
                                    torch.ones(m, dtype=torch.bool, device=dev))

                def call(left=left, right=right, nb=nb, m=m):
                    r = ops.grouped_join_agg(
                        left, right, left_on=("fk",), right_on=("rk",),
                        join_key_domains=((0, m - 1),), join_num_buckets=m, keys=("g",),
                        aggs=aggs, max_groups=nb, key_domains=((0, nb - 1),), num_buckets=nb)
                    return _dense(r, nb, torch)
            out[(route, kind)] = (call, want, absum)
    n, d, k = KMS_SHAPE
    for kind in ("ordered", "random"):
        x = rng.normal(size=(n, d)).astype(np.float32)
        if kind == "ordered":
            x *= (10.0 ** rng.uniform(-4, 8, (n, 1))).astype(np.float32)
        c = x[rng.choice(n, k, replace=False)].copy()
        xt, ct = torch.from_numpy(x).to(dev), torch.from_numpy(c).to(dev)
        lab = torch.argmin(torch.cdist(xt.double(), ct.double()), 1).cpu().numpy()
        want, absum = np.zeros((k, d)), np.zeros((k, d))
        np.add.at(want, lab, x.astype(np.float64))
        np.add.at(absum, lab, np.abs(x.astype(np.float64)))
        out[("kms_main", kind)] = (lambda xt=xt, ct=ct: ops.kmeans_step(xt, ct)[0], want, absum)
    n, d, kk = SEG_SHAPE
    for kind in ("ordered", "random"):
        x = rng.normal(size=(n, d)).astype(np.float32)
        ids = rng.integers(-1, kk + 1, n)
        if kind == "ordered":
            x *= (10.0 ** rng.uniform(-4, 8, (n, 1))).astype(np.float32)
            ids = rng.integers(0, 3, n)
        keep = (ids >= 0) & (ids < kk)
        want, absum = np.zeros((kk, d)), np.zeros((kk, d))
        np.add.at(want, ids[keep], x[keep].astype(np.float64))
        np.add.at(absum, ids[keep], np.abs(x[keep].astype(np.float64)))
        xt = torch.from_numpy(x).to(dev)
        it = torch.from_numpy(ids.astype(np.int32)).to(dev)
        out[("seg_main", kind)] = (lambda xt=xt, it=it: ops.segsum(xt, it, kk), want, absum)
    for kind, make in (("ordered", _ordered), ("random", _random)):
        v, g = make(rng, SEGSUM_ROWS, 7)
        want, absum = np.zeros(8), np.zeros(8)
        np.add.at(want, g, v.astype(np.float64))
        np.add.at(absum, g, np.abs(v.astype(np.float64)))
        vt = torch.from_numpy(v).to(dev)
        gt = torch.from_numpy(g).to(dev)
        out[("segment_sum", kind)] = (lambda vt=vt, gt=gt: rt._segment_sum(vt, gt, 8),
                                      want, absum)
    return out


def _dense(r, nb, torch):
    """A grouped result's sum column scattered back to its bucket ids."""
    s = torch.zeros(nb, dtype=torch.float32, device=r.valid.device)
    n = int(r.valid.sum())
    s[r.cols["g"][:n].long()] = r.cols["s"][:n]
    return s


def _smallest(ops, rt, torch, np, dev, tries):
    """Per route, the smallest ordered input whose calls differ (module
    docstring), or None up to 2^20."""
    from repro_torch.core.expr import AggSpec, col, const

    aggs = (AggSpec("sum", col("v"), "s"), AggSpec("count", const(1), "c"))
    found = {}
    for route in ("segment_sum", "gsa_smem", "gsa_global", "gja_smem", "gja_global",
                  "kms_main", "seg_main"):
        found[route] = None
        for log2 in range(6, 21, 2):
            n = 1 << log2
            rng = np.random.default_rng(log2)
            v, g = _ordered(rng, n, 4)
            vt = torch.from_numpy(v).to(dev)
            gt = torch.from_numpy(g.astype(np.int32)).to(dev)
            ones = torch.ones(n, dtype=torch.bool, device=dev)
            if route == "segment_sum":
                call = lambda: rt._segment_sum(vt, gt.long(), 4)  # noqa: E731
            elif route.startswith("gsa"):
                nb = INPUTS[route]
                t = rt.VecTable({"g": gt, "v": vt}, ones)
                call = lambda t=t, nb=nb: ops.grouped_select_agg(  # noqa: E731
                    t, None, ("g",), aggs, nb, ((0, nb - 1),), nb).cols["s"]
            elif route.startswith("gja"):
                nb, m = INPUTS[route], 64
                left = rt.VecTable({"g": gt, "v": vt, "fk": gt}, ones)
                right = rt.VecTable({"rk": torch.arange(m, dtype=torch.int32, device=dev)},
                                    torch.ones(m, dtype=torch.bool, device=dev))
                call = lambda left=left, right=right, nb=nb, m=m: ops.grouped_join_agg(  # noqa
                    left, right, left_on=("fk",), right_on=("rk",),
                    join_key_domains=((0, m - 1),), join_num_buckets=m, keys=("g",),
                    aggs=aggs, max_groups=nb, key_domains=((0, nb - 1),),
                    num_buckets=nb).cols["s"]
            elif route == "kms_main":
                x = (rng.normal(size=(n, 64)) * 10.0 ** rng.uniform(-2, 4, (n, 1)))
                xt = torch.from_numpy(x.astype(np.float32)).to(dev)
                ct = xt[:8].contiguous()
                call = lambda xt=xt, ct=ct: ops.kmeans_step(xt, ct)[0]  # noqa: E731
            else:
                dt = torch.from_numpy(np.stack([v] * 3, 1)).to(dev).contiguous()
                call = lambda dt=dt: ops.segsum(dt, gt, 100)  # noqa: E731
            first = call()
            for _ in range(tries):
                diff = _first_diff(first, call())
                if diff is not None:
                    found[route] = {"rows": n, **diff}
                    break
            if found[route] is not None:
                break
        print(f"smallest {route}: {json.dumps(found[route])}", flush=True)
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--label", default="")
    ap.add_argument("--smallest", action="store_true")
    ap.add_argument("--tries", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    from repro_torch.relational import runtime as rt

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    report = {"src": str(args.src), "label": args.label, "card": smi, "routes": {}}
    if args.smallest:
        report["smallest"] = _smallest(ops, rt, torch, np, dev, args.tries)
        print(json.dumps(report))
        return 0
    for (route, kind), (call, want, absum) in _cases(ops, rt, torch, np, dev).items():
        launches = dict(ops.GEN_LAUNCHES, **ops.KMEANS_LAUNCHES, **ops.SEGSUM_LAUNCHES)
        a = call()
        torch.cuda.synchronize()
        took = [r for r, c in dict(ops.GEN_LAUNCHES, **ops.KMEANS_LAUNCHES,
                                   **ops.SEGSUM_LAUNCHES).items() if c != launches.get(r)]
        b = call()
        got = a.detach().cpu().double().numpy().reshape(want.shape)
        err = float(np.max(np.abs(got - want) / np.maximum(absum, 1e-30)))
        rec = {"routes_launched": took, "same_bits": _first_diff(a, b) is None,
               "first_diff": _first_diff(a, b), "max_err_over_sum_abs": err}
        if kind == "random":
            rec["wrapper_ms"] = round(_cuda_ms(call, args.reps), 4)
            rec["device_ms"] = _device_ms(call, args.reps)
        report["routes"][f"{route}/{kind}"] = rec
        print(f"{route} {kind}: {json.dumps(rec)}", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
