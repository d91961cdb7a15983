"""TPC-H through CVM on the PyTorch port — the paper's main workload
(Figs. 2–4).

The counterpart of ``examples/tpch_cvm.py`` on ``repro_torch``: the six
implemented queries through the full rewrite pipeline on the local backend
(the generated kernels on the card), each validated against its numpy
reference; the script exits 1 if any query disagrees.

Run: PYTHONPATH=src python examples/torch_tpch_cvm.py [--sf 0.005] [--parallel 4]
     [--device cpu]   (the card by default)
"""

import argparse
import sys
import time

import numpy as np

from repro_torch.frontends.dataflow import _to_numpy
from repro_torch.relational import tpch

ap = argparse.ArgumentParser()
ap.add_argument("--sf", type=float, default=0.005)
ap.add_argument("--parallel", type=int, default=None)
ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
args = ap.parse_args()

tables = tpch.generate(sf=args.sf, seed=0)
ctx = tpch.make_context(tables)
print(f"TPC-H sf={args.sf} on {args.device}: "
      f"lineitem={len(tables['lineitem']['l_orderkey']):,} rows, "
      f"orders={len(tables['orders']['o_orderkey']):,}, part={len(tables['part']['p_partkey']):,}")

bad = []
for qname in sorted(tpch.QUERIES):
    frame = tpch.QUERIES[qname](ctx)
    compiled = ctx.compile(frame, parallel=args.parallel, device=args.device)
    sources = ctx.sources(args.device)
    compiled(sources)  # warm-up (the kernels' first build and launch)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        (out,) = compiled(sources)
    dt = (time.perf_counter() - t0) / reps * 1e3

    got = _to_numpy(out)
    want = tpch.REFERENCES[qname](tables)
    checks = []
    for kcol in want:
        g = np.sort(np.asarray(got[kcol], dtype=np.float64).ravel())
        w = np.sort(np.asarray(want[kcol], dtype=np.float64).ravel())
        checks.append(g.shape == w.shape and np.allclose(g, w, rtol=2e-3))
    status = "✓" if all(checks) else "✗ MISMATCH"
    if not all(checks):
        bad.append(qname)
    n_ops = len(compiled.program.opcodes())
    print(f"  {qname:>4}: {dt:7.1f} ms   {n_ops:3d} physical ops   ref {status}")
if bad:
    sys.exit(f"queries disagree with their numpy references: {bad}")
print(f"all {len(tpch.QUERIES)} queries match their numpy references ✓")
