"""Quickstart on the PyTorch port: one frontend program, three execution
strategies.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: a small
analytics query written once in the Python frontend, run

  1. sequentially (the local backend, fused into the kernels on the card),
  2. parallelized (the Split/ConcurrentExecute/pre-aggregate rewrite),
  3. with the rewritten IR shown at each stage,

then checked against the abstract machine (``target="interp"``).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the card by default; ``--device cpu`` runs the kernels' plain versions)
"""

import argparse

import numpy as np

from repro_torch.core.expr import col
from repro_torch.frontends.dataflow import Context, avg_, count_, sum_

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
args = ap.parse_args()
dev = args.device

# -- make a toy sales table ---------------------------------------------------
rng = np.random.default_rng(0)
n = 10_000
ctx = Context(pad_to=256)
ctx.register("sales", {
    "region": rng.integers(0, 8, n).astype(np.int32),
    "amount": rng.gamma(2.0, 50.0, n).astype(np.float32),
    "discount": rng.uniform(0, 0.2, n).astype(np.float32),
    "year": rng.integers(2018, 2026, n).astype(np.int32),
})

# -- one frontend program ------------------------------------------------------
q = (
    ctx.table("sales")
    .filter((col("year") >= 2020) & (col("discount") < 0.15))
    .with_columns(net=col("amount") * (1.0 - col("discount")))
    .group_by("region", max_groups=8)
    .agg(sum_("net").as_("revenue"), avg_("amount").as_("avg_amount"),
         count_().as_("n"))
    .order_by("region")
)

print("== logical CVM program (rel.* flavor) ==")
print(q.program("sales_by_region").render())

# -- 1. sequential local backend ----------------------------------------------
seq = q.collect(device=dev)
print(f"\n== sequential result ({dev}) ==")
for i in range(len(seq["region"])):
    print(f"  region {seq['region'][i]}: revenue={seq['revenue'][i]:.0f} "
          f"avg={seq['avg_amount'][i]:.1f} n={seq['n'][i]}")

# -- 2. parallelized (paper Alg. 1 → Alg. 2) ------------------------------------
compiled = ctx.compile(q, parallel=4, device=dev)
print("\n== parallelized physical program (vec.* flavor, 4 workers) ==")
print(compiled.program.render())
print("\n== per-pass instrumentation ==")
print(compiled.explain())
par = q.collect(parallel=4, device=dev)
assert np.allclose(np.sort(seq["revenue"]), np.sort(par["revenue"]), rtol=1e-5)
print("\nparallel == sequential ✓")

# the abstract machine (numpy on the host) agrees
oracle = q.collect(target="interp")
assert np.allclose(np.sort(seq["revenue"]), np.sort(np.asarray(oracle["revenue"])),
                   rtol=1e-5)
print("interp (abstract machine) == sequential ✓")

# recompiling the same frontend program is a structural-plan-cache hit
again = ctx.compile(q, parallel=4, device=dev)
assert again.cache_hit and again.executable is compiled.executable
print("repeated compile hit the plan cache ✓")

# -- 3. scalar aggregate fuses into the single-pass kernel ----------------------
q6ish = (
    ctx.table("sales")
    .filter(col("discount").between(0.05, 0.07))
    .agg(sum_(col("amount") * col("discount")).as_("promo_revenue"))
)
c = ctx.compile(q6ish, device=dev)
ops = c.program.opcodes()
print(f"\nscalar-agg pipeline ops: {ops}")
assert "vec.FusedSelectAgg" in ops, "fusion should produce the single-pass kernel op"
got = q6ish.collect(device=dev)
want = q6ish.collect(target="interp")
assert np.allclose(np.asarray(got["promo_revenue"], np.float64),
                   np.asarray(want["promo_revenue"], np.float64), rtol=1e-5)
print("fused select+aggregate pipeline ✓ →", got)
