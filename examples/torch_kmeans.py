"""k-means through the LA flavor on the PyTorch port — the paper's Fig. 2
(right) workload.

The counterpart of ``examples/kmeans.py`` on ``repro_torch``: the same two
CVM mechanisms,
  * plan analysis / fusion: CDist2→ArgMinRow→SegSum/SegCount collapses into
    the fused la.KMeansStep (the ``kmeans_step`` kernel on the card),
  * the parallelization rewrite: points Split, centroids Broadcast,
    partials CombineChunks,
then five steps timed against a numpy baseline, whose centroids they must
match.

Run: PYTHONPATH=src python examples/torch_kmeans.py [--n 32768] [--device cpu]
(the card by default)
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.backends.local import LocalBackend
from repro_torch.core import Builder, verify
from repro_torch.core.passes import FuseKMeansStep, Parallelize
from repro_torch.core.types import F32, Tensor
from repro_torch.kmeans import make_data

ap = argparse.ArgumentParser()
ap.add_argument("--n", type=int, default=1 << 15)
ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
args = ap.parse_args()

n, d, k, iters = args.n, 8, 16, 5
X, C0 = make_data(n, d, k, 0)

# -- build the UNFUSED program (what a frontend would emit) --------------------
b = Builder("kmeans_iter")
xr = b.input("X", Tensor(F32, (n, d)))
cr = b.input("C", Tensor(F32, (k, d)))
dist = b.emit1("la.CDist2", [xr, cr])
lab = b.emit1("la.ArgMinRow", [dist])
sums = b.emit1("la.SegSum", [xr, lab], {"k": k})
counts = b.emit1("la.SegCount", [lab], {"k": k})
program = b.finish(sums, counts)
print("== frontend program ==")
print(program.render())

# -- fusion + parallelization rewrites -----------------------------------------
program = FuseKMeansStep().apply(program)
program = Parallelize(n=8, targets={xr.name}).apply(program)
verify(program)
print("\n== after FuseKMeansStep + Parallelize(8) ==")
print(program.render())

compiled = LocalBackend(device=args.device).compile(program)
x_dev = torch.from_numpy(X).to(args.device)


def step(x, c):
    sums, counts = compiled({}, x, c)
    return sums / torch.clamp(counts, min=1e-9)[:, None]


def sync():
    if x_dev.is_cuda:
        torch.cuda.synchronize()


# -- run ------------------------------------------------------------------------
C = torch.from_numpy(C0).to(args.device)
step(x_dev, C)  # warm-up (the kernel's first build and launch)
sync()
t0 = time.perf_counter()
for it in range(iters):
    C = step(x_dev, C)
sync()
cvm_t = (time.perf_counter() - t0) / iters
C = C.cpu().numpy()


# numpy "sklearn-style" baseline
def np_step(x, c):
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    labf = np.argmin(d2, axis=1)
    sums = np.zeros((k, d))
    np.add.at(sums, labf, x)
    cnt = np.maximum(np.bincount(labf, minlength=k), 1)
    return sums / cnt[:, None]


Cn = C0.copy()
t0 = time.perf_counter()
for it in range(iters):
    Cn = np_step(X, Cn)
np_t = (time.perf_counter() - t0) / iters

err = np.abs(np.sort(C, axis=0) - np.sort(Cn, axis=0)).max()
print(f"\nCVM-compiled k-means on {args.device}: {cvm_t*1e3:.2f} ms/iter; "
      f"numpy baseline: {np_t*1e3:.1f} ms/iter; speedup ×{np_t/cvm_t:.1f}")
print(f"centroid agreement (sorted) max|Δ| = {err:.2e}")
assert err < 1e-2
