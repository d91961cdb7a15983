"""A CPU probe of the hybrid family's f32 train step (no card needed).

``--conditioning``: how far the one-device f32 train step (microbatch 2,
B = 4, S = 32) lies from the same step in f64, leaf by leaf, for the
reduced Zamba2 (its Mamba decays drawn as Mamba2 initialises them:
exp(A_log) ~ U(1, 16), dt log-uniform in [0.001, 0.1], D ~ N(1, 0.3)) and
the reduced Qwen2: the rounding that a sharded step, whose sums run in
another order, is measured against.  Which DTensor ops of the hybrid's
sharded train cell output strided placements is
``tests/test_torch_dryrun.py::test_hybrid_train_cell_on_the_multi_pod_mesh_plans_no_strided_placement``'s
to check.

Usage::

    python3 tools/hybrid_mesh_probe.py --conditioning
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def conditioning() -> dict:
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.train.optimizer import Optimizer, tree_leaves, tree_map

    grads_of = Optimizer(lambda p: {}, lambda g, st, p: (g, st))
    batch = {k: torch.from_numpy(v) for k, v in
             TokenPipeline(vocab=512, seq_len=32, global_batch=4, seed=5).batch_at(0).items()}
    out = {}
    for arch in ("zamba2-7b", "qwen2-1.5b"):
        cfg = get_reduced(arch)
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        if cfg.family == "hybrid":
            mamba, rng = params["layers"]["mamba"], np.random.default_rng(3)
            shape = tuple(mamba["A_log"].shape)
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
            mamba["A_log"] = torch.from_numpy(np.log(rng.uniform(1.0, 16.0, shape))).float()
            mamba["dt_bias"] = torch.from_numpy(dt + np.log(-np.expm1(-dt))).float()
            mamba["D"] = torch.from_numpy(rng.normal(1.0, 0.3, shape)).float()
        grads = {}
        for dtype in ("float32", "float64"):
            model = build_model(replace(cfg, dtype=dtype))
            p = params if dtype == "float32" else tree_map(lambda t: t.double(), params)
            grads[dtype] = tree_leaves(make_train_step(model, grads_of, microbatch=2)[0](
                p, {}, batch)[0])
        gaps = [float((a.double() - b).norm() / b.norm())
                for a, b in zip(grads["float32"], grads["float64"])]
        out[arch] = {"f32_vs_f64_grad_rel_max": max(gaps), "leaves": len(gaps)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conditioning", action="store_true", help="the probe (the default)")
    ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    print(json.dumps({"conditioning": conditioning()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
