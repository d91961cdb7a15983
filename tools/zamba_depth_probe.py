"""Zamba2-7B served at full width through flash_attention, at several
depths and seeds: how far the kernel path's logits lie from the plain
path's, beside how far two correct paths lie from each other (needs the
card).

For each depth and seed: the weights from ``model.init`` with that seed,
SERVE_BATCH × SERVE_PROMPT prompt tokens from ``default_rng(seed)``, then
ZAMBA_GEN greedy decode steps (``chip_smoke.prefill_decode``), through
attn_mode "pallas" (the kernel), "ref" (the plain version), f64 attention
rounded once (``chip_smoke.exact_attention``) and "chunked".  Each pair's
largest |Δ| and RMS over the steps both were fed the same tokens
(``chip_smoke.path_gap``, ``logit_rms_gap``), and whether pallas against
ref passes ``chip_smoke.phase_zamba2``'s rule: within the larger of
LOGIT_STD_SHARE of the logits' std and NOISE_FACTOR × ref's own distance
from the f64-attention run.  ``--f32`` adds the same runs in f32 at the
first depth and seed (the kernel's f32 route on the CUDA cores), the
witness without bf16's rounding.

Usage::

    python3 tools/zamba_depth_probe.py [--depths 21 39] [--seeds 0 1 2] [--f32]

One JSON object a line on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def probe(depth: int, seed: int, dtype: str) -> dict:
    from dataclasses import replace

    import numpy as np
    import torch

    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    base = replace(get_config(smoke.ZAMBA_ARCH), n_layers=depth, dtype=dtype)
    params = build_model(base).init(torch.Generator("cuda").manual_seed(seed))
    tokens = np.random.default_rng(seed).integers(0, base.vocab,
                                                  (smoke.SERVE_BATCH, smoke.SERVE_PROMPT))
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    runs = {}
    for name, mode in (("pallas", "pallas"), ("ref", "ref"), ("exact", smoke.exact_attention),
                       ("chunked", "chunked")):
        ops.reset_launches()
        _, logits, _, _ = smoke.prefill_decode(build_model(replace(base, attn_mode=mode)), params,
                                               batch, smoke.ZAMBA_GEN)
        runs[name] = logits
        if name == "pallas" and ops.LAUNCHES["flash_attention"] != base.n_attn_points:
            raise AssertionError(f"pallas launched {dict(ops.LAUNCHES)}, not flash_attention "
                                 f"{base.n_attn_points}")
    out = {"depth": depth, "seed": seed, "dtype": dtype, "attn_points": base.n_attn_points}
    for a, b in (("pallas", "ref"), ("chunked", "ref"), ("ref", "exact"), ("pallas", "exact"),
                 ("chunked", "exact")):
        _, worst, same, std = smoke.path_gap(runs[a], runs[b])
        out[f"{a}_vs_{b}"] = {"max_abs": worst, "rms": smoke.logit_rms_gap(runs[a], runs[b]),
                              "same_token_steps": same, "std": std}
    noise, std = out["ref_vs_exact"]["max_abs"], out["pallas_vs_ref"]["std"]
    limit = max(smoke.LOGIT_STD_SHARE * std, smoke.NOISE_FACTOR * noise)
    out["rule"] = {"limit": limit, "pallas_passes": out["pallas_vs_ref"]["max_abs"] <= limit,
                   "chunked_passes": out["chunked_vs_ref"]["max_abs"] <= limit}
    del params, runs
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", type=int, nargs="+", default=[21, 39])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--f32", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("zamba_depth_probe needs the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cells = [(d, s, "bfloat16") for d in a.depths for s in a.seeds]
    if a.f32:
        cells.append((a.depths[0], a.seeds[0], "float32"))
    for depth, seed, dtype in cells:
        print(json.dumps(probe(depth, seed, dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
