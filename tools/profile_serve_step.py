"""Where one prefill wave and one decode step of a served model spend their
time on the card.

Run on a CUDA card from the repository root:

    python3 tools/profile_serve_step.py [--arch moonshot-v1-16b-a3b] [--layers N]

Builds the config at full width (depth cut to ``--layers`` where given),
bf16, parameters from ``model.init`` with seed 0 and ``attn_mode="pallas"``,
and runs a warm-up prefill of ``chip_smoke.py``'s serving traffic (4
prompts of 2048 tokens, seed 0, a cache of 2080) and three decode steps.
Then, for one prefill and one decode step: the call's wall time (the median
of 5, the card synchronised before and after each), and one call under
``torch.profiler`` in a window padded with idle seconds on both sides
(``chip_smoke._profiled``): the device kernels' time, the number of kernel
launches, the top 15 kernels by device time, and the busy share (device
time over the wall median).  Prints the card's name and power limit, then
one JSON object per call.  Without a visible card it exits with code 2.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b")
    ap.add_argument("--layers", type=int, default=None)
    a = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("profile_serve_step: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, make_serve_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg = replace(get_config(a.arch), attn_mode="pallas")
    if a.layers:
        cfg = replace(cfg, n_layers=a.layers)
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (cs.SERVE_BATCH, cs.SERVE_PROMPT))
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    serve = make_serve_step(model)
    with torch.inference_mode():
        logits, cache = model.prefill(params, batch, cs.SERVE_CAP)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        for _ in range(3):
            tok, _, cache = serve(params, cache, tok)
        torch.cuda.synchronize()
        # the decode step is called on the same cache each time: it writes
        # its key and value at the same place, the cost of a step is alike
        calls = {"prefill": lambda: model.prefill(params, batch, cs.SERVE_CAP),
                 "decode step": lambda: serve(params, cache, tok)}
        for label, fn in calls.items():
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            wall = statistics.median(walls)
            prof = cs._profiled(lambda: (fn(), torch.cuda.synchronize()),
                                [ProfilerActivity.CPU, ProfilerActivity.CUDA])
            events = cs._device_events(prof)
            dev_ms = sum(e.self_device_time_total for e in events) / 1e3
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
            print(json.dumps({
                "arch": cfg.arch, "layers": cfg.n_layers, "call": label, "card": smi,
                "wall_ms_median": wall, "wall_ms": walls, "device_kernel_ms": dev_ms,
                "kernel_launches": sum(e.count for e in events), "busy_share": dev_ms / wall,
                "top": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3} for e in top]}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
