"""Where one prefill wave and one decode step of a served model (and,
with ``--train``, one train step) spend their time on the card.

Run on a CUDA card from the repository root:

    python3 tools/profile_serve_step.py [--arch moonshot-v1-16b-a3b] [--layers N] [--train]

Builds the config at full width (depth cut to ``--layers`` where given),
bf16, parameters from ``model.init`` with seed 0 and ``attn_mode="pallas"``,
and runs a warm-up prefill of ``chip_smoke.py``'s serving traffic (4
prompts of 2048 tokens, seed 0, a cache of 2080; for the enc-dec
Whisper-base, 16 × 1500 stub frames already on the card, a cache of 448,
decode from a zero token) and three decode steps.  With ``--train``, also
``chip_smoke.py``'s train step of the config (its own attention mode,
AdamW, the launcher's batch from ``TokenPipeline(seed=0)``: B = 4,
S = 2048; Whisper-base B = 16, S = 448 tokens and frames).  Then, for each
call: its wall time (the median of 5, the card synchronised before and
after each), and one call under ``torch.profiler`` in a window padded with
idle seconds on both sides (``chip_smoke._profiled``): the device kernels'
time, the number of kernel launches, the top 15 kernels by device time,
and the busy share (device time over the wall median).  Prints the card's
name and power limit, then one JSON object per call.  Without a visible
card it exits with code 2.
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
    ap.add_argument("--train", action="store_true", help="also profile one train step")
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
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model, make_serve_step, make_train_step
    from repro_torch.train.optimizer import AdamW

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    base = get_config(a.arch)
    if a.layers:
        base = replace(base, n_layers=a.layers,
                       **({"n_enc_layers": a.layers} if base.family == "encdec" else {}))
    cfg = replace(base, attn_mode="pallas")
    enc = cfg.family == "encdec"
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    if enc:
        b, cap = cs.WHISPER_BATCH, cs.WHISPER_CAP
        frames = rng.normal(size=(b, cs.WHISPER_FRAMES, cfg.d_model)).astype(np.float32)
        batch = {"frames": torch.from_numpy(frames).cuda()}
    else:
        b, cap = cs.SERVE_BATCH, cs.SERVE_CAP
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, cs.SERVE_PROMPT)))
                 .cuda()}
    serve = make_serve_step(model)

    def prefill():
        with torch.inference_mode():
            if enc:  # an enc-dec prefill gives the cache alone; decode from a zero token
                return torch.zeros((b, 1), dtype=torch.int32, device="cuda"), \
                    model.prefill(params, batch, cap)
            logits, cache = model.prefill(params, batch, cap)
            return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    tok, cache = prefill()
    with torch.inference_mode():
        for _ in range(3):
            tok, _, cache = serve(params, cache, tok)
    torch.cuda.synchronize()

    def decode():
        with torch.inference_mode():
            return serve(params, cache, tok)

    # the decode step is called on the same cache each time: it writes
    # its key and value at the same place, the cost of a step is alike
    calls = {"prefill": prefill, "decode step": decode}
    if a.train:
        tb, ts = (cs.WHISPER_TRAIN_B, cs.WHISPER_CAP) if enc else (cs.TRAIN_B, cs.TRAIN_S)
        tmodel = build_model(base)
        tparams = tmodel.init(torch.Generator("cuda").manual_seed(0))
        step, opt = make_train_step(tmodel, AdamW(lr=cs.TRAIN_LR))
        state = opt.init(tparams)
        tbatch = make_batch_fn(base, TokenPipeline(vocab=base.vocab, seq_len=ts, global_batch=tb,
                                                   seed=0), "cuda")(0)
        step(tparams, state, tbatch)  # warm-up
        calls["train step"] = lambda: step(tparams, state, tbatch)
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
