"""End-to-end training on the PyTorch port: a small LM for a few hundred
steps.

The counterpart of ``examples/train_lm.py`` on ``repro_torch``: a scaled-down
qwen2 variant for 120 steps by default; ``--full-100m`` trains the
~100M-parameter configuration (same code path).  The deterministic data
pipeline, AdamW, checkpoints and resume, through
``repro_torch.launch.train.main``.

Run: PYTHONPATH=src python examples/torch_train_lm.py [--full-100m] [--steps N]
     [--device cpu] [--ckpt-dir DIR]   (the card by default)
"""

import argparse

from repro_torch.launch import train

ap = argparse.ArgumentParser()
ap.add_argument("--full-100m", action="store_true",
                help="~100M params (on the card; too slow for the CPU)")
ap.add_argument("--steps", type=int, default=120)
ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
ap.add_argument("--ckpt-dir", default="artifacts/torch_train_lm_ckpt")
args = ap.parse_args()

if args.full_100m:
    # ~100M-parameter qwen2-style config: d_model 768, 12L, vocab 32k
    from dataclasses import replace

    import repro_torch.configs.qwen2_1_5b as q
    cfg100 = replace(q.CONFIG, arch="qwen2-100m", n_layers=12, d_model=768,
                     n_heads=12, n_kv_heads=4, d_ff=3072, vocab=32768,
                     d_head=64, dtype="float32", remat=False)
    q.REDUCED = cfg100  # the launcher picks it up via --reduced

losses = train.main([
    "--arch", "qwen2-1.5b", "--reduced", "--device", args.device,
    "--steps", str(args.steps), "--batch", "8", "--seq", "64",
    "--lr", "3e-3", "--ckpt-every", "40",
    "--ckpt-dir", args.ckpt_dir,
])
print(f"loss trajectory: {losses[0]:.3f} → {losses[len(losses)//2]:.3f} → {losses[-1]:.3f}")
assert losses[-1] < losses[0], "training must reduce loss"
print(f"end-to-end training ✓ (checkpoints in {args.ckpt_dir})")
