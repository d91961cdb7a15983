"""Training driver: config → a planned train step → fault-tolerant loop (the
port's copy of ``repro/launch/train.py``).

The step is ``models.api.make_train_step`` (AdamW) on one device; this
driver owns the run loop: deterministic data (``data.TokenPipeline``),
checkpoint cadence and restore-on-failure (``distributed.StepRunner`` and
``CheckpointManager``), and the straggler log.  It runs on the card unless
``--device`` names another device; where no card is visible it exits with
a message rather than train on the CPU.

JAX's launcher jits the step with its state donated; here each step makes
a new state and the old one is freed when the runner drops it, so the
peak holds two copies of the parameters and moments for a moment.

On the CPU use reduced configs::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
        --device cpu --steps 12 --batch 4 --seq 32 --ckpt-dir /tmp/ck
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_reduced
from ..data.pipeline import TokenPipeline
from ..distributed.checkpoint import CheckpointManager
from ..distributed.fault import StepRunner
from ..models.api import build_model, make_train_step
from ..relational.runtime import resolve_device
from ..train.optimizer import AdamW


def make_batch_fn(cfg, pipeline: TokenPipeline,
                  device: Any = None) -> Callable[[int], Dict[str, torch.Tensor]]:
    """Adapt the token pipeline to the family's batch dict, on ``device``.
    The VLM batch, as JAX's: stub patch embeddings (B, S, D) as f32
    normals from ``np.random.default_rng((1234, step))``, ``positions3``
    the broadcast arange (3, B, S), and no tokens.  The enc-dec batch waits
    for its family."""
    if cfg.family == "encdec":
        raise NotImplementedError("the encdec family's batches (frames) wait for "
                                  "ROADMAP Queue 1 item 8.6")

    def at(step: int) -> Dict[str, torch.Tensor]:
        b = pipeline.batch_at(step)
        if cfg.family == "vlm":
            bsz, s = b.pop("tokens").shape
            rng = np.random.default_rng((1234, step))
            b["embeds"] = rng.normal(size=(bsz, s, cfg.d_model)).astype(np.float32)
            b["positions3"] = np.broadcast_to(np.arange(s, dtype=np.int32), (3, bsz, s)).copy()
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    return at


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b",
                    help="a dense, MoE or VLM config (the VLM trains on stub patch "
                         "embeddings)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers (widths kept)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu for the tests)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Tuple[Tuple[Any, Any], List[float]]:
    """Train as ``args`` say: ((params, opt_state) after the last step, the
    losses of the steps run)."""
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[train] {e}")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.layers is not None:
        cfg = replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    print(f"[train] {cfg.arch}: {cfg.n_params()/1e6:.1f}M params "
          f"({cfg.n_active_params()/1e6:.1f}M active) on {device}")

    params = model.init(torch.Generator(device).manual_seed(0))
    step_fn, opt = make_train_step(model, AdamW(lr=args.lr), microbatch=args.microbatch)
    opt_state = opt.init(params)

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        (params, opt_state), extra = ckpt.restore((params, opt_state))
        start_step = int(extra.get("step", 0))
        print(f"[train] resumed from step {start_step}")

    pipeline = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    batch_at = make_batch_fn(cfg, pipeline, device)
    runner = StepRunner(step_fn=step_fn, ckpt=ckpt, ckpt_every=args.ckpt_every)

    def batches():
        s = start_step
        while True:
            yield s, batch_at(s)
            s += 1

    t0 = time.time()
    state = runner.run((params, opt_state), batches(), start_step=start_step,
                       num_steps=args.steps)
    dt = time.time() - t0
    losses = [h.loss for h in runner.history if h.loss is not None]
    print(f"[train] {args.steps} steps in {dt:.1f}s "
          f"({1000*dt/max(1,args.steps):.0f} ms/step); "
          f"loss {losses[0]:.3f} → {losses[-1]:.3f}; "
          f"stragglers={runner.stragglers}")
    return state, losses


def main(argv=None) -> List[float]:
    return run(parse_args(argv))[1]


if __name__ == "__main__":
    main()
