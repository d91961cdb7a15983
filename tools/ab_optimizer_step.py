"""A train step's time under this checkout's optimizer against another
checkout's, in one process on one card.

Run on a CUDA card from the repository root:

    python3 tools/ab_optimizer_step.py --other PATH/src/repro_torch/train/optimizer.py \\
        [--arch qwen2-1.5b] [--steps 3]

Builds the config at full width and depth in bf16 (parameters from
``model.init`` with seed 0, ``chip_smoke.py``'s train batch: B = 4,
S = 2048 from ``TokenPipeline(seed=0).batch_at(0)``) and runs
``make_train_step`` with AdamW (lr 3e-3) taken from the other file, from
this checkout, from this checkout and from the other file again (other,
this, this, other), each from the same parameters: a warm-up step, then
``--steps`` steps, each timed on the host clock with the card
synchronised.  The other file is loaded by path; it must need nothing but
``torch`` (``train/optimizer.py`` does).  Prints the card's name and power
limit, then one JSON object: per turn the median step ms, the losses and
the largest |Δ| of the parameters against the first turn's after the same
steps.  Without a visible card it exits with code 2.
"""
import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="another checkout's train/optimizer.py")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_optimizer_step: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.train import optimizer as this
    from repro_torch.train.optimizer import tree_leaves

    spec = importlib.util.spec_from_file_location("other_optimizer", a.other)
    other = sys.modules[spec.name] = importlib.util.module_from_spec(spec)  # for its dataclass
    spec.loader.exec_module(other)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    model = build_model(get_config(a.arch))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    got = TokenPipeline(vocab=model.cfg.vocab, seq_len=2048, global_batch=4, seed=0).batch_at(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in got.items()}
    turns, first = [], None
    for label, mod in (("other", other), ("this", this), ("this", this), ("other", other)):
        step, opt = make_train_step(model, mod.AdamW(lr=3e-3))
        p, state = params, opt.init(params)
        p, state, met = step(p, state, batch)  # warm-up
        losses, times = [float(met["loss"])], []
        for _ in range(a.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, state, met = step(p, state, batch)
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        leaves = [t.detach().float() for t in tree_leaves(p)]
        first = first or leaves
        gap = max(float((x - y).abs().max()) for x, y in zip(leaves, first))
        turns.append({"optimizer": label, "step_ms_median": statistics.median(times) * 1e3,
                      "step_ms": [t * 1e3 for t in times], "losses": losses,
                      "max_abs_param_gap_vs_first_turn": gap})
        del p, state, met, leaves
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"arch": a.arch, "other": a.other, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
