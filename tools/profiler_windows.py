"""How often a torch.profiler window keeps the device kernels launched in it.

Run on a CUDA card from the repository root:

    python3 tools/profiler_windows.py [--windows 8] [--cycles 3]

It times nothing.  It launches three bf16 ``flash_attention`` calls at the
serving shape of ``chip_smoke.py`` (q 4×12×2048×128, GQA over 2 kv heads)
inside each window and counts the device kernels the profiler recorded:
first in a fresh process, then after ``--cycles`` rounds of four spawned
gloo ranks that run collectives on CUDA tensors on the same card (as
``chip_smoke.py``'s spmd phase does), for windows padded with idle seconds
before the work, after it, on both sides or not at all.  Prints one JSON
object: per variant, the kernels each window kept (3 is all of them).
"""
import argparse
import datetime
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RANKS, CALLS, PAD_S = 4, 3, 2.0


def _rank(rank: int, world: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    x = torch.randn(1 << 22, device="cuda:0")
    for _ in range(20):
        dist.all_reduce(x)
        dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
        dist.all_to_all_single(torch.empty_like(x), x)
        dist.broadcast(x, 0)
    torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()


def _kept(fn, before: float, after: float) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(before)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(after)
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--cycles", type=int, default=3)
    a = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops

    g = torch.Generator("cuda").manual_seed(0)
    q = torch.randn(4, 12, 2048, 128, device="cuda", dtype=torch.bfloat16, generator=g)
    k = torch.randn(4, 2, 2048, 128, device="cuda", dtype=torch.bfloat16, generator=g)
    fa = lambda: ops.flash_attention(q, k, k, causal=True)  # noqa: E731
    fa()
    torch.cuda.synchronize()
    out = {"fresh, no pad": [_kept(fa, 0.0, 0.0) for _ in range(a.windows)]}
    t0 = time.perf_counter()
    for _ in range(a.cycles):
        with tempfile.TemporaryDirectory() as tmp:
            procs = [mp.get_context("spawn").Process(target=_rank, args=(r, RANKS, tmp))
                     for r in range(RANKS)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(120)
            if any(p.exitcode for p in procs):
                raise SystemExit(f"ranks exited {[p.exitcode for p in procs]}")
    out["rank_cycles_s"] = time.perf_counter() - t0
    for name, before, after in (("no pad", 0.0, 0.0), ("pad before", PAD_S, 0.0),
                                ("pad after", 0.0, PAD_S), ("pad both", PAD_S, PAD_S),
                                ("no pad, again", 0.0, 0.0)):
        out[f"after ranks, {name}"] = [_kept(fa, before, after) for _ in range(a.windows)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
