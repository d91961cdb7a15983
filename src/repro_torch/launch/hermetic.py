"""Deterministic environments for the port's rank subprocesses.

Tests and launchers start rank processes with a minimal environment, so
stray user configuration cannot leak in.  The port's copy of
``repro/launch/hermetic.py``'s ``subprocess_env``: it sets only
``PYTHONPATH``, ``PATH`` and ``HOME`` (the port uses no JAX, so it pins no
JAX platform); a caller adds the rank's own variables as ``overrides``.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["subprocess_env", "run_ranks"]


def subprocess_env(repo_root: Path, **overrides: str) -> dict:
    """Minimal env for a rank subprocess: the repo's sources on the path."""
    env = {
        "PYTHONPATH": str(Path(repo_root) / "src"),
        "PATH": "/usr/bin:/bin",
        "HOME": os.path.expanduser("~"),
    }
    env.update(overrides)
    return env


def run_ranks(code: str, world: int, workdir: Path, repo_root: Path, *,
              timeout: float, **overrides: str) -> list:
    """Run ``python -c code`` as ``world`` rank processes and wait for all.

    Each rank gets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and
    ``INIT_FILE``, a ``file://`` rendezvous path under ``workdir`` (no
    port to collide with another run's), on top of :func:`subprocess_env`.
    Every rank is killed when ``timeout`` seconds have passed, so a rank
    that hangs in a collective fails the run instead of stalling it.
    Returns ``(returncode, stdout, stderr)`` per rank, in rank order."""
    import subprocess
    import sys
    import time

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    init = workdir / "rendezvous"
    if init.exists():
        init.unlink()
    procs, files = [], []
    try:
        for r in range(world):
            env = subprocess_env(repo_root, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                                 INIT_FILE=str(init), **overrides)
            files += [open(workdir / f"rank{r}.out", "w"), open(workdir / f"rank{r}.err", "w")]
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                          cwd=str(workdir), stdout=files[-2],
                                          stderr=files[-1]))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    return [(p.returncode, (workdir / f"rank{r}.out").read_text(),
             (workdir / f"rank{r}.err").read_text()) for r, p in enumerate(procs)]
