"""Fault tolerance: retrying step runner, straggler detection, elastic hooks
(the port's copy of ``repro/distributed/fault.py``).

On a real cluster the failure signals are runtime errors (device loss,
collective timeout) and heartbeat gaps; here they surface as exceptions
from the step callable.  The runner implements the standard production
policy around them:

  * **checkpoint cadence** + restore-on-failure (bounded retries);
  * **straggler detection**: EWMA of step time via
    :class:`repro_torch.robust.retry.StragglerDetector`; a step slower than
    ``straggler_factor``× the EWMA is logged and counted — the hook where a
    real deployment triggers pre-emptive re-sharding or backup workers;
  * **elastic resize**: on ``ElasticEvent`` the caller re-builds the mesh
    from surviving hosts and the runner restores the last checkpoint onto
    the new topology (checkpointing is placement-agnostic; see
    ``checkpoint.CheckpointManager.restore``).

A step on the card returns before the card has done its work, so a step's
time is taken after its loss is read (or its device synchronised), and a
fault of the card or of a kernel (:func:`repro_torch.errors.is_card_fault`)
re-raises at once: a sticky CUDA error leaves the context unusable, so a
restore would only fail again (the JAX runner retries every exception).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..errors import is_card_fault
from ..robust.retry import StragglerDetector
from .checkpoint import CheckpointManager


class ElasticEvent(Exception):
    """Raised (by the platform layer) when the device set changed."""


def _synchronize() -> None:
    """Wait for the card, where this process has used one."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class StepStats:
    step: int
    seconds: float
    straggler: bool
    loss: Optional[float] = None


@dataclass
class StepRunner:
    step_fn: Callable[..., Tuple[Any, ...]]   # (state..., batch) -> (state..., metrics)
    ckpt: CheckpointManager
    ckpt_every: int = 50
    max_retries: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    history: List[StepStats] = field(default_factory=list)
    stragglers: int = 0

    def run(self, state: Tuple[Any, ...], batches, *, start_step: int = 0,
            num_steps: int = 100,
            on_failure: Optional[Callable[[int, Exception], None]] = None):
        """Drive ``num_steps`` steps with checkpointing + retry-restore."""
        detector = StragglerDetector(factor=self.straggler_factor,
                                     alpha=self.ewma_alpha)
        step = start_step
        retries = 0
        it = iter(batches)
        while step < start_step + num_steps:
            got = next(it)
            batch_step, batch = got if isinstance(got, tuple) else (step, got)
            t0 = time.time()
            try:
                *new_state, metrics = self.step_fn(*state, batch)
            except Exception as e:  # device loss / elastic event / NaN guard
                retries += 1
                if on_failure is not None:
                    on_failure(step, e)
                if retries > self.max_retries or is_card_fault(e):
                    raise
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state, extra = self.ckpt.restore(tuple(state))
                    step = int(extra.get("step", latest))
                continue
            retries = 0
            loss = None
            if isinstance(metrics, dict) and "loss" in metrics:
                loss = float(metrics["loss"])  # waits for the step's device
            else:
                _synchronize()
            dt = time.time() - t0
            straggler = detector.observe(dt)
            if straggler:
                self.stragglers += 1
            self.history.append(StepStats(step, dt, straggler, loss))
            state = tuple(new_state)
            step += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, state, extra={"step": step})
        return state
