"""Local backend: runs a lowered program eagerly on torch tensors.

PyTorch executes operator by operator, so there is no counterpart of the
JAX package's ``jax.jit`` here; the fused operators are single kernel
launches instead.  ``compile`` returns an executable that takes the
source collections and the program's positional inputs
(``compiled(sources, *args)``) and returns the program results.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..convert import tensors_from_arrays
from ..core.program import Program
from ..errors import DeviceMismatchError
from ..relational import runtime as rt
from .emit import EvalCtx, evaluate_program, read_taps


def _canonical(d: torch.device) -> torch.device:
    """``cuda`` without an index names the current card."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _on(dev: torch.device, value: Any, what: str) -> Any:
    """A numpy input moved to ``dev`` (x64 off); a tensor or table that
    lies elsewhere raises."""
    if isinstance(value, np.ndarray):
        return tensors_from_arrays(value, device=dev)[0]
    where = value.device if isinstance(value, (torch.Tensor, rt.VecTable)) else None
    if where is not None and _canonical(where) != _canonical(dev):
        raise DeviceMismatchError(f"{what} lies on {where}, but the backend runs on {dev}")
    return value


@dataclass
class Compiled:
    program: Program
    use_kernels: bool = True
    device: Any = None
    #: the plan's constants on the device, filled at the first call
    consts: Dict[Any, Any] = field(default_factory=dict)

    def _run(self, sources: Optional[Mapping[str, Any]], args: Any,
             taps: Optional[Dict[str, List[Any]]]) -> List[Any]:
        dev = rt.resolve_device(self.device)
        srcs = {k: _on(dev, v, f"source {k!r}") for k, v in dict(sources or {}).items()}
        ins = [_on(dev, a, f"input {i}") for i, a in enumerate(args)]
        ctx = EvalCtx(sources=srcs, use_kernels=self.use_kernels, device=dev,
                      consts=self.consts, taps=taps)
        return evaluate_program(ctx, self.program, *ins)

    def __call__(self, sources: Optional[Mapping[str, Any]] = None, *args: Any) -> List[Any]:
        return self._run(sources, args, None)

    def run_traced(self, sources: Optional[Mapping[str, Any]] = None, *args: Any):
        """Execute and measure: ``(results, {tap key → TapRecord}, {})``.

        The counts stay on the device while the plan runs and come back in
        one copy at the end (no sync per tapped operator); per-op wall
        times would need a sync per operator, hence the empty third
        element, as the JAX package's jitted backend returns."""
        from ..obs.feedback import TapRecord

        taps: Dict[str, List[Any]] = {}
        outs = self._run(sources, args, taps)
        cards = {k: TapRecord(int(occ), None if ri is None else int(ri), int(ro))
                 for k, (occ, ri, ro) in read_taps(taps).items()}
        return outs, cards, {}


class LocalBackend:
    """Runs on ``device`` (``cuda`` unless given; resolved at each call,
    so a program compiles on a machine without a card)."""

    name = "local"

    def __init__(self, use_kernels: bool = True, device: Any = None) -> None:
        self.use_kernels = use_kernels
        self.device = device

    def compile(self, program: Program) -> Compiled:
        return Compiled(program, self.use_kernels, self.device)
