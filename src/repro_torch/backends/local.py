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
from ..relational import runtime as rt
from .emit import EvalCtx, evaluate_program


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
        raise ValueError(f"{what} lies on {where}, but the backend runs on {dev}")
    return value


@dataclass
class Compiled:
    program: Program
    use_kernels: bool = True
    device: Any = None
    #: the plan's constants on the device, filled at the first call
    consts: Dict[Any, Any] = field(default_factory=dict)

    def __call__(self, sources: Optional[Mapping[str, Any]] = None, *args: Any) -> List[Any]:
        dev = rt.resolve_device(self.device)
        srcs = {k: _on(dev, v, f"source {k!r}") for k, v in dict(sources or {}).items()}
        ins = [_on(dev, a, f"input {i}") for i, a in enumerate(args)]
        ctx = EvalCtx(sources=srcs, use_kernels=self.use_kernels, device=dev,
                      consts=self.consts)
        return evaluate_program(ctx, self.program, *ins)


class LocalBackend:
    """Runs on ``device`` (``cuda`` unless given; resolved at each call,
    so a program compiles on a machine without a card)."""

    name = "local"

    def __init__(self, use_kernels: bool = True, device: Any = None) -> None:
        self.use_kernels = use_kernels
        self.device = device

    def compile(self, program: Program) -> Compiled:
        return Compiled(program, self.use_kernels, self.device)
