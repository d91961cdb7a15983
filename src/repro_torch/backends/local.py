"""Local backend: runs a lowered vec program eagerly on torch tensors.

PyTorch executes operator by operator, so there is no counterpart of the
JAX package's ``jax.jit`` here; the fused operators are single kernel
launches instead.  ``compile`` returns an executable that takes the
source collections and returns the program results.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Mapping, Optional

from ..core.program import Program
from .emit import EvalCtx, evaluate_program


@dataclass
class Compiled:
    program: Program
    use_kernels: bool = True

    def __call__(self, sources: Optional[Mapping[str, Any]] = None, *args: Any) -> List[Any]:
        ctx = EvalCtx(sources=dict(sources or {}), use_kernels=self.use_kernels)
        return evaluate_program(ctx, self.program, *args)


class LocalBackend:
    name = "local"

    def __init__(self, use_kernels: bool = True) -> None:
        self.use_kernels = use_kernels

    def compile(self, program: Program) -> Compiled:
        return Compiled(program, self.use_kernels)
