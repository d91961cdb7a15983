"""The compile driver of the torch port, and the table statistics.

``compile`` runs one fixed lowering path — the JAX package's ``local``
target under the strategy ``groupby=direct, join=hash, encode=raw,
fuse=fused``:

    CommonSubexpressionElimination, DeadCodeElimination
    → Parallelize(n=parallel)                      (when parallel > 1)
    → LowerRelToVec(catalog with statistics, groupby/join/encode)
    → FuseSelectAgg, FuseSelectGroupAgg, FuseJoinGroupAgg, DeadCodeElimination
    → verify

and hands the program to the eager torch backend.  The strategies this
package does not execute yet raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..core import verify
from ..core.passes import (
    CommonSubexpressionElimination, DeadCodeElimination, FuseJoinGroupAgg,
    FuseSelectAgg, FuseSelectGroupAgg, Parallelize,
)
from ..core.passes.lower_vec import Catalog, LowerRelToVec
from ..core.program import Program
from .stats import Dictionary, Statistics, propagate, stats_from_columns  # noqa: F401

#: the one strategy this package executes
DEFAULT_STRATEGY: Dict[str, str] = {
    "groupby": "direct", "join": "hash", "encode": "raw", "fuse": "fused"}

_SUPPORTED = {"groupby": ("direct",), "join": ("hash",), "encode": ("raw",),
              "fuse": ("fused",)}
_LATER = {
    ("groupby", "sorted"): "ROADMAP Queue 1: the sorted tiers",
    ("join", "sorted"): "ROADMAP Queue 1: the sorted tiers",
    ("encode", "dict"): "ROADMAP Queue 1: dict encode/decode",
    ("fuse", "unfused"): "ROADMAP Queue 1: cost search, plan store, fallback ladder and taps",
}


def normalize_strategy(strategy: Any = None) -> Dict[str, str]:
    """The full choice → label binding: ``strategy`` (a dict or pairs)
    over the defaults."""
    chosen = dict(DEFAULT_STRATEGY)
    for name, label in dict(strategy or {}).items():
        if name not in _SUPPORTED:
            raise ValueError(f"unknown strategy choice {name!r}; known: {sorted(_SUPPORTED)}")
        if label not in _SUPPORTED[name]:
            where = _LATER.get((name, label))
            if where is None:
                raise ValueError(f"choice {name!r} has no variant {label!r}")
            raise NotImplementedError(
                f"strategy {name}={label} is not ported to torch yet ({where})")
        chosen[name] = label
    return chosen


def compile(program: Program, catalog: Optional[Catalog] = None, *,
            use_kernels: bool = True, parallel: Optional[int] = None,
            optimize: Optional[str] = None, strategy: Any = None, device: Any = None):
    """Lower a ``rel`` program to the vec flavor and bind it to the torch
    backend on ``device`` (``cuda`` unless given, resolved when it runs);
    returns a callable ``compiled(sources) -> [results]`` whose
    ``.program`` is the lowered program.  ``parallel=n`` splits the sources
    into ``n`` chunks (the paper's parallelization rewrite)."""
    from ..backends.local import LocalBackend

    if optimize is not None:
        raise NotImplementedError(
            f"optimize={optimize!r} is not ported to torch yet (ROADMAP Queue 1: "
            "cost search, plan store, fallback ladder and taps)")
    chosen = normalize_strategy(strategy)
    passes = [CommonSubexpressionElimination(), DeadCodeElimination()]
    if parallel is not None and parallel > 1:
        passes.append(Parallelize(n=parallel))
    passes += [LowerRelToVec(catalog if catalog is not None else Catalog(),
                             groupby=chosen["groupby"], join=chosen["join"],
                             encode=chosen["encode"]),
               FuseSelectAgg(), FuseSelectGroupAgg(), FuseJoinGroupAgg(),
               DeadCodeElimination()]
    for p in passes:
        program = p.apply(program)
        verify(program, allow_unknown_ops=True)
    verify(program)
    return LocalBackend(use_kernels=use_kernels, device=device).compile(program)
