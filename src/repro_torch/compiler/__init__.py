"""The compile driver of the torch port, its plan cache, and the table
statistics.

``compile`` runs the JAX package's ``local`` lowering path under a bound
strategy — ``groupby`` (direct | sorted), ``join`` (hash | sorted),
``encode`` (raw | dict) and ``fuse`` (fused | unfused):

    CommonSubexpressionElimination, DeadCodeElimination
    → Parallelize(n=parallel)                      (when parallel > 1)
    → LowerRelToVec(catalog with statistics, groupby/join/encode)
    → FuseSelectAgg, FuseSelectGroupAgg, FuseJoinGroupAgg, DeadCodeElimination
                                                   (fuse=fused only)
    → verify

and hands the program to the eager torch backend.  Every compile goes
through a :class:`PlanCache` first (``PLAN_CACHE`` unless the caller
passes its own, or ``cache=False``): the same program under the same
options on the same device skips the passes.  The cost search
(``optimize="cost"``) raises ``NotImplementedError`` naming the ROADMAP
item that brings it.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

from ..core import verify
from ..core.passes import (
    CommonSubexpressionElimination, DeadCodeElimination, FuseJoinGroupAgg,
    FuseSelectAgg, FuseSelectGroupAgg, Parallelize,
)
from ..core.passes.lower_vec import Catalog, LowerRelToVec
from ..core.program import Program
from ..obs.trace import get_tracer
from .fingerprint import fingerprint
from .stats import Dictionary, Statistics, propagate, stats_from_columns  # noqa: F401

#: the strategy this package binds where the caller names none (the JAX
#: package defaults to sorted/sorted: ROADMAP Queue 3 lists the divergence)
DEFAULT_STRATEGY: Dict[str, str] = {
    "groupby": "direct", "join": "hash", "encode": "raw", "fuse": "fused"}

_VARIANTS = {"groupby": ("direct", "sorted"), "join": ("hash", "sorted"),
             "encode": ("raw", "dict"), "fuse": ("fused", "unfused")}


def normalize_strategy(strategy: Any = None) -> Dict[str, str]:
    """The full choice → label binding: ``strategy`` (a dict or pairs)
    over the defaults."""
    chosen = dict(DEFAULT_STRATEGY)
    for name, label in dict(strategy or {}).items():
        if name not in _VARIANTS:
            raise ValueError(f"unknown strategy choice {name!r}; known: {sorted(_VARIANTS)}")
        if label not in _VARIANTS[name]:
            raise ValueError(f"choice {name!r} has no variant {label!r}; "
                             f"known: {list(_VARIANTS[name])}")
        chosen[name] = label
    return chosen


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------


class PlanCache:
    """LRU cache of compiled plans keyed by (target, device, fingerprint,
    options), as ``repro.compiler.driver.PlanCache``."""

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = capacity
        self._entries: "OrderedDict[Tuple, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, key: Tuple) -> Optional[Any]:
        got = self._entries.get(key)
        if got is None:
            self.misses += 1
            get_tracer().counter("plan_cache.miss")
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        get_tracer().counter("plan_cache.hit")
        return got

    def store(self, key: Tuple, result: Any) -> None:
        self._entries[key] = result
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
            get_tracer().counter("plan_cache.evict")

    def drop(self, key: Tuple) -> None:
        """Invalidate one entry."""
        self._entries.pop(key, None)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self._entries)}


#: process-wide default cache: a repeated ``collect`` of the same frame
#: skips the lowering passes
PLAN_CACHE = PlanCache()


@dataclass
class CompileResult:
    """A compiled plan: ``result(sources, *args) -> [results]``, with the
    lowered ``program`` and whether it came from the cache."""

    executable: Any
    program: Program
    cache_hit: bool = False

    def __call__(self, sources: Any = None, *args: Any) -> List[Any]:
        return self.executable(sources, *args)


def _catalog_key(catalog: Catalog) -> Tuple:
    """The catalog's part of the cache key (``CompileOptions.cache_key``)."""
    stats = catalog.stats
    return (tuple(sorted(catalog.capacities.items())), catalog.default_max_groups,
            catalog.join_selectivity, stats.cache_key() if stats is not None else None)


def _lower(program: Program, catalog: Catalog, parallel: Optional[int],
           chosen: Dict[str, str]) -> Program:
    passes: List[Any] = [CommonSubexpressionElimination(), DeadCodeElimination()]
    if parallel is not None and parallel > 1:
        passes.append(Parallelize(n=parallel))
    passes.append(LowerRelToVec(catalog, groupby=chosen["groupby"], join=chosen["join"],
                                encode=chosen["encode"]))
    if chosen["fuse"] == "fused":
        passes += [FuseSelectAgg(), FuseSelectGroupAgg(), FuseJoinGroupAgg(),
                   DeadCodeElimination()]
    for p in passes:
        program = p.apply(program)
        verify(program, allow_unknown_ops=True)
    verify(program)
    return program


def compile(program: Program, catalog: Optional[Catalog] = None, *,
            use_kernels: bool = True, parallel: Optional[int] = None,
            optimize: Optional[str] = None, strategy: Any = None, device: Any = None,
            cache: Union[None, bool, PlanCache] = None) -> CompileResult:
    """Lower a ``rel`` program to the vec flavor and bind it to the torch
    backend on ``device`` (``cuda`` unless given, resolved when it runs);
    returns a callable ``compiled(sources) -> [results]`` whose
    ``.program`` is the lowered program.  ``parallel=n`` splits the sources
    into ``n`` chunks (the paper's parallelization rewrite).  ``cache`` is
    the plan cache to look in and fill: ``None`` the process-wide
    ``PLAN_CACHE``, ``False`` none."""
    import torch

    from ..backends.local import LocalBackend

    if optimize is not None:
        raise NotImplementedError(
            f"optimize={optimize!r} is not ported to torch yet (ROADMAP Queue 1: "
            "cost search, plan store, fallback ladder and taps)")
    chosen = normalize_strategy(strategy)
    catalog = catalog if catalog is not None else Catalog()
    plan_cache = None if cache is False else (
        PLAN_CACHE if cache is None or cache is True else cache)
    key = None
    if plan_cache is not None:
        # the device as named, not resolved: a plan compiles where no card is
        key = ("local", str(torch.device("cuda" if device is None else device)),
               fingerprint(program), (parallel, use_kernels, tuple(sorted(chosen.items())),
                                      optimize, _catalog_key(catalog)))
        hit = plan_cache.lookup(key)
        if hit is not None:
            return CompileResult(hit.executable, hit.program, cache_hit=True)
    lowered = _lower(program, catalog, parallel, chosen)
    result = CompileResult(LocalBackend(use_kernels=use_kernels, device=device).compile(lowered),
                           lowered)
    if plan_cache is not None:
        plan_cache.store(key, result)
    return result
