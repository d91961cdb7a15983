"""Backend target registry: declarative, flavor-aware lowering paths.

The port's copy of ``repro/compiler/targets.py``, cut to the targets this
package runs: ``local`` (the eager torch backend, on the card unless the
caller names a device), ``stream`` (the local path split for micro-batched
incremental execution, on the card too) and ``interp`` (the numpy
reference interpreter, on the host).  Each registers a :class:`Target`
declaring

  * its name,
  * the IR flavors its executables accept after lowering,
  * a declarative *lowering path* — an ordered tuple of :class:`Stage`
    factories and strategy :class:`Choice` points (canonicalize →
    optional parallelize → groupby / join / encode / fuse choices),
  * how to construct the backend object, and
  * what kind of source collections its executables consume.

The JAX package's ``spmd``, ``multipod`` and ``pjit`` targets are not
ported: :func:`get_target` raises ``NotImplementedError`` naming
the ROADMAP item that brings each.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from ..core.passes import (
    CommonSubexpressionElimination,
    DeadCodeElimination,
    FuseJoinGroupAgg,
    FuseSelectAgg,
    FuseSelectGroupAgg,
    Parallelize,
)
from ..core.passes.lower_vec import Catalog, LowerRelToVec

__all__ = [
    "CompileOptions", "Stage", "StrategyStage", "Choice", "Target",
    "register_target", "get_target", "available_targets",
    "CANONICALIZE", "PARALLELIZE", "FUSE", "FUSE_CHOICE", "GROUPBY_CHOICE",
    "JOIN_CHOICE", "ENCODE_CHOICE", "DEFAULT_STRATEGY", "TARGETS_LATER",
]

#: the strategy the ``local`` target binds where the caller names none (the
#: JAX package defaults to sorted/sorted: ROADMAP Queue 3 lists the
#: divergence); these are the defaults of the four Choices below
DEFAULT_STRATEGY: Dict[str, str] = {
    "groupby": "direct", "join": "hash", "encode": "raw", "fuse": "fused"}


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CompileOptions:
    """Everything a lowering path may depend on — and the plan-cache key covers."""

    parallel: Optional[int] = None
    use_kernels: bool = True
    catalog: Optional[Catalog] = None
    #: None → fixed default lowering path; "cost" → enumerate the target's
    #: Choice points and pick the cheapest candidate under the cost model
    optimize: Optional[str] = None
    #: explicit strategy overrides ((choice-name, label), ...) — forces
    #: specific variants regardless of the optimizer
    strategy: Optional[Tuple[Tuple[str, str], ...]] = None
    #: resource-admission byte budget for the plan's estimated peak working
    #: set (see ``repro_torch.robust.admission``); None → the
    #: ``REPRO_MEM_BUDGET_BYTES`` environment default (off when unset)
    memory_budget: Optional[int] = None
    #: the device the local backend runs on, as the caller named it
    #: (``cuda`` unless given; resolved at each call)
    device: Optional[str] = None
    #: streaming target only: the source table delivered as micro-batches
    stream_table: Optional[str] = None
    #: streaming target only: micro-batch capacity (rows per batch); the
    #: stream table is lowered at this capacity, so per-batch cost is
    #: O(batch), not O(full table)
    batch_rows: Optional[int] = None

    def stats(self):
        return self.catalog.stats if self.catalog is not None else None

    def cache_key(self) -> Tuple:
        cat = None
        if self.catalog is not None:
            stats = self.catalog.stats
            cat = (tuple(sorted(self.catalog.capacities.items())),
                   self.catalog.default_max_groups,
                   self.catalog.join_selectivity,
                   stats.cache_key() if stats is not None else None)
        return (self.parallel, self.use_kernels, cat, self.optimize, self.strategy,
                self.memory_budget, self.stream_table, self.batch_rows)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Stage:
    """One named step of a lowering path: options → a sequence of passes.

    A "pass" here is anything with ``.name`` and ``.apply(program)``.
    Returning ``[]`` makes the stage a no-op for these options.
    """

    name: str
    build: Callable[[CompileOptions], Sequence[Any]]


@dataclass(frozen=True)
class StrategyStage(Stage):
    """A Stage whose passes depend on the WHOLE bound strategy: ``build``
    receives ``(opts, chosen)``, so several Choices (``groupby``, ``join``,
    ``encode``) parameterize one shared pass (:class:`LowerRelToVec`)."""

    build: Callable[[CompileOptions, Dict[str, str]], Sequence[Any]]


def _canonicalize(opts: CompileOptions) -> Sequence[Any]:
    return [CommonSubexpressionElimination(), DeadCodeElimination()]


def _parallelize(opts: CompileOptions) -> Sequence[Any]:
    if opts.parallel and opts.parallel > 1:
        return [Parallelize(n=opts.parallel)]
    return []


def _fuse(opts: CompileOptions) -> Sequence[Any]:
    return [FuseSelectAgg(), FuseSelectGroupAgg(), FuseJoinGroupAgg(), DeadCodeElimination()]


CANONICALIZE = Stage("canonicalize", _canonicalize)
PARALLELIZE = Stage("parallelize", _parallelize)
FUSE = Stage("fuse", _fuse)


# ---------------------------------------------------------------------------
# strategy choices
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Choice:
    """A strategy point in a lowering path: named alternative Stage variants.

    Under the default compile the ``default`` variant runs; under
    ``optimize="cost"`` the driver enumerates every available variant,
    costs the resulting candidate plans, and picks the cheapest.  An
    ``available`` predicate can narrow the variants for given options.
    """

    name: str
    variants: Tuple[Tuple[str, Stage], ...]
    default: str
    available: Optional[Callable[[CompileOptions], Tuple[str, ...]]] = None

    def labels(self, opts: CompileOptions) -> Tuple[str, ...]:
        if self.available is not None:
            return tuple(self.available(opts))
        return tuple(label for label, _ in self.variants)

    def variant(self, label: str) -> Stage:
        for l, stage in self.variants:
            if l == label:
                return stage
        raise KeyError(
            f"choice {self.name!r} has no variant {label!r}; "
            f"known: {[l for l, _ in self.variants]}")


def _effective_catalog(opts: CompileOptions) -> Catalog:
    """The catalog the vec lowering sees.

    For streaming compiles the stream table's capacity (and its observed
    row count, when statistics are present) is rebound to the micro-batch
    capacity: the per-batch segment of the split plan must size its
    intermediates — and be costed — at O(batch), not O(full table)."""
    cat = opts.catalog if opts.catalog is not None else Catalog()
    if opts.stream_table is None:
        return cat
    rows = int(opts.batch_rows or 256)
    caps = dict(cat.capacities)
    caps[opts.stream_table] = rows
    stats = cat.stats
    if stats is not None:
        stats = stats.with_observed_rows({opts.stream_table: rows})
    return replace(cat, capacities=caps, stats=stats)


def _lower_rel_to_vec_chosen(opts: CompileOptions,
                             chosen: Dict[str, str]) -> Sequence[Any]:
    return [LowerRelToVec(_effective_catalog(opts),
                          groupby=chosen.get("groupby", "sorted"),
                          join=chosen.get("join", "sorted"),
                          encode=chosen.get("encode", "raw"))]


#: the one lowering stage the physical-operator Choices parameterize
LOWER_REL_TO_VEC_STRATEGY = StrategyStage("lower-rel-to-vec", _lower_rel_to_vec_chosen)


def _with_stats(*labels: str) -> Callable[[CompileOptions], Tuple[str, ...]]:
    """Every label when the catalog carries statistics, else the first."""
    return lambda opts: labels if opts.stats() is not None else labels[:1]


#: grouped aggregation tier: SortByKey + GroupAggSorted (always valid) vs
#: the sort-free dense-bucket GroupAggDirect (needs key-domain bounds).
#: The variants are listed in the JAX package's order, so the costed search
#: enumerates the same candidates in the same order.
GROUPBY_CHOICE = Choice(
    name="groupby",
    variants=(("sorted", LOWER_REL_TO_VEC_STRATEGY),
              ("direct", LOWER_REL_TO_VEC_STRATEGY)),
    default=DEFAULT_STRATEGY["groupby"],
    available=_with_stats("sorted", "direct"),
)

_JOIN_TIER = Stage("join-strategy", lambda opts: [])

#: physical join tier: SortByKey(build) + MergeJoinSorted vs the direct
#: table vec.HashJoinDirect; a no-op Stage whose label LowerRelToVec reads
JOIN_CHOICE = Choice(
    name="join",
    variants=(("sorted", _JOIN_TIER), ("hash", _JOIN_TIER)),
    default=DEFAULT_STRATEGY["join"],
    available=_with_stats("sorted", "hash"),
)

_ENCODE_TIER = Stage("encode-strategy", lambda opts: [])

#: key encoding for the direct operators: raw domains, or dictionary ranks
#: (vec.DictEncode/DictDecode) where raw domains are missing or too wide
ENCODE_CHOICE = Choice(
    name="encode",
    variants=(("raw", _ENCODE_TIER), ("dict", _ENCODE_TIER)),
    default=DEFAULT_STRATEGY["encode"],
    available=_with_stats("raw", "dict"),
)

_NO_FUSE = Stage("no-fuse", lambda opts: [])

#: fuse vs no-fuse: the fused operators are single CUDA kernel launches
FUSE_CHOICE = Choice(
    name="fuse",
    variants=(("fused", FUSE), ("unfused", _NO_FUSE)),
    default=DEFAULT_STRATEGY["fuse"],
)


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Target:
    """A registered backend: lowering path + backend factory + data model."""

    name: str
    flavors: Tuple[str, ...]
    lowering_path: Tuple[Any, ...]  # Stage | Choice
    make_backend: Callable[[CompileOptions], Any]
    source_kind: str = "vec"  # "vec" (VecTable sources) | "numpy" (raw columns)
    #: the backend executes micro-batched incremental plans: compiles
    #: require ``stream_table=`` and lower the stream scan at batch capacity
    streaming: bool = False

    def choices(self) -> Tuple[Choice, ...]:
        return tuple(s for s in self.lowering_path if isinstance(s, Choice))


_TARGETS: Dict[str, Target] = {}

#: the JAX package's other targets, and the ROADMAP item that brings each
TARGETS_LATER = {
    "spmd": "ROADMAP Queue 1 item 7: SPMD and multipod",
    "multipod": "ROADMAP Queue 1 item 7: SPMD and multipod",
    "pjit": "ROADMAP Queue 1 item 8: the LM substrate's training",
}


def register_target(target: Target, overwrite: bool = False) -> Target:
    if target.name in _TARGETS and not overwrite:
        raise ValueError(f"target {target.name!r} already registered")
    _TARGETS[target.name] = target
    return target


def get_target(name: str) -> Target:
    try:
        return _TARGETS[name]
    except KeyError:
        if name in TARGETS_LATER:
            raise NotImplementedError(f"target {name!r} is not ported to torch yet "
                                      f"({TARGETS_LATER[name]})") from None
        raise KeyError(
            f"unknown compile target {name!r}; registered: {sorted(_TARGETS)}"
        ) from None


def available_targets() -> Dict[str, Target]:
    return dict(sorted(_TARGETS.items()))


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------


def _make_interp(opts: CompileOptions) -> Any:
    from ..backends.interp import InterpBackend
    return InterpBackend()


def _make_local(opts: CompileOptions) -> Any:
    from ..backends.local import LocalBackend
    return LocalBackend(use_kernels=opts.use_kernels, device=opts.device)


register_target(Target(
    name="interp",
    flavors=("rel", "cf", "df", "la"),
    lowering_path=(CANONICALIZE, PARALLELIZE),
    make_backend=_make_interp,
    source_kind="numpy",
))

register_target(Target(
    name="local",
    flavors=("vec", "cf", "rel", "df", "la"),
    lowering_path=(CANONICALIZE, PARALLELIZE, GROUPBY_CHOICE, JOIN_CHOICE,
                   ENCODE_CHOICE, FUSE_CHOICE),
    make_backend=_make_local,
    source_kind="vec",
))


def _make_stream(opts: CompileOptions) -> Any:
    from ..backends.stream import StreamBackend
    return StreamBackend(opts)


# The streaming target shares the local lowering path (same physical-tier
# Choices, the port's defaults among them — the carried state *is* a
# GroupAggDirect/GroupAggSorted accumulator), then StreamBackend splits the
# lowered program into static / per-batch / merge / finalize segments
# (core/passes/lower_stream) for checkpointed incremental execution.  No
# Parallelize stage: the micro-batch is the unit of work.
register_target(Target(
    name="stream",
    flavors=("vec", "cf", "rel", "df", "la"),
    lowering_path=(CANONICALIZE, GROUPBY_CHOICE, JOIN_CHOICE,
                   ENCODE_CHOICE, FUSE_CHOICE),
    make_backend=_make_stream,
    source_kind="vec",
    streaming=True,
))
