"""Backend target registry: declarative, flavor-aware lowering paths.

The port's copy of ``repro/compiler/targets.py``, with all of its
targets: ``local`` (the eager torch backend, on the card unless the
caller names a device), ``stream`` (the local path split for micro-batched
incremental execution, on the card too), ``spmd`` and ``multipod`` (the
local path lowered to the mesh flavor, each rank of a
``torch.distributed`` mesh running it on its chunk), ``interp`` (the
numpy reference interpreter, on the host) and ``pjit`` (the tensor
frontend's train step: its plan, and with a model-bound
``frontends.tensor.PjitBackend`` the step itself, on one device).  Each
registers a
:class:`Target` declaring

  * its name,
  * the IR flavors its executables accept after lowering,
  * a declarative *lowering path* — an ordered tuple of :class:`Stage`
    factories and strategy :class:`Choice` points (canonicalize →
    optional parallelize → groupby / join / encode / fuse choices),
  * how to construct the backend object, and
  * what kind of source collections its executables consume.

A target of the JAX package listed in ``TARGETS_LATER`` would make
:func:`get_target` raise ``NotImplementedError`` naming the ROADMAP item
that brings it; none is left.
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
    LowerToMesh,
    Parallelize,
    PushCombineIntoMesh,
    PushGroupedCombineIntoMesh,
)
from ..core.passes.lower_vec import Catalog, LowerRelToVec

__all__ = [
    "CompileOptions", "Stage", "StrategyStage", "Choice", "Target",
    "register_target", "get_target", "available_targets",
    "CANONICALIZE", "PARALLELIZE", "FUSE", "LOWER_TO_MESH", "FUSE_CHOICE",
    "GROUPED_RECOMBINE", "GROUPBY_CHOICE", "JOIN_CHOICE", "ENCODE_CHOICE",
    "DEFAULT_STRATEGY", "TARGETS_LATER",
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
    #: the mesh axis the spmd targets lower ``cf.ConcurrentExecute`` onto
    axis: str = "workers"
    #: spmd targets: pull combines into the mesh body as collectives
    collectives: bool = True
    catalog: Optional[Catalog] = None
    #: spmd targets: the ``launch.mesh.Mesh`` of ranks the plan runs on
    mesh: Any = None
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
    #: the registers the parallelization rewrite seeds (None → every
    #: absorbable source); the tensor frontend splits only the batch
    parallelize_targets: Optional[Tuple[str, ...]] = None

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
        # the mesh's ranks, backend and device are part of the plan: an
        # equally shaped mesh over other ranks must not reuse it
        mesh_key = self.mesh.key() if self.mesh is not None else None
        return (self.parallel, self.use_kernels, self.axis, self.collectives, cat,
                mesh_key, self.optimize, self.strategy, self.memory_budget,
                self.stream_table, self.batch_rows, self.parallelize_targets)


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
        targets = set(opts.parallelize_targets) if opts.parallelize_targets else None
        return [Parallelize(n=opts.parallel, targets=targets)]
    return []


def _fuse(opts: CompileOptions) -> Sequence[Any]:
    return [FuseSelectAgg(), FuseSelectGroupAgg(), FuseJoinGroupAgg(), DeadCodeElimination()]


def _lower_to_mesh(opts: CompileOptions) -> Sequence[Any]:
    rules: list = [LowerToMesh(opts.axis)]
    if opts.collectives:
        rules.append(PushCombineIntoMesh())
    return rules


CANONICALIZE = Stage("canonicalize", _canonicalize)
PARALLELIZE = Stage("parallelize", _parallelize)
FUSE = Stage("fuse", _fuse)
LOWER_TO_MESH = Stage("lower-to-mesh", _lower_to_mesh)


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

_GROUPED_GATHER = Stage("grouped-gather", lambda opts: [])
_GROUPED_EXCHANGE = Stage(
    "grouped-exchange", lambda opts: [PushGroupedCombineIntoMesh()])

#: grouped recombine after a MeshExecute: gather-then-aggregate (cheap at
#: low group cardinality) vs mesh.ExchangeByKey + per-rank aggregation
#: (wins when the partial-aggregate gather would swamp one rank)
GROUPED_RECOMBINE = Choice(
    name="grouped-recombine",
    variants=(("gather", _GROUPED_GATHER), ("exchange", _GROUPED_EXCHANGE)),
    default="gather",
    available=lambda opts: (("gather", "exchange") if opts.collectives
                            else ("gather",)),
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
    #: the backend runs on a mesh of ranks (``CompileOptions.mesh``)
    needs_mesh: bool = False
    #: the backend executes micro-batched incremental plans: compiles
    #: require ``stream_table=`` and lower the stream scan at batch capacity
    streaming: bool = False

    def choices(self) -> Tuple[Choice, ...]:
        return tuple(s for s in self.lowering_path if isinstance(s, Choice))


_TARGETS: Dict[str, Target] = {}

#: the JAX package's other targets, and the ROADMAP item that brings each
TARGETS_LATER: Dict[str, str] = {}


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


def _make_spmd(opts: CompileOptions) -> Any:
    from ..backends.spmd import SpmdBackend
    # the driver built the mesh (from ``parallel`` where none was given);
    # rewrite=False: it also ran LowerToMesh/PushCombineIntoMesh as
    # registered pipeline stages
    return SpmdBackend(opts.mesh, axis=opts.axis, use_kernels=opts.use_kernels,
                       collectives=opts.collectives, rewrite=False)


# The SPMD (Modularis-analogue) target: the local lowering path — its
# Choices at the port's defaults — then the mesh rules; every rank of the
# mesh runs the plan on its chunk.
register_target(Target(
    name="spmd",
    flavors=("vec", "cf", "rel", "la", "mesh"),
    lowering_path=(CANONICALIZE, PARALLELIZE, GROUPBY_CHOICE, JOIN_CHOICE,
                   ENCODE_CHOICE, FUSE_CHOICE, LOWER_TO_MESH, GROUPED_RECOMBINE),
    make_backend=_make_spmd,
    source_kind="vec",
    needs_mesh=True,
))

# The multipod (Lambada-analogue) target shares the SPMD lowering path; the
# elastic facade (ElasticExecutor) re-enters the driver per worker count and
# relies on the structural plan cache instead of its own plan table.
register_target(Target(
    name="multipod",
    flavors=("vec", "cf", "rel", "la", "mesh"),
    lowering_path=(CANONICALIZE, PARALLELIZE, GROUPBY_CHOICE, JOIN_CHOICE,
                   ENCODE_CHOICE, FUSE_CHOICE, LOWER_TO_MESH, GROUPED_RECOMBINE),
    make_backend=_make_spmd,
    source_kind="vec",
    needs_mesh=True,
))


# The tensor frontend's pjit binding, as a registered target: the LM
# trainer's planning rewrite (Alg. 1 → Alg. 2) is the parallelize stage of
# an ordinary lowering path, and ``compile(plan, target="pjit")`` yields a
# plan-summary executable; ``lower_to_pjit`` passes a model-bound
# ``PjitBackend`` via ``backend=`` to get a runnable train step.

def _tensor_parallelize(opts: CompileOptions) -> Sequence[Any]:
    targets = set(opts.parallelize_targets) if opts.parallelize_targets else None
    return [Parallelize(n=opts.parallel or 1, targets=targets)]


TENSOR_PARALLELIZE = Stage("parallelize", _tensor_parallelize)


def _make_pjit(opts: CompileOptions) -> Any:
    from ..frontends.tensor import PjitBackend
    return PjitBackend()  # plan-only unless a model binding is supplied


register_target(Target(
    name="pjit",
    flavors=("tz", "cf", "mesh"),
    lowering_path=(CANONICALIZE, TENSOR_PARALLELIZE),
    make_backend=_make_pjit,
    source_kind="numpy",
))
