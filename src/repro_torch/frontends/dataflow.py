"""Generic Python dataflow frontend.

The user-facing collection API shared by all backends (paper Fig. 1: one
Python frontend, three platforms).  ``Frame`` is an immutable logical plan
node; ``.program()`` translates the plan into a ``rel.*`` CVM program ("this
initial translation should be as thin as possible"), and ``Context.execute``
drives the rewriting pipeline.

This package's copy of ``repro.frontends.dataflow``: ``Context.compile``,
``execute`` and ``sources`` route to the torch port's compiler, local
backend and ``VecTable``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core import Builder, Program, verify
from ..core.expr import AggSpec, Col, Expr, col, const
from ..core.types import BAG, Atom, Bag, CollectionType, TupleType

_ids = itertools.count()


@dataclass(frozen=True)
class _Node:
    op: str
    params: Tuple[Tuple[str, Any], ...]
    children: Tuple["_Node", ...]
    uid: int = field(default_factory=lambda: next(_ids))


# -- aggregation helpers -----------------------------------------------------


@dataclass(frozen=True)
class AggExpr:
    fn: str
    expr: Expr
    name: Optional[str] = None

    def as_(self, name: str) -> "AggExpr":
        return AggExpr(self.fn, self.expr, name)


def sum_(e: Expr | str) -> AggExpr:
    return AggExpr("sum", col(e) if isinstance(e, str) else e)


def count_() -> AggExpr:
    return AggExpr("count", const(1))


def min_(e: Expr | str) -> AggExpr:
    return AggExpr("min", col(e) if isinstance(e, str) else e)


def max_(e: Expr | str) -> AggExpr:
    return AggExpr("max", col(e) if isinstance(e, str) else e)


def avg_(e: Expr | str) -> AggExpr:
    return AggExpr("avg", col(e) if isinstance(e, str) else e)


class Frame:
    """An immutable logical collection (lazy)."""

    def __init__(self, ctx: "Context", node: _Node, schema: TupleType) -> None:
        self._ctx = ctx
        self._node = node
        self.schema = schema

    # -- transformations ----------------------------------------------------
    def filter(self, pred: Expr) -> "Frame":
        return Frame(self._ctx, _Node("rel.Select", (("pred", pred),), (self._node,)),
                     self.schema)

    def select(self, *names: str) -> "Frame":
        return Frame(self._ctx, _Node("rel.Proj", (("names", tuple(names)),), (self._node,)),
                     self.schema.project(names))

    def with_columns(self, **exprs: Expr) -> "Frame":
        all_exprs = tuple((n, col(n)) for n in self.schema.names if n not in exprs)
        all_exprs += tuple(exprs.items())
        fields = tuple((n, e.infer(self.schema)) for n, e in all_exprs)
        return Frame(self._ctx, _Node("rel.ExProj", (("exprs", all_exprs),), (self._node,)),
                     TupleType(fields))

    def project(self, **exprs: Expr) -> "Frame":
        items = tuple(exprs.items())
        fields = tuple((n, e.infer(self.schema)) for n, e in items)
        return Frame(self._ctx, _Node("rel.ExProj", (("exprs", items),), (self._node,)),
                     TupleType(fields))

    def join(self, other: "Frame", left_on: str | Sequence[str],
             right_on: str | Sequence[str]) -> "Frame":
        from ..core.ops.relational import join_schema

        lo = (left_on,) if isinstance(left_on, str) else tuple(left_on)
        ro = (right_on,) if isinstance(right_on, str) else tuple(right_on)
        schema = join_schema(self.schema, other.schema, lo, ro)
        return Frame(
            self._ctx,
            _Node("rel.Join", (("left_on", lo), ("right_on", ro)),
                  (self._node, other._node)),
            schema,
        )

    def order_by(self, *keys: str, ascending: Optional[Sequence[bool]] = None) -> "Frame":
        asc = tuple(ascending or (True,) * len(keys))
        return Frame(self._ctx,
                     _Node("rel.OrderBy", (("keys", tuple(keys)), ("ascending", asc)),
                           (self._node,)),
                     self.schema)

    def limit(self, k: int) -> "Frame":
        return Frame(self._ctx, _Node("rel.Limit", (("k", k),), (self._node,)), self.schema)

    # -- aggregations ---------------------------------------------------------
    def _desugar(self, aggs: Sequence[AggExpr]) -> Tuple[Tuple[AggSpec, ...],
                                                         Optional[Tuple[Tuple[str, Expr], ...]]]:
        """avg → sum/count + a finalize ExProj; returns (specs, finalize)."""
        specs: List[AggSpec] = []
        finalize: List[Tuple[str, Expr]] = []
        needs_finalize = False
        for a in aggs:
            name = a.name or f"{a.fn}_{next(_ids)}"
            if a.fn == "avg":
                needs_finalize = True
                s, c = f"__{name}_sum", f"__{name}_cnt"
                specs.append(AggSpec("sum", a.expr, s))
                specs.append(AggSpec("count", a.expr, c))
                finalize.append((name, col(s) / col(c)))
            else:
                specs.append(AggSpec(a.fn, a.expr, name))
                finalize.append((name, col(name)))
        return tuple(specs), (tuple(finalize) if needs_finalize else None)

    def agg(self, *aggs: AggExpr) -> "Frame":
        specs, finalize = self._desugar(aggs)
        node = _Node("rel.Aggr", (("aggs", specs),), (self._node,))
        schema = TupleType(tuple((s.name, s.result_atom(self.schema)) for s in specs))
        out = Frame(self._ctx, node, schema)
        if finalize:
            fields = tuple((n, e.infer(schema)) for n, e in finalize)
            out = Frame(self._ctx, _Node("rel.ExProj", (("exprs", finalize),), (node,)),
                        TupleType(fields))
        return out

    def group_by(self, *keys: str, max_groups: Optional[int] = None) -> "GroupBy":
        return GroupBy(self, keys, max_groups)

    # -- plumbing -------------------------------------------------------------
    def program(self, name: str = "query") -> Program:
        b = Builder(name)
        memo: Dict[int, Any] = {}

        def build(node: _Node):
            if node.uid in memo:
                return memo[node.uid]
            child_regs = [build(c) for c in node.children]
            outs = b.emit(node.op, child_regs, dict(node.params))
            memo[node.uid] = outs[0]
            return outs[0]

        result = build(self._node)
        p = b.finish(result)
        verify(p)
        return p

    def collect(self, parallel: Optional[int] = None, use_kernels: bool = True,
                optimize: Optional[str] = None, strategy: Any = None,
                device: Any = None, cache: Any = None, target: str = "local",
                store: Any = None, memory_budget: Optional[int] = None,
                guard: bool = True, mesh: Any = None,
                collectives: bool = True) -> Dict[str, np.ndarray]:
        """Compile (through the plan cache) and run on ``device`` (``cuda``
        unless given; ``"cpu"`` runs the kernels' plain versions).
        Defaults: ``use_kernels=True`` and the strategy ``groupby=direct,
        join=hash, encode=raw, fuse=fused`` (the JAX package defaults to
        the sorted tiers and no kernels); ``parallel=n`` splits the tables
        into ``n`` chunks; ``optimize="cost"`` picks the strategy by cost.
        ``target="interp"`` runs the numpy interpreter on the host;
        ``target="spmd"`` (or ``"multipod"``) runs on every rank of ``mesh``
        (by default ``parallel`` ranks of the default process group), each
        rank calling ``collect`` alike and receiving the whole answer."""
        return self._ctx.execute(self, parallel=parallel, use_kernels=use_kernels,
                                 optimize=optimize, strategy=strategy,
                                 device=device, cache=cache, target=target,
                                 store=store, memory_budget=memory_budget,
                                 guard=guard, mesh=mesh, collectives=collectives)


class GroupBy:
    def __init__(self, frame: Frame, keys: Sequence[str], max_groups: Optional[int]) -> None:
        self.frame = frame
        self.keys = tuple(keys)
        self.max_groups = max_groups

    def agg(self, *aggs: AggExpr) -> Frame:
        specs, finalize = self.frame._desugar(aggs)
        params: Tuple[Tuple[str, Any], ...] = (("keys", self.keys), ("aggs", specs))
        if self.max_groups:
            params += (("max_groups", self.max_groups),)
        node = _Node("rel.GroupByAggr", params, (self.frame._node,))
        fields = tuple((k, self.frame.schema.field(k)) for k in self.keys)
        fields += tuple((s.name, s.result_atom(self.frame.schema)) for s in specs)
        schema = TupleType(fields)
        out = Frame(self.frame._ctx, node, schema)
        if finalize:
            keep = tuple((k, col(k)) for k in self.keys)
            exprs = keep + finalize
            f2 = tuple((n, e.infer(schema)) for n, e in exprs)
            out = Frame(self.frame._ctx, _Node("rel.ExProj", (("exprs", exprs),), (node,)),
                        TupleType(f2))
        return out


class Context:
    """Holds named tables (numpy columns) and drives compilation.

    ``pad_to`` rounds physical capacities up so worker counts divide them.
    """

    def __init__(self, pad_to: int = 256) -> None:
        self.tables: Dict[str, Dict[str, np.ndarray]] = {}
        self.schemas: Dict[str, TupleType] = {}
        self.pad_to = pad_to
        self._stats = None  # lazily computed Statistics; reset on register
        self._sources: Dict[str, Any] = {}  # device → VecTables; reset on register

    # -- catalog ---------------------------------------------------------------
    def register(self, name: str, data: Mapping[str, np.ndarray],
                 schema: Optional[TupleType] = None) -> None:
        data = {k: np.asarray(v) for k, v in data.items()}
        # object arrays of python strings (pandas-style) → native unicode
        data = {k: v.astype(str) if v.dtype.kind == "O" else v
                for k, v in data.items()}
        if schema is None:
            schema = TupleType(tuple((k, _infer_atom(v)) for k, v in data.items()))
        self.tables[name] = data
        self.schemas[name] = schema
        self._stats = None
        self._sources = {}

    def table(self, name: str) -> Frame:
        schema = self.schemas[name]
        node = _Node("rel.Scan", (("table", name), ("schema", schema), ("kind", BAG)), ())
        return Frame(self, node, schema)

    # -- compilation -------------------------------------------------------------
    def capacity(self, name: str) -> int:
        n = len(next(iter(self.tables[name].values())))
        p = self.pad_to
        return max(p, ((n + p - 1) // p) * p)

    def _has_strings(self) -> bool:
        return any(np.asarray(v).dtype.kind in ("U", "S")
                   for cols in self.tables.values() for v in cols.values())

    def statistics(self):
        """Exact table statistics from the registered columns (cached).

        These feed the driver's cost-based plan selection via
        ``Catalog.stats`` → ``CompileOptions``.  When any registered column
        holds strings, a session-global string :class:`Dictionary` is built
        over the union of all string values: physical string columns are
        its i32 rank codes (globally consistent, so cross-table joins and
        order-by compare correctly on codes), and per-column dictionaries
        are expressed in that code space.
        """
        if self._stats is None:
            from ..compiler.stats import (Dictionary, Statistics,
                                          stats_from_columns)

            svals: set = set()
            for cols in self.tables.values():
                for v in cols.values():
                    a = np.asarray(v)
                    if a.dtype.kind in ("U", "S"):
                        svals.update(str(x) for x in np.unique(a))
            gd = Dictionary.make(sorted(svals)) if svals else None
            self._stats = Statistics.make(
                {name: stats_from_columns(cols, gd)
                 for name, cols in self.tables.items()}, gd)
        return self._stats

    def catalog(self, with_stats: bool = True):
        """The lowering catalog; ``with_stats=False`` skips the (memoized
        but O(n log n) per column) exact-statistics computation for compiles
        that will never consult them."""
        from ..core.passes.lower_vec import Catalog
        return Catalog(capacities={t: self.capacity(t) for t in self.tables},
                       stats=self.statistics() if with_stats else None)

    def compile(self, frame: Frame, parallel: Optional[int] = None,
                use_kernels: bool = True, optimize: Optional[str] = None,
                strategy: Any = None, device: Any = None, cache: Any = None,
                target: str = "local", store: Any = None,
                memory_budget: Optional[int] = None, guard: bool = True,
                stream_table: Optional[str] = None,
                batch_rows: Optional[int] = None, mesh: Any = None,
                collectives: bool = True):
        """Lower ``frame`` through this package's driver and its plan cache
        (``cache``: ``None`` the process-wide one, ``False`` none, or a
        ``PlanCache``); ``optimize``, ``store``, ``memory_budget``,
        ``guard``, for ``target="stream"`` ``stream_table`` and
        ``batch_rows``, and for ``target="spmd"``/``"multipod"`` ``mesh`` and
        ``collectives`` as ``repro_torch.compiler.compile`` takes them.

        Defaults: strategy ``groupby=direct, join=hash, encode=raw,
        fuse=fused``, sequential unless ``parallel`` > 1,
        ``use_kernels=True`` (the CUDA kernels on a card, their plain
        versions on CPU tensors) and ``device`` ``cuda``.  The direct tiers
        and dictionary encoding need the statistics, so the catalog always
        carries them."""
        from ..compiler import compile as cvm_compile

        return cvm_compile(frame.program(), catalog=self.catalog(), target=target,
                           use_kernels=use_kernels, parallel=parallel,
                           optimize=optimize, strategy=strategy, device=device,
                           cache=cache, store=store, memory_budget=memory_budget,
                           guard=guard, stream_table=stream_table, batch_rows=batch_rows,
                           mesh=mesh, collectives=collectives)

    def _physical_columns(self, name: str) -> Dict[str, np.ndarray]:
        """Columns in their physical dtypes: string columns become i32
        global-dictionary rank codes (the documented str→i32 adaptation —
        rank order is lexicographic order, so comparisons, sorts, and
        joins on codes agree with the same operations on the strings)."""
        data = self.tables[name]
        if not any(np.asarray(v).dtype.kind in ("U", "S")
                   for v in data.values()):
            return data
        gd = self.statistics().global_dict
        gvals = np.asarray(gd.values)
        out = {}
        for k, v in data.items():
            a = np.asarray(v)
            out[k] = (np.searchsorted(gvals, a).astype(np.int32)
                      if a.dtype.kind in ("U", "S") else a)
        return out

    def sources(self, device: Any = None) -> Dict[str, Any]:
        """Every registered table as a torch ``VecTable`` on ``device``
        (``cuda`` unless given).  Kept per device until the next
        ``register``: a session holds its tables on the card."""
        from ..convert import sources_from_context
        from ..relational.runtime import resolve_device

        dev = str(resolve_device(device))
        if dev not in self._sources:
            self._sources[dev] = sources_from_context(self, dev)
        return self._sources[dev]

    def execute(self, frame: Frame, parallel: Optional[int] = None,
                use_kernels: bool = True, optimize: Optional[str] = None,
                strategy: Any = None, device: Any = None,
                cache: Any = None, target: str = "local", store: Any = None,
                memory_budget: Optional[int] = None,
                guard: bool = True, stream_table: Optional[str] = None,
                batch_rows: Optional[int] = None, mesh: Any = None,
                collectives: bool = True) -> Dict[str, np.ndarray]:
        from ..compiler import get_target

        compiled = self.compile(frame, parallel=parallel, use_kernels=use_kernels,
                                optimize=optimize, strategy=strategy, device=device,
                                cache=cache, target=target, store=store,
                                memory_budget=memory_budget, guard=guard,
                                stream_table=stream_table, batch_rows=batch_rows,
                                mesh=mesh, collectives=collectives)
        tgt = get_target(target)
        if tgt.source_kind == "numpy":
            src = self.tables
        elif tgt.needs_mesh:
            # this rank's device (cuda:LOCAL_RANK on a host of several cards)
            from ..launch.mesh import resolve_rank_device

            src = self.sources(mesh.device if mesh is not None
                               else resolve_rank_device(device))
        else:
            src = self.sources(device)
        (out,) = compiled(src)
        return self._decode_output(frame, _to_numpy(out))

    def _decode_output(self, frame: Frame,
                       out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Decode i32 global-code columns back to strings at the session
        boundary.  Schema-driven: a column the frame types as ``str`` whose
        physical array is integral came out of the vec pipeline as codes;
        the interp target returns the raw strings already (non-integer
        dtype) and is left alone."""
        if not self._has_strings():
            return out
        gd = self.statistics().global_dict
        gvals = np.asarray(gd.values)
        schema = frame.schema
        names = set(schema.names)
        for k, arr in list(out.items()):
            if (k in names
                    and getattr(schema.field(k), "domain", None) == "str"
                    and np.issubdtype(np.asarray(arr).dtype, np.integer)):
                out[k] = gvals[np.clip(np.asarray(arr), 0, len(gvals) - 1)]
        return out


def _infer_atom(v: np.ndarray) -> Atom:
    from ..core.types import BOOL, F32, F64, I32, I64, STR

    if v.dtype.kind in ("U", "S"):
        return STR
    if v.dtype == np.bool_:
        return BOOL
    if v.dtype in (np.int8, np.int16, np.int32):
        return I32
    if v.dtype == np.int64:
        return I64
    if v.dtype == np.float32:
        return F32
    if v.dtype == np.float64:
        return F64
    raise TypeError(f"unsupported column dtype {v.dtype}")


def _to_numpy(out: Any) -> Dict[str, np.ndarray]:
    from ..relational.runtime import VecTable

    if isinstance(out, VecTable):
        return out.to_numpy()
    if isinstance(out, dict):
        return {k: _host(v) for k, v in out.items()}
    return {"result": _host(out)}


def _host(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
