"""Wrappers around the CUDA kernels.

Each wrapper takes the operator's inputs (``VecTable``\\ s and the
instruction's parameters, or the ``la`` flavor's tensors) and returns what
the operator returns.  Inputs on the CPU go to the plain version in
``ref``; inputs on a CUDA device go to the kernel, and a launch that fails
raises.  Outputs and scratch are allocated here with ``torch.empty``; the
kernels allocate nothing and never synchronise.

``fused_select_agg``, ``grouped_select_agg`` and ``grouped_join_agg`` run
kernels generated per query (``codegen``), built at their first use
(``build.build_generated``) and cached here per query.  The epilogue
keeps the JAX package's contract (``repro/kernels/ops.py``): the kernels'
±3e38 sentinels for empty min/max map back to ±inf, the count comes
first, bucket ids decode back to key values, and the result is compacted
to ``max_groups``.  There is no lane padding and no bucket
limit: the relational kernels accumulate with atomics instead of a one-hot.

``LAUNCHES`` counts, per kernel, the calls that launched it,
``KMEANS_LAUNCHES`` and ``SEGSUM_LAUNCHES`` the ``kmeans_step`` and
``segsum`` calls per route and ``GEN_LAUNCHES`` the generated kernels'
calls per route.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.expr import AggSpec, Expr
from ..errors import DeviceMismatchError, KernelBuildError, KernelLaunchError, card_fault
from ..relational import runtime as rt
from . import codegen, exprcode, ref

LAUNCHES: Dict[str, int] = {"fused_select_agg": 0, "grouped_select_agg": 0,
                            "grouped_join_agg": 0, "kmeans_step": 0, "segsum": 0,
                            "flash_attention": 0}

_SENTINEL = 3.0e38


#: the generated kernels' routes: fused_select_agg's one, and
#: grouped_select_agg's and grouped_join_agg's by shape (``gsa_gen_route``,
#: ``gja_gen_route``: accumulators in registers, in shared memory, in
#: global memory)
GEN_ROUTES = ("fsa_gen", "gsa_reg", "gsa_smem", "gsa_global", "gja_reg", "gja_smem", "gja_global")
#: calls that launched each route's kernel
GEN_LAUNCHES: Dict[str, int] = {r: 0 for r in GEN_ROUTES}


def reset_launches() -> None:
    for counts in (LAUNCHES, KMEANS_LAUNCHES, SEGSUM_LAUNCHES, GEN_LAUNCHES):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# checks and launch plumbing
# ---------------------------------------------------------------------------


def _on_card(*tables: Any) -> bool:
    """True for CUDA tables or tensors, False for CPU ones; raises on a mix
    or on any other device."""
    devs = {t.device for t in tables}
    if len(devs) != 1:
        raise DeviceMismatchError(
            f"kernel inputs lie on several devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must lie on the CPU or a CUDA device, not {dev}")
    return True


def _check(t: torch.Tensor, rows: int, what: str, device: torch.device) -> None:
    if t.device != device:
        raise DeviceMismatchError(f"{what} lies on {t.device}, expected {device}")
    if t.dim() != 1 or t.shape[0] != rows:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected ({rows},)")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")
    exprcode.column_type(t.dtype)  # raises on other dtypes


def _columns(table: rt.VecTable, names: Sequence[str], what: str) -> List[torch.Tensor]:
    cols = [table.cols[n] for n in names]
    for n, c in zip(names, cols):
        _check(c, table.capacity, f"{what} column {n!r}", table.device)
    if table.valid.dtype != torch.bool:
        raise ValueError(f"{what} validity must be bool, not {table.valid.dtype}")
    _check(table.valid, table.capacity, f"{what} validity", table.device)
    return cols


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"{name} kernel launch failed: CUDA error {err}")


def _from_sentinel(x: torch.Tensor) -> torch.Tensor:
    inf = torch.full_like(x, float("inf"))
    return torch.where(x >= _SENTINEL, inf, torch.where(x <= -_SENTINEL, -inf, x))


def _value_aggs(aggs: Sequence[AggSpec]) -> List[AggSpec]:
    return [a for a in aggs if a.fn != "count"]


def _grouped_epilogue(cnt: torch.Tensor, acc: torch.Tensor, keys: Sequence[str],
                      key_dtypes: Sequence[torch.dtype], aggs: Sequence[AggSpec],
                      max_groups: int, key_domains: Sequence[Tuple[int, int]],
                      num_buckets: int, index: Optional[Sequence[int]] = None) -> rt.VecTable:
    """Keys decoded from the bucket ids, the count, each value aggregate's
    row of ``acc`` (row ``index[k]`` for the k-th, where given), compacted
    to ``max_groups``."""
    out = rt.decode_bucket_keys(keys, key_domains, key_dtypes, num_buckets, cnt.device)
    k = 0
    for a in aggs:
        if a.fn == "count":
            out[a.name] = cnt
        else:
            out[a.name] = _from_sentinel(acc[k if index is None else index[k]])
            k += 1
    return rt.compact(rt.VecTable(out, cnt > 0), max_groups)


def _grouped_buffers(n_acc: int, nb: int, device: torch.device):
    cnt = torch.empty(nb, dtype=torch.int32, device=device)
    acc = torch.empty((max(n_acc, 1), nb), dtype=torch.float32, device=device)
    return cnt, acc


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


class _Generated(NamedTuple):
    """One query's generated kernel: its entry point, its scratch size as
    a function of the rows, its route (and grouped_join_agg's build)."""

    launch: Any
    scratch_bytes: Any
    route: str
    build: Any = None


class _Query(NamedTuple):
    """What a wrapper needs of one query, found once: the columns it reads
    (sorted; grouped_join_agg's probe columns, then its build columns and
    the build side's key columns, as ``join`` lays them out), its distinct
    (aggregate, expression) values, each value aggregate's index among
    them, and its kernels per column types."""

    names: Tuple[str, ...]
    values: Tuple[Tuple[str, Expr], ...]
    index: List[int]
    kernels: Dict[Tuple[str, ...], _Generated]
    join: Optional[codegen.Join] = None


#: per (family, predicate, value aggregates, keys, key domains)
_QUERIES: Dict[tuple, _Query] = {}
#: per (device, stream): the generated kernels' zeroed tickets (each launch
#: leaves them zeroed) and their scratch (launches on one stream run in
#: turn, so they share both)
_GEN_STREAM: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _query(family: str, pred: Optional[Expr], aggs: Tuple[AggSpec, ...],
           keys: Tuple[str, ...] = (), domains: tuple = ()) -> _Query:
    """The query's columns and values, looked up by the query (one hash of
    its expressions a call)."""
    key = (family, pred, tuple((a.fn, a.expr) for a in aggs if a.fn != "count"), keys, domains)
    q = _QUERIES.get(key)
    if q is None:
        values, index = _distinct_values(_value_aggs(aggs))
        fields = set(pred.fields()) if pred is not None else set()
        names = tuple(sorted(fields | set(keys) | {f for _, e in values for f in e.fields()}))
        q = _QUERIES[key] = _Query(names, values, index, {})
    return q


def _generated(family: str, pred: Optional[Expr], q: _Query, types: Tuple[str, ...],
               keys: Tuple[str, ...] = (), domains: tuple = ()) -> _Generated:
    """The kernel generated for query ``q`` over columns of the types
    ``types`` (i, f or b), built at its first use and then cached (a
    repeated call neither regenerates nor rehashes the text)."""
    gen = q.kernels.get(types)
    if gen is None:
        with card_fault(KernelBuildError, f"generating the {family} kernel"):
            from .build import build_generated

            slots: Dict[str, int] = {}
            for j, n in enumerate(q.names):  # a name on both sides of a join: the probe's
                slots.setdefault(n, j)
            prog = exprcode.compile_program(pred, [e for _, e in q.values],
                                            {n: types[j] for n, j in slots.items()}, slots,
                                            max_stack=None)
            key_slots = None
            if family != "fused_select_agg":
                key_slots = [(slots[k], int(lo), int(hi) - int(lo) + 1)
                             for k, (lo, hi) in zip(keys, domains)]
            text = codegen.kernel_source(family, prog, types, [fn for fn, _ in q.values],
                                         key_slots, q.join)
            lib = build_generated(family, text)
            if family == "fused_select_agg":
                gen = _Generated(lib.fsa_gen_launch, lib.fsa_gen_scratch_bytes, "fsa_gen")
            elif family == "grouped_select_agg":
                gen = _Generated(lib.gsa_gen_launch, lib.gsa_gen_scratch_bytes,
                                 GEN_ROUTES[1 + lib.gsa_gen_route()])
            else:
                gen = _Generated(lib.gja_gen_launch, lib.gja_gen_scratch_bytes,
                                 GEN_ROUTES[4 + lib.gja_gen_route()], lib.gja_gen_build)
        q.kernels[types] = gen
    return gen


def _gen_workspace(device: torch.device, stream: int, nbytes: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ticket, scratch of at least ``nbytes``) for launches on ``stream``."""
    key = (device.index, stream)
    ticket, scratch = _GEN_STREAM.get(key, (None, None))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
    if scratch is None or scratch.numel() < nbytes:
        scratch = torch.empty(max(nbytes, 16), dtype=torch.uint8, device=device)
    _GEN_STREAM[key] = (ticket, scratch)
    return ticket, scratch


def _distinct_values(vaggs: Sequence[AggSpec]) -> Tuple[Tuple[Tuple[str, Expr], ...], List[int]]:
    """The distinct (aggregate, expression) pairs of the value aggregates,
    and for each aggregate its pair's index (Q1 sums l_quantity twice)."""
    pairs: List[Tuple[str, Expr]] = []
    index = []
    for a in vaggs:
        pair = (a.fn, a.expr)
        if pair not in pairs:
            pairs.append(pair)
        index.append(pairs.index(pair))
    return tuple(pairs), index


def _pointers(cols: Sequence[torch.Tensor]) -> np.ndarray:
    return np.array([c.data_ptr() for c in cols] or [0], np.uint64)


def fused_select_agg(table: rt.VecTable, pred: Expr,
                     aggs: Sequence[AggSpec]) -> Dict[str, torch.Tensor]:
    """VecTable → Single⟨aggs⟩ ({name: 0-dim tensor}) in one pass."""
    aggs = tuple(aggs)
    if not _on_card(table):
        return ref.fused_select_agg(table, pred, aggs)
    dev = table.device
    q = _query("fused_select_agg", pred, aggs)
    cols = _columns(table, q.names, "fused_select_agg")
    gen = _generated("fused_select_agg", pred, q,
                     tuple(exprcode.column_type(c.dtype) for c in cols))
    stream = _stream(dev)
    ticket, scratch = _gen_workspace(dev, stream, gen.scratch_bytes(table.capacity))
    # the count, then the values (the kernel maps the ±3e38 sentinels to ±inf)
    out = torch.empty(1 + max(len(q.values), 1), dtype=torch.int32, device=dev)
    ptrs = _pointers(cols)
    err = gen.launch(ptrs.ctypes.data, table.valid.data_ptr(), table.capacity,
                     scratch.data_ptr(), ticket.data_ptr(), out.data_ptr(),
                     out.data_ptr() + 4, stream)
    _raise_on(err, "fused_select_agg")
    LAUNCHES["fused_select_agg"] += 1
    GEN_LAUNCHES[gen.route] += 1
    vals = out[1:].view(torch.float32)
    res, k = {}, 0
    for a in aggs:
        if a.fn == "count":
            res[a.name] = out[0]
        else:
            res[a.name] = vals[q.index[k]]
            k += 1
    return res


def grouped_select_agg(table: rt.VecTable, pred: Optional[Expr], keys: Sequence[str],
                       aggs: Sequence[AggSpec], max_groups: int,
                       key_domains: Sequence[Tuple[int, int]],
                       num_buckets: int) -> rt.VecTable:
    """VecTable → Vec⟨keys+aggs⟩: fused predicate + dense-bucket grouped
    aggregation (``vec.GroupAggDirect`` under ``use_kernels``)."""
    keys, aggs = tuple(keys), tuple(aggs)
    key_domains = tuple((int(lo), int(hi)) for lo, hi in key_domains)
    if not _on_card(table):
        return ref.grouped_select_agg(table, pred, keys, aggs, max_groups,
                                      key_domains, num_buckets)
    nb = int(num_buckets)
    cnt, acc, index = _grouped_select_launch(table, pred, keys, aggs, key_domains, nb)
    return _grouped_epilogue(cnt, acc, keys, [table.cols[k].dtype for k in keys], aggs,
                             max_groups, key_domains, nb, index)


def _grouped_select_launch(table: rt.VecTable, pred: Optional[Expr], keys: Tuple[str, ...],
                           aggs: Tuple[AggSpec, ...], key_domains: tuple, nb: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """grouped_select_agg up to its epilogue: the query's generated kernel
    launched over ``table`` → (counts (nb,), values (distinct values, nb),
    each value aggregate's row of the values)."""
    dev = table.device
    q = _query("grouped_select_agg", pred, aggs, keys, key_domains)
    cols = _columns(table, q.names, "grouped_select_agg")
    if nb != math.prod(hi - lo + 1 for lo, hi in key_domains):
        raise ValueError(f"grouped_select_agg: {nb} buckets for key domains {key_domains}")
    gen = _generated("grouped_select_agg", pred, q,
                     tuple(exprcode.column_type(c.dtype) for c in cols), keys, key_domains)
    stream = _stream(dev)
    ticket, scratch = _gen_workspace(dev, stream, gen.scratch_bytes(table.capacity))
    cnt, acc = _grouped_buffers(len(q.values), nb, dev)
    ptrs = _pointers(cols)
    err = gen.launch(ptrs.ctypes.data, table.valid.data_ptr(), table.capacity,
                     scratch.data_ptr(), ticket.data_ptr(), cnt.data_ptr(), acc.data_ptr(),
                     stream)
    _raise_on(err, "grouped_select_agg")
    LAUNCHES["grouped_select_agg"] += 1
    GEN_LAUNCHES[gen.route] += 1
    return cnt, acc, q.index


def grouped_join_agg(left: rt.VecTable, right: rt.VecTable, *, left_on: Sequence[str],
                     right_on: Sequence[str],
                     join_key_domains: Sequence[Tuple[int, int]],
                     join_num_buckets: int, keys: Sequence[str],
                     aggs: Sequence[AggSpec], max_groups: int,
                     key_domains: Sequence[Tuple[int, int]],
                     num_buckets: int, pred: Optional[Expr] = None) -> rt.VecTable:
    """(probe VecTable, build VecTable) → Vec⟨keys+aggs⟩ in one pass over
    the probe side (``vec.FusedJoinGroupAgg`` under ``use_kernels``)."""
    kw = dict(left_on=tuple(left_on), right_on=tuple(right_on),
              join_key_domains=tuple((int(lo), int(hi)) for lo, hi in join_key_domains),
              join_num_buckets=int(join_num_buckets), keys=tuple(keys),
              aggs=tuple(aggs), max_groups=int(max_groups),
              key_domains=tuple((int(lo), int(hi)) for lo, hi in key_domains),
              num_buckets=int(num_buckets), pred=pred)
    if not _on_card(left, right):
        return ref.grouped_join_agg(left, right, **kw)
    call = _join_call(left, right, pred, kw["left_on"], kw["right_on"], kw["join_key_domains"],
                      kw["join_num_buckets"], kw["keys"], kw["aggs"], kw["key_domains"],
                      kw["num_buckets"])
    _join_build(call)
    cnt, acc = _join_probe(call)
    key_dtypes = [left.cols[k].dtype if k in left.cols else right.cols[k].dtype
                  for k in kw["keys"]]
    return _grouped_epilogue(cnt, acc, kw["keys"], key_dtypes, kw["aggs"], kw["max_groups"],
                             kw["key_domains"], kw["num_buckets"], call.index)


class _JoinCall(NamedTuple):
    """One grouped_join_agg call up to its launches: the query's generated
    kernel, its column pointers (probe, build, build keys), the tables, the
    stream's workspace (the first-row table, then the route's partials)."""

    gen: _Generated
    ptrs: np.ndarray
    left: rt.VecTable
    right: rt.VecTable
    ticket: torch.Tensor
    scratch: torch.Tensor
    stream: int
    n_values: int
    num_buckets: int
    index: List[int]


def _join_query(left: rt.VecTable, right: rt.VecTable, pred: Optional[Expr],
                aggs: Tuple[AggSpec, ...], left_on: Tuple[str, ...], right_on: Tuple[str, ...],
                join_domains: tuple, keys: Tuple[str, ...], domains: tuple) -> _Query:
    """grouped_join_agg's query, looked up by the query and the two sides'
    column names: the probe columns it reads (the predicate's, the join
    keys, the values' and keys' where the probe has them), the build
    columns (the values' and keys' the probe lacks), then the build keys."""
    key = ("grouped_join_agg", pred, tuple((a.fn, a.expr) for a in aggs if a.fn != "count"),
           keys, domains, left_on, right_on, join_domains, tuple(left.cols), tuple(right.cols))
    q = _QUERIES.get(key)
    if q is None:
        if not len(left_on) == len(right_on) == len(join_domains):
            raise ValueError(f"grouped_join_agg: join keys {left_on} = {right_on} over "
                             f"{len(join_domains)} domains")
        values, index = _distinct_values(_value_aggs(aggs))
        pred_fields = set(pred.fields()) if pred is not None else set()
        if not pred_fields <= set(left.cols):
            raise ValueError("grouped_join_agg: the predicate may read probe columns only")
        need = set(keys) | {f for _, e in values for f in e.fields()}
        lnames = tuple(sorted(pred_fields | set(left_on) | (need & set(left.cols))))
        rnames = tuple(sorted(need - set(left.cols)))
        missing = [f for f in rnames if f not in right.cols or f in right_on]
        if missing:
            raise ValueError(f"grouped_join_agg: {missing} are columns of neither side's "
                             "joined result")
        sizes = [(lo, hi - lo + 1) for lo, hi in join_domains]
        join = codegen.Join(
            len(lnames), len(rnames),
            [(lnames.index(k), lo, size) for k, (lo, size) in zip(left_on, sizes)],
            [(len(lnames) + len(rnames) + i, lo, size) for i, (lo, size) in enumerate(sizes)])
        q = _QUERIES[key] = _Query(lnames + rnames + right_on, values, index, {}, join)
    return q


def _join_call(left: rt.VecTable, right: rt.VecTable, pred: Optional[Expr],
               left_on: Tuple[str, ...], right_on: Tuple[str, ...], join_domains: tuple,
               join_buckets: int, keys: Tuple[str, ...], aggs: Tuple[AggSpec, ...],
               domains: tuple, nb: int) -> _JoinCall:
    """The checks, the query's kernel (generated at its first use) and the
    stream's workspace of one grouped_join_agg call."""
    dev = left.device
    q = _join_query(left, right, pred, aggs, left_on, right_on, join_domains, keys, domains)
    n_probe, n_build = q.join.n_probe, q.join.n_build
    cols = (_columns(left, q.names[:n_probe], "grouped_join_agg probe")
            + _columns(right, q.names[n_probe:], "grouped_join_agg build"))
    if join_buckets != math.prod(hi - lo + 1 for lo, hi in join_domains):
        raise ValueError(f"grouped_join_agg: {join_buckets} join buckets for key domains "
                         f"{join_domains}")
    if nb != math.prod(hi - lo + 1 for lo, hi in domains):
        raise ValueError(f"grouped_join_agg: {nb} buckets for key domains {domains}")
    if right.capacity >= 2 ** 31:
        raise ValueError(f"grouped_join_agg: {right.capacity} build rows; the first-row "
                         "table holds int32")
    gen = _generated("grouped_join_agg", pred, q,
                     tuple(exprcode.column_type(c.dtype) for c in cols), keys, domains)
    stream = _stream(dev)
    ticket, scratch = _gen_workspace(dev, stream, gen.scratch_bytes(left.capacity))
    return _JoinCall(gen, _pointers(cols), left, right, ticket, scratch, stream, len(q.values),
                     nb, q.index)


def _join_build(call: _JoinCall) -> None:
    """grouped_join_agg's build: the first-row table of the build side."""
    err = call.gen.build(call.ptrs.ctypes.data, call.right.valid.data_ptr(), call.right.capacity,
                         call.scratch.data_ptr(), call.stream)
    _raise_on(err, "grouped_join_agg build")


def _join_probe(call: _JoinCall) -> Tuple[torch.Tensor, torch.Tensor]:
    """grouped_join_agg's probe, after its build on the same stream: →
    (counts (nb,), values (distinct values, nb))."""
    cnt, acc = _grouped_buffers(call.n_values, call.num_buckets, call.left.device)
    err = call.gen.launch(call.ptrs.ctypes.data, call.left.valid.data_ptr(), call.left.capacity,
                          call.right.capacity, call.scratch.data_ptr(), call.ticket.data_ptr(),
                          cnt.data_ptr(), acc.data_ptr(), call.stream)
    _raise_on(err, "grouped_join_agg")
    LAUNCHES["grouped_join_agg"] += 1
    GEN_LAUNCHES[call.gen.route] += 1
    return cnt, acc


def _check_matrix(t: torch.Tensor, dtype: torch.dtype, dim: int, what: str) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, not {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{what} must have {dim} dimension(s), not shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


#: the kmeans_step kernels: on the tensor cores (d ≤ 32, k ≤ 64 and
#: roundup(k, 16)·roundup(d, 8) ≤ 512, with the roundings to 16/32/64 and
#: 8/16/32) and on the CUDA cores (every other shape the kernel takes)
KMEANS_ROUTES = ("kms_tc", "kms_main")
#: kmeans_step calls that launched each route's kernel
KMEANS_LAUNCHES: Dict[str, int] = {r: 0 for r in KMEANS_ROUTES}

#: the segsum kernels: on the tensor cores (seg_tc, kms_tc's range) and on
#: the CUDA cores (seg_main, every other shape)
SEGSUM_ROUTES = ("seg_tc", "seg_main")
#: segsum calls that launched each route's kernel
SEGSUM_LAUNCHES: Dict[str, int] = {r: 0 for r in SEGSUM_ROUTES}

#: per (device, stream): the tensor-core kernels' (kms_tc, seg_tc) zeroed
#: tickets, which their finishing blocks take and set back to 0, and the
#: kernels' scratch (launches on one stream run in turn, so they share both)
_TC_STREAM: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
#: the libraries' constants, the routes per shape, the SMs of each card
_CACHED: Dict[Any, Any] = {}


def _cached(key: Any, make: Callable[[], Any]) -> Any:
    if key not in _CACHED:
        _CACHED[key] = make()
    return _CACHED[key]


def kmeans_step_route(d: int, k: int) -> str:
    """The kernel ``kmeans_step`` launches for points of width ``d`` and
    ``k`` centroids on the card (``kms_route`` in ``kmeans_step.cu``)."""
    from .build import library

    return _cached(("kms_route", d, k), lambda: KMEANS_ROUTES[
        0 if library("kmeans_step").kms_route(d, k) else 1])


def onehot_tiling(n: int, d: int, k: int, device: torch.device) -> ref.KmsTiling:
    """How the tensor-core kernels (``kms_tc``, ``seg_tc``; both built from
    ``csrc/onehot.cuh``) cut ``n`` points of width ``d`` with ``k`` labels
    on the card ``device``: the order of their sums, which
    ``ref.kmeans_step_tiled`` and ``ref.segsum_tiled`` follow
    (``kms_tc_grid`` in ``kmeans_step.cu``, for that card's SMs)."""
    from .build import constant, library

    lib = library("kmeans_step")
    tile, warps, group = _cached(("onehot_tiling", d), lambda: (
        lib.kms_tc_tile_points(d), constant("kmeans_step", "kms_tc_warps"),
        constant("kmeans_step", "kms_tc_group")))
    return ref.KmsTiling(tile, warps, lib.kms_tc_grid(n, d, k, _sms(device)), group)


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _cached(("sms", index),
                   lambda: torch.cuda.get_device_properties(index).multi_processor_count)


def _tc_workspace(device: torch.device, stream: int, tickets: int, nbytes: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(at least ``tickets`` zeroed tickets, scratch of at least ``nbytes``)
    for launches on ``stream``."""
    key = (device.index, stream)
    held, scratch = _TC_STREAM.get(key, (None, None))
    if held is None or held.numel() < tickets:
        held = torch.zeros(tickets, dtype=torch.int32, device=device)
    if scratch is None or scratch.numel() < nbytes:
        scratch = torch.empty(max(nbytes, 16), dtype=torch.uint8, device=device)
    _TC_STREAM[key] = (held, scratch)
    return held, scratch


def kmeans_step(x: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points (n, d) f32 and centroids (k, d) f32 → (sums (k, d) f32,
    counts (k,) f32) over each point's nearest centroid (``la.KMeansStep``
    under ``use_kernels``).  On the card the shape picks the kernel
    (``kmeans_step_route``); the tensor-core one's arithmetic is
    ``ref.kmeans_step_tiled``, and its sums are the same on every run."""
    if not _on_card(x, c):
        return ref.kmeans_step(x, c)
    from .build import constant, entry, library

    _check_matrix(x, torch.float32, 2, "kmeans_step points")
    _check_matrix(c, torch.float32, 2, "kmeans_step centroids")
    (n, d), k = x.shape, c.shape[0]
    if c.shape[1] != d:
        raise ValueError(f"kmeans_step: points of width {d}, centroids of width {c.shape[1]}")
    max_d = _cached("max_d", lambda: constant("kmeans_step", "kms_max_d"))
    if not (1 <= d <= max_d) or k < 1:
        raise ValueError(f"kmeans_step takes 1 ≤ d ≤ {max_d} and k ≥ 1, not d={d}, k={k}")
    route = kmeans_step_route(d, k)
    grid = onehot_tiling(n, d, k, x.device).grid if route == "kms_tc" else 0
    stream = _stream(x.device)
    tickets, scratch = _tc_workspace(
        x.device, stream, _cached("kms_tickets", lambda: constant("kmeans_step", "kms_tickets")),
        library("kmeans_step").kms_scratch_bytes(grid, d, k))
    out = torch.empty(k * d + k, dtype=torch.float32, device=x.device)  # sums, then counts
    err = entry("kmeans_step")(x.data_ptr(), c.data_ptr(), n, d, k, out.data_ptr(),
                               out.data_ptr() + 4 * k * d, scratch.data_ptr(),
                               tickets.data_ptr(), grid, stream)
    if err == _cached("err_table", lambda: constant("kmeans_step", "kms_err_table")):
        raise ValueError(f"kmeans_step: {k} centroids of width {d} do not fit in the "
                         "card's opt-in shared memory per block")
    _raise_on(err, "kmeans_step")
    LAUNCHES["kmeans_step"] += 1
    KMEANS_LAUNCHES[route] += 1
    return out[:k * d].view(k, d), out[k * d:]


def segsum_route(d: int, k: int) -> str:
    """The kernel ``segsum`` launches for rows of width ``d`` and ``k``
    segments on the card (``seg_route`` in ``segsum.cu``)."""
    from .build import library

    return _cached(("seg_route", d, k), lambda: SEGSUM_ROUTES[
        0 if library("segsum").seg_route(d, k) else 1])


def segsum(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(n, d) f32 rows summed by segment id (n,) int32 → (num_segments, d)
    f32; ids outside [0, num_segments) are dropped.  On the card the shape
    picks the kernel (``segsum_route``); the tensor-core one's arithmetic
    is ``ref.segsum_tiled``, and its sums are the same on every run."""
    if not _on_card(data, seg_ids):
        return ref.segsum(data, seg_ids, num_segments)
    from .build import constant, entry, library

    _check_matrix(data, torch.float32, 2, "segsum data")
    _check_matrix(seg_ids, torch.int32, 1, "segsum ids")
    n, d = data.shape
    if seg_ids.shape[0] != n:
        raise ValueError(f"segsum: {seg_ids.shape[0]} ids for {n} rows")
    if d < 1 or num_segments < 1:
        raise ValueError(f"segsum takes d ≥ 1 and num_segments ≥ 1, not {d}, {num_segments}")
    route = segsum_route(d, num_segments)
    grid = onehot_tiling(n, d, num_segments, data.device).grid if route == "seg_tc" else 0
    stream = _stream(data.device)
    tickets, scratch = _tc_workspace(
        data.device, stream, _cached("seg_tickets", lambda: constant("segsum", "seg_tickets")),
        library("segsum").seg_scratch_bytes(grid, d, num_segments))
    out = torch.empty((num_segments, d), dtype=torch.float32, device=data.device)
    err = entry("segsum")(data.data_ptr(), seg_ids.data_ptr(), n, d, num_segments,
                          out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), grid, stream)
    _raise_on(err, "segsum")
    LAUNCHES["segsum"] += 1
    SEGSUM_LAUNCHES[route] += 1
    return out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


#: the head widths both flash_attention kernels are built for (``fa_launch``
#: in ``csrc/flash_attention.cu`` refuses any other)
FA_HEAD_DIMS = (32, 64, 112, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal or sliding-window GQA attention, forward only: q (B, Hq, S,
    D), k, v (B, Hkv, S, D), f32 or bf16 → (B, Hq, S, D) in q's dtype
    (``attention(mode="pallas")``).  Any S ≥ 1; D ∈ ``FA_HEAD_DIMS`` (112
    is Zamba2-7B's shared attention: the tensor-core kernel runs it in its
    D = 128 tile, zero-filled by TMA).  On the card bf16 runs on the tensor
    cores (its arithmetic is ``ref.flash_attention_tiled``), f32 on the
    CUDA cores.  The kernel has no backward, as the JAX kernel has none:
    under grad mode with q, k or v requiring grad it raises on every
    device, rather than return an output that carries no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention is forward-only, as the JAX kernel is (no "
                         "backward): train with attn_mode=\"chunked\", or call it "
                         "under torch.no_grad() / torch.inference_mode()")
    if not _on_card(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
    from .build import constant, entry

    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes f32 or bf16, not {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_matrix(t, q.dtype, 4, f"flash_attention {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name} is not 16-byte aligned")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    group = hq // hkv if hkv else 0
    if hkv < 1 or hq % hkv or not 1 <= group <= constant("flash_attention", "fa_max_group"):
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} kv heads")
    if d not in FA_HEAD_DIMS or s < 1:
        raise ValueError(f"flash_attention takes D in {FA_HEAD_DIMS} and S ≥ 1, not D={d}, "
                         f"S={s}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    err = entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, s, d,
        int(q.dtype == torch.bfloat16), int(causal), -1 if window is None else int(window),
        scale, _stream(q.device))
    _raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def _attention_block(qf: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                     m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, k0: int,
                     causal: bool, window: Optional[int]):
    """One kv block of ``chunked_attention``'s online softmax: (m, l, acc)
    after the keys ``ks`` and values ``vs`` that start at position ``k0``."""
    s = qf.shape[-2]
    s_blk = torch.matmul(qf, ks.float()[:, :, None].transpose(-1, -2))  # (b, hkv, g, s, bk)
    qpos = torch.arange(s, device=qf.device)
    kpos = torch.arange(k0, k0 + vs.shape[2], device=qf.device)
    mask = torch.ones((s, kpos.shape[0]), dtype=torch.bool, device=qf.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s_blk = s_blk.masked_fill(~mask, ref.NEG)
    m_new = torch.maximum(m, s_blk.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s_blk - m_new[..., None])
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.matmul(p.to(vs.dtype).float(),
                                                    vs.float()[:, :, None])
    return m_new, l_new, acc_new


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      sm_scale: Optional[float] = None, block_k: int = 512,
                      policy: str = "remat") -> torch.Tensor:
    """The JAX package's default attention in plain torch: an online
    softmax over kv blocks of ``block_k`` (the last may be shorter).
    Products take the inputs as they are (q scaled in its own dtype) and
    accumulate in f32, the weights go to v's dtype before the second
    product, and m, l and acc stay f32.  Differentiable by autograd; with
    ``policy="remat"`` (JAX's default) each block runs under
    ``torch.utils.checkpoint`` when a gradient is being recorded, so the
    backward recomputes the block's logits and keeps O(S·D), not O(S²).

    Where the key length differs from the query length S (cross-attention)
    the blocks are JAX's, which it takes from S: S // bk blocks of bk =
    min(block_k, S) keys, block i from ``min(i·bk, S_k − bk)`` (the clamp of
    ``dynamic_slice``) at key positions i·bk onwards in the mask.  So only
    the first S keys are seen, and a decode step (S = 1) sees key 0 alone
    (a kept quirk, ROADMAP Queue 3 item 30).  Raises ``ValueError`` where
    JAX fails: bk > S_k, or S not a multiple of bk."""
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, hkv, group, s, d).float()
    m = torch.full((b, hkv, group, s), ref.NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, group, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, group, s, d), dtype=torch.float32, device=q.device)
    remat = (policy == "remat" and torch.is_grad_enabled()
             and any(t.requires_grad for t in (q, k, v)))
    if sk == s:  # (slice start, first key position): every key, block by block
        width, blocks = block_k, [(k0, k0) for k0 in range(0, s, min(block_k, s))]
    else:
        width = min(block_k, s)
        if width > sk or s % width:
            raise ValueError(f"chunked_attention: {s} queries over {sk} keys take blocks of "
                             f"{width} keys, which JAX's cannot cut")
        blocks = [(min(i * width, sk - width), i * width) for i in range(s // width)]
    for c, k0 in blocks:
        blk = (qf, k[:, :, c:c + width], v[:, :, c:c + width], m, l, acc, k0, causal, window)
        if remat:
            m, l, acc = checkpoint(_attention_block, *blk, use_reentrant=False)
        else:
            m, l, acc = _attention_block(*blk)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).reshape(b, hq, s, d).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              sm_scale: Optional[float] = None,
              mode: Union[str, Callable] = "chunked") -> torch.Tensor:
    """``mode="pallas"``: the kernel (contiguous copies of q, k and v where
    they are views); ``"chunked"``: ``chunked_attention``; a function: that
    function, called as the kernel is (a caller's own attention, such as an
    f64 yardstick); anything else: the plain ``ref.flash_attention``."""
    if callable(mode):
        return mode(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
    if mode == "pallas":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                               window=window, sm_scale=sm_scale)
    if mode == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
    return ref.flash_attention(q, k, v, causal=causal, window=window, sm_scale=sm_scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor], *,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """One-token decode attention: the plain version (the JAX package has
    no kernel for it either)."""
    return ref.decode_attention(q, k_cache, v_cache, cache_len, sm_scale=sm_scale)
