"""Wrappers around the CUDA kernels.

Each wrapper takes the operator's inputs (``VecTable``\\ s and the
instruction's parameters, or the ``la`` flavor's tensors) and returns what
the operator returns.  Inputs on the CPU go to the plain version in
``ref``; inputs on a CUDA device go to the kernel, and a launch that fails
raises.  Outputs and scratch are allocated here with ``torch.empty``; the
kernels allocate nothing and never synchronise.

The epilogue keeps the JAX package's contract (``repro/kernels/ops.py``):
the kernels' ±3e38 sentinels for empty min/max map back to ±inf, the
count comes first, bucket ids decode back to key values, and the result
is compacted to ``max_groups``.  There is no lane padding and no bucket
limit: the relational kernels accumulate with atomics instead of a one-hot.

``LAUNCHES`` counts, per kernel, the calls that launched it, and
``KMEANS_LAUNCHES`` the ``kmeans_step`` calls per route.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.expr import AggSpec, Expr
from ..relational import runtime as rt
from . import exprcode, ref

LAUNCHES: Dict[str, int] = {"fused_select_agg": 0, "grouped_select_agg": 0,
                            "grouped_join_agg": 0, "kmeans_step": 0, "segsum": 0,
                            "flash_attention": 0}

_FN = {"sum": 0, "min": 1, "max": 2}
_SENTINEL = 3.0e38

_PROGRAMS: Dict[tuple, Tuple[exprcode.ExprProgram, torch.Tensor]] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in KMEANS_LAUNCHES:
        KMEANS_LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# checks and launch plumbing
# ---------------------------------------------------------------------------


def _on_card(*tables: Any) -> bool:
    """True for CUDA tables or tensors, False for CPU ones; raises on a mix
    or on any other device."""
    devs = {t.device for t in tables}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must lie on the CPU or a CUDA device, not {dev}")
    return True


def _check(t: torch.Tensor, rows: int, what: str, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} lies on {t.device}, expected {device}")
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


def _program(pred: Optional[Expr], values: Tuple[Expr, ...], names: Tuple[str, ...],
             types: Tuple[str, ...], device: torch.device
             ) -> Tuple[exprcode.ExprProgram, torch.Tensor]:
    """The lowered program and its copy on ``device`` (cached per query)."""
    key = (pred, values, names, types, str(device))
    if key not in _PROGRAMS:
        prog = exprcode.compile_program(pred, values, dict(zip(names, types)),
                                        {n: j for j, n in enumerate(names)})
        _PROGRAMS[key] = (prog, torch.from_numpy(prog.code.copy()).to(device))
    return _PROGRAMS[key]


class _Cols:
    """Host arrays describing the kernel's column slots."""

    def __init__(self, cols: Sequence[torch.Tensor], src: Sequence[int]) -> None:
        if len(cols) > 32:
            raise ValueError(f"{len(cols)} columns; the kernels take at most 32")
        self.ptrs = np.array([c.data_ptr() for c in cols] or [0], np.uint64)
        self.types = np.array([exprcode.COL_TYPES[exprcode.column_type(c.dtype)]
                               for c in cols] or [0], np.int32)
        self.src = np.array(list(src) or [0], np.int32)
        self.n = len(cols)
        self.vm_types = tuple(exprcode.column_type(c.dtype) for c in cols)


def _keys(slots: Sequence[int], domains: Sequence[Tuple[int, int]]):
    if len(slots) > 8:
        raise ValueError(f"{len(slots)} key columns; the kernels take at most 8")
    lo = np.array([int(a) for a, _ in domains] or [0], np.int64)
    size = np.array([int(b) - int(a) + 1 for a, b in domains] or [1], np.int64)
    return np.array(list(slots) or [0], np.int32), lo, size


def _fns(aggs: Sequence[AggSpec]) -> np.ndarray:
    return np.array([_FN[a.fn] for a in aggs] or [0], np.int32)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _from_sentinel(x: torch.Tensor) -> torch.Tensor:
    inf = torch.full_like(x, float("inf"))
    return torch.where(x >= _SENTINEL, inf, torch.where(x <= -_SENTINEL, -inf, x))


def _value_aggs(aggs: Sequence[AggSpec]) -> List[AggSpec]:
    return [a for a in aggs if a.fn != "count"]


def _grouped_epilogue(cnt: torch.Tensor, acc: torch.Tensor, keys: Sequence[str],
                      key_dtypes: Sequence[torch.dtype], aggs: Sequence[AggSpec],
                      max_groups: int, key_domains: Sequence[Tuple[int, int]],
                      num_buckets: int) -> rt.VecTable:
    out = rt.decode_bucket_keys(keys, key_domains, key_dtypes, num_buckets, cnt.device)
    k = 0
    for a in aggs:
        if a.fn == "count":
            out[a.name] = cnt
        else:
            out[a.name] = _from_sentinel(acc[k])
            k += 1
    return rt.compact(rt.VecTable(out, cnt > 0), max_groups)


def _grouped_buffers(n_acc: int, nb: int, device: torch.device):
    cnt = torch.empty(nb, dtype=torch.int32, device=device)
    acc = torch.empty((max(n_acc, 1), nb), dtype=torch.float32, device=device)
    return cnt, acc


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def fused_select_agg(table: rt.VecTable, pred: Expr,
                     aggs: Sequence[AggSpec]) -> Dict[str, torch.Tensor]:
    """VecTable → Single⟨aggs⟩ ({name: 0-dim tensor}) in one pass."""
    aggs = tuple(aggs)
    if not _on_card(table):
        return ref.fused_select_agg(table, pred, aggs)
    from .build import constant, entry

    dev = table.device
    vaggs = _value_aggs(aggs)
    names = tuple(sorted(set(pred.fields()) | {f for a in vaggs for f in a.expr.fields()}))
    cols = _columns(table, names, "fused_select_agg")
    c = _Cols(cols, [0] * len(cols))
    prog, code = _program(pred, tuple(a.expr for a in vaggs), names, c.vm_types, dev)
    # per-block partials for the most blocks the kernel launches
    max_blocks = (torch.cuda.get_device_properties(dev).multi_processor_count
                  * constant("fused_select_agg", "fsa_blocks_per_sm"))
    n_acc = len(vaggs)
    part_cnt = torch.empty(max_blocks, dtype=torch.int32, device=dev)
    part_acc = torch.empty(max(max_blocks * n_acc, 1), dtype=torch.float32, device=dev)
    out_cnt = torch.empty(1, dtype=torch.int32, device=dev)
    out_acc = torch.empty(max(n_acc, 1), dtype=torch.float32, device=dev)
    fns = _fns(vaggs)
    err = entry("fused_select_agg")(
        code.data_ptr(), prog.n_pred, len(prog.code), c.ptrs.ctypes.data,
        c.types.ctypes.data, c.src.ctypes.data, c.n, table.valid.data_ptr(),
        table.capacity, fns.ctypes.data, n_acc, part_cnt.data_ptr(),
        part_acc.data_ptr(), max_blocks, out_cnt.data_ptr(), out_acc.data_ptr(),
        _stream(dev))
    _raise_on(err, "fused_select_agg")
    LAUNCHES["fused_select_agg"] += 1
    vals = _from_sentinel(out_acc)
    out, k = {}, 0
    for a in aggs:
        if a.fn == "count":
            out[a.name] = out_cnt[0]
        else:
            out[a.name] = vals[k]
            k += 1
    return out


def grouped_select_agg(table: rt.VecTable, pred: Optional[Expr], keys: Sequence[str],
                       aggs: Sequence[AggSpec], max_groups: int,
                       key_domains: Sequence[Tuple[int, int]],
                       num_buckets: int) -> rt.VecTable:
    """VecTable → Vec⟨keys+aggs⟩: fused predicate + dense-bucket grouped
    aggregation (``vec.GroupAggDirect`` under ``use_kernels``)."""
    keys, aggs = tuple(keys), tuple(aggs)
    key_domains = tuple(key_domains)
    if not _on_card(table):
        return ref.grouped_select_agg(table, pred, keys, aggs, max_groups,
                                      key_domains, num_buckets)
    from .build import entry

    dev = table.device
    vaggs = _value_aggs(aggs)
    pred_fields = set(pred.fields()) if pred is not None else set()
    names = tuple(sorted(pred_fields | set(keys)
                         | {f for a in vaggs for f in a.expr.fields()}))
    cols = _columns(table, names, "grouped_select_agg")
    c = _Cols(cols, [0] * len(cols))
    prog, code = _program(pred, tuple(a.expr for a in vaggs), names, c.vm_types, dev)
    slots, lo, size = _keys([names.index(k) for k in keys], key_domains)
    nb = int(num_buckets)
    cnt, acc = _grouped_buffers(len(vaggs), nb, dev)
    fns = _fns(vaggs)
    err = entry("grouped_select_agg")(
        code.data_ptr(), prog.n_pred, len(prog.code), c.ptrs.ctypes.data,
        c.types.ctypes.data, c.src.ctypes.data, c.n, table.valid.data_ptr(),
        table.capacity, slots.ctypes.data, lo.ctypes.data, size.ctypes.data,
        len(keys), fns.ctypes.data, len(vaggs), nb, cnt.data_ptr(), acc.data_ptr(),
        _stream(dev))
    _raise_on(err, "grouped_select_agg")
    LAUNCHES["grouped_select_agg"] += 1
    return _grouped_epilogue(cnt, acc, keys, [table.cols[k].dtype for k in keys], aggs,
                             max_groups, key_domains, nb)


def build_tables(right: rt.VecTable, right_on: Sequence[str], names: Sequence[str],
                 join_key_domains: Sequence[Tuple[int, int]], join_num_buckets: int
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Dense build tables over the join-bucket axis, made in torch outside
    the kernel: a presence table, and each of ``names`` gathered at the
    first build row of each bucket (duplicate keys: first occurrence wins),
    in the column's own dtype."""
    ridx = rt.build_first_index(right, right_on, join_key_domains, join_num_buckets)
    present = ridx < right.capacity
    ridx_c = torch.clamp(ridx, max=right.capacity - 1)
    return present, [right.cols[n][ridx_c] for n in names]


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
              join_key_domains=tuple(join_key_domains),
              join_num_buckets=int(join_num_buckets), keys=tuple(keys),
              aggs=tuple(aggs), max_groups=int(max_groups),
              key_domains=tuple(key_domains), num_buckets=int(num_buckets), pred=pred)
    if not _on_card(left, right):
        return ref.grouped_join_agg(left, right, **kw)
    from .build import entry

    dev = left.device
    keys, aggs = kw["keys"], kw["aggs"]
    vaggs = _value_aggs(aggs)
    agg_fields = {f for a in vaggs for f in a.expr.fields()}
    pred_fields = set(pred.fields()) if pred is not None else set()
    if not pred_fields <= set(left.cols):
        raise ValueError("grouped_join_agg: the predicate may read probe columns only")
    rnames = tuple(sorted((set(keys) | agg_fields) & (set(right.cols) - set(right_on))))
    lnames = tuple(sorted(pred_fields | set(left_on)
                          | ((set(keys) | agg_fields) & set(left.cols))))
    lcols = _columns(left, lnames, "grouped_join_agg probe")
    _columns(right, rnames, "grouped_join_agg build")
    nbj = kw["join_num_buckets"]
    present, tables = build_tables(right, right_on, rnames, kw["join_key_domains"], nbj)
    names = lnames + rnames
    c = _Cols(lcols + tables, [0] * len(lcols) + [1] * len(tables))
    prog, code = _program(pred, tuple(a.expr for a in vaggs), names, c.vm_types, dev)
    jslots, jlo, jsize = _keys([names.index(k) for k in left_on], kw["join_key_domains"])
    gslots, glo, gsize = _keys([names.index(k) for k in keys], kw["key_domains"])
    nb = kw["num_buckets"]
    cnt, acc = _grouped_buffers(len(vaggs), nb, dev)
    fns = _fns(vaggs)
    err = entry("grouped_join_agg")(
        code.data_ptr(), prog.n_pred, len(prog.code), c.ptrs.ctypes.data,
        c.types.ctypes.data, c.src.ctypes.data, c.n, left.valid.data_ptr(),
        left.capacity, jslots.ctypes.data, jlo.ctypes.data, jsize.ctypes.data,
        len(left_on), present.data_ptr(), gslots.ctypes.data, glo.ctypes.data,
        gsize.ctypes.data, len(keys), fns.ctypes.data, len(vaggs), nb,
        cnt.data_ptr(), acc.data_ptr(), _stream(dev))
    _raise_on(err, "grouped_join_agg")
    LAUNCHES["grouped_join_agg"] += 1
    key_dtypes = [left.cols[k].dtype if k in left.cols else right.cols[k].dtype
                  for k in keys]
    return _grouped_epilogue(cnt, acc, keys, key_dtypes, aggs, kw["max_groups"],
                             kw["key_domains"], nb)


def _check_matrix(t: torch.Tensor, dtype: torch.dtype, dim: int, what: str) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, not {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{what} must have {dim} dimension(s), not shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def segsum(data: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(n, d) f32 rows summed by segment id (n,) int32 → (num_segments, d)
    f32; ids outside [0, num_segments) are dropped."""
    if not _on_card(data, seg_ids):
        return ref.segsum(data, seg_ids, num_segments)
    from .build import entry

    _check_matrix(data, torch.float32, 2, "segsum data")
    _check_matrix(seg_ids, torch.int32, 1, "segsum ids")
    n, d = data.shape
    if seg_ids.shape[0] != n:
        raise ValueError(f"segsum: {seg_ids.shape[0]} ids for {n} rows")
    if d < 1 or num_segments < 1:
        raise ValueError(f"segsum takes d ≥ 1 and num_segments ≥ 1, not {d}, {num_segments}")
    out = torch.empty((num_segments, d), dtype=torch.float32, device=data.device)
    err = entry("segsum")(data.data_ptr(), seg_ids.data_ptr(), n, d, num_segments,
                          out.data_ptr(), _stream(data.device))
    _raise_on(err, "segsum")
    LAUNCHES["segsum"] += 1
    return out


#: the kmeans_step kernels: on the tensor cores (d ≤ 32, k ≤ 64 and
#: roundup(k, 16)·roundup(d, 8) ≤ 512, with the roundings to 16/32/64 and
#: 8/16/32) and on the CUDA cores (every other shape the kernel takes)
KMEANS_ROUTES = ("kms_tc", "kms_main")
#: kmeans_step calls that launched each route's kernel
KMEANS_LAUNCHES: Dict[str, int] = {r: 0 for r in KMEANS_ROUTES}

#: per (device, stream): kms_tc's zeroed tickets, which its finishing blocks
#: take and set back to 0, and the kernels' scratch (launches on one stream
#: run in turn, so they share both)
_KMS_STREAM: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
#: kmeans_step's constants, its route per shape, the SMs of each card
_KMS: Dict[Any, Any] = {}


def _kms(key: Any, make: Callable[[], Any]) -> Any:
    if key not in _KMS:
        _KMS[key] = make()
    return _KMS[key]


def kmeans_step_route(d: int, k: int) -> str:
    """The kernel ``kmeans_step`` launches for points of width ``d`` and
    ``k`` centroids on the card (``kms_route`` in ``kmeans_step.cu``)."""
    from .build import library

    return _kms(("route", d, k), lambda: KMEANS_ROUTES[
        0 if library("kmeans_step").kms_route(d, k) else 1])


def kmeans_step_tiling(n: int, d: int, k: int, device: torch.device) -> ref.KmsTiling:
    """How the tensor-core kernel (``kms_tc``) cuts ``n`` points of width
    ``d`` with ``k`` centroids on the card ``device``: the order of its
    sums, which ``ref.kmeans_step_tiled`` follows (``kms_tc_grid`` in
    ``kmeans_step.cu``, for that card's SMs)."""
    from .build import constant, library

    lib = library("kmeans_step")
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = _kms(("sms", index),
               lambda: torch.cuda.get_device_properties(index).multi_processor_count)
    tile, warps, group = _kms(("tiling", d), lambda: (
        lib.kms_tc_tile_points(d), constant("kmeans_step", "kms_tc_warps"),
        constant("kmeans_step", "kms_tc_group")))
    return ref.KmsTiling(tile, warps, lib.kms_tc_grid(n, d, k, sms), group)


def _kms_workspace(device: torch.device, stream: int, nbytes: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tickets, scratch of at least ``nbytes``) for launches on ``stream``."""
    from .build import constant

    key = (device.index, stream)
    tickets, scratch = _KMS_STREAM.get(key, (None, None))
    if tickets is None:
        tickets = torch.zeros(constant("kmeans_step", "kms_tickets"), dtype=torch.int32,
                              device=device)
    if scratch is None or scratch.numel() < nbytes:
        scratch = torch.empty(max(nbytes, 16), dtype=torch.uint8, device=device)
    _KMS_STREAM[key] = (tickets, scratch)
    return tickets, scratch


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
    max_d = _kms("max_d", lambda: constant("kmeans_step", "kms_max_d"))
    if not (1 <= d <= max_d) or k < 1:
        raise ValueError(f"kmeans_step takes 1 ≤ d ≤ {max_d} and k ≥ 1, not d={d}, k={k}")
    route = kmeans_step_route(d, k)
    grid = kmeans_step_tiling(n, d, k, x.device).grid if route == "kms_tc" else 0
    stream = _stream(x.device)
    tickets, scratch = _kms_workspace(
        x.device, stream, library("kmeans_step").kms_scratch_bytes(grid, d, k))
    out = torch.empty(k * d + k, dtype=torch.float32, device=x.device)  # sums, then counts
    err = entry("kmeans_step")(x.data_ptr(), c.data_ptr(), n, d, k, out.data_ptr(),
                               out.data_ptr() + 4 * k * d, scratch.data_ptr(),
                               tickets.data_ptr(), grid, stream)
    if err == _kms("err_table", lambda: constant("kmeans_step", "kms_err_table")):
        raise ValueError(f"kmeans_step: {k} centroids of width {d} do not fit in the "
                         "card's opt-in shared memory per block")
    _raise_on(err, "kmeans_step")
    LAUNCHES["kmeans_step"] += 1
    KMEANS_LAUNCHES[route] += 1
    return out[:k * d].view(k, d), out[k * d:]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal or sliding-window GQA attention, forward only: q (B, Hq, S,
    D), k, v (B, Hkv, S, D), f32 or bf16 → (B, Hq, S, D) in q's dtype
    (``attention(mode="pallas")``).  Any S ≥ 1; D ∈ {32, 64, 128}.  On the
    card bf16 runs on the tensor cores (its arithmetic is
    ``ref.flash_attention_tiled``), f32 on the CUDA cores."""
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
    if d not in (32, 64, 128) or s < 1:
        raise ValueError(f"flash_attention takes D in (32, 64, 128) and S ≥ 1, not D={d}, S={s}")
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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      sm_scale: Optional[float] = None, block_k: int = 512) -> torch.Tensor:
    """The JAX package's default attention in plain torch, forward only:
    an online softmax over kv blocks of ``block_k`` (the last may be
    shorter).  Products take the inputs as they are (q scaled in its own
    dtype) and accumulate in f32, the weights go to v's dtype before the
    second product, and m, l and acc stay f32."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, hkv, group, s, d).float()
    qpos = torch.arange(s, device=q.device)
    m = torch.full((b, hkv, group, s), ref.NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, group, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, group, s, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, s, min(block_k, s)):
        ks = k[:, :, k0:k0 + block_k].float()[:, :, None]          # (b, hkv, 1, bk, d)
        vs = v[:, :, k0:k0 + block_k]
        s_blk = torch.matmul(qf, ks.transpose(-1, -2))              # (b, hkv, g, s, bk)
        kpos = torch.arange(k0, k0 + vs.shape[2], device=q.device)
        mask = torch.ones((s, kpos.shape[0]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s_blk = s_blk.masked_fill(~mask, ref.NEG)
        m_new = torch.maximum(m, s_blk.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s_blk - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p.to(vs.dtype).float(),
                                                    vs.float()[:, :, None])
        m = m_new
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
