"""VecTable: the physical ``Vec⟨tuple⟩`` collection on torch.

A VecTable is a struct-of-arrays block with a static capacity and a
validity mask; cardinality lives in the mask.  The operators below are the
executable meaning of the ``vec.*`` flavor on the path this package runs
(the torch counterpart of ``repro.relational.runtime``).  Semantics kept
from the JAX package:

* x64 is off: 64-bit columns ingest as f32/i32 and ``count`` is int32;
* empty min/max give ±inf;
* sorts are stable and put valid rows first;
* ``compact`` drops rows past ``max_count`` (through a dump slot);
* duplicate build keys resolve to the first occurrence, and probe keys
  outside the declared domain never match.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.expr import AggSpec, Expr, evaluate

_F32_INF = float("inf")

def resolve_device(device: Any = None) -> torch.device:
    """``cuda`` unless the caller names a device; asking for a card that
    is not there raises instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA card by default and none is "
            "visible; pass device='cpu' to run the plain versions on the CPU")
    return dev


def x32(v: Any) -> Any:
    """The x64-off view of a value: 64-bit ints/floats become 32-bit."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.int64:
            return v.to(torch.int32)
        if v.dtype == torch.float64:
            return v.to(torch.float32)
    return v


def _np_x32(v: np.ndarray) -> np.ndarray:
    if v.dtype == np.int64:
        return v.astype(np.int32)
    if v.dtype == np.float64:
        return v.astype(np.float32)
    return v


# ---------------------------------------------------------------------------
# expression evaluation over torch tensors
# ---------------------------------------------------------------------------


def _pair(a: Any, b: Any) -> Tuple[Any, Any]:
    """Lift a Python scalar beside a tensor into a 0-dim tensor, which
    torch's promotion treats as weakly typed (like a JAX Python scalar)."""
    if isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    elif isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, device=b.device)
    return a, b


class _TorchNamespace:
    """The array-module names ``core.expr.evaluate`` calls, on torch."""

    @staticmethod
    def logical_not(a):
        return torch.logical_not(a) if isinstance(a, torch.Tensor) else not a

    @staticmethod
    def abs(a):
        return torch.abs(a) if isinstance(a, torch.Tensor) else abs(a)

    @staticmethod
    def minimum(a, b):
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            return min(a, b)
        return torch.minimum(*_pair(a, b))

    @staticmethod
    def maximum(a, b):
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            return max(a, b)
        return torch.maximum(*_pair(a, b))

    @staticmethod
    def logical_and(a, b):
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            return bool(a) and bool(b)
        return torch.logical_and(*_pair(a, b))

    @staticmethod
    def logical_or(a, b):
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            return bool(a) or bool(b)
        return torch.logical_or(*_pair(a, b))


T = _TorchNamespace()


def eval_expr(e: Expr, cols: Mapping[str, Any]) -> Any:
    """``core.expr.evaluate`` on torch, with the x64-off result types."""
    return x32(evaluate(e, dict(cols), T))


def _full(cap: int, v: Any, device: torch.device) -> torch.Tensor:
    """A Python or 0-dim scalar broadcast to a column, typed as JAX types
    it with x64 off (bool, int32, float32)."""
    if isinstance(v, torch.Tensor):
        return x32(v).expand(cap).contiguous()
    if isinstance(v, (bool, np.bool_)):
        return torch.full((cap,), bool(v), dtype=torch.bool, device=device)
    if isinstance(v, (int, np.integer)):
        return torch.full((cap,), int(v), dtype=torch.int32, device=device)
    return torch.full((cap,), float(v), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------


@dataclass
class VecTable:
    cols: Dict[str, torch.Tensor]
    valid: torch.Tensor  # bool (cap,)

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    @staticmethod
    def from_numpy(data: Mapping[str, np.ndarray], capacity: Optional[int] = None,
                   device: Any = None) -> "VecTable":
        n = len(next(iter(data.values())))
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < rows {n}")
        dev = resolve_device(device)
        cols = {}
        for k, v in data.items():
            v = _np_x32(np.asarray(v))
            out = torch.zeros((cap,) + v.shape[1:], dtype=torch.from_numpy(v[:0]).dtype,
                              device=dev)
            out[:n] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            cols[k] = out
        valid = torch.arange(cap, device=dev) < n
        return VecTable(cols, valid)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        mask = self.valid.cpu().numpy()
        return {k: v.cpu().numpy()[mask] for k, v in self.cols.items()}


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


def mask_select(t: VecTable, pred: Expr) -> VecTable:
    """Predicated (late-materialized) selection: narrow the mask only."""
    p = eval_expr(pred, t.cols)
    if not isinstance(p, torch.Tensor) or p.dim() == 0:
        p = _full(t.capacity, p, t.device)
    return VecTable(t.cols, t.valid & p)


def exproj(t: VecTable, exprs: Sequence[Tuple[str, Expr]]) -> VecTable:
    out = {}
    for name, e in exprs:
        v = eval_expr(e, t.cols)
        if not isinstance(v, torch.Tensor) or v.dim() == 0:
            v = _full(t.capacity, v, t.device)
        out[name] = v
    return VecTable(out, t.valid)


def _as_f32(arr: torch.Tensor) -> torch.Tensor:
    return arr if arr.dtype == torch.float32 else arr.to(torch.float32)


def _masked(fn: str, arr: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    if fn == "count":
        return valid.sum(dtype=torch.int32)
    arr = _as_f32(arr)
    if fn == "sum":
        return torch.where(valid, arr, 0.0).sum()
    if fn == "min":
        return torch.where(valid, arr, _F32_INF).min()
    if fn == "max":
        return torch.where(valid, arr, -_F32_INF).max()
    raise ValueError(fn)


def aggr(t: VecTable, aggs: Sequence[AggSpec]) -> Dict[str, torch.Tensor]:
    """Masked scalar aggregation → Single⟨aggs⟩ (dict of 0-dim tensors)."""
    out = {}
    for a in aggs:
        arr = eval_expr(a.expr, t.cols) if a.fn != "count" else t.valid
        if not isinstance(arr, torch.Tensor) or arr.dim() == 0:
            arr = _full(t.capacity, arr, t.device)
        out[a.name] = _masked(a.fn, arr, t.valid)
    return out


_FOLD = {"sum": lambda v: v.sum(0, dtype=v.dtype), "min": lambda v: v.amin(0),
         "max": lambda v: v.amax(0)}


def combine_partials(partials: Sequence[Dict[str, torch.Tensor]],
                     aggs: Sequence[AggSpec]) -> Dict[str, torch.Tensor]:
    """Fold per-chunk Single⟨aggs⟩ partials with each agg's combine
    function; a sum keeps its partials' dtype (int32 counts stay int32)."""
    return {a.name: _FOLD[a.combine_fn](torch.stack([p[a.name] for p in partials]))
            for a in aggs}


def _sort_perm(t: VecTable, keys: Sequence[str], ascending: Sequence[bool]) -> torch.Tensor:
    """Permutation: valid rows first, ordered by keys (stable).

    torch has no lexsort: chained stable sorts from the least significant
    key to the most significant one (the validity flag) give the same
    order as the JAX package's ``jnp.lexsort``."""
    arrays = []
    for k, asc in zip(reversed(list(keys)), reversed(list(ascending))):
        arr = t.cols[k]
        if arr.dtype == torch.bool:
            arr = (~arr if not asc else arr).to(torch.int32)
        elif not asc:
            arr = -arr if not arr.is_floating_point() else -_as_f32(arr)
        arrays.append(arr)
    arrays.append((~t.valid).to(torch.int32))  # primary: valid first
    perm = torch.arange(t.capacity, device=t.device)
    for arr in arrays:
        order = torch.sort(arr[perm], stable=True).indices
        perm = perm[order]
    return perm


def sort_by_key(t: VecTable, keys: Sequence[str],
                ascending: Optional[Sequence[bool]] = None) -> VecTable:
    asc = list(ascending or [True] * len(keys))
    perm = _sort_perm(t, keys, asc)
    return VecTable({k: v[perm] for k, v in t.cols.items()}, t.valid[perm])


def compact(t: VecTable, max_count: Optional[int] = None) -> VecTable:
    """Densify valid rows to the front — O(n) prefix-sum scatter.

    Each valid row goes to its prefix count of valid rows; rows past
    ``max_count`` and invalid rows go to a dump slot one past the end
    (torch raises on out-of-range indices where JAX drops them)."""
    out_cap = int(max_count) if max_count is not None else t.capacity
    pos = torch.cumsum(t.valid.to(torch.int64), 0) - 1
    idx = torch.where(t.valid, pos, out_cap).clamp_(max=out_cap)
    n = torch.clamp(t.valid.sum(), max=out_cap)

    def scatter(col: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((out_cap + 1,) + col.shape[1:], dtype=col.dtype,
                          device=col.device)
        out[idx] = col
        return out[:out_cap]

    cols = {k: scatter(v) for k, v in t.cols.items()}
    valid = torch.arange(out_cap, device=t.device) < n
    return VecTable(cols, valid)


def _int_key(arr: torch.Tensor) -> torch.Tensor:
    """Key columns as i32: f32 keys bit-cast (as the JAX runtime does)."""
    if arr.dtype == torch.float32:
        return arr.view(torch.int32)
    return arr.to(torch.int32)


#: rows per chunk of a segment sum, and the most chunk partials it keeps
_SUM_CHUNK_ROWS = 1024
_SUM_MAX_PARTIALS = 1 << 24


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """f32 sums of the rows of ``vals`` (``(n,)`` or ``(n, d)``) into
    ``num_segments`` slots, in two levels.

    One accumulator per segment that every row adds into loses about
    n·2^-24 of a sum over n rows (1.5e-4 relative on a 490,000-row Q1
    group at sf=5, on an H100).  So the rows are cut into chunks of ``_SUM_CHUNK_ROWS`` (fewer,
    longer chunks when the chunks × segments partials would pass
    ``_SUM_MAX_PARTIALS``), each chunk sums into partials of its own, and
    torch's reduction adds the partials of each segment."""
    n, rest = vals.shape[0], tuple(vals.shape[1:])
    chunks = max(1, min(-(-n // _SUM_CHUNK_ROWS), _SUM_MAX_PARTIALS // num_segments))
    rows = max(1, -(-n // chunks))
    slot = torch.arange(n, device=vals.device) // rows * num_segments + seg
    part = torch.zeros((chunks * num_segments,) + rest, dtype=vals.dtype, device=vals.device)
    return part.index_add_(0, slot, vals).view((chunks, num_segments) + rest).sum(0)


def _dump_outside(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment ids as int64, those outside [0, num_segments) sent to the
    dump slot ``num_segments``."""
    seg = seg.to(torch.int64)
    return torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)


def segment_sum(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Rows of ``data`` (n, d) summed by segment id (n,) → (num_segments, d);
    ids outside [0, num_segments) are dropped (``jax.ops.segment_sum``'s
    semantics), the sums are f32 in two levels (``_segment_sum``)."""
    dump = _dump_outside(seg, num_segments)
    return _segment_sum(_as_f32(data), dump, num_segments + 1)[:num_segments]


def segment_count(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Occurrences of each segment id (n,) → (num_segments,) f32, counted
    exactly in int32 first; ids outside [0, num_segments) are dropped."""
    dump = _dump_outside(seg, num_segments)
    counts = torch.zeros(num_segments + 1, dtype=torch.int32, device=seg.device)
    counts.index_add_(0, dump, torch.ones_like(dump, dtype=torch.int32))
    return counts[:num_segments].to(torch.float32)


def _segment_agg(a: AggSpec, cols: Mapping[str, torch.Tensor], valid: torch.Tensor,
                 seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """One masked segment reduction into ``num_segments`` dense slots."""
    dev = valid.device
    if a.fn == "count":
        return torch.zeros(num_segments, dtype=torch.int32, device=dev).index_add_(
            0, seg, valid.to(torch.int32))
    arr = eval_expr(a.expr, cols)
    if not isinstance(arr, torch.Tensor) or arr.dim() == 0:
        arr = _full(valid.shape[0], arr, dev)
    arr = _as_f32(arr)
    if a.fn == "sum":
        return _segment_sum(torch.where(valid, arr, 0.0), seg, num_segments)
    if a.fn == "min":
        return torch.full((num_segments,), _F32_INF, device=dev).scatter_reduce_(
            0, seg, torch.where(valid, arr, _F32_INF), "amin")
    if a.fn == "max":
        return torch.full((num_segments,), -_F32_INF, device=dev).scatter_reduce_(
            0, seg, torch.where(valid, arr, -_F32_INF), "amax")
    raise ValueError(a.fn)


def bucket_ids(t: VecTable, keys: Sequence[str],
               key_domains: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Dense bucket id per row: lexicographic rank in the static key domain."""
    acc = torch.zeros(t.capacity, dtype=torch.int64, device=t.device)
    for k, (lo, hi) in zip(keys, key_domains):
        size = int(hi) - int(lo) + 1
        arr = torch.clamp(_int_key(t.cols[k]).to(torch.int64) - int(lo), 0, size - 1)
        acc = acc * size + arr
    return acc


def decode_bucket_keys(keys: Sequence[str], key_domains: Sequence[Tuple[int, int]],
                       dtypes: Sequence[torch.dtype], num_buckets: int,
                       device: Any) -> Dict[str, torch.Tensor]:
    """Key column values for each dense bucket id (inverse of bucket_ids)."""
    b = torch.arange(num_buckets, dtype=torch.int64, device=device)
    out: Dict[str, torch.Tensor] = {}
    stride = num_buckets
    for k, (lo, hi), dt in zip(keys, key_domains, dtypes):
        size = int(hi) - int(lo) + 1
        stride //= size
        out[k] = ((b // stride) % size + int(lo)).to(dt)
    return out


def group_agg_direct(t: VecTable, keys: Sequence[str], aggs: Sequence[AggSpec],
                     max_groups: int, key_domains: Sequence[Tuple[int, int]],
                     num_buckets: int, pred: Optional[Expr] = None) -> VecTable:
    """Grouped aggregation WITHOUT sorting: dense-bucket segment reduction.

    Every row's group is a static function of its key values (catalog
    ``key_domains``): reduce straight into ``num_buckets`` dense buckets,
    then prefix-sum-compact the non-empty ones to ``max_groups``.  Bucket
    order is lexicographic key order.  ``pred`` is a fused MaskSelect."""
    valid = t.valid
    if pred is not None:
        valid = mask_select(t, pred).valid
    bid = bucket_ids(t, keys, key_domains)
    seg = torch.where(valid, bid, num_buckets)  # dump invalid rows
    counts = torch.zeros(num_buckets + 1, dtype=torch.int32,
                         device=t.device).index_add_(
        0, seg, valid.to(torch.int32))[:num_buckets]
    out_cols = decode_bucket_keys(keys, key_domains, [t.cols[k].dtype for k in keys],
                                  num_buckets, t.device)
    for a in aggs:
        out_cols[a.name] = _segment_agg(a, t.cols, valid, seg,
                                        num_buckets + 1)[:num_buckets]
    return compact(VecTable(out_cols, counts > 0), max_groups)


def _bucket_ids_checked(t: VecTable, keys: Sequence[str],
                        key_domains: Sequence[Tuple[int, int]],
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense bucket id per row + an in-domain mask (a clipped
    out-of-domain probe key must not alias the boundary bucket)."""
    acc = torch.zeros(t.capacity, dtype=torch.int64, device=t.device)
    ok = torch.ones(t.capacity, dtype=torch.bool, device=t.device)
    for k, (lo, hi) in zip(keys, key_domains):
        size = int(hi) - int(lo) + 1
        arr = _int_key(t.cols[k]).to(torch.int64) - int(lo)
        ok = ok & (arr >= 0) & (arr < size)
        acc = acc * size + torch.clamp(arr, 0, size - 1)
    return acc, ok


def build_first_index(right: VecTable, right_on: Sequence[str],
                      key_domains: Sequence[Tuple[int, int]],
                      num_buckets: int) -> torch.Tensor:
    """Direct table over the join-bucket axis: the lowest valid build row
    index per bucket, ``right.capacity`` where the bucket is empty.

    A scatter-min into a table with a dump slot, so duplicate build keys
    resolve to the first occurrence and out-of-domain rows fall away."""
    cap_r = right.capacity
    rbid, rok = _bucket_ids_checked(right, right_on, key_domains)
    slot = torch.where(rok & right.valid, rbid, num_buckets)
    table = torch.full((num_buckets + 1,), cap_r, dtype=torch.int64,
                       device=right.device)
    rows = torch.arange(cap_r, dtype=torch.int64, device=right.device)
    return table.scatter_reduce_(0, slot, rows, "amin")[:num_buckets]


def _direct_probe(left: VecTable, right: VecTable, right_on: Sequence[str],
                  key_domains: Sequence[Tuple[int, int]], num_buckets: int,
                  lbid: torch.Tensor, lok: torch.Tensor,
                  columns: Optional[Sequence[str]] = None) -> VecTable:
    """Dense direct-table probe: one gather per left row.  Output rows stay
    at ``left.capacity``; ``columns`` restricts which right columns are
    gathered."""
    cap_r = right.capacity
    table = build_first_index(right, right_on, key_domains, num_buckets)
    idx = table[torch.clamp(lbid, 0, num_buckets - 1)]
    match = left.valid & lok & (idx < cap_r)
    idx_c = torch.clamp(idx, max=cap_r - 1)
    out = dict(left.cols)
    lnames = set(left.cols)
    for k, v in right.cols.items():
        if k in right_on or (columns is not None and k not in columns):
            continue
        name = k if k not in lnames else k + "_r"
        out[name] = v[idx_c]
    return VecTable(out, match)


def hash_join_direct(left: VecTable, right: VecTable, left_on: Sequence[str],
                     right_on: Sequence[str], max_count: int,
                     key_domains: Optional[Sequence[Tuple[int, int]]] = None,
                     num_buckets: Optional[int] = None) -> VecTable:
    """Sort-free PK-FK inner equi-join via a dense direct table, for
    catalog-bounded ``key_domains`` (out-of-domain rows never match)."""
    if key_domains is None:
        raise NotImplementedError(
            "hash_join_direct with dynamic key bounds (no catalog key_domains) "
            "is not ported yet: ROADMAP Queue 1, the sorted tiers")
    nb = 1
    for lo, hi in key_domains:
        nb *= int(hi) - int(lo) + 1
    lbid, lok = _bucket_ids_checked(left, left_on, key_domains)
    joined = _direct_probe(left, right, right_on, key_domains, nb, lbid, lok)
    if max_count != left.capacity:
        joined = compact(joined, max_count)
    return joined


def fused_join_group_agg(left: VecTable, right: VecTable,
                         left_on: Sequence[str], right_on: Sequence[str],
                         join_key_domains: Sequence[Tuple[int, int]],
                         join_num_buckets: int, keys: Sequence[str],
                         aggs: Sequence[AggSpec], max_groups: int,
                         key_domains: Sequence[Tuple[int, int]],
                         num_buckets: int, pred: Optional[Expr] = None,
                         ) -> VecTable:
    """Whole-pipeline select→join→group, the join never compacted: only
    the right columns the grouping reads are gathered."""
    valid = left.valid
    if pred is not None:
        valid = mask_select(left, pred).valid
    lbid, lok = _bucket_ids_checked(left, left_on, join_key_domains)
    needed = set(keys)
    for a in aggs:
        if a.fn != "count":
            needed.update(a.expr.fields())
    joined = _direct_probe(VecTable(left.cols, valid), right, right_on,
                           join_key_domains, join_num_buckets, lbid, lok,
                           columns=sorted(needed))
    return group_agg_direct(joined, keys, aggs, max_groups, key_domains,
                            num_buckets)


def concat(tables: Sequence[VecTable]) -> VecTable:
    cols = {k: torch.cat([t.cols[k] for t in tables]) for k in tables[0].cols}
    return VecTable(cols, torch.cat([t.valid for t in tables]))


def split(t: VecTable, n: int) -> List[VecTable]:
    """``n`` equal row ranges; each column of a chunk is a contiguous view
    of the table's column, so the kernels take it without a copy."""
    cap = t.capacity
    if cap % n != 0:
        raise ValueError(f"capacity {cap} not divisible by {n}")
    c = cap // n
    return [
        VecTable({k: v[i * c:(i + 1) * c] for k, v in t.cols.items()},
                 t.valid[i * c:(i + 1) * c])
        for i in range(n)
    ]
