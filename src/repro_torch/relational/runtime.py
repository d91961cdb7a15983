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
  outside the declared domain never match;
* key packings are int32 arithmetic and wrap as JAX's do;
* ``topk`` breaks ties by the lowest row index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.expr import AggSpec, Expr, evaluate

_F32_INF = float("inf")
_I32_MAX = (1 << 31) - 1
_I32_MIN = -(1 << 31)

def resolve_device(device: Any = None) -> torch.device:
    """``cuda`` unless the caller names a device; asking for a card that
    is not there raises instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        from ..errors import NoCardError
        raise NoCardError(
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


def proj(t: VecTable, names: Sequence[str]) -> VecTable:
    return VecTable({n: t.cols[n] for n in names}, t.valid)


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


def dict_encode(t: VecTable, cols: Sequence[str], modes: Sequence[str],
                tables: Sequence[torch.Tensor], lows: Sequence[int],
                cards: Sequence[int]) -> VecTable:
    """Per-column value → rank encoding against static sorted dictionaries
    (``tables`` on the table's device).

    ``mode == "remap"``: one gather through a span-sized rank table whose
    out-of-dictionary slots already hold the sentinel.  Otherwise a
    searchsorted rank lookup.  Values outside the dictionary get the
    sentinel rank ``card``, one past every declared rank domain."""
    out = dict(t.cols)
    for c, mode, tab, lo, card in zip(cols, modes, tables, lows, cards):
        arr = t.cols[c]
        if mode == "remap":
            span = tab.shape[0]
            idx = _cast_i32(arr) - int(lo)
            ok = (idx >= 0) & (idx < span)
            ranks = tab[idx.clamp(0, span - 1).to(torch.int64)]
            out[c] = torch.where(ok, ranks, int(card)).to(torch.int32)
        else:
            tab = tab.to(arr.dtype)
            ic = torch.searchsorted(tab, arr).clamp_(0, int(card) - 1)
            out[c] = torch.where(tab[ic] == arr, ic, int(card)).to(torch.int32)
    return VecTable(out, t.valid)


def dict_decode(t: VecTable, cols: Sequence[str], tables: Sequence[torch.Tensor]) -> VecTable:
    """Ranks back to raw values through the sorted value tables; sentinel
    and invalid ranks clip to the last entry (such rows are invalid)."""
    out = dict(t.cols)
    for c, tab in zip(cols, tables):
        ranks = t.cols[c].to(torch.int64).clamp(0, tab.shape[0] - 1)
        out[c] = tab[ranks]
    return VecTable(out, t.valid)


#: composite-key packings with more buckets than this raise instead of
#: silently colliding in the 32-bit accumulator
_PACK_LIMIT = 1 << 31


def _composite_key(t: VecTable, keys: Sequence[str],
                   key_domains: Optional[Sequence[Tuple[int, int]]] = None,
                   lows: Optional[Sequence[torch.Tensor]] = None,
                   sizes: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Pack key columns into one i32, preserving lexicographic order.

    The bounds come from static ``key_domains`` (checked against the 32-bit
    budget), else from dynamic ``lows``/``sizes`` traced from the data;
    with neither, only a single column packs."""
    if key_domains is not None:
        n_buckets = 1
        for lo, hi in key_domains:
            n_buckets *= int(hi) - int(lo) + 1
        if n_buckets > _PACK_LIMIT:
            raise ValueError(
                f"composite key domain for {tuple(keys)} has {n_buckets} "
                f"buckets and cannot be packed into a 32-bit accumulator; "
                "reduce the key domain or use a single integer key column")
        acc = torch.zeros(t.capacity, dtype=torch.int32, device=t.device)
        for k, (lo, hi) in zip(keys, key_domains):
            size = int(hi) - int(lo) + 1
            acc = acc * size + (_int_key(t.cols[k]) - int(lo)).clamp(0, size - 1)
        return acc
    if lows is not None and sizes is not None:
        acc = torch.zeros(t.capacity, dtype=torch.int32, device=t.device)
        for k, lo, size in zip(keys, lows, sizes):
            acc = acc * size + (_int_key(t.cols[k]) - lo)
        return acc
    if len(keys) == 1:
        return _int_key(t.cols[keys[0]])
    raise ValueError(
        f"cannot pack composite key {tuple(keys)} without per-column domain "
        "bounds; provide catalog key domains (see Catalog.stats) or derive "
        "dynamic bounds from the data")


def _cast_i32(arr: torch.Tensor) -> torch.Tensor:
    """``astype(int32)`` as XLA converts: floats truncate and saturate, NaN
    gives 0 (a plain torch cast of an out-of-range float on the CPU gives
    INT32_MIN)."""
    if not arr.is_floating_point():
        return arr.to(torch.int32)
    big = arr >= 2.0 ** 31
    sat = torch.nan_to_num(arr, nan=0.0).clamp(min=-2.0 ** 31).masked_fill(big, 0.0)
    return torch.where(big, _I32_MAX, sat.to(torch.int32))


def _int_key(arr: torch.Tensor) -> torch.Tensor:
    """Key columns as i32: f32 keys bit-cast (as the JAX runtime does)."""
    if arr.dtype == torch.float32:
        return arr.view(torch.int32)
    return arr.to(torch.int32)


def _key_change(t: VecTable, keys: Sequence[str]) -> torch.Tensor:
    """Per-row "starts a new group" flags of a key-sorted block: each key
    column against the previous row (collision-free for any key)."""
    change = torch.zeros(t.capacity, dtype=torch.bool, device=t.device)
    change[:1] = True
    for k in keys:
        c = t.cols[k]
        change |= c != torch.cat([c[:1], c[:-1]])
    return change & t.valid


def _lowest(dtype: torch.dtype) -> Any:
    """The identity of a max: ``jax.ops.segment_max``'s empty-segment value."""
    if dtype == torch.bool:
        return False
    if dtype.is_floating_point:
        return -_F32_INF
    return torch.iinfo(dtype).min


def group_agg_sorted(t: VecTable, keys: Sequence[str], aggs: Sequence[AggSpec],
                     max_groups: int) -> VecTable:
    """Grouped aggregation over a key-sorted block (valid rows first) by
    segment reduction: segment ids are the prefix count of key changes,
    clipped into a dump segment past ``max_groups``."""
    change = _key_change(t, keys)
    seg = torch.cumsum(change.to(torch.int64), 0) - 1
    seg = torch.where(t.valid, seg, max_groups).clamp_(0, max_groups)
    out_cols: Dict[str, torch.Tensor] = {}
    for k in keys:
        c = t.cols[k]
        as_int = c.to(torch.int32) if c.dtype == torch.bool else c
        vals = torch.where(t.valid, as_int, torch.zeros((), dtype=as_int.dtype,
                                                         device=t.device))
        red = torch.full((max_groups + 1,), _lowest(c.dtype), dtype=as_int.dtype,
                         device=t.device).scatter_reduce_(0, seg, vals, "amax",
                                                          include_self=False)
        out_cols[k] = red[:max_groups].to(c.dtype)
    for a in aggs:
        out_cols[a.name] = _segment_agg(a, t.cols, t.valid, seg, max_groups + 1)[:max_groups]
    n_groups = change.sum()
    return VecTable(out_cols, torch.arange(max_groups, device=t.device) < n_groups)


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


def _first_index(right: VecTable, rbid: torch.Tensor, rok: torch.Tensor,
                 num_buckets: int) -> torch.Tensor:
    """The lowest valid build row index per join bucket, ``right.capacity``
    where the bucket is empty: a scatter-min into a table with a dump
    slot, so duplicate build keys resolve to the first occurrence and rows
    outside the domain fall away."""
    cap_r = right.capacity
    slot = torch.where(rok & right.valid, rbid.to(torch.int64), num_buckets)
    table = torch.full((num_buckets + 1,), cap_r, dtype=torch.int64,
                       device=right.device)
    rows = torch.arange(cap_r, dtype=torch.int64, device=right.device)
    return table.scatter_reduce_(0, slot, rows, "amin")[:num_buckets]


def build_first_index(right: VecTable, right_on: Sequence[str],
                      key_domains: Sequence[Tuple[int, int]],
                      num_buckets: int) -> torch.Tensor:
    """Direct table over the join-bucket axis of static ``key_domains``."""
    rbid, rok = _bucket_ids_checked(right, right_on, key_domains)
    return _first_index(right, rbid, rok, num_buckets)


def _direct_probe(left: VecTable, right: VecTable, right_on: Sequence[str],
                  table: torch.Tensor, lbid: torch.Tensor, lok: torch.Tensor,
                  columns: Optional[Sequence[str]] = None) -> VecTable:
    """Dense direct-table probe: one gather per left row.  Output rows stay
    at ``left.capacity``; ``columns`` restricts which right columns are
    gathered."""
    cap_r = right.capacity
    idx = table[torch.clamp(lbid.to(torch.int64), 0, table.shape[0] - 1)]
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


def merge_join_sorted(left: VecTable, right: VecTable, left_on: Sequence[str],
                      right_on: Sequence[str], max_count: int,
                      key_domains: Optional[Sequence[Tuple[int, int]]] = None,
                      ) -> VecTable:
    """PK-FK inner equi-join; ``right`` must be key-sorted (valid rows
    first).  searchsorted + gather.  Multi-column keys pack with
    ``key_domains`` where given, else with bounds traced jointly from both
    sides; a single key column is cast to i32 (not bit-cast, as in JAX)."""
    if len(left_on) != 1 or len(right_on) != 1:
        if key_domains is not None:
            lk = _composite_key(left, left_on, key_domains=key_domains)
            rk = _composite_key(right, right_on, key_domains=key_domains)
        else:
            lows, sizes = _joint_key_bounds(left, right, left_on, right_on)
            lk = _composite_key(left, left_on, lows=lows, sizes=sizes)
            rk = _composite_key(right, right_on, lows=lows, sizes=sizes)
    else:
        lk = _cast_i32(left.cols[left_on[0]])
        rk = _cast_i32(right.cols[right_on[0]])
    rk = torch.where(right.valid, rk, _I32_MAX)
    idx = torch.searchsorted(rk, lk)
    idx_c = idx.clamp_(0, right.capacity - 1)
    match = (rk[idx_c] == lk) & left.valid
    out = dict(left.cols)
    lnames = set(left.cols)
    for k, v in right.cols.items():
        if k in right_on:
            continue
        name = k if k not in lnames else k + "_r"
        out[name] = v[idx_c]
    joined = VecTable(out, match)
    if max_count != left.capacity:
        joined = compact(joined, max_count)
    return joined


def _joint_key_bounds(left: VecTable, right: VecTable, left_on: Sequence[str],
                      right_on: Sequence[str]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Shared per-column (lo, size), 0-dim i32, over the valid rows of both
    join sides (packing must agree across sides)."""
    lows, sizes = [], []
    for lk, rk in zip(left_on, right_on):
        la, ra = _int_key(left.cols[lk]), _int_key(right.cols[rk])
        lo = torch.minimum(torch.where(left.valid, la, _I32_MAX).min(),
                           torch.where(right.valid, ra, _I32_MAX).min())
        hi = torch.maximum(torch.where(left.valid, la, -_I32_MAX).max(),
                           torch.where(right.valid, ra, -_I32_MAX).max())
        lows.append(lo)
        sizes.append(torch.clamp(hi - lo + 1, min=1))
    return lows, sizes


def hash_join_direct(left: VecTable, right: VecTable, left_on: Sequence[str],
                     right_on: Sequence[str], max_count: int,
                     key_domains: Optional[Sequence[Tuple[int, int]]] = None,
                     num_buckets: Optional[int] = None) -> VecTable:
    """Sort-free PK-FK inner equi-join via a dense direct table.

    * static ``key_domains`` (catalog-derived): bucket ids are checked
      against the declared domain, out-of-domain rows never match;
    * dynamic (``key_domains=None``): per-column bounds are taken jointly
      from both sides; when their product passes the static
      ``num_buckets`` budget the join falls back to the sorted merge join.
      JAX decides inside the trace (``lax.cond``); here the test is a host
      branch on one value read from the device."""
    if key_domains is not None:
        nb = 1
        for lo, hi in key_domains:
            nb *= int(hi) - int(lo) + 1
        lbid, lok = _bucket_ids_checked(left, left_on, key_domains)
        table = build_first_index(right, right_on, key_domains, nb)
        joined = _direct_probe(left, right, right_on, table, lbid, lok)
    else:
        if num_buckets is None:
            raise ValueError("hash_join_direct without key_domains needs a "
                             "static num_buckets budget")
        nb = int(num_buckets)
        lows, sizes = _joint_key_bounds(left, right, left_on, right_on)
        prod = torch.ones((), dtype=torch.float32, device=left.device)
        for s in sizes:
            prod = prod * s.to(torch.float32)  # f32: no i32 overflow on the product
        if bool(prod <= nb):
            # joint bounds cover every valid row of both sides by construction
            def dyn_bid(t: VecTable, keys: Sequence[str]) -> torch.Tensor:
                acc = torch.zeros(t.capacity, dtype=torch.int32, device=t.device)
                for k, lo, size in zip(keys, lows, sizes):
                    arr = torch.minimum((_int_key(t.cols[k]) - lo).clamp(min=0), size - 1)
                    acc = acc * size + arr
                return acc

            table = _first_index(right, dyn_bid(right, right_on), right.valid, nb)
            joined = _direct_probe(left, right, right_on, table, dyn_bid(left, left_on),
                                   left.valid)
        else:
            joined = merge_join_sorted(left, sort_by_key(right, right_on), left_on,
                                       right_on, left.capacity)
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
    table = build_first_index(right, right_on, join_key_domains, join_num_buckets)
    needed = set(keys)
    for a in aggs:
        if a.fn != "count":
            needed.update(a.expr.fields())
    joined = _direct_probe(VecTable(left.cols, valid), right, right_on, table, lbid, lok,
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


def topk(t: VecTable, keys: Sequence[str], ascending: Sequence[bool], k: int) -> VecTable:
    """The first ``k`` rows in key order.  A single numeric key takes a
    stable descending sort of a validity-masked score, so ties go to the
    lowest index (``lax.top_k``'s order); ascending ints flip by bitwise
    NOT, which stays strictly decreasing at INT32_MIN.  As in JAX, a valid
    key whose score equals the sentinel can lose its slot to an earlier
    invalid row; the sort path is the general tier."""
    if len(keys) == 1 and t.cols[keys[0]].dtype != torch.bool:
        arr = t.cols[keys[0]]
        k_eff = min(int(k), t.capacity)
        if arr.is_floating_point():
            sentinel = -_F32_INF
            score = -arr if ascending[0] else arr
        else:
            sentinel = _I32_MIN
            score = ~arr.to(torch.int32) if ascending[0] else arr.to(torch.int32)
        score = torch.where(t.valid, score, sentinel)
        idx = torch.sort(score, descending=True, stable=True).indices[:k_eff]
        return VecTable({kk: v[idx] for kk, v in t.cols.items()}, t.valid[idx])
    s = sort_by_key(t, keys, ascending)
    return VecTable({kk: v[:k] for kk, v in s.cols.items()}, s.valid[:k])


def limit(t: VecTable, k: int) -> VecTable:
    c = compact(t)
    return VecTable(c.cols, c.valid & (torch.arange(t.capacity, device=t.device) < k))


# ---------------------------------------------------------------------------
# incremental (streaming) state: init / merge across micro-batches
# ---------------------------------------------------------------------------
#
# The streaming target (core/passes/lower_stream.py) splits a lowered plan
# at its terminal aggregation: each micro-batch produces a *partial*
# aggregate (the batch segment reuses the ordinary grouped/scalar operators
# above, the kernels among them), and the running state is folded forward
# with the functions below, in plain torch on the state's device.  Every
# AggSpec is self-decomposable (count combines with sum), so
# merge-of-partials is itself a grouped aggregation over the concatenated
# (state, delta) block.  On the direct tier each bucket of that block holds
# at most two valid rows, the state's and the delta's, and a sum of two f32
# values does not depend on their order: the merge gives the same bits run
# to run, on the card too.


def _merge_aggs(aggs: Sequence[AggSpec]) -> List[AggSpec]:
    """The partial-combining AggSpecs: ``fn=combine_fn`` over the partial
    column itself (sum-of-sums, min-of-mins, sum-of-counts)."""
    from ..core.expr import Col

    return [AggSpec(a.combine_fn, Col(a.name), a.name) for a in aggs]


def empty_grouped_state(template: VecTable) -> VecTable:
    """The identity element for grouped merge: same schema/capacity as a
    partial-aggregate block, zero valid rows."""
    return VecTable({k: torch.zeros_like(v) for k, v in template.cols.items()},
                    torch.zeros_like(template.valid))


def merge_grouped_partials(state: VecTable, delta: VecTable,
                           keys: Sequence[str], aggs: Sequence[AggSpec],
                           max_groups: int,
                           key_domains: Optional[Sequence[Tuple[int, int]]] = None,
                           num_buckets: Optional[int] = None) -> VecTable:
    """Fold one micro-batch's grouped partial aggregate into the running
    state (both capacity ``max_groups``) — the streaming step/merge op.

    With catalog ``key_domains`` the merge is the sort-free dense-bucket
    tier (O(state+delta), the carried GroupAggDirect accumulator); without
    them it falls back to sort + segment reduction.  Aggregate columns are
    cast back to the delta's dtypes so integer counts stay integers across
    arbitrarily many merges.
    """
    both = concat([state, delta])
    merge_aggs = _merge_aggs(aggs)
    if key_domains is not None and num_buckets is not None:
        merged = group_agg_direct(both, keys, merge_aggs, max_groups,
                                  key_domains, int(num_buckets))
    else:
        merged = group_agg_sorted(sort_by_key(both, keys), keys, merge_aggs,
                                  max_groups)
    cols = {k: merged.cols[k].to(delta.cols[k].dtype) for k in merged.cols}
    return VecTable(cols, merged.valid)


_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def merge_scalar_partials(state: Dict[str, torch.Tensor],
                          delta: Dict[str, torch.Tensor],
                          aggs: Sequence[AggSpec]) -> Dict[str, torch.Tensor]:
    """Fold one micro-batch's scalar partial aggregate (Single) into the
    running state, dtype-preserving (counts stay integral)."""
    return {a.name: _COMBINE[a.combine_fn](state[a.name], delta[a.name]) for a in aggs}
