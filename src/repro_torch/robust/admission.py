"""Resource admission: bound a plan's peak bytes *before* it executes.

The estimate models what the port allocates while a lowered program runs
(``backends/emit.py``, ``relational/runtime.py``, ``kernels/ops.py``), from
static shapes: every register type carries its padded capacity
(``Vec[max_count]``, ``ArrayN[n]``, tensor shapes), and each operator's own
allocations follow from its parameters.  The model, and why:

* ``evaluate_program`` keeps every register until the program returns, so
  the live set at an instruction is everything the instructions before it
  made, not only its inputs and outputs.  A register that is a view of
  another (a scanned source, a projection, a split) adds nothing; a new
  one adds its bytes, the validity mask included.
* an operator's transient allocations (``_work``): the sorted tiers'
  chained stable sorts (``runtime._sort_perm``: int64 permutations, key
  copies and their gathers, the sort's values, indices and the device
  sort's buffers) and the gathered copy of every column; the direct tiers'
  bucket tables and their epilogue (decoded keys, the ±3e38 sentinels'
  copies, the compaction's prefix sums and scatters); ``_segment_sum``'s
  chunk partials (``_SUM_CHUNK_ROWS``) and slot temporaries on the CPU,
  ``fixed_sum``'s integer temporaries and accumulators on the card;
  join tables and probe gathers; the temporaries of each expression
  (``_expr_live``: eager evaluation holds a node's left operand while its
  right one is made);
* the kernels' scratch (``_kernel_scratch``: the reg routes' partials, the
  atomic routes' int64 sums and scale words, the join's first-row table,
  ``kms_main``'s labels), which ``ops`` allocates at first use and keeps
  per stream, so it is added once, at the plan's largest.

The estimate is the max over instructions of live + new + transient, plus
that scratch; nested bodies run ``cf.ConcurrentExecute``/``mesh.MeshExecute``
chunk by chunk and count each chunk's peak (an over-approximation).  It
stays deliberately an over-approximation of the allocation high-water
mark, and deliberately cheap: one walk of the lowered program.  The admission
question is "can this plan OOM the device"; ``chip_smoke.py`` holds each
plan's estimate above the caching allocator's measured rise on the card,
and ``tests/test_torch_admission.py`` above ``MemTracker``'s on the CPU.

:func:`admit` compares the estimate against a byte budget
(``CompileOptions.memory_budget`` or the ``REPRO_MEM_BUDGET_BYTES``
environment default) and raises :class:`AdmissionError` when over.  The
driver treats that like any other plan failure: degrade down the fallback
ladder (``groupby=sorted`` drops the bucket table, interp escapes static
padding altogether) rather than letting the device OOM.  The ``interp`` rung runs on the host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from ..core.program import Instruction, Program, Register
from ..core.types import CollectionType, is_coll, item_nbytes

__all__ = ["AdmissionError", "ResourceEstimate", "estimate_peak_bytes",
           "admit", "default_budget"]

#: assumed element count for collections with no static capacity attr —
#: abstract (pre-lowering) programs stay admissible by construction
DEFAULT_ROWS = 1024


class AdmissionError(RuntimeError):
    """The plan's estimated peak working set exceeds the byte budget."""

    def __init__(self, message: str, estimate: "ResourceEstimate",
                 budget: int) -> None:
        super().__init__(message)
        self.estimate = estimate
        self.budget = budget


@dataclass(frozen=True)
class ResourceEstimate:
    """Peak-bytes estimate for one lowered program."""

    peak_bytes: int
    #: the instruction at the high-water mark, e.g. ``vec.GroupAggDirect``
    peak_site: str
    #: per-site footprints, largest first: (opcode, bytes)
    breakdown: Tuple[Tuple[str, int], ...] = ()

    def render(self) -> str:
        top = ", ".join(f"{op}={b:,}B" for op, b in self.breakdown[:4])
        return (f"peak ≈ {self.peak_bytes:,} bytes at {self.peak_site}"
                + (f" ({top})" if top else ""))


# ---------------------------------------------------------------------------
# block footprints from static types
# ---------------------------------------------------------------------------


def _type_bytes(t: Any) -> int:
    """Padded bytes of one value of type ``t`` (static capacities)."""
    if not is_coll(t):
        return item_nbytes(t, 8)
    assert isinstance(t, CollectionType)
    kind = t.kind.name
    if kind == "Single":
        return item_nbytes(t.item, 8)
    if kind == "ArrayN":
        n = int(t.attr("n") or 1)
        return n * _type_bytes(t.item)
    if kind in ("Tensor", "KDSeq"):
        shape = t.attr("shape") or ()
        count = 1
        for s in shape:
            count *= int(s) if int(s) > 0 else DEFAULT_ROWS
        return count * item_nbytes(t.item, 8)
    # Vec / Seq / Bag / Set / HTab / Stream: padded capacity × element
    cap = t.attr("max_count")
    count = int(cap) if cap else DEFAULT_ROWS
    return count * _type_bytes(t.item) if is_coll(t.item) \
        else count * item_nbytes(t.item, 8)


def _rows(t: Any) -> int:
    """Rows of a collection register: its static capacity (a tensor's
    first dimension)."""
    if not is_coll(t):
        return 1
    if t.kind.name in ("Tensor", "KDSeq"):
        shape = t.attr("shape") or ()
        return int(shape[0]) if shape and int(shape[0]) > 0 else DEFAULT_ROWS
    cap = t.attr("max_count") or t.attr("n")
    return int(cap) if cap else DEFAULT_ROWS


def _row_bytes(t: Any) -> int:
    """Bytes of one row of a relation register, its validity byte included."""
    if not is_coll(t):
        return item_nbytes(t, 8)
    return item_nbytes(t.item, 8) + 1


def _vec_bytes(reg: Register) -> int:
    """A register's bytes as the port holds it: a relation's columns and
    validity mask; any other value as ``_type_bytes`` counts it."""
    t = reg.type
    if is_coll(t) and t.kind.name in ("Vec", "Seq", "Bag", "Set", "HTab", "Stream") \
            and not is_coll(t.item):
        return _rows(t) * _row_bytes(t) + SMALL_ALLOC
    return _type_bytes(t) + SMALL_ALLOC


#: what the caching allocator rounds each allocation up to (a 0-dim
#: aggregate, a Python constant lifted beside a column)
SMALL_ALLOC = 512
#: bytes a row of the sorted tiers' chained sort holds at once
#: (``runtime._sort_perm``): the int64 permutation and the next one, a key
#: copy (negated or cast) and its gather, ``torch.sort``'s values and int64
#: indices, and the device radix sort's double buffers of both
SORT_ROW_BYTES = 96
#: bytes a row of a segment sum's temporaries holds (``runtime._segment_sum``:
#: on the CPU the int64 row index, its chunk and the slot; on the card
#: ``runtime.fixed_sum``'s int64 cell ids, the value's bits, exponent,
#: significand and shift, and its int64 integer with the shift's temporaries)
SEGSUM_ROW_BYTES = 72
#: bytes a (chunk, segment) slot of ``runtime.fixed_sum`` holds (an int32
#: word, then the int64 sum), and a segment (its exponent and flags, the
#: int64 sum, the f64 result and its exponent, the f32 result's copies)
FIXED_SLOT_BYTES, FIXED_SEGMENT_BYTES = 12, 48
#: bytes a bucket of the direct tiers' epilogue holds beside the counts and
#: values (``rt.decode_bucket_keys``' int64 ids and quotients,
#: ``rt.compact``'s int64 prefix sums and scatter indices, the sentinels'
#: f32 copies)
BUCKET_BYTES = 40
#: bytes a probe row of a direct join holds (``rt._bucket_ids_checked``'s
#: int64 ids, their clamp and in-domain mask, the table gather and its clamp)
PROBE_ROW_BYTES = 48


def _expr_live(e: Any, rows: int) -> int:
    """Bytes an expression's eager evaluation holds at once over ``rows``
    rows (``core.expr.evaluate``: a node holds its left operand while the
    right one is made, then both beside its result), each computed column
    at 8 bytes a row (int64 and f64 intermediates before ``x32``), plus the
    result's x32 copy."""
    def live(x) -> Tuple[int, int]:  # (peak held, size of the result)
        kids = [getattr(x, a) for a in ("lhs", "rhs", "arg") if hasattr(x, a)]
        if not kids:
            return 0, 0
        held, peak = 0, 0
        for k in kids:
            p, size = live(k)
            peak = max(peak, held + p)
            held += size
        out = 8 * rows + SMALL_ALLOC
        return max(peak, held + out), out

    if e is None:
        return 0
    peak, size = live(e)
    return peak + size + SMALL_ALLOC * 4


def _agg_exprs(aggs: Any) -> list:
    return [a.expr for a in (aggs or ()) if getattr(a, "fn", "count") != "count"]


def _partials(rows: int, segments: int, width: int = 4) -> int:
    """``runtime._segment_sum``'s per-segment bytes: on the CPU its chunk
    partials and their sum, on the card ``fixed_sum``'s accumulators."""
    from ..relational.runtime import _FIXED_SLOT_ROWS, _SUM_CHUNK_ROWS, _SUM_MAX_PARTIALS

    cells = max(segments * width // 4, 1)
    chunks = max(1, min(-(-rows // _SUM_CHUNK_ROWS), _SUM_MAX_PARTIALS // cells))
    fixed = max(1, -(-rows * width // 4 // (_FIXED_SLOT_ROWS * cells)))
    return max((chunks + 1) * 4, FIXED_SLOT_BYTES * fixed + FIXED_SEGMENT_BYTES) * cells


def _segment_aggs(aggs: Any, rows: int, segments: int) -> int:
    """``runtime._segment_aggs``: every aggregate's result kept (``segments``
    values of 4 bytes, twice for a sum's stacked copy) beside the largest
    temporaries: on the CPU one aggregate's at a time (its expression, the
    f32 column and its masked copy, a sum's slot temporaries and chunk
    partials); on the card the sums' together (their masked columns and
    their stack, ``fixed_sum`` over every column at once)."""
    aggs = tuple(aggs or ())
    n_sums = sum(1 for a in aggs if a.fn == "sum")
    kept = len(aggs) * (segments * 4 + SMALL_ALLOC) + n_sums * segments * 4
    worst = 0
    for a in aggs:
        w = _expr_live(None if a.fn == "count" else a.expr, rows) + 8 * rows
        if a.fn == "sum":
            w += SEGSUM_ROW_BYTES * rows + _partials(rows, segments)
        worst = max(worst, w)
    if n_sums > 1:
        live = max(_expr_live(a.expr, rows) for a in aggs if a.fn == "sum")
        worst = max(worst, live + 8 * rows * n_sums + SEGSUM_ROW_BYTES * rows * n_sums
                    + _partials(rows, segments, 4 * n_sums))
    return kept + worst


def _direct_group(rows: int, nb: int, groups: int, out_row: int, aggs: Any,
                  pred: Any, n_keys: int) -> int:
    """``GroupAggDirect``'s transient bytes, the larger of its two paths:
    the plain one (``rt.group_agg_direct``: the predicate, int64 bucket
    ids, the segment reductions into ``nb + 1`` slots) and the kernel's
    epilogue (``ops._grouped_epilogue``: counts and values per bucket,
    decoded keys, the sentinels' copies); both then compact the ``nb``
    buckets to ``groups`` rows."""
    n_vals = len(_agg_exprs(aggs))
    plain = (_expr_live(pred, rows) + rows + 3 * 8 * rows + 4 * rows
             + _segment_aggs(aggs, rows, nb + 1))
    buckets = nb * (4 + 4 * max(n_vals, 1) + BUCKET_BYTES + 8 * n_keys + 4 * len(aggs or ()))
    return plain + buckets + (groups + 1) * out_row


def _join_table(ins: Instruction, build_rows: int) -> int:
    """A direct join's first-row table (int64, one slot per join bucket
    and a dump slot) and the build side's int64 bucket ids and rows."""
    nb = ins.param("join_num_buckets") or ins.param("num_buckets")
    domains = ins.param("join_key_domains") or ins.param("key_domains")
    if domains is not None:
        nb = 1
        for lo, hi in domains:
            nb *= int(hi) - int(lo) + 1
    return (int(nb or 0) + 1) * 8 + PROBE_ROW_BYTES * build_rows


def _work(ins: Instruction) -> int:
    """Transient bytes of one instruction: what its emitter allocates and
    frees again, beyond its outputs (the module's docstring)."""
    op = ins.opcode
    ins_t = [r.type for r in ins.inputs]
    n = _rows(ins_t[0]) if ins_t else 0
    w_in = _row_bytes(ins_t[0]) if ins_t else 0
    out_t = ins.outputs[0].type if ins.outputs else None
    out_row = _row_bytes(out_t) if out_t is not None else 8
    aggs = ins.param("aggs")
    if op in ("vec.MaskSelect",):
        return _expr_live(ins.param("pred"), n) + n
    if op == "vec.ExProjVec":
        return max((_expr_live(e, n) for _, e in (ins.param("exprs") or ())), default=0)
    if op in ("vec.AggrVec", "vec.FusedSelectAgg"):
        per = max((_expr_live(e, n) for e in _agg_exprs(aggs)), default=0) + 8 * n
        return _expr_live(ins.param("pred"), n) + 2 * n + per + SMALL_ALLOC * 2 * len(aggs or ())
    if op == "vec.SortByKey":
        return SORT_ROW_BYTES * n + n * 4
    if op == "vec.GroupAggSorted":
        groups = int(ins.param("max_groups") or 0)
        keys = len(ins.param("keys") or ())
        return (10 * n + 3 * 8 * n + keys * (8 * n + (groups + 1) * 8)
                + _segment_aggs(aggs, n, groups + 1))
    if op == "vec.GroupAggDirect":
        return _direct_group(n, int(ins.param("num_buckets") or 0),
                             int(ins.param("max_groups") or 0), out_row, aggs,
                             ins.param("pred"), len(ins.param("keys") or ()))
    if op == "vec.FusedJoinGroupAgg":
        m = _rows(ins_t[1])
        gathered = n * _row_bytes(ins_t[1])
        return (_expr_live(ins.param("pred"), n) + n + PROBE_ROW_BYTES * n
                + _join_table(ins, m) + gathered
                + _direct_group(n, int(ins.param("num_buckets") or 0),
                                int(ins.param("max_groups") or 0), out_row, aggs, None,
                                len(ins.param("keys") or ())))
    if op in ("vec.HashJoinDirect", "vec.MergeJoinSorted"):
        m = _rows(ins_t[1])
        gathered = n * _row_bytes(ins_t[1])
        work = PROBE_ROW_BYTES * n + gathered + n * 2 + 4 * 8 * n
        if op == "vec.HashJoinDirect":
            work += _join_table(ins, m)
            if ins.param("key_domains") is None:  # the dynamic branch may sort the build side
                work += SORT_ROW_BYTES * m + m * _row_bytes(ins_t[1])
        else:
            work += 3 * 4 * (n + m)
        return work + 3 * 8 * n  # the compaction's prefix sums and scatter
    if op == "vec.TopKVec":
        return SORT_ROW_BYTES * n + n * w_in
    if op in ("vec.LimitVec", "vec.Compact"):
        return 3 * 8 * n + n
    if op == "vec.DictEncode":
        return 4 * 8 * n
    if op == "vec.DictDecode":
        return 3 * 8 * n
    if op in ("vec.MergeGroupedState",):
        rows = 2 * n
        both = rows * w_in
        if ins.param("key_domains") is not None and ins.param("num_buckets") is not None:
            return both + _direct_group(rows, int(ins.param("num_buckets")),
                                        int(ins.param("max_groups") or 0), out_row, aggs,
                                        None, len(ins.param("keys") or ()))
        groups = int(ins.param("max_groups") or 0)
        return (both + SORT_ROW_BYTES * rows + rows * w_in + 34 * rows
                + _segment_aggs(aggs, rows, groups + 1))
    if op == "la.CDist2":
        return 3 * _type_bytes(out_t) if out_t is not None else 0
    if op == "la.ArgMinRow":
        return 8 * n
    if op in ("la.SegSum", "la.SegCount", "la.KMeansStep"):
        k = int(ins.param("k") or 0) or (_rows(ins_t[1]) if len(ins_t) > 1 else 1)
        d = (_type_bytes(ins_t[0]) // max(n * 4, 1)) if ins_t else 1
        work = SEGSUM_ROW_BYTES * n + _partials(n, k + 1, 4 * max(d, 1)) + 8 * n
        if op == "la.KMeansStep":
            work += 3 * n * k * 4
        return work
    if op == "mesh.ExchangeByKey":
        # send + receive buffers, each a full shard block
        return 2 * sum(_vec_bytes(r) for r in ins.inputs)
    if op == "mesh.AllGatherVec":
        k = int(ins.param("n", 1) or 1)
        return k * sum(_vec_bytes(r) for r in ins.inputs)
    if op in _VIEWS or op in _SMALL_OPS:
        return 0
    # an operator this model has no rule for: a copy of every input
    return sum(_vec_bytes(r) for r in ins.inputs)


#: operators whose outputs are views of their inputs or of the sources
_VIEWS = frozenset({"vec.ScanVec", "df.Source", "vec.ProjVec", "vec.SplitVec", "cf.Split",
                    "cf.Broadcast", "cf.TakeChunk", "df.Collect", "la.Transpose"})
#: operators whose outputs are a few scalars
_SMALL_OPS = frozenset({"vec.FinalizeSingle", "rel.CombinePartials",
                        "vec.MergeScalarState", "vec.AggrVec", "vec.FusedSelectAgg"})


def _new_bytes(ins: Instruction) -> int:
    """Bytes an instruction's outputs add to the live set: none for views,
    a few allocations for scalars, the validity mask for a selection, else
    the outputs' bytes."""
    op = ins.opcode
    if op in _VIEWS:
        return 0
    if op == "la.Literal" and ins.param("name") is not None:
        return SMALL_ALLOC
    if op in _SMALL_OPS:
        n_out = len(ins.param("aggs") or ins.param("exprs") or ()) or 1
        return SMALL_ALLOC * 2 * n_out
    if op == "vec.MaskSelect":
        return _rows(ins.inputs[0].type) + SMALL_ALLOC
    out = sum(_vec_bytes(r) for r in ins.outputs)
    if op in ("vec.DictEncode", "vec.DictDecode"):
        # the plan's dictionary tables, moved to the device once and kept
        for t in (ins.param("tables") or ()):
            size = getattr(t, "size", None)
            itemsize = getattr(getattr(t, "dtype", None), "itemsize", 4)
            out += int(size if size is not None else len(t)) * itemsize + SMALL_ALLOC
    return out


def _kernel_scratch(ins: Instruction) -> int:
    """The kernels' scratch an instruction's launch needs (``ops``' per
    stream workspace, kept and grown to the largest): the reg and
    fused_select_agg routes' per-block partials (at most 1,024 blocks
    here), the atomic routes' int64 sums and scale words per value and
    bucket (``fixsum.cuh``), the join's first-row table, k-means' labels,
    sums' accumulators and tensor-core partials."""
    op = ins.opcode
    if op in ("vec.GroupAggDirect", "vec.FusedJoinGroupAgg"):
        nb = int(ins.param("num_buckets") or 0)
        nv = len(_agg_exprs(ins.param("aggs")))
        grouped = max(1024 * nb * (1 + nv) * 4 if nb * (1 + nv) <= 64 else 0, nb * nv * 12)
        if op == "vec.FusedJoinGroupAgg":
            grouped += int(ins.param("join_num_buckets") or 0) * 4 + 16
        return grouped + SMALL_ALLOC
    if op == "vec.FusedSelectAgg":
        return 1024 * (1 + len(_agg_exprs(ins.param("aggs")))) * 4 + SMALL_ALLOC
    if op == "la.KMeansStep" and ins.inputs:
        n = _rows(ins.inputs[0].type)
        k = _rows(ins.inputs[1].type) if len(ins.inputs) > 1 else 1
        d = max(_type_bytes(ins.inputs[0].type) // max(n * 4, 1), 1)
        # kms_main: labels, counts, the sums' accumulators; kms_tc: at most 528
        # partials of (k, d) padded to 16 and 8, and the counts
        return max(4 * n + 4 * k + 12 * k * d, 528 * (k + 16) * (d + 9) * 4) + SMALL_ALLOC
    return 0


def _chunk_count(ins: Instruction) -> int:
    """How many copies of a nested body run (in turn, each counted)."""
    n = ins.param("n")
    if n:
        return int(n)
    if ins.inputs:
        t = ins.inputs[0].type
        if is_coll(t):
            seq_n = t.attr("n")
            if seq_n:
                return int(seq_n)
    return 1


def _program_peak(program: Program) -> Tuple[int, str, list, int]:
    """(peak bytes, the instruction at the peak, per-instruction
    footprints, the kernels' scratch) of one program: the registers every
    earlier instruction made stay live (``evaluate_program`` keeps them)."""
    peak, site, sites, live, scratch = 0, "(empty)", [], 0, 0
    for ins in program.body:
        nested = [p for p in
                  (ins.param("P"), ins.param("Pthen"), ins.param("Pelse"))
                  if p is not None]
        new = _new_bytes(ins)
        if nested:
            inner = [_program_peak(p) for p in nested]
            scratch = max([scratch] + [i[3] for i in inner])
            inner_peak = max(i[0] for i in inner)
            if ins.opcode in ("cf.ConcurrentExecute", "mesh.MeshExecute"):
                work = _chunk_count(ins) * inner_peak
            else:  # cf.Loop / cf.While / cf.Cond / cf.Call: one body live
                work = inner_peak + sum(_vec_bytes(r) for r in ins.inputs)
        else:
            work = _work(ins)
            scratch = max(scratch, _kernel_scratch(ins))
        footprint = live + new + work
        sites.append((ins.opcode, footprint))
        if footprint > peak:
            peak, site = footprint, ins.opcode
        live += new
    return peak, site, sites, scratch


def estimate_peak_bytes(program: Program) -> ResourceEstimate:
    """Estimate the peak bytes a (lowered) program allocates on its device
    beyond its sources: the module's model."""
    peak, site, sites, scratch = _program_peak(program)
    sites.sort(key=lambda kv: -kv[1])
    return ResourceEstimate(peak_bytes=int(peak + scratch), peak_site=site,
                            breakdown=tuple(sites[:8]))


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def default_budget() -> Optional[int]:
    """The ``REPRO_MEM_BUDGET_BYTES`` environment default (None → no cap)."""
    raw = os.environ.get("REPRO_MEM_BUDGET_BYTES", "").strip()
    if not raw:
        return None
    try:
        budget = int(float(raw))
    except ValueError:
        raise ValueError(
            f"REPRO_MEM_BUDGET_BYTES must be a byte count, got {raw!r}"
        ) from None
    return budget if budget > 0 else None


def admit(program: Program, budget: Optional[int] = None,
          *, name: str = "") -> ResourceEstimate:
    """Admit ``program`` under ``budget`` bytes or raise AdmissionError.

    ``budget=None`` falls back to :func:`default_budget`; no budget at all
    admits everything (the estimate is still returned for provenance).
    """
    from ..obs.trace import get_tracer

    budget = default_budget() if budget is None else int(budget)
    est = estimate_peak_bytes(program)
    if budget is not None and est.peak_bytes > budget:
        get_tracer().counter("robust.admission.reject")
        raise AdmissionError(
            f"plan {name or program.name!r} rejected by resource admission: "
            f"{est.render()} > budget {budget:,} bytes", est, budget)
    get_tracer().counter("robust.admission.admit")
    return est
