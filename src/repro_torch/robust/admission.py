"""Resource admission: bound a plan's peak bytes *before* it executes.

The port's copy of ``repro/robust/admission.py``, model unchanged: it
estimates the JAX package's allocation from static shapes.  A lowered vec
program's working set is knowable at admission time: every register type carries its padded capacity
(``Vec[max_count]``, ``ArrayN[n]``, tensor shapes) and the expensive
operators declare their scratch (``vec.GroupAggDirect`` allocates a
``num_buckets`` dense table; exchanges buffer a full shard).  The estimate
is the max over instructions of

    live inputs + outputs + operator scratch

with concurrently-executing nested bodies (``cf.ConcurrentExecute``,
``mesh.MeshExecute``) multiplied by their chunk count.  It is deliberately
an over-approximation of the *allocation* high-water mark — the admission
question is "can this plan OOM the device", not "what will the allocator
do" (torch's caching allocator and the generated kernels' scratch differ
from XLA's; ``chip_smoke.py`` prints the estimate beside the card's
measured peak) — and deliberately cheap: one walk of the lowered program.

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


def _reg_bytes(reg: Register) -> int:
    return _type_bytes(reg.type)


def _scratch_bytes(ins: Instruction) -> int:
    """Operator-private allocations beyond inputs and outputs."""
    op = ins.opcode
    if op == "vec.GroupAggDirect":
        # the dense bucket table: one accumulator row per bucket, shaped
        # like the output element (keys + aggregates)
        n_buckets = int(ins.param("num_buckets") or 0)
        out = ins.outputs[0].type
        bpr = item_nbytes(out.item, 8) if is_coll(out) else 8
        return n_buckets * bpr
    if op == "vec.HashJoinDirect":
        # the direct table: one int32 build-row index per join bucket
        # (plus the out-of-domain spill slot)
        nb = ins.param("num_buckets")
        domains = ins.param("key_domains")
        if domains is not None:
            nb = 1
            for lo, hi in domains:
                nb *= int(hi) - int(lo) + 1
        return (int(nb or 0) + 1) * 4
    if op == "vec.FusedJoinGroupAgg":
        # direct join table + the dense group-bucket accumulator rows
        nbj = int(ins.param("join_num_buckets") or 0)
        nbg = int(ins.param("num_buckets") or 0)
        out = ins.outputs[0].type
        bpr = item_nbytes(out.item, 8) if is_coll(out) else 8
        return (nbj + 1) * 4 + nbg * bpr
    if op in ("vec.DictEncode", "vec.DictDecode"):
        # the static dictionary tables shipped with the instruction (remap
        # rank tables / sorted value tables) plus the re-encoded key
        # columns: one i32 per row per encoded column
        table_bytes = 0
        for t in (ins.param("tables") or ()):
            size = getattr(t, "size", None)
            itemsize = getattr(getattr(t, "dtype", None), "itemsize", 4)
            table_bytes += int(size if size is not None else len(t)) * itemsize
        n_cols = len(tuple(ins.param("cols") or ()))
        t0 = ins.inputs[0].type if ins.inputs else None
        rows = int(t0.attr("max_count") or 0) if t0 is not None and is_coll(t0) else 0
        return table_bytes + n_cols * rows * 4
    if op == "vec.SortByKey":
        # permutation indices + a gathered copy of the block
        return sum(_reg_bytes(r) for r in ins.inputs)
    if op == "mesh.ExchangeByKey":
        # send + receive buffers, each a full shard block
        return 2 * sum(_reg_bytes(r) for r in ins.inputs)
    if op == "mesh.AllGatherVec":
        n = int(ins.param("n", 1) or 1)
        return n * sum(_reg_bytes(r) for r in ins.inputs)
    return 0


def _chunk_count(ins: Instruction) -> int:
    """How many copies of a nested body run concurrently."""
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


def _program_peak(program: Program) -> Tuple[int, str, list]:
    peak, site, sites = 0, "(empty)", []
    for ins in program.body:
        nested = [p for p in
                  (ins.param("P"), ins.param("Pthen"), ins.param("Pelse"))
                  if p is not None]
        if ins.opcode in ("cf.ConcurrentExecute", "mesh.MeshExecute"):
            inner_peak = max((_program_peak(p)[0] for p in nested), default=0)
            footprint = (_chunk_count(ins) * inner_peak
                         + sum(_reg_bytes(r) for r in ins.inputs)
                         + sum(_reg_bytes(r) for r in ins.outputs))
        elif nested:  # cf.Loop / cf.While / cf.Cond / cf.Call: one body live
            footprint = max(_program_peak(p)[0] for p in nested)
        else:
            footprint = (sum(_reg_bytes(r) for r in ins.inputs)
                         + sum(_reg_bytes(r) for r in ins.outputs)
                         + _scratch_bytes(ins))
        sites.append((ins.opcode, footprint))
        if footprint > peak:
            peak, site = footprint, ins.opcode
    return peak, site, sites


def estimate_peak_bytes(program: Program) -> ResourceEstimate:
    """Estimate the peak working set of a (lowered) program."""
    peak, site, sites = _program_peak(program)
    sites.sort(key=lambda kv: -kv[1])
    return ResourceEstimate(peak_bytes=int(peak), peak_site=site,
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
