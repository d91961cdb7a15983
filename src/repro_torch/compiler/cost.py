"""Cost model for choosing between alternative physical lowerings.

Tupleware's observation (and Flare's, for native Spark plans) is that a
*lightweight* cost model choosing between execution strategies is where
compiled analytics wins — the model only has to rank a handful of candidate
plans, not predict wall times.  Costs are abstract "byte-ops":

  * local work:   rows × bytes/row          (× log rows for sorts)
  * network work: rows × bytes/row × C_NET  (gathers, exchanges)
  * collectives:  fixed startup A_COLL      (all-to-all / all-reduce latency)

Work inside a ``MeshExecute``/``ConcurrentExecute`` body is costed once —
it runs on every shard *in parallel* — while work after a ``cf.Merge`` of a
mesh output runs on the full gathered data on one device.  That asymmetry
is exactly what separates *gather-then-aggregate* from
*exchange-by-key + per-shard aggregation*.

Estimated costs are calibrated into seconds by :class:`CostCalibration`,
an EMA over the driver's measured compile+pass observations
(``PassRecord`` history); the calibration is persisted by the plan store so
estimates improve across processes.  Calibration scales the reported
seconds — it never reorders candidates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..core.program import Instruction, Program
from .stats import Statistics, StatsEnv, propagate

__all__ = [
    "estimate_cost", "CostModel", "CostCalibration",
    "Candidate", "PlanDecision", "CALIBRATION", "EXEC_CALIBRATION",
]

#: relative cost of moving one byte across the interconnect vs touching it
C_NET = 8.0
#: fixed startup cost of a collective, in local byte-op units — the
#: equivalent of ~32 KiB over the interconnect, so a collective only pays
#: off once it saves that much gathered/serialized traffic
A_COLL = 262_144.0


class CostModel:
    """Walk a lowered program under propagated statistics and sum op costs."""

    def __init__(self, net: float = C_NET, coll: float = A_COLL) -> None:
        self.net = net
        self.coll = coll

    # ------------------------------------------------------------------
    def estimate(self, program: Program, stats: Optional[Statistics] = None) -> float:
        env = propagate(program, stats)
        return self._program_cost(program, env)

    # ------------------------------------------------------------------
    def _program_cost(self, program: Program, env: StatsEnv) -> float:
        producers = program.producers()
        total = 0.0
        for ins in program.body:
            total += self._op_cost(ins, program, env, producers)
        return total

    def _op_cost(self, ins: Instruction, program: Program, env: StatsEnv,
                 producers: Dict[str, Instruction]) -> float:
        op = ins.opcode
        args = [env.get(program, r) for r in ins.inputs]
        outs = [env.get(program, r) for r in ins.outputs]
        rows = args[0].rows if args else 1.0
        bpr = args[0].bytes_per_row if args else 8.0

        if op in ("cf.ConcurrentExecute", "mesh.MeshExecute"):
            # SPMD: every shard runs the body concurrently — cost it once
            return self._program_cost(ins.param("P"), env)

        if op in ("vec.SortByKey", "rel.OrderBy"):
            return rows * max(math.log2(max(rows, 2.0)), 1.0) * bpr

        if op in ("vec.GroupAggSorted", "rel.GroupByAggr"):
            return 2.0 * rows * bpr

        if op == "vec.GroupAggDirect":
            # sort-free dense buckets: one pass over the rows plus the
            # bucket-table epilogue (build + compact) — the term that grows
            # with the key domain and hands the win back to the sorted tier
            # at high NDV
            nb = float(ins.param("num_buckets") or 1.0)
            return rows * bpr + 2.0 * nb * outs[0].bytes_per_row

        if op == "vec.DictEncode":
            # rank lookup per encoded key column: log2(card) searchsorted
            # probes of 4-byte ranks, or one O(1) gather through the dense
            # remap table — the cost the elided sort has to beat
            total = 0.0
            for mode, card in zip(ins.param("modes"), ins.param("cards")):
                per = (max(math.log2(max(float(card), 2.0)), 1.0)
                       if mode == "searchsorted" else 1.0)
                total += rows * 4.0 * per
            return total

        if op == "vec.DictDecode":
            # decode-late: one gather per surviving key column on the
            # compacted output, never the full input
            return outs[0].rows * 4.0 * len(tuple(ins.param("cols")))

        if op in ("vec.MergeJoinSorted", "rel.Join"):
            right = args[1] if len(args) > 1 else args[0]
            probe = rows * max(math.log2(max(right.rows, 2.0)), 1.0) * bpr
            return probe + right.rows * right.bytes_per_row

        if op == "vec.HashJoinDirect":
            # sort-free direct table: one linear pass over each side plus the
            # dense-table build/probe epilogue — the bucket term grows with
            # the key domain and hands the win back to the sorted tier at
            # high NDV, exactly like GroupAggDirect
            right = args[1] if len(args) > 1 else args[0]
            nb = float(ins.param("num_buckets") or 1.0)
            if ins.param("key_domains") is not None:
                nb = 1.0
                for lo, hi in ins.param("key_domains"):
                    nb *= float(hi) - float(lo) + 1.0
            # the per-bucket weight is the i32 slot ×8: a scatter-min build
            # plus a gathered probe cost well more per bucket than the
            # groupby tier's segment-sum rows (calibrated on the BENCH_8
            # cells so the sorted tier takes back sparse ~2^19 domains)
            return (rows * bpr + right.rows * right.bytes_per_row
                    + 8.0 * nb * 4.0)

        if op == "vec.FusedJoinGroupAgg":
            # single fused pass: probe side + build side touched once, plus
            # the join direct table and the group bucket epilogue; no join
            # materialization / compact term at all
            right = args[1] if len(args) > 1 else args[0]
            nbj = float(ins.param("join_num_buckets") or 1.0)
            nbg = float(ins.param("num_buckets") or 1.0)
            return (rows * bpr + right.rows * right.bytes_per_row
                    + 8.0 * nbj * 4.0 + 2.0 * nbg * outs[0].bytes_per_row)

        if op == "cf.Merge":
            src = producers.get(ins.inputs[0].name)
            gathered = outs[0].rows * outs[0].bytes_per_row
            if src is not None and src.opcode == "mesh.MeshExecute":
                # gather: every shard's chunk crosses the interconnect and
                # all downstream work on the result is single-device
                return gathered * self.net
            return gathered

        if op == "mesh.ExchangeByKey":
            return self.coll + rows * bpr * self.net

        if op == "mesh.AllReduce":
            return self.coll + rows * bpr * self.net

        if op == "mesh.AllGatherVec":
            return self.coll + outs[0].rows * outs[0].bytes_per_row * self.net

        if op in ("cf.Split", "cf.Broadcast", "cf.TakeChunk"):
            return rows * bpr * 0.1

        if op in ("rel.Scan", "vec.ScanVec", "df.Source", "la.Literal"):
            return 0.0

        # default: one pass over the input rows
        return rows * bpr


_DEFAULT_MODEL = CostModel()


def estimate_cost(program: Program, stats: Optional[Statistics] = None,
                  model: Optional[CostModel] = None) -> float:
    """Estimated cost (abstract byte-op units) of a lowered program."""
    return (model or _DEFAULT_MODEL).estimate(program, stats)


# ---------------------------------------------------------------------------
# calibration: abstract units → seconds, from measured observations
# ---------------------------------------------------------------------------


@dataclass
class CostCalibration:
    """EMA mapping of estimated cost units to measured seconds."""

    scale: float = 0.0
    n: int = 0

    def update(self, est_cost: float, measured_s: float) -> None:
        if est_cost <= 0.0 or measured_s <= 0.0:
            return
        obs = measured_s / est_cost
        self.scale = obs if self.n == 0 else 0.8 * self.scale + 0.2 * obs
        self.n += 1

    def seconds(self, est_cost: float) -> Optional[float]:
        return est_cost * self.scale if self.n else None

    def to_dict(self) -> Dict[str, Any]:
        return {"scale": self.scale, "n": self.n}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "CostCalibration":
        return CostCalibration(scale=float(d.get("scale", 0.0)),
                               n=int(d.get("n", 0)))


#: process-wide calibration, seeded from the plan store when one is used
CALIBRATION = CostCalibration()

#: the runtime sibling of :data:`CALIBRATION`: abstract plan-cost units →
#: measured *execution* seconds, fed by traced executions through
#: ``repro_torch.obs.feedback.FEEDBACK`` — the measured leg of the
#: estimate-vs-actual feedback loop
EXEC_CALIBRATION = CostCalibration()


# ---------------------------------------------------------------------------
# decisions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Candidate:
    """One enumerated lowering alternative and its estimated cost."""

    strategy: Tuple[Tuple[str, str], ...]
    est_cost: float
    size: int
    lower_s: float

    def label(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.strategy) or "(default)"


@dataclass(frozen=True)
class PlanDecision:
    """Outcome of the costed search: candidates, winner, provenance."""

    candidates: Tuple[Candidate, ...]
    chosen: int
    source: str  # "search" | "store" | "default"
    est_seconds: Optional[float] = None
    #: measured compile+lowering seconds of the winner (the PassRecord
    #: observation that feeds calibration) — NOT plan execution time
    measured_s: Optional[float] = None

    @property
    def winner(self) -> Candidate:
        return self.candidates[self.chosen]

    def render(self) -> str:
        lines = [f"cost search ({self.source}): "
                 f"{len(self.candidates)} candidate(s), "
                 f"winner {self.winner.label()}",
                 "| strategy | est cost | IR size | lower ms | chosen |",
                 "|---|---:|---:|---:|:---:|"]
        for i, c in enumerate(self.candidates):
            mark = "✓" if i == self.chosen else ""
            lines.append(f"| {c.label()} | {c.est_cost:,.0f} | {c.size} "
                         f"| {c.lower_s * 1e3:.3f} | {mark} |")
        est = (f"{self.est_seconds * 1e3:.3f} ms" if self.est_seconds
               else "uncalibrated")
        meas = (f"{self.measured_s * 1e3:.3f} ms" if self.measured_s
                else "n/a")
        lines.append(f"estimated {est} vs measured compile {meas}")
        return "\n".join(lines)

    def records(self) -> List[Dict[str, Any]]:
        return [
            {"strategy": dict(c.strategy), "est_cost": c.est_cost,
             "size": c.size, "lower_s": c.lower_s,
             "chosen": i == self.chosen, "source": self.source,
             "est_seconds": self.est_seconds, "measured_s": self.measured_s}
            for i, c in enumerate(self.candidates)
        ]
