"""The port's admission model (``repro_torch/robust/admission.py``) holds the
port's own allocations (ROADMAP Queue 3 item 14): on the CPU, the peak
that ``MemTracker`` sees a plan's first run allocate beyond its sources
stays at or below ``estimate_peak_bytes``.  The card's side (the caching
allocator's rise) is ``chip_smoke.py``'s admission phase.

* the six TPC-H queries at sf=0.01 under the port's tiers, the sorted
  tiers, ``encode=dict`` and ``fuse=unfused``, sequential and
  ``parallel=4``;
* the wide group-by of 2^16 rows over keys in [0, 10^6) (item 14's
  smallest input, whose sorted plan the JAX-shaped model priced at a
  twelfth of what the card allocated) under both group-by tiers;
* the cost search under a budget keeps exactly the candidates the model
  admits, whichever tier that is.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed._tools.mem_tracker import MemTracker  # noqa: E402

from repro_torch.compiler import PlanCache  # noqa: E402
from repro_torch.frontends.dataflow import Context, count_, sum_  # noqa: E402
from repro_torch.relational import tpch  # noqa: E402
from repro_torch.robust.admission import estimate_peak_bytes  # noqa: E402

STRATEGIES = {"port": None, "sorted": {"groupby": "sorted", "join": "sorted"},
              "dict": {"encode": "dict"}, "unfused": {"fuse": "unfused"}}


@pytest.fixture(scope="module")
def tpch_ctx():
    return tpch.make_context(tpch.generate(sf=0.01))


def measured_rise(res, sources) -> int:
    """Bytes the tracked tensors rose to, above the sources, while the
    plan's first run ran on the CPU."""
    mt = MemTracker()
    mt.track_external(*[t for v in sources.values() for t in (*v.cols.values(), v.valid)])
    with mt:
        base = sum(d.get("Total", 0) for d in mt.get_tracker_snapshot("current").values())
        res(sources)
    return sum(d.get("Total", 0) for d in mt.get_tracker_snapshot("peak").values()) - base


@pytest.mark.parametrize("parallel", [None, 4])
@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("q", list(tpch.QUERIES))
def test_tpch_plans_allocate_within_their_estimate(tpch_ctx, q, strategy, parallel):
    res = tpch_ctx.compile(tpch.QUERIES[q](tpch_ctx), device="cpu", cache=False,
                           strategy=STRATEGIES[strategy], parallel=parallel)
    est = estimate_peak_bytes(res.program)
    rise = measured_rise(res, tpch_ctx.sources("cpu"))
    assert 0 < rise <= est.peak_bytes, (rise, est.render())


def _wide():
    rng = np.random.default_rng(0)
    n, span = 1 << 16, 1_000_000
    ctx = Context(pad_to=1024)
    ctx.register("w", {"k": rng.integers(0, span, n).astype(np.int32),
                       "v": rng.normal(size=n).astype(np.float32)})
    frame = ctx.table("w").group_by("k", max_groups=n).agg(sum_("v").as_("s"),
                                                           count_().as_("n"))
    return ctx, frame


@pytest.mark.parametrize("strategy", [{"groupby": "sorted"}, {"groupby": "direct"},
                                      {"groupby": "sorted", "encode": "dict"}])
def test_wide_group_by_allocates_within_its_estimate(strategy):
    """Item 14's input: the sorted plan's chained sorts (int64
    permutations, every column gathered) and its segment sum's chunk
    partials (64 chunks × 65,537 groups) are priced."""
    ctx, frame = _wide()
    res = ctx.compile(frame, device="cpu", cache=False, strategy=strategy)
    est = estimate_peak_bytes(res.program)
    rise = measured_rise(res, ctx.sources("cpu"))
    assert rise <= est.peak_bytes, (rise, est.render())
    if strategy["groupby"] == "sorted":
        assert rise > 1_572_864  # what the JAX-shaped model estimated for this plan


def test_cost_search_keeps_the_candidates_the_model_admits(tpch_ctx):
    """Q4 under a budget of the cheaper tier's largest estimate: the search
    keeps exactly the candidates estimated within it, and one byte below
    every estimate rejects all; which tier is cheaper is the model's."""
    from repro_torch.robust.admission import AdmissionError

    q4 = tpch.q4(tpch_ctx)
    search = tpch_ctx.compile(q4, device="cpu", cache=False, optimize="cost")
    ests = {c.strategy: estimate_peak_bytes(tpch_ctx.compile(
        q4, device="cpu", cache=False, strategy=dict(c.strategy)).program).peak_bytes
        for c in search.decision.candidates}
    by_tier = {}
    for s, e in ests.items():
        by_tier.setdefault(dict(s)["groupby"], []).append(e)
    budget = min(max(es) for es in by_tier.values())
    res = tpch_ctx.compile(q4, device="cpu", cache=PlanCache(), optimize="cost",
                           memory_budget=budget)
    kept = {c.strategy for c in res.decision.candidates}
    assert kept == {s for s, e in ests.items() if e <= budget}
    assert res.resources.peak_bytes <= budget
    with pytest.raises(AdmissionError):
        tpch_ctx.compile(q4, device="cpu", cache=False, optimize="cost", guard=False,
                         memory_budget=min(ests.values()) - 1)
