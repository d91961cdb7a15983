"""The compile driver of the torch port, copied from ``repro.compiler``.

* :mod:`~repro_torch.compiler.targets` — the ``local``, ``stream``,
  ``spmd``, ``multipod`` and ``interp`` targets, their lowering paths and
  the strategy ``Choice`` points (``groupby`` direct | sorted, ``join``
  hash | sorted, ``encode`` raw | dict, ``fuse`` fused | unfused, and on
  the mesh targets ``grouped-recombine`` gather | exchange);
* :mod:`~repro_torch.compiler.driver` — ``compile()`` with per-pass
  records, the plan cache (``PlanCache``, ``PLAN_CACHE``), the
  ``optimize="cost"`` search, admission, the fallback ladder and the
  first-execution guard;
* :mod:`~repro_torch.compiler.fingerprint` — alpha-invariant program
  fingerprints (the cache's content address);
* :mod:`~repro_torch.compiler.stats` — table statistics and their
  propagation;
* :mod:`~repro_torch.compiler.cost` — the cost model, calibration and plan
  decisions;
* :mod:`~repro_torch.compiler.store` — the on-disk plan-metadata store.

The ``local`` target's fixed path runs, under ``DEFAULT_STRATEGY``
(direct/hash, where the JAX package binds the sorted tiers):

    CommonSubexpressionElimination, DeadCodeElimination
    → Parallelize(n=parallel)                      (when parallel > 1)
    → LowerRelToVec(catalog with statistics, groupby/join/encode)
    → FuseSelectAgg, FuseSelectGroupAgg, FuseJoinGroupAgg, DeadCodeElimination
                                                   (fuse=fused only)

and hands the program to the eager torch backend.  The ``spmd`` and
``multipod`` targets add ``LowerToMesh`` (+ ``PushCombineIntoMesh`` under
``collectives``) and the ``grouped-recombine`` choice, and hand the program
to ``backends/spmd.py`` on a mesh of ``torch.distributed`` ranks.
"""

from .cost import (  # noqa: F401
    CALIBRATION,
    EXEC_CALIBRATION,
    Candidate,
    CostCalibration,
    CostModel,
    PlanDecision,
    estimate_cost,
)
from .driver import (  # noqa: F401
    PLAN_CACHE,
    CompileResult,
    PassRecord,
    PlanCache,
    compile,
    disable_auto_replan,
    enable_auto_replan,
    normalize_strategy,
    program_size,
    run_passes,
)
from .fingerprint import canonicalize, fingerprint, fingerprint_value  # noqa: F401
from .stats import (  # noqa: F401
    Dictionary, RegStats, Statistics, TableStats, propagate, stats_from_columns,
)
from .store import PlanStore, default_store  # noqa: F401
from .targets import (  # noqa: F401
    DEFAULT_STRATEGY,
    Choice,
    CompileOptions,
    Stage,
    Target,
    available_targets,
    get_target,
    register_target,
)
