"""Guarded compilation and execution for the port, copied from
``repro/robust``:

* ``inject`` — seeded fault injection at the wired points (the driver's
  pass loop, PlanStore I/O, backend compile/execute, the serve step, the
  stream consumer's batch, snapshot and restore);
* ``fallback`` — the ladder the driver walks when a chosen plan fails
  (safer strategy variants, then the numpy interpreter);
* ``admission`` — a plan's estimated peak bytes against a byte budget;
* ``retry`` — bounded retries with backoff, straggler detection, and
  deadlines.
"""

from .admission import (  # noqa: F401
    AdmissionError,
    ResourceEstimate,
    admit,
    default_budget,
    estimate_peak_bytes,
)
from .fallback import DegradedWarning, SAFE_VARIANTS, degrade, fallback_ladder  # noqa: F401
from .inject import (  # noqa: F401
    FaultRule,
    InjectedFault,
    InjectionPoint,
    clear_faults,
    inject,
    maybe_inject,
    register_point,
    registered_points,
)
from .retry import (  # noqa: F401
    Deadline, Ewma, RetryPolicy, StragglerDetector, call_with_retry)
