"""Observability for the port, copied from ``repro/obs``: the span tracer,
counters, histograms and structured warnings (``trace``), the Chrome-trace
export (``export``), and the measured cardinalities joined against the
cost model's estimates (``feedback``)."""

from .export import chrome_trace, write_chrome_trace  # noqa: F401
from .feedback import (  # noqa: F401
    FEEDBACK,
    TAPPED_OPS,
    FeedbackCatalog,
    OpObservation,
    RuntimeProfile,
    TapRecord,
    build_profile,
    tap_key,
)
from .trace import (  # noqa: F401
    NULL_SPAN,
    DegradedWarning,
    ObsWarning,
    Span,
    Tracer,
    get_tracer,
    set_tracer,
    tracing,
    warn_event,
)
