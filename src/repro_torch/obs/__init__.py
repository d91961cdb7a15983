"""Tracing for the port: the span tracer, counters and histograms
(``trace``) and the Chrome-trace export (``export``), copied from
``repro/obs``.  The JAX package's cardinality feedback is not ported."""

from .export import chrome_trace, write_chrome_trace  # noqa: F401
from .trace import (  # noqa: F401
    NULL_SPAN,
    Span,
    Tracer,
    get_tracer,
    set_tracer,
    tracing,
)
