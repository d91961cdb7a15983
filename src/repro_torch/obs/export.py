"""Trace exporters: Chrome-trace JSON (chrome://tracing / Perfetto) + metrics.

The Chrome trace event format is the lowest-common-denominator viewer
interchange: a ``{"traceEvents": [...]}`` object whose entries are complete
("ph": "X") events with microsecond timestamps.  Nesting is implicit —
events on the same pid/tid whose intervals contain each other render as a
flame graph, which is exactly what :class:`~repro_torch.obs.trace.Span`
records.  The port's copy of ``repro/obs/export.py``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from .trace import Tracer, get_tracer

__all__ = ["chrome_trace", "write_chrome_trace"]


def chrome_trace(tracer: Optional[Tracer] = None,
                 process_name: str = "repro-cvm") -> Dict[str, Any]:
    """Render a tracer's spans/events as a Chrome trace event object."""
    tracer = tracer or get_tracer()
    pid = os.getpid()
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    tids = {}
    for span in tracer.spans:
        tid = tids.setdefault(span.tid, len(tids))
        args = {k: _jsonable(v) for k, v in span.args.items()}
        if span.parent_id is not None:
            args["parent"] = span.parent_id
        events.append({
            "name": span.name,
            "cat": span.cat or "default",
            "ph": "X",
            "pid": pid,
            "tid": tid,
            "ts": (span.t0 - tracer.epoch) * 1e6,
            "dur": span.dur_s * 1e6,
            "id": span.span_id,
            "args": args,
        })
    for ev in tracer.events:
        events.append({
            "name": ev["name"], "cat": "event", "ph": "i", "s": "p",
            "pid": pid, "tid": 0, "ts": ev["ts"] * 1e6,
            "args": {k: _jsonable(v) for k, v in ev.items()
                     if k not in ("name", "ts")},
        })
    for name, value in sorted(tracer.counters.items()):
        events.append({
            "name": name, "cat": "counter", "ph": "C", "pid": pid, "tid": 0,
            "ts": 0.0, "args": {"value": value},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"epoch_wall_s": tracer.epoch_wall,
                         "metrics": tracer.metrics()}}


def write_chrome_trace(path: Union[str, Path],
                       tracer: Optional[Tracer] = None,
                       process_name: str = "repro-cvm") -> Path:
    """Write the Chrome-trace JSON; load the file in chrome://tracing."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace(tracer, process_name), indent=1))
    return path


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
