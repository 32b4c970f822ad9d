"""Exporters: Chrome-trace/Perfetto JSON for spans, flat JSON for metrics.

``export_chrome_trace`` writes the standard ``traceEvents`` object format
(complete ``"X"`` events plus thread-name metadata), which loads directly
in Perfetto / ``chrome://tracing`` — one query renders as a flame graph of
nested shortlist / rerank child spans under the query root.  Span
attributes ride along in each event's ``args`` (plus the span/parent ids,
so tooling can rebuild the exact tree without relying on time
containment).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

TRACE_SCHEMA = "repro.obs.trace/v1"


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return v.item()        # numpy scalars / one-element tensors
    except (AttributeError, RuntimeError, ValueError):
        return repr(v)          # not a one-element scalar


def chrome_trace_events(spans: Optional[List[_trace.SpanRecord]] = None
                        ) -> list:
    """Spans (default: the whole trace buffer) as chrome-trace events."""
    spans = _trace.get_spans() if spans is None else list(spans)
    pid = os.getpid()
    events = []
    for tid, name in sorted({(s.thread_id, s.thread_name) for s in spans}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    for s in spans:
        args = {k: _jsonable(v) for k, v in s.attrs.items()}
        args["span_id"] = s.span_id
        args["parent_id"] = s.parent_id
        events.append({
            "ph": "X", "name": s.name, "cat": "repro",
            "pid": pid, "tid": s.thread_id,
            "ts": (s.t_start + _trace._EPOCH_UNIX) * 1e6,   # µs
            "dur": s.duration * 1e6,
            "args": args,
        })
    return events


def export_chrome_trace(path: str,
                        spans: Optional[List[_trace.SpanRecord]] = None
                        ) -> int:
    """Write spans as a Perfetto-loadable chrome trace; returns the
    number of span events written."""
    events = chrome_trace_events(spans)
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"schema": TRACE_SCHEMA,
                         "dropped_spans": _trace.dropped_spans()}}
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for e in events if e["ph"] == "X")


def export_metrics(path: str,
                   reg: Optional[_metrics.MetricsRegistry] = None) -> dict:
    """Dump a registry (default: the process-wide one) to ``path``."""
    return (reg or _metrics.registry()).dump(path)
