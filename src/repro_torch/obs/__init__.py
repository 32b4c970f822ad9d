"""repro_torch.obs — dependency-free tracing, metrics, and profiling substrate
(port of ``repro.obs``).

Three pieces (see the submodule docstrings for the full contracts):

* **Spans** (``repro_torch.obs.trace``): nested, thread-aware stage timers.
  ``with obs.span("engine.fit") as sp: ...`` or
  ``@obs.traced(device_sync=True)``; ``device_sync`` fences CUDA work
  with ``torch.cuda.synchronize`` so dispatch isn't mistaken for compute.
  Spans always *time*; ``obs.disable()`` only stops buffer recording.
* **Metrics** (``repro_torch.obs.metrics``): a lock-consistent process-wide
  registry of counters, gauges, and log-bucket latency histograms with
  exact-bound p50/p95/p99 (no sample retention).
* **Exporters** (``repro_torch.obs.export``): ``export_chrome_trace(path)``
  (Perfetto flame graphs) and ``export_metrics(path)`` (the flat JSON
  metrics schema the reference uses).
"""

from repro_torch.obs.export import (chrome_trace_events,
                                    export_chrome_trace, export_metrics)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     delta_counts, delta_mean,
                                     delta_quantile, registry)
from repro_torch.obs.trace import (Span, SpanRecord, clear, current_span,
                                   disable, dropped_spans, enable, get_spans,
                                   is_enabled, set_capacity, span, traced)


def counter(name: str) -> Counter:
    """Process-wide counter (shorthand for ``registry().counter``)."""
    return registry().counter(name)


def gauge(name: str) -> Gauge:
    """Process-wide gauge."""
    return registry().gauge(name)


def histogram(name: str, buckets=None) -> Histogram:
    """Process-wide histogram."""
    return registry().histogram(name, buckets)


def reset_metrics() -> None:
    """Drop every instrument in the process-wide registry (benchmarks
    call this between sweep sizes; tests call it for isolation)."""
    registry().reset()


__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "SpanRecord", "chrome_trace_events", "clear", "counter",
    "current_span", "delta_counts", "delta_mean", "delta_quantile",
    "disable", "dropped_spans", "enable",
    "export_chrome_trace", "export_metrics", "gauge", "get_spans",
    "histogram", "is_enabled", "registry", "reset_metrics", "set_capacity",
    "span", "traced",
]
