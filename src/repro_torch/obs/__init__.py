"""``repro_torch.obs`` — low-overhead observability for the serving stack
(the port's own copy of ``repro.obs``).

Three pieces, wired together:

  * :mod:`repro_torch.obs.trace` — a monotonic-clock span tracer.  Stages wrap in
    ``with obs.span("index.fan.stage1", shards=4): ...``; spans nest into a
    per-thread tree, the root mints a process-unique trace id, and finished
    roots flow to registered sinks.  **Disabled by default**: ``span()``
    then returns one shared no-op object — the hot path pays a global load
    and a branch, nothing else.
  * :mod:`repro_torch.obs.metrics` — a process-global registry of counters,
    gauges, and fixed-bucket latency histograms (p50/p95/p99 summaries,
    ``snapshot()`` dict, Prometheus text exposition, optional stdlib HTTP
    scrape endpoint).  Counters are always live (they are the serving
    stats), histograms fill from spans only while tracing is enabled.
  * :mod:`repro_torch.obs.slowlog` — a bounded worst-N log of query traces,
    attached as a tracer sink and surfaced via ``SketchIndex.stats()``.

``obs.enable()`` / ``obs.disable()`` flip the whole layer.
"""

from __future__ import annotations

from . import metrics, slowlog, trace
from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .slowlog import GLOBAL_SLOW_LOG, SlowQueryLog
from .trace import NULL_SPAN, Span, current_trace_id, span

__all__ = [
    "trace", "metrics", "slowlog",
    "span", "Span", "NULL_SPAN", "current_trace_id",
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SlowQueryLog", "GLOBAL_SLOW_LOG",
    "enable", "disable", "enabled",
]

# the global slow log sees every finished root span (it filters for queries)
trace.add_sink(GLOBAL_SLOW_LOG.offer)


def enable(profiler_scope: bool = False) -> None:
    """Turn tracing (and with it span-fed histograms + the slow-query log)
    on.  ``profiler_scope=True`` additionally marks each span as a
    ``torch.profiler.record_function`` range, for profiler traces of the
    card."""
    trace.enable()
    trace.set_profiler_scope(profiler_scope)


def disable() -> None:
    trace.disable()
    trace.set_profiler_scope(False)


def enabled() -> bool:
    return trace.enabled()
