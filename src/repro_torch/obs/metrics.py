"""Process-global metrics registry: counters, gauges, latency histograms.

The port's own copy of ``repro.obs.metrics``: pure Python, with the same
fixed buckets, summaries, exposition formats and metric names, so one
operator dashboard reads either package.

All instruments are thread-safe (one lock per instrument — the serving
stack's writers are the batcher's flusher threads, the background compactor,
and the rebalance hook, all of which increment concurrently).  Reads
(``snapshot()``, ``prometheus()``) take a consistent per-instrument view but
never block writers for long.

Histograms use fixed upper-bound buckets (log-spaced milliseconds by
default) so ``observe`` is an O(log B) bisect with no allocation, and
percentiles are computed from the bucket counts with linear interpolation
inside the winning bucket — deterministic for a deterministic input stream,
which the tests exploit with an injectable clock.

``REGISTRY`` is the process-global default; ``MetricsRegistry`` instances
can be created standalone for tests.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "DEFAULT_BUCKETS_MS"]

# log-spaced latency buckets, in milliseconds: 10us .. ~100s.  Wide enough
# for a strip loop and a full compaction pass to land in the interior.
DEFAULT_BUCKETS_MS: Tuple[float, ...] = tuple(
    round(base * 10.0 ** exp, 6)
    for exp in range(-2, 5)
    for base in (1.0, 2.5, 5.0)
)


class Counter:
    """Monotonic counter.  ``inc`` is atomic under the instrument lock —
    safe for the batcher's read-modify-write flush accounting."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with percentile summaries.

    ``buckets`` are inclusive upper bounds; an implicit +inf bucket catches
    the tail.  ``percentile(p)`` finds the bucket holding the p-quantile
    observation and interpolates linearly inside it (the +inf bucket reports
    its lower bound — there is nothing to interpolate toward).
    """

    __slots__ = ("name", "help", "buckets", "_lock", "_counts", "_count",
                 "_sum", "_min", "_max")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError("buckets must be sorted, unique, non-empty")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +inf bucket
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self):
        """[(upper_bound, cumulative_count), ...] ending with the +inf
        bucket — the Prometheus ``_bucket`` series, one consistent read."""
        with self._lock:
            counts = list(self._counts)
            count = self._count
        out, cum = [], 0
        for ub, c in zip(self.buckets, counts):
            cum += c
            out.append((ub, cum))
        out.append((float("inf"), count))
        return out

    def percentile(self, p: float) -> float:
        """p in [0, 100].  0.0 when empty (histograms report, never raise)."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        with self._lock:
            counts = list(self._counts)
            total = self._count
            lo_obs, hi_obs = self._min, self._max
        if total == 0:
            return 0.0
        # rank of the p-quantile observation, 1-based ceil (p50 of 10 -> 5th)
        rank = max(1, int(-(-p * total // 100)))
        seen = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i == len(self.buckets):  # +inf bucket: nothing to
                    return hi_obs           # interpolate toward
                hi = self.buckets[i]
                lo = self.buckets[i - 1] if i > 0 else min(lo_obs, hi)
                est = lo + (hi - lo) * (rank - seen) / c
                # never report outside the observed range
                return max(min(est, hi_obs), lo_obs)
            seen += c
        return hi_obs  # unreachable: rank <= total

    def summary(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
        return {
            "count": count,
            "sum": round(total, 6),
            "mean": round(total / count, 6) if count else 0.0,
            "p50": round(self.percentile(50), 6),
            "p95": round(self.percentile(95), 6),
            "p99": round(self.percentile(99), 6),
        }

    def snapshot(self):
        return self.summary()


class MetricsRegistry:
    """Name -> instrument map.  ``counter``/``gauge``/``histogram`` are
    get-or-create and idempotent, so instrumented call sites never need a
    registration phase (or a module import order).

    ``REGISTRY`` (module-level) is the process-global instance every layer
    of the serving stack reports into; ``reset()`` exists for test
    isolation only.

    Example::

        >>> from repro_torch.obs.metrics import REGISTRY
        >>> REGISTRY.counter("demo.requests", "requests served").inc()
        >>> REGISTRY.counter("demo.requests").value
        1
        >>> REGISTRY.histogram("demo.latency_ms").observe(3.2)
        >>> REGISTRY.histogram("demo.latency_ms").summary()["count"]
        1
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, factory, kind):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help), Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS_MS) -> Histogram:
        return self._get(name, lambda: Histogram(name, help, buckets),
                         Histogram)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every instrument (test isolation hook)."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """{name: value|summary} — JSON-friendly, one consistent read per
        instrument."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4) of every instrument.

        Metric names are sanitized (dots -> underscores); histograms emit
        cumulative ``_bucket`` series plus ``_count``/``_sum``, counters
        ``_total``, gauges bare.
        """
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in items:
            pname = name.replace(".", "_").replace("-", "_")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname}_total counter")
                if m.help:
                    lines.append(f"# HELP {pname}_total {m.help}")
                lines.append(f"{pname}_total {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {pname} histogram")
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                cum = m.cumulative()
                for ub, c in cum[:-1]:
                    lines.append(f'{pname}_bucket{{le="{ub:g}"}} {c}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum[-1][1]}')
                lines.append(f"{pname}_sum {m.sum}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


REGISTRY = MetricsRegistry()


def serve_http(port: int, registry: Optional[MetricsRegistry] = None,
               host: str = "127.0.0.1"):
    """Start a daemon-thread HTTP server exposing ``/metrics`` (Prometheus
    text) and ``/metrics.json`` (the ``snapshot()`` dict).  Returns the
    server; ``server.shutdown()`` stops it.  Stdlib only — no new deps.

    Example::

        >>> from repro_torch.obs.metrics import serve_http
        >>> server = serve_http(0)          # port 0: OS-assigned free port
        >>> port = server.server_address[1]
        >>> # curl http://127.0.0.1:<port>/metrics
        >>> server.shutdown()
    """
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry if registry is not None else REGISTRY

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path.split("?")[0] == "/metrics":
                body = reg.prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?")[0] == "/metrics.json":
                body = json.dumps(reg.snapshot(), indent=1).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet: scrapes are not server logs
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="obs-metrics-http")
    thread.start()
    return server
