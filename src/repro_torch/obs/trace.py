"""Monotonic-clock span tracer: nested spans, per-query trace IDs, sinks.

The serving stack wraps its stages in ``with obs.trace.span("name"): ...``
blocks.  When tracing is **disabled** (the default) ``span()`` returns one
shared no-op singleton — no object allocation, no clock read, no
thread-local touch — so the instrumented hot path costs one global load and
one branch per stage.  When **enabled**, spans form a per-thread tree: the
first span opened on a thread becomes a trace root and mints a
process-unique trace id; children attach to the innermost open span, and a
finished root is handed to every registered sink (the slow-query log, test
collectors).

The micro-batcher's coalescing makes one flush serve many callers; the
flusher's trace therefore carries the whole batch (its root span records the
batch size), which is the honest accounting — the engine ran once.

``set_profiler_scope(True)`` additionally enters
``torch.profiler.record_function(name)`` for every real span, so spans show
up as ranges in ``torch.profiler`` traces of the card; it is off by default
because a range is only meaningful while a profiler trace is being captured.

The port's own copy of ``repro.obs.trace``; the profiler passthrough is its
only difference.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, Optional

__all__ = [
    "span", "enable", "disable", "enabled", "set_profiler_scope",
    "current_trace_id", "add_sink", "remove_sink", "Span",
]

_ENABLED = False
_PROFILER_SCOPE = False
_TRACE_IDS = itertools.count(1)  # process-unique, never 0 (0 = "no trace")
_SINKS: List[Callable[["Span"], None]] = []
_tls = threading.local()

# injectable for deterministic tests; real spans read it at enter/exit
clock = time.monotonic


def enable() -> None:
    """Turn the tracer on (module-global; affects all threads)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def set_profiler_scope(on: bool) -> None:
    """Also wrap every real span in ``torch.profiler.record_function``
    (profiler range passthrough).  No effect while tracing is disabled."""
    global _PROFILER_SCOPE
    _PROFILER_SCOPE = bool(on)


def add_sink(fn: Callable[["Span"], None]) -> None:
    """Register a callback invoked with every *finished root* span."""
    if fn not in _SINKS:
        _SINKS.append(fn)


def remove_sink(fn: Callable[["Span"], None]) -> None:
    if fn in _SINKS:
        _SINKS.remove(fn)


def current_trace_id() -> int:
    """Trace id of the innermost open span on this thread (0 outside one)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1].trace_id if stack else 0


class Span:
    """One timed stage.  Truthy (the no-op span is falsy), so hot paths can
    guard attribute work with ``if sp: sp.set(rows=...)`` and pay nothing
    when tracing is off."""

    __slots__ = ("name", "trace_id", "attrs", "t0", "t1", "children",
                 "metric", "_scope")

    def __init__(self, name: str, metric: Optional[str], attrs: dict):
        self.name = name
        self.metric = metric
        self.attrs = attrs
        self.trace_id = 0
        self.t0 = 0.0
        self.t1 = 0.0
        self.children: List[Span] = []
        self._scope = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        if stack:
            parent = stack[-1]
            self.trace_id = parent.trace_id
            parent.children.append(self)
        else:
            self.trace_id = next(_TRACE_IDS)
        stack.append(self)
        if _PROFILER_SCOPE:
            import torch

            self._scope = torch.profiler.record_function(self.name)
            self._scope.__enter__()
        self.t0 = clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = clock()
        if self._scope is not None:
            self._scope.__exit__(exc_type, exc, tb)
            self._scope = None
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        stack = getattr(_tls, "stack", None)
        # pop defensively: an enable()/disable() flip mid-span must not
        # corrupt an unrelated thread's stack
        is_root = False
        if stack and stack[-1] is self:
            stack.pop()
            is_root = not stack
        if self.metric is not None:
            self._observe()
        if is_root:
            for sink in _SINKS:
                sink(self)
        return False

    def _observe(self) -> None:
        from .metrics import REGISTRY

        REGISTRY.histogram(self.metric).observe(self.duration_s * 1e3)

    # ------------------------------------------------------------- export

    def to_dict(self) -> dict:
        """JSON-friendly span tree (relative times in ms)."""
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "duration_ms": round(self.duration_s * 1e3, 4),
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }

    def tree(self, indent: int = 0) -> str:
        """Human-readable nested rendering (slow-query dumps)."""
        attrs = " ".join(f"{k}={v}" for k, v in self.attrs.items())
        line = (f"{'  ' * indent}{self.name} {self.duration_s * 1e3:.2f}ms"
                + (f" [{attrs}]" if attrs else ""))
        return "\n".join([line] + [c.tree(indent + 1) for c in self.children])

    def find(self, name: str) -> List["Span"]:
        """All spans named ``name`` in this subtree (tests, assertions)."""
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out


class _NullSpan:
    """The shared disabled-mode span: every method is a no-op, ``bool`` is
    False, and ``span()`` returns this exact object — the disabled hot path
    allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


def span(name: str, metric: Optional[str] = None, **attrs):
    """Open a traced stage.

    Args:
      name: dotted stage name, e.g. ``"index.fan.stage1"``.
      metric: optional histogram name; a *root* span observes its duration
        (ms) into ``obs.metrics.REGISTRY.histogram(metric)`` on exit, so the
        latency histograms fill themselves from the trace spans.  Non-root
        spans with a metric observe too (compaction runs nested under
        nothing, queries under the batcher — both want their own histogram).
      **attrs: static attributes recorded on the span.

    Returns the shared no-op span when tracing is disabled.

    Example::

        >>> from repro_torch import obs
        >>> obs.enable()
        >>> with obs.span("demo.stage", metric="demo.stage_ms", rows=4) as sp:
        ...     _ = sp.set(note="extra attrs may be attached mid-span")
        >>> obs.metrics.REGISTRY.histogram("demo.stage_ms").count
        1
        >>> obs.disable()
    """
    if not _ENABLED:
        return NULL_SPAN
    return Span(name, metric, attrs)
