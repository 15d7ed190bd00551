"""Bounded slow-query log: the N worst query traces, with their span trees.

The port's own copy of ``repro.obs.slowlog``.

A :class:`SlowQueryLog` is registered as a tracer sink; every finished root
span whose name matches the query filter is *offered*, and the log keeps
only the ``capacity`` slowest (a min-heap on duration — O(log N) per offer,
O(1) rejection once full and faster than the current floor).  The span tree
is snapshotted to plain dicts at admission time so retained entries never
pin segment data or grow after the fact.

``SketchIndex.stats()["slow_queries"]`` surfaces the global log;
``dump()`` renders the trees for an operator ("where did this query's 40ms
go?").
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import List, Optional, Tuple

from .trace import Span

__all__ = ["SlowQueryLog", "GLOBAL_SLOW_LOG"]

# root-span names that count as queries; maintenance traces (compaction,
# rebalance) have their own histograms and would otherwise crowd out the
# per-request entries this log exists for
_QUERY_ROOTS = ("index.query", "batcher.query")


class SlowQueryLog:
    """Keep the ``capacity`` worst (slowest) query traces seen so far."""

    def __init__(self, capacity: int = 16,
                 name_prefixes: Tuple[str, ...] = _QUERY_ROOTS):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.name_prefixes = tuple(name_prefixes)
        self._lock = threading.Lock()
        # min-heap of (duration_s, tiebreak, entry-dict): the fastest
        # retained trace sits at the root and is evicted first
        self._heap: List[tuple] = []
        self._tiebreak = itertools.count()
        self.offered = 0
        self.admitted = 0

    def offer(self, root: Span) -> bool:
        """Consider one finished root span; returns True when retained.
        Registered with ``obs.trace.add_sink`` — non-query roots are
        filtered here, not at the call sites."""
        if not root.name.startswith(self.name_prefixes):
            return False
        dur = root.duration_s
        with self._lock:
            self.offered += 1
            if len(self._heap) >= self.capacity and dur <= self._heap[0][0]:
                return False  # faster than everything retained
            entry = root.to_dict()
            item = (dur, next(self._tiebreak), entry)
            if len(self._heap) < self.capacity:
                heapq.heappush(self._heap, item)
            else:
                heapq.heappushpop(self._heap, item)
            self.admitted += 1
            return True

    def entries(self) -> List[dict]:
        """Retained traces, slowest first (plain dicts, JSON-friendly)."""
        with self._lock:
            items = sorted(self._heap, key=lambda t: (-t[0], -t[1]))
        return [e for _d, _t, e in items]

    def clear(self) -> None:
        with self._lock:
            self._heap.clear()
            self.offered = 0
            self.admitted = 0

    def dump(self) -> str:
        """Operator-facing rendering of every retained trace."""
        out = []
        for e in self.entries():
            out.append(_render(e))
        return "\n\n".join(out)

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


def _render(entry: dict, indent: int = 0) -> str:
    attrs = " ".join(f"{k}={v}" for k, v in entry["attrs"].items())
    head = "  " * indent + (
        f"{entry['name']} {entry['duration_ms']:.2f}ms"
        + (f" trace={entry['trace_id']}" if indent == 0 else "")
        + (f" [{attrs}]" if attrs else ""))
    return "\n".join([head] + [_render(c, indent + 1)
                               for c in entry["children"]])


# the process-global log every index's stats() reads; registered as a tracer
# sink on first obs import (see obs/__init__)
GLOBAL_SLOW_LOG: Optional[SlowQueryLog] = SlowQueryLog()
