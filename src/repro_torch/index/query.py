"""Query fans: the engine's fused reductions across segments.

``fan_topk`` streams each segment through the engine's strip machinery
(the ``pairwise_lp`` kernel's strips when the resolved estimator spec
declares ``uses_packed``, the spec's own strip function otherwise) with
tombstones masked to ``+inf`` *after* the strip estimate (an in-place fill
keeps live-row values bit-identical), then folds each strip into a running
candidate list with the engine's key-based ``merge_topk``.  Candidates carry
global positions (segment base + local column), and the merge ranks
(value, position) keys, so equal distances resolve to the earliest-ingested
live row — the rule of the engine over the equivalent live corpus.

``threshold_scan`` routes the same masked strips through the engine's
float32 threshold criterion, yielding (query_row, row_id) pairs.

``MicroBatcher`` is the serving front door: concurrent callers' query rows
are coalesced into one fused pass per (top_k, estimator, approx_ok) group —
one sketch call + one fan per batch instead of one per request.  The
flushing caller's thread launches the batch's device work on its current
stream (the default one unless the caller chose another).

The port's counterpart of ``repro.index.query``.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..core import registry
from ..core.pairwise import pack_left, pack_right
from ..core.registry import EstimatorSpec
from ..core.sketch import LpSketch, SketchConfig
from ..engine import (EngineConfig, float32_radius, merge_topk, row_major, strip_bounds,
                      strip_distances, threshold_hits)
from ..obs.metrics import REGISTRY
from .segment import ActiveSegment, SealedSegment

__all__ = ["fan_topk", "threshold_scan", "MicroBatcher"]

# fleet-wide batcher counters (always live — they ARE the serving stats);
# resolved once at import so the flush path never takes the registry lock
_BATCHES_TOTAL = REGISTRY.counter(
    "batcher.batches", "micro-batches flushed, all batchers")
_ROWS_TOTAL = REGISTRY.counter(
    "batcher.rows", "query rows served through micro-batches")
# batch-size buckets are row counts, not latencies
_BATCH_ROWS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                       512.0, 1024.0)
_DEADLINE_FLUSHES = REGISTRY.counter(
    "batcher.deadline_flushes",
    "partial batches shipped early because a waiter's deadline budget was "
    "at risk")
# when the flush-latency histogram is empty (tracing never ran), assume a
# flush costs this much when deciding how long a deadline holder may wait
_DEFAULT_FLUSH_BUDGET_MS = 1.0

Segment = Union[ActiveSegment, SealedSegment]


def _check_top_k(top_k) -> None:
    """Contract errors instead of shape errors deep in the fan.  ``top_k``
    larger than the live-row count is fine (results have min(top_k, live)
    columns); a negative or non-integer k is not."""
    if isinstance(top_k, bool) or not isinstance(top_k, (int, np.integer)):
        raise ValueError(
            f"top_k must be an integer, got {type(top_k).__name__} {top_k!r}")
    if top_k < 0:
        raise ValueError(
            f"top_k must be >= 0, got {top_k} (results always have "
            "min(top_k, live rows) columns; ask for 0 to get none)")


def _finite_k(vals: torch.Tensor, k_out: int) -> int:
    """Shrink k_out to the finite candidates every query row actually has.

    ``k_out = min(top_k, n_live)`` comes from a live-count snapshot; a delete
    racing the fan can tombstone rows after it.  Masked candidates carry
    ``+inf``, so clamping to the per-row finite count returns a narrower,
    consistent answer instead of surfacing dead rows."""
    if vals.shape[0] == 0 or k_out == 0:
        return k_out
    return min(k_out, int(torch.isfinite(vals).sum(dim=1).min()))


def _pack_query(qsk: LpSketch, cfg: SketchConfig, spec: EstimatorSpec):
    """Query-side factors, computed once per fan (segment-invariant)."""
    if not spec.uses_packed:
        return None
    return pack_left(qsk, cfg), qsk.norm_pp(cfg.p).contiguous()


def _segment_strip_fn(qsk: LpSketch, q_packed, seg: Segment,
                      cfg: SketchConfig, spec: EstimatorSpec, backend: str):
    """strip(c0, c1) -> (q, c1-c0) masked distance strip for one segment."""
    dead = ~seg.mask()
    seg_sk = seg.as_sketch()
    if spec.uses_packed:
        if isinstance(seg, ActiveSegment):
            B, nb = pack_right(seg_sk, cfg), seg_sk.norm_pp(cfg.p).contiguous()
        else:
            B, nb = seg.packed(cfg)
        Aq, nq = q_packed

        def estimate(c0: int, c1: int) -> torch.Tensor:
            return strip_distances(Aq, B[c0:c1], nq, nb[c0:c1],
                                   backend=backend, clip=True)
    else:
        def estimate(c0: int, c1: int) -> torch.Tensor:
            return spec.pairwise(
                qsk, LpSketch(U=seg_sk.U[c0:c1], moments=seg_sk.moments[c0:c1]),
                cfg, clip=True)

    def strip(c0: int, c1: int) -> torch.Tensor:
        return estimate(c0, c1).masked_fill_(dead[None, c0:c1], float("inf"))

    return strip


def _fold_segment_topk(vals, idx, qsk, q_packed, seg: Segment,
                       cfg: SketchConfig, spec: EstimatorSpec, backend: str,
                       col_block: int, base: int, k: int):
    """Fold one segment's strips into the running (q, <=k) candidate list,
    with columns globalized at ``base``."""
    n = seg.as_sketch().n
    strip = _segment_strip_fn(qsk, q_packed, seg, cfg, spec, backend)
    # the span times the host-side strip loop: launches are asynchronous,
    # so device time lands in whichever span later waits on the result
    with obs.span("engine.strips", rows=n, base=base):
        for c0, c1 in strip_bounds(n, col_block):
            D = strip(c0, c1)
            pos = torch.arange(base + c0, base + c1, dtype=torch.int64,
                               device=D.device).expand(D.shape[0], -1)
            vals, idx = merge_topk(vals, idx, D, pos, k)
    return vals, idx


def _segment_threshold_hits(qsk, q_packed, seg: Segment, cfg: SketchConfig,
                            spec: EstimatorSpec, backend: str, col_block: int,
                            nq: torch.Tensor, r32: torch.Tensor, relative: bool):
    """One segment's hits as (query_rows, local columns), row-major, on the
    segment's device, by the engine's float32 threshold test
    (``engine.threshold_hits``).  Masked columns are ``+inf`` and never hit."""
    seg_sk = seg.as_sketch()
    nb = seg_sk.norm_pp(cfg.p)
    strip = _segment_strip_fn(qsk, q_packed, seg, cfg, spec, backend)
    hits = [threshold_hits(strip(c0, c1), r32, nq, nb[c0:c1], relative)
            for c0, c1 in strip_bounds(seg_sk.n, col_block)]
    return torch.nonzero(torch.cat(hits, dim=1), as_tuple=True)


def fan_topk(
    qsk: LpSketch,
    segments: Sequence[Segment],
    cfg: SketchConfig,
    *,
    top_k: int,
    estimator: str = registry.DEFAULT_ESTIMATOR,
    engine: Optional[EngineConfig] = None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """(distances (q, k) on the sketches' device, row_ids (q, k) int64 on
    the host) over all live rows, ascending, k = min(top_k, total live
    rows).  Dead/padded rows never surface."""
    spec = registry.resolve(estimator, p=cfg.p, projection=cfg.projection.family)
    _check_top_k(top_k)
    device = qsk.U.device
    backend, _, col_block = (engine or EngineConfig()).resolve(device)
    q = qsk.n
    n_live = sum(seg.live_count for seg in segments)
    k_out = min(top_k, n_live)
    if k_out == 0:
        return (torch.zeros((q, 0), dtype=torch.float32, device=device),
                np.zeros((q, 0), np.int64))

    # merge in global-position space (segment base + local column): position
    # order == ingest order, the engine's tie-break order
    total = sum(seg.as_sketch().n for seg in segments)
    if total >= 2**32:
        raise ValueError(f"positions must fit in 32 bits, got {total} rows")
    vals = torch.empty((q, 0), dtype=torch.float32, device=device)
    idx = torch.empty((q, 0), dtype=torch.int64, device=device)
    base = 0
    id_map: List[np.ndarray] = []
    q_packed = _pack_query(qsk, cfg, spec)
    with obs.span("index.fan.stage1", metric="index.stage1_dense_ms",
                  mode="single", segments=len(segments)):
        for seg in segments:
            n = seg.as_sketch().n
            vals, idx = _fold_segment_topk(vals, idx, qsk, q_packed, seg, cfg,
                                           spec, backend, col_block, base, top_k)
            id_map.append(seg.row_ids[:n])
            base += n
        pos_to_id = np.concatenate(id_map)
        k_out = _finite_k(vals, k_out)
        pos = idx[:, :k_out].cpu().numpy()
    return vals[:, :k_out], pos_to_id[pos]


def threshold_scan(
    qsk: LpSketch,
    segments: Sequence[Segment],
    cfg: SketchConfig,
    *,
    radius: float,
    relative: bool = False,
    estimator: str = registry.DEFAULT_ESTIMATOR,
    engine: Optional[EngineConfig] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(query_rows, row_ids) int64 host arrays of live pairs with
    D < radius (optionally relative to the marginal-norm scale), in
    (query, ingest-order) order.  Hits are gathered and ordered on the
    sketches' device; only their coordinates are copied to the host."""
    spec = registry.resolve(estimator, p=cfg.p, projection=cfg.projection.family)
    device = qsk.U.device
    backend, _, col_block = (engine or EngineConfig()).resolve(device)
    nq = qsk.norm_pp(cfg.p)
    r32 = float32_radius(radius, device)
    q_packed = _pack_query(qsk, cfg, spec)
    rows_out, pos_out, id_map = [], [], []
    base = 0
    for seg in segments:
        n = seg.as_sketch().n
        rr, cc = _segment_threshold_hits(qsk, q_packed, seg, cfg, spec, backend,
                                         col_block, nq, r32, relative)
        rows_out.append(rr)
        pos_out.append(cc + base)
        id_map.append(seg.row_ids[:n])
        base += n
    if not rows_out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # (query, position) order; position order is ingest order, so this is
    # the reference's (query, row id) order
    rows, pos = row_major(torch.cat(rows_out), torch.cat(pos_out), base)
    return rows.cpu().numpy(), np.concatenate(id_map)[pos.cpu().numpy()]


class MicroBatcher:
    """Coalesce concurrent single/few-row queries into one fused index pass.

    Callers block in ``query``; a request joins the open batch for its
    (top_k, estimator, approx_ok) group and is flushed when the batch
    reaches ``max_batch`` rows or ``max_wait_ms`` elapses (whichever first).
    One sketch + one segment fan serves the whole batch.

    Deadline-aware closing: a caller may pass ``deadline_ms`` (its remaining
    latency budget).  The batch then tracks the *tightest* absolute deadline
    among its waiters, and every waiter shortens its wait so the flush
    starts while that budget — minus the observed p99 flush cost from the
    ``batcher.flush_ms`` histogram — is still intact.  The batcher itself
    never rejects.

    Example::

        >>> import torch
        >>> from repro_torch.core import SketchConfig
        >>> from repro_torch.index import MicroBatcher, SketchIndex
        >>> idx = SketchIndex(SketchConfig(p=4, k=16, block_d=32), device="cpu")
        >>> _ = idx.ingest(torch.ones((8, 32)))
        >>> mb = MicroBatcher(idx, max_wait_ms=1.0)
        >>> dists, ids = mb.query(torch.ones((1, 32)), top_k=3, deadline_ms=50.0)
        >>> ids.shape
        (1, 3)
    """

    def __init__(self, index, *, max_batch: int = 64, max_wait_ms: float = 2.0):
        self.index = index
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._lock = threading.Lock()
        self._groups: dict = {}  # (top_k, estimator, approx_ok) -> _Batch
        # atomic instruments, not bare ints: two flushes can finish
        # concurrently on different caller threads
        self._batches = obs.Counter("batches_run")
        self._rows = obs.Counter("rows_served")
        self._deadline_flushes = obs.Counter("deadline_flushes")

    @property
    def batches_run(self) -> int:
        return self._batches.value

    @property
    def rows_served(self) -> int:
        return self._rows.value

    @property
    def deadline_flushes(self) -> int:
        return self._deadline_flushes.value

    def flush_budget_ms(self) -> float:
        """How long a flush is expected to take: observed p99 of
        ``batcher.flush_ms`` (filled while tracing is enabled), with a
        conservative default before any flush has been measured."""
        hist = REGISTRY.get("batcher.flush_ms")
        if hist is not None and getattr(hist, "count", 0) > 0:
            return float(hist.percentile(99))
        return _DEFAULT_FLUSH_BUDGET_MS

    def _wait_budget(self, deadline_abs: Optional[float],
                     now: Optional[float] = None) -> float:
        """Seconds this waiter may sleep before claiming a flush: the default
        ``max_wait``, shortened so a batch holding a deadline flushes while
        ``deadline - p99 flush cost`` remains.  <= 0 means flush now."""
        if deadline_abs is None:
            return self.max_wait
        if now is None:
            now = obs.trace.clock()
        budget = (deadline_abs - now) - self.flush_budget_ms() / 1e3
        return min(self.max_wait, budget)

    def stats(self) -> dict:
        """Serving counters, live queue state, and (when tracing has run)
        latency/shape summaries from the process-global registry."""
        now = obs.trace.clock()
        with self._lock:
            open_groups = len(self._groups)
            queue_depth = sum(b.n for b in self._groups.values())
            oldest = min((b.t_open for b in self._groups.values()), default=None)
        return {
            "batches_run": self.batches_run,
            "rows_served": self.rows_served,
            "deadline_flushes": self.deadline_flushes,
            "open_groups": open_groups,
            "queue_depth": queue_depth,
            "oldest_wait_ms": (0.0 if oldest is None
                               else max(0.0, (now - oldest) * 1e3)),
            "queue_wait_ms": REGISTRY.histogram("batcher.queue_wait_ms").summary(),
            "batch_rows": REGISTRY.histogram(
                "batcher.batch_rows", buckets=_BATCH_ROWS_BUCKETS).summary(),
            "flush_ms": REGISTRY.histogram("batcher.flush_ms").summary(),
        }

    class _Batch:
        def __init__(self):
            self.rows: List[torch.Tensor] = []
            self.n = 0
            self.done = threading.Event()
            self.results = None
            self.error: Optional[BaseException] = None
            self.t_open = obs.trace.clock()  # for the queue-wait histogram
            self.deadline: Optional[float] = None  # tightest absolute deadline

    def query(self, rows, top_k: int = 10,
              estimator: str = registry.DEFAULT_ESTIMATOR,
              approx_ok=None, *, deadline_ms: Optional[float] = None):
        """(distances (b, k), row_ids (b, k)) for this caller's rows, with
        k = min(top_k, index live rows).  ``rows`` is (b, D) or (D,), a
        tensor or an array; it is moved to the index's device here, in the
        caller's thread.  A malformed ``top_k`` fails only this caller.
        ``approx_ok`` is part of the batch key; ``deadline_ms`` (remaining
        budget, not part of the key) arms the deadline-aware closer."""
        _check_top_k(top_k)
        rows = torch.as_tensor(rows, device=self.index.device)
        rows = rows.reshape(1, -1) if rows.ndim == 1 else rows
        if rows.shape[0] == 0:
            # empty request: answer at once, never a 0-row strip
            k_out = min(top_k, self.index.n_live)
            return (torch.zeros((0, k_out), dtype=torch.float32, device=rows.device),
                    np.zeros((0, k_out), np.int64))
        deadline_abs = (None if deadline_ms is None
                        else obs.trace.clock() + deadline_ms / 1e3)
        key = (top_k, estimator, approx_ok)
        with self._lock:
            batch = self._groups.get(key)
            if batch is None:
                batch = self._groups[key] = self._Batch()
            my = batch
            lo = my.n
            my.rows.append(rows)
            my.n += rows.shape[0]
            if deadline_abs is not None and (my.deadline is None
                                             or deadline_abs < my.deadline):
                my.deadline = deadline_abs
            full = my.n >= self.max_batch
            if full:
                self._groups.pop(key, None)
        if full:
            self._run(my, key)
        else:
            wait = self._wait_budget(my.deadline)
            if not (wait > 0 and my.done.wait(wait)):
                with self._lock:
                    # whoever times out first claims the flush
                    claimed = self._groups.get(key) is my
                    if claimed:
                        self._groups.pop(key, None)
                if claimed:
                    if my.deadline is not None and wait < self.max_wait:
                        # the deadline, not the batch window, closed it
                        self._deadline_flushes.inc()
                        _DEADLINE_FLUSHES.inc()
                    self._run(my, key)
                my.done.wait()
        if my.error is not None:
            raise my.error
        dists, ids = my.results
        return dists[lo:lo + rows.shape[0]], ids[lo:lo + rows.shape[0]]

    def _run(self, batch: "_Batch", key) -> None:
        top_k, estimator, approx_ok = key
        try:
            X = torch.cat(batch.rows, dim=0)
            n = X.shape[0]
            if obs.enabled():
                REGISTRY.histogram(
                    "batcher.queue_wait_ms",
                    "ms a batch waited open before its flush started",
                ).observe((obs.trace.clock() - batch.t_open) * 1e3)
                REGISTRY.histogram(
                    "batcher.batch_rows", "rows coalesced per flushed batch",
                    buckets=_BATCH_ROWS_BUCKETS).observe(n)
            # the flusher's trace carries the whole coalesced batch; the
            # index's own index.query span nests under this root
            with obs.span("batcher.query", metric="batcher.flush_ms",
                          rows=n, top_k=top_k, estimator=estimator):
                batch.results = self.index.query(X, top_k=top_k,
                                                 estimator=estimator,
                                                 approx_ok=approx_ok)
            self._batches.inc()
            self._rows.inc(n)
            _BATCHES_TOTAL.inc()
            _ROWS_TOTAL.inc(n)
        except BaseException as e:  # propagate to every waiter, never hang
            batch.error = e
            raise
        finally:
            batch.done.set()

    def flush(self) -> None:
        """Flush every open batch (shutdown / test hook)."""
        with self._lock:
            pending = list(self._groups.items())
            self._groups.clear()
        for key, batch in pending:
            try:
                self._run(batch, key)
            except Exception:
                pass  # waiters re-raise from batch.error; keep flushing
