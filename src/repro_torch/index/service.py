"""``SketchIndex`` — the corpus-scale serving object over segments.

Rows are sketched once at ingest (raw D-dim data is never retained),
appended into the preallocated active segment, sealed into immutable
blocks, tombstoned on delete, compacted when a segment's live fraction
decays, and persisted/restored through an atomic-rename commit.  All sketch
state lies on the index's device: ``device=None`` means the card, and the
CPU only when asked (``device="cpu"``).

Row identity: every ingested row gets a monotonically increasing int64 id
(returned by ``ingest``); ``delete`` and query results speak ids, never
positions, so ids stay stable across seals, compactions, and reloads.

The port's counterpart of ``repro.index.service``.  R comes from a
:class:`~repro_torch.core.projections.ProjectionKey`: ``seed`` draws it
with PyTorch's generator, which gives another R than the reference's
threefry for the same seed; ``key=`` hands the index an R carried across
(``repro_torch.convert.projection_key_from_tiles``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..core import registry
from ..core.projections import ProjectionKey
from ..core.sketch import LpSketch, SketchConfig, sketch
from ..device import resolve_device
from ..engine import EngineConfig
from ..obs.metrics import REGISTRY
from ..obs.slowlog import GLOBAL_SLOW_LOG
from .planner import ApproxContract, QueryPlanner
from .query import fan_topk, threshold_scan
from .segment import ActiveSegment, SealedSegment

# process-global maintenance counters, resolved once at import (counters
# are always live — they are the serving stats)
_COMPACT_PASSES = REGISTRY.counter(
    "index.compaction_passes", "compaction passes that reached the swap")
_COMPACT_SEGMENTS = REGISTRY.counter(
    "index.compaction_segments_rewritten", "segments rewritten by compaction")
_COMPACT_REPLAYED = REGISTRY.counter(
    "index.compaction_replayed_deletes",
    "tombstones replayed onto replacements at swap time")

__all__ = ["IndexConfig", "CompactionPolicy", "SketchIndex", "CompactionHandle"]

_ROW_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Index-level knobs (the sketch itself is configured by SketchConfig).

    Attributes:
      segment_capacity: rows per segment; the active segment preallocates
        exactly this many rows of sketch state on the index's device.
      min_live_frac: ``compact()`` rewrites sealed segments whose live
        fraction is at or below this threshold.
    """

    segment_capacity: int = 4096
    min_live_frac: float = 0.5

    def __post_init__(self):
        if self.segment_capacity < 2:
            raise ValueError("segment_capacity must be >= 2")
        if not 0.0 <= self.min_live_frac <= 1.0:
            raise ValueError("min_live_frac must be in [0, 1]")


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Scheduling policy that drives ``compact_async`` off the write path.

    ``maybe_compact()`` (called automatically after every delete and ingest
    when ``auto`` is set, or by an operator loop) starts one background pass
    iff some sealed segment's live fraction has decayed to
    ``live_frac_trigger`` or below, at least ``min_interval_s`` elapsed since
    the last pass *started* (manual passes arm the limiter too), and no pass
    is in flight.

    Attributes:
      live_frac_trigger: segment live fraction at/below which a rewrite is
        scheduled (forwarded to ``compact_async`` as its threshold).
      min_interval_s: minimum seconds between scheduled pass starts.
      auto: hook the check into ``delete``/``ingest``.
      clock: monotonic time source (injectable for deterministic tests).
    """

    live_frac_trigger: float = 0.5
    min_interval_s: float = 60.0
    auto: bool = True
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        if not 0.0 <= self.live_frac_trigger <= 1.0:
            raise ValueError("live_frac_trigger must be in [0, 1]")
        if self.min_interval_s < 0:
            raise ValueError("min_interval_s must be >= 0")


class CompactionHandle:
    """Join handle for a background compaction pass.

    ``join()`` blocks until the replacement segments are built *and* swapped
    in, then returns how many segments were rewritten (re-raising any build
    error).  The swap is atomic under the index lock: a query sees either
    the whole pre-compaction segment list or the whole post-compaction one."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._result: int = 0
        self._error: Optional[BaseException] = None
        self._finished = False  # set by the worker, never inferred from the
        #                         thread state (an unstarted thread reads as
        #                         not alive)

    @property
    def done(self) -> bool:
        return self._finished

    def join(self, timeout: Optional[float] = None) -> int:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("background compaction still running")
        if self._error is not None:
            raise self._error
        return self._result


class SketchIndex:
    """Segmented, persistent l_p sketch index: ingest / delete / query.

    ``device=None`` means the card; without CUDA the constructor raises.
    ``key`` (a ProjectionKey) overrides the R drawn from ``seed``.
    """

    def __init__(self, cfg: SketchConfig, *, seed: int = 0,
                 key: Optional[ProjectionKey] = None,
                 index_cfg: Optional[IndexConfig] = None,
                 engine: Optional[EngineConfig] = None,
                 policy: Optional[CompactionPolicy] = None,
                 device=None):
        self.cfg = cfg
        self.seed = seed
        self.device = resolve_device(device)
        self.key = ProjectionKey(seed) if key is None else key
        self.index_cfg = index_cfg or IndexConfig()
        self.engine = engine
        self.policy = policy
        self.sealed: List[SealedSegment] = []
        self.active = self._new_active()
        self.next_row_id = 0
        # row id -> (segment index, local row); active segment is index -1
        self._loc: Dict[int, Tuple[int, int]] = {}
        # guards the segment list + id map against the background compactor;
        # queries snapshot the list under it, the compactor swaps under it
        self._lock = threading.RLock()
        self.generation = 0  # bumped on every atomic segment-list flip
        self._compaction: Optional[CompactionHandle] = None
        self._last_compaction_start: Optional[float] = None
        self.auto_compactions = 0  # policy-triggered passes
        # one planner per index: cost samples never leak between corpora
        self.planner = QueryPlanner()

    def _new_active(self) -> ActiveSegment:
        return ActiveSegment(self.cfg, self.index_cfg.segment_capacity,
                             device=self.device)

    # ------------------------------------------------------------------ state

    @property
    def n_live(self) -> int:
        return sum(s.live_count for s in self.sealed) + self.active.live_count

    @property
    def n_rows(self) -> int:
        """Physical rows currently held (live + tombstoned + padding)."""
        return sum(s.n for s in self.sealed) + self.active.size

    @property
    def n_segments(self) -> int:
        return len(self.sealed) + (1 if self.active.size else 0)

    def stats(self) -> dict:
        return {
            "live": self.n_live,
            "rows": self.n_rows,
            "sealed_segments": len(self.sealed),
            "active_fill": self.active.size / self.active.capacity,
            "next_row_id": self.next_row_id,
            "generation": self.generation,
            "compacting": bool(self._compaction and not self._compaction.done),
            "auto_compactions": self.auto_compactions,
            # latency histograms fill from trace spans (obs.enable()); the
            # registry is process-global, so with several indexes in one
            # process these aggregate across them
            "latency": {
                "query_ms": REGISTRY.histogram("index.query_ms").summary(),
                "threshold_ms": REGISTRY.histogram("index.threshold_ms").summary(),
                "compact_ms": REGISTRY.histogram("index.compact_ms").summary(),
                "rebalance_ms": REGISTRY.histogram("index.rebalance_ms").summary(),
            },
            "slow_queries": GLOBAL_SLOW_LOG.entries(),
        }

    def _segments(self) -> Sequence[Union[ActiveSegment, SealedSegment]]:
        """Consistent snapshot of the segment list (atomic vs. the swap)."""
        with self._lock:
            segs: List[Union[ActiveSegment, SealedSegment]] = list(self.sealed)
            if self.active.size:
                segs.append(self.active)
            return segs

    def _on_device(self, sk: LpSketch) -> LpSketch:
        return LpSketch(U=sk.U.to(self.device), moments=sk.moments.to(self.device))

    def _rows(self, rows) -> torch.Tensor:
        """(n, D) rows on the index's device, float32 unless bfloat16."""
        X = torch.as_tensor(rows, device=self.device)
        return X if X.dtype in _ROW_DTYPES else X.to(torch.float32)

    # ----------------------------------------------------------------- ingest

    def ingest(self, rows) -> np.ndarray:
        """Sketch and index (n, D) rows (a tensor or an array, moved to the
        index's device first); returns their assigned int64 ids."""
        return self.ingest_sketch(sketch(self._rows(rows), self.key, self.cfg))

    def ingest_sketch(self, sk: LpSketch) -> np.ndarray:
        """Index pre-sketched rows (must share this index's key + config)."""
        sk = self._on_device(sk)
        with self._lock:
            n = sk.n
            ids = np.arange(self.next_row_id, self.next_row_id + n, dtype=np.int64)
            self.next_row_id += n
            off = 0
            while off < n:
                take = min(n - off, self.active.remaining)
                part = LpSketch(U=sk.U[off:off + take],
                                moments=sk.moments[off:off + take])
                start_local = self.active.size
                self.active.append(part, ids[off:off + take])
                self._loc.update(zip(ids[off:off + take].tolist(),
                                     ((-1, start_local + j) for j in range(take))))
                off += take
                if self.active.remaining == 0:
                    self.seal_active()
        self._maybe_auto_compact()
        return ids

    def seal_active(self) -> None:
        """Freeze the active segment and open a fresh one."""
        with self._lock:
            if self.active.size == 0:
                return
            seg = self.active.seal()
            seg_idx = len(self.sealed)
            self.sealed.append(seg)
            self._loc.update((rid, (seg_idx, local))
                             for local, rid in enumerate(seg.row_ids.tolist()) if rid >= 0)
            self.active = self._new_active()

    # ----------------------------------------------------------------- delete

    def delete(self, row_ids) -> int:
        """Tombstone rows by id; returns how many were live before.  One
        ``delete_local`` call per segment per batch, not per row."""
        with self._lock:
            seen = set()
            per_seg: Dict[int, List[int]] = {}
            for rid in np.atleast_1d(np.asarray(row_ids, np.int64)):
                loc = self._loc.get(int(rid))
                if loc is None or loc in seen:
                    continue
                seg_idx, local = loc
                seg = self.active if seg_idx == -1 else self.sealed[seg_idx]
                if seg.live[local]:
                    seen.add(loc)
                    per_seg.setdefault(seg_idx, []).append(local)
            for seg_idx, locals_ in per_seg.items():
                seg = self.active if seg_idx == -1 else self.sealed[seg_idx]
                seg.delete_local(np.asarray(locals_, np.int64))
            removed = len(seen)
        if removed:
            self._maybe_auto_compact()
        return removed

    # ------------------------------------------------------------- compaction

    def maybe_compact(self) -> Optional[CompactionHandle]:
        """Consult the :class:`CompactionPolicy` and start one background
        pass if it is due; returns its handle, or None when the policy
        declines (no policy, decay threshold not reached, rate limited, or a
        pass already in flight)."""
        pol = self.policy
        if pol is None:
            return None
        now = pol.clock()
        with self._lock:
            if self._compaction is not None and not self._compaction.done:
                return None  # one pass at a time; never queue behind it
            if (self._last_compaction_start is not None
                    and now - self._last_compaction_start < pol.min_interval_s):
                return None
            if not any(seg.live_fraction <= pol.live_frac_trigger
                       for seg in self.sealed):
                return None
            self.auto_compactions += 1
            return self.compact_async(pol.live_frac_trigger)

    def _maybe_auto_compact(self) -> None:
        """Write-path hook: policy check after every delete/ingest batch."""
        if self.policy is not None and self.policy.auto:
            self.maybe_compact()

    def compact(self, min_live_frac: Optional[float] = None) -> int:
        """Rewrite sealed segments at/below the live-fraction threshold to
        live rows only (dropping fully-dead segments); returns how many
        segments were rewritten.  Query results are bit-for-bit unchanged —
        compaction moves rows, never recomputes estimates."""
        with obs.span("index.compact", metric="index.compact_ms",
                      mode="blocking") as sp:
            self._arm_rate_limit()
            plan = self._compaction_plan(min_live_frac)
            built = [(seg, snap, self._build_replacement(seg, snap))
                     for seg, snap in plan]
            rewritten = self._swap_compacted(built)
            if sp:
                sp.set(planned=len(plan), rewritten=rewritten)
            return rewritten

    def compact_async(self, min_live_frac: Optional[float] = None
                      ) -> CompactionHandle:
        """Background compaction: replacement segments are built on a worker
        thread from a tombstone snapshot, then swapped in atomically (one
        generation flip under the index lock).  Deletes that land on a
        segment while its replacement is being built are replayed onto the
        replacement at swap time.

        The worker launches its copies on its own current stream, the
        default one, where queries run too; a query in flight keeps the old
        segments' tensors alive until it drops them.

        One pass runs at a time: if one is in flight its handle is returned
        and ``min_live_frac`` is not re-applied."""
        with self._lock:
            if self._compaction is not None and not self._compaction.done:
                return self._compaction
            self._arm_rate_limit()
            handle = CompactionHandle()
            plan = self._compaction_plan(min_live_frac)

            def work():
                try:
                    with obs.span("index.compact", metric="index.compact_ms",
                                  mode="async") as sp:
                        built = [(seg, snap, self._build_replacement(seg, snap))
                                 for seg, snap in plan]  # device work, no lock
                        handle._result = self._swap_compacted(built)
                        if sp:
                            sp.set(planned=len(plan), rewritten=handle._result)
                except BaseException as e:  # surfaced on join()
                    handle._error = e
                finally:
                    handle._finished = True

            handle._thread = threading.Thread(target=work, daemon=True,
                                              name="sketch-index-compactor")
            # publish + start under the lock: a racing compact_async sees no
            # handle or a started one, never one whose thread can't be joined
            self._compaction = handle
            handle._thread.start()
        return handle

    def _arm_rate_limit(self) -> None:
        """Every pass start (manual or policy-driven) arms the policy's
        min-interval limiter."""
        if self.policy is not None:
            self._last_compaction_start = self.policy.clock()

    @staticmethod
    def _build_replacement(seg: SealedSegment,
                           snap: np.ndarray) -> Optional[SealedSegment]:
        """Compacted replacement, or None to drop a segment that was fully
        dead at snapshot time."""
        if not snap.any():
            return None
        return seg.compacted(live=snap)

    def _compaction_plan(self, min_live_frac: Optional[float]):
        """(segment, live-bitmap snapshot) for every segment due a rewrite."""
        thr = self.index_cfg.min_live_frac if min_live_frac is None else min_live_frac
        with self._lock:
            return [(seg, seg.live.copy()) for seg in self.sealed
                    if seg.live_fraction <= thr]

    def _swap_compacted(self, built) -> int:
        """Atomically splice replacement segments into the sealed list.

        Each entry is (original, live snapshot, replacement|None).  Under the
        lock: originals no longer in the list (a racing compact beat us) are
        skipped; tombstones set after the snapshot are replayed onto the
        replacement; then the list is flipped in one assignment and the
        generation bumped."""
        with self._lock:
            slot_of = {id(seg): i for i, seg in enumerate(self.sealed)}
            out: List[Optional[SealedSegment]] = list(self.sealed)
            rewritten = 0
            replayed = 0
            for seg, snap, rep in built:
                slot = slot_of.get(id(seg))
                if slot is None:
                    continue  # someone already rewrote/dropped this segment
                rewritten += 1
                if rep is None:
                    out[slot] = None  # fully dead at snapshot: drop
                    continue
                newly_dead = seg.row_ids[snap & ~seg.live]
                if len(newly_dead):
                    rep.delete_local(np.flatnonzero(np.isin(rep.row_ids, newly_dead)))
                    replayed += len(newly_dead)
                out[slot] = rep
            self.sealed = [s for s in out if s is not None]
            self._reindex()
            self.generation += 1
            _COMPACT_PASSES.inc()
            _COMPACT_SEGMENTS.inc(rewritten)
            if replayed:
                _COMPACT_REPLAYED.inc(replayed)
            return rewritten

    def _reindex(self) -> None:
        self._loc = {}
        for seg_idx, seg in enumerate(self.sealed):
            for local in np.flatnonzero(seg.live & (seg.row_ids >= 0)).tolist():
                self._loc[int(seg.row_ids[local])] = (seg_idx, local)
        for local in range(self.active.size):
            rid = int(self.active.row_ids[local])
            if rid >= 0:
                self._loc[rid] = (-1, local)

    # ------------------------------------------------------------------ query

    def query(self, rows, top_k: int = 10,
              estimator: str = registry.DEFAULT_ESTIMATOR, *,
              approx_ok: Optional[ApproxContract] = None,
              deadline_ms: Optional[float] = None
              ) -> Tuple[torch.Tensor, np.ndarray]:
        """Top-k live neighbors of (q, D) query rows.

        Returns (distances (q, k) on the index's device, row_ids (q, k)
        int64 on the host), ascending, k = min(top_k, live rows).
        ``estimator`` names a spec in ``repro_torch.core.registry``.
        ``approx_ok`` and ``deadline_ms`` are plan context; the single-host
        fan is exact regardless and never drops work.
        """
        qsk = sketch(self._rows(rows), self.key, self.cfg)
        return self.query_sketch(qsk, top_k=top_k, estimator=estimator,
                                 approx_ok=approx_ok, deadline_ms=deadline_ms)

    def query_sketch(self, qsk: LpSketch, top_k: int = 10,
                     estimator: str = registry.DEFAULT_ESTIMATOR, *,
                     approx_ok: Optional[ApproxContract] = None,
                     deadline_ms: Optional[float] = None):
        qsk = self._on_device(qsk)
        with obs.span("index.query", metric="index.query_ms", kind="topk",
                      top_k=top_k, estimator=estimator, rows=qsk.n):
            plan = self.planner.plan(reduce="topk", estimator=estimator,
                                     sharded=False, approx_ok=approx_ok,
                                     deadline_ms=deadline_ms)
            t0 = time.perf_counter()
            out = fan_topk(qsk, self._segments(), self.cfg, top_k=top_k,
                           estimator=estimator, engine=self.engine)
            self.planner.observe(plan, "dense", (time.perf_counter() - t0) * 1e3)
            return out

    def query_threshold(self, rows, radius: float, *,
                        relative: bool = False,
                        estimator: str = registry.DEFAULT_ESTIMATOR,
                        approx_ok: Optional[ApproxContract] = None,
                        deadline_ms: Optional[float] = None):
        """(query_rows, row_ids) host arrays of live rows with D < radius."""
        qsk = sketch(self._rows(rows), self.key, self.cfg)
        return self.query_threshold_sketch(qsk, radius=radius, relative=relative,
                                           estimator=estimator, approx_ok=approx_ok,
                                           deadline_ms=deadline_ms)

    def query_threshold_sketch(self, qsk: LpSketch, *, radius: float,
                               relative: bool = False,
                               estimator: str = registry.DEFAULT_ESTIMATOR,
                               approx_ok: Optional[ApproxContract] = None,
                               deadline_ms: Optional[float] = None):
        qsk = self._on_device(qsk)
        with obs.span("index.query", metric="index.threshold_ms",
                      kind="threshold", estimator=estimator, rows=qsk.n):
            plan = self.planner.plan(reduce="threshold", estimator=estimator,
                                     sharded=False, approx_ok=approx_ok,
                                     deadline_ms=deadline_ms)
            t0 = time.perf_counter()
            out = threshold_scan(qsk, self._segments(), self.cfg, radius=radius,
                                 relative=relative, estimator=estimator,
                                 engine=self.engine)
            self.planner.observe(plan, "dense", (time.perf_counter() - t0) * 1e3)
            return out

    # ------------------------------------------------------------ persistence

    def save(self, path: str) -> str:
        from .store import save_index  # local import: store imports service
        return save_index(path, self)

    @classmethod
    def load(cls, path: str, *, key: Optional[ProjectionKey] = None,
             engine: Optional[EngineConfig] = None,
             policy: Optional[CompactionPolicy] = None,
             device=None) -> "SketchIndex":
        from .store import load_index
        return load_index(path, key=key, engine=engine, policy=policy, device=device)

    # ----------------------------------------------------- corpus export

    def live_sketch(self) -> LpSketch:
        """The live corpus as one LpSketch in ingest order (a gather on the
        index's device, O(live))."""
        Us, Ms = [], []
        for seg in self._segments():
            sk = seg.as_sketch()
            keep = torch.nonzero(seg.mask()).flatten()
            Us.append(sk.U.index_select(0, keep))
            Ms.append(sk.moments.index_select(0, keep))
        if not Us:
            return LpSketch(
                U=torch.zeros((0, self.cfg.vectors_per_row, self.cfg.k),
                              dtype=self.cfg.projection.dtype, device=self.device),
                moments=torch.zeros((0, self.cfg.num_moments), device=self.device))
        return LpSketch(U=torch.cat(Us), moments=torch.cat(Ms))
