"""Index segments: a preallocated active segment + immutable sealed blocks.

The index's write path never concatenates: the active segment owns
fixed-shape buffers on the index's device (``capacity`` rows of sketch
state, allocated once) and every ingest batch is copied in place into the
next rows — O(batch) work per call, no reallocation.  When the buffer
fills, the segment is sealed: trimmed to its row count (a view, no copy),
packed once for the plain-estimator query path, and never written again.

Deletes are tombstones: a host-side ``live`` bitmap per segment.  Queries
mask dead (and, in the active segment, not-yet-written) rows to ``+inf``
*after* the strip estimate, so live-row values stay bit-identical to the
engine path and masked rows can never enter a top-k.  Compaction rewrites a
segment to its live rows only (order preserved — ``index_select`` moves
bits, never recomputes them), padding to ``_MIN_SEGMENT_ROWS`` as the
reference does, so both packages read and write one on-disk format.

The port's counterpart of ``repro.index.segment``.  The per-shard stacks
and the tombstone delta log serve only the sharded index, which is not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.pairwise import pack_right
from ..core.sketch import LpSketch, SketchConfig
from ..device import resolve_device

__all__ = ["ActiveSegment", "SealedSegment", "SketchReservoir"]

# the reference never presents a 1-row segment to its engine (XLA lowers a
# width-1 strip as a GEMV with another summation order); the CUDA kernel
# has no such path, but segments keep the same padding so that an index
# saved by either package loads in the other with the same rows
_MIN_SEGMENT_ROWS = 2


def _pad_rows(sk: LpSketch, n_pad: int) -> LpSketch:
    if n_pad <= 0:
        return sk
    U = torch.cat([sk.U, sk.U.new_zeros((n_pad, *sk.U.shape[1:]))])
    M = torch.cat([sk.moments, sk.moments.new_zeros((n_pad, sk.moments.shape[1]))])
    return LpSketch(U=U, moments=M)


def _zeros_sketch(cfg: SketchConfig, rows: int, device: torch.device) -> LpSketch:
    return LpSketch(
        U=torch.zeros((rows, cfg.vectors_per_row, cfg.k), dtype=cfg.projection.dtype,
                      device=device),
        moments=torch.zeros((rows, cfg.num_moments), dtype=torch.float32, device=device))


class SealedSegment:
    """An immutable block of sketched rows + tombstone bitmap, on the device
    its sketch lies on.

    Packed right factors for the plain estimator are computed once, at the
    first query after sealing, and cached; the device-side live mask is
    cached until a delete invalidates it.
    """

    def __init__(self, sketch: LpSketch, row_ids: np.ndarray,
                 live: Optional[np.ndarray] = None):
        n = sketch.n
        self.sketch = sketch
        self.row_ids = np.asarray(row_ids, np.int64)
        if self.row_ids.shape != (n,):
            raise ValueError(f"row_ids must be ({n},), got {self.row_ids.shape}")
        self.live = (np.ones(n, bool) if live is None
                     else np.asarray(live, bool).copy())
        self.live_version = 0  # bumped on every tombstone write
        self._packed = None    # (B, nb) right factors, built lazily
        self._mask_dev = None
        self._live_count = int(self.live.sum())
        self._live_count_version = 0

    @property
    def n(self) -> int:
        return self.sketch.n

    @property
    def device(self) -> torch.device:
        return self.sketch.U.device

    @property
    def live_count(self) -> int:
        """Cached per tombstone version: the compaction policy consults this
        on every write batch, and an O(n) bitmap scan per segment per write
        (under the index lock) would make the write path O(corpus)."""
        if self._live_count_version != self.live_version:
            self._live_count = int(self.live.sum())
            self._live_count_version = self.live_version
        return self._live_count

    @property
    def live_fraction(self) -> float:
        return self.live_count / max(self.n, 1)

    def delete_local(self, local_idx) -> None:
        self.live[local_idx] = False
        self.live_version += 1
        self._mask_dev = None

    def packed(self, cfg: SketchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, nb): cached right factor + marginal norms for plain strips."""
        if self._packed is None:
            self._packed = (pack_right(self.sketch, cfg),
                            self.sketch.norm_pp(cfg.p).contiguous())
        return self._packed

    def mask(self) -> torch.Tensor:
        """(n,) bool mask on the segment's device — True where the row is live."""
        if self._mask_dev is None:
            self._mask_dev = torch.from_numpy(self.live.copy()).to(self.device)
        return self._mask_dev

    def as_sketch(self) -> LpSketch:
        return self.sketch

    def compacted(self, live: Optional[np.ndarray] = None) -> "SealedSegment":
        """Live rows only, order preserved, padded (dead) to
        ``_MIN_SEGMENT_ROWS``.  Bits of live rows are moved, never
        recomputed, so query results are identical before and after.

        ``live`` overrides the segment's current bitmap with a snapshot —
        the background compactor builds replacements from a snapshot taken
        off the query path and replays any tombstones that landed later at
        swap time."""
        keep = np.flatnonzero(self.live if live is None else live)
        n_pad = max(_MIN_SEGMENT_ROWS - len(keep), 0)
        idx = torch.from_numpy(keep).to(self.device)
        sk = LpSketch(U=self.sketch.U.index_select(0, idx),
                      moments=self.sketch.moments.index_select(0, idx))
        sk = _pad_rows(sk, n_pad)
        row_ids = np.concatenate([self.row_ids[keep], np.full(n_pad, -1, np.int64)])
        live_out = np.concatenate([np.ones(len(keep), bool), np.zeros(n_pad, bool)])
        return SealedSegment(sk, row_ids, live_out)


class ActiveSegment:
    """The write head: fixed-capacity buffers filled left to right.

    Queries see the *full* capacity buffer with rows past ``size`` masked
    dead alongside tombstones.  ``device=None`` means the card.
    """

    def __init__(self, cfg: SketchConfig, capacity: int, *, device=None):
        if capacity < _MIN_SEGMENT_ROWS:
            raise ValueError(f"capacity must be >= {_MIN_SEGMENT_ROWS}")
        self.cfg = cfg
        self.capacity = capacity
        self.device = resolve_device(device)
        buf = _zeros_sketch(cfg, capacity, self.device)
        self.U, self.moments = buf.U, buf.moments
        self.row_ids = np.full(capacity, -1, np.int64)
        self.live = np.zeros(capacity, bool)
        self.size = 0
        self._mask_dev = None

    @property
    def remaining(self) -> int:
        return self.capacity - self.size

    @property
    def live_count(self) -> int:
        return int(self.live.sum())

    def append(self, sk: LpSketch, row_ids: np.ndarray) -> None:
        """Copy a batch into the next rows of the buffer, in place."""
        b = sk.n
        if b > self.remaining:
            raise ValueError(f"batch of {b} exceeds remaining {self.remaining}")
        self.U[self.size:self.size + b].copy_(sk.U)
        self.moments[self.size:self.size + b].copy_(sk.moments)
        self.row_ids[self.size:self.size + b] = row_ids
        self.live[self.size:self.size + b] = True
        self.size += b
        self._mask_dev = None

    def delete_local(self, local_idx) -> None:
        self.live[local_idx] = False
        self._mask_dev = None

    def mask(self) -> torch.Tensor:
        if self._mask_dev is None:
            self._mask_dev = torch.from_numpy(self.live.copy()).to(self.device)
        return self._mask_dev

    def as_sketch(self) -> LpSketch:
        """Full-capacity view (fixed shape; dead slots are masked at query)."""
        return LpSketch(U=self.U, moments=self.moments)

    def seal(self) -> SealedSegment:
        """Freeze: trim to the written rows (a view of the buffer) and hand
        off; the index opens a fresh active segment."""
        n = max(self.size, _MIN_SEGMENT_ROWS)
        sk = LpSketch(U=self.U[:n], moments=self.moments[:n])
        return SealedSegment(sk, self.row_ids[:n].copy(), self.live[:n].copy())


class SketchReservoir:
    """Fixed-capacity FIFO ring of sketched rows (dedup's reservoir).

    Admission overwrites the oldest slots in place with ``index_copy_`` —
    O(batch) per admit at any reservoir size.  ``device=None`` means the
    card.
    """

    def __init__(self, cfg: SketchConfig, capacity: int, *, device=None):
        if capacity < _MIN_SEGMENT_ROWS:
            raise ValueError(f"capacity must be >= {_MIN_SEGMENT_ROWS}")
        self.cfg = cfg
        self.capacity = capacity
        self.device = resolve_device(device)
        buf = _zeros_sketch(cfg, capacity, self.device)
        self.U, self.moments = buf.U, buf.moments
        self.count = 0  # total rows ever admitted

    @property
    def size(self) -> int:
        return min(self.count, self.capacity)

    def admit(self, sk: LpSketch) -> None:
        b = sk.n
        if b == 0:
            return
        if b > self.capacity:  # only the newest `capacity` rows can survive
            sk = LpSketch(U=sk.U[-self.capacity:], moments=sk.moments[-self.capacity:])
            self.count += b - self.capacity
            b = self.capacity
        idx = (self.count + torch.arange(b, device=self.device)) % self.capacity
        self.U.index_copy_(0, idx, sk.U.to(self.device))
        self.moments.index_copy_(0, idx, sk.moments.to(self.device))
        self.count += b

    def view(self) -> Tuple[LpSketch, np.ndarray]:
        """(full-buffer sketch, live mask) — fixed shapes at any fill."""
        live = np.arange(self.capacity) < self.size
        return LpSketch(U=self.U, moments=self.moments), live
