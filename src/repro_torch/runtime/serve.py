"""The paper's KNN service over the sketch index.

The port's counterpart of ``repro.runtime.serve.SketchKnnService``, single
host only (the reference's decode loop and sharded backing are not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import registry
from ..core.projections import ProjectionKey
from ..core.sketch import LpSketch, SketchConfig
from ..index import CompactionPolicy, IndexConfig, SketchIndex

__all__ = ["SketchKnnService"]


@dataclasses.dataclass
class SketchKnnService:
    """Approximate l_p KNN over a sketched corpus.  The corpus never needs
    its raw D-dim rows after ingestion — only (p-1)k sketch dims + p-1
    moments per row.

    Thin shim over :class:`repro_torch.index.SketchIndex`: ingest appends
    into the index's preallocated active segment and queries fan the
    engine's fused top-k across segments.  ``device=None`` means the card;
    ``key`` overrides the R drawn from ``seed``.
    """

    cfg: SketchConfig
    seed: int = 0
    segment_capacity: int = 4096
    policy: Optional[CompactionPolicy] = None
    device: Optional[object] = None
    key: Optional[ProjectionKey] = None

    def __post_init__(self):
        self.index = SketchIndex(
            self.cfg, seed=self.seed, key=self.key,
            index_cfg=IndexConfig(segment_capacity=self.segment_capacity),
            policy=self.policy, device=self.device)
        self.key = self.index.key
        self.device = self.index.device

    @property
    def n_ingested(self) -> int:
        return self.index.next_row_id

    @property
    def corpus(self) -> Optional[LpSketch]:
        """The live corpus as one sketch (an O(live) gather), or None."""
        if self.index.n_live == 0:
            return None
        return self.index.live_sketch()

    def ingest(self, rows):
        return self.index.ingest(rows)

    def delete(self, row_ids) -> int:
        return self.index.delete(row_ids)

    def query(self, rows, top_k: int = 10, mle: bool = False, approx_ok=None, *,
              estimator: Optional[str] = None):
        """``estimator`` names any spec in ``repro_torch.core.registry``;
        the ``mle`` flag is honoured when no name is given."""
        if self.index.n_live == 0:
            raise RuntimeError("empty corpus")
        if estimator is None:
            estimator = registry.MARGIN_MLE if mle else registry.DEFAULT_ESTIMATOR
        return self.index.query(rows, top_k=top_k, estimator=estimator,
                                approx_ok=approx_ok)

    def save(self, path: str) -> str:
        return self.index.save(path)

    @classmethod
    def load(cls, path: str, *, key: Optional[ProjectionKey] = None,
             device=None) -> "SketchKnnService":
        index = SketchIndex.load(path, key=key, device=device)
        svc = cls.__new__(cls)
        svc.cfg = index.cfg
        svc.seed = index.seed
        svc.segment_capacity = index.index_cfg.segment_capacity
        svc.policy = index.policy
        svc.device = index.device
        svc.index = index
        svc.key = index.key
        return svc
