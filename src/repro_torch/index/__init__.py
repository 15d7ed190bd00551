"""``repro_torch.index`` — a segmented, persistent sketch index.

The serving layer between the sketch builder and the streaming engine: the
corpus lives only as O(nk) sketch state on the index's device, appended
into a preallocated active segment, sealed into immutable blocks,
tombstoned on delete, compacted when segments decay, and persisted through
an atomic commit.  Queries fan the engine's fused reductions across
segments (the ``pairwise_lp`` kernel's strips on the card) and merge
candidates with the engine's tie rule.

  from repro_torch.index import SketchIndex
  idx = SketchIndex(SketchConfig(p=4, k=128))   # device=None: the card
  ids = idx.ingest(rows)                 # -> stable int64 row ids
  d, nn = idx.query(q, top_k=10)         # -> (dists, row ids)
  idx.delete(ids[:100]); idx.compact()
  idx.save("index_dir"); idx2 = SketchIndex.load("index_dir")

The port's counterpart of ``repro.index``, single host only: the sharded
index and its stacked fans are not ported yet.  Every query is planned by a
``QueryPlanner``, which on one host always picks the dense fan.
"""

from .planner import ApproxContract, QueryPlan, QueryPlanner
from .query import MicroBatcher, fan_topk, threshold_scan
from .segment import ActiveSegment, SealedSegment, SketchReservoir
from .service import CompactionHandle, CompactionPolicy, IndexConfig, SketchIndex
from .store import load_index, save_index

__all__ = [
    "SketchIndex",
    "IndexConfig",
    "CompactionHandle",
    "CompactionPolicy",
    "ApproxContract",
    "QueryPlan",
    "QueryPlanner",
    "MicroBatcher",
    "ActiveSegment",
    "SealedSegment",
    "SketchReservoir",
    "fan_topk",
    "threshold_scan",
    "save_index",
    "load_index",
]
