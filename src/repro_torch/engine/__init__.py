"""Streaming pairwise-distance engine (see api.py for the contract).

  from repro_torch import engine
  dists, idx = engine.pairwise(sq, sc, cfg, reduce="topk", top_k=10)
  rows, cols = engine.pairwise(sk, None, cfg, reduce="threshold", radius=r)
  D          = engine.pairwise(sa, sb, cfg, reduce="full")
"""

from .api import pairwise
from .backends import strip_distances
from .config import BACKENDS, EngineConfig
from .reduce import (float32_radius, merge_topk, rerank_topk, row_major,
                     streaming_topk_strips, strip_bounds, threshold_hits)

__all__ = [
    "pairwise",
    "strip_distances",
    "EngineConfig",
    "BACKENDS",
    "merge_topk",
    "rerank_topk",
    "streaming_topk_strips",
    "strip_bounds",
    "float32_radius",
    "threshold_hits",
    "row_major",
]
