"""Index persistence: segments as .npy blocks + one JSON manifest, committed
through an atomic rename (``repro_torch.checkpoint.atomic_replace_dir``).

The format is the reference's (``repro.index.store``, format version 1),
so an index saved by either package loads in the other::

    <path>/
      manifest.json              sketch + index config, seed, row counter,
                                 per-segment row counts
      seg_00000.U.npy            sketch projections   (n, nvec, k) float32
                                                      (bfloat16: raw 2-byte words)
      seg_00000.moments.npy      even power moments   (n, p-1)     float32
      seg_00000.live.npy         tombstone bitmap     (n,)         bool
      seg_00000.row_ids.npy      stable ids           (n,)         int64
      ...

The active segment is saved trimmed to its written rows; on load every
stored segment comes back sealed (padded to the minimum segment size) and a
fresh active segment is opened, so a reloaded index answers queries
identically and keeps ingesting.

numpy has no bfloat16: the reference writes it through ``ml_dtypes`` as an
opaque 2-byte type (``V2``).  The port writes and reads the same raw words
and views them as ``torch.bfloat16``.

The manifest's ``seed`` names the R that made the sketches: threefry's in
``repro``, PyTorch's generator's in the port.  A loaded index therefore
answers ``query_sketch`` / ``query_threshold_sketch`` whichever package
saved it, but raw-row ``query`` on an index saved by the other package
needs that package's R, handed over as ``load_index(path, key=...)``
(``repro_torch.convert.projection_key_from_tiles``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..checkpoint import atomic_replace_dir
from ..core.projections import ProjectionKey, ProjectionSpec
from ..core.sketch import LpSketch, SketchConfig
from ..engine import EngineConfig
from .segment import _MIN_SEGMENT_ROWS, SealedSegment, _pad_rows
from .service import CompactionPolicy, IndexConfig, SketchIndex

__all__ = ["save_index", "load_index"]

_FORMAT_VERSION = 1

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}
_BF16_WORDS = np.dtype("V2")

# the reference's fractional-p projection fields, at its defaults: written
# so that both packages' manifests carry the same keys; the port serves no
# family that reads them
_STABLE_DEFAULTS = {"alpha": 2.0, "density": 0.05}


def _cfg_to_json(cfg: SketchConfig) -> dict:
    return {
        "p": cfg.p,
        "k": cfg.k,
        "strategy": cfg.strategy,
        "block_d": cfg.block_d,
        "projection": {
            "family": cfg.projection.family,
            "s": cfg.projection.s,
            "dtype": _DTYPE_NAMES[cfg.projection.dtype],
            "block_d": cfg.projection.block_d,
            **_STABLE_DEFAULTS,
        },
    }


def _cfg_from_json(d: dict) -> SketchConfig:
    proj = d["projection"]
    if proj["dtype"] not in _DTYPES:
        raise ValueError(f"unsupported sketch dtype {proj['dtype']!r}")
    return SketchConfig(
        p=d["p"], k=d["k"], strategy=d["strategy"], block_d=d["block_d"],
        projection=ProjectionSpec(family=proj["family"], s=proj["s"],
                                  dtype=_DTYPES[proj["dtype"]],
                                  block_d=proj["block_d"]),
    )


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        if a.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 segment stored as {a.dtype}")
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def save_index(path: str, index: SketchIndex) -> str:
    """Atomically persist ``index`` at ``path`` (replacing any prior save)."""
    segments = []
    arrays = []
    # snapshot under the index lock so a concurrent compaction swap can't
    # tear the segment list mid-walk (live bitmaps are copied for the same
    # reason: deletes may land while the .npy files stream out)
    with index._lock:
        for seg in index.sealed:
            segments.append({"n": seg.n})
            arrays.append((seg.sketch.U, seg.sketch.moments, seg.live.copy(),
                           seg.row_ids))
        act = index.active
        if act.size:
            n = act.size
            segments.append({"n": n})
            arrays.append((act.U[:n], act.moments[:n], act.live[:n].copy(),
                           act.row_ids[:n].copy()))
        next_row_id = index.next_row_id

    manifest = {
        "format_version": _FORMAT_VERSION,
        "sketch_config": _cfg_to_json(index.cfg),
        "index_config": {
            "segment_capacity": index.index_cfg.segment_capacity,
            "min_live_frac": index.index_cfg.min_live_frac,
        },
        "seed": index.seed,
        "next_row_id": next_row_id,
        "segments": segments,
    }
    with atomic_replace_dir(path) as tmp:
        for i, (U, M, live, ids) in enumerate(arrays):
            np.save(os.path.join(tmp, f"seg_{i:05d}.U.npy"), _to_numpy(U))
            np.save(os.path.join(tmp, f"seg_{i:05d}.moments.npy"), _to_numpy(M))
            np.save(os.path.join(tmp, f"seg_{i:05d}.live.npy"), np.asarray(live, bool))
            np.save(os.path.join(tmp, f"seg_{i:05d}.row_ids.npy"), np.asarray(ids, np.int64))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
    return path


def load_index(path: str, *, key: Optional[ProjectionKey] = None,
               engine: Optional[EngineConfig] = None,
               policy: Optional[CompactionPolicy] = None,
               device=None) -> SketchIndex:
    """Restore an index saved by ``save_index`` (of either package) onto
    ``device`` (``None`` means the card).  ``key`` overrides the R drawn
    from the manifest's seed, for raw-row queries on an index whose
    sketches were made with another R."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported index format {manifest['format_version']}")
    cfg = _cfg_from_json(manifest["sketch_config"])
    icfg = IndexConfig(**manifest["index_config"])
    index = SketchIndex(cfg, seed=manifest["seed"], key=key, index_cfg=icfg,
                        engine=engine, policy=policy, device=device)
    index.next_row_id = manifest["next_row_id"]
    for i, meta in enumerate(manifest["segments"]):
        U = np.load(os.path.join(path, f"seg_{i:05d}.U.npy"))
        M = np.load(os.path.join(path, f"seg_{i:05d}.moments.npy"))
        live = np.load(os.path.join(path, f"seg_{i:05d}.live.npy"))
        ids = np.load(os.path.join(path, f"seg_{i:05d}.row_ids.npy"))
        if U.shape[0] != meta["n"]:
            raise ValueError(f"segment {i}: manifest says {meta['n']} rows, "
                             f"found {U.shape[0]}")
        sk = LpSketch(U=_from_numpy(U, cfg.projection.dtype).to(index.device),
                      moments=_from_numpy(M, torch.float32).to(index.device))
        # pad tiny segments to the minimum segment size, like seal() and
        # compacted() do
        n_pad = max(_MIN_SEGMENT_ROWS - sk.n, 0)
        if n_pad:
            sk = _pad_rows(sk, n_pad)
            ids = np.concatenate([ids, np.full(n_pad, -1, np.int64)])
            live = np.concatenate([live, np.zeros(n_pad, bool)])
        index.sealed.append(SealedSegment(sk, ids, live))
    index._reindex()
    return index
