"""Carries state across from the JAX implementation, as numpy arrays.

For this system the projection matrix R and a corpus sketch are the
weights.  ``repro`` draws R with JAX's threefry and the port with PyTorch's
generator, so one seed gives two different R's; a sketch made by ``repro``
is queried here with the R tiles it was made with, carried across:

  key = projection_key_from_tiles({(matrix_id, block_index): tile}, spec)
  key = projection_key_from_matrices({matrix_id: R}, spec, block_d=...)
  sk  = sketch_from_reference(U, moments)

Nothing here imports JAX: callers hand over ``np.asarray(...)`` of the
reference's arrays.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from .core.projections import ProjectionKey, ProjectionSpec
from .core.sketch import LpSketch
from .device import resolve_device

__all__ = ["projection_key_from_tiles", "projection_key_from_matrices",
           "sketch_from_reference"]


def _tensor(a) -> torch.Tensor:
    """A tensor that owns a copy: the reference's arrays are read-only."""
    return torch.from_numpy(np.array(a, order="C", copy=True))


def projection_key_from_tiles(
    tiles: Mapping[Tuple[int, int], np.ndarray], spec: ProjectionSpec
) -> ProjectionKey:
    """A key serving exactly these tiles: ``{(matrix_id, block_index):
    (block_rows, k)}``, as ``repro.core.projections.projection_block`` made
    them (each tile's row count is its block size).  Any other tile raises."""
    key = ProjectionKey(None)
    for (matrix_id, block_index), tile in tiles.items():
        t = _tensor(tile)
        key.put_tile(matrix_id, block_index, t.shape[0], t, spec)
    return key


def projection_key_from_matrices(
    matrices: Mapping[int, np.ndarray], spec: ProjectionSpec, *,
    block_d: int, block_offset: int = 0,
) -> ProjectionKey:
    """A key serving full matrices ``{matrix_id: R (D, k)}``, cut into blocks
    of ``min(block_d, D)`` rows numbered from ``block_offset`` (the last
    block may be short).  Any other tile raises."""
    key = ProjectionKey(None)
    for matrix_id, R in matrices.items():
        t = _tensor(R)
        bd = min(block_d, t.shape[0])
        for i, r0 in enumerate(range(0, t.shape[0], bd)):
            key.put_tile(matrix_id, block_offset + i, bd, t[r0:r0 + bd], spec)
    return key


def sketch_from_reference(U, moments, *, device=None) -> LpSketch:
    """The port's ``LpSketch`` from a reference sketch's ``(U, moments)``.
    ``device=None`` means the card."""
    dev = resolve_device(device)
    return LpSketch(U=_tensor(U).to(dev), moments=_tensor(moments).to(dev))
