"""Random projection families (paper §2.1 / §4).

Three dense sub-Gaussian families, all zero-mean unit-variance with fourth
moment ``s``:

- ``normal``:     r ~ N(0, 1),                    s = 3   (paper §2)
- ``uniform``:    r ~ Uniform(-sqrt(3), sqrt(3)), s = 9/5 (paper §4)
- ``threepoint``: r = sqrt(s) * {+1 w.p. 1/(2s); 0 w.p. 1-1/s; -1 w.p. 1/(2s)}

R is never needed at full (D, k) up front: tile (matrix_id, block_index) is
drawn from its own ``torch.Generator``, seeded from (seed, matrix_id,
block_index) alone, so any shard or restart regenerates the same tile.
Tiles are drawn on the CPU and copied to the device that asks, so one key
gives the same R on the CPU and on the card.  A :class:`ProjectionKey`
caches its tiles per device: a sketch call then costs no draw.

The generator is PyTorch's, not JAX's threefry: the same seed gives other
numbers than ``repro``.  State made by ``repro`` comes across as tiles
(``repro_torch.convert``), which a key holds in place of drawing.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device

__all__ = [
    "ProjectionSpec",
    "ProjectionKey",
    "fourth_moment",
    "projection_block",
    "projection_matrix",
]

_FAMILIES = ("normal", "uniform", "threepoint")
_M64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class ProjectionSpec:
    """Which projection family to draw R from.

    Attributes:
      family: ``normal`` / ``uniform`` / ``threepoint``.
      s: fourth moment for ``threepoint`` (must be >= 1; ignored otherwise).
      dtype: dtype of the R entries.
      block_d: row-block size used when R is assembled over the D axis.
    """

    family: str = "normal"
    s: float = 3.0
    dtype: torch.dtype = torch.float32
    block_d: int = 2048

    def __post_init__(self):
        if self.family not in _FAMILIES:
            raise ValueError(f"unknown projection family {self.family!r}")
        if self.family == "threepoint" and self.s < 1.0:
            raise ValueError("three-point SubG(s) requires s >= 1")


def fourth_moment(spec: ProjectionSpec) -> float:
    """E[r^4] = s (enters the Lemma 6 variance)."""
    return {"normal": 3.0, "uniform": 9.0 / 5.0, "threepoint": float(spec.s)}[
        spec.family
    ]


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _tile_seed(seed: int, matrix_id: int, block_index: int) -> int:
    h = _splitmix64(seed & _M64)
    h = _splitmix64(h ^ (matrix_id & _M64))
    h = _splitmix64(h ^ (block_index & _M64))
    return h >> 1  # a non-negative 63-bit seed


def _draw(gen: torch.Generator, shape, spec: ProjectionSpec) -> torch.Tensor:
    if spec.family == "normal":
        r = torch.randn(shape, generator=gen, dtype=torch.float32)
    elif spec.family == "uniform":
        r = (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0
             ) * math.sqrt(3.0)
    else:
        s = float(spec.s)
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        sign = torch.where(u < 1.0 / (2.0 * s), -1.0,
                           torch.where(u < 1.0 / s, 1.0, 0.0))
        r = math.sqrt(s) * sign
    return r.to(spec.dtype)


_TileId = Tuple[str, float, torch.dtype, int, int, int, int]


def _tile_id(spec: ProjectionSpec, matrix_id: int, block_index: int,
             block_rows: int, k: int) -> _TileId:
    return (spec.family, float(spec.s), spec.dtype, int(matrix_id),
            int(block_index), int(block_rows), int(k))


def _canonical(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class ProjectionKey:
    """The source of every R tile of one sketch space.

    ``ProjectionKey(seed)`` draws tile (matrix_id, block_index) from a
    generator seeded by (seed, matrix_id, block_index).  ``ProjectionKey(None)``
    draws nothing: it serves only the tiles put into it with
    :meth:`put_tile` (state carried across from another implementation) and
    raises for any other.  Sketches compare only when built from one key.
    """

    def __init__(self, seed: Optional[int]):
        if seed is not None and not isinstance(seed, int):
            raise TypeError(f"seed must be an int or None, got {type(seed).__name__}")
        self.seed = seed
        self._host: Dict[_TileId, torch.Tensor] = {}
        self._on_device: Dict[Tuple[torch.device, _TileId], torch.Tensor] = {}
        self._lock = threading.Lock()

    def put_tile(self, matrix_id: int, block_index: int, block_rows: int,
                 tile: torch.Tensor, spec: ProjectionSpec) -> None:
        """Hold ``tile`` ((rows, k), rows <= block_rows for a ragged last
        block) as tile (matrix_id, block_index) of ``block_rows``-row blocks."""
        if tile.ndim != 2 or tile.shape[0] > block_rows:
            raise ValueError(
                f"tile must be (rows <= {block_rows}, k), got {tuple(tile.shape)}")
        tid = _tile_id(spec, matrix_id, block_index, block_rows, tile.shape[1])
        with self._lock:
            self._host[tid] = tile.detach().to("cpu", spec.dtype).contiguous()
            for dkey in [dk for dk in self._on_device if dk[1] == tid]:
                del self._on_device[dkey]

    def tile(self, matrix_id: int, block_index: int, block_rows: int, k: int,
             spec: ProjectionSpec, device: torch.device) -> torch.Tensor:
        """The (block_rows, k) tile on ``device`` (cached per device)."""
        tid = _tile_id(spec, matrix_id, block_index, block_rows, k)
        dkey = (_canonical(torch.device(device)), tid)
        with self._lock:
            cached = self._on_device.get(dkey)
            if cached is not None:
                return cached
            host = self._host.get(tid)
        if host is None:
            if self.seed is None:
                raise KeyError(
                    f"tile (matrix {matrix_id}, block {block_index}, "
                    f"{block_rows}x{k}, {spec.family}) was not carried into "
                    f"this key and a key without a seed draws none")
            gen = torch.Generator(device="cpu")
            gen.manual_seed(_tile_seed(self.seed, matrix_id, block_index))
            host = _draw(gen, (block_rows, k), spec)
            with self._lock:
                host = self._host.setdefault(tid, host)
        dev_tile = host.to(dkey[0])
        with self._lock:
            return self._on_device.setdefault(dkey, dev_tile)


def projection_block(
    key: ProjectionKey, matrix_id: int, block_index: int, block_rows: int,
    k: int, spec: ProjectionSpec, *, device=None,
) -> torch.Tensor:
    """The (block_rows, k) tile of R^(matrix_id) covering rows
    [block_index*block_rows, ...).  ``device=None`` means the card."""
    return key.tile(matrix_id, block_index, block_rows, k, spec,
                    resolve_device(device))


def projection_matrix(
    key: ProjectionKey, matrix_id: int, D: int, k: int,
    spec: Optional[ProjectionSpec] = None, *, block_d: Optional[int] = None,
    block_offset: int = 0, device=None,
) -> torch.Tensor:
    """R^(matrix_id) at (D, k), assembled from the per-block stream: blocks of
    ``min(block_d, D)`` rows (``block_d`` defaults to ``spec.block_d``),
    numbered from ``block_offset``.  ``device=None`` means the card."""
    spec = spec or ProjectionSpec()
    dev = resolve_device(device)
    bd = min(block_d or spec.block_d, D)
    nblocks = -(-D // bd)
    tiles = [key.tile(matrix_id, block_offset + i, bd, k, spec, dev)
             for i in range(nblocks)]
    R = tiles[0] if nblocks == 1 else torch.cat(tiles, dim=0)
    if R.shape[0] < D:
        raise ValueError(f"the tiles of matrix {matrix_id} cover {R.shape[0]} "
                         f"rows, fewer than D={D}")
    return R[:D]
