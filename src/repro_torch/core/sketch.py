"""Power sketches for l_p distance estimation (paper §2.1, §2.2, §3).

Given a row x in R^D, the sketch holds k-dimensional projections of the
power vectors x^1 ... x^{p-1} plus the exact even power moments:

- ``basic``:       one R for every order;  U[j-1] = (x^j)^T R           (p-1 vectors)
- ``alternative``: term m = 1..p-1 gets its own independent R^(m);
                   Ua[m-1] = (x^{p-m})^T R^(m), Ub[m-1] = (x^m)^T R^(m).

The projections go through the ``power_project`` kernel (each X element is
read once for all powers of one R), with R assembled from the same
per-block tile stream as ``repro.core.sketch``: blocks of
``min(block_d, D)`` rows numbered from ``block_offset``.  Sketches compare
only when built from the same (key, config).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.power_project.ops import power_project
from .decomposition import interaction_orders, power_moments
from .projections import ProjectionKey, ProjectionSpec, projection_matrix
from .registry import SKETCH_EVEN_P

__all__ = ["SketchConfig", "LpSketch", "sketch", "sketch_moments"]

_BASIC_MATRIX_ID = 0


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Static configuration of an l_p sketch.

    Attributes:
      p: distance order, even >= 4.
      k: sketch width (number of projection samples).
      strategy: ``basic`` (one R) or ``alternative`` (p-1 independent R's).
      projection: the R family.
      block_d: block over the D axis; R tiles are (block_d, k).
    """

    p: int = 4
    k: int = 64
    strategy: str = "basic"
    projection: ProjectionSpec = dataclasses.field(default_factory=ProjectionSpec)
    block_d: int = 2048

    def __post_init__(self):
        if not SKETCH_EVEN_P.contains(self.p):
            raise ValueError(f"p must be even and >= 4, got {self.p}")
        object.__setattr__(self, "p", int(self.p))
        if self.strategy not in ("basic", "alternative"):
            raise ValueError(f"unknown strategy {self.strategy!r}")

    @property
    def num_orders(self) -> int:
        return self.p - 1

    @property
    def num_moments(self) -> int:
        return self.p - 1

    @property
    def vectors_per_row(self) -> int:
        return self.p - 1 if self.strategy == "basic" else 2 * (self.p - 1)


@dataclasses.dataclass
class LpSketch:
    """Sketch of n rows.

    U:  basic: (n, p-1, k), U[:, j-1] = (x^j)^T R.
        alternative: (n, 2(p-1), k) = [Ua | Ub] stacked on axis 1.
    moments: (n, p-1), column j-1 = sum_i x_i^{2j}.
    """

    U: torch.Tensor
    moments: torch.Tensor

    @property
    def n(self) -> int:
        return self.U.shape[0]

    def norm_pp(self, p) -> torch.Tensor:
        """||x||_p^p per row."""
        return self.moments[..., int(p) // 2 - 1]

    def row(self, i) -> "LpSketch":
        return LpSketch(self.U[i][None], self.moments[i][None])


def sketch_moments(X: torch.Tensor, cfg: SketchConfig) -> torch.Tensor:
    """(n, p-1) exact moment columns."""
    return power_moments(X, cfg.p)


def sketch(
    X: torch.Tensor,
    key: ProjectionKey,
    cfg: Optional[SketchConfig] = None,
    *,
    block_offset: int = 0,
) -> LpSketch:
    """Sketch the rows of X (n, D), on the device X lies on.

    ``block_offset`` shifts the R block counter, for shards that own columns
    [offset*block_d, ...) of the global matrix.
    """
    cfg = cfg or SketchConfig()
    if X.ndim != 2:
        raise ValueError(f"X must be (n, D), got {tuple(X.shape)}")
    X = X.contiguous()
    D = X.shape[1]

    def R(matrix_id: int) -> torch.Tensor:
        return projection_matrix(key, matrix_id, D, cfg.k, cfg.projection,
                                 block_d=cfg.block_d, block_offset=block_offset,
                                 device=X.device)

    if cfg.strategy == "basic":
        U = power_project(X, R(_BASIC_MATRIX_ID), tuple(range(1, cfg.p)))
    else:
        ua, ub = [], []
        for a, c, _ in interaction_orders(cfg.p):  # term m = c uses R^(m)
            both = power_project(X, R(c), (a, c))
            ua.append(both[:, 0])
            ub.append(both[:, 1])
        U = torch.stack(ua + ub, dim=1)
    return LpSketch(U=U.to(cfg.projection.dtype), moments=sketch_moments(X, cfg))
