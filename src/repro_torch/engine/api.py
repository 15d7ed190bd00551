"""The streaming pairwise engine — single entry point for all O(n·m) work.

``pairwise(sa, sb, cfg, reduce=...)`` tiles the packed sketch factors into
(row_block, col_block) strips, computes each strip through the backend the
device calls for (the ``pairwise_lp`` CUDA kernel on the card, its plain
version on the CPU), and folds the requested reduction into the strip loop
so the (n, m) estimate never materializes on the device:

  reduce="topk"       streaming per-row candidate merge -> (dists, indices)
  reduce="threshold"  (rows, cols) index pairs with D < radius (optionally
                      relative to the marginal-norm scale, the dedup regime)
  reduce="full"       dense output, assembled strip by strip in host memory

``estimator=`` names a spec in ``repro_torch.core.registry``, resolved once
here: packed-factor strips when ``spec.uses_packed``, otherwise the spec's
own strip function on the row-sliced raw sketches (margin-MLE).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..core import registry
from ..core.pairwise import pack_left, pack_right
from ..core.sketch import LpSketch, SketchConfig
from .backends import strip_distances
from .config import EngineConfig
from .reduce import (float32_radius, row_major, streaming_topk_strips, strip_bounds,
                     threshold_hits)

__all__ = ["pairwise"]

_REDUCES = ("full", "topk", "threshold")


def _rows(sk: LpSketch, r0: int, r1: int) -> LpSketch:
    return LpSketch(U=sk.U[r0:r1], moments=sk.moments[r0:r1])


def pairwise(
    sa: LpSketch,
    sb: Optional[LpSketch],
    cfg: SketchConfig,
    *,
    reduce: str = "full",
    top_k: int = 10,
    radius: Optional[float] = None,
    relative: bool = False,
    estimator: str = registry.DEFAULT_ESTIMATOR,
    clip: bool = True,
    zero_diag: bool = False,
    engine: Optional[EngineConfig] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Streaming pairwise l_p^p distance estimates with a fused reduction.

    Args:
      sa: left/query sketch (n rows).
      sb: right/corpus sketch (m rows); ``None`` means self-pairs against sa.
      cfg: the sketch configuration both sketches were built with.
      reduce: "full" | "topk" | "threshold".
      top_k: neighbors per row for reduce="topk" (capped at m).
      radius: threshold for reduce="threshold"; pairs with D < radius are
        returned.  With ``relative=True`` the test is
        D < radius * (||x_i||_p^p + ||y_j||_p^p) — the dedup criterion.
        The radius is rounded to float32 first and compared in float32.
      estimator: a name registered in ``repro_torch.core.registry``.
      clip: clamp estimates at 0.
      zero_diag: reduce="full" + self-pairs only — zero the diagonal.
      engine: block sizes / backend override (device defaults otherwise).

    Returns:
      reduce="full":      (n, m) float32 tensor in host memory.
      reduce="topk":      (distances (n, k) float32, indices (n, k) int64) on
                          the sketches' device, ascending, k = min(top_k, m),
                          equal distances resolved to the lowest index.
      reduce="threshold": (rows, cols) int64 tensors on the sketches' device,
                          in row-major order.
    """
    if reduce not in _REDUCES:
        raise ValueError(f"reduce must be one of {_REDUCES}, got {reduce!r}")
    spec = registry.resolve(estimator, p=cfg.p, projection=cfg.projection.family)
    if reduce == "threshold" and radius is None:
        raise ValueError("reduce='threshold' requires a radius")

    device = sa.U.device
    engine = engine or EngineConfig()
    backend, row_block, col_block = engine.resolve(device)

    self_pairs = sb is None
    sb_ = sa if self_pairs else sb
    n, m = sa.n, sb_.n
    na = sa.norm_pp(cfg.p).contiguous()
    nb = sb_.norm_pp(cfg.p).contiguous()

    if spec.uses_packed:
        A = pack_left(sa, cfg)
        B = pack_right(sb_, cfg)

        def strip(r0, r1, c0, c1):
            return strip_distances(A[r0:r1], B[c0:c1], na[r0:r1], nb[c0:c1],
                                   backend=backend, clip=clip)
    else:
        def strip(r0, r1, c0, c1):
            return spec.pairwise(_rows(sa, r0, r1), _rows(sb_, c0, c1), cfg,
                                 clip=clip)

    if reduce == "topk":
        vals, idx = [], []
        for r0, r1 in strip_bounds(n, row_block):
            v, i = streaming_topk_strips(
                lambda c0, c1, r0=r0, r1=r1: strip(r0, r1, c0, c1),
                r1 - r0, m, top_k=top_k, col_block=col_block,
            )
            vals.append(v)
            idx.append(i)
        return torch.cat(vals, dim=0), torch.cat(idx, dim=0)

    if reduce == "threshold":
        r32 = float32_radius(radius, device)
        rows_out, cols_out = [], []
        for r0, r1 in strip_bounds(n, row_block):
            for c0, c1 in strip_bounds(m, col_block):
                hit = threshold_hits(strip(r0, r1, c0, c1), r32, na[r0:r1],
                                     nb[c0:c1], relative)
                rr, cc = torch.nonzero(hit, as_tuple=True)
                rows_out.append(rr + r0)
                cols_out.append(cc + c0)
        rows = torch.cat(rows_out) if rows_out else torch.zeros(0, dtype=torch.int64, device=device)
        cols = torch.cat(cols_out) if cols_out else torch.zeros(0, dtype=torch.int64, device=device)
        return row_major(rows, cols, m)

    out = torch.empty((n, m), dtype=torch.float32)
    for r0, r1 in strip_bounds(n, row_block):
        for c0, c1 in strip_bounds(m, col_block):
            out[r0:r1, c0:c1] = strip(r0, r1, c0, c1).cpu()
    if zero_diag and self_pairs:
        out.fill_diagonal_(0.0)
    return out
