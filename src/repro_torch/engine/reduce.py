"""Streaming reductions fused into the strip loop.

The top-k merge keeps a per-row running list of k candidates and folds each
new strip's local top-k into it, so only (rows, k) state survives a strip.
Equal distances resolve to the LOWEST column index, as in ``repro``'s dense
``lax.top_k`` contract.  ``torch.topk`` promises no order among ties, and
with the clip at 0 ties are common, so the candidates are ranked by one
int64 key per (value, index): the float's bits mapped to an order-preserving
int32 in the high half, the column index in the low half.  Keys are unique,
so the order is total and independent of the order candidates arrive in.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = [
    "streaming_topk_strips",
    "merge_topk",
    "rerank_topk",
    "strip_bounds",
    "float32_radius",
    "threshold_hits",
    "row_major",
]

_LOW32 = 0xFFFFFFFF
_MAGNITUDE = 0x7FFFFFFF


def strip_bounds(total: int, block: int):
    """(start, stop) strip bounds covering [0, total), never leaving a
    width-1 tail: a single-element remainder joins the preceding strip (the
    reference keeps this rule because a width-1 strip lowers to a GEMV with
    another accumulation order; the port keeps it so both cut alike)."""
    bounds = []
    c0 = 0
    while c0 < total:
        c1 = min(c0 + block, total)
        if total - c1 == 1:
            c1 = total
        bounds.append((c0, c1))
        c0 = c1
    return bounds


def _keys(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (value, index); idx must lie in [0, 2**32)."""
    bits = (vals.to(torch.float32) + 0.0).view(torch.int32)  # + 0.0: -0 -> +0
    ordered = torch.where(bits < 0, bits ^ _MAGNITUDE, bits)
    return (ordered.to(torch.int64) << 32) | idx.to(torch.int64)


def _decode(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    ordered = (keys >> 32).to(torch.int32)
    bits = torch.where(ordered < 0, ordered ^ _MAGNITUDE, ordered)
    return bits.view(torch.float32), keys & _LOW32


def _smallest(keys: torch.Tensor, k: int) -> torch.Tensor:
    k = min(k, keys.shape[1])
    return torch.topk(keys, k, dim=1, largest=False, sorted=True).values


def merge_topk(vals, idx, cand_vals, cand_idx, k: int):
    """Fold strip candidates into the running (rows, k) lists (ascending)."""
    keys = torch.cat([_keys(vals, idx), _keys(cand_vals, cand_idx)], dim=1)
    return _decode(_smallest(keys, k))


def rerank_topk(vals, idx, k: int):
    """(rows, C) -> (rows, k), ascending, ties broken by lowest index, in
    whatever order the candidates were gathered."""
    return _decode(_smallest(_keys(vals, idx), k))


def streaming_topk_strips(
    strip_fn: Callable[[int, int], torch.Tensor],
    rows: int,
    cols: int,
    *,
    top_k: int,
    col_block: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic streaming top-k: ``strip_fn(c0, c1)`` -> (rows, c1-c0) strip.

    Returns (distances (rows, k) float32, column indices (rows, k) int64),
    ascending, k = min(top_k, cols).
    """
    k = min(top_k, cols)
    if cols >= 2**32:
        raise ValueError(f"column indices must fit in 32 bits, got {cols} columns")
    best = None
    # an empty corpus still asks for one (rows, 0) strip, so the empty
    # result lies on the strips' device
    for c0, c1 in strip_bounds(cols, col_block) or [(0, 0)]:
        D = strip_fn(c0, c1)
        col = torch.arange(c0, c1, dtype=torch.int64, device=D.device)
        cand = _smallest(_keys(D, col.expand(D.shape[0], -1)), k)
        best = cand if best is None else _smallest(torch.cat([best, cand], dim=1), k)
    return _decode(best)


def float32_radius(radius: float, device) -> torch.Tensor:
    """The threshold radius rounded to float32, once per call: strips are
    float32, and comparing against a float64 radius would flip ties exactly
    at the (scaled) radius."""
    return torch.tensor(radius, dtype=torch.float32, device=device)


def threshold_hits(D: torch.Tensor, r32: torch.Tensor, na: torch.Tensor,
                   nb: torch.Tensor, relative: bool) -> torch.Tensor:
    """(rows, cols) bool hit mask of one strip: ``D < r32`` or, relative,
    ``D < r32 * (na_i + nb_j)``, the scale summed and multiplied in float32
    (``r32`` from ``float32_radius``; ``na``/``nb`` the strip's margins)."""
    thr = r32 * (na[:, None] + nb[None, :]) if relative else r32
    return D < thr


def row_major(rows: torch.Tensor, cols: torch.Tensor, width: int):
    """Hit coordinates in the order ``nonzero`` gives on one dense
    (., width) matrix."""
    order = torch.argsort(rows * width + cols)
    return rows[order], cols[order]
