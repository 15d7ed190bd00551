"""All-pairs / KNN distance estimation from sketches — the O(n^2 k) path.

The order-matched sketch vectors are packed with sign-folded sqrt
coefficients:

    A[i] = concat_m sqrt(|c_m|/k) * u^{(i)}_{p-m}
    B[i] = concat_m sign(c_m) sqrt(|c_m|/k) * u^{(i)}_{m}

so the whole interaction estimate for every pair is one (n, (p-1)k) x
((p-1)k, m) product with the marginal norms as a rank-1 epilogue,

    D_hat = ||x_i||_p^p + ||x_j||_p^p + (A @ B^T)[i, j],

which is what the ``pairwise_lp`` kernel computes.  The packing is exact.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.pairwise_lp.ops import pairwise_lp
from .decomposition import interaction_orders
from .estimators import margin_mle_root
from .sketch import LpSketch, SketchConfig

__all__ = ["pack_left", "pack_right", "pack_sketch", "pairwise_distances",
           "pairwise_margin_mle", "knn"]


def _pack(sk: LpSketch, cfg: SketchConfig, slots, scales) -> torch.Tensor:
    """(n, len(slots)*k): U[:, slot] * scale, written side by side into one
    buffer (no (n, p-1, k) temporary, which matters for a large corpus)."""
    k = cfg.k
    out = torch.empty((sk.n, len(slots) * k), dtype=sk.U.dtype, device=sk.U.device)
    for i, (slot, scale) in enumerate(zip(slots, scales)):
        torch.mul(sk.U[:, slot], scale, out=out[:, i * k:(i + 1) * k])
    return out


def pack_left(sk: LpSketch, cfg: SketchConfig) -> torch.Tensor:
    """A: the rows as the left operand ("x")."""
    orders = interaction_orders(cfg.p)
    if cfg.strategy == "basic":
        slots = [a - 1 for a, _, _ in orders]
    else:
        slots = [c - 1 for _, c, _ in orders]  # Ua[m-1], m = c
    scales = [math.sqrt(abs(coef) / cfg.k) for _, _, coef in orders]
    return _pack(sk, cfg, slots, scales)


def pack_right(sk: LpSketch, cfg: SketchConfig) -> torch.Tensor:
    """B: the rows as the right operand ("y"), signs folded in."""
    orders = interaction_orders(cfg.p)
    if cfg.strategy == "basic":
        slots = [c - 1 for _, c, _ in orders]
    else:
        slots = [cfg.num_orders + c - 1 for _, c, _ in orders]  # Ub[m-1]
    scales = [math.copysign(1.0, coef) * math.sqrt(abs(coef) / cfg.k)
              for _, _, coef in orders]
    return _pack(sk, cfg, slots, scales)


def pack_sketch(sk: LpSketch, cfg: SketchConfig):
    """(A, B, norms): packed left/right factors + marginal p-norms."""
    return pack_left(sk, cfg), pack_right(sk, cfg), sk.norm_pp(cfg.p).contiguous()


def pairwise_distances(
    sa: LpSketch,
    sb: Optional[LpSketch],
    cfg: SketchConfig,
    *,
    clip: bool = True,
    zero_diag: bool = False,
) -> torch.Tensor:
    """(n, m) estimated l_p^p distances between rows of two sketch sets,
    through the ``pairwise_lp`` kernel on the card.

    ``sb=None`` means self-pairs; ``zero_diag`` then zeroes the diagonal.
    """
    self_pairs = sb is None
    sb = sa if self_pairs else sb
    D = pairwise_lp(pack_left(sa, cfg), pack_right(sb, cfg),
                    sa.norm_pp(cfg.p).contiguous(), sb.norm_pp(cfg.p).contiguous(),
                    clip=clip)
    if zero_diag and self_pairs:
        D = D * (1.0 - torch.eye(D.shape[0], dtype=D.dtype, device=D.device))
    return D


def pairwise_margin_mle(
    sa: LpSketch,
    sb: Optional[LpSketch],
    cfg: SketchConfig,
    *,
    newton_steps: int = 2,
    clip: bool = True,
) -> torch.Tensor:
    """All-pairs margin-MLE distances (Lemma 4 per term, vectorized).

    p-1 rank-k products for the t_m matrices (``torch.matmul``, as the
    reference leaves them to XLA) plus O(n m (p-1)) Newton work.
    """
    sb_ = sa if sb is None else sb
    p, k = cfg.p, cfg.k
    no = cfg.num_orders
    D = sa.norm_pp(p)[:, None] + sb_.norm_pp(p)[None, :]
    for a, c, coef in interaction_orders(p):
        if cfg.strategy == "basic":
            U, V = sa.U[:, a - 1], sb_.U[:, c - 1]
        else:
            U, V = sa.U[:, c - 1], sb_.U[:, no + c - 1]
        t = U @ V.T
        nu = torch.sum(U * U, dim=-1)[:, None]
        nv = torch.sum(V * V, dim=-1)[None, :]
        Mx = sa.moments[:, a - 1][:, None]
        My = sb_.moments[:, c - 1][None, :]
        D = D + coef * margin_mle_root(t, nu, nv, Mx, My, k, newton_steps)
    return torch.clamp_min(D, 0.0) if clip else D


def knn(
    queries: LpSketch,
    corpus: LpSketch,
    cfg: SketchConfig,
    top_k: int = 10,
    *,
    mle: bool = False,
    engine_cfg=None,
):
    """Top-k nearest corpus rows per query under estimated l_p^p distance.

    Returns (distances (q, k), indices (q, k)), ascending, k = min(top_k, m),
    equal distances resolved to the lowest index.  Streams strips through
    ``repro_torch.engine``; the (q, m) matrix never materializes.
    """
    from ..engine import pairwise as engine_pairwise  # lazy: avoids a cycle

    from . import registry

    return engine_pairwise(
        queries, corpus, cfg,
        reduce="topk", top_k=top_k,
        estimator=registry.MARGIN_MLE if mle else registry.DEFAULT_ESTIMATOR,
        engine=engine_cfg,
    )
