"""Exact even-p decomposition of l_p distances (paper §1.1 / §2 / §3).

For even p and x, y in R^D:

    d_(p)(x, y) = sum_i |x_i - y_i|^p
                = ||x||_p^p + ||y||_p^p + sum_{m=1}^{p-1} c_m <x^{p-m}, y^m>

with c_m = (-1)^m C(p, m).  The marginal norms are exact linear scans; the
p-1 mixed-order inner products are what the sketches estimate.
"""

from __future__ import annotations

import math

import torch

from .registry import EVEN_P

__all__ = [
    "lp_coefficients",
    "interaction_orders",
    "exact_lp_distance",
    "exact_pairwise_lp",
    "power_moments",
    "marginal_norm",
    "mixed_moment",
]


def _check_even_p(p: int) -> None:
    EVEN_P.check(p, what="the decomposition")


def _acc(x: torch.Tensor) -> torch.Tensor:
    """Accumulate in at least float32."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def lp_coefficients(p: int) -> tuple[int, ...]:
    """Coefficients c_m = (-1)^m C(p, m) for m = 0..p."""
    _check_even_p(p)
    return tuple((-1) ** m * math.comb(p, m) for m in range(p + 1))


def interaction_orders(p: int) -> tuple[tuple[int, int, int], ...]:
    """(x_order a, y_order c, coefficient c_m) for the p-1 interaction
    terms: term m estimates <x^{p-m}, y^m>, a = p - m, c = m."""
    coeffs = lp_coefficients(p)
    return tuple((p - m, m, coeffs[m]) for m in range(1, p))


def exact_lp_distance(x: torch.Tensor, y: torch.Tensor, p: int) -> torch.Tensor:
    """d_(p) = sum_i |x_i - y_i|^p along the last axis."""
    _check_even_p(p)
    return torch.sum(_acc(x - y) ** p, dim=-1)


def exact_pairwise_lp(A: torch.Tensor, B: torch.Tensor, p: int) -> torch.Tensor:
    """All-pairs exact l_p^p distances between rows of A (n, D) and B (m, D).

    O(n m D), the cost the sketches avoid; the oracle of tests and checks.
    One row of A at a time, so the live difference is (m, D), not (n, m, D).
    """
    _check_even_p(p)
    out = torch.empty((A.shape[0], B.shape[0]), device=A.device,
                      dtype=torch.promote_types(A.dtype, torch.float32))
    for i in range(A.shape[0]):
        out[i] = exact_lp_distance(A[i][None, :], B, p)
    return out


def power_moments(X: torch.Tensor, p: int) -> torch.Tensor:
    """Even power moments M[..., j-1] = sum_i X_i^{2j} for j = 1..p-1.

    Column p//2 - 1 is the marginal norm ||x||_p^p.
    """
    _check_even_p(p)
    X = _acc(X)
    x2 = X * X
    cols = []
    acc = x2
    for _ in range(1, p):
        cols.append(torch.sum(acc, dim=-1))
        acc = acc * x2
    return torch.stack(cols, dim=-1)


def marginal_norm(moments: torch.Tensor, p: int) -> torch.Tensor:
    """||x||_p^p from a :func:`power_moments` result."""
    return moments[..., p // 2 - 1]


def mixed_moment(x: torch.Tensor, y: torch.Tensor, a: int, c: int) -> torch.Tensor:
    """<x^a, y^c> = sum_i x_i^a y_i^c."""
    return torch.sum(_acc(x) ** a * _acc(y) ** c, dim=-1)
