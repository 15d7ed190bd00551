"""Distance estimators from power sketches (paper §2.1, §2.2, §2.3, §3).

- ``estimate``: the plain unbiased estimator
      d_hat = ||x||_p^p + ||y||_p^p + (1/k) sum_m c_m u_{p-m}^T v_m
- ``estimate_margin_mle``: the margin-regularized estimator of Lemma 4 —
  each interaction a_m is the root of a cubic that conditions on the exact
  marginal moments, solved by safeguarded Newton from the plain estimate,
  every iterate clamped to the Cauchy-Schwarz ball |a_m| <= sqrt(Mx My).

The arithmetic follows ``repro.core.estimators`` operation by operation
(integer powers as repeated products), so the two agree to float32 rounding.
"""

from __future__ import annotations

import torch

from .decomposition import interaction_orders
from .sketch import LpSketch, SketchConfig

__all__ = ["interaction_dots", "estimate", "margin_mle_root", "estimate_margin_mle"]


def _uv(sx: LpSketch, sy: LpSketch, cfg: SketchConfig, m: int, a: int, c: int):
    """(u, v) for interaction term m: u ~ x^a, v ~ y^c under the right R."""
    if cfg.strategy == "basic":
        return sx.U[..., a - 1, :], sy.U[..., c - 1, :]
    no = cfg.num_orders
    return sx.U[..., m - 1, :], sy.U[..., no + m - 1, :]


def interaction_dots(sx: LpSketch, sy: LpSketch, cfg: SketchConfig) -> torch.Tensor:
    """(..., p-1) per-term sketch dot products u_{p-m}^T v_m (not yet /k)."""
    dots = []
    for a, c, _ in interaction_orders(cfg.p):
        u, v = _uv(sx, sy, cfg, m=c, a=a, c=c)
        dots.append(torch.sum(u * v, dim=-1))
    return torch.stack(dots, dim=-1)


def estimate(sx: LpSketch, sy: LpSketch, cfg: SketchConfig, *,
             clip: bool = False) -> torch.Tensor:
    """Plain unbiased estimator of d_(p)(x, y), rowwise over the sketches."""
    d = sx.norm_pp(cfg.p) + sy.norm_pp(cfg.p)
    dots = interaction_dots(sx, sy, cfg)
    coefs = torch.tensor([c for _, _, c in interaction_orders(cfg.p)],
                         dtype=d.dtype, device=d.device)
    d = d + torch.sum(coefs * dots, dim=-1) / cfg.k
    return torch.clamp_min(d, 0.0) if clip else d


def margin_mle_root(
    t: torch.Tensor,
    nu: torch.Tensor,
    nv: torch.Tensor,
    Mx: torch.Tensor,
    My: torch.Tensor,
    k: int,
    newton_steps: int = 2,
) -> torch.Tensor:
    """Solve the Lemma-4 cubic for one interaction term.

        f(a) = a^3 - (a^2/k) t - (Mx My / k) t - a Mx My + (a/k)(Mx nv + My nu)

    Args:
      t: u^T v (k-sample dot).  nu, nv: ||u||^2, ||v||^2.
      Mx, My: exact marginal moments sum x^{2(p-m)}, sum y^{2m}.

    Newton starts from the plain estimate t/k; every iterate is clamped to
    the Cauchy-Schwarz ball |a| <= sqrt(Mx My).
    """
    f32 = torch.float32
    t = t.to(f32)
    nu, nv = nu.to(f32), nv.to(f32)
    Mx, My = Mx.to(f32), My.to(f32)
    MxMy = Mx * My
    bound = torch.sqrt(MxMy)
    cross = (Mx * nv + My * nu) / k

    def f(a):
        return a * a * a - (a * a / k) * t - (MxMy / k) * t - a * MxMy + a * cross

    def fp(a):
        return 3 * (a * a) - (2 * a / k) * t - MxMy + cross

    a = torch.clamp(t / k, -bound, bound)
    for _ in range(newton_steps):
        slope = fp(a)
        step = f(a) / torch.where(torch.abs(slope) < 1e-30, 1e-30, slope)
        a = torch.clamp(a - step, -bound, bound)
    return a


def estimate_margin_mle(
    sx: LpSketch,
    sy: LpSketch,
    cfg: SketchConfig,
    *,
    newton_steps: int = 2,
    clip: bool = False,
) -> torch.Tensor:
    """Margin-MLE estimator (Lemma 4), for either projection strategy."""
    p, k = cfg.p, cfg.k
    d = sx.norm_pp(p) + sy.norm_pp(p)
    for a_ord, c_ord, coef in interaction_orders(p):
        u, v = _uv(sx, sy, cfg, m=c_ord, a=a_ord, c=c_ord)
        t = torch.sum(u * v, dim=-1)
        nu = torch.sum(u * u, dim=-1)
        nv = torch.sum(v * v, dim=-1)
        Mx = sx.moments[..., a_ord - 1]
        My = sy.moments[..., c_ord - 1]
        d = d + coef * margin_mle_root(t, nu, nv, Mx, My, k, newton_steps)
    return torch.clamp_min(d, 0.0) if clip else d
