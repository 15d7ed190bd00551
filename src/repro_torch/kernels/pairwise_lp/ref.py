"""The plain PyTorch version of the pairwise_lp kernel."""

from __future__ import annotations

import torch


def pairwise_lp_ref(A: torch.Tensor, B: torch.Tensor, na: torch.Tensor,
                    nb: torch.Tensor, *, clip: bool = True) -> torch.Tensor:
    """D (n, m) fp32 = na[:, None] + nb[None, :] + A @ B.T, clipped at 0."""
    D = (na.to(torch.float32)[:, None] + nb.to(torch.float32)[None, :]
         + A.to(torch.float32) @ B.to(torch.float32).T)
    return torch.clamp_min(D, 0.0) if clip else D
