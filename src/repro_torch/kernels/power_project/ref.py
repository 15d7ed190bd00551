"""The plain PyTorch version of the power_project kernel."""

from __future__ import annotations

import torch


def power_project_ref(X: torch.Tensor, R: torch.Tensor, powers: tuple[int, ...]) -> torch.Tensor:
    """U (n, len(powers), k) fp32 = stack_j (X**powers[j]) @ R (naive path)."""
    Xf = X.to(torch.float32)
    Rf = R.to(torch.float32)
    return torch.stack([(Xf**j) @ Rf for j in powers], dim=1)
