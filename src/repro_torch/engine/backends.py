"""Strip backends: one (row_block, col_block) distance strip, two routes.

Both compute the same estimate on a strip of the packed factors from
``repro_torch.core.pairwise.pack_sketch``:

    D[i, j] = na[i] + nb[j] + sum_K A[i, :] B[j, :]        (clipped at 0)

  * ``kernel``: the ``pairwise_lp`` wrapper — the CUDA kernel for tensors on
                the card, its plain version for tensors on the CPU.
  * ``plain``:  the plain PyTorch version on any device.
"""

from __future__ import annotations

import torch

from ..kernels.pairwise_lp.ops import pairwise_lp
from ..kernels.pairwise_lp.ref import pairwise_lp_ref

__all__ = ["strip_distances"]


def strip_distances(
    A: torch.Tensor,
    B: torch.Tensor,
    na: torch.Tensor,
    nb: torch.Tensor,
    *,
    backend: str = "kernel",
    clip: bool = True,
) -> torch.Tensor:
    """(rows(A), rows(B)) distance-estimate strip via the chosen backend."""
    if backend == "kernel":
        return pairwise_lp(A, B, na, nb, clip=clip)
    if backend == "plain":
        return pairwise_lp_ref(A, B, na, nb, clip=clip)
    raise ValueError(f"unknown engine backend {backend!r}")
