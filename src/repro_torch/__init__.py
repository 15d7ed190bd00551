"""PyTorch and CUDA port of the l_p sketching system (``repro`` is the JAX
reference it is held against).

The main path is the paper's pipeline for even p:

  rows X -> ``core.sketch.sketch`` (exact power moments + projections of
  x^1..x^{p-1} onto R tiles; the ``power_project`` CUDA kernel)
  -> ``core.pairwise.pack_sketch`` -> ``engine.pairwise`` strips of
  ``D = max(na + nb^T + A B^T, 0)`` (the ``pairwise_lp`` CUDA kernel) with a
  fused top-k or threshold reduction -> ``core.pairwise.knn``.

Functions on tensors run where their tensors lie: a CUDA tensor goes to the
hand-written kernels, a CPU tensor to their plain PyTorch versions.
Functions that create tensors from nothing take ``device=None``, which means
the card; without CUDA they raise instead of running on the CPU.

TF32 is switched off for matrix products and cuDNN: the port is held against
the float32 reference, and TF32 keeps about three decimal digits, which
would break that parity on the plain and margin-MLE routes.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
