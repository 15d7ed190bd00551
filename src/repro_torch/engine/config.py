"""Engine configuration: strip backend and strip block sizes, per device.

The engine walks the packed factors in (row_block, col_block) strips, so
the live estimate is one strip, never the (n, m) matrix.  Defaults follow
the device the sketches lie on:

  * cuda: the hand-written ``pairwise_lp`` kernel, 2048 x 2048 strips.
  * cpu:  the kernel's plain PyTorch version, 512 x 512 strips (small
    enough that tests cross strip edges).

``backend="plain"`` forces the plain version on either device (the route a
kernel is compared against); ``backend="kernel"`` forces the kernel's
wrapper, which on CPU tensors runs the plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["EngineConfig", "BACKENDS"]

BACKENDS = ("auto", "kernel", "plain")

# device type -> (backend, row_block, col_block)
_DEVICE_DEFAULTS = {
    "cuda": ("kernel", 2048, 2048),
    "cpu": ("plain", 512, 512),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine knobs.  ``None`` block sizes mean the device default.

    Attributes:
      backend: "auto" (by device), "kernel" or "plain".
      row_block: strip height over the left/query rows.
      col_block: strip width over the right/corpus rows.
    """

    backend: str = "auto"
    row_block: Optional[int] = None
    col_block: Optional[int] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        for name in ("row_block", "col_block"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")

    def resolve(self, device) -> Tuple[str, int, int]:
        """(backend, row_block, col_block) for sketches on ``device``."""
        dtype = torch.device(device).type
        if dtype not in _DEVICE_DEFAULTS:
            raise ValueError(f"no engine defaults for device type {dtype!r}")
        dflt_backend, dflt_rb, dflt_cb = _DEVICE_DEFAULTS[dtype]
        backend = dflt_backend if self.backend == "auto" else self.backend
        return backend, self.row_block or dflt_rb, self.col_block or dflt_cb
