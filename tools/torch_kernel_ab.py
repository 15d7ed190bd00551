#!/usr/bin/env python3
"""Times the PyTorch port's two CUDA kernels at the main path's shapes, in
one checkout, on one CUDA card, and prints one JSON line.

  python3 tools/torch_kernel_ab.py [SRC_DIR]

SRC_DIR is the ``src`` directory of the checkout whose ``repro_torch`` is
timed (default: this checkout's); its kernels are built from that
checkout's sources.  To compare two commits on one card, unpack the other
one (``git archive``) into a directory that .gitignore lists and run both
in turns in one session: parent, change, change, parent.

The inputs, shapes, launch counts and timer are chip_smoke.py's own
(``power_project_inputs``, ``pairwise_lp_inputs``, ``cuda_ms``), so these
times are the ``ms`` of its ``kernels`` line taken for another checkout.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke  # puts this checkout's src on the path first

    src = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT / "src").resolve()
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.kernels.pairwise_lp import pairwise_lp
    from repro_torch.kernels.power_project import power_project

    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, not {src}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 4)
    X, R, powers = smoke.power_project_inputs(torch, dev, gen)
    pp = smoke.cuda_ms(lambda: power_project(X, R, powers), smoke.POWER_PROJECT_ITERS)
    del X, R
    A, B, na, nb = smoke.pairwise_lp_inputs(torch, dev, gen)
    pl = smoke.cuda_ms(lambda: pairwise_lp(A, B, na, nb), smoke.PAIRWISE_LP_ITERS)
    print(json.dumps({"src": str(src), "power_project_ms": pp, "pairwise_lp_ms": pl,
                      "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
