"""Wrapper of the power_project CUDA kernel (``csrc/power_project.cu``).

A CUDA tensor goes to the kernel, or the call raises; a CPU tensor goes to
the plain version.  ``power_project.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import power_project_ref

__all__ = ["power_project"]

_MAX_POWERS = 7
_X_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("power_project")
    lib.power_project_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
    ]
    lib.power_project_launch.restype = ctypes.c_int
    lib.power_project_error_string.argtypes = [ctypes.c_int]
    lib.power_project_error_string.restype = ctypes.c_char_p
    return lib


def power_project(X: torch.Tensor, R: torch.Tensor, powers) -> torch.Tensor:
    """U (n, len(powers), k) fp32 = stack_j (X ** powers[j]) @ R.

    X (n, D) float32 or bfloat16, R (D, k) float32 or bfloat16 (taken as
    float32), powers: 1 to 7 exponents, each >= 1.  On the card both must
    be contiguous and on one device.
    """
    powers = tuple(int(e) for e in powers)
    if X.ndim != 2 or R.ndim != 2 or X.shape[1] != R.shape[0]:
        raise ValueError(f"need X (n, D) and R (D, k), got {tuple(X.shape)} "
                         f"and {tuple(R.shape)}")
    if not 1 <= len(powers) <= _MAX_POWERS or min(powers) < 1:
        raise ValueError(f"need 1..{_MAX_POWERS} powers, each >= 1, got {powers}")
    if X.device.type == "cpu" and R.device.type == "cpu":
        return power_project_ref(X, R, powers)
    if X.device.type != "cuda" or R.device != X.device:
        raise ValueError(f"X and R must lie on one CUDA device (or both on the "
                         f"CPU), got {X.device} and {R.device}")
    if X.dtype not in _X_DTYPES or R.dtype not in _X_DTYPES:
        raise TypeError(f"X and R must be float32 or bfloat16, got {X.dtype} "
                        f"and {R.dtype}")
    if not (X.is_contiguous() and R.is_contiguous()):
        raise ValueError("X and R must be contiguous")
    n, D = X.shape
    k = R.shape[1]
    R32 = R.to(torch.float32)  # bf16 -> fp32 is exact; R is (D, k), small
    U = torch.empty((n, len(powers), k), dtype=torch.float32, device=X.device)
    if U.numel() == 0:
        return U
    lib = _lib()
    exps = (ctypes.c_int * len(powers))(*powers)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.power_project_launch(
            X.data_ptr(), int(X.dtype == torch.bfloat16), R32.data_ptr(),
            U.data_ptr(), n, D, k, exps, len(powers), stream)
    if err != 0:
        msg = lib.power_project_error_string(err).decode()
        raise RuntimeError(f"power_project launch failed: {msg} (cudaError {err})")
    power_project.launches += 1
    return U


power_project.launches = 0
