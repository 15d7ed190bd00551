"""Wrapper of the pairwise_lp CUDA kernel (``csrc/pairwise_lp.cu``).

A CUDA tensor goes to the kernel, or the call raises; a CPU tensor goes to
the plain version.  ``pairwise_lp.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import pairwise_lp_ref

__all__ = ["pairwise_lp"]

_FACTOR_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("pairwise_lp")
    lib.pairwise_lp_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pairwise_lp_launch.restype = ctypes.c_int
    lib.pairwise_lp_error_string.argtypes = [ctypes.c_int]
    lib.pairwise_lp_error_string.restype = ctypes.c_char_p
    return lib


def pairwise_lp(A: torch.Tensor, B: torch.Tensor, na: torch.Tensor,
                nb: torch.Tensor, *, clip: bool = True) -> torch.Tensor:
    """D (n, m) fp32 = max(na[:, None] + nb[None, :] + A @ B.T, 0).

    A (n, K) and B (m, K) both float32 or both bfloat16, na (n,) and nb (m,)
    float32.  On the card all four must be contiguous and on one device.
    """
    if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[1]:
        raise ValueError(f"need A (n, K) and B (m, K), got {tuple(A.shape)} "
                         f"and {tuple(B.shape)}")
    n, K = A.shape
    m = B.shape[0]
    if tuple(na.shape) != (n,) or tuple(nb.shape) != (m,):
        raise ValueError(f"need na ({n},) and nb ({m},), got {tuple(na.shape)} "
                         f"and {tuple(nb.shape)}")
    tensors = (A, B, na, nb)
    if all(t.device.type == "cpu" for t in tensors):
        return pairwise_lp_ref(A, B, na, nb, clip=clip)
    if A.device.type != "cuda" or any(t.device != A.device for t in tensors):
        raise ValueError("A, B, na and nb must lie on one CUDA device (or all "
                         "on the CPU)")
    if A.dtype not in _FACTOR_DTYPES or B.dtype != A.dtype:
        raise TypeError(f"A and B must both be float32 or both bfloat16, got "
                        f"{A.dtype} and {B.dtype}")
    if na.dtype != torch.float32 or nb.dtype != torch.float32:
        raise TypeError(f"na and nb must be float32, got {na.dtype} and {nb.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("A, B, na and nb must be contiguous")
    out = torch.empty((n, m), dtype=torch.float32, device=A.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.pairwise_lp_launch(
            A.data_ptr(), B.data_ptr(), int(A.dtype == torch.bfloat16),
            na.data_ptr(), nb.data_ptr(), out.data_ptr(), n, m, K, int(clip),
            stream)
    if err != 0:
        msg = lib.pairwise_lp_error_string(err).decode()
        raise RuntimeError(f"pairwise_lp launch failed: {msg} (cudaError {err})")
    pairwise_lp.launches += 1
    return out


pairwise_lp.launches = 0
