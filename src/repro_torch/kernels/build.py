"""Builds the port's CUDA kernels from the sources in ``repro_torch/csrc``.

Each ``<name>.cu`` has a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout, at first use, and loaded with ``ctypes``.  The hash covers
the source, every shared header in ``csrc`` (``*.cuh``) and the flags, so
an edited source or header builds anew and an unchanged one is reused.
Sources that are missing their library are compiled in parallel, one
``nvcc`` each.  Nothing here runs when the module is
imported: the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["KERNELS", "BUILD_DIR", "build", "load", "ptxas_report", "sass"]

KERNELS = ("power_project", "pairwise_lp")

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_PTXAS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc was not found (on PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _library(name: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, all at once.

    Returns {name: seconds} for the sources compiled here (0.0 for a
    library that already existed).  Raises with the compiler's output if
    any build fails.
    """
    names = tuple(names)
    for name in names:
        if name not in KERNELS:
            raise ValueError(f"unknown kernel {name!r} (known: {KERNELS})")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started: Dict[str, Tuple[subprocess.Popen, Path, Path, float]] = {}
    seconds = {name: 0.0 for name in names}
    try:
        for name in names:
            out = _library(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started[name] = (proc, tmp, out, time.perf_counter())
        failures = []
        for name, (proc, tmp, out, t0) in started.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            _PTXAS[name] = log
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name}.cu "
                                f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    finally:
        for proc, tmp, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_library(name)))
            _LIBS[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said when this process built ``name`` (registers,
    shared memory, spills per instantiation); empty if it was reused."""
    return _PTXAS.get(name, "")


def sass(name: str) -> Optional[str]:
    """``cuobjdump -sass`` of kernel ``name``'s built library, or None when
    the toolkit beside ``nvcc`` has no ``cuobjdump``."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    return subprocess.run([str(tool), "-sass", str(_library(name))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
