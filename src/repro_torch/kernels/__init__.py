"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

  power_project  U[:, s, :] = (X ** powers[s]) @ R       (the sketch's scan)
  pairwise_lp    D = max(na + nb^T + A B^T, 0)           (every query strip)

Each wrapper (``ops.py``) takes a CUDA tensor to its kernel, or raises, and
a CPU tensor to the plain version (``ref.py``).  ``build.py`` compiles the
sources in ``repro_torch/csrc`` at first use.
"""
