"""The port's standing rules: it imports neither JAX nor the JAX package,
nothing it makes from nothing lands on the CPU unless asked, and TF32 is off.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.core import SketchConfig, projections
from repro_torch.index import ActiveSegment, SketchIndex, SketchReservoir, load_index
from repro_torch.runtime import SketchKnnService
from repro_torch.device import resolve_device
from repro_torch.kernels import build

PKG = pathlib.Path(repro_torch.__file__).resolve().parent
SRC = PKG.parent

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
print(json.dumps(sorted(sys.modules)))
"""


def test_importing_every_module_leaves_jax_and_repro_out():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    loaded = json.loads(out.splitlines()[-1])
    for mod in ("repro_torch.engine.api", "repro_torch.convert", "repro_torch.checkpoint",
                "repro_torch.obs.trace", "repro_torch.index.store",
                "repro_torch.index.planner", "repro_torch.runtime.serve"):
        assert mod in loaded
    banned = [m for m in loaded
              if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton")]
    assert banned == []


def test_no_source_file_names_jax_or_the_reference_package_in_an_import():
    paths = list(PKG.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    assert {"checkpoint.py", "metrics.py", "planner.py", "store.py", "serve.py",
            "chip_smoke.py"} <= {p.name for p in paths}
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, name)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_constructors_default_to_the_card_and_raise_without_cuda(no_cuda, tmp_path):
    spec = projections.ProjectionSpec()
    key = projections.ProjectionKey(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        projections.projection_block(key, 0, 0, 8, 4, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        projections.projection_matrix(key, 0, 16, 4, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.sketch_from_reference(torch.zeros(2, 3, 4).numpy(), torch.zeros(2, 3).numpy())
    cfg = SketchConfig(p=4, k=8, block_d=16)
    path = SketchIndex(cfg, device="cpu").save(str(tmp_path / "idx"))
    for make in (lambda: SketchIndex(cfg), lambda: SketchKnnService(cfg),
                 lambda: load_index(path), lambda: SketchIndex.load(path),
                 lambda: SketchKnnService.load(path),
                 lambda: ActiveSegment(cfg, 4), lambda: SketchReservoir(cfg, 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # asked for explicitly, the CPU works
    assert projections.projection_matrix(key, 0, 16, 4, spec, device="cpu").shape == (16, 4)
    assert SketchKnnService(cfg, device="cpu").index.device == torch.device("cpu")
    assert load_index(path, device="cpu").n_live == 0


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


def test_tf32_is_off_after_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
