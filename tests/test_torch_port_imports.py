"""The port stands alone: no JAX, no flax, nothing of ``bmnas_tpu``.

Every module of ``bmnas_tpu_torch`` is imported in a fresh interpreter,
which must then hold no ``jax``, ``flax`` or ``bmnas_tpu`` module.
``chip_smoke.py`` is read for its imports. The port's serve entry runs on
CUDA unless asked for the CPU, and raises where there is no CUDA device.
"""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "bmnas_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax_or_reference():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import bmnas_tpu_torch\n"
        "names = ['bmnas_tpu_torch'] + [m.name for m in pkgutil.walk_packages("
        "bmnas_tpu_torch.__path__, 'bmnas_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'imported': names, 'modules': sorted(sys.modules)}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("cli.serve", "cli.mmimdb", "cli.mmimdb_found",
                 "ops.kernels.node_mixed", "ops.kernels.attention",
                 "ops.fusion_ops", "models.supernet", "search.bilevel",
                 "search.loop", "search.scheduler", "utils.experiment",
                 "visualize", "models.hcn", "models.inflated_resnet",
                 "models.ntu", "data.ntu", "models.resnext", "models.ego",
                 "data.ego", "cli.ego"):
        assert f"bmnas_tpu_torch.{name}" in res["imported"], name
    assert len(res["imported"]) >= 33
    bad = [m for m in res["modules"] if _forbidden(m)]
    assert not bad, bad


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_chip_smoke_imports_no_jax_or_reference():
    names = list(_imports(os.path.join(ROOT, "chip_smoke.py")))
    assert "torch" in names and "bmnas_tpu_torch.cli.serve" in names
    assert "bmnas_tpu_torch.cli.mmimdb" in names
    assert "bmnas_tpu_torch.cli.mmimdb_found" in names
    assert not [n for n in names if _forbidden(n)]


def test_port_sources_import_no_jax_or_reference():
    pkg = os.path.join(ROOT, "bmnas_tpu_torch")
    for dirpath, dirnames, files in os.walk(pkg):
        if "_build" in dirnames:  # build outputs, not sources
            dirnames.remove("_build")
        for f in files:
            if f.endswith(".py"):
                bad = [n for n in _imports(os.path.join(dirpath, f))
                       if _forbidden(n)]
                assert not bad, (f, bad)


def test_serve_raises_without_cuda_unless_cpu_asked(monkeypatch, tmp_path):
    from bmnas_tpu_torch.cli.serve import main_serve
    from bmnas_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_serve(["--task", "mmimdb", "--eval_exp_dir", str(tmp_path),
                    "--datadir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_kernel_module_builds_nothing_at_import():
    """Importing the kernel wrappers touches no nvcc and no build dir; the
    build happens at the first CUDA launch."""
    from bmnas_tpu_torch.ops.kernels import _build
    assert _build.CSRC.endswith(os.path.join("bmnas_tpu_torch", "csrc"))
    for src in ("found_cell.cu", "node_mixed.cu", "attention.cu",
                "cell_common.cuh"):
        assert os.path.exists(os.path.join(_build.CSRC, src))
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert not _build._LIBS
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    assert set(LAUNCHES) == {"attention", "found_cell", "node_mixed"}
