"""Build the CUDA sources under ``bmnas_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``bmnas_tpu_torch/_build/<name>-<hash>.so`` at first use, then
loaded with ``ctypes``. The hash covers the source, every header in
``csrc`` and the flags, so an edited source rebuilds and an unchanged one is
reused. A build failure raises; nothing falls back to another path.

Nothing here runs at import time: the CPU-only test host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the port's "
                       "CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    tmp = f"{out}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, shared memory, spills) of the built
    library of ``csrc/<name>.cu``."""
    with open(_lib_path(name) + ".log") as f:
        return f.read()


def build_all(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together."""
    with _LOCK:
        todo = [(n, _lib_path(n)) for n in names]
        todo = [(n, p) for n, p in todo if not os.path.exists(p)]
        procs = [(n, p, _start(n, p)) for n, p in todo]
        errors = []
        for n, p, proc in procs:
            try:
                _finish(n, p, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str, binder: Callable[[ctypes.CDLL], ctypes.CDLL]
         ) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    its C interface declared by ``binder`` once, when it is first loaded."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = _LIBS[name] = binder(ctypes.CDLL(_lib_path(name)))
        return lib
