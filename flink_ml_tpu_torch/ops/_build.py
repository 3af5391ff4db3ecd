"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, under ``flink_ml_tpu_torch/_build/``
(listed in ``.gitignore``). The library's file name carries a hash of the
source and the flags, so an edited source builds anew and an unchanged one
is loaded from the earlier build. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

from flink_ml_tpu_torch.resilience.policy import KernelBuildError

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ptxas' report (registers, shared memory, spills) of each source built by
#: this process, by source name
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found on PATH or under /usr/local/cuda: the port's CUDA "
        "kernels are built from csrc/ at first use on a machine with the "
        "CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(name: str) -> Path:
    """Compiles ``csrc/<name>.cu`` unless its current build exists."""
    build_all([name])
    return library_path(name)


def build_all(names) -> None:
    """Compiles every ``csrc/<name>.cu`` of ``names`` whose current build
    does not exist, one ``nvcc`` for each, all started together; waits for
    every one of them before it raises on any that failed."""
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    try:
        for name in todo:
            # compile to a private name, then rename: a concurrent build
            # never sees a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            started.append((name, library_path(name), tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, out, tmp, proc in started:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed building {name}.cu (exit "
                              f"{proc.returncode}):\n{stdout}{stderr}")
                continue
            BUILD_LOGS[name] = stdout + stderr
            os.replace(tmp, out)
        if failed:
            raise KernelBuildError("\n".join(failed))
    finally:
        for _, _, tmp, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, loaded once per process."""
    return ctypes.CDLL(str(build(name)))
