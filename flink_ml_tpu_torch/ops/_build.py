"""Builds the port's CUDA and host C++ sources at first use and loads them
with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, under ``flink_ml_tpu_torch/_build/``
(listed in ``.gitignore``). The library's file name carries a hash of the
source and the flags, so an edited source builds anew and an unchanged one
is loaded from the earlier build. Nothing here runs at import time. Each
source's build, or the library found from an earlier one, is reported once
per process to ``observability/compilestats.py`` (``ml.compile`` under
``fn=<source>``), which records it once compile accounting is installed.

The host kernels (``csrc/host/*.cpp``, the native tier of ``native/``) build
the same way with ``g++`` into one library, :func:`load_host`: at first
use, content-addressed over every source and the flags, written to a
private name and renamed, reported as ``fn=host_native``. A missing
``g++`` or a failed build raises :class:`KernelBuildError`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

from flink_ml_tpu_torch.observability import compilestats
from flink_ml_tpu_torch.resilience.policy import KernelBuildError

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"

HOST_CSRC_DIR = CSRC_DIR / "host"
HOST_LIBRARY = "host_native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread",
             "-std=c++17")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ptxas' report (registers, shared memory, spills) of each source built by
#: this process, by source name
BUILD_LOGS: Dict[str, str] = {}

#: sources whose build (or cached library) this process has reported
_REPORTED = set()


def _report(name: str, ms: float, cached: bool) -> None:
    if name not in _REPORTED:
        _REPORTED.add(name)
        compilestats.note_build(name, ms, cached)


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
    t0 = time.perf_counter()
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
            # wall time from the common start until this build was
            # collected (the builds run at once)
            _report(name, (time.perf_counter() - t0) * 1000.0, cached=False)
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
    path = build(name)
    _report(name, 0.0, cached=True)  # a no-op when this process built it
    return ctypes.CDLL(str(path))


def _host_sources():
    return sorted(HOST_CSRC_DIR.glob("*.cpp"))


def host_library_path() -> Path:
    """Where ``csrc/host/*.cpp`` build to (content-addressed over every
    source, its name and the flags)."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in _host_sources():
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{HOST_LIBRARY}-{digest.hexdigest()[:16]}.so"


def build_host() -> Path:
    """Compiles ``csrc/host/*.cpp`` into one library with ``g++`` unless its
    current build exists."""
    out = host_library_path()
    if out.exists():
        return out
    sources = _host_sources()
    if not sources:
        raise KernelBuildError(f"no host kernel sources under {HOST_CSRC_DIR}")
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelBuildError(
            "g++ not found on PATH: the port's host kernels are built from "
            "csrc/host/ at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, *map(str, sources), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"g++ failed building {HOST_LIBRARY} (exit {proc.returncode}):"
                f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        _report(HOST_LIBRARY, (time.perf_counter() - t0) * 1000.0,
                cached=False)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load_host() -> ctypes.CDLL:
    """The built host-kernel library, loaded once per process."""
    path = build_host()
    _report(HOST_LIBRARY, 0.0, cached=True)
    return ctypes.CDLL(str(path))
