# Building and loading the port's hand-written CUDA kernels.
#
# Each kernel is one source under csrc/ with a plain C interface.  At first
# use it is compiled with nvcc for sm_90a (Hopper) into a shared library in
# build/kernels/ beside the package (a directory .gitignore lists) and
# loaded through ctypes.  No PyTorch header is compiled, so a build takes
# seconds, not minutes.  The library's file name carries a digest of the
# source, so an edited source is rebuilt and a stale library is never
# loaded.
#
# Every wrapper that launches a kernel adds one to its count in
# `launch_counts` where it launches, and nowhere else: a run can show that
# its path went through the kernels by resetting the counts before it and
# reading them after.

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "build_kernel", "load_kernel",
           "launch_counts", "reset_launch_counts", "build_seconds"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# kernel name -> its source file under csrc/
KERNEL_SOURCES = {
    "flash_attention": "flash_attention.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launch_counts = {name: 0 for name in KERNEL_SOURCES}
# kernel name -> seconds its last build took (absent: loaded from disk)
build_seconds: dict = {}
# kernel name -> what nvcc printed (registers, shared memory, spills)
build_logs: dict = {}

_LIBRARIES: dict = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path("/usr/local/cuda/bin/nvcc")
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels are built from csrc/ at first use and need the CUDA "
        "toolkit")


def _library_path(name: str) -> Path:
    source = CSRC_DIR / KERNEL_SOURCES[name]
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernel(name: str) -> Path:
    """Compile csrc/<source> into build/kernels/ unless the library for
    this exact source is already there; returns the library's path."""
    target = _library_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = CSRC_DIR / KERNEL_SOURCES[name]
    # build under a temporary name, then rename: a concurrent or
    # interrupted build never leaves a half-written library behind
    handle, partial = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(handle)
    command = [_nvcc(), *NVCC_FLAGS, "-o", partial, str(source)]
    start = time.perf_counter()
    result = subprocess.run(command, capture_output=True, text=True)
    elapsed = time.perf_counter() - start
    if result.returncode != 0:
        os.unlink(partial)
        raise RuntimeError(
            f"nvcc failed to build {source.name} (exit "
            f"{result.returncode}):\n{result.stdout}\n{result.stderr}")
    os.replace(partial, target)
    build_seconds[name] = elapsed
    build_logs[name] = result.stdout + result.stderr
    return target


def load_kernel(name: str) -> ctypes.CDLL:
    """The kernel's library, built at first use and loaded once."""
    with _LOCK:
        library = _LIBRARIES.get(name)
        if library is None:
            library = ctypes.CDLL(str(build_kernel(name)))
            _LIBRARIES[name] = library
        return library
