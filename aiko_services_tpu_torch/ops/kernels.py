# Building and loading the port's hand-written CUDA kernels.
#
# Each library is one source under csrc/ with a plain C interface, holding
# one or more kernels; the sources share the headers (csrc/*.cuh) they
# include.  At first use a source is compiled with nvcc for sm_90a
# (Hopper) into a shared library in build/kernels/ beside the package (a
# directory .gitignore lists) and loaded through ctypes.  No PyTorch
# header is compiled, so a build takes seconds, not minutes.  The
# library's file name carries a digest of the source and of every header,
# so an edited source or header is rebuilt and a stale library is never
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "KERNELS", "build_kernel", "build_all",
           "load_kernel", "launch_counts", "reset_launch_counts",
           "build_seconds"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# library name -> its source file under csrc/
KERNEL_SOURCES = {
    "flash_attention": "flash_attention.cu",
    "flash_attention_backward": "flash_attention_backward.cu",
}
# the kernels, each with its launch counter: the forward in
# flash_attention.cu, dQ and dK/dV in flash_attention_backward.cu
KERNELS = ("flash_attention", "flash_attention_dq", "flash_attention_dkv")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launch_counts = {name: 0 for name in KERNELS}
# library name -> seconds its last build took (absent: loaded from disk)
build_seconds: dict = {}
# library name -> what nvcc printed (registers, shared memory, spills)
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
    digest = hashlib.sha256()
    for path in [CSRC_DIR / KERNEL_SOURCES[name],
                 *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


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


def build_all() -> None:
    """Build every library at once, one nvcc process per source."""
    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
        list(pool.map(build_kernel, KERNEL_SOURCES))


def load_kernel(name: str) -> ctypes.CDLL:
    """The library `name`, built at first use and loaded once."""
    with _LOCK:
        library = _LIBRARIES.get(name)
        if library is None:
            library = ctypes.CDLL(str(build_kernel(name)))
            _LIBRARIES[name] = library
        return library
