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
# loaded.  runtime/compile_cache.py may point the builds at another
# directory (a fleet's shared kernel build cache, set_cache_dir); each
# library is loaded once per directory, so a process pointed at another
# directory really looks there, and the builds (misses) and each
# thread's first request for an already-built library (hits) are
# counted there.
#
# Every wrapper that launches a kernel counts one launch of it
# (count_launch) where it launches, and nowhere else: a run can show that
# its path went through the kernels by resetting `launch_counts` before it
# and reading them after.  A launch recorded into a CUDA graph runs
# nothing until the graph is replayed, so inside captured_launches() this
# thread's launches are kept apart, and the graph's owner counts them again
# at each replay (count_replay): the counts are the launches the card ran.

from __future__ import annotations

import contextlib
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

__all__ = ["KERNEL_SOURCES", "KERNELS", "FLASH_KERNELS", "build_kernel",
           "build_all", "load_kernel", "launch_counts", "reset_launch_counts",
           "count_launch", "captured_launches", "count_replay",
           "build_seconds"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# library name -> its source file under csrc/
KERNEL_SOURCES = {
    "flash_attention": "flash_attention.cu",
    "flash_attention_backward": "flash_attention_backward.cu",
    "paged_attention": "paged_attention.cu",
}
# the kernels, each with its launch counter: K1, K2 and K3 (the forward
# in flash_attention.cu, dQ and dK/dV in flash_attention_backward.cu),
# which every attention outside the decode engine's paged steps runs, and
# K4, the paged decode attention's two launches (splits, merge) in
# paged_attention.cu
FLASH_KERNELS = ("flash_attention", "flash_attention_dq",
                 "flash_attention_dkv")
KERNELS = FLASH_KERNELS + ("paged_decode_attention",)

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launch_counts = {name: 0 for name in KERNELS}
# library name -> seconds its last build took (absent: loaded from disk)
build_seconds: dict = {}
# library name -> what nvcc printed (registers, shared memory, spills)
build_logs: dict = {}

# the kernel build cache's directory (runtime/compile_cache.py sets it
# when it is enabled or disabled); None builds into BUILD_DIR
_CACHE_DIR: Path | None = None
# (library name, build directory) -> the library loaded from there
_LIBRARIES: dict = {}
_LOCK = threading.Lock()
# per thread, `loaded`: (name, directory) -> the library this thread
# has requested from there
_REQUESTED = threading.local()
# per thread, `counts`: the launches of the graph this thread captures
_CAPTURING = threading.local()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def count_launch(name: str) -> None:
    """One launch of kernel `name`: in launch_counts, or in the counts of
    the graph this thread is capturing (captured_launches)."""
    captured = getattr(_CAPTURING, "counts", None)
    (launch_counts if captured is None else captured)[name] += 1


@contextlib.contextmanager
def captured_launches():
    """A scope around a CUDA graph capture: yields a dict, kernel name ->
    the launches this thread records into the graph, which launch_counts
    does not count (the capture runs nothing)."""
    counts = {name: 0 for name in KERNELS}
    _CAPTURING.counts = counts
    try:
        yield counts
    finally:
        _CAPTURING.counts = None


def count_replay(counts: dict) -> None:
    """One replay of a graph whose capture recorded `counts`
    (captured_launches): its launches run now."""
    for name, count in counts.items():
        launch_counts[name] += count


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


def set_cache_dir(directory: str | None) -> None:
    """runtime/compile_cache.py: build into and load from `directory`
    from now on (None: BUILD_DIR again)."""
    global _CACHE_DIR
    _CACHE_DIR = Path(directory) if directory else None


def build_dir() -> Path:
    """Where the libraries are built and looked for: the kernel build
    cache when one is enabled (runtime/compile_cache.py), else
    BUILD_DIR."""
    return _CACHE_DIR or BUILD_DIR


def _library_path(name: str, directory: Path | None = None) -> Path:
    digest = hashlib.sha256()
    for path in [CSRC_DIR / KERNEL_SOURCES[name],
                 *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return ((build_dir() if directory is None else directory)
            / f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_kernel(name: str) -> Path:
    """Compile csrc/<source> into the build directory (build_dir())
    unless the library for this exact source is already there; returns
    the library's path.  A build counts one miss of the build cache."""
    return _build(name, build_dir())[0]


def _build(name: str, directory: Path) -> tuple:
    """(the library's path in `directory`, whether nvcc built it now)."""
    target = _library_path(name, directory)
    if target.exists():
        return target, False
    directory.mkdir(parents=True, exist_ok=True)
    source = CSRC_DIR / KERNEL_SOURCES[name]
    # build under a temporary name, then rename: a concurrent or
    # interrupted build never leaves a half-written library behind
    handle, partial = tempfile.mkstemp(suffix=".so", dir=directory)
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
    from ..runtime.compile_cache import record_miss
    record_miss()
    return target, True


def build_all() -> None:
    """Build every library at once, one nvcc process per source."""
    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
        list(pool.map(build_kernel, KERNEL_SOURCES))


def load_kernel(name: str) -> ctypes.CDLL:
    """The library `name` in the build directory, built at first use
    there and loaded once per directory.  A thread's first request for a
    library that was already built (on disk, or loaded) counts one hit
    of the build cache; later requests are one lookup in the thread's
    own table."""
    key = (name, _CACHE_DIR or BUILD_DIR)
    loaded = getattr(_REQUESTED, "loaded", None)
    if loaded is None:
        loaded = _REQUESTED.loaded = {}
    library = loaded.get(key)
    if library is not None:
        return library
    with _LOCK:
        path, built = _build(name, key[1])
        library = _LIBRARIES.get(key)
        if library is None:
            library = _LIBRARIES[key] = ctypes.CDLL(str(path))
    loaded[key] = library
    if not built:
        from ..runtime.compile_cache import record_hit
        record_hit()
    return library
