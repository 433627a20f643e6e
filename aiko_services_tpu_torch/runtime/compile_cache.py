# The kernel build cache: warm-start replicas skip the nvcc builds.
#
# The port's counterpart of the JAX package's runtime/compile_cache.py,
# with the same API (enable_compile_cache, disable_compile_cache,
# compile_cache_dir, cache_stats, thread_cache_snapshot,
# thread_cache_delta) and the same AIKO_COMPILE_CACHE variable.  What a
# replica rebuilds on the card is not an XLA executable but the CUDA
# libraries of the hand-written kernels (ops/kernels.py): each kernel
# source is compiled by nvcc for sm_90a into a shared library whose file
# name carries a digest of the source and its headers.  The cache
# directory IS that build directory: every process pointed at the same
# directory loads the libraries the fleet already built instead of
# running nvcc, so a warm replica's time-to-healthy is weight hand-off +
# library load, not a build per kernel source.  With no cache enabled
# the builds go to ops/kernels.py's fixed BUILD_DIR, as before.
#
# This module is the one place that counts, into the process-global
# metrics registry and per thread:
#
#   misses    an nvcc build that ops.kernels.build_kernel ran
#             (`compile_cache.misses`)
#   hits      the first request on a thread for a library that was
#             already built -- found on disk, or already loaded by this
#             process (`compile_cache.hits`); later requests on the same
#             thread count nothing
#   captures  a CUDA-graph capture (decode/engine.py _CapturedStep,
#             `compile_cache.captures`).  A warm replica cannot reuse
#             another engine's graphs: each binds that engine's own
#             static tensors.  So captures are REPORTED beside the
#             hits and misses, never required to be zero.
#
# The JAX module runs cold when its cache cannot be set up.  Here a
# directory that cannot be created or written raises, and so does a
# build that fails (ops/kernels.py): no replica ever falls back from a
# kernel to its plain version.

from __future__ import annotations

import os
import tempfile
import threading

from ..utils import get_logger

__all__ = ["enable_compile_cache", "disable_compile_cache",
           "compile_cache_dir", "cache_stats", "thread_cache_snapshot",
           "thread_cache_delta"]

_LOGGER = get_logger("compile_cache")

ENV_CACHE_DIR = "AIKO_COMPILE_CACHE"

_LOCK = threading.Lock()
_ENABLED_DIR: str | None = None

_HITS, _MISSES, _CAPTURES = 0, 1, 2


def compile_cache_dir() -> str | None:
    """The directory warm starts share: the explicitly enabled one, else
    the AIKO_COMPILE_CACHE environment value (set for spawned replica
    children via ProcessManager's env override; the builds follow it
    once enable_compile_cache() is called, as the `pipeline` command
    does)."""
    return _ENABLED_DIR or os.environ.get(ENV_CACHE_DIR) or None


def enable_compile_cache(directory: str | None = None) -> str | None:
    """Point the kernel builds at `directory` (default: the
    AIKO_COMPILE_CACHE environment variable).  Idempotent; returns the
    active directory, or None when no directory is configured (the
    builds stay in ops/kernels.py's BUILD_DIR).  Raises OSError when the
    directory cannot be created or written."""
    global _ENABLED_DIR
    directory = directory or os.environ.get(ENV_CACHE_DIR)
    if not directory:
        return None
    directory = os.path.abspath(str(directory))
    with _LOCK:
        if _ENABLED_DIR == directory:
            return directory
        os.makedirs(directory, exist_ok=True)
        # a build writes its library under a temporary name in this
        # directory, then renames it: prove both work now, not at the
        # first kernel launch of a replica at peak load
        handle, probe = tempfile.mkstemp(suffix=".probe", dir=directory)
        os.close(handle)
        os.unlink(probe)
        os.environ[ENV_CACHE_DIR] = directory
        _ENABLED_DIR = directory
        from ..ops import kernels
        kernels.set_cache_dir(directory)
        _LOGGER.info("kernel build cache at %s", directory)
        return directory


def disable_compile_cache() -> None:
    """Send the builds back to ops/kernels.py's BUILD_DIR (test hygiene:
    the setting is process-global)."""
    global _ENABLED_DIR
    with _LOCK:
        _ENABLED_DIR = None
        os.environ.pop(ENV_CACHE_DIR, None)
        from ..ops import kernels
        kernels.set_cache_dir(None)


# counts PER THREAD (ident -> [hits, misses, captures]): a library is
# requested and a graph captured on the thread that launches, and every
# virtual Process runs its services on its own event-loop thread -- so a
# replica's bring-up can be attributed exactly even while sibling
# replicas in the same OS process build or capture concurrently
_THREAD_COUNTS: dict[int, list] = {}


def _count(index: int, counter: str) -> None:
    from ..observe.metrics import get_registry
    get_registry().counter(counter).inc()
    ident = threading.get_ident()
    with _LOCK:  # pairs with thread_cache_snapshot's iteration
        _THREAD_COUNTS.setdefault(ident, [0, 0, 0])[index] += 1


def record_hit() -> None:
    """ops/kernels.py: a thread's first request for a library that was
    already built."""
    _count(_HITS, "compile_cache.hits")


def record_miss() -> None:
    """ops/kernels.py: nvcc built a library."""
    _count(_MISSES, "compile_cache.misses")


def record_capture() -> None:
    """decode/engine.py: a CUDA graph was captured."""
    _count(_CAPTURES, "compile_cache.captures")


def thread_cache_snapshot() -> dict:
    """{thread_ident: (hits, misses, captures)} at this moment; diff two
    snapshots over a known thread set to scope a bring-up's build
    traffic to exactly the threads that ran it."""
    with _LOCK:
        return {ident: tuple(entry)
                for ident, entry in _THREAD_COUNTS.items()}


def thread_cache_delta(before: dict, after: dict, idents) -> dict:
    """Hits/misses/captures accumulated between two snapshots on
    `idents` only."""
    totals = [0, 0, 0]
    for ident in set(idents):
        if ident is None:
            continue
        base = before.get(ident, (0, 0, 0))
        now = after.get(ident, (0, 0, 0))
        for index in range(3):
            totals[index] += now[index] - base[index]
    return {"hits": totals[_HITS], "misses": totals[_MISSES],
            "captures": totals[_CAPTURES]}


def cache_stats() -> dict:
    """Current counter values (zeros until a build or request is seen):
    read before/after a replica bring-up and diff them."""
    from ..observe.metrics import get_registry
    registry = get_registry()
    return {
        "dir": compile_cache_dir(),
        "hits": registry.counter("compile_cache.hits").value,
        "misses": registry.counter("compile_cache.misses").value,
        "captures": registry.counter("compile_cache.captures").value,
    }
