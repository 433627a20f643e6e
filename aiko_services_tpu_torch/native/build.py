# Build the native extension: python -m aiko_services_tpu_torch.native.build
#
# Direct g++ invocation against the running interpreter's headers (no
# pybind11/setuptools needed -- the extension uses the raw CPython API).
# Produces build/native/_sexpr_native-<digest><abi suffix> and loads it,
# so utils/sexpr.py switches to the native path in this process at once
# and in every later process at import.

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
from pathlib import Path

from . import SOURCE, extension_path, load

__all__ = ["build"]


def build(directory=None, verbose: bool = True) -> Path | None:
    """Build (unless already built from this source) and load the
    extension; its path, or None when g++ is missing or fails."""
    target = extension_path(directory)
    if not target.exists():
        target.parent.mkdir(parents=True, exist_ok=True)
        staging = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        include = sysconfig.get_paths()["include"]
        command = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                   f"-I{include}", str(SOURCE), "-o", str(staging)]
        try:
            result = subprocess.run(command, capture_output=True,
                                    text=True)
        except FileNotFoundError:
            if verbose:
                print("native build failed: g++ not found",
                      file=sys.stderr)
            return None
        if result.returncode != 0:
            staging.unlink(missing_ok=True)
            if verbose:
                print(f"native build failed:\n{result.stderr}",
                      file=sys.stderr)
            return None
        os.replace(staging, target)  # concurrent builders never see half
        if verbose:
            print(f"built {target}")
    return target if load(directory) else None


if __name__ == "__main__":
    sys.exit(0 if build() else 1)
