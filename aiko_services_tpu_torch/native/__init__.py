# Native extension loader: exposes sexpr_parse_native, the C++ parser of
# native/sexpr_codec.cpp, or None while the extension is not built.
# Build it (and load it into the running process) with:
#   python -m aiko_services_tpu_torch.native.build
#
# The extension is built into build/native/ beside the package (a
# directory .gitignore lists), under a file name that carries a digest of
# the source, so an edited source is rebuilt and a stale library is never
# loaded.  It is loaded at import when present.  An extension that is not
# built leaves the Python parser in use: utils/sexpr.py takes the native
# path only while sexpr_parse_native is set (the JAX package's
# native/__init__.py has the same contract).

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import sysconfig
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "extension_path", "load",
           "install_parse_error", "sexpr_parse_native"]

SOURCE = Path(__file__).resolve().parent / "sexpr_codec.cpp"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "native")

sexpr_parse_native = None
_ext = None
_parse_error = None  # the exception class utils.sexpr installs


def extension_path(directory=None) -> Path:
    """Where the extension built from this source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return Path(directory or BUILD_DIR) / f"_sexpr_native-{digest}{suffix}"


def _parse(payload):
    if isinstance(payload, str):
        payload = payload.encode("latin-1")
    return _ext.parse_bytes(payload)


def load(directory=None) -> bool:
    """Load the extension built from this source in `directory`
    (build/native/ by default); True when the native path is live."""
    global _ext, sexpr_parse_native
    if not Path(directory or BUILD_DIR).is_dir():
        return False  # nothing built: no need to read the source
    path = extension_path(directory)
    if not path.exists():
        return False
    name = f"{__name__}._sexpr_native"
    loader = importlib.machinery.ExtensionFileLoader(name, str(path))
    spec = importlib.util.spec_from_file_location(name, path, loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    if _parse_error is not None:
        module.set_parse_error(_parse_error)
    _ext = module
    sexpr_parse_native = _parse
    return True


def install_parse_error(exception_class) -> None:
    """The class the native parser raises on a malformed payload (kept
    for an extension loaded later)."""
    global _parse_error
    _parse_error = exception_class
    if _ext is not None:
        _ext.set_parse_error(exception_class)


load()
