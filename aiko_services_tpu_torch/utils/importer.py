# Element module loader (capability parity with reference
# src/aiko_services/main/utilities/importer.py:24-40): loads element code by
# dotted module name or by file path, memoized.

from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path

__all__ = ["load_module", "unload_module"]

_MODULES_LOADED: dict[str, object] = {}


def load_module(module_descriptor: str):
    if module_descriptor in _MODULES_LOADED:
        return _MODULES_LOADED[module_descriptor]
    if module_descriptor.endswith(".py") or "/" in module_descriptor:
        path = Path(module_descriptor)
        name = path.stem
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or spec.loader is None:
            raise ImportError(f"Cannot load module from {module_descriptor}")
        module = importlib.util.module_from_spec(spec)
        sys.modules.setdefault(name, module)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(module_descriptor)
    _MODULES_LOADED[module_descriptor] = module
    return module


def unload_module(name: str) -> None:
    """Drop a module from BOTH import caches (sys.modules and the
    descriptor memo) so the next load_module(name) re-imports it."""
    sys.modules.pop(name, None)
    for key, module in list(_MODULES_LOADED.items()):
        if key == name or getattr(module, "__name__", None) == name:
            del _MODULES_LOADED[key]
