"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain references import nothing of the program (top-level module names
compared whole: the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
JAX = {"jax", "jaxlib", "flax", "aiko_services_tpu"}
PROGRAM = "aiko_services_tpu_torch"


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(directory: Path) -> list:
    return [path for path in directory.rglob("*.py")
            if ".cache" not in path.parts]


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources(HERE):
        assert not imported(path) & JAX, path


def test_references_import_nothing_of_the_program():
    for path in sources(HERE / "reference"):
        assert PROGRAM not in imported(path), path


def test_the_isolation_check_compares_whole_names(monkeypatch):
    import sys
    from bench_h100 import harness
    monkeypatch.setitem(sys.modules, "aiko_services_tpu_torch_extra",
                        sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "aiko_services_tpu.models", sys)
    assert harness.forbidden_modules() == ["aiko_services_tpu"]
