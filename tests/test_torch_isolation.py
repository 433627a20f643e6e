# The port stands alone: importing its speech-serving and training paths
# loads no JAX, no optax, no ml_dtypes and nothing of the JAX package, and
# no source file of the port (nor chip_smoke.py or chip_profile.py)
# imports them.

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "aiko_services_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "ml_dtypes", "aiko_services_tpu")


def _forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".")
               for name in FORBIDDEN)


def test_importing_the_main_path_loads_no_jax():
    script = (
        "import sys\n"
        "import aiko_services_tpu_torch.elements\n"
        "import aiko_services_tpu_torch.models\n"
        "import aiko_services_tpu_torch.models.transformer\n"
        "import aiko_services_tpu_torch.models.optim\n"
        "import aiko_services_tpu_torch.parallel\n"
        "import aiko_services_tpu_torch.pipeline\n"
        "import aiko_services_tpu_torch.runtime\n"
        "import aiko_services_tpu_torch.analyze\n"
        "import aiko_services_tpu_torch.observe\n"
        "print(' '.join(sorted(sys.modules)))\n")
    result = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    loaded = result.stdout.split()
    assert "aiko_services_tpu_torch.elements.ml" in loaded
    assert "aiko_services_tpu_torch.models.transformer" in loaded
    assert "aiko_services_tpu_torch.models.optim" in loaded
    assert [module for module in loaded if _forbidden(module)] == []


def _imports(path: pathlib.Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    modules = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            modules.append(node.module or "")
    return modules


def test_no_source_imports_jax_or_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                            ROOT / "chip_profile.py"]
    assert len(sources) > 40
    offenders = {str(path.relative_to(ROOT)): bad
                 for path in sources
                 if (bad := [module for module in _imports(path)
                             if _forbidden(module)])}
    assert offenders == {}
