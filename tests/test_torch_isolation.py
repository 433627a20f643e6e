# The port stands alone: importing its speech-serving, config-5 serving
# (LM generation, tokenizer, detector, sources), continuous decode engine
# (decode/, with the prefill engine of decode/disagg.py and the
# checkpoint keeper of decode/checkpoint.py), serving tier (serve/: the
# gateway, its admission, journal, disaggregation and federation
# policies), media, vision and toy elements, the native codec, the
# Checkpointer and training paths loads no JAX, no optax, no ml_dtypes and
# nothing of the JAX package, and no source file of the port (decode/
# and serve/ included; nor the chip scripts chip_smoke.py,
# chip_profile.py and chip_backward_ab.py) imports them.

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
        "import aiko_services_tpu_torch.models.detector\n"
        "import aiko_services_tpu_torch.models.tokenizer\n"
        "import aiko_services_tpu_torch.elements.compute\n"
        "import aiko_services_tpu_torch.parallel\n"
        "import aiko_services_tpu_torch.pipeline\n"
        "import aiko_services_tpu_torch.runtime\n"
        "import aiko_services_tpu_torch.analyze\n"
        "import aiko_services_tpu_torch.observe\n"
        "import aiko_services_tpu_torch.decode\n"
        "import aiko_services_tpu_torch.decode.disagg\n"
        "import aiko_services_tpu_torch.decode.checkpoint\n"
        "import aiko_services_tpu_torch.serve\n"
        "import aiko_services_tpu_torch.native.build\n"
        "import aiko_services_tpu_torch.utils.checkpoint\n"
        "print(' '.join(sorted(sys.modules)))\n")
    result = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    loaded = result.stdout.split()
    assert "aiko_services_tpu_torch.elements.ml" in loaded
    assert "aiko_services_tpu_torch.models.transformer" in loaded
    assert "aiko_services_tpu_torch.models.optim" in loaded
    for module in ("models.detector", "models.tokenizer", "elements.compute",
                   "elements.common_io", "elements.audio_io",
                   "elements.image_io", "decode.blocks", "decode.engine",
                   "decode.prefix", "decode.disagg", "decode.checkpoint",
                   "serve.gateway", "serve.policy", "serve.journal",
                   "serve.disagg", "serve.federation", "elements.toys",
                   "elements.vision", "elements.webcam_io",
                   "elements.gstreamer_io", "native", "native.build",
                   "utils.checkpoint"):
        assert f"aiko_services_tpu_torch.{module}" in loaded
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
    sources = sorted(PORT.rglob("*.py")) + sorted(ROOT.glob("chip_*.py"))
    assert len(sources) > 40
    assert {PORT / "decode" / name for name in (
        "__init__.py", "blocks.py", "engine.py", "prefix.py", "disagg.py",
        "checkpoint.py")} <= set(sources)
    assert {PORT / "serve" / name for name in (
        "__init__.py", "gateway.py", "policy.py", "journal.py", "disagg.py",
        "federation.py")} <= set(sources)
    offenders = {str(path.relative_to(ROOT)): bad
                 for path in sources
                 if (bad := [module for module in _imports(path)
                             if _forbidden(module)])}
    assert offenders == {}
