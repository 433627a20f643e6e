# Telemetry-name audit of the PyTorch/CUDA port: every counter / gauge /
# histogram name the port's serving, decode, pipeline, observe, transport
# and runtime layers write must appear in the README's observability
# documentation, which both packages share.  The scan and the matching
# rule are the JAX package's audit (test_telemetry_audit.py), pointed at
# the port's sources.

from pathlib import Path

import test_telemetry_audit as audit

PORT = Path(__file__).resolve().parent.parent / "aiko_services_tpu_torch"


def test_every_port_instrument_name_is_documented(monkeypatch):
    monkeypatch.setattr(audit, "PACKAGE", PORT)
    names = audit._instrument_names()
    assert len(names) >= 40, (
        f"audit scan looks broken: only {len(names)} instrument "
        f"names found")
    readme_text = audit.README.read_text()
    missing = {name: files for name, files in sorted(names.items())
               if not audit._documented(name, readme_text)}
    assert not missing, (
        "the port's telemetry names missing from the README "
        "observability/telemetry tables (document them in the "
        "'Telemetry reference' table):\n" + "\n".join(
            f"  {name}  ({', '.join(sorted(set(files)))})"
            for name, files in missing.items()))
