"""BENCHMARK.json against the benchmark's contract: its keys, the
characters of names and units, and that every cell, configuration,
traffic mix, driver and per-layer metric it names is a file of its own
that the harness finds by name."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "bench_h100"
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|heads|head_|"
                    r"latent|state|proj|expan|experts_per_tok|d_model|ffn")


def test_top_level_keys():
    assert list(BENCHMARK) == ["command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"]
    assert BENCHMARK["command"][:2] == ["python3", "bench_h100/run.py"]
    assert BENCHMARK["paths"] == ["bench_h100"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCHMARK[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end":
                    assert TEXT.match(entry[key]), entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))


def test_configs_are_files_under_paths():
    for config in BENCHMARK["configs"]:
        assert config["file"] == f"bench_h100/configs/{config['name']}.json"
        content = json.loads((ROOT / config["file"]).read_text())
        assert content["reduced"] == config["reduced"]
        assert content["source"] == config["source"]
        for key in config["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key), key
        assert any(cell["config"] == config["name"]
                   for cell in BENCHMARK["workloads"])


def test_cells_name_their_files():
    pairs = set()
    for cell in BENCHMARK["workloads"]:
        spec = json.loads((HERE / "workloads" / f"{cell['name']}.json")
                          .read_text())
        assert spec["config"] == cell["config"]
        assert spec["traffic"] == cell["traffic"]
        assert spec["chips"] == cell["chips"] in (1, 4)
        assert (HERE / "drivers" / f"{spec['driver']}.py").is_file()
        assert (HERE / "traffic" / f"{cell['traffic']}.json").is_file()
        assert len(cell["why"]) <= 200
        pairs.add((cell["config"], cell["traffic"]))
    assert len(pairs) == len(BENCHMARK["workloads"])


def test_metrics():
    cells = {cell["name"] for cell in BENCHMARK["workloads"]}
    e2e = {metric["name"]: metric for metric in BENCHMARK["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for metric in e2e.values():
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
        assert set(metric.get("workloads", cells)) <= cells
    for cell in cells:
        reported = [name for name, metric in e2e.items()
                    if cell in metric.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in metric.get("workloads", [])
                   for metric in BENCHMARK["per_layer"])
    layers = set()
    for metric in BENCHMARK["per_layer"]:
        assert (HERE / "metrics" / f"{metric['name']}.py").is_file()
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        moved = e2e[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", cells)
        if metric["name"].split(".")[0].endswith("_roofline") or \
                "mfu" in metric["name"]:
            assert metric["unit"] == "%"
        layers.add(metric["layer"])
    assert all("\n" not in layer for layer in layers)


def test_file_names_are_made_of_name_characters():
    for path in HERE.rglob("*"):
        if ".cache" in path.parts or "__pycache__" in path.parts:
            continue
        relative = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", relative), relative
