"""The harness every cell runs through: it finds the cell, its
configuration, its traffic mix and its driver by name, checks the cards,
lets the driver set up, measure and judge its window, reads the
per-layer metrics from the traced run, and prints the result."""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from . import traffic as traffic_module

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aiko_services_tpu")


@dataclass
class Outcome:
    """What a driver hands back: its end-to-end values, the record the
    per-layer readers read, what it attempted and what failed, the
    numbers compared with their limits, and the peak memory read right
    after the window."""
    e2e: dict
    record: dict
    attempted: int
    failed: int
    checks: list                  # [(name, value, limit)], value <= limit
    memory_peak_bytes: int


@dataclass
class Context:
    cell: str
    spec: dict                    # workloads/<cell>.json
    config: dict                  # configs/<config>.json
    traffic: dict                 # traffic/<mix>.json
    seed: int
    seconds: float
    trace: bool
    device: str                   # "cuda" on the card; "cpu" in tests
    chips: int
    started: float                # process start, perf_counter
    control: str | None = None    # a control run (control.py) only
    setup_s: float | None = None
    profile: object = None

    def note(self, step: str) -> None:
        """Say on standard error how far set-up has come."""
        print(f"[{self.cell}] {step} at "
              f"{time.perf_counter() - self.started:.3f} s",
              file=sys.stderr, flush=True)

    def setup_done(self) -> None:
        """Set-up ends here: the first timed request follows."""
        self.setup_s = time.perf_counter() - self.started
        self.note("set-up done")

    @contextlib.contextmanager
    def traced(self):
        """The measured window, under torch.profiler in a traced run."""
        import torch
        if not self.trace:
            yield
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device != "cpu":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profile = torch.profiler.profile(activities=activities)
        with profile:
            with torch.profiler.record_function("bench.window"):
                yield
            if self.device != "cpu":
                torch.cuda.synchronize()
        self.profile = profile


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise SystemExit(f"missing {path}")
    return json.loads(path.read_text())


def cell_entry(benchmark: dict, name: str) -> dict:
    for entry in benchmark["workloads"]:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no cell {name!r} in BENCHMARK.json")


def cell_metrics(benchmark: dict, name: str) -> tuple:
    """(end-to-end, per-layer) metric entries this cell reports."""
    e2e = [metric for metric in benchmark["end_to_end"]
           if name in metric.get("workloads", [name])]
    reported = {metric["name"] for metric in e2e}
    per_layer = [metric for metric in benchmark["per_layer"]
                 if (name in metric["workloads"] if "workloads" in metric
                     else metric["moves"] in reported)]
    return e2e, per_layer


def load_reader(name: str, directory: Path):
    """metrics/<name>.py's read(record) -> number or None."""
    path = directory / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no reader for per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        "bench_h100_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, a JAX library's or
    the JAX package's (compared as whole names: the port's name begins
    with the JAX package's)."""
    tops = {module.split(".")[0] for module in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as error:
        return f"nvidia-smi unavailable: {error}"
    return " | ".join(done.stdout.strip().splitlines())


def set_cache_dirs(root: Path) -> Path:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths: only a cell's first run there builds."""
    cache = root / "bench_h100" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    return cache / "kernels"


def execute(benchmark: dict, name: str, seed: int, seconds: float,
            trace: bool, device: str, started: float,
            directory: Path = HERE, control: str | None = None) -> dict:
    """One run of cell `name` on `device`: the result's dictionary, with
    "checks" last.  `directory` holds configs/, workloads/, traffic/ and
    metrics/ (the benchmark's own, or a test's)."""
    entry = cell_entry(benchmark, name)
    spec = load_json(directory / "workloads" / f"{name}.json")
    context = Context(
        cell=name, spec=spec,
        config=load_json(directory / "configs" / f"{entry['config']}.json"),
        traffic=traffic_module.load(entry["traffic"],
                                    directory / "traffic"),
        seed=int(seed), seconds=float(seconds), trace=bool(trace),
        device=device, chips=int(entry["chips"]), started=started,
        control=control)
    driver = importlib.import_module(f"bench_h100.drivers.{spec['driver']}")
    outcome = driver.run(context)
    e2e, per_layer = cell_metrics(benchmark, name)
    metrics = {}
    device_info = {}
    breakdown = None
    if trace:
        from . import trace as trace_module
        record = dict(outcome.record)
        record.update(trace_module.read_profile(context.profile))
        for metric in per_layer:
            readers = directory / "metrics"
            if not (readers / f"{metric['name']}.py").is_file():
                readers = HERE / "metrics"
            value = load_reader(metric["name"], readers)(record)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
        device_info = {"busy_s": record["busy_s"],
                       "window_s": record["window_s"]}
        breakdown = record["breakdown"]
    else:
        values = dict(outcome.e2e, setup_s=context.setup_s)
        for metric in e2e:
            metrics[metric["name"]] = {"value": values[metric["name"]],
                                       "unit": metric["unit"]}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{', '.join(found)}")
    result = {"correct": all(value <= limit
                             for _, value, limit in outcome.checks),
              "attempted": int(outcome.attempted),
              "failed": int(outcome.failed),
              "metrics": metrics,
              "device": device_record(device, context.chips,
                                      outcome.memory_peak_bytes)}
    result["device"].update(device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in outcome.checks}
    return result


def device_record(device: str, chips: int, peak: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": int(peak)}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def parse(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="bench_h100/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv, started: float) -> int:
    args = parse(argv)
    kernel_cache = set_cache_dirs(ROOT)
    benchmark = load_json(ROOT / "BENCHMARK.json")
    chips = int(cell_entry(benchmark, args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {count}", file=sys.stderr)
        return 3
    from aiko_services_tpu_torch.ops import kernels
    kernels.set_cache_dir(str(kernel_cache))
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    result = execute(benchmark, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", started)
    for name, check in result["checks"].items():
        print(f"check {name}={check['value']!r} "
              f"limit={check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
