"""Each driver at a toy size on the CPU through the harness's own path
(toy cells added as files alone), the result line's keys, and run.py's
refusal without a card."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from bench_h100 import harness
from bench_h100.tests import toy

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2**33 + 11


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    directory = tmp_path_factory.mktemp("cells")
    return directory, toy.write(directory)


@pytest.mark.parametrize("cell", ["toy_whisper.tones", "toy_decoder.chat"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_toy_cell_runs_through_the_harness(cells, cell, trace):
    directory, benchmark = cells
    result = harness.execute(benchmark, cell, SEED, 1.5, trace, "cpu",
                             time.perf_counter(), directory=directory)
    assert list(result)[:5] == KEYS
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    e2e, per_layer = harness.cell_metrics(benchmark, cell)
    wanted = per_layer if trace else e2e
    assert set(result["metrics"]) == {metric["name"] for metric in wanted}
    for metric in result["metrics"].values():
        assert metric["value"] > 0 and metric["unit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.loads(json.dumps(result, allow_nan=False))


def test_same_seed_same_traffic():
    from bench_h100 import traffic
    mix = dict(toy.CHAT)
    first = traffic.open_loop(mix, SEED, 3.0, 256)
    again = traffic.open_loop(mix, SEED, 3.0, 256)
    other = traffic.open_loop(mix, SEED + 1, 3.0, 256)
    assert [r.due_s for r in first] == [r.due_s for r in again]
    assert all((a.prompt == b.prompt).all() for a, b in zip(first, again))

    def work(requests):
        window = [r for r in requests if r.in_window]
        return (sorted(r.prompt.size for r in window),
                sorted(r.max_new for r in window))

    def classes(requests):
        return [(r.due_s, int(np.ceil(np.log2(r.prompt.size))),
                 int(np.ceil(np.log2(r.max_new)))) for r in requests]

    # another seed: the same sizes at the same due times, each arrival
    # keeping the power-of-two class of its lengths, in another order
    assert work(first) == work(other)
    assert classes(first) == classes(other)
    assert [r.prompt.size for r in first] != [r.prompt.size for r in other]


def test_run_refuses_without_a_card():
    done = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload",
         "whisper_small.transcribe_30s", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert done.returncode != 0
    assert done.stdout.strip() == ""


def test_run_refuses_an_unknown_cell():
    with pytest.raises(SystemExit):
        harness.cell_entry(harness.load_json(ROOT / "BENCHMARK.json"),
                           "no_such.cell")
