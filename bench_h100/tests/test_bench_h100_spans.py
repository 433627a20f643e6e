"""The readers of the port's program spans (metrics/_spans.py) on the toy
cells through the harness's traced path, and their silence on a
program that records no program spans."""

import time

import pytest

from bench_h100 import harness
from bench_h100.metrics import _spans
from bench_h100.tests import toy

SEED = 2**33 + 17
SPAN_METRICS = {
    "toy_whisper.tones": [("encode_ms.transcribe", "audio_s_per_s"),
                          ("decode_loop_ms.transcribe", "audio_s_per_s")],
    "toy_decoder.chat": [("decode_step_ms.serve", "itl_p90_ms"),
                         ("prefill_ms.serve", "ttft_p95_ms")]}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    directory = tmp_path_factory.mktemp("cells")
    benchmark = toy.write(directory)
    for cell, metrics in SPAN_METRICS.items():
        for name, moves in metrics:
            benchmark["per_layer"].append(
                {"name": name, "unit": "ms", "moves": moves,
                 "workloads": [cell]})
    return directory, benchmark


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_toy_cell_reads_its_program_spans(cells, cell):
    directory, benchmark = cells
    result = harness.execute(benchmark, cell, SEED, 1.5, True, "cpu",
                             time.perf_counter(), directory=directory)
    assert result["correct"] is True
    for name, _ in SPAN_METRICS[cell]:
        metric = result["metrics"][name]
        assert metric["value"] > 0 and metric["unit"] == "ms", name


def test_an_untraced_run_records_no_program_span(cells):
    from aiko_services_tpu_torch.observe.trace import PROGRAM
    directory, benchmark = cells
    since = time.perf_counter()
    harness.execute(benchmark, "toy_decoder.chat", SEED, 1.0, False, "cpu",
                    time.perf_counter(), directory=directory)
    assert PROGRAM.collect(since) == []


def test_the_readers_are_silent_without_the_recorder(monkeypatch):
    from aiko_services_tpu_torch.observe import trace
    monkeypatch.delattr(trace, "PROGRAM")
    record = {}
    assert _spans.window_spans(record) is None
    assert _spans.mean_device_ms(record, "asr.encode") is None


def test_a_window_reads_its_own_spans_once():
    record = {"program_spans": [
        {"name": "engine.decode", "start_s": 0.0, "end_s": 0.5,
         "device_ms": 400.0},
        {"name": "engine.decode", "start_s": 1.0, "end_s": 1.5,
         "device_ms": 500.0},
        {"name": "queue:engine", "start_s": 0.0, "end_s": 0.25,
         "device_ms": None}]}
    assert _spans.mean_device_ms(record, "engine.decode") == 450.0
    assert _spans.mean_device_ms(record, "engine.prefill") is None
    # a window's spans are harvested once per run, then kept in its record
    unread = {}
    first = _spans.window_spans(unread)
    assert _spans.window_spans(unread) is first
    assert _spans.window_spans({}) == []
