# The port's program spans (aiko_services_tpu_torch/observe/trace.py,
# PROGRAM): nothing recorded and nothing built while nothing records;
# the span tree of a coalesced speech group (flush > gather, element >
# the speech element's phases, split) on the fused and chained paths;
# the decode engine's step tree and its queue:engine intervals; the
# engine's phase times counted from a request's arrival and recorded at
# admission and first token; the Chrome export's lane 0; the ring's
# dropped count.

import ast
import pathlib
import queue
import time
import tracemalloc

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.decode import DecodeEngine
from aiko_services_tpu_torch.models import SafetensorsFile
from aiko_services_tpu_torch.models import transformer as torch_lm
from aiko_services_tpu_torch.observe import MetricsRegistry, trace
from aiko_services_tpu_torch.observe.trace import (
    PROGRAM, Tracer, record_program_spans)
from aiko_services_tpu_torch.pipeline import create_pipeline
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.transport import reset_brokers

ASSET = pathlib.Path(__file__).parent / "assets" / "asr_tones.safetensors"
MODULE = "aiko_services_tpu_torch.elements"
TINY = dict(vocab_size=64, n_layers=2, n_heads=2, n_kv_heads=2,
            d_model=32, d_ff=64, max_seq_len=64, dtype="float32")


@pytest.fixture
def recorded():
    """Program spans recorded for the test: yields the perf_counter
    time recording began (collect's `since`)."""
    since = time.perf_counter()
    record_program_spans(True)
    try:
        yield since
    finally:
        record_program_spans(False)


def _by_id(spans: list) -> dict:
    return {span["span_id"]: span for span in spans}


def _children(spans: list, parent: dict, name: str) -> list:
    return [span for span in spans if span["parent"] == parent["span_id"]
            and span["name"] == name]


class _Counting:
    """A constructor stand-in counting its calls."""

    def __init__(self, real):
        self.real = real
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.real(*args, **kwargs)


def test_a_span_while_nothing_records_builds_nothing(monkeypatch):
    record_program_spans(False)
    assert not torch.autograd.profiler._is_profiler_enabled
    record_function = _Counting(torch.profiler.record_function)
    event = _Counting(torch.cuda.Event)
    opened = _Counting(trace._Span)
    kept = _Counting(trace.ProgramSpan)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(trace, "_Span", opened)
    monkeypatch.setattr(trace, "ProgramSpan", kept)
    tracer = Tracer()
    first = tracer.span("engine.decode", "r1", device=True)
    # the shared no-op context, whatever the name, key or device
    assert first is tracer.span("asr.encode") is PROGRAM.span("x")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with tracer.span("engine.decode", "r1", device=True):
                pass
            tracer.interval("queue:engine", 1.0, 2.0, "r1")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [stat for stat in after.compare_to(before, "filename")
             if stat.traceback[0].filename == trace.__file__
             and stat.size_diff > 0]
    assert grown == []
    assert record_function.calls == event.calls == 0
    assert opened.calls == kept.calls == 0
    assert len(tracer.program) == 0 and tracer.collect() == []


def test_spans_record_under_a_profiler_and_nest_by_thread():
    tracer = Tracer()
    since = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as profile:
        with tracer.span("outer", key="r7"):
            with tracer.span("inner", device=True):
                torch.ones(4).add_(1)
    spans = tracer.collect(since)
    outer, inner = (next(span for span in spans if span["name"] == name)
                    for name in ("outer", "inner"))
    assert outer["parent"] is None and inner["parent"] == outer["span_id"]
    # a span given no key inherits its parent's
    assert outer["key"] == inner["key"] == "r7"
    assert outer["start_s"] <= inner["start_s"] <= inner["end_s"] \
        <= outer["end_s"]
    # on the CPU a device span's device time is its host duration
    assert inner["device_ms"] == pytest.approx(
        (inner["end_s"] - inner["start_s"]) * 1e3)
    assert outer["device_ms"] is None
    # each span entered record_function: the profiler names both
    names = {event.name() for event in
             profile.profiler.kineto_results.events()}
    assert {"outer", "inner"} <= names
    # nothing records once the profiler has stopped
    with tracer.span("after"):
        pass
    assert all(span["name"] != "after" for span in tracer.collect())


def test_the_ring_counts_what_it_drops(recorded, monkeypatch):
    monkeypatch.setattr(Tracer, "PROGRAM_RING", 4)
    tracer = Tracer()
    for index in range(7):
        with tracer.span(f"s{index}"):
            pass
    assert tracer.program_dropped == 3
    assert [span["name"] for span in tracer.collect()] == [
        "s3", "s4", "s5", "s6"]
    truncation = [event for event in tracer.chrome_events()
                  if event.get("cat") == "truncation"]
    assert truncation and truncation[0]["args"]["dropped_spans"] == 3


def test_chrome_events_carry_program_spans_on_lane_zero(recorded):
    tracer = Tracer()
    with tracer.span("engine.step"):
        with tracer.span("engine.prefill", "r1", device=True):
            pass
    tracer.interval("queue:engine", time.perf_counter() - 0.25,
                    time.perf_counter(), "r1")
    events = [event for event in tracer.chrome_events()
              if event.get("cat") == "program"]
    assert [event["name"] for event in events] == [
        "engine.prefill", "engine.step", "queue:engine"]
    assert all(event["tid"] == 0 and event["ph"] == "X"
               for event in events)
    prefill, step, wait = events
    assert prefill["args"]["program_parent"] == step["args"]["program_span"]
    assert prefill["args"]["key"] == "r1" and "device_ms" in prefill["args"]
    assert wait["dur"] == pytest.approx(0.25e6, rel=1e-3)
    # spans line up with the frame tracer's timeline (to_us)
    assert step["ts"] <= prefill["ts"] <= trace.now_us()


# -- a coalesced speech group ---------------------------------------------


def _asr_parameters() -> dict:
    container = SafetensorsFile(ASSET)
    metadata = {key: ast.literal_eval(value)
                for key, value in container.metadata.items()}
    container.close()
    return {**{key: value for key, value in metadata["config"].items()
               if key != "max_text_len"},
            "max_tokens": 4, "weights": str(ASSET), "micro_batch": 2,
            "micro_batch_wait_ms": 60000}


@pytest.mark.parametrize("fused", [True, False])
def test_a_speech_group_yields_the_flush_tree(recorded, fused):
    reset_brokers()
    definition = {
        "name": "spans", "graph": ["(asr (text))"],
        "parameters": {"device": "cpu"},
        "elements": [
            {"name": "asr", "input": [{"name": "audio"}],
             "output": [{"name": "tokens"}],
             "parameters": {**_asr_parameters(),
                            "micro_batch_fused": fused},
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "SpeechToText"}}},
            {"name": "text", "input": [{"name": "tokens"}],
             "output": [{"name": "text"}],
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "TokensToText"}}}]}
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        streams = [pipeline.create_stream(f"s{index}",
                                          queue_response=responses)
                   for index in range(2)]
        audio = np.zeros((1, 16000), np.float32)
        for stream in streams:
            pipeline.create_frame(stream, {"audio": audio})
        for _ in streams:
            responses.get(timeout=120)
    finally:
        process.terminate()
        reset_brokers()
    spans = PROGRAM.collect(recorded)
    flushes = [span for span in spans if span["name"] == "flush:asr"]
    assert len(flushes) == 1
    flush = flushes[0]
    assert flush["parent"] is None and flush["key"]
    tree = [span for span in spans if span["thread"] == flush["thread"]]
    for name in ("gather:asr", "element:asr", "split:asr"):
        assert len(_children(tree, flush, name)) == 1, name
    element = _children(tree, flush, "element:asr")[0]
    phases = ["asr.frontend", "asr.encode", "asr.cross_kv", "asr.decode"]
    found = [_children(tree, element, name) for name in phases]
    assert all(len(spans) == 1 for spans in found), phases
    starts = [spans[0]["start_s"] for spans in found]
    assert starts == sorted(starts)
    for spans in found:
        assert spans[0]["device_ms"] is not None
    # the downstream element runs inside the flush, with its own span
    assert len(_children(tree, flush, "element:text")) == 2
    # every span of the group shares the group's key
    members = _by_id(tree)
    for span in tree:
        root = span
        while root["parent"] is not None:
            root = members[root["parent"]]
        if root is flush:
            assert span["key"] == flush["key"], span["name"]


# -- the decode engine ------------------------------------------------------


def _engine(registry=None) -> DecodeEngine:
    config = torch_lm.TransformerConfig(**TINY)
    params = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                  device="cpu")
    return DecodeEngine(params, config, decode_slots=2, kv_block_size=8,
                        registry=registry)


def test_an_engine_step_yields_its_tree_and_queue_intervals(recorded):
    engine = _engine()
    arrived = time.perf_counter() - 0.5
    rng = np.random.default_rng(0)
    for index in range(2):
        engine.submit(f"r{index}", rng.integers(0, 64, 9), 4,
                      arrived_at=arrived)
    engine.step()
    admitted = {slot.request.request_id: slot.request.admitted_at
                for slot in engine.slots}
    spans = PROGRAM.collect(recorded)
    steps = [span for span in spans if span["name"] == "engine.step"]
    assert len(steps) == 1
    step = steps[0]
    admit = _children(spans, step, "engine.admit")
    assert len(admit) == 1
    prefills = _children(spans, admit[0], "engine.prefill")
    assert sorted(span["key"] for span in prefills) == ["r0", "r1"]
    assert all(span["device_ms"] is not None for span in prefills)
    assert len(_children(spans, step, "engine.decode")) == 1
    waits = {span["key"]: span for span in spans
             if span["name"] == "queue:engine"}
    assert set(waits) == {"r0", "r1"}
    for request_id, span in waits.items():
        # an interval is a wait, run by no thread
        assert span["start_s"] == arrived and span["thread"] is None
        assert span["end_s"] - span["start_s"] == pytest.approx(
            admitted[request_id] - arrived, abs=1e-9)
        assert span["end_s"] - span["start_s"] >= 0.5


def test_engine_times_count_from_arrival_and_record_early():
    registry = MetricsRegistry()
    engine = _engine(registry)
    arrived = time.perf_counter() - 2.0
    engine.submit("early", np.arange(1, 10), 3, arrived_at=arrived)
    engine.submit("now", np.arange(1, 12), 3)
    engine.step()
    # queue wait at admission and TTFT at the first token, before either
    # request completes
    assert registry.histogram("decode.queue_wait_s").count == 2
    assert registry.histogram("decode.ttft_s").count == 2
    assert registry.histogram("decode.total_s").count == 0
    completions = {}
    while engine.has_work():
        for completion in engine.step().completions:
            completions[completion.request_id] = completion.stats
    early, now = completions["early"], completions["now"]
    assert early["queue_wait_s"] >= 2.0 and early["ttft_s"] >= 2.0
    assert early["total_s"] >= 2.0
    assert now["queue_wait_s"] < 1.0 and now["ttft_s"] < 1.0
    assert early["ttft_s"] == pytest.approx(
        early["queue_wait_s"] + early["prefill_s"])
    assert registry.histogram("decode.queue_wait_s").count == 2
    assert registry.histogram("decode.ttft_s").count == 2
    assert registry.histogram("decode.total_s").count == 2


def test_a_continuous_frame_splits_its_time_into_queue_and_compute(
        monkeypatch):
    """LMGenerate `continuous: true`: the engine's slot wait goes to
    time_queue_{node} and the rest of the frame's time since its submit
    to time_{node}, both counted from the one starting point."""
    from aiko_services_tpu_torch.observe.telemetry import PipelineTelemetry
    rows = []
    record_engine_frame = PipelineTelemetry.record_engine_frame

    def keep_rows(self, frame, node, stats_rows):
        rows.append((frame.frame_id, list(stats_rows)))
        record_engine_frame(self, frame, node, stats_rows)

    monkeypatch.setattr(PipelineTelemetry, "record_engine_frame",
                        keep_rows)
    reset_brokers()
    definition = {
        "name": "split", "graph": ["(lm)"],
        "parameters": {"device": "cpu"},
        "elements": [
            {"name": "lm", "input": [{"name": "tokens"}],
             "output": [{"name": "generated"}],
             "parameters": {**TINY, "max_new_tokens": 4,
                            "continuous": True, "decode_slots": 1,
                            "kv_block_size": 8},
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "LMGenerate"}}}]}
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        stream = pipeline.create_stream("s", queue_response=responses)
        began = time.perf_counter()
        for index in range(3):
            pipeline.create_frame(
                stream, {"tokens": np.arange(1, 8 + index)[None]})
        frames = [responses.get(timeout=120)[1] for _ in range(3)]
        elapsed = time.perf_counter() - began
    finally:
        process.terminate()
        reset_brokers()
    stats = dict(rows)
    assert sorted(stats) == sorted(frame.frame_id for frame in frames)
    waited = 0.0
    for frame in frames:
        (row,) = stats[frame.frame_id]
        queue_s, compute_s = (frame.metrics["time_queue_lm"],
                              frame.metrics["time_lm"])
        assert queue_s == row["queue_wait_s"]
        assert 0.0 <= row["queue_wait_s"] <= row["ttft_s"] <= row["total_s"]
        # the response comes after the completion, and inside the test's
        # own window from the first create_frame
        assert row["total_s"] <= queue_s + compute_s <= elapsed
        waited = max(waited, queue_s)
    # one slot: the later frames wait for the earlier ones
    assert waited > 0.0
