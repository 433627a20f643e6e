# The port's speech-serving path end to end on the CPU: audio in ->
# SpeechToText(weights=asr_tones) -> TokensToText -> exact text out, as
# the JAX package's tests/test_asr_correctness.py runs it, through the
# port's own Process / create_pipeline with `device: "cpu"`.

import ast
import pathlib
import queue
import time

import numpy as np
import pytest

from aiko_services_tpu_torch.models import SafetensorsFile
from aiko_services_tpu_torch.pipeline import (
    DefinitionError, PipelineElement, StreamEvent, create_pipeline)
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.transport import reset_brokers

ASSET = pathlib.Path(__file__).parent / "assets" / "asr_tones.safetensors"
MODULE = "aiko_services_tpu_torch.elements"


def _metadata() -> dict:
    container = SafetensorsFile(ASSET)
    metadata = {key: ast.literal_eval(value)
                for key, value in container.metadata.items()}
    container.close()
    return metadata


_METADATA = _metadata()
LABELS = {float(freq): label for freq, label in _METADATA["labels"].items()}
SECONDS, SAMPLE_RATE = float(_METADATA["seconds"]), 16000
ASR_PARAMETERS = {**{key: value for key, value in _METADATA["config"].items()
                     if key != "max_text_len"},
                  "max_tokens": 9, "weights": str(ASSET)}


@pytest.fixture(autouse=True)
def clean_brokers():
    reset_brokers()
    yield
    reset_brokers()


def _tone(frequency: float) -> np.ndarray:
    t = np.arange(int(SECONDS * SAMPLE_RATE)) / SAMPLE_RATE
    return np.sin(2 * np.pi * frequency * t).astype(np.float32)


def _definition(device="cpu", asr_parameters=None, parameters=None):
    pipeline_parameters = {"device": device} if device else {}
    pipeline_parameters.update(parameters or {})
    return {
        "name": "asr_correct",
        "graph": ["(asr (text))"],
        "parameters": pipeline_parameters,
        "elements": [
            {"name": "asr", "input": [{"name": "audio"}],
             "output": [{"name": "tokens"}],
             "parameters": {**ASR_PARAMETERS, **(asr_parameters or {})},
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "SpeechToText"}}},
            {"name": "text", "input": [{"name": "tokens"}],
             "output": [{"name": "text"}],
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "TokensToText"}}},
        ],
    }


def _serve(definition) -> tuple:
    """(texts in frame order, tokens in frame order, pipeline summary)."""
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        stream = pipeline.create_stream("s1", queue_response=responses)
        for frequency in LABELS:
            pipeline.create_frame(stream, {"audio": _tone(frequency)[None]})
        got = {}
        for _ in LABELS:
            _, frame, outputs = responses.get(timeout=120)
            got[frame.frame_id] = outputs
        frames = [got[index] for index in range(len(LABELS))]
        return ([outputs["text"][0] for outputs in frames],
                [np.asarray(outputs["tokens"]) for outputs in frames],
                pipeline.telemetry.summary())
    finally:
        process.terminate()


def test_pipeline_transcribes_audio_to_correct_text():
    texts, tokens, _ = _serve(_definition())
    assert texts == list(LABELS.values()), texts
    assert all(row.shape == (1, 9) and row.dtype == np.int32
               for row in tokens)


def test_micro_batch_fused_equals_chained():
    fused_texts, fused_tokens, fused = _serve(_definition(
        asr_parameters={"micro_batch": 2}))
    chained_texts, chained_tokens, chained = _serve(_definition(
        asr_parameters={"micro_batch": 2, "micro_batch_fused": False}))
    assert fused["fused_groups"] > 0 and fused["chained_groups"] == 0
    assert chained["chained_groups"] > 0 and chained["fused_groups"] == 0
    assert fused_texts == chained_texts == list(LABELS.values())
    for fused_row, chained_row in zip(fused_tokens, chained_tokens):
        np.testing.assert_array_equal(fused_row, chained_row)


def test_cuda_device_raises_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_pipeline(Process(transport_kind="loopback"),
                        _definition(device="cuda"))
    # no `device` parameter at all means CUDA too
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_pipeline(Process(transport_kind="loopback"),
                        _definition(device=None))


@pytest.mark.parametrize("parameter, value, bad, code", [
    ("autoscale_policy", "min_replicas=1", "min_replicas=3;max_replicas=2",
     "AIKO406"),
    ("tune", "slo=latency", "slo=goodput", "AIKO501"),
])
def test_unported_grammars_fail_as_definition_errors(parameter, value, bad,
                                                     code):
    """The elastic fleet's and the tuner's grammars, once refused as not
    ported, now check definitions as the JAX package's do: a good spec
    constructs, a bad one fails with its rule code."""
    create_pipeline(Process(transport_kind="loopback"),
                    _definition(parameters={parameter: value}))
    with pytest.raises(DefinitionError, match=code):
        create_pipeline(Process(transport_kind="loopback"),
                        _definition(parameters={parameter: bad}))


@pytest.mark.parametrize("parameter, good, bad, code", [
    ("gateway_policy", "max_inflight=4", "max_inflight=many", "AIKO403"),
    ("journal_policy", "backend=retained", "backend=sqlite", "AIKO407"),
    ("federation_policy", "groups=a,b", "groups=a,a", "AIKO410"),
    ("disagg", "role=prefill", "role=gpu", "AIKO408"),
])
def test_serving_grammars_check_definitions(parameter, good, bad, code):
    """The serving tier's definition-level grammars construct on a good
    spec and fail with their rule code on a bad one; `disagg:
    "role=prefill"` puts the replica's pool role into its share, where a
    gateway reads it."""
    pipeline = create_pipeline(Process(transport_kind="loopback"),
                               _definition(parameters={parameter: good}))
    if parameter == "disagg":
        assert pipeline.share["role"] == "prefill"
    with pytest.raises(DefinitionError, match=code):
        create_pipeline(Process(transport_kind="loopback"),
                        _definition(parameters={parameter: bad}))


def test_sharding_block_runs_on_a_data_axis():
    """The sharding block takes every mesh axis: the transcription
    element on a data axis over two devices (its state spec defaults to
    asr_param_specs filtered to the mesh) transcribes every tone as the
    element without one does."""
    from aiko_services_tpu_torch.parallel import set_default_devices
    definition = _definition()
    definition["elements"][0]["sharding"] = {"axes": {"data": -1}}
    set_default_devices(["cpu"] * 2)
    try:
        texts, tokens, _ = _serve(definition)
    finally:
        set_default_devices(None)
    assert texts == list(LABELS.values()), texts
    plain_texts, plain_tokens, _ = _serve(_definition())
    assert texts == plain_texts
    for got, want in zip(tokens, plain_tokens):
        np.testing.assert_array_equal(got, want)


class SlowStartSink(PipelineElement):
    """A sink whose start_stream takes a while before it sets up what
    its process_frame needs (as DataTarget's target path)."""

    def start_stream(self, stream, stream_id):
        time.sleep(0.3)
        stream.variables["sink.ready"] = True
        return StreamEvent.OKAY, None

    def process_frame(self, stream, text):
        return StreamEvent.OKAY, {"text": text,
                                  "ready": stream.variables["sink.ready"]}


def test_every_element_starts_before_a_source_generates():
    """A source's generator thread produces frames the moment its
    start_stream runs; the stream's other elements are started first,
    so no frame reaches an element whose start_stream has not run
    (under load the JAX package's engine can deliver one there)."""
    definition = {
        "name": "start_order", "graph": ["(source (sink))"],
        "elements": [
            {"name": "source", "output": [{"name": "text"}],
             "parameters": {"data_sources": ["a", "b", "c"]},
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "TextSource"}}},
            {"name": "sink", "input": [{"name": "text"}],
             "output": [{"name": "text"}, {"name": "ready"}],
             "deploy": {"local": {"module": "tests.test_torch_pipeline",
                                  "class_name": "SlowStartSink"}}}]}
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        pipeline.create_stream("s1", queue_response=responses)
        got = [responses.get(timeout=20)[2] for _ in range(3)]
    finally:
        process.terminate()
    assert sorted(outputs["text"] for outputs in got) == ["a", "b", "c"]
    assert all(outputs["ready"] for outputs in got)
