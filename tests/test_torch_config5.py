# The config-5 serving graph, (sources (asr (text) (lm (reply)))
# (detector)), through both packages' Process / create_pipeline on the
# CPU: the same definition as bench.py::_multimodal_setup at its smoke
# sizes, the same weights (the JAX package's random parameters saved with
# its save_pytree and loaded by both), the same host-synthesized frames
# (MultiModalSource with on_device false is numpy in both).  f32
# throughout.
#
# Tolerances: ASR tokens, LM tokens, texts, detection classes and valid
# masks identical; detection scores atol 1e-4 and boxes atol 1e-3 on
# pixel coordinates (the raw head after eight f32 convolutions agrees to
# 1e-4, tests/test_torch_detector.py); LMForward logits and NLL atol 1e-5
# (two f32 layers summed in another order).

import ast
import pathlib
import queue
import time

import jax
import numpy as np
import pytest
import torch

import aiko_services_tpu.models as jax_models
import aiko_services_tpu.pipeline as jax_pipeline
import aiko_services_tpu.runtime as jax_runtime
import aiko_services_tpu.transport as jax_transport
import aiko_services_tpu_torch.pipeline as torch_pipeline
import aiko_services_tpu_torch.runtime as torch_runtime
import aiko_services_tpu_torch.transport as torch_transport
from aiko_services_tpu_torch.models import SafetensorsFile

JAX = ("aiko_services_tpu.elements", jax_pipeline, jax_runtime)
PORT = ("aiko_services_tpu_torch.elements", torch_pipeline, torch_runtime)

# bench.py::_multimodal_setup's SMOKE sizes
LM = dict(vocab_size=1024, d_model=256, n_layers=2, n_heads=8,
          n_kv_heads=4, d_ff=768, max_seq_len=2048, dtype="float32")
ASR = dict(d_model=64, enc_layers=1, dec_layers=1, n_heads=2,
           vocab_size=1024, max_frames=192, dtype="float32")
DET = dict(n_classes=16, base_channels=8, image_size=64, dtype="float32")
MAX_TOKENS, MAX_NEW, SECONDS, ROWS = 16, 8, 1.0, 2
DETECTOR_ASSET = (pathlib.Path(__file__).parent / "assets"
                  / "detector_shapes.safetensors")


@pytest.fixture(autouse=True)
def clean_brokers():
    jax_transport.reset_brokers()
    torch_transport.reset_brokers()
    yield
    jax_transport.reset_brokers()
    torch_transport.reset_brokers()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{stage: path} of the JAX package's random parameters."""
    root = tmp_path_factory.mktemp("config5")
    paths = {}
    for name, params in (
            ("asr", jax_models.init_asr_params(
                jax_models.AsrConfig(**ASR), jax.random.PRNGKey(0))),
            ("lm", jax_models.init_params(
                jax_models.TransformerConfig(**LM), jax.random.PRNGKey(1))),
            ("lm_bpe", jax_models.init_params(
                jax_models.TransformerConfig(**{**LM, "vocab_size": 4096}),
                jax.random.PRNGKey(2))),
            ("detector", jax_models.init_detector_params(
                jax_models.DetectorConfig(**DET), jax.random.PRNGKey(3)))):
        paths[name] = str(root / f"{name}.safetensors")
        jax_models.save_pytree(paths[name], params)
    return paths


def _local(package, class_name):
    return {"local": {"module": package[0], "class_name": class_name}}


def _config5(package, weights, count, micro=1, fused=True, rows=ROWS):
    """bench.py::_multimodal_setup's definition at the smoke sizes, with
    the typed ports it declares."""
    samples = int(SECONDS * 16000)
    audio_t, image_t = f"f32[b,{samples}]", "f32[b,3,64,64]"
    tokens_t, generated_t = f"i32[b,{MAX_TOKENS}]", f"i32[b,{MAX_NEW}]"
    batching = {"micro_batch": micro, "micro_batch_wait_ms": 2000,
                "micro_batch_fused": fused}
    definition = {
        "name": "config5",
        "graph": ["(sources (asr (text) (lm (reply))) (detector))"],
        "parameters": {"device": "cpu"} if package is PORT else {},
        "elements": [
            {"name": "sources",
             "output": [{"name": "audio", "type": audio_t},
                        {"name": "image", "type": image_t},
                        {"name": "t0", "type": "float"}],
             "parameters": {"data_sources": [[440, SECONDS]],
                            "image_shape": [3, 64, 64],
                            "data_batch_size": rows, "timestamps": True,
                            "on_device": False, "count": count},
             "deploy": _local(package, "MultiModalSource")},
            {"name": "asr",
             "input": [{"name": "audio", "type": audio_t}],
             "output": [{"name": "tokens", "type": tokens_t}],
             "parameters": {**ASR, "max_tokens": MAX_TOKENS,
                            "weights": weights["asr"], **batching},
             "deploy": _local(package, "SpeechToText")},
            {"name": "text",
             "input": [{"name": "tokens", "type": tokens_t}],
             "output": [{"name": "text", "type": "str"}],
             "deploy": _local(package, "TokensToText")},
            {"name": "lm",
             "input": [{"name": "tokens", "type": tokens_t}],
             "output": [{"name": "generated", "type": generated_t}],
             "parameters": {**LM, "max_new_tokens": MAX_NEW,
                            "weights": weights["lm"], **batching},
             "deploy": _local(package, "LMGenerate")},
            {"name": "reply",
             "input": [{"name": "tokens", "type": generated_t}],
             "output": [{"name": "text", "type": "str"}],
             "map_in": {"tokens": "generated"},
             "map_out": {"text": "reply"},
             "deploy": _local(package, "TokensToText")},
            {"name": "detector",
             "input": [{"name": "image", "type": image_t}],
             "output": [{"name": "detections", "type": "dict"}],
             "parameters": {**DET, "score_threshold": 0.05,
                            "weights": weights["detector"], **batching},
             "deploy": _local(package, "Detector")},
        ],
    }
    return definition


def _host(value):
    if isinstance(value, dict):
        return {key: _host(child) for key, child in value.items()}
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if hasattr(value, "shape"):
        return np.asarray(value)
    return value


def _serve(package, definition, count, frames=None, subscribe=None,
           timeout=300):
    """Run `definition` in a fresh Process of `package`: a source-driven
    stream (frames=None) or posted `frames`.  Returns ({frame_id: host
    outputs}, pipeline summary, messages received on `subscribe`)."""
    _, pipeline_module, runtime_module = package
    process = runtime_module.Process(transport_kind="loopback")
    messages = []
    try:
        if subscribe:
            process.add_message_handler(
                lambda _topic, payload: messages.append(payload),
                subscribe.format(namespace=process.namespace))
        pipeline = pipeline_module.create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        stream = pipeline.create_stream("s1", queue_response=responses)
        for frame in frames or ():
            pipeline.create_frame(stream, frame)
        results = {}
        for _ in range(count):
            _, frame, outputs = responses.get(timeout=timeout)
            results[frame.frame_id] = _host(dict(outputs))
        summary = pipeline.telemetry.summary()
        deadline = time.monotonic() + 30
        while subscribe and not messages and time.monotonic() < deadline:
            time.sleep(0.01)  # the side channel is delivered on its own
    finally:
        process.terminate()
    return results, summary, messages


def _assert_frames_equal(actual, expected):
    assert sorted(actual) == sorted(expected)
    for frame_id, want in expected.items():
        got = actual[frame_id]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["generated"], want["generated"])
        assert got["text"] == want["text"]
        assert got["reply"] == want["reply"]
        for key in ("classes", "valid"):
            np.testing.assert_array_equal(got["detections"][key],
                                          want["detections"][key])
        np.testing.assert_allclose(got["detections"]["scores"],
                                   want["detections"]["scores"],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["detections"]["boxes"],
                                   want["detections"]["boxes"],
                                   atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def jax_config5(weights):
    results, _, _ = _serve(JAX, _config5(JAX, weights, count=2), count=2)
    return results


def test_config5_graph_matches_the_jax_package(weights, jax_config5):
    """Two frames of 2 rows: ASR tokens, LM tokens and both texts
    identical, detections within tolerance."""
    actual, summary, _ = _serve(PORT, _config5(PORT, weights, count=2),
                                count=2)
    _assert_frames_equal(actual, jax_config5)
    first = actual[0]
    assert first["tokens"].dtype == np.int32
    assert first["tokens"].shape == (ROWS, MAX_TOKENS)
    assert first["generated"].dtype == np.int32
    assert first["generated"].shape == (ROWS, MAX_NEW)
    assert first["detections"]["boxes"].shape == (ROWS, 32, 4)
    assert first["detections"]["valid"].any()
    assert len(first["text"]) == len(first["reply"]) == ROWS
    assert "t0" in first
    assert summary["frames"] == 2 and summary["errors"] == 0


def test_config5_fused_micro_batch_equals_chained(weights, jax_config5):
    """micro_batch 2: the fused group kernels of SpeechToText, LMGenerate
    and Detector give what the chained path gives, and both what the JAX
    package gives unbatched."""
    fused, fused_summary, _ = _serve(
        PORT, _config5(PORT, weights, count=2, micro=2), count=2)
    chained, chained_summary, _ = _serve(
        PORT, _config5(PORT, weights, count=2, micro=2, fused=False),
        count=2)
    assert fused_summary["fused_groups"] == 3
    assert fused_summary["chained_groups"] == 0
    assert chained_summary["chained_groups"] == 3
    assert chained_summary["fused_groups"] == 0
    _assert_frames_equal(fused, chained)
    _assert_frames_equal(fused, jax_config5)


def test_config5_on_device_source_feeds_the_graph(weights):
    """on_device: true -- the batch synthesized on the element's device
    as tensors of the declared shapes, served end to end."""
    definition = _config5(PORT, weights, count=1)
    definition["elements"][0]["parameters"]["on_device"] = True
    results, _, _ = _serve(PORT, definition, count=1)
    outputs = results[0]
    assert outputs["generated"].shape == (ROWS, MAX_NEW)
    assert outputs["detections"]["scores"].shape == (ROWS, 32)


def _chat_definition(package, weights):
    return {
        "name": "chat",
        "graph": ["(lm)"],
        "parameters": {"device": "cpu"} if package is PORT else {},
        "elements": [
            {"name": "lm", "input": [{"name": "text"}],
             "output": [{"name": "generated"}, {"name": "text"},
                        {"name": "prompt"}],
             "parameters": {
                 **LM, "vocab_size": 4096, "max_new_tokens": 6,
                 "weights": weights["lm_bpe"], "tokenizer": "default",
                 "system_prompt": "Answer briefly.",
                 "chat_template": "<<{system}>> {context}[user] {user}",
                 "detections_subscribe": True, "detections_window": 600},
             "deploy": _local(package, "LMGenerate")},
        ],
    }


def _chat(package, weights):
    """Detections published on the side channel before the frame, then
    two text prompts through LMGenerate."""
    _, pipeline_module, runtime_module = package
    process = runtime_module.Process(transport_kind="loopback")
    try:
        pipeline = pipeline_module.create_pipeline(
            process, _chat_definition(package, weights))
        process.run(in_thread=True)
        process.publish(f"{process.namespace}/detections",
                        "(detections (cat dog))")
        lm = pipeline.elements["lm"]
        for _ in range(3000):
            if lm._detections is not None:
                break
            time.sleep(0.01)
        responses = queue.Queue()
        stream = pipeline.create_stream("s1", queue_response=responses)
        pipeline.create_frame(stream, {"text": [
            "hello there", "what do you see? naïve café"]})
        _, _, outputs = responses.get(timeout=300)
        return _host(dict(outputs))
    finally:
        process.terminate()


def test_lm_generate_text_prompt_with_chat_template_matches_jax(weights):
    expected = _chat(JAX, weights)
    actual = _chat(PORT, weights)
    assert actual["prompt"] == expected["prompt"]
    assert actual["prompt"][0] == (
        "<<Answer briefly.>> Visible objects: cat, dog.\n[user] hello there")
    np.testing.assert_array_equal(actual["generated"], expected["generated"])
    assert actual["generated"].dtype == np.int32
    assert actual["text"] == expected["text"]


def _detector_metadata() -> dict:
    container = SafetensorsFile(DETECTOR_ASSET)
    metadata = {key: ast.literal_eval(value)
                for key, value in container.metadata.items()}
    container.close()
    return metadata


def _publish_definition(package):
    config = _detector_metadata()["config"]
    return {
        "name": "publish",
        "graph": ["(detector (publish))"],
        "parameters": {"device": "cpu"} if package is PORT else {},
        "elements": [
            {"name": "detector", "input": [{"name": "image"}],
             "output": [{"name": "detections"}],
             "parameters": {**config, "weights": str(DETECTOR_ASSET)},
             "deploy": _local(package, "Detector")},
            {"name": "publish", "input": [{"name": "detections"}],
             "output": [{"name": "detections"}],
             "parameters": {"class_names": ["red", "green", "blue",
                                            "yellow"]},
             "deploy": _local(package, "DetectionsPublish")},
        ],
    }


def test_detections_publish_payload_matches_jax():
    metadata = _detector_metadata()
    colors = np.asarray(metadata["colors"], np.float32)
    images = np.random.default_rng(0).uniform(
        0.0, 0.25, (2, 3, 64, 64)).astype(np.float32)
    images[0, :, 6:26, 8:28] = colors[2][:, None, None] * 0.9
    images[1, :, 30:48, 34:52] = colors[0][:, None, None] * 0.9
    payloads = {}
    for package in (JAX, PORT):
        _, _, messages = _serve(package, _publish_definition(package), 1,
                                frames=[{"image": images}],
                                subscribe="{namespace}/detections")
        payloads[package[0]] = messages
    assert payloads[PORT[0]] == payloads[JAX[0]]
    assert payloads[PORT[0]] == ["(detections (blue red))"]


def test_lm_forward_element_matches_jax(weights):
    tokens = np.random.default_rng(9).integers(0, 1024, (2, 12)).astype(
        np.int32)
    results = {}
    for package in (JAX, PORT):
        definition = {
            "name": "score",
            "graph": ["(lm)"],
            "parameters": {"device": "cpu"} if package is PORT else {},
            "elements": [
                {"name": "lm", "input": [{"name": "tokens"}],
                 "output": [{"name": "logits"}, {"name": "nll"}],
                 "parameters": {**LM, "weights": weights["lm"]},
                 "deploy": _local(package, "LMForward")}],
        }
        outputs, _, _ = _serve(package, definition, 1,
                               frames=[{"tokens": tokens}])
        results[package[0]] = outputs[0]
    got, want = results[PORT[0]], results[JAX[0]]
    assert got["logits"].shape == (2, 12, 1024)
    for key in ("logits", "nll"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0)


@pytest.mark.parametrize("class_name, parameters, key", [
    ("ArraySource", {"data_sources": [[3, 5], [2, 4]], "seed": 4},
     "tensor"),
    ("TokenSource", {"data_sources": [[2, 6]], "count": 2,
                     "vocab_size": 100, "seed": 5}, "tokens"),
])
def test_sources_emit_the_jax_packages_frames(class_name, parameters, key):
    results = {}
    for package in (JAX, PORT):
        definition = {
            "name": "source",
            "graph": ["(source)"],
            "parameters": {"device": "cpu"} if package is PORT else {},
            "elements": [
                {"name": "source", "output": [{"name": key}],
                 "parameters": parameters,
                 "deploy": _local(package, class_name)}],
        }
        outputs, _, _ = _serve(package, definition, 2)
        results[package[0]] = outputs
    for frame_id, want in results[JAX[0]].items():
        np.testing.assert_array_equal(results[PORT[0]][frame_id][key],
                                      want[key])


@pytest.mark.parametrize("max_len", [None, 6])
def test_text_to_tokens_element_matches_jax(max_len):
    parameters = {"max_len": max_len} if max_len else {}
    results = {}
    for package in (JAX, PORT):
        definition = {
            "name": "tokenize",
            "graph": ["(tokenize)"],
            "parameters": {"device": "cpu"} if package is PORT else {},
            "elements": [
                {"name": "tokenize", "input": [{"name": "text"}],
                 "output": [{"name": "tokens"}], "parameters": parameters,
                 "deploy": _local(package, "TextToTokens")}],
        }
        outputs, _, _ = _serve(package, definition, 1, frames=[
            {"text": ["a short prompt", "a somewhat longer prompt, naïve"]}])
        results[package[0]] = outputs[0]["tokens"]
    assert results[PORT[0]].dtype == np.int32
    np.testing.assert_array_equal(results[PORT[0]], results[JAX[0]])
