# The port's elements on a sharded mesh against the JAX package's, on the
# CPU: the shipped examples (examples/pipeline_llm_8b.json through its
# TextSource, examples/pipeline_longcontext.json with its seq x model
# mesh), LMForward and LMGenerate on an element mesh (JAX
# tests/test_ml_elements.py), and the whisper model and SpeechToText on a
# model / fsdp mesh with asr_param_specs.  The examples' JSON is read as
# shipped; only the runtime, the element modules, the widths (the JAX
# tests' own) and the weights file change, in memory.  Both packages load
# one save_pytree checkpoint of the JAX package's random parameters.  The
# port's mesh names the CPU several times (set_default_devices); JAX runs
# on its virtual 8-device CPU mesh (tests/conftest.py).
#
# Tolerances (f32): greedy tokens identical; logits and NLL atol/rtol
# 1e-5 against the JAX element and the port's element without a mesh
# (the same products, their partial sums added in another order); the
# JAX tests' own bound against dense, 2e-3, is looser.

import ast
import copy
import json
import pathlib
import queue

import jax
import numpy as np
import pytest
import torch

import aiko_services_tpu.pipeline as jax_pipeline
import aiko_services_tpu.runtime as jax_runtime
import aiko_services_tpu.transport as jax_transport
import aiko_services_tpu_torch.pipeline as torch_pipeline
import aiko_services_tpu_torch.runtime as torch_runtime
import aiko_services_tpu_torch.transport as torch_transport
from aiko_services_tpu.models import asr as jax_asr
from aiko_services_tpu.models import save_pytree
from aiko_services_tpu.models.weights import load_pytree as jax_load_pytree
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu.parallel import create_mesh as jax_create_mesh
from aiko_services_tpu.parallel import filter_specs as jax_filter_specs
from aiko_services_tpu.parallel import shard_pytree as jax_shard_pytree
from aiko_services_tpu_torch.models import (
    SafetensorsFile, load_pytree, params_from_numpy)
from aiko_services_tpu_torch.models import asr as torch_asr
from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram
from aiko_services_tpu_torch.parallel import collectives
from aiko_services_tpu_torch.parallel import mesh as torch_mesh

TOL = dict(atol=1e-5, rtol=1e-5)
EXAMPLES = pathlib.Path(__file__).parent.parent / "examples"
ASSET = pathlib.Path(__file__).parent / "assets" / "asr_tones.safetensors"
JAX = ("aiko_services_tpu.elements", jax_pipeline, jax_runtime)
PORT = ("aiko_services_tpu_torch.elements", torch_pipeline, torch_runtime)
SMALL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=64, max_seq_len=64, dtype="float32")


@pytest.fixture(autouse=True)
def eight_cpus():
    torch_mesh.set_default_devices(["cpu"] * 8)
    jax_transport.reset_brokers()
    torch_transport.reset_brokers()
    try:
        yield
    finally:
        torch_mesh.set_default_devices(None)
        jax_transport.reset_brokers()
        torch_transport.reset_brokers()


def _checkpoint(tmp_path, config: dict, seed: int) -> str:
    params = jax_lm.init_params(jax_lm.TransformerConfig(**config),
                                jax.random.PRNGKey(seed))
    path = tmp_path / f"lm{seed}.safetensors"
    save_pytree(str(path), params)
    return str(path)


def _for(package, definition: dict) -> dict:
    """The definition for `package`: its runtime and element modules,
    and the CPU for the port."""
    definition = copy.deepcopy(definition)
    definition["runtime"] = "torch" if package is PORT else "jax"
    if package is PORT:
        definition.setdefault("parameters", {})["device"] = "cpu"
    for element in definition["elements"]:
        element["deploy"]["local"]["module"] = package[0]
    return definition


def _run(package, definition: dict, count: int = 1) -> tuple:
    """({frame_id: outputs as numpy / host values}, the lm element)."""
    _, pipeline_module, runtime_module = package
    process = runtime_module.Process(transport_kind="loopback")
    try:
        pipeline = pipeline_module.create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        pipeline.create_stream("s1", queue_response=responses)
        results = {}
        for _ in range(count):
            _, frame, outputs = responses.get(timeout=300)
            results[frame.frame_id] = {
                name: (value.detach().cpu().numpy()
                       if isinstance(value, torch.Tensor)
                       else value if isinstance(value, list)
                       else np.asarray(value))
                for name, value in outputs.items()}
        element = pipeline.elements["lm"]
    finally:
        process.terminate()
    return results, element


def test_8b_pipeline_definition_runs_on_the_port(tmp_path):
    """JAX test_8b_pipeline_definition_compiles_on_virtual_mesh:
    examples/pipeline_llm_8b.json as shipped -- TextSource prompt, its
    data 1 x fsdp 2 x seq 1 x model 4 mesh, the default tokenizer -- at
    the JAX test's architecture widths (32 layers, GQA 4:1, so each
    model shard's two query heads share one KV head).  The port's
    sharded element, its element without the sharding block and the JAX
    package's element generate the same tokens and text."""
    definition = json.loads((EXAMPLES / "pipeline_llm_8b.json").read_text())
    lm = next(element for element in definition["elements"]
              if element["name"] == "lm")
    widths = {"vocab_size": 256, "d_model": 64, "n_layers": 32,
              "n_heads": 8, "n_kv_heads": 2, "d_ff": 224,
              "max_seq_len": 512, "dtype": "float32"}
    lm["parameters"].pop("preset")
    lm["parameters"].update(widths, max_new_tokens=4, stream_tokens=False,
                            weights=_checkpoint(tmp_path, widths, 3))
    expected, _ = _run(JAX, _for(JAX, definition))
    ours, element = _run(PORT, _for(PORT, definition))
    assert dict(element.mesh.shape) == {"data": 1, "fsdp": 2, "seq": 1,
                                        "model": 4}
    wq = element.state["layers"]["wq"]["w"]
    assert isinstance(wq, torch_mesh.Sharded)
    assert tuple(wq.shards.flat[0].shape) == (32, 32, 16)
    plain = copy.deepcopy(definition)
    del next(element for element in plain["elements"]
             if element["name"] == "lm")["sharding"]
    whole, _ = _run(PORT, _for(PORT, plain))
    np.testing.assert_array_equal(ours[0]["generated"],
                                  np.asarray(expected[0]["generated"]))
    np.testing.assert_array_equal(ours[0]["generated"],
                                  whole[0]["generated"])
    assert ours[0]["text"] == list(expected[0]["text"])


def _lm_element(package, name: str, class_name: str, weights: str,
                extra: dict, sharding=None, source=(2, 32)) -> dict:
    """JAX tests/test_ml_elements.py's element-mesh definitions."""
    element = {
        "name": "lm", "input": [{"name": "tokens"}],
        "output": ([{"name": "logits"}, {"name": "nll"}]
                   if class_name == "LMForward"
                   else [{"name": "generated"}]),
        "parameters": {**SMALL, "weights": weights, **extra},
        "deploy": {"local": {"module": package[0],
                             "class_name": class_name}}}
    if sharding:
        element["sharding"] = sharding
    return {"name": name, "graph": ["(tokens (lm))"], "elements": [
        {"name": "tokens", "output": [{"name": "tokens"}],
         "parameters": {"data_sources": [list(source)], "vocab_size": 128},
         "deploy": {"local": {"module": package[0],
                              "class_name": "TokenSource"}}},
        element]}


@pytest.mark.parametrize("class_name", ["LMForward", "LMGenerate"])
def test_lm_elements_on_an_element_mesh(tmp_path, class_name):
    """JAX test_lm_forward_sequence_parallel_on_element_mesh and
    test_lm_generate_sequence_parallel_matches_dense: sequence_parallel
    on data 2 x seq 2 x model 2 with the tokens' batch on "data"; the
    state spec defaults to param_specs filtered to the mesh, so each
    element runs sharded.  Logits / NLL (TOL) and tokens (identical)
    equal the JAX element's and the port's dense element's."""
    weights = _checkpoint(tmp_path, SMALL, 0)
    sharding = {"axes": {"data": 2, "seq": 2, "model": 2},
                "inputs": {"tokens": ["data", None]}}
    extra = ({"sequence_parallel": True} if class_name == "LMForward"
             else {"sequence_parallel": True, "max_new_tokens": 6})
    dense_extra = ({} if class_name == "LMForward"
                   else {"max_new_tokens": 6})
    names = (["logits", "nll"] if class_name == "LMForward"
             else ["generated"])
    expected, _ = _run(JAX, _for(JAX, _lm_element(
        JAX, "sp", class_name, weights, extra, sharding)))
    ours, element = _run(PORT, _for(PORT, _lm_element(
        PORT, "sp", class_name, weights, extra, sharding)))
    dense, _ = _run(PORT, _for(PORT, _lm_element(
        PORT, "dense", class_name, weights, dense_extra)))
    assert isinstance(element.state["layers"]["wq"]["w"], torch_mesh.Sharded)
    for name in names:
        got = ours[0][name]
        assert np.isfinite(got).all()
        if name == "generated":
            np.testing.assert_array_equal(got, expected[0][name])
            np.testing.assert_array_equal(got, dense[0][name])
        else:
            np.testing.assert_allclose(got, expected[0][name], **TOL)
            np.testing.assert_allclose(got, dense[0][name], **TOL)


def test_longcontext_example_as_shipped(tmp_path):
    """examples/pipeline_longcontext.json with its own sharding block,
    data 1 x seq 4 x model 2: the ring runs over each model shard's
    heads, and the logits and NLL equal the JAX element's and those of
    the port's element without the sharding block."""
    definition = json.loads(
        (EXAMPLES / "pipeline_longcontext.json").read_text())
    length = 64
    source, lm = definition["elements"]
    source["output"][0]["type"] = f"i32[1,{length}]"
    source["parameters"].update(data_sources=[[1, length]], count=2,
                                vocab_size=SMALL["vocab_size"])
    lm["input"][0]["type"] = f"i32[1,{length}]"
    lm["output"][0]["type"] = f"f32[1,{length},{SMALL['vocab_size']}]"
    lm["parameters"].update(SMALL, max_seq_len=128,
                            weights=_checkpoint(tmp_path, SMALL, 0))
    expected, _ = _run(JAX, _for(JAX, definition), count=2)
    collectives.reset_collective_counts()
    ours, element = _run(PORT, _for(PORT, definition), count=2)
    assert dict(element.mesh.shape) == {"data": 1, "seq": 4, "model": 2}
    assert collectives.collective_counts()["model"]["calls"] > 0
    dense = copy.deepcopy(definition)
    del dense["elements"][1]["sharding"]
    dense["elements"][1]["parameters"]["sequence_parallel"] = False
    whole, _ = _run(PORT, _for(PORT, dense), count=2)
    assert sorted(ours) == sorted(expected) == sorted(whole)
    for frame_id, want in expected.items():
        got = ours[frame_id]
        np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
        np.testing.assert_allclose(got["nll"], want["nll"], **TOL)
        np.testing.assert_allclose(got["logits"], whole[frame_id]["logits"],
                                   **TOL)


# -- whisper ------------------------------------------------------------------

def _asr_config() -> dict:
    container = SafetensorsFile(ASSET)
    try:
        return ast.literal_eval(container.metadata["config"])
    finally:
        container.close()


def _tone(frequency: float, seconds: float = 0.4) -> np.ndarray:
    t = np.arange(int(seconds * 16000)) / 16000
    return np.sin(2 * np.pi * frequency * t).astype(np.float32)


@pytest.mark.parametrize("axes", [{"model": 2},
                                  {"data": 2, "fsdp": 2, "model": 2}])
def test_sharded_whisper_matches_jax(axes):
    """The asr_tones model cut by asr_param_specs: encode_audio within TOL
    of JAX's sharded encoder, transcribe's tokens identical to JAX's
    sharded and the port's unsharded transcription (the trained weights
    spell the tones' words)."""
    config = _asr_config()
    jax_config = jax_asr.AsrConfig(**config)
    torch_config = torch_asr.AsrConfig(**config)
    jax_params = jax_load_pytree(str(ASSET))
    numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    audio = np.stack([_tone(440.0), _tone(783.99)])
    count = int(np.prod(list(axes.values())))
    jax_mesh = jax_create_mesh(axes, devices=jax.devices()[:count])
    mesh = torch_mesh.create_mesh(axes, devices=["cpu"] * count)
    mel = log_mel_spectrogram(torch.from_numpy(audio), n_mels=80)
    with jax.set_mesh(jax_mesh):
        jax_sharded = jax_shard_pytree(jax_params, jax_mesh, jax_filter_specs(
            jax_asr.asr_param_specs(jax_config), jax_mesh))
        expected_memory = np.asarray(jax_asr.encode_audio(
            jax_sharded, jax_config, mel.numpy()))
        expected = np.asarray(jax_asr.transcribe(
            jax_sharded, jax_config, mel.numpy(), max_tokens=9))
    whole = params_from_numpy(numpy_params, device="cpu")
    sharded = torch_mesh.shard_pytree(
        params_from_numpy(numpy_params, device="cpu"), mesh,
        torch_mesh.filter_specs(torch_asr.asr_param_specs(torch_config),
                                mesh))
    memory = torch_asr.encode_audio(sharded, torch_config, mel)
    np.testing.assert_allclose(memory.numpy(), expected_memory, **TOL)
    tokens = torch_asr.transcribe(sharded, torch_config, mel, max_tokens=9)
    np.testing.assert_array_equal(tokens.numpy(), expected)
    np.testing.assert_array_equal(
        tokens.numpy(),
        torch_asr.transcribe(whole, torch_config, mel, max_tokens=9).numpy())


def test_speech_to_text_on_a_model_mesh():
    """SpeechToText with a {"model": 2} sharding block: its state spec
    defaults to asr_param_specs, each encoder layer runs the attention
    on each model shard's heads, and the tokens equal the element's
    without a mesh on the same frames."""
    config = _asr_config()

    def definition(sharding):
        element = {"name": "lm", "input": [{"name": "audio"}],
                   "output": [{"name": "tokens"}],
                   "parameters": {**config, "max_tokens": 9,
                                  "weights": str(ASSET)},
                   "deploy": {"local": {"module": PORT[0],
                                        "class_name": "SpeechToText"}}}
        if sharding:
            element["sharding"] = sharding
        return {"name": "asr", "graph": ["(lm)"],
                "parameters": {"device": "cpu"}, "elements": [element]}

    def serve(sharding):
        process = torch_runtime.Process(transport_kind="loopback")
        try:
            pipeline = torch_pipeline.create_pipeline(process,
                                                      definition(sharding))
            process.run(in_thread=True)
            responses = queue.Queue()
            stream = pipeline.create_stream("s1", queue_response=responses)
            for frequency in (440.0, 523.25, 659.25, 783.99):
                pipeline.create_frame(stream, {"audio": _tone(frequency)[
                    None]})
            out = {}
            for _ in range(4):
                _, frame, outputs = responses.get(timeout=120)
                out[frame.frame_id] = outputs["tokens"].cpu().numpy()
            return out, pipeline.elements["lm"]
        finally:
            process.terminate()

    sharded, element = serve({"axes": {"model": 2}, "devices": [0, 2]})
    assert isinstance(element.state["enc_layers"]["attn"]["wq"]["w"],
                      torch_mesh.Sharded)
    whole, _ = serve(None)
    assert sorted(sharded) == sorted(whole)
    for frame_id, tokens in whole.items():
        np.testing.assert_array_equal(sharded[frame_id], tokens)
