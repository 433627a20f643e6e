# The port's HuggingFace name maps (models/weights.py load_llama_params /
# load_whisper_params, and the elements that probe for them) against the
# JAX package's, on the CPU.  Each test writes one HF-named safetensors
# file from a numpy seed (f32, or bf16 through the port's writer), loads
# it through both packages and compares leaf by leaf, bitwise (bf16
# through its bits: the JAX package casts with ml_dtypes, the port with
# torch, both round to nearest even).  Mirrors
# tests/test_weights_tokenizer.py (its test named in each docstring).
#
# Tolerances: the loads are bitwise; logits from the same weights through
# both packages' forwards atol/rtol 1e-5 (f32; sums in another order, the
# bound tests/test_torch_transformer.py uses); greedy tokens identical.

import queue

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import asr as jax_asr
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu.models import weights as jax_weights
from aiko_services_tpu import pipeline as jax_pipeline
from aiko_services_tpu import runtime as jax_runtime
from aiko_services_tpu import transport as jax_transport
from aiko_services_tpu_torch import pipeline as torch_pipeline
from aiko_services_tpu_torch import runtime as torch_runtime
from aiko_services_tpu_torch import transport as torch_transport
from aiko_services_tpu_torch.models import asr as torch_asr
from aiko_services_tpu_torch.models import transformer as torch_lm
from aiko_services_tpu_torch.models import weights
from aiko_services_tpu_torch.parallel import mesh as torch_mesh

TOL = dict(atol=1e-5, rtol=1e-5)
LM = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=32, max_seq_len=32)
ASR = dict(n_mels=8, d_model=16, enc_layers=2, dec_layers=2, n_heads=4,
           vocab_size=64, max_frames=16, max_text_len=12)


@pytest.fixture(autouse=True)
def clean_brokers():
    jax_transport.reset_brokers()
    torch_transport.reset_brokers()
    yield
    torch_mesh.set_default_devices(None)
    jax_transport.reset_brokers()
    torch_transport.reset_brokers()


def _write(path, tensors: dict, dtype: str) -> None:
    """numpy f32 tensors -> one safetensors file in `dtype`."""
    torch_dtype = getattr(torch, dtype)
    weights.write_safetensors(path, {
        name: torch.from_numpy(array).to(torch_dtype)
        for name, array in tensors.items()})


def _hf_llama(config: dict, seed: int, lm_head: bool = False) -> dict:
    """HF Llama naming, (out, in) linear layout, numpy f32."""
    rng = np.random.default_rng(seed)
    d, hd = config["d_model"], config["d_model"] // config["n_heads"]

    def t(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    tensors = {"model.embed_tokens.weight": t(config["vocab_size"], d),
               "model.norm.weight": 1 + 0.1 * t(d)}
    if lm_head:
        tensors["lm_head.weight"] = t(config["vocab_size"], d)
    for layer in range(config["n_layers"]):
        prefix = f"model.layers.{layer}."
        tensors.update({
            prefix + "input_layernorm.weight": 1 + 0.1 * t(d),
            prefix + "post_attention_layernorm.weight": 1 + 0.1 * t(d),
            prefix + "self_attn.q_proj.weight": t(config["n_heads"] * hd, d),
            prefix + "self_attn.k_proj.weight": t(config["n_kv_heads"] * hd,
                                                  d),
            prefix + "self_attn.v_proj.weight": t(config["n_kv_heads"] * hd,
                                                  d),
            prefix + "self_attn.o_proj.weight": t(d, config["n_heads"] * hd),
            prefix + "mlp.gate_proj.weight": t(config["d_ff"], d),
            prefix + "mlp.up_proj.weight": t(config["d_ff"], d),
            prefix + "mlp.down_proj.weight": t(d, config["d_ff"]),
        })
    return tensors


def _hf_whisper(config: dict, seed: int) -> dict:
    """HF openai/whisper-* naming: biases on q/v/out, none on k, layer
    norms with weight and bias, position tables longer than the
    config's windows."""
    rng = np.random.default_rng(seed)
    d = config["d_model"]

    def t(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    tensors = {
        "model.encoder.conv1.weight": t(d, config["n_mels"], 3),
        "model.encoder.conv1.bias": t(d),
        "model.encoder.conv2.weight": t(d, d, 3),
        "model.encoder.conv2.bias": t(d),
        "model.encoder.embed_positions.weight": t(config["max_frames"] + 8,
                                                  d),
        "model.encoder.layer_norm.weight": 1 + t(d),
        "model.encoder.layer_norm.bias": t(d),
        "model.decoder.embed_tokens.weight": t(config["vocab_size"], d),
        "model.decoder.embed_positions.weight": t(
            config["max_text_len"] + 8, d),
        "model.decoder.layer_norm.weight": 1 + t(d),
        "model.decoder.layer_norm.bias": t(d),
    }
    for decoder, count in ((False, config["enc_layers"]),
                           (True, config["dec_layers"])):
        for layer in range(count):
            for name, (parts, transpose) in jax_weights.whisper_layer_map(
                    layer, decoder).items():
                if parts[-1] in ("w",):
                    width = 4 * d if "w1" in parts else d
                    depth = 4 * d if "w2" in parts else d
                    tensors[name] = t(width, depth)
                elif "w1" in parts:
                    tensors[name] = t(4 * d)
                elif parts[-1] == "scale":
                    tensors[name] = 1 + t(d)
                else:
                    tensors[name] = t(d)
    return tensors


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}/{key}")
    else:
        yield prefix, tree


def _bits(leaf) -> np.ndarray:
    """A leaf of either package as comparable bits (bf16 as uint16)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    array = np.asarray(leaf)
    if array.dtype.name == "bfloat16":
        return array.view(np.uint16)
    return array


def _assert_same_leaves(ours: dict, theirs: dict) -> None:
    ours, theirs = dict(_leaves(ours)), dict(_leaves(theirs))
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        got, want = _bits(ours[name]), _bits(theirs[name])
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


LOAD_CASES = [("float32", "float32", False), ("float32", "bfloat16", True),
              ("bfloat16", "bfloat16", False), ("bfloat16", "float32", True)]


@pytest.mark.parametrize("stored, dtype, lm_head", LOAD_CASES)
def test_llama_loads_leaf_for_leaf_as_jax(tmp_path, stored, dtype,
                                          lm_head):
    """test_load_llama_params_shapes_and_orientation: every leaf, its
    orientation ((out, in) -> (in, out)) and its cast, bitwise."""
    path = tmp_path / "llama.safetensors"
    tensors = _hf_llama(LM, 0, lm_head=lm_head)
    _write(path, tensors, stored)
    ours = weights.load_llama_params(
        str(path), torch_lm.TransformerConfig(**LM, dtype=dtype),
        device="cpu")
    theirs = jax_weights.load_llama_params(
        str(path), jax_lm.TransformerConfig(**LM, dtype=dtype))
    _assert_same_leaves(ours, theirs)
    assert ("lm_head" in ours) == lm_head
    if stored == "float32" and dtype == "float32":
        np.testing.assert_array_equal(
            ours["layers"]["wq"]["w"][0].numpy(),
            tensors["model.layers.0.self_attn.q_proj.weight"].T)


def test_llama_untied_head_changes_logits(tmp_path):
    """test_load_llama_untied_head_changes_logits: the untied head is the
    output projection (and the port's logits are JAX's)."""
    config = torch_lm.TransformerConfig(**LM, dtype="float32")
    jax_config = jax_lm.TransformerConfig(**LM, dtype="float32")
    tokens = np.random.default_rng(2).integers(0, 64, (2, 6)).astype(
        np.int32)
    logits = {}
    for lm_head in (False, True):
        path = tmp_path / f"llama{int(lm_head)}.safetensors"
        _write(path, _hf_llama(LM, 1, lm_head=lm_head), "float32")
        ours = torch_lm.forward(
            weights.load_llama_params(str(path), config, device="cpu"),
            config, torch.from_numpy(tokens)).numpy()
        theirs = np.asarray(jax_lm.forward(
            jax_weights.load_llama_params(str(path), jax_config),
            jax_config, jnp.asarray(tokens)))
        np.testing.assert_allclose(ours, theirs, **TOL)
        logits[lm_head] = ours
    assert not np.allclose(logits[False], logits[True])


@pytest.mark.parametrize("stored, dtype", [("float32", "float32"),
                                           ("bfloat16", "bfloat16"),
                                           ("float32", "bfloat16")])
def test_whisper_loads_leaf_for_leaf_as_jax(tmp_path, stored, dtype):
    """test_load_whisper_params_shapes_orientation_and_forward: biases on
    q/v/out only, norms with bias, convolutions as stored, the position
    tables cut to the config's windows -- bitwise against JAX."""
    path = tmp_path / "whisper.safetensors"
    _write(path, _hf_whisper(ASR, 0), stored)
    ours = weights.load_whisper_params(
        str(path), torch_asr.AsrConfig(**ASR, dtype=dtype), device="cpu")
    theirs = jax_weights.load_whisper_params(
        str(path), jax_asr.AsrConfig(**ASR, dtype=dtype))
    _assert_same_leaves(ours, theirs)
    assert "b" not in ours["enc_layers"]["attn"]["wk"]
    assert ours["enc_positions"].shape == (ASR["max_frames"],
                                           ASR["d_model"])
    assert ours["dec_positions"].shape == (ASR["max_text_len"],
                                           ASR["d_model"])


def test_whisper_biases_change_output(tmp_path):
    """test_whisper_biases_change_output: the biases flow through the
    forward (a map that loads but drops them fails), and the port's
    logits are JAX's."""
    path = tmp_path / "whisper.safetensors"
    _write(path, _hf_whisper(ASR, 3), "float32")
    config = torch_asr.AsrConfig(**ASR, dtype="float32")
    jax_config = jax_asr.AsrConfig(**ASR, dtype="float32")
    params = weights.load_whisper_params(str(path), config, device="cpu")
    mel = np.random.default_rng(4).standard_normal((1, 8, 24)).astype(
        np.float32)
    tokens = np.ones((1, 4), np.int32)

    def logits(tree):
        return torch_asr.asr_forward(tree, config, torch.from_numpy(mel),
                                     torch.from_numpy(tokens)).numpy()

    base = logits(params)
    np.testing.assert_allclose(base, np.asarray(jax_asr.asr_forward(
        jax_weights.load_whisper_params(str(path), jax_config), jax_config,
        jnp.asarray(mel), jnp.asarray(tokens))), **TOL)
    for parts in (("dec_norm", "bias"), ("dec_layers", "mlp", "w1", "b"),
                  ("enc_layers", "attn", "wq", "b")):
        stripped = weights.load_whisper_params(str(path), config,
                                               device="cpu")
        node = stripped
        for part in parts[:-1]:
            node = node[part]
        node[parts[-1]] = torch.zeros_like(node[parts[-1]])
        assert not np.allclose(base, logits(stripped)), parts


@pytest.mark.parametrize("family", ["llama", "whisper"])
def test_missing_tensor_raises(tmp_path, family):
    """test_missing_tensor_raises: KeyError naming the tensor."""
    path = tmp_path / "broken.safetensors"
    if family == "llama":
        tensors = _hf_llama(LM, 0)
        missing = "model.layers.1.mlp.up_proj.weight"
    else:
        tensors = _hf_whisper(ASR, 0)
        missing = "model.decoder.layers.1.encoder_attn.v_proj.bias"
    del tensors[missing]
    _write(path, tensors, "float32")
    with pytest.raises(KeyError, match=missing.replace(".", r"\.")):
        if family == "llama":
            weights.load_llama_params(
                str(path), torch_lm.TransformerConfig(**LM, dtype="float32"),
                device="cpu")
        else:
            weights.load_whisper_params(
                str(path), torch_asr.AsrConfig(**ASR, dtype="float32"),
                device="cpu")


@pytest.mark.parametrize("lm_head", [False, True])
def test_llama_placed_into_shards_as_read(tmp_path, monkeypatch, lm_head):
    """test_load_llama_sharded_on_mesh: load_llama_params(mesh=, specs=)
    on the 8-CPU-device mesh gives the blocks shard_pytree gives the
    unsharded load, and places one tensor at a time (the largest call
    one stacked leaf, never the whole tree)."""
    torch_mesh.set_default_devices(["cpu"] * 8)
    config = torch_lm.TransformerConfig(**LM, dtype="float32")
    path = tmp_path / "llama.safetensors"
    _write(path, _hf_llama(LM, 5, lm_head=lm_head), "float32")
    mesh = torch_mesh.create_mesh({"data": 2, "fsdp": 2, "model": 2},
                                  devices=["cpu"] * 8)
    specs = torch_mesh.filter_specs(
        torch_lm.param_specs(config, lm_head=lm_head), mesh)
    placed_sizes = []
    original = weights.shard_pytree

    def recording(tree, mesh, spec):
        assert isinstance(tree, torch.Tensor)  # one leaf per call
        placed_sizes.append(tree.numel())
        return original(tree, mesh, spec)

    monkeypatch.setattr(weights, "shard_pytree", recording)
    loaded = weights.load_llama_params(str(path), config, mesh=mesh,
                                       specs=specs)
    monkeypatch.setattr(weights, "shard_pytree", original)
    whole = weights.load_llama_params(str(path), config, device="cpu")
    expected = torch_mesh.shard_pytree(whole, mesh, specs)
    total = sum(leaf.numel() for _, leaf in _leaves(whole))
    assert len(placed_sizes) == len(list(_leaves(whole)))
    assert max(placed_sizes) < total / 4
    for (name, got), (_, want) in zip(_leaves(loaded), _leaves(expected)):
        assert type(got) is type(want), name
        if isinstance(want, torch_mesh.Sharded):
            assert got.sharding.spec == want.sharding.spec, name
            for a, b in zip(got.shards.flat, want.shards.flat):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (2, 6)).astype(np.int32))
    np.testing.assert_allclose(
        torch_lm.forward(loaded, config, tokens).numpy(),
        torch_lm.forward(whole, config, tokens).numpy(), **TOL)


# -- the elements -------------------------------------------------------------

JAX = ("aiko_services_tpu.elements", jax_pipeline, jax_runtime)
PORT = ("aiko_services_tpu_torch.elements", torch_pipeline, torch_runtime)


def _run(package, definition: dict, element: str, frames: int) -> list:
    """Each frame's `tokens`/`generated` output as numpy, and the
    element."""
    module, pipeline_module, runtime_module = package
    definition = dict(definition, runtime="torch" if package is PORT
                      else "jax")
    definition["elements"] = [
        dict(item, deploy={"local": dict(item["deploy"]["local"],
                                         module=module)})
        for item in definition["elements"]]
    if package is PORT:
        definition["parameters"] = {"device": "cpu"}
    process = runtime_module.Process(transport_kind="loopback")
    try:
        pipeline = pipeline_module.create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        pipeline.create_stream("s1", queue_response=responses)
        outputs = []
        for _ in range(frames):
            _, frame, out = responses.get(timeout=120)
            value = out.get("tokens", out.get("generated"))
            if isinstance(value, torch.Tensor):
                value = value.detach().cpu().numpy()
            outputs.append((frame.frame_id, np.asarray(value)))
        return [value for _, value in sorted(outputs, key=lambda x: x[0])]
    finally:
        process.terminate()


def _asr_definition(path) -> dict:
    return {
        "name": "asr_hf", "graph": ["(tone (asr))"],
        "elements": [
            {"name": "tone", "output": [{"name": "audio"},
                                        {"name": "image"}],
             "parameters": {"data_sources": [[220, 0.2], [660, 0.2]]},
             "deploy": {"local": {"class_name": "MultiModalSource"}}},
            {"name": "asr", "input": [{"name": "audio"}],
             "output": [{"name": "tokens"}],
             "parameters": {"d_model": ASR["d_model"], "n_mels": 8,
                            "enc_layers": 2, "dec_layers": 2,
                            "n_heads": 4, "vocab_size": 64,
                            "max_frames": ASR["max_frames"],
                            "max_tokens": 6, "dtype": "float32",
                            "weights": str(path)},
             "deploy": {"local": {"class_name": "SpeechToText"}}},
        ],
    }


def test_speech_to_text_and_lm_generate_on_hf_files_match_jax(tmp_path):
    """test_speech_to_text_element_ingests_hf_whisper, held to the JAX
    element's tokens: SpeechToText on an HF whisper file (sot/eot 50258 /
    50257, clamped into the table as jnp.take clamps them) and
    LMGenerate on an HF llama file give JAX's greedy tokens."""
    whisper = tmp_path / "whisper.safetensors"
    _write(whisper, _hf_whisper(ASR, 7), "float32")
    asr = _asr_definition(whisper)
    ours = _run(PORT, asr, "asr", 2)
    theirs = _run(JAX, asr, "asr", 2)
    for got, want in zip(ours, theirs):
        assert got.shape == (1, 6)
        np.testing.assert_array_equal(got, want)

    llama = tmp_path / "llama.safetensors"
    _write(llama, _hf_llama(LM, 8, lm_head=True), "float32")
    lm = {
        "name": "lm_hf", "graph": ["(tokens (lm))"],
        "elements": [
            {"name": "tokens", "output": [{"name": "tokens"}],
             "parameters": {"data_sources": [[2, 5]], "count": 2,
                            "vocab_size": 64},
             "deploy": {"local": {"class_name": "TokenSource"}}},
            {"name": "lm", "input": [{"name": "tokens"}],
             "output": [{"name": "generated"}],
             "parameters": dict(LM, dtype="float32", max_new_tokens=5,
                                weights=str(llama)),
             "deploy": {"local": {"class_name": "LMGenerate"}}},
        ],
    }
    ours = _run(PORT, lm, "lm", 2)
    theirs = _run(JAX, lm, "lm", 2)
    for got, want in zip(ours, theirs):
        assert got.shape == (2, 5)
        np.testing.assert_array_equal(got, want)


def test_restore_that_skips_setup_keeps_whisper_token_ids(tmp_path):
    """SpeechToText decides HF naming in configure(): a restore that
    installs the state without setup() still decodes between 50258 and
    50257 (overridable by parameters), with the tokens setup() gives."""
    whisper = tmp_path / "whisper.safetensors"
    _write(whisper, _hf_whisper(ASR, 9), "float32")
    definition = _asr_definition(whisper)
    definition["runtime"] = "torch"
    definition["parameters"] = {"device": "cpu"}
    for item in definition["elements"]:
        item["deploy"]["local"]["module"] = PORT[0]
    process = torch_runtime.Process(transport_kind="loopback")
    try:
        pipeline = torch_pipeline.create_pipeline(process, definition)
        process.run(in_thread=True)
        element = pipeline.elements["asr"]
        element.restore_state(weights.load_whisper_params(
            str(whisper), torch_asr.AsrConfig(**ASR, dtype="float32"),
            device="cpu"))
        assert (element.config.sot_token, element.config.eot_token) == (
            50258, 50257)
        audio = np.random.default_rng(0).standard_normal((1, 3200)).astype(
            np.float32)
        restored = element._transcribe(element.state, audio, 6)
        fresh = weights.load_whisper_params(
            str(whisper), element.config, device="cpu")
        np.testing.assert_array_equal(
            restored.numpy(), element._transcribe(fresh, audio, 6).numpy())
    finally:
        process.terminate()
    definition["elements"][1]["parameters"].update(sot_token=1,
                                                   eot_token=2)
    process = torch_runtime.Process(transport_kind="loopback")
    try:
        element = torch_pipeline.create_pipeline(
            process, definition).elements["asr"]
        process.run(in_thread=True)
        element.configure()
        assert (element.config.sot_token, element.config.eot_token) == (
            1, 2)
    finally:
        process.terminate()
