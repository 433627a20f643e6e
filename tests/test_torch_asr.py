# The port's ASR model (models/asr.py) against the JAX package's on the
# CPU, on the same weights: the JAX package's random parameters go
# through numpy into the port (models/bridge.py), the same numpy audio
# goes into both.  f32 throughout.  The encoder memory agrees to atol
# 1e-4 (the sum of two small transformer layers' f32 rounding, taken in
# another order); greedy token streams must be IDENTICAL.

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import asr as jax_asr
from aiko_services_tpu.models import load_pytree as jax_load_pytree
from aiko_services_tpu.ops import log_mel_spectrogram as jax_log_mel
from aiko_services_tpu_torch.models import asr as torch_asr
from aiko_services_tpu_torch.models import (
    SafetensorsFile, load_pytree, params_from_numpy)

ASSET = pathlib.Path(__file__).parent / "assets" / "asr_tones.safetensors"

TINY = dict(n_mels=80, d_model=32, enc_layers=2, dec_layers=2, n_heads=2,
            vocab_size=64, max_frames=32, max_text_len=16, dtype="float32")
MAX_TOKENS = 8


@pytest.fixture(scope="module")
def tiny():
    """(jax config, jax params, port config, port params, audio)."""
    jax_config = jax_asr.AsrConfig(**TINY)
    jax_params = jax_asr.init_asr_params(jax_config,
                                         jax.random.PRNGKey(3))
    numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    torch_config = torch_asr.AsrConfig(**TINY)
    torch_params = params_from_numpy(numpy_params, device="cpu")
    rng = np.random.default_rng(11)
    t = np.arange(4800) / 16000.0
    audio = np.stack([
        np.sin(2 * np.pi * freq * t) + rng.normal(0, 0.05, t.shape)
        for freq in (300.0, 700.0, 1500.0)]).astype(np.float32)
    return jax_config, jax_params, torch_config, torch_params, audio


def _mel(audio):
    return np.array(jax_log_mel(audio))  # writable, for torch


def test_bridge_keeps_every_leaf(tiny):
    _, jax_params, _, torch_params, _ = tiny
    jax_leaves = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    for path, leaf in jax_leaves:
        node = torch_params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_encode_audio_matches_jax(tiny):
    jax_config, jax_params, torch_config, torch_params, audio = tiny
    mel = _mel(audio)
    expected = np.asarray(jax_asr.encode_audio(jax_params, jax_config, mel))
    actual = torch_asr.encode_audio(torch_params, torch_config,
                                    torch.from_numpy(mel))
    assert actual.shape == expected.shape == (3, 16, 32)
    np.testing.assert_allclose(actual.numpy(), expected, atol=1e-4, rtol=0)


def test_decode_tokens_matches_jax(tiny):
    jax_config, jax_params, torch_config, torch_params, audio = tiny
    mel = _mel(audio)
    tokens = np.random.default_rng(5).integers(0, 64, (3, 7)).astype(
        np.int32)
    memory = jax_asr.encode_audio(jax_params, jax_config, mel)
    expected = np.asarray(jax_asr.decode_tokens(jax_params, jax_config,
                                                tokens, memory))
    actual = torch_asr.decode_tokens(
        torch_params, torch_config, torch.from_numpy(tokens),
        torch.from_numpy(np.array(memory)))
    np.testing.assert_allclose(actual.numpy(), expected, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["transcribe", "transcribe_rescore"])
def test_transcription_tokens_identical(tiny, name):
    jax_config, jax_params, torch_config, torch_params, audio = tiny
    mel = _mel(audio)
    expected = np.asarray(getattr(jax_asr, name)(
        jax_params, jax_config, mel, max_tokens=MAX_TOKENS))
    actual = getattr(torch_asr, name)(
        torch_params, torch_config, torch.from_numpy(mel),
        max_tokens=MAX_TOKENS)
    assert actual.dtype == torch.int32
    np.testing.assert_array_equal(actual.numpy(), expected)


def test_transcribe_audio_tokens_identical(tiny):
    jax_config, jax_params, torch_config, torch_params, audio = tiny
    expected = np.asarray(jax_asr.transcribe_audio(
        jax_params, jax_config, audio, max_tokens=MAX_TOKENS))
    actual = torch_asr.transcribe_audio(
        torch_params, torch_config, torch.from_numpy(audio),
        max_tokens=MAX_TOKENS)
    np.testing.assert_array_equal(actual.numpy(), expected)


def test_asr_tones_asset_transcribes_exactly_through_port_loader():
    """The committed trained checkpoint, read by the PORT's own
    safetensors reader: exact labels, and the JAX package's tokens."""
    container = SafetensorsFile(ASSET)
    metadata = {key: ast.literal_eval(value)
                for key, value in container.metadata.items()}
    container.close()
    config_fields = metadata["config"]
    labels = {float(freq): label
              for freq, label in metadata["labels"].items()}
    t = np.arange(int(float(metadata["seconds"]) * 16000)) / 16000
    audio = np.stack([np.sin(2 * np.pi * freq * t)
                      for freq in labels]).astype(np.float32)

    torch_config = torch_asr.AsrConfig(**config_fields)
    params = load_pytree(ASSET, dtype=torch_config.dtype)
    tokens = torch_asr.transcribe_audio(params, torch_config,
                                        torch.from_numpy(audio),
                                        max_tokens=9).numpy()
    texts = ["".join(chr(token - 3) for token in row if 3 <= token < 259)
             for row in tokens]
    assert texts == list(labels.values())

    jax_config = jax_asr.AsrConfig(**config_fields)
    jax_tokens = np.asarray(jax_asr.transcribe_audio(
        jax_load_pytree(ASSET, dtype=jax_config.dtype), jax_config, audio,
        max_tokens=9))
    np.testing.assert_array_equal(tokens, jax_tokens)


def test_init_is_seeded_by_the_generator():
    config = torch_asr.AsrConfig(**TINY)
    first = torch_asr.init_asr_params(config, torch.Generator().manual_seed(7))
    again = torch_asr.init_asr_params(config, torch.Generator().manual_seed(7))
    other = torch_asr.init_asr_params(config, torch.Generator().manual_seed(8))
    assert torch.equal(first["enc_layers"]["attn"]["wq"]["w"],
                       again["enc_layers"]["attn"]["wq"]["w"])
    assert not torch.equal(first["enc_layers"]["attn"]["wq"]["w"],
                           other["enc_layers"]["attn"]["wq"]["w"])
    assert first["enc_layers"]["attn"]["wq"]["w"].shape == (2, 32, 32)
