# The port's ASR model (models/asr.py) against the JAX package's on the
# CPU, on the same weights: the JAX package's random parameters go
# through numpy into the port (models/bridge.py), the same numpy audio
# goes into both.  f32 throughout.  The encoder memory agrees to atol
# 1e-4 (the sum of two small transformer layers' f32 rounding, taken in
# another order); greedy token streams must be IDENTICAL.  The train step:
# the loss to atol 1e-5 and every gradient leaf to atol 1e-5 (values of
# order 1e-1, the same f32 sums in another order); parameters after three
# adamw(1e-3) steps to atol 5e-5 (Adam divides each gradient by its own
# running magnitude, so a rounding difference in a gradient near its noise
# floor moves that entry by a fraction of the learning rate).

import ast
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aiko_services_tpu.models import asr as jax_asr
from aiko_services_tpu.models import load_pytree as jax_load_pytree
from aiko_services_tpu.ops import log_mel_spectrogram as jax_log_mel
from aiko_services_tpu_torch.models import asr as torch_asr
from aiko_services_tpu_torch.models import (
    SafetensorsFile, load_pytree, optim, params_from_numpy, params_to_numpy)
from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram

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
    params = load_pytree(ASSET, dtype=torch_config.dtype, device="cpu")
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
    first = torch_asr.init_asr_params(
        config, torch.Generator().manual_seed(7), device="cpu")
    again = torch_asr.init_asr_params(
        config, torch.Generator().manual_seed(7), device="cpu")
    other = torch_asr.init_asr_params(
        config, torch.Generator().manual_seed(8), device="cpu")
    assert torch.equal(first["enc_layers"]["attn"]["wq"]["w"],
                       again["enc_layers"]["attn"]["wq"]["w"])
    assert not torch.equal(first["enc_layers"]["attn"]["wq"]["w"],
                           other["enc_layers"]["attn"]["wq"]["w"])
    assert first["enc_layers"]["attn"]["wq"]["w"].shape == (2, 32, 32)


def _pairs(jax_tree, torch_tree):
    torch_numpy = params_to_numpy(torch_tree)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        node = torch_numpy
        for key in path:
            node = node[key.key]
        yield jax.tree_util.keystr(path), np.asarray(leaf), node


def _train_tokens():
    return np.random.default_rng(9).integers(0, 64, (3, 7)).astype(np.int32)


def test_train_step_loss_and_gradients_match_jax(tiny):
    jax_config, jax_params, torch_config, _, audio = tiny
    mel = _mel(audio)
    tokens = _train_tokens()

    def jax_loss(params, mel, tokens):
        logits = jax_asr.asr_forward(params, jax_config, mel, tokens[:, :-1])
        log_probs = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            log_probs, tokens[:, 1:, None], axis=-1)[..., 0])

    def torch_loss(params, mel, tokens):
        logits = torch_asr.asr_forward(params, torch_config, mel,
                                       tokens[:, :-1])
        return optim.next_token_loss(logits, tokens[:, 1:])

    expected_loss, expected_grads = jax.value_and_grad(jax_loss)(
        jax_params, mel, tokens)
    numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    loss, grads = optim.value_and_grad(
        torch_loss, params_from_numpy(numpy_params, device="cpu"),
        torch.from_numpy(mel), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(expected_loss), atol=1e-5,
                               rtol=0)
    leaves = list(_pairs(expected_grads, grads))
    assert len(leaves) == len(jax.tree_util.tree_leaves(jax_params))
    for name, want, got in leaves:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=name)


def test_three_train_steps_match_jax(tiny):
    jax_config, jax_params, torch_config, _, audio = tiny
    mel = _mel(audio)
    tokens = _train_tokens()
    jax_optimizer = optax.adamw(1e-3)
    jax_step = jax_asr.make_asr_train_step(jax_config, jax_optimizer)
    expected, jax_state = jax_params, jax_optimizer.init(jax_params)
    optimizer = optim.adamw(1e-3)
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")
    state = optimizer.init(params)
    step = torch_asr.make_asr_train_step(torch_config, optimizer)
    for _ in range(3):
        expected, jax_state, expected_loss = jax_step(expected, jax_state,
                                                      mel, tokens)
        params, state, loss = step(params, state, torch.from_numpy(mel),
                                   torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(expected_loss),
                                   atol=1e-5, rtol=0)
    for name, want, got in _pairs(expected, params):
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0,
                                   err_msg=name)


def _tones_recipe():
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "train_asr_tones.py")
    spec = importlib.util.spec_from_file_location("train_asr_tones", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tones_recipe_loss_falls_in_twenty_steps():
    """The examples/train_asr_tones.py recipe (its config, adamw(3e-4),
    8 jittered tones per class per step) through the port's own
    initialisation and train step on the CPU."""
    recipe = _tones_recipe()
    config = torch_asr.AsrConfig(
        n_mels=80, d_model=64, enc_layers=2, dec_layers=2, n_heads=4,
        vocab_size=259, max_frames=24, max_text_len=16, dtype="float32")
    params = torch_asr.init_asr_params(
        config, torch.Generator().manual_seed(0), device="cpu")
    optimizer = optim.adamw(3e-4)
    state = optimizer.init(params)
    step = torch_asr.make_asr_train_step(config, optimizer)
    rng = np.random.default_rng(7)
    losses = []
    for _ in range(20):
        audio, tokens = recipe.tone_batch(rng, per_class=8)
        mel = log_mel_spectrogram(torch.from_numpy(audio),
                                  n_mels=config.n_mels)
        params, state, loss = step(params, state, mel,
                                   torch.from_numpy(tokens))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5
