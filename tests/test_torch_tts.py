# The port's TTS (models/tts.py, the TextToSpeech element) against the
# JAX package's on the CPU, on the same weights (the JAX package's random
# parameters through numpy into the port, models/bridge.py) and the same
# characters.  Mirrors the TTS tests of tests/test_tts_vision_robot.py
# (TestTTS, the phoneme-training test, the DFT-matmul test), each held
# against the JAX package.
#
# Tolerances: the mel atol 1e-5 (two f32 residual convolutions and the
# mel head, values of order 1, the same products summed in another
# order); the STFT against numpy's rfft atol 2e-3 and the inverse atol
# 1e-4 (the JAX test's: f32 DFT sums of 400 terms of order 1); one
# STFT/ISTFT round trip against the JAX package's atol 1e-5; the
# waveform after Griffin-Lim atol WAVE_ATOL = 1e-4 on a peak-normalized
# signal (each of the iterations feeds its f32 rounding of the phase into
# the next, where bins of tiny magnitude turn it freely); the train
# step's loss rtol 1e-6 (a mean of f32 squares of order 30) and every
# gradient leaf within 1e-6 of its largest entry (f32 sums of the same
# products); along 20 adam(3e-3) steps the losses rtol 1e-5 and then the
# parameters atol 5e-5 (Adam's division by each gradient's own magnitude
# lets them drift apart, as in test_torch_transformer.py).  atan2 at signed zeros must be bit-equal.
# The ISTFT is compared before its division by the window normalization,
# and after it only where that is >= 1e-2: at the window's ends it
# divides f32 rounding by down to 1e-8.

import queue

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aiko_services_tpu.models import tts as jax_tts
from aiko_services_tpu_torch.models import (
    optim, params_from_numpy, params_to_numpy, save_pytree)
from aiko_services_tpu_torch.models import tts as torch_tts
from aiko_services_tpu_torch.pipeline import create_pipeline
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.transport import reset_brokers

MODULE = "aiko_services_tpu_torch.elements"
SMALL = dict(d_model=64, n_conv_layers=2, n_mels=40, n_fft=256, hop=128,
             frames_per_char=4, griffin_lim_iters=8)
WAVE_ATOL = 1e-4


@pytest.fixture(autouse=True)
def clean_brokers():
    reset_brokers()
    yield
    reset_brokers()


def _models(config: dict, seed: int = 0):
    """(jax config, jax params, port config, port params)."""
    jax_config = jax_tts.TTSConfig(**config)
    jax_params = jax_tts.init_tts_params(jax_config,
                                         jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jax_params),
                               device="cpu")
    return jax_config, jax_params, torch_tts.TTSConfig(**config), params


def test_init_tts_params_tree_matches_jax():
    jax_config, jax_params, config, _ = _models(SMALL)
    ours = params_to_numpy(torch_tts.init_tts_params(
        config, torch.Generator().manual_seed(0), device="cpu"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
        node = ours
        for key in path:
            node = node[key.key]
        assert node.shape == leaf.shape and node.dtype == leaf.dtype


def test_encode_chars_is_the_jax_packages():
    for text, max_len in (("hello world", 16), ("naïve", None),
                          ("abcdefgh", 4)):
        np.testing.assert_array_equal(torch_tts.encode_chars(text, max_len),
                                      jax_tts.encode_chars(text, max_len))


def test_mel_shapes_and_values_match_jax():
    jax_config, jax_params, config, params = _models(SMALL)
    chars = torch_tts.encode_chars("hello world", max_len=16)
    chars[0, -1] = 300                  # out of the table: clips to 255
    expected = jax_tts.synthesize_mel(jax_params, jax_config,
                                      jnp.asarray(chars))
    mel = torch_tts.synthesize_mel(params, config, torch.from_numpy(chars))
    assert tuple(mel.shape) == (1, 40, 16 * 4)
    np.testing.assert_allclose(mel.numpy(), np.asarray(expected), atol=1e-5,
                               rtol=0)


def test_waveform_end_to_end_matches_jax():
    jax_config, jax_params, config, params = _models(SMALL)
    chars = torch_tts.encode_chars("aloha honua", max_len=16)
    expected = np.asarray(jax_tts.synthesize(jax_params, jax_config,
                                             jnp.asarray(chars)))
    waveform = torch_tts.synthesize(params, config, torch.from_numpy(chars))
    samples = (16 * 4 - 1) * 128 + 256
    assert tuple(waveform.shape) == (1, samples)
    assert waveform.dtype == torch.float32
    wave = waveform.numpy()
    assert np.isfinite(wave).all()
    assert np.abs(wave).max() <= 1.0 + 1e-5
    assert np.abs(wave).max() > 1e-3
    np.testing.assert_allclose(wave, expected, atol=WAVE_ATOL, rtol=0)


def test_deterministic():
    _, _, config, params = _models(SMALL)
    chars = torch.from_numpy(torch_tts.encode_chars("abc", max_len=8))
    assert torch.equal(torch_tts.synthesize(params, config, chars),
                       torch_tts.synthesize(params, config, chars))


def test_stft_round_trip_matches_jax_and_the_fft():
    """The Griffin-Lim transforms as real DFT matmuls: the STFT against
    numpy's rfft of the same frames, the inverse against irfft, and one
    windowed ISTFT of the JAX package's against the port's."""
    n_fft, hop = 400, 100
    rng = np.random.default_rng(0)
    signal = rng.standard_normal((2, 2000)).astype(np.float32)
    window_np = np.hanning(n_fft).astype(np.float32)
    window = torch.from_numpy(window_np)
    cos_m, sin_m = torch_tts._dft_matrices(n_fft, "cpu")
    real, imag = torch_tts._stft_ri(torch.from_numpy(signal), n_fft, hop,
                                    window, cos_m, sin_m)
    frames = torch_tts._frame(torch.from_numpy(signal), n_fft, hop).numpy()
    reference = np.fft.rfft(frames * window_np, axis=-1)
    np.testing.assert_allclose(real.numpy(), reference.real, atol=2e-3)
    np.testing.assert_allclose(imag.numpy(), reference.imag, atol=2e-3)
    jax_frames = np.asarray(jax_tts._frame(jnp.asarray(signal), n_fft, hop))
    np.testing.assert_array_equal(frames, jax_frames)
    weights = torch_tts._irfft_weights(n_fft, "cpu")
    inverse = (real * weights) @ cos_m.T + (imag * weights) @ sin_m.T
    np.testing.assert_allclose(
        inverse.numpy(), np.fft.irfft(reference, n=n_fft, axis=-1),
        atol=1e-4)
    # the windowed inverse with overlap-add, against the JAX package's
    length = (real.shape[1] - 1) * hop + n_fft
    norm = torch_tts._window_norm(window_np, hop, real.shape[1], length,
                                  "cpu")
    jax_norm = jax_tts._window_norm(window_np, hop, real.shape[1], length)
    np.testing.assert_array_equal(norm.numpy(), np.asarray(jax_norm))
    jax_cos, jax_sin = jax_tts._dft_matrices(n_fft)
    expected = jax_tts._istft_ri(
        jnp.asarray(real.numpy()), jnp.asarray(imag.numpy()), n_fft, hop,
        jnp.asarray(window_np), length, jax_cos, jax_sin,
        jax_tts._irfft_weights(n_fft), jax_norm)
    actual = torch_tts._istft_ri(real, imag, n_fft, hop, window, length,
                                 cos_m, sin_m, weights, norm)
    # before the division by the window normalization, everywhere; after
    # it, where the normalization is not near zero (the window's ends
    # divide f32 rounding by down to 1e-8)
    norm = norm.numpy()
    np.testing.assert_allclose(actual.numpy() * norm,
                               np.asarray(expected) * norm, atol=1e-5,
                               rtol=0)
    inner = norm >= 1e-2
    np.testing.assert_allclose(actual.numpy()[:, inner],
                               np.asarray(expected)[:, inner], atol=1e-5,
                               rtol=0)


def test_atan2_at_signed_zeros_is_jnp_arctan2():
    """Griffin-Lim's phase where the real part is non-positive and the
    imaginary part is +-0: atan2(+-0, x <= 0) is +-pi (and +-0 at x = +0),
    bit for bit in both packages."""
    imag = np.array([0.0, -0.0, 0.0, -0.0, 0.0, -0.0, 1e-30, -1e-30],
                    np.float32)
    real = np.array([-1.0, -1.0, -0.0, -0.0, 0.0, 0.0, -2.0, -2.0],
                    np.float32)
    expected = np.asarray(jnp.arctan2(jnp.asarray(imag), jnp.asarray(real)))
    actual = torch.atan2(torch.from_numpy(imag), torch.from_numpy(real))
    np.testing.assert_array_equal(actual.numpy().view(np.uint32),
                                  expected.view(np.uint32))


def _phoneme_targets(config):
    """'aaaaaaaa' with energy in the low mel bands, 'ssssssss' in the high
    ones (the JAX package's phoneme templates)."""
    chars = np.concatenate([torch_tts.encode_chars("aaaaaaaa"),
                            torch_tts.encode_chars("ssssssss")])
    frames = chars.shape[1] * config.frames_per_char
    target = np.full((2, config.n_mels, frames), -6.0, np.float32)
    target[0, 4:16] = 1.5
    target[1, 60:76] = 1.5
    return chars, target


def _capture_gradients():
    from aiko_services_tpu_torch.utils.tree import tree_map
    return optim.GradientTransformation(
        lambda params: None,
        lambda grads, state, params=None: (
            tree_map(torch.zeros_like, grads), grads))


def test_tts_train_step_loss_and_gradients_match_jax():
    config_dict = dict(d_model=64, n_conv_layers=2, frames_per_char=4,
                       griffin_lim_iters=8)
    jax_config, jax_params, config, params = _models(config_dict)
    chars, target = _phoneme_targets(config)
    jax_step = jax_tts.make_tts_train_step(jax_config, optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g)))
    _, expected_grads, expected_loss = jax_step(
        jax.tree_util.tree_map(jnp.array, jax_params),
        jax.tree_util.tree_map(jnp.zeros_like, jax_params),
        jnp.asarray(chars), jnp.asarray(target))
    step = torch_tts.make_tts_train_step(config, _capture_gradients())
    _, grads, loss = step(params, None, torch.from_numpy(chars),
                          torch.from_numpy(target))
    np.testing.assert_allclose(float(loss), float(expected_loss), atol=0,
                               rtol=1e-6)
    numpy_grads = params_to_numpy(grads)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            expected_grads)[0]:
        node = numpy_grads
        for key in path:
            node = node[key.key]
        scale = float(np.abs(np.asarray(leaf)).max())
        np.testing.assert_allclose(node, np.asarray(leaf),
                                   atol=1e-6 * scale, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def _spectral_centroid(waveform, sample_rate=16000):
    spectrum = np.abs(np.fft.rfft(np.asarray(waveform, np.float64)))
    freqs = np.fft.rfftfreq(len(waveform), 1.0 / sample_rate)
    power = spectrum ** 2
    return float((freqs * power).sum() / max(power.sum(), 1e-12))


def test_tts_training_learns_phoneme_spectra_as_jax_does():
    """20 adam(3e-3) steps track optax's, then the port trains on to 300
    steps: the loss falls below a tenth, and the sibilant's spectral
    centroid sits far above the vowel's (the JAX package's test)."""
    config_dict = dict(d_model=64, n_conv_layers=2, frames_per_char=4,
                       griffin_lim_iters=8)
    jax_config, jax_params, config, params = _models(config_dict)
    chars, target = _phoneme_targets(config)
    chars_t, target_t = torch.from_numpy(chars), torch.from_numpy(target)
    untrained_a = torch_tts.synthesize(params, config, chars_t[:1])[0]
    untrained_s = torch_tts.synthesize(params, config, chars_t[1:])[0]
    untrained_gap = abs(_spectral_centroid(untrained_s.numpy())
                        - _spectral_centroid(untrained_a.numpy()))
    jax_optimizer = optax.adam(3e-3)
    jax_state = jax_optimizer.init(jax_params)
    jax_step = jax_tts.make_tts_train_step(jax_config, jax_optimizer)
    optimizer = optim.adam(3e-3)
    state = optimizer.init(params)
    step = torch_tts.make_tts_train_step(config, optimizer)
    first_loss = None
    for index in range(300):
        params, state, loss = step(params, state, chars_t, target_t)
        if first_loss is None:
            first_loss = float(loss)
        if index < 20:
            jax_params, jax_state, expected = jax_step(
                jax_params, jax_state, jnp.asarray(chars),
                jnp.asarray(target))
            np.testing.assert_allclose(float(loss), float(expected),
                                       atol=0, rtol=1e-5)
        if index == 19:
            numpy_params = params_to_numpy(params)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    jax_params)[0]:
                node = numpy_params
                for key in path:
                    node = node[key.key]
                np.testing.assert_allclose(node, np.asarray(leaf),
                                           atol=5e-5, rtol=0)
    assert float(loss) < first_loss * 0.1, (first_loss, float(loss))
    centroid_a = _spectral_centroid(
        torch_tts.synthesize(params, config, chars_t[:1])[0].numpy())
    centroid_s = _spectral_centroid(
        torch_tts.synthesize(params, config, chars_t[1:])[0].numpy())
    assert centroid_s > centroid_a * 1.5, (centroid_a, centroid_s)
    assert centroid_s - centroid_a > 4 * untrained_gap, (
        untrained_gap, centroid_a, centroid_s)


def _tts_pipeline(parameters: dict, texts: list) -> list:
    definition = {
        "name": "tts_pipe",
        "graph": ["(speak)"],
        "parameters": {"device": "cpu"},
        "elements": [
            {"name": "speak", "input": [{"name": "text"}],
             "output": [{"name": "audio"}, {"name": "sample_rate"}],
             "parameters": parameters,
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "TextToSpeech"}}}],
    }
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        stream = pipeline.create_stream("s1", queue_response=responses)
        for text in texts:
            pipeline.create_frame(stream, {"text": text})
        return [responses.get(timeout=120)[2] for _ in texts]
    finally:
        process.terminate()


def test_element_in_pipeline_matches_jax_on_saved_weights(tmp_path,
                                                          monkeypatch):
    """The JAX package's weights saved with save_pytree, loaded by the
    port's element: the waveform of each prompt (padded to its bucket)
    equals the JAX package's synthesize on the same characters; a prompt
    past max_chars is truncated with a warning."""
    config_dict = dict(d_model=64, n_conv_layers=2, frames_per_char=4,
                       griffin_lim_iters=4)
    jax_config, jax_params, _, _ = _models(config_dict)
    weights = tmp_path / "tts.safetensors"
    save_pytree(weights, jax.tree_util.tree_map(np.asarray, jax_params))
    from aiko_services_tpu_torch.elements import ml
    warnings = []
    monkeypatch.setattr(ml._LOGGER, "warning",
                        lambda message, *args: warnings.append(
                            message % args))
    texts = ["hello", ["hi there", "a longer prompt of text"],
             "x" * 40]
    outputs = _tts_pipeline({**config_dict, "weights": str(weights),
                             "max_chars": 32}, texts)
    for text, output in zip(texts, outputs):
        prompts = [text] if isinstance(text, str) else text
        longest = min(max(len(prompt) for prompt in prompts), 32)
        width = 16 if longest <= 16 else 32
        chars = np.concatenate([jax_tts.encode_chars(prompt, max_len=width)
                                for prompt in prompts])
        expected = np.asarray(jax_tts.synthesize(jax_params, jax_config,
                                                 jnp.asarray(chars)))
        audio = output["audio"].numpy()
        assert output["sample_rate"] == 16000
        assert audio.shape == expected.shape
        assert audio.shape[1] > 1000 and np.isfinite(audio).all()
        np.testing.assert_allclose(audio, expected, atol=WAVE_ATOL, rtol=0)
    assert any("truncated to max_chars=32" in warning
               for warning in warnings)


def test_tts_flops_per_example_is_the_jax_packages():
    from aiko_services_tpu.models.configs import (
        tts_flops_per_example as jax_flops)
    from aiko_services_tpu_torch.models.configs import tts_flops_per_example
    for config in (SMALL, {}):
        assert (tts_flops_per_example(torch_tts.TTSConfig(**config), 32)
                == jax_flops(jax_tts.TTSConfig(**config), 32))
