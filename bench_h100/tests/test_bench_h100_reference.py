"""The plain references against the port at f32 on tiny shapes, on the
same seeded weights the benchmark draws."""

import numpy as np
import pytest
import torch

from bench_h100.drivers import engine_open_loop, pipeline_speech
from bench_h100.reference import full_f32, gaps
from bench_h100.reference import transformer as lm_reference
from bench_h100.reference import whisper as asr_reference
from bench_h100.tests import toy


@pytest.fixture(scope="module")
def whisper():
    config = dict(toy.WHISPER)
    return config, pipeline_speech.weights(config, 2**33 + 3, "cpu")


@pytest.fixture(scope="module")
def decoder():
    config = dict(toy.DECODER)
    return config, engine_open_loop.weights(config, 2**31 + 9, "cpu")


def audio(rows: int, seconds: float = 2.0) -> torch.Tensor:
    rng = np.random.default_rng(4)
    return torch.from_numpy(rng.standard_normal(
        (rows, int(seconds * 16000))).astype(np.float32))


def test_log_mel_matches_the_port():
    from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram
    wave = audio(3)
    with full_f32():
        mine = asr_reference.log_mel(wave, 80)
    theirs = log_mel_spectrogram(wave, n_mels=80)
    assert mine.shape == theirs.shape
    torch.testing.assert_close(mine, theirs, atol=2e-4, rtol=1e-4)


def test_whisper_encoder_and_decoder_match_the_port(whisper):
    from aiko_services_tpu_torch.models import asr
    from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram
    config, params = whisper
    program = pipeline_speech.asr_config(config)
    mel = log_mel_spectrogram(audio(2), n_mels=80)
    tokens = torch.randint(0, config["vocab_size"], (2, 7),
                           generator=torch.Generator().manual_seed(1))
    with full_f32():
        memory = asr_reference.encode(params, config, mel)
        logits = asr_reference.decoder_logits(params, config, tokens,
                                              memory)
    torch.testing.assert_close(memory, asr.encode_audio(params, program,
                                                        mel),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        logits, asr.decode_tokens(params, program, tokens, memory),
        atol=1e-4, rtol=1e-4)


def test_decoder_logits_match_the_port(decoder):
    from aiko_services_tpu_torch.models import forward
    config, params = decoder
    program = engine_open_loop.transformer_config(config)
    tokens = torch.randint(0, config["vocab_size"], (19,),
                           generator=torch.Generator().manual_seed(2))
    with full_f32():
        mine = lm_reference.logits(params, config, tokens, 5)
    theirs = forward(params, program, tokens[None])[0, 5:]
    torch.testing.assert_close(mine, theirs, atol=1e-4, rtol=1e-4)


def test_reference_blocks_its_queries_without_changing_them(
        decoder, monkeypatch):
    config, params = decoder
    tokens = torch.randint(0, config["vocab_size"], (23,),
                           generator=torch.Generator().manual_seed(3))
    whole = lm_reference.logits(params, config, tokens, 0)
    monkeypatch.setattr(lm_reference, "_QUERY_BLOCK", 4)
    torch.testing.assert_close(lm_reference.logits(params, config,
                                                   tokens, 0), whole)


def test_fp8_reference_parts_from_the_f32_one(whisper):
    """The whisper cell's control: the same reference in float8."""
    from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram
    config, params = whisper
    mel = log_mel_spectrogram(audio(2), n_mels=80)
    tokens = torch.randint(0, config["vocab_size"], (2, 9),
                           generator=torch.Generator().manual_seed(6))
    exact = asr_reference.decoder_logits(
        params, config, tokens, asr_reference.encode(params, config, mel))
    rounded = asr_reference.decoder_logits(
        params, config, tokens,
        asr_reference.encode(params, config, mel, "fp8"), "fp8")
    assert float((exact - rounded).abs().max()) > 1e-2
    assert float(gaps(exact[0], exact[0].argmax(dim=-1)).max()) == 0.0
