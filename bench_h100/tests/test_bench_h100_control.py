"""`correct` must come out false for the controls and for the faults
each cell can have: a run of the harness at a toy size on the CPU with
the timed path broken underneath (the look for a card is skipped).
On the card the controls run at the cells' own sizes through
bench_h100/control.py."""

import time

import pytest
import torch

from bench_h100 import harness
from bench_h100.tests import toy

SEED = 2**32 + 21


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    directory = tmp_path_factory.mktemp("cells")
    return directory, toy.write(directory)


def run(cells, cell, control=None):
    directory, benchmark = cells
    return harness.execute(benchmark, cell, SEED, 1.0, False, "cpu",
                           time.perf_counter(), directory=directory,
                           control=control)


def gap(result, name):
    check = result["checks"][name]
    return check["value"], check["limit"]


@pytest.mark.parametrize("cell,control,name", [
    ("toy_whisper.tones", "reference_fp8", "control_max_logit_gap"),
    ("toy_decoder.chat", "program_int8", "mean_logit_gap")])
def test_control_is_not_correct(cells, cell, control, name):
    result = run(cells, cell, control)
    assert result["correct"] is False
    value, limit = gap(result, name)
    assert value > limit


def _altered_token(monkeypatch):
    from aiko_services_tpu_torch.models import asr
    original = asr._greedy_next

    calls = []

    def altered(config, logits, finished):
        """The third token of every row altered."""
        tokens = original(config, logits, finished)
        calls.append(None)
        if len(calls) % 6 == 3:
            tokens = (tokens + 1) % config.vocab_size
        return tokens

    monkeypatch.setattr(asr, "_greedy_next", altered)


def _half_batch(monkeypatch):
    from aiko_services_tpu_torch.models import asr
    original = asr.transcribe

    def half(params, config, mel, max_tokens=32):
        rows = mel.shape[0]
        tokens = original(params, config, mel[:(rows + 1) // 2],
                          max_tokens)
        return torch.cat([tokens, tokens])[:rows]

    monkeypatch.setattr(asr, "transcribe", half)


def _state_unchanged(monkeypatch):
    from aiko_services_tpu_torch.models import asr
    original = asr._decode_step

    def unchanged(params, config, token, index, self_k, self_v, *cross):
        logits, _, _ = original(params, config, token, index,
                                self_k.clone(), self_v.clone(), *cross)
        return logits, self_k, self_v

    monkeypatch.setattr(asr, "_decode_step", unchanged)


@pytest.mark.parametrize("fault", [_altered_token, _half_batch,
                                   _state_unchanged])
def test_speech_faults_are_not_correct(cells, monkeypatch, fault):
    fault(monkeypatch)
    result = run(cells, "toy_whisper.tones")
    assert result["correct"] is False


def _engine_step(monkeypatch, change):
    from aiko_services_tpu_torch.decode import engine
    original = engine.paged_decode_step

    def broken(params, config, pool, *arrays):
        return change(original, params, config, pool, *arrays)

    monkeypatch.setattr(engine, "paged_decode_step", broken)


def _engine_altered_token(original, params, config, pool, *arrays):
    pool, tokens = original(params, config, pool, *arrays)
    tokens = tokens.clone()
    tokens[:, 0] = (tokens[:, 0] + 1) % config.vocab_size
    return pool, tokens


def _engine_state_unchanged(original, params, config, pool, *arrays):
    copy = {name: buffer.clone() for name, buffer in pool.items()}
    return pool, original(params, config, copy, *arrays)[1]


def _engine_half_batch(original, params, config, pool, *arrays):
    """Every other slot left out: each odd slot gets its even
    neighbour's token."""
    pool, tokens = original(params, config, pool, *arrays)
    tokens = tokens.clone()
    tokens[1::2] = tokens[0::2][:tokens[1::2].shape[0]]
    return pool, tokens


@pytest.mark.parametrize("change", [_engine_altered_token,
                                    _engine_state_unchanged,
                                    _engine_half_batch])
def test_engine_faults_are_not_correct(cells, monkeypatch, change):
    _engine_step(monkeypatch, change)
    result = run(cells, "toy_decoder.chat")
    assert result["correct"] is False
