# LMGenerate `continuous: true` (the decode engine behind the element)
# through the port's Process / create_pipeline on the CPU: the same
# frames give the closed batch's tokens and the JAX package's continuous
# pipeline's (the JAX package's random parameters saved with its
# save_pytree and loaded by both); chunked prefill and speculation
# through the element; token streaming, stream teardown and engine
# failure; the AIKO405 / AIKO411 lint verdicts against the JAX package's;
# and what is still refused (`role`, `checkpoint`, `prefix_keeper`,
# handoff / restore inputs).  f32 throughout; tokens must be identical.

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
from aiko_services_tpu.analyze import policies as jax_policies
from aiko_services_tpu_torch.analyze import policies
from aiko_services_tpu_torch.pipeline.definition import DefinitionError

JAX = ("aiko_services_tpu.elements", jax_pipeline, jax_runtime)
PORT = ("aiko_services_tpu_torch.elements", torch_pipeline, torch_runtime)

LM = {"vocab_size": 300, "d_model": 32, "n_layers": 1, "n_heads": 2,
      "n_kv_heads": 1, "d_ff": 64, "max_seq_len": 128, "dtype": "float32",
      "max_new_tokens": 6}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These models are tiny: one intra-op thread computes them as fast as
    many, and several test workers sharing the cores do not then spin
    each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_brokers():
    jax_transport.reset_brokers()
    torch_transport.reset_brokers()
    yield
    jax_transport.reset_brokers()
    torch_transport.reset_brokers()


def wait_for(predicate, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError("condition not reached in time")


def definition(package, parameters, validate=True):
    return {
        "name": "lm_pipe",
        "graph": ["(lm)"],
        "parameters": ({"device": "cpu"} if package is PORT else {})
        | ({} if validate else {"validate": False}),
        "elements": [
            {"name": "lm", "input": [{"name": "tokens"}],
             "output": [{"name": "generated"}],
             "parameters": {**LM, **parameters},
             "deploy": {"local": {"module": package[0],
                                  "class_name": "LMGenerate"}}}],
    }


class Running:
    """A one-element LMGenerate pipeline on a running Process."""

    def __init__(self, package, parameters, out=False):
        self.process = package[2].Process(transport_kind="loopback")
        self.pipeline = package[1].create_pipeline(
            self.process, definition(package, parameters))
        self.lm = self.pipeline.elements["lm"]
        self.streamed = []
        if out:
            self.process.add_message_handler(
                lambda topic, payload: self.streamed.append(payload),
                f"{self.lm.topic_path}/out")
        self.process.run(in_thread=True)

    def serve(self, frames, stream_id="s", parameters=None):
        responses = queue.Queue()
        stream = self.pipeline.create_stream(
            stream_id, queue_response=responses, grace_time=300,
            parameters=parameters or {})
        for frame in frames:
            self.pipeline.create_frame(stream, {"tokens": frame})
        return [responses.get(timeout=120) for _ in frames]

    def close(self):
        self.process.terminate()


def run_frames(package, parameters, frames):
    running = Running(package, parameters)
    try:
        results = running.serve(frames)
        return results, running.lm.engine_stats() if parameters.get(
            "continuous") else None
    finally:
        running.close()


def _generated(results):
    return [np.asarray(outputs["generated"]) for _, _, outputs in results]


def test_continuous_pipeline_equals_closed_batch():
    """The same frames through `continuous: true` and the closed batch:
    identical completions, per frame, in frame order."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(1, 300, size=(2, 7)).astype(np.int32)
              for _ in range(3)]
    closed, _ = run_frames(PORT, {}, frames)
    continuous, stats = run_frames(
        PORT, {"continuous": True, "decode_slots": 3, "kv_block_size": 8},
        frames)
    for (_, closed_frame, _), (_, frame, _) in zip(closed, continuous):
        assert closed_frame.frame_id == frame.frame_id
    for expected, actual in zip(_generated(closed), _generated(continuous)):
        np.testing.assert_array_equal(actual, expected)
    assert stats["completed"] == sum(frame.shape[0] for frame in frames)
    assert stats["active_slots"] == 0 and stats["waiting"] == 0


def test_continuous_pipeline_equals_the_jax_packages(tmp_path):
    """Both packages' continuous pipelines on the JAX package's weights
    (saved with its save_pytree): identical tokens and engine counters."""
    path = str(tmp_path / "lm.safetensors")
    jax_models.save_pytree(path, jax_models.init_params(
        jax_models.TransformerConfig(
            **{key: value for key, value in LM.items()
               if key != "max_new_tokens"}),
        jax.random.PRNGKey(4)))
    rng = np.random.default_rng(6)
    frames = [rng.integers(1, 300, size=(3, 9)).astype(np.int32)
              for _ in range(2)]
    parameters = {"continuous": True, "decode_slots": 2, "kv_block_size": 4,
                  "weights": path, "prefill_chunk_size": 4}
    expected, expected_stats = run_frames(JAX, parameters, frames)
    actual, stats = run_frames(PORT, parameters, frames)
    for want, got in zip(_generated(expected), _generated(actual)):
        np.testing.assert_array_equal(got, want)
    for name in ("admitted", "completed", "preempted", "prefill_chunks",
                 "chunk_interleaves"):
        assert stats[name] == expected_stats[name], name


def test_chunked_speculative_element_equals_closed_batch():
    """`prefill_chunk_size` + `speculative: draft=self;k=3;layers=1;
    seed=9` through the element: the closed batch's tokens, and the
    engine's counters reach engine_stats()."""
    rng = np.random.default_rng(21)
    frames = [rng.integers(1, 300, size=(2, 17)).astype(np.int32)
              for _ in range(2)]
    closed, _ = run_frames(PORT, {}, frames)
    continuous, stats = run_frames(
        PORT, {"continuous": True, "decode_slots": 3, "kv_block_size": 8,
               "prefill_chunk_size": 8,
               "speculative": "draft=self;k=3;layers=1;seed=9"}, frames)
    for expected, actual in zip(_generated(closed), _generated(continuous)):
        np.testing.assert_array_equal(actual, expected)
    assert stats["prefill_chunks"] > 0
    assert stats["spec_windows"] > 0
    assert stats["accepted_len_mean"] >= 1.0
    assert 0.0 <= stats["draft_overhead_frac"] <= 1.0
    assert stats["prefill_chunk_size"] == 8 and stats["spec_k"] == 3


def test_prefix_policy_element_equals_cold():
    """`prefix_policy` through the element: frames sharing a long
    leading prompt borrow cached blocks and give the cold tokens."""
    rng = np.random.default_rng(8)
    preamble = rng.integers(1, 300, size=20).astype(np.int32)
    frames = [np.concatenate([preamble, rng.integers(1, 300, size=5)
                              .astype(np.int32)])[None] for _ in range(3)]
    cold, cold_stats = run_frames(
        PORT, {"continuous": True, "decode_slots": 2, "kv_block_size": 8},
        frames)
    warm, stats = run_frames(
        PORT, {"continuous": True, "decode_slots": 2, "kv_block_size": 8,
               "prefix_policy": "prefix_cache=on;min_prefix_blocks=1"},
        frames)
    for expected, actual in zip(_generated(cold), _generated(warm)):
        np.testing.assert_array_equal(actual, expected)
    assert stats["prefix_hits"] > 0 and stats["prefix_blocks_shared"] > 0
    assert "prefix_cached_blocks" not in cold_stats


def test_continuous_pipeline_adds_no_step_signature_after_warmup():
    rng = np.random.default_rng(1)
    frames = [rng.integers(1, 300, size=(1, 9)).astype(np.int32)
              for _ in range(4)]
    running = Running(PORT, {"continuous": True, "decode_slots": 2,
                             "kv_block_size": 8})
    try:
        running.serve(frames[:1])
        warm = running.lm.engine_stats()["compiles"]
        running.serve(frames[1:], stream_id="s2")
        assert running.lm.engine_stats()["compiles"] == warm
    finally:
        running.close()


def test_continuous_token_streaming_chunks():
    """`stream_tokens` publishes per-row `(token_chunk stream_id frame_id
    row offset payload)` chunks."""
    frames = [np.random.default_rng(2).integers(1, 300, size=(2, 5))
              .astype(np.int32)]
    running = Running(PORT, {"continuous": True, "decode_slots": 2,
                             "kv_block_size": 8, "stream_tokens": True,
                             "stream_chunk": 2}, out=True)
    try:
        [(_, _, outputs)] = running.serve(frames)
        # 2 rows x 6 tokens in chunks of 2 -> 6 publishes
        wait_for(lambda: len([payload for payload in running.streamed
                              if payload.startswith("(token_chunk")]) >= 6)
        assert np.asarray(outputs["generated"]).shape == (2, 6)
    finally:
        running.close()


def test_stop_stream_cancels_inflight_work():
    running = Running(PORT, {"continuous": True, "decode_slots": 2,
                             "kv_block_size": 8, "max_new_tokens": 64})
    try:
        lm, pipeline = running.lm, running.pipeline
        tokens = np.arange(1, 8, dtype=np.int32)[None]
        stream = pipeline.create_stream("s1", grace_time=300)
        pipeline.create_frame(stream, {"tokens": tokens})
        wait_for(lambda: lm.engine_stats() is not None
                 and lm.engine_stats()["admitted"] >= 1)
        pipeline.destroy_stream("s1")
        wait_for(lambda: lm.engine_stats()["cancelled"] >= 1
                 or lm.engine_stats()["completed"] >= 1)
        [(_, _, outputs)] = running.serve([tokens], stream_id="s2")
        assert np.asarray(outputs["generated"]).shape == (1, 64)
        wait_for(lambda: lm.engine_stats()["active_slots"] == 0)
    finally:
        running.close()


def test_engine_failure_releases_pending_frames():
    """A crash inside the pump errors out every parked frame, drops the
    engine, and the next continuous frame rebuilds a working one."""
    running = Running(PORT, {"continuous": True, "decode_slots": 2,
                             "kv_block_size": 8, "max_new_tokens": 4})
    try:
        lm, pipeline = running.lm, running.pipeline
        tokens = np.arange(1, 9, dtype=np.int32)[None]
        [expected] = _generated(running.serve([tokens], stream_id="ok1"))

        def explode():
            raise RuntimeError("injected device failure")

        lm._engine.step = explode
        doomed = pipeline.create_stream("doomed", grace_time=300)
        pipeline.create_frame(doomed, {"tokens": tokens})
        wait_for(lambda: lm._engine is None and not lm._engine_frames)
        [out] = _generated(running.serve([tokens], stream_id="ok2"))
        np.testing.assert_array_equal(out, expected)
    finally:
        running.close()


def test_rejected_submit_does_not_leak_frame_entry():
    running = Running(PORT, {"continuous": True, "decode_slots": 2,
                             "kv_block_size": 8, "max_context": 32,
                             "max_new_tokens": 20})
    try:
        lm, pipeline = running.lm, running.pipeline
        # row 0 (8 + 20 = 28) queues, row 1 (16 + 20 = 36) raises, and
        # the cleanup must also cancel the queued row 0
        bad = np.zeros((2, 16), np.int32)
        bad[0, :8] = np.arange(1, 9)
        bad[1, :] = np.arange(1, 17)
        stream = pipeline.create_stream("bad", grace_time=300)
        pipeline.create_frame(stream, {"tokens": bad})
        wait_for(lambda: getattr(lm, "_engine", None) is not None
                 and not lm._engine_frames and not lm._engine.has_work())
        [(_, _, outputs)] = running.serve(
            [np.arange(1, 9, dtype=np.int32)[None]], stream_id="ok",
            parameters={"max_new_tokens": 4})
        assert np.asarray(outputs["generated"]).shape == (1, 4)
    finally:
        running.close()


def test_new_frames_join_the_running_decode_loop():
    """A frame arriving while another decodes is admitted into the
    running loop: some engine step decodes both."""
    running = Running(PORT, {"continuous": True, "decode_slots": 4,
                             "kv_block_size": 8, "max_new_tokens": 120})
    try:
        lm, pipeline = running.lm, running.pipeline
        responses = queue.Queue()
        stream = pipeline.create_stream("s", queue_response=responses,
                                        grace_time=300)
        pipeline.create_frame(
            stream, {"tokens": np.arange(1, 8, dtype=np.int32)[None]})
        wait_for(lambda: lm.engine_stats() is not None
                 and lm.engine_stats()["admitted"] >= 1)
        engine, active = lm._engine, []
        step = engine.step

        def counted_step():
            report = step()
            active.append(report.active)
            return report

        engine.step = counted_step
        pipeline.create_frame(
            stream, {"tokens": np.arange(11, 18, dtype=np.int32)[None]})
        first, second = (responses.get(timeout=120) for _ in range(2))
        assert first[1].frame_id != second[1].frame_id
        assert max(active) == 2
    finally:
        running.close()


def test_engine_metrics_reach_the_telemetry_summary():
    running = Running(PORT, {"continuous": True, "decode_slots": 2,
                             "kv_block_size": 8})
    try:
        running.serve([np.random.default_rng(5).integers(
            1, 300, size=(2, 6)).astype(np.int32)])
        decode = running.pipeline.telemetry.summary()["decode"]
        assert decode["completed"] == 2
        assert decode["active_slots"] == 0 and decode["waiting"] == 0
        assert decode["free_blocks"] > 0
    finally:
        running.close()


# -- lint: the AIKO405 / AIKO411 verdicts of the JAX package ----------------

DECODE_SPECS = {
    "speculative_ok": {"continuous": True, "speculative": "draft=self;k=2"},
    "speculative_k0": {"continuous": True, "speculative": "draft=self;k=0"},
    "speculative_no_k": {"continuous": True, "speculative": "draft=self"},
    "speculative_unknown": {"continuous": True,
                            "speculative": "draft=self;k=2;warp=9"},
    "speculative_preset_layers": {"continuous": True,
                                  "speculative": "draft=toy;k=2;layers=1"},
    "features_without_engine": {"speculative": "draft=self;k=2",
                                "prefill_chunk_size": 16},
    "tiny_pool": {"continuous": True, "kv_blocks": 2, "kv_block_size": 4,
                  "max_new_tokens": 16},
    "tiny_context": {"continuous": True, "max_context": 8,
                     "max_new_tokens": 16},
    "prefix_ok": {"continuous": True,
                  "prefix_policy": "prefix_cache=on;cache_blocks=8"},
    "prefix_bad_value": {"continuous": True,
                         "prefix_policy": "prefix_cache=maybe"},
    "prefix_gateway_side": {"continuous": True,
                            "prefix_policy": "prefix_cache=on;"
                                             "affinity_weight=2"},
    "prefix_without_engine": {"prefix_policy": "prefix_cache=on"},
}


@pytest.mark.parametrize("case", sorted(DECODE_SPECS))
def test_decode_lint_reports_what_the_jax_grammar_reports(case):
    parameters = DECODE_SPECS[case]
    assert (policies.check_decode_parameters(parameters)
            == jax_policies.check_decode_parameters(parameters))


@pytest.mark.parametrize("spec", [
    "prefix_cache=on", "prefix_cache=on;min_prefix_blocks=2",
    "prefix_cache=maybe", "prefix_cache=on;warmth=high",
    "prefix_cache=on;affinity_weight=2", "prefix_cache=on;cache_blocks=0"])
@pytest.mark.parametrize("element", [True, False],
                         ids=["engine", "gateway"])
def test_prefix_policy_lint_reports_what_the_jax_grammar_reports(spec,
                                                                 element):
    assert (policies.check_prefix_policy(spec, element=element)
            == jax_policies.check_prefix_policy(spec, element=element))


def test_malformed_speculative_spec_fails_construction():
    with pytest.raises(DefinitionError, match="AIKO405"):
        torch_pipeline.create_pipeline(
            torch_runtime.Process(transport_kind="loopback"),
            definition(PORT, {"continuous": True,
                              "speculative": "draft=self;k=oops"}))


# -- still refused ------------------------------------------------------------

REFUSED = {
    "role": {"continuous": True, "role": "decode"},
    "checkpoint": {"continuous": True,
                   "checkpoint": "checkpoint_every=1;keeper=K"},
    "prefix_keeper": {"continuous": True, "prefix_keeper": "K"},
}


@pytest.mark.parametrize("option", sorted(REFUSED))
def test_unported_options_still_raise(option):
    """Past lint (`validate: false`), the element itself refuses."""
    with pytest.raises(NotImplementedError, match="not yet ported"):
        torch_pipeline.create_pipeline(
            torch_runtime.Process(transport_kind="loopback"),
            definition(PORT, REFUSED[option], validate=False))


def test_checkpoint_is_refused_by_lint():
    with pytest.raises(DefinitionError, match="AIKO409"):
        torch_pipeline.create_pipeline(
            torch_runtime.Process(transport_kind="loopback"),
            definition(PORT, REFUSED["checkpoint"]))


@pytest.mark.parametrize("port", ["handoff", "restore"])
def test_handoff_and_restore_inputs_raise(port):
    process = torch_runtime.Process(transport_kind="loopback")
    pipeline = torch_pipeline.create_pipeline(
        process, definition(PORT, {"continuous": True}))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        pipeline.elements["lm"].process_frame(
            None, tokens=None, **{port: {"prompt": [1, 2]}})
