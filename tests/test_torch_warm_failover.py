# Warm KV failover in the port on the CPU (aiko_services_tpu_torch/
# decode/checkpoint.py, DecodeEngine.restore_request, LMGenerate
# `checkpoint` and the `restore` input, the gateway's restore hints and
# recovery pacing), held against the JAX package on the same weights
# (its random parameters through numpy into the port) and the same numpy
# prompts.
#
# The snapshots a checkpointer ships (cursor, tokens, delta ranges,
# sequence numbers) equal the JAX package's, and their KV blocks agree
# within the tolerance of tests/test_torch_disagg.py (f32 atol 1e-5, int8
# codes exact, scales rtol 1e-6 or atol 1e-5 / 127).  Tokens are
# identical: a restored stream equals the uncrashed one, the closed
# batch and the JAX package's restore.  A failover run kills its replica
# through the seeded fault plan's replica_kill point and waits on events
# with deadlines, never on a fixed sleep.

import queue
import threading

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu import decode as jax_decode
from aiko_services_tpu.analyze import policies as jax_policies
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu_torch import decode as torch_decode
from aiko_services_tpu_torch import faults as faults_module
from aiko_services_tpu_torch.analyze import policies
from aiko_services_tpu_torch.decode import (
    CheckpointKeeper, CheckpointPolicy, DecodeEngine, fetch_kv_blocks,
    reset_keepers)
from aiko_services_tpu_torch.decode import disagg as torch_disagg
from aiko_services_tpu_torch.models import params_from_numpy
from aiko_services_tpu_torch.models import transformer as torch_lm
from aiko_services_tpu_torch.pipeline import create_pipeline
from aiko_services_tpu_torch.pipeline.transfer import (
    reset_circuits, reset_transfer_server)
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.serve import Gateway
from aiko_services_tpu_torch.transport import reset_brokers

TINY = dict(vocab_size=64, n_layers=2, n_heads=2, n_kv_heads=2,
            d_model=32, d_ff=64, max_seq_len=64, dtype="float32")
ELEMENTS = "aiko_services_tpu_torch.elements"


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean():
    for reset in (reset_brokers, reset_keepers, reset_circuits,
                  faults_module.reset_injector, jax_decode.reset_keepers):
        reset()
    yield
    for reset in (reset_brokers, reset_keepers, reset_circuits,
                  faults_module.reset_injector, jax_decode.reset_keepers):
        reset()


def _models(kv_dtype: str = "", seed: int = 0):
    """(jax params, jax config, port params, port config) on the CPU."""
    jax_config = jax_lm.TransformerConfig(**TINY, kv_dtype=kv_dtype)
    jax_params = jax_lm.init_params(jax_config, jax.random.PRNGKey(seed))
    numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    return (jax_params, jax_config,
            params_from_numpy(numpy_params, device="cpu"),
            torch_lm.TransformerConfig(**TINY, kv_dtype=kv_dtype))


@pytest.fixture(scope="module")
def tiny():
    return _models()


def reference(params, config, prompt, max_new):
    out, _ = torch_lm.generate(params, config,
                               torch.from_numpy(np.asarray(prompt))[None],
                               max_new)
    return out[0].numpy()


def drain(engine, done=None, emitted=None, limit=4000):
    done = {} if done is None else done
    steps = 0
    while engine.has_work():
        report = engine.step()
        if emitted is not None:
            emitted.extend((offset, token) for _rid, offset, token
                           in report.emitted)
        for completion in report.completions:
            done[completion.request_id] = completion
        steps += 1
        assert steps < limit
    return done


def checkpointed(package, params, config, prompts, max_new, spec, steps,
                 keeper_name="k1"):
    """Run `prompts` on a checkpointed engine of `package` for `steps`
    ticks: (engine, checkpointer, keeper, shipped snapshot metadata,
    emitted (request, offset, token))."""
    keeper = package.CheckpointKeeper(keeper_name)
    shipped = []
    store = keeper.store

    def spy(snapshot):
        shipped.append({key: value for key, value in snapshot.items()
                        if key != "kv_blocks"}
                       | {"blocks": len(snapshot["kv_blocks"])})
        store(snapshot)

    keeper.store = spy
    engine = package.DecodeEngine(params, config, decode_slots=3,
                                  kv_block_size=8)
    checkpointer = package.DecodeCheckpointer(
        engine, package.CheckpointPolicy.parse(spec), keeper=keeper)
    for index, prompt in enumerate(prompts):
        engine.submit(f"r{index}", prompt, max_new)
    emitted = []
    for _ in range(steps):
        emitted.extend(engine.step().emitted)
        checkpointer.tick()
    assert keeper.flush()
    return engine, checkpointer, keeper, shipped, emitted


# -- the checkpointer against the JAX package --------------------------------

SPEC = "checkpoint_every=2;max_checkpoint_lag=3;keeper=k1"


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32", "int8"])
def test_snapshots_and_restores_match_the_jax_package(kv_dtype):
    """Three requests through both packages' checkpointed engines: the
    same snapshots in the same order (delta ranges, cursors, tokens,
    sequence numbers), the keepers' merged blocks within tolerance, and
    restores on fresh engines finish with the uncrashed tokens -- the
    closed batch's and the JAX package's."""
    jax_params, jax_config, params, config = _models(kv_dtype)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 64, size=n).astype(np.int32)
               for n in (11, 6, 17)]
    max_new = 14
    _, _, jax_keeper, jax_shipped, _ = checkpointed(
        jax_decode, jax_params, jax_config, prompts, max_new, SPEC, 7)
    _, checkpointer, keeper, shipped, emitted = checkpointed(
        torch_decode, params, config, prompts, max_new, SPEC, 7)
    assert shipped == jax_shipped
    assert checkpointer.counters["checkpoints"] == len(shipped) > 3
    assert 0 < len(emitted) < 3 * max_new, "the crash must be mid-decode"
    for index, prompt in enumerate(prompts):
        record = keeper.restore(f"r{index}")
        jax_record = jax_keeper.restore(f"r{index}")
        leaves = fetch_kv_blocks(record)
        for name, expected in jax_decode.fetch_kv_blocks(
                jax_record).items():
            expected, actual = np.asarray(expected), leaves[name].numpy()
            if actual.dtype == np.int8:
                np.testing.assert_array_equal(actual, expected)
            elif name.endswith("_scale"):
                np.testing.assert_allclose(actual, expected, rtol=1e-6,
                                           atol=1e-5 / 127)
            else:
                np.testing.assert_allclose(actual, expected, atol=1e-5,
                                           rtol=0)
        survivor = DecodeEngine(params, config, decode_slots=1,
                                kv_block_size=8)
        jax_survivor = jax_decode.DecodeEngine(jax_params, jax_config,
                                               decode_slots=1,
                                               kv_block_size=8)
        done = drain(survivor, {c.request_id: c for c in
                                survivor.restore_request(
                                    "r", record).completions})
        jax_done = {c.request_id: c for c in jax_survivor.restore_request(
            "r", jax_record).completions}
        while jax_survivor.has_work():
            for completion in jax_survivor.step().completions:
                jax_done[completion.request_id] = completion
        np.testing.assert_array_equal(
            done["r"].tokens, reference(params, config, prompt, max_new))
        np.testing.assert_array_equal(done["r"].tokens,
                                      np.asarray(jax_done["r"].tokens))
        assert survivor.counters["restores"] == 1
        assert survivor.counters["restore_fallbacks"] == 0
        assert survivor.stats()["free_blocks"] == survivor.blocks.capacity


def test_a_tick_gathers_every_due_slot_at_once(tiny, monkeypatch):
    """Every due slot's delta blocks leave the pool in ONE gather per
    tick (one index_select and one host copy per leaf), however many
    slots are due."""
    _, _, params, config = tiny
    gathers = []
    gather = torch_disagg.gather_pool_blocks

    def counted(pool, block_ids):
        gathers.append(len(block_ids))
        return gather(pool, block_ids)

    monkeypatch.setattr(torch_disagg, "gather_pool_blocks", counted)
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (5, 9, 12)]
    _, checkpointer, _, shipped, _ = checkpointed(
        torch_decode, params, config, prompts, 6,
        "checkpoint_every=1;keeper=k1", 4)
    # tick 1 follows the prefills (no slot is due yet); ticks 2-4 ship
    # all three slots, each tick through one gather
    assert checkpointer.ticks == 4
    assert len(shipped) == 3 * 3 and len(gathers) == 3
    assert all(count >= 3 for count in gathers)
    assert checkpointer.stats()["checkpoint_s"] > 0


def test_a_refused_offer_degrades_and_a_device_fault_raises(
        tiny, monkeypatch):
    """When the transfer plane refuses a tick's offers, every due slot
    keeps the keeper's previous snapshot and counts a checkpoint error,
    and the next tick ships them all again (the keeper ends complete);
    an error in the gather (a fault on the device) raises out of tick()
    instead of becoming a count."""
    from aiko_services_tpu_torch.pipeline.transfer import TransferError
    _, _, params, config = tiny
    offer = torch_disagg.offer_blocks
    calls = []

    def refused_once(host):
        calls.append(len(calls))
        if len(calls) == 2:     # the second shipping tick
            raise TransferError("offer refused")
        return offer(host)

    monkeypatch.setattr(torch_disagg, "offer_blocks", refused_once)
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (5, 9, 12)]
    engine, checkpointer, keeper, shipped, _ = checkpointed(
        torch_decode, params, config, prompts, 12,
        "checkpoint_every=1;keeper=k1", 4)
    # ticks 2 and 4 ship all three slots, tick 3's offers are refused
    assert [snapshot["request_id"] for snapshot in shipped] == \
        ["r0", "r1", "r2"] * 2
    assert [snapshot["seq"] for snapshot in shipped] == [0] * 3 + [1] * 3
    assert checkpointer.stats()["checkpoint_errors"] == 3
    assert keeper.kept_count() == 3 and keeper.stats()["store_errors"] == 0
    for index in range(3):
        record = keeper.restore(f"r{index}")
        assert record["position"] == int(engine.positions[index])

    def device_fault(pool, block_ids):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(torch_disagg, "gather_pool_blocks", device_fault)
    engine.step()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        checkpointer.tick()
    assert checkpointer.stats()["checkpoint_errors"] == 3


def test_resume_from_is_gapless_and_counts_replayed(tiny):
    """A client holding offsets [0, crash) passes resume_from: the tokens
    between the snapshot and the crash re-decode silently and emission
    resumes exactly at the crash offset."""
    _, _, params, config = tiny
    prompt = np.arange(1, 8, dtype=np.int32)
    max_new = 12
    engine, _, keeper, _, emitted = checkpointed(
        torch_decode, params, config, [prompt], max_new,
        "checkpoint_every=2;max_checkpoint_lag=32;keeper=k1", 3)
    for _ in range(4):          # post-snapshot progress, never shipped
        emitted.extend(engine.step().emitted)
    crash = len(emitted)
    record = keeper.restore("r0")
    assert len(record["generated"]) < crash
    survivor = DecodeEngine(params, config, decode_slots=1, kv_block_size=8)
    report = survivor.restore_request("r0", record, resume_from=crash)
    resumed = [(offset, token) for _rid, offset, token in report.emitted]
    drain(survivor, emitted=resumed)
    assert (survivor.counters["restore_replayed_tokens"]
            == crash - len(record["generated"]))
    assert sorted(dict(resumed))[0] == crash
    combined = {offset: token for _rid, offset, token in emitted}
    combined.update(dict(resumed))
    assert sorted(combined) == list(range(max_new))
    np.testing.assert_array_equal(
        np.asarray([combined[i] for i in range(max_new)]),
        reference(params, config, prompt, max_new))


def test_degraded_restores_fall_back_to_reprefill(tiny):
    """No record, a block-size mismatch and expired transfer keys all
    degrade to the replay re-prefill: the request completes with the
    closed batch's tokens and the granted blocks go back first."""
    _, _, params, config = tiny
    prompt = np.arange(1, 10, dtype=np.int32)
    max_new = 6
    expected = reference(params, config, prompt, max_new)

    def restored(engine, record, **kwargs):
        free_before = engine.blocks.free_count
        report = engine.restore_request("r0", record, prompt_tokens=prompt,
                                        max_new_tokens=max_new, **kwargs)
        assert engine.counters["restore_fallbacks"] == 1
        assert engine.counters["restores"] == 0
        assert engine.blocks.free_count == free_before
        done = drain(engine, {c.request_id: c
                              for c in report.completions})
        np.testing.assert_array_equal(done["r0"].tokens, expected)

    restored(DecodeEngine(params, config, decode_slots=1, kv_block_size=8),
             None)
    _, _, keeper, _, _ = checkpointed(
        torch_decode, params, config, [prompt], max_new,
        "checkpoint_every=1;keeper=k2", 3, keeper_name="k2")
    record = keeper.restore("r0")
    restored(DecodeEngine(params, config, decode_slots=1,
                          kv_block_size=16), record)
    reset_transfer_server()
    restored(DecodeEngine(params, config, decode_slots=1, kv_block_size=8),
             record, timeout=1)
    with pytest.raises(KeyError):
        CheckpointKeeper("k_empty").restore("missing")


# -- AIKO409: the JAX package's verdicts ------------------------------------

CHECKPOINT_SPECS = ["checkpoint_every=4;max_checkpoint_lag=8;keeper=k",
                    "recovery_rate=2.5;keeper=k", "recovery_rate=-1",
                    "checkpoint_every=0", "warp=9", "recovery_rate=1",
                    "checkpoint_every=4", "keeper=k", ""]


@pytest.mark.parametrize("spec", CHECKPOINT_SPECS)
@pytest.mark.parametrize("element", [True, False],
                         ids=["engine", "gateway"])
def test_checkpoint_lint_reports_what_the_jax_grammar_reports(spec,
                                                              element):
    assert (policies.check_checkpoint_policy(spec, element=element)
            == jax_policies.check_checkpoint_policy(spec, element=element))


@pytest.mark.parametrize("parameters", [
    {"checkpoint": "checkpoint_every=2"},
    {"checkpoint": "checkpoint_every=2", "continuous": True},
    {"checkpoint": "checkpoint_every=2", "role": "prefill"},
    {"checkpoint": "recovery_rate=2", "continuous": True}],
    ids=["without_engine", "ok", "prefill_role", "gateway_side"])
def test_checkpoint_parameters_lint_like_the_jax_package(parameters):
    assert (policies.check_decode_parameters(parameters)
            == jax_policies.check_decode_parameters(parameters))


def test_gateway_checkpoint_construction_matches_lint():
    process = Process(transport_kind="loopback")
    with pytest.raises(ValueError, match="AIKO409"):
        Gateway(process, name="bad", checkpoint="recovery_rate=-1")
    with pytest.raises(ValueError, match="AIKO404"):
        Gateway(process, name="bad2", checkpoint="warp=9")
    with pytest.raises(ValueError, match="AIKO409"):
        Gateway(process, name="bad3", checkpoint="checkpoint_every=4")
    assert CheckpointPolicy.parse("recovery_rate=2;keeper=k").keeper == "k"


# -- the gateway: a replica killed mid-decode --------------------------------

LM_PARAMS = {"vocab_size": 300, "d_model": 32, "n_layers": 1,
             "n_heads": 2, "n_kv_heads": 1, "d_ff": 64,
             "max_seq_len": 128, "dtype": "float32"}
STREAMS = 4
MAX_NEW = 24


def lm_definition(name):
    return {
        "name": name,
        "graph": ["(lm)"],
        "parameters": {"device": "cpu"},
        "elements": [
            {"name": "lm",
             "input": [{"name": "tokens"},
                       {"name": "restore", "optional": True}],
             "output": [{"name": "generated"}],
             "parameters": {
                 **LM_PARAMS, "continuous": True, "decode_slots": STREAMS,
                 "kv_block_size": 8, "max_new_tokens": MAX_NEW,
                 "checkpoint": ("checkpoint_every=1;"
                                "max_checkpoint_lag=4;keeper=gwk")},
             "deploy": {"local": {"module": ELEMENTS,
                                  "class_name": "LMGenerate"}}},
        ],
    }


def serve_with_failover(frames, kill: bool) -> dict:
    """Streams pinned to replica wf0; the uncrashed arm runs them to the
    end, the kill arm pauses wf0's engine once every stream has a
    snapshot and none has finished, consults the seeded plan's
    replica_kill point, crashes wf0 and fails its streams over to wf1."""
    keeper = CheckpointKeeper("gwk")
    processes = [Process(transport_kind="loopback") for _ in range(3)]
    victim = create_pipeline(processes[0], lm_definition("wf0"))
    survivor = create_pipeline(processes[1], lm_definition("wf1"))
    gateway = Gateway(processes[2], policy="max_inflight=16;queue=64",
                      checkpoint="recovery_rate=2;keeper=gwk")
    gateway.attach_replica(victim)
    paused, resume = threading.Event(), threading.Event()
    if kill:
        engine = victim.elements["lm"]._ensure_engine()
        step = engine.step

        def gated_step():
            if (not paused.is_set() and keeper.flush(timeout=5)
                    and keeper.kept_count() >= STREAMS):
                paused.set()
                resume.wait(timeout=120)
            return step()

        engine.step = gated_step
    for process in processes:
        process.run(in_thread=True)
    try:
        responses = queue.Queue()
        for index, frame in enumerate(frames):
            gateway.submit_stream(f"s{index}", {},
                                  queue_response=responses)
            gateway.submit_frame(f"s{index}", {"tokens": frame},
                                 frame_id=0)
        if kill:
            assert paused.wait(timeout=60)
            gateway.attach_replica(survivor)
            injector = faults_module.create_injector(
                "seed=13;replica_kill:node=wf0:frame=0")
            assert injector.replica_kill("wf0")
            victim.process.crash()
            gateway.post_message("_replica_lost", [
                victim.topic_path, "injected replica_kill"])
        got = {}
        while len(got) < len(frames):
            stream_id, _, outputs, status = responses.get(timeout=120)
            assert status == "ok", (stream_id, outputs)
            got[stream_id] = np.asarray(outputs["generated"])
        return {"outputs": got,
                "survivor": survivor.elements["lm"].engine_stats(),
                "victim": victim.elements["lm"].checkpoint_stats(),
                "paced": gateway.telemetry.recovery_paced.value}
    finally:
        resume.set()
        for process in processes:
            process.terminate()
        reset_keepers()
        reset_brokers()


def test_replica_killed_mid_decode_restores_the_uncrashed_tokens():
    """The warm-failover contract end to end: a decode replica killed
    mid-decode by the seeded plan; the gateway's paced failover replays
    every stream with a restore hint; the survivor resumes each from its
    checkpoint (no re-prefill) and every stream's tokens equal the
    uncrashed run's -- zero frames lost."""
    rng = np.random.default_rng(13)
    frames = [rng.integers(1, 300, size=(1, 6)).astype(np.int32)
              for _ in range(STREAMS)]
    uncrashed = serve_with_failover(frames, kill=False)
    killed = serve_with_failover(frames, kill=True)
    assert sorted(killed["outputs"]) == sorted(uncrashed["outputs"])
    for stream_id, tokens in uncrashed["outputs"].items():
        np.testing.assert_array_equal(killed["outputs"][stream_id], tokens)
    survivor = killed["survivor"]
    assert survivor["restores"] == STREAMS, survivor
    assert survivor["restore_fallbacks"] == 0, survivor
    assert killed["victim"]["checkpoints"] >= STREAMS
    assert killed["paced"] >= 1     # recovery_rate=2 over 4 streams
