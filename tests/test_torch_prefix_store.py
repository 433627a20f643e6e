# The cross-replica prefix store and prefix-affinity routing in the port
# on the CPU: DecodeEngine.export_prefix_snapshot / adopt_prefix
# (decode/engine.py), LMGenerate's `prefix_keeper` pre-warm and export,
# the `prefix_heads` share it publishes, and the gateway's `prefix`
# policy -- held against the JAX package on the same weights (its random
# parameters through numpy into the port) and prompts.  Chain digests
# and snapshot metadata are identical to the JAX package's (the gateway
# routes on the digests across replicas of either package); prefix KV
# blocks agree within tests/test_torch_disagg.py's tolerance; warm
# tokens equal cold tokens everywhere.

import queue

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu import decode as jax_decode
from aiko_services_tpu import serve as jax_serve
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu.runtime import Process as JaxProcess
from aiko_services_tpu.serve.gateway import _Replica as JaxReplica
from aiko_services_tpu_torch.decode import (
    CheckpointKeeper, DecodeEngine, fetch_kv_blocks, prefix_head,
    reset_keepers)
from aiko_services_tpu_torch.models import params_from_numpy
from aiko_services_tpu_torch.models import transformer as torch_lm
from aiko_services_tpu_torch.pipeline import create_pipeline
from aiko_services_tpu_torch.pipeline.transfer import reset_transfer_server
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.serve import Gateway
from aiko_services_tpu_torch.serve.gateway import _Replica
from aiko_services_tpu_torch.transport import reset_brokers

TINY = dict(vocab_size=64, n_layers=2, n_heads=2, n_kv_heads=2,
            d_model=32, d_ff=64, max_seq_len=64, dtype="float32")
POLICY = "prefix_cache=on;min_prefix_blocks=1"


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean():
    reset_brokers()
    reset_keepers()
    jax_decode.reset_keepers()
    yield
    reset_brokers()
    reset_keepers()
    jax_decode.reset_keepers()


@pytest.fixture(scope="module")
def models():
    jax_config = jax_lm.TransformerConfig(**TINY)
    jax_params = jax_lm.init_params(jax_config, jax.random.PRNGKey(0))
    numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    return (jax_params, jax_config,
            params_from_numpy(numpy_params, device="cpu"),
            torch_lm.TransformerConfig(**TINY))


def drain(engine, done=None):
    done = {} if done is None else done
    steps = 0
    while engine.has_work():
        for completion in engine.step().completions:
            done[completion.request_id] = completion
        steps += 1
        assert steps < 4000
    return done


def served(engine, prompts, max_new=6):
    for index, prompt in enumerate(prompts):
        engine.submit(index, prompt, max_new)
    return drain(engine)


def test_exported_prefix_warms_another_replica_like_the_jax_package(
        models):
    """Replica A serves a prompt and exports its cached prefix through
    the keeper; replica B adopts it into its cached tier and serves a
    prompt sharing that prefix from the borrowed blocks: warm tokens
    equal cold ones, and the snapshot, the heads and the blocks equal the
    JAX package's."""
    jax_params, jax_config, params, config = models
    rng = np.random.default_rng(3)
    preamble = rng.integers(1, 64, size=26).astype(np.int32)
    first = np.concatenate([preamble, [5, 6]]).astype(np.int32)
    second = np.concatenate([preamble, [9, 7, 3]]).astype(np.int32)

    replica_a = DecodeEngine(params, config, decode_slots=2,
                             kv_block_size=8, prefix_policy=POLICY)
    jax_a = jax_decode.DecodeEngine(jax_params, jax_config,
                                    decode_slots=2, kv_block_size=8,
                                    prefix_policy=POLICY)
    served(replica_a, [first])
    jax_a.submit(0, first, 6)
    while jax_a.has_work():
        jax_a.step()
    assert replica_a.prefix_heads() == jax_a.prefix_heads()
    assert replica_a.prefix_heads() == [prefix_head(first, 8)]

    snapshot = replica_a.export_prefix_snapshot(first)
    jax_snapshot = jax_a.export_prefix_snapshot(first)
    strip = ("kv_blocks",)
    assert ({k: v for k, v in snapshot.items() if k not in strip}
            == {k: v for k, v in jax_snapshot.items() if k not in strip})
    assert snapshot["blocks_total"] == 3      # 28 tokens: 3 full blocks
    leaves = fetch_kv_blocks(snapshot)
    for name, expected in jax_decode.fetch_kv_blocks(jax_snapshot).items():
        np.testing.assert_allclose(leaves[name].numpy(),
                                   np.asarray(expected), atol=1e-5, rtol=0)

    keeper = CheckpointKeeper("prefix_k")
    keeper.store(snapshot)
    assert keeper.flush()
    record = keeper.restore(tuple(snapshot["request_id"]))
    replica_b = DecodeEngine(params, config, decode_slots=2,
                             kv_block_size=8, prefix_policy=POLICY)
    assert replica_b.adopt_prefix(record, timeout=5) == 3
    assert replica_b.adopt_prefix(record, timeout=5) == 0   # resident
    assert replica_b.prefix.cached_count == 3
    warm = served(replica_b, [second])[0]
    assert replica_b.counters["prefix_hits"] == 1
    assert replica_b.counters["prefix_blocks_shared"] == 3
    cold = served(DecodeEngine(params, config, decode_slots=2,
                               kv_block_size=8), [second])[0]
    np.testing.assert_array_equal(warm.tokens, cold.tokens)
    reference, _ = torch_lm.generate(params, config,
                                     torch.from_numpy(second)[None], 6)
    np.testing.assert_array_equal(warm.tokens, reference[0].numpy())


def test_adopt_prefix_is_best_effort(models):
    """A disarmed cache, a block-size mismatch or a record whose blocks
    are gone all register nothing and leave the pool as it was."""
    _, _, params, config = models
    prompt = np.arange(1, 27, dtype=np.int32)
    replica_a = DecodeEngine(params, config, decode_slots=1,
                             kv_block_size=8, prefix_policy=POLICY)
    served(replica_a, [prompt])
    snapshot = replica_a.export_prefix_snapshot(prompt)
    assert DecodeEngine(params, config, decode_slots=1,
                        kv_block_size=8).export_prefix_snapshot(
        prompt) is None
    assert DecodeEngine(params, config, decode_slots=1,
                        kv_block_size=8).adopt_prefix(snapshot) == 0
    other = DecodeEngine(params, config, decode_slots=1, kv_block_size=16,
                         prefix_policy=POLICY)
    assert other.adopt_prefix(snapshot) == 0
    reset_transfer_server()
    fresh = DecodeEngine(params, config, decode_slots=1, kv_block_size=8,
                         prefix_policy=POLICY)
    free_before = fresh.blocks.free_count
    assert fresh.adopt_prefix(snapshot, timeout=1) == 0
    assert fresh.blocks.free_count == free_before


# -- the gateway's affinity placement: the JAX package's choices -------------

HEAD = "a" * 32


@pytest.mark.parametrize("case", ["warm_wins", "hot_loses", "saturated",
                                  "no_hint"])
def test_affinity_placement_equals_the_jax_gateways(case):
    """The same pool (mirrored loads and heads) behind both packages'
    gateways with the same router seed: the same replica wins, and the
    same hit/miss counters move."""
    loads = {"warm_wins": (1, 0, 0), "hot_loses": (6, 0, 0),
             "saturated": (0, 0, 0), "no_hint": (1, 0, 0)}[case]
    hint = None if case == "no_hint" else HEAD
    chosen = []
    for process_class, gateway_class, replica_class in (
            (JaxProcess, jax_serve.Gateway, JaxReplica),
            (Process, Gateway, _Replica)):
        gateway = gateway_class(process_class(transport_kind="loopback"),
                                policy="max_inflight=8;queue=32",
                                router_seed=5,
                                prefix="prefix_cache=on;affinity_weight=2")
        for index, load in enumerate(loads):
            replica = replica_class(
                f"pool/r{index}", f"r{index}",
                cache={"inflight": load,
                       "prefix_heads": HEAD if index == 0 else ""})
            if case == "saturated" and index == 0:
                replica.outstanding = gateway.policy.max_inflight
            gateway.replicas[replica.topic_path] = replica
        picks = [gateway._place(0.0, prefix_hint=hint).name
                 for _ in range(4)]
        chosen.append((picks, gateway.telemetry.affinity_hits.value,
                       gateway.telemetry.affinity_misses.value))
    assert chosen[0] == chosen[1]


# -- through the element: the keeper store behind a gateway -------------------

LM_PARAMS = {"vocab_size": 300, "d_model": 32, "n_layers": 1,
             "n_heads": 2, "n_kv_heads": 1, "d_ff": 64,
             "max_seq_len": 128, "dtype": "float32", "max_new_tokens": 5,
             "continuous": True, "decode_slots": 2, "kv_block_size": 8}


def lm_definition(name, prefix=True):
    extra = {"prefix_policy": POLICY} if prefix else {}
    return {
        "name": name,
        "graph": ["(lm)"],
        "parameters": {"device": "cpu"},
        "elements": [
            {"name": "lm", "input": [{"name": "tokens"}],
             "output": [{"name": "generated"}],
             "parameters": {**LM_PARAMS, **extra},
             "deploy": {"local": {
                 "module": "aiko_services_tpu_torch.elements",
                 "class_name": "LMGenerate"}}}],
    }


def test_affinity_routing_and_the_keeper_prewarm_through_the_element():
    """Two prefix-cached replicas behind a gateway whose prefix and
    checkpoint policies turn the keeper into a prefix store: a stream
    hinting a cached head routes to its holder; a replica that never saw
    the prefix pre-warms it from the keeper; every answer equals the
    cold replica's."""
    rng = np.random.default_rng(8)
    preamble = rng.integers(1, 300, size=33).astype(np.int32)
    prompts = [np.concatenate([preamble, rng.integers(1, 300, size=3)])
               .astype(np.int32)[None] for _ in range(3)]
    head = prefix_head(prompts[0][0], 8)
    CheckpointKeeper("store_k")
    processes = [Process(transport_kind="loopback") for _ in range(4)]
    replicas = [create_pipeline(processes[index],
                                lm_definition(f"px{index}"))
                for index in range(2)]
    cold = create_pipeline(processes[2], lm_definition("cold",
                                                       prefix=False))
    gateway = Gateway(processes[3], policy="max_inflight=8;queue=32",
                      router_seed=2,
                      prefix="prefix_cache=on;affinity_weight=4",
                      checkpoint="keeper=store_k")
    for replica in replicas:
        gateway.attach_replica(replica)
    for process in processes:
        process.run(in_thread=True)
    try:
        def through_gateway(stream_id, tokens):
            replies = queue.Queue()
            gateway.submit_stream(stream_id, {"prefix_hint": head},
                                  queue_response=replies, grace_time=300)
            gateway.submit_frame(stream_id, {"tokens": tokens}, frame_id=0)
            _, _, outputs, status = replies.get(timeout=120)
            assert status == "ok", outputs
            return (np.asarray(outputs["generated"]),
                    gateway.streams[stream_id].replica.name)

        def direct(pipeline, stream_id, tokens, parameters=None):
            replies = queue.Queue()
            stream = pipeline.create_stream(
                stream_id, queue_response=replies, grace_time=300,
                parameters=parameters or {})
            pipeline.create_frame(stream, {"tokens": tokens})
            return np.asarray(replies.get(timeout=120)[2]["generated"])

        first, holder = through_gateway("g0", prompts[0])
        holder_pipe = next(pipe for pipe in replicas if pipe.name == holder)
        other = next(pipe for pipe in replicas if pipe.name != holder)
        assert head in holder_pipe.share.get("prefix_heads", "").split(",")
        second, placed = through_gateway("g1", prompts[1])
        assert placed == holder
        assert gateway.telemetry.affinity_hits.value == 2 - int(
            gateway.telemetry.affinity_misses.value)
        assert gateway.telemetry.affinity_hits.value >= 1
        assert holder_pipe.elements["lm"].engine_stats()["prefix_hits"] >= 1
        # the replica that never served the prefix pre-warms from the keeper
        third = direct(other, "warm", prompts[2],
                       {"prefix_keeper": "store_k"})
        warmed = other.elements["lm"].engine_stats()
        assert warmed["prefix_hits"] == 1
        assert warmed["prefix_blocks_shared"] == 4
        for index, (tokens, got) in enumerate(zip(prompts,
                                                  (first, second, third))):
            np.testing.assert_array_equal(
                got, direct(cold, f"cold{index}", tokens))
    finally:
        for process in processes:
            process.terminate()
