# Prefill/decode disaggregation in the port on the CPU
# (aiko_services_tpu_torch/decode/disagg.py, DecodeEngine.adopt_request,
# LMGenerate `role: prefill` and the `handoff` input, the gateway's
# two-pool scheduling), held against the JAX package on the same weights
# (its random parameters through numpy into the port) and the same numpy
# prompts.
#
# Tolerances: the handoff's f32 K/V blocks agree with the JAX
# PrefillEngine's within atol 1e-5 (the pool-block tolerance of
# tests/test_torch_decode.py: K/V of order 1 out of two layers, the same
# products summed in another order; the largest difference here is
# 1.8e-6, so 1e-6 does not hold), its int8 codes exactly and its scales
# within rtol 1e-6 or atol 1e-5 / 127; the migration itself is exact
# (the adopting pool holds the exported bytes bit for bit), and tokens
# are identical everywhere: split == co-located == closed batch == the
# JAX package's split fleet.

import json
import queue

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu import decode as jax_decode
from aiko_services_tpu.analyze import policies as jax_policies
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu_torch.analyze import policies
from aiko_services_tpu_torch.decode import (
    DecodeEngine, PrefillEngine, fetch_kv_blocks)
from aiko_services_tpu_torch.models import params_from_numpy
from aiko_services_tpu_torch.models import transformer as torch_lm
from aiko_services_tpu_torch.pipeline import create_pipeline
from aiko_services_tpu_torch.pipeline.tensors import (
    decode_frame_data, encode_frame_data)
from aiko_services_tpu_torch.pipeline.transfer import reset_transfer_server
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
def clean_brokers():
    reset_brokers()
    yield
    reset_brokers()


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


def drain(engine, done=None, limit=4000):
    done = {} if done is None else done
    steps = 0
    while engine.has_work():
        for completion in engine.step().completions:
            done[completion.request_id] = completion
        steps += 1
        assert steps < limit
    return done


def prefill_all(engine, prompts, max_new):
    for index, prompt in enumerate(prompts):
        engine.submit(index, prompt, max_new)
    handoffs = []
    while engine.has_work():
        handoffs += engine.step()
    return handoffs


def run_split(params, config, prompts, max_new, prefill_kwargs=None,
              package=None):
    """Prefill every prompt on a PrefillEngine, adopt each handoff into a
    DecodeEngine and drain: (handoffs, completions, (prefill, decode))."""
    if package is None:
        prefill = PrefillEngine(params, config, kv_block_size=8,
                                device="cpu", **(prefill_kwargs or {}))
        decode = DecodeEngine(params, config, decode_slots=len(prompts),
                              kv_block_size=8)
    else:
        prefill = package.PrefillEngine(params, config, kv_block_size=8,
                                        **(prefill_kwargs or {}))
        decode = package.DecodeEngine(params, config,
                                      decode_slots=len(prompts),
                                      kv_block_size=8)
    handoffs = prefill_all(prefill, prompts, max_new)
    done = {}
    for handoff in handoffs:
        report = decode.adopt_request(handoff["request_id"], handoff,
                                      timeout=5)
        for completion in report.completions:
            done[completion.request_id] = completion
    drain(decode, done)
    return handoffs, done, (prefill, decode)


def _assert_blocks_agree(jax_leaves, torch_leaves):
    assert sorted(jax_leaves) == sorted(torch_leaves)
    for name, expected in jax_leaves.items():
        expected = np.asarray(expected)
        actual = torch_leaves[name].numpy()
        assert actual.shape == expected.shape, name
        if actual.dtype == np.int8:
            np.testing.assert_array_equal(actual, expected, err_msg=name)
        elif name.endswith("_scale"):
            np.testing.assert_allclose(actual, expected, rtol=1e-6,
                                       atol=1e-5 / 127, err_msg=name)
        else:
            np.testing.assert_allclose(actual, expected, atol=1e-5,
                                       rtol=0, err_msg=name)


# -- the handoff against the JAX package ------------------------------------

PROMPT_LENGTHS = (5, 9, 12)


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32", "int8"])
def test_handoff_blocks_and_tokens_match_the_jax_package(kv_dtype):
    """The same prompts through both packages' PrefillEngines: the same
    first tokens and handoff metadata, KV blocks within tolerance; the
    port's split fleet gives the closed batch's tokens and the JAX split
    fleet's, with every block returned on both sides."""
    jax_params, jax_config, params, config = _models(kv_dtype)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 64, size=n).astype(np.int32)
               for n in PROMPT_LENGTHS]
    jax_handoffs, jax_done, _ = run_split(jax_params, jax_config, prompts,
                                          8, package=jax_decode)
    handoffs, done, (prefill, decode) = run_split(params, config,
                                                  prompts, 8)
    for want, got in zip(jax_handoffs, handoffs):
        for key in ("schema", "request_id", "prompt", "max_new",
                    "true_len", "first_token", "block_size", "kv_dtype",
                    "kv_bytes"):
            assert got[key] == want[key], key
        _assert_blocks_agree(jax_decode.fetch_kv_blocks(want),
                             fetch_kv_blocks(got))
    for index, prompt in enumerate(prompts):
        np.testing.assert_array_equal(done[index].tokens,
                                      reference(params, config, prompt, 8))
        np.testing.assert_array_equal(done[index].tokens,
                                      np.asarray(jax_done[index].tokens))
    assert decode.counters["adopted"] == len(prompts)
    assert decode.counters["adopt_fallbacks"] == 0
    assert decode.counters["kv_migrated_bytes"] == sum(
        handoff["kv_bytes"] for handoff in handoffs)
    assert prefill.counters["exported"] == len(prompts)
    assert prefill.blocks.free_count == prefill.blocks.capacity
    assert decode.stats()["free_blocks"] == decode.blocks.capacity


def test_the_port_adopts_the_jax_packages_handoff(tiny):
    """The wire layout is the JAX package's: a port decode engine adopts
    a handoff the JAX PrefillEngine exported and decodes the closed
    batch's tokens."""
    jax_params, jax_config, params, config = tiny
    prompt = np.arange(3, 14, dtype=np.int32)
    jax_prefill = jax_decode.PrefillEngine(jax_params, jax_config,
                                           kv_block_size=8)
    [handoff] = prefill_all(jax_prefill, [prompt], 6)
    decode = DecodeEngine(params, config, decode_slots=1, kv_block_size=8)
    done = {c.request_id: c for c in decode.adopt_request(
        "r", json.loads(json.dumps(handoff)), timeout=5).completions}
    drain(decode, done)
    assert decode.counters["adopted"] == 1
    np.testing.assert_array_equal(done["r"].tokens,
                                  reference(params, config, prompt, 6))


def test_adopt_writes_the_pool_in_place_and_exactly(tiny):
    """The scatter writes into the pool tensors' own storage (the decode
    graphs captured on the card read those tensors), and the adopted
    blocks hold the exported bytes bit for bit."""
    _, _, params, config = _models("int8")
    prompt = np.arange(1, 20, dtype=np.int32)
    prefill = PrefillEngine(params, config, kv_block_size=8, device="cpu")
    [handoff] = prefill_all(prefill, [prompt], 4)
    decode = DecodeEngine(params, config, decode_slots=1, kv_block_size=8)
    pool = dict(decode.pool)
    pointers = {name: leaf.untyped_storage().data_ptr()
                for name, leaf in pool.items()}
    exported = fetch_kv_blocks(handoff)
    decode.adopt_request("r", handoff, timeout=5)
    assert decode.counters["adopted"] == 1
    blocks = decode.slots[0].blocks
    for name, leaf in decode.pool.items():
        assert leaf is pool[name], name
        assert leaf.untyped_storage().data_ptr() == pointers[name], name
        assert torch.equal(leaf[:, blocks], exported[name]), name


def test_chunked_prefill_export_matches(tiny):
    _, _, params, config = tiny
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 64, size=n).astype(np.int32)
               for n in (21, 33)]
    handoffs, done, (prefill, _) = run_split(
        params, config, prompts, 6,
        prefill_kwargs={"prefill_chunk_size": 8})
    assert prefill.counters["chunks"] > 0
    for index, prompt in enumerate(prompts):
        np.testing.assert_array_equal(done[index].tokens,
                                      reference(params, config, prompt, 6))


def test_handoff_survives_the_frame_codec_inert_and_json(tiny):
    """The frame codec carries the handoff's KV descriptors INERT (raw
    descriptor dicts, batch-fetched by the adopting engine), and a JSON
    round trip adopts identically."""
    _, _, params, config = tiny
    prompt = np.arange(1, 10, dtype=np.int32)
    prefill = PrefillEngine(params, config, kv_block_size=8, device="cpu")
    [handoff] = prefill_all(prefill, [prompt], 4)
    handoff = dict(handoff, request_id=0)
    wire = decode_frame_data(encode_frame_data({"handoff": [handoff]}))
    record = json.loads(json.dumps(wire["handoff"][0]))
    assert isinstance(record["kv_blocks"][0]["k"], dict)
    decode = DecodeEngine(params, config, decode_slots=1, kv_block_size=8)
    done = {c.request_id: c for c in decode.adopt_request(
        "r", record, timeout=5).completions}
    drain(decode, done)
    np.testing.assert_array_equal(done["r"].tokens,
                                  reference(params, config, prompt, 4))


def test_offers_sweep_expired_keys_at_a_bounded_rate(monkeypatch):
    """offer() sweeps the transfer store for expired keys at most every
    _OFFER_PURGE_INTERVAL seconds, not once per offer (a sweep scans
    every entry, and the checkpointer offers per block); an expired key
    that no sweep has reached yet is never served."""
    import time
    from aiko_services_tpu_torch.pipeline import transfer
    server = transfer.TensorTransferServer(host="127.0.0.1", ttl=0.0)
    try:
        sweeps = []
        purge = server._purge
        monkeypatch.setattr(server, "_purge",
                            lambda: (sweeps.append(1), purge()))
        server._purged_at = time.monotonic() + 60.0   # swept just now
        descriptors = [server.offer(np.zeros(4, np.float32))
                       for _ in range(50)]
        assert not sweeps and len(server._store) == 50
        with pytest.raises(KeyError):
            transfer.fetch(descriptors[0], timeout=5.0, retries=0)
        server._purged_at -= 60.0 + transfer._OFFER_PURGE_INTERVAL
        server.offer(np.zeros(4, np.float32))
        assert len(sweeps) == 1 and len(server._store) <= 1
    finally:
        server.close()


def test_adopt_mid_storm_adds_no_signature(tiny):
    """Requests adopted INTO A BUSY engine mid-storm: co-scheduled slots
    keep decoding, outputs equal the closed batch's, and adoption adds no
    step signature (the pool scatter is no engine step)."""
    _, _, params, config = tiny
    rng = np.random.default_rng(42)
    engine = DecodeEngine(params, config, decode_slots=3, kv_block_size=8)
    for index, length in enumerate((3, 9, 17)):
        engine.submit(("warm", index),
                      np.arange(1, length + 1, dtype=np.int32), 3)
    drain(engine)
    prefill = PrefillEngine(params, config, kv_block_size=8, device="cpu")
    [warm] = prefill_all(prefill, [np.arange(1, 6, dtype=np.int32)], 2)
    engine.adopt_request("warm_adopt", warm, timeout=5)
    drain(engine)
    before = engine.compile_count
    workload, done, adopted = {}, {}, 0
    for submitted in range(12):
        prompt = rng.integers(1, 64, size=int(rng.integers(1, 21))) \
            .astype(np.int32)
        max_new = int(rng.integers(2, 8))
        workload[submitted] = (prompt, max_new)
        if submitted % 3 == 0:
            prefill.submit(submitted, prompt, max_new)
            while prefill.has_work():
                for handoff in prefill.step():
                    report = engine.adopt_request(
                        handoff["request_id"], handoff, timeout=5)
                    adopted += 1
                    for completion in report.completions:
                        done[completion.request_id] = completion
        else:
            engine.submit(submitted, prompt, max_new)
        for _ in range(int(rng.integers(1, 4))):
            for completion in engine.step().completions:
                done[completion.request_id] = completion
    drain(engine, done)
    assert adopted == 4 and engine.counters["adopted"] == 5
    for index, (prompt, max_new) in workload.items():
        np.testing.assert_array_equal(
            done[index].tokens, reference(params, config, prompt, max_new))
    assert engine.compile_count == before


def test_adopt_failures_fall_back_to_local_prefill(tiny):
    """Expired transfer keys, a block-size mismatch and a pool of another
    geometry all fall back to a LOCAL re-prefill through the ordinary
    admission path: the request still completes with the closed batch's
    tokens, and the granted blocks go back first."""
    _, _, params, config = tiny
    prompt = np.arange(1, 10, dtype=np.int32)
    expected = reference(params, config, prompt, 5)
    prefill = PrefillEngine(params, config, kv_block_size=8, device="cpu")
    [expired] = prefill_all(prefill, [prompt], 5)
    reset_transfer_server()
    decode = DecodeEngine(params, config, decode_slots=1, kv_block_size=8)
    free_before = decode.blocks.free_count
    decode.adopt_request("r", expired, timeout=1)
    assert decode.counters["adopt_fallbacks"] == 1
    assert decode.counters["adopted"] == 0
    assert decode.blocks.free_count == free_before
    np.testing.assert_array_equal(drain(decode)["r"].tokens, expected)

    [handoff] = prefill_all(prefill, [prompt], 5)
    other = DecodeEngine(params, config, decode_slots=1, kv_block_size=16)
    other.adopt_request("r2", handoff, timeout=1)
    assert other.counters["adopt_fallbacks"] == 1
    np.testing.assert_array_equal(drain(other)["r2"].tokens, expected)

    [handoff] = prefill_all(prefill, [prompt], 5)
    wider = torch_lm.TransformerConfig(**dict(TINY, n_kv_heads=1))
    mismatch = DecodeEngine(
        torch_lm.init_params(wider, torch.Generator().manual_seed(0),
                             device="cpu"),
        wider, decode_slots=1, kv_block_size=8)
    free_before = mismatch.blocks.free_count
    mismatch.adopt_request("r3", handoff, timeout=1)
    assert mismatch.counters["adopt_fallbacks"] == 1
    assert mismatch.blocks.free_count == free_before
    assert "r3" in drain(mismatch)


def test_prefill_engine_defaults_to_cuda(tiny):
    _, _, params, config = tiny
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrefillEngine(params, config)
    assert not torch.cuda.is_available()


# -- AIKO408: the JAX package's verdicts ------------------------------------

DISAGG_SPECS = ["adopt_timeout=2;min_replicas:prefill=1;"
                "min_replicas:decode=2", "role=prefill", "role=decode",
                "role=gpu", "role=prefill;adopt_timeout=2",
                "adopt_timeout=-1", "min_replicas:gpu=1", "warp=9", ""]


@pytest.mark.parametrize("spec", DISAGG_SPECS)
def test_disagg_lint_reports_what_the_jax_grammar_reports(spec):
    assert (policies.check_disagg_policy(spec)
            == jax_policies.check_disagg_policy(spec))


@pytest.mark.parametrize("parameters", [
    {"role": "decode"}, {"role": "prefill", "continuous": True},
    {"role": "prefill", "prefill_chunk_size": 16},
    {"adopt_timeout": 2.0, "continuous": True},
    {"role": "decode", "continuous": True, "adopt_timeout": 2.0}],
    ids=["decode_without_engine", "prefill_with_engine", "prefill_chunk",
         "adopt_timeout", "decode_ok"])
def test_role_parameters_lint_like_the_jax_package(parameters):
    assert (policies.check_decode_parameters(parameters)
            == jax_policies.check_decode_parameters(parameters))


def test_gateway_disagg_construction_matches_lint():
    process = Process(transport_kind="loopback")
    with pytest.raises(ValueError, match="AIKO408"):
        Gateway(process, name="bad", disagg="adopt_timeout=-1")
    with pytest.raises(ValueError, match="AIKO404"):
        Gateway(process, name="bad2", disagg="warp=9")
    with pytest.raises(ValueError, match="AIKO408"):
        Gateway(process, name="bad3", disagg="role=prefill")


# -- the gateway's two pools --------------------------------------------------

LM_PARAMS = {"vocab_size": 300, "d_model": 32, "n_layers": 1,
             "n_heads": 2, "n_kv_heads": 1, "d_ff": 64,
             "max_seq_len": 128, "dtype": "float32", "max_new_tokens": 6}


def lm_definition(name, extra, prefill=False):
    if prefill:
        ports = {"input": [{"name": "tokens"}],
                 "output": [{"name": "handoff"}]}
        pipe_params = {"disagg": "role=prefill"}
    else:
        ports = {"input": [{"name": "tokens"},
                           {"name": "handoff", "optional": True}],
                 "output": [{"name": "generated"}]}
        pipe_params = {}
    return {
        "name": name,
        "graph": ["(lm)"],
        "parameters": {"device": "cpu", **pipe_params},
        "elements": [
            {"name": "lm", **ports,
             "parameters": {**LM_PARAMS, **extra},
             "deploy": {"local": {"module": ELEMENTS,
                                  "class_name": "LMGenerate"}}},
        ],
    }


def closed_batch_reference(frames):
    process = Process(transport_kind="loopback")
    pipeline = create_pipeline(process, lm_definition("ref", {}))
    process.run(in_thread=True)
    responses = queue.Queue()
    stream = pipeline.create_stream("s", queue_response=responses,
                                    grace_time=300)
    for frame in frames:
        pipeline.create_frame(stream, {"tokens": frame})
    expected = [np.asarray(responses.get(timeout=120)[2]["generated"])
                for _ in frames]
    process.terminate()
    reset_brokers()
    return expected


def split_fleet(adopt_timeout):
    processes = [Process(transport_kind="loopback") for _ in range(3)]
    prefill = create_pipeline(processes[0], lm_definition(
        "pre0", {"role": "prefill", "kv_block_size": 8}, prefill=True))
    decode = create_pipeline(processes[1], lm_definition(
        "dec0", {"role": "decode", "continuous": True, "decode_slots": 4,
                 "kv_block_size": 8, "adopt_timeout": 5}))
    gateway = Gateway(processes[2], policy="max_inflight=8;queue=32",
                      disagg=f"adopt_timeout={adopt_timeout}")
    gateway.attach_replica(prefill)        # role from the share
    gateway.attach_replica(decode)
    for process in processes:
        process.run(in_thread=True)
    return gateway, prefill, decode, processes


def test_split_pools_through_the_gateway_give_the_closed_batch():
    """A disagg gateway fronting a prefill pool and a decode pool serves
    the plain pipeline's completions: streams pin to decode, prompts
    route to prefill, KV migrates over the transfer plane."""
    rng = np.random.default_rng(9)
    frames = [rng.integers(1, 300, size=(1, 6)).astype(np.int32)
              for _ in range(4)]
    expected = closed_batch_reference(frames)
    gateway, prefill, decode, processes = split_fleet(5)
    try:
        assert {replica.name: replica.pool_role()
                for replica in gateway.replicas.values()} == {
            "pre0": "prefill", "dec0": "decode"}
        responses = queue.Queue()
        gateway.submit_stream("g1", {}, queue_response=responses)
        for frame_id, frame in enumerate(frames):
            gateway.submit_frame("g1", {"tokens": frame},
                                 frame_id=frame_id)
        got = {}
        for _ in frames:
            _, frame_id, outputs, status = responses.get(timeout=120)
            assert status == "ok", (frame_id, outputs)
            got[frame_id] = np.asarray(outputs["generated"])
        for frame_id, reference_out in enumerate(expected):
            np.testing.assert_array_equal(got[frame_id], reference_out)
        engine = decode.elements["lm"].engine_stats()
        assert engine["adopted"] >= 1 and engine["kv_migrated_bytes"] > 0
        assert prefill.elements["lm"].prefill_stats()["exported"] == 4
        assert gateway.telemetry.prefill_routed.value == 4
        assert gateway.telemetry.kv_migrations.value == 4
        snapshot = gateway.pool_snapshot()
        assert snapshot["pre0"]["role"] == "prefill"
        assert snapshot["dec0"]["role"] == "decode"
    finally:
        for process in processes:
            process.terminate()


def test_prefill_replica_death_degrades_not_loses():
    """Losing the ONLY prefill replica mid-stream: later frames complete
    through the decode replica's local prefill with the closed batch's
    tokens -- zero lost frames."""
    rng = np.random.default_rng(11)
    frames = [rng.integers(1, 300, size=(1, 6)).astype(np.int32)
              for _ in range(3)]
    expected = closed_batch_reference(frames)
    gateway, prefill, _, processes = split_fleet(2)
    try:
        responses = queue.Queue()
        gateway.submit_stream("g1", {}, queue_response=responses)
        gateway.submit_frame("g1", {"tokens": frames[0]}, frame_id=0)
        assert responses.get(timeout=120)[3] == "ok"
        gateway.post_message("_replica_lost",
                             [prefill.topic_path, "test kill"])
        for frame_id, frame in enumerate(frames[1:], start=1):
            gateway.submit_frame("g1", {"tokens": frame},
                                 frame_id=frame_id)
        for _ in frames[1:]:
            _, frame_id, outputs, status = responses.get(timeout=120)
            assert status == "ok", (frame_id, outputs)
            np.testing.assert_array_equal(
                np.asarray(outputs["generated"]), expected[frame_id])
        assert prefill.topic_path not in gateway.replicas
    finally:
        for process in processes:
            process.terminate()
