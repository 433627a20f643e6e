# The port's long-context path against the JAX package's, on the CPU:
# the transformer with sequence_parallel=True (ring and Ulysses prefill,
# the cached prefill and sp decode of generate, the train step through
# the ring's backward) and the elements on a mesh (LMForward in the
# graph of examples/pipeline_longcontext.json, LMGenerate's left-padded
# prompts).  JAX runs on its virtual 8-device CPU mesh (tests/conftest.py,
# Pallas in interpret mode); the port's mesh names the CPU several times
# (set_default_devices).  The JAX package's random parameters go through
# numpy into the port (models/bridge.py), or through its save_pytree
# into both pipelines.  f32 at the JAX tests' sizes (2 layers, d 32, 4
# heads, 2 KV heads).
#
# Tolerances: SP logits atol/rtol 1e-5 against JAX's SP forward (the JAX
# test's own bound against dense is 2e-3; both packages merge the same
# per-hop partials, summed in another order inside a hop); greedy tokens
# identical; the SP loss atol 1e-6 and every gradient leaf atol 1e-6
# (values of order 1e-2) against jax.value_and_grad of JAX's dense loss,
# the bound tests/test_torch_transformer.py holds the dense gradient to;
# one adamw(1e-3) train step: loss atol 1e-5 and every
# parameter atol 5e-5 against JAX's dense make_train_step, the bounds
# tests/test_torch_transformer.py holds the dense step to (Adam divides
# each gradient by its own magnitude, so an f32 rounding difference in a
# gradient near its noise floor moves that entry by up to a fraction of
# the learning rate); element logits and NLL atol 1e-5.

import dataclasses
import queue

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import aiko_services_tpu.pipeline as jax_pipeline
import aiko_services_tpu.runtime as jax_runtime
import aiko_services_tpu.transport as jax_transport
import aiko_services_tpu_torch.pipeline as torch_pipeline
import aiko_services_tpu_torch.runtime as torch_runtime
import aiko_services_tpu_torch.transport as torch_transport
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu.models import save_pytree
from aiko_services_tpu.parallel import create_mesh as jax_create_mesh
from aiko_services_tpu.parallel import filter_specs as jax_filter_specs
from aiko_services_tpu.parallel import shard_pytree as jax_shard_pytree
from aiko_services_tpu_torch.models import (
    optim, params_from_numpy, params_to_numpy)
from aiko_services_tpu_torch.models import transformer as torch_lm
from aiko_services_tpu_torch.parallel import mesh as torch_mesh

CONFIG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=64, max_seq_len=64, dtype="float32")
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def eight_cpus():
    torch_mesh.set_default_devices(["cpu"] * 8)
    jax_transport.reset_brokers()
    torch_transport.reset_brokers()
    try:
        yield
    finally:
        torch_mesh.set_default_devices(None)
        jax_transport.reset_brokers()
        torch_transport.reset_brokers()


@pytest.fixture(scope="module")
def lm():
    """(JAX params, the same params as numpy)."""
    params = jax_lm.init_params(jax_lm.TransformerConfig(**CONFIG),
                                jax.random.PRNGKey(0))
    return params, jax.tree_util.tree_map(np.asarray, params)


def _configs(**changes):
    return (jax_lm.TransformerConfig(**CONFIG, **changes),
            torch_lm.TransformerConfig(**CONFIG, **changes))


def _meshes(n: int):
    return (jax_create_mesh({"seq": n}, devices=jax.devices()[:n]),
            torch_mesh.create_mesh({"seq": n}, devices=["cpu"] * n))


def _tokens(shape, seed=5):
    return np.random.default_rng(seed).integers(
        0, CONFIG["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize("mechanism, n", [("ring", 8), ("ring", 4),
                                          ("ulysses", 4)])
def test_sp_forward_matches_jax_sp_forward(lm, mechanism, n):
    """JAX test_sequence_parallel_matches_dense through both packages;
    Ulysses needs the 4 heads to divide by the axis."""
    jax_params, numpy_params = lm
    jax_config, config = _configs(sequence_parallel=True,
                                  sp_mechanism=mechanism)
    jax_mesh, mesh = _meshes(n)
    tokens = _tokens((2, 32))
    with jax.set_mesh(jax_mesh):
        expected = np.asarray(jax_lm.forward(jax_params, jax_config, tokens))
    params = params_from_numpy(numpy_params, device="cpu")
    with torch_mesh.use_mesh(mesh):
        actual = torch_lm.forward(params, config, torch.from_numpy(tokens))
    np.testing.assert_allclose(actual.numpy(), expected, **TOL)
    dense = torch_lm.forward(params, _configs()[1], torch.from_numpy(tokens))
    np.testing.assert_allclose(actual.numpy(), dense.numpy(),
                               atol=2e-3, rtol=2e-3)


def test_sp_generate_tokens_equal_jax_sp_generate(lm):
    """Greedy generate with the SP cache: the ring's cached prefill at
    pos 0, then sp_decode_attention over the seq-sharded cache."""
    jax_params, numpy_params = lm
    jax_config, config = _configs(sequence_parallel=True)
    jax_mesh, mesh = _meshes(4)
    prompt = _tokens((2, 16), seed=9)
    max_new, cache_len = 12, 28   # 16 + 12, divisible by 4
    with jax.set_mesh(jax_mesh):
        jax_cache = jax_shard_pytree(
            jax_lm.init_cache(jax_config, 2, max_len=cache_len), jax_mesh,
            jax_filter_specs(jax_lm.cache_specs(sequence_parallel=True),
                             jax_mesh))
        expected, _ = jax_lm.generate(jax_params, jax_config, prompt,
                                      max_new, cache=jax_cache)
    params = params_from_numpy(numpy_params, device="cpu")
    with torch_mesh.use_mesh(mesh):
        cache = torch_lm.init_sp_cache(config, 2, cache_len, device="cpu")
        assert cache["k"].shape[3] == cache_len
        actual, _ = torch_lm.generate(params, config,
                                      torch.from_numpy(prompt), max_new,
                                      cache=cache)
        streamed = np.concatenate([block for _, block in
                                   torch_lm.generate_stream(
                                       params, config,
                                       torch.from_numpy(prompt), max_new,
                                       chunk=5)], axis=1)
    np.testing.assert_array_equal(actual.numpy(), np.asarray(expected))
    np.testing.assert_array_equal(streamed, np.asarray(expected))


def test_sp_train_step_matches_jax_dense_step(lm):
    """One adamw step through the ring (its backward: the dQ and dK/dV
    kernels' plain versions per hop) against the JAX package's dense
    make_train_step on the same weights and tokens."""
    jax_params, numpy_params = lm
    jax_config = jax_lm.TransformerConfig(**CONFIG)
    config = torch_lm.TransformerConfig(**CONFIG, sequence_parallel=True)
    tokens = _tokens((2, 17), seed=3)   # 16 positions train, 16 % 4 == 0
    jax_optimizer = optax.adamw(1e-3)
    expected, _, expected_loss = jax_lm.make_train_step(
        jax_config, jax_optimizer)(jax_params,
                                   jax_optimizer.init(jax_params), tokens)
    optimizer = optim.adamw(1e-3)
    params = params_from_numpy(numpy_params, device="cpu")
    with torch_mesh.use_mesh(_meshes(4)[1]):
        params, _, loss = torch_lm.make_train_step(config, optimizer)(
            params, optimizer.init(params), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(expected_loss),
                               atol=1e-5, rtol=0)
    got = params_to_numpy(params)
    for path, want in jax.tree_util.tree_flatten_with_path(expected)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(want), atol=5e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mechanism, n", [("ring", 4), ("ring", 8),
                                          ("ulysses", 4)])
def test_sp_loss_and_every_gradient_leaf_match_jax_dense(lm, mechanism, n):
    """The SP loss's gradient, leaf by leaf, against jax.value_and_grad of
    the JAX package's dense loss on the same weights and tokens: the
    ring's backward (the dQ and dK/dV kernels' plain versions per hop,
    dK/dV carried home) and Ulysses' per head group, through repeat_kv."""
    jax_params, numpy_params = lm
    jax_config = jax_lm.TransformerConfig(**CONFIG)
    config = torch_lm.TransformerConfig(**CONFIG, sequence_parallel=True,
                                        sp_mechanism=mechanism)
    tokens = _tokens((2, 17), seed=3)   # 16 positions, divisible by n

    def jax_loss(params, tokens):
        logits = jax_lm.forward(params, jax_config, tokens[:, :-1])
        log_probs = jax.nn.log_softmax(logits, axis=-1)
        return -jax.numpy.mean(jax.numpy.take_along_axis(
            log_probs, tokens[:, 1:, None], axis=-1)[..., 0])

    def torch_loss(params, tokens):
        logits = torch_lm.forward(params, config, tokens[:, :-1])
        return optim.next_token_loss(logits, tokens[:, 1:])

    expected_loss, expected = jax.value_and_grad(jax_loss)(jax_params,
                                                           tokens)
    with torch_mesh.use_mesh(_meshes(n)[1]):
        loss, grads = optim.value_and_grad(
            torch_loss, params_from_numpy(numpy_params, device="cpu"),
            torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(expected_loss),
                               atol=1e-6, rtol=0)
    got = params_to_numpy(grads)
    leaves = jax.tree_util.tree_flatten_with_path(expected)[0]
    assert len(leaves) == 11
    for path, want in leaves:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(want), atol=1e-6,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def test_sp_cache_length_pads_to_the_seq_axis():
    """init_sp_cache: init_cache with the length rounded up to divide the
    seq axis of the given or the ambient mesh; no seq mesh raises."""
    _, config = _configs(sequence_parallel=True)
    mesh = _meshes(4)[1]
    assert torch_lm.init_sp_cache(config, 1, 26, mesh,
                                  device="cpu")["k"].shape == (2, 1, 2, 28, 8)
    with torch_mesh.use_mesh(_meshes(8)[1]):
        assert torch_lm.init_sp_cache(config, 1, 26,
                                      device="cpu")["v"].shape[3] == 32
    with pytest.raises(ValueError, match="needs a mesh with a 'seq' axis"):
        torch_lm.init_sp_cache(config, 1, 26, device="cpu")


def test_sp_cached_prefill_needs_pos_0(lm):
    _, numpy_params = lm
    _, config = _configs(sequence_parallel=True)
    params = params_from_numpy(numpy_params, device="cpu")
    cache = torch_lm.init_cache(config, 1, max_len=32, device="cpu")
    with torch_mesh.use_mesh(_meshes(4)[1]):
        with pytest.raises(ValueError, match="requires pos == 0"):
            torch_lm.forward(params, config,
                             torch.from_numpy(_tokens((1, 8))),
                             cache=cache, pos=4)
    assert not cache["k"].any()   # refused before anything was written


def test_int8_kv_cache_with_sp_raises():
    with pytest.raises(ValueError, match="kv_dtype='int8' is not supported"):
        torch_lm.TransformerConfig(**CONFIG, sequence_parallel=True,
                                   kv_dtype="int8")
    with pytest.raises(ValueError, match="sp_mechanism"):
        torch_lm.TransformerConfig(**CONFIG, sp_mechanism="tree")


@pytest.mark.parametrize("call", ["param_specs", "activation_specs",
                                  "sharded_train_step"])
def test_parameter_sharding_matches_jax(lm, call):
    """The parameter-sharding entry points next to the long-context path:
    param_specs (and its quantized and MoE forms) are JAX's spec trees;
    forward(activation_specs=True) and make_train_step(sharded=True) on
    an ambient data 2 x seq 4 mesh, with sequence parallelism, give JAX's
    logits and loss (TOL) -- and without a mesh activation_specs changes
    nothing."""
    jax_params, numpy_params = lm
    jax_config, config = _configs(sequence_parallel=True)
    tokens = _tokens((2, 17))
    if call == "param_specs":
        def as_tuples(tree):
            if isinstance(tree, dict):
                return {key: as_tuples(value) for key, value in tree.items()}
            return tuple(tree)
        for changes in ({}, {"n_experts": 4}):
            jax_c, port_c = _configs(**changes)
            for lm_head in (False, True):
                assert as_tuples(torch_lm.param_specs(port_c, lm_head)) == \
                    as_tuples(jax_lm.param_specs(jax_c, lm_head))
                assert as_tuples(torch_lm.quantized_param_specs(
                    port_c, lm_head)) == as_tuples(
                        jax_lm.quantized_param_specs(jax_c, lm_head))
        return
    jax_mesh = jax_create_mesh({"data": 2, "seq": 4})
    mesh = torch_mesh.create_mesh({"data": 2, "seq": 4})
    params = params_from_numpy(numpy_params, device="cpu")
    if call == "activation_specs":
        dense_config = _configs()[1]
        whole = torch_lm.forward(params, dense_config,
                                 torch.from_numpy(tokens))
        np.testing.assert_array_equal(torch_lm.forward(
            params, dense_config, torch.from_numpy(tokens),
            activation_specs=True).numpy(), whole.numpy())
        with jax.set_mesh(jax_mesh):
            expected = np.asarray(jax_lm.forward(
                jax_params, jax_config, tokens[:, :16],
                activation_specs=True))
        with torch_mesh.use_mesh(mesh):
            actual = torch_lm.forward(params, config,
                                      torch.from_numpy(tokens[:, :16]),
                                      activation_specs=True)
        np.testing.assert_allclose(actual.numpy(), expected, **TOL)
        return
    with jax.set_mesh(jax_mesh):
        step = jax_lm.make_train_step(jax_config, optax.adamw(1e-3),
                                      sharded=True)
        copied = jax.tree_util.tree_map(jnp.array, jax_params)
        _, _, expected = step(copied, optax.adamw(1e-3).init(copied),
                              tokens)
    optimizer = optim.adamw(1e-3)
    with torch_mesh.use_mesh(mesh):
        _, _, loss = torch_lm.make_train_step(
            config, optimizer, sharded=True)(
                params, optimizer.init(params), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(expected), atol=1e-5)


def test_cache_specs_match_jax():
    for sequence_parallel in (False, True):
        for quantized in (False, True):
            expected = jax_lm.cache_specs(sequence_parallel, quantized)
            actual = torch_lm.cache_specs(sequence_parallel, quantized)
            assert {name: tuple(spec) for name, spec in actual.items()} == {
                name: tuple(spec) for name, spec in expected.items()}


# -- the elements ------------------------------------------------------------

JAX = ("aiko_services_tpu.elements", jax_pipeline, jax_runtime)
PORT = ("aiko_services_tpu_torch.elements", torch_pipeline, torch_runtime)


@pytest.fixture(scope="module")
def weights(lm, tmp_path_factory):
    path = tmp_path_factory.mktemp("sp") / "lm.safetensors"
    save_pytree(str(path), lm[0])
    return str(path)


def _longcontext(package, weights, length: int, count: int):
    """examples/pipeline_longcontext.json built in code at the JAX tests'
    widths: (tokens (lm)), LMForward with sequence_parallel on a data 1 x
    seq 4 mesh (the model axis of the example is ROADMAP item 4b), the
    example's bucket_axes and input spec."""
    return {
        "name": "pipeline_longcontext",
        "graph": ["(tokens (lm))"],
        "parameters": {"device": "cpu"} if package is PORT else {},
        "elements": [
            {"name": "tokens",
             "output": [{"name": "tokens", "type": f"i32[1,{length}]"}],
             "parameters": {"data_sources": [[1, length]], "count": count,
                            "vocab_size": CONFIG["vocab_size"]},
             "deploy": {"local": {"module": package[0],
                                  "class_name": "TokenSource"}}},
            {"name": "lm",
             "input": [{"name": "tokens", "type": f"i32[1,{length}]"}],
             "output": [{"name": "logits"}, {"name": "nll"}],
             "parameters": {**CONFIG, "max_seq_len": 128,
                            "weights": weights, "sequence_parallel": True,
                            "bucket_axes": {"tokens": 1},
                            "bucket_min": 32},
             "sharding": {"axes": {"data": 1, "seq": 4},
                          "devices": [0, 4],
                          "inputs": {"tokens": ["data", None]}},
             "deploy": {"local": {"module": package[0],
                                  "class_name": "LMForward"}}},
        ],
    }


def _serve(package, definition, count, frames=()):
    _, pipeline_module, runtime_module = package
    process = runtime_module.Process(transport_kind="loopback")
    try:
        pipeline = pipeline_module.create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        stream = pipeline.create_stream("s1", queue_response=responses)
        for frame in frames:
            pipeline.create_frame(stream, frame)
        results = {}
        for _ in range(count):
            _, frame, outputs = responses.get(timeout=120)
            results[frame.frame_id] = {
                name: (value.detach().cpu().numpy()
                       if isinstance(value, torch.Tensor)
                       else np.asarray(value))
                for name, value in outputs.items()}
        element = pipeline.elements["lm"]
    finally:
        process.terminate()
    return results, element


@pytest.mark.parametrize("length", [64, 50])
def test_longcontext_element_matches_jax_element(weights, length):
    """The source's frames through both packages' graphs: logits and NLL
    equal; 50 is not a multiple of the seq axis, so the bucketing pads
    to 64 and un-pads the logits, as in the JAX package."""
    expected, _ = _serve(JAX, _longcontext(JAX, weights, length, 2), 2)
    actual, element = _serve(PORT, _longcontext(PORT, weights, length, 2),
                             2)
    assert dict(element.mesh.shape) == {"data": 1, "seq": 4}
    assert sorted(actual) == sorted(expected)
    for frame_id, want in expected.items():
        got = actual[frame_id]
        assert got["logits"].shape == (1, length, CONFIG["vocab_size"])
        assert np.isfinite(got["logits"]).all()
        np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
        np.testing.assert_allclose(got["nll"], want["nll"], **TOL)


def _generate(package, weights, sharded: bool):
    element = {
        "name": "lm", "input": [{"name": "tokens"}],
        "output": [{"name": "generated"}],
        "parameters": {**CONFIG, "weights": weights, "max_new_tokens": 8,
                       **({"sequence_parallel": True} if sharded else {})},
        "deploy": {"local": {"module": package[0],
                             "class_name": "LMGenerate"}}}
    if sharded:
        element["sharding"] = {"axes": {"data": 1, "seq": 4},
                               "devices": [0, 4],
                               "inputs": {"tokens": ["data", None]}}
    return {"name": "gen", "graph": ["(lm)"],
            "parameters": {"device": "cpu"} if package is PORT else {},
            "elements": [element]}


def test_lm_generate_left_pads_to_the_seq_axis_as_jax_does(weights):
    """Prompts of 13 and 15 tokens (not multiples of 4) are LEFT-padded
    with the pad id to 16: the SP tokens equal the JAX package's SP
    tokens, pad included -- not the unsharded result."""
    frames = [{"tokens": _tokens((1, 13), seed=21)},
              {"tokens": _tokens((2, 15), seed=22)}]
    expected, _ = _serve(JAX, _generate(JAX, weights, True), 2, frames)
    actual, _ = _serve(PORT, _generate(PORT, weights, True), 2, frames)
    for frame_id, want in expected.items():
        assert actual[frame_id]["generated"].dtype == np.int32
        np.testing.assert_array_equal(actual[frame_id]["generated"],
                                      want["generated"])
    # the pad is attended: what the dense element gives for the unpadded
    # prompt is another computation, shown equal to the padded one
    padded = [{"tokens": np.concatenate(
        [np.zeros((frame["tokens"].shape[0], 16 - frame["tokens"].shape[1]),
                  np.int32), frame["tokens"]], axis=1)} for frame in frames]
    dense, _ = _serve(PORT, _generate(PORT, weights, False), 2, padded)
    for frame_id, want in expected.items():
        np.testing.assert_array_equal(dense[frame_id]["generated"],
                                      want["generated"])


def test_sp_generate_without_a_seq_mesh_raises(weights):
    definition = _generate(PORT, weights, True)
    del definition["elements"][0]["sharding"]
    process = torch_runtime.Process(transport_kind="loopback")
    try:
        pipeline = torch_pipeline.create_pipeline(process, definition)
        process.run(in_thread=True)
        element = pipeline.elements["lm"]
        element._ensure_ready()
        with pytest.raises(ValueError, match="needs a sharding block"):
            element._sp_cache(1, 16)
        with pytest.raises(ValueError, match="needs a mesh"):
            torch_lm.forward(element.state, element.config,
                             torch.from_numpy(_tokens((1, 16))))
    finally:
        process.terminate()


def test_meshed_compute_runs_under_its_own_ambient_mesh(weights):
    """Two meshed elements computing on two threads each see their own
    mesh (the ambient mesh is a context variable, not a process-wide
    flag): seq 2 and seq 4 LMForward elements give the dense logits."""
    import threading
    results, errors = {}, []

    def run(name, size):
        definition = _longcontext(PORT, weights, 32, 1)
        definition["name"] = name
        definition["elements"][1]["sharding"]["axes"]["seq"] = size
        definition["elements"][1]["sharding"]["devices"] = [0, size]
        try:
            results[name] = _serve(PORT, definition, 1)
        except Exception as error:   # surfaced by the assert below
            errors.append(error)

    threads = [threading.Thread(target=run, args=(f"sp{size}", size))
               for size in (2, 4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=300)
        assert not thread.is_alive()
    assert errors == []
    assert dict(results["sp2"][1].mesh.shape)["seq"] == 2
    assert dict(results["sp4"][1].mesh.shape)["seq"] == 4
    np.testing.assert_allclose(results["sp2"][0][0]["logits"],
                               results["sp4"][0][0]["logits"], **TOL)
    assert torch_mesh.ambient_mesh() is None


def test_indivisible_input_runs_replicated_with_one_warning(weights):
    """An input spec whose dimension does not divide by its axes (batch 1
    on seq 4) is placed without its spec (the JAX package replicates it)
    and says so once; the logits are those of the divisible spec."""
    expected, _ = _serve(PORT, _longcontext(PORT, weights, 32, 2), 2)
    definition = _longcontext(PORT, weights, 32, 2)
    definition["elements"][1]["sharding"]["inputs"] = {
        "tokens": ["seq", None]}
    actual, element = _serve(PORT, definition, 2)
    assert element._indivisible_warned == {"tokens"}
    for frame_id, want in expected.items():
        np.testing.assert_array_equal(actual[frame_id]["logits"],
                                      want["logits"])
