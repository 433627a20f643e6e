# The port's parameter-sharding axes (parallel/mesh.py placement,
# parallel/collectives.py, the sharded paths of models/transformer.py)
# against the JAX package's GSPMD, on the CPU.  JAX runs on its virtual
# 8-device CPU mesh (tests/conftest.py) with its Pallas kernels in
# interpret mode, as tests/test_transformer.py runs them; the port's mesh
# names the CPU eight times (set_default_devices), so every shard of a
# mesh computes on the CPU.  The JAX package's random parameters go
# through numpy into the port (models/bridge.py); the same numpy tokens go
# into both.  Each test mirrors a JAX test (named in its docstring) at
# that test's widths, and holds three runs together: the JAX package
# sharded, the port sharded and the port unsharded.
#
# Tolerances (f32 throughout): greedy tokens identical (the contract of
# JAX test_decode_parity_with_param_specs_sharding); logits atol/rtol
# 1e-5 between the port's sharded and unsharded runs and against JAX
# (the same products, their partial sums added in another order); the
# loss atol 1e-5 and every parameter atol 5e-5 after the train steps, the
# bounds tests/test_torch_transformer.py holds the unsharded step to
# (Adam divides each gradient by its own magnitude, so a rounding
# difference in a gradient near its noise floor moves that entry by a
# fraction of the learning rate); the JAX SP and EP train steps, which
# its tests only run, are held at the same bounds.

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from aiko_services_tpu.models import asr as jax_asr
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu.models.configs import LLAMA3_8B as JAX_8B
from aiko_services_tpu.models.configs import LLAMA32_1B as JAX_1B
from aiko_services_tpu.parallel import create_mesh as jax_create_mesh
from aiko_services_tpu.parallel import filter_specs as jax_filter_specs
from aiko_services_tpu.parallel import shard_pytree as jax_shard_pytree
from aiko_services_tpu_torch.models import (
    asr as torch_asr, optim, params_from_numpy, save_pytree, load_pytree)
from aiko_services_tpu_torch.models import transformer as torch_lm
from aiko_services_tpu_torch.parallel import collectives
from aiko_services_tpu_torch.parallel import mesh as torch_mesh

TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=5e-5, rtol=0)
# tests/test_transformer.py's small config and its serving config
SMALL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=64, max_seq_len=64, dtype="float32")
ARCH_1B = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=8,
               n_kv_heads=2, d_ff=128, max_seq_len=128, dtype="float32",
               rope_theta=JAX_1B.rope_theta)


@pytest.fixture(autouse=True)
def eight_cpus():
    torch_mesh.set_default_devices(["cpu"] * 8)
    try:
        yield
    finally:
        torch_mesh.set_default_devices(None)


def _meshes(axes: dict):
    count = int(np.prod(list(axes.values())))
    return (jax_create_mesh(axes, devices=jax.devices()[:count]),
            torch_mesh.create_mesh(axes, devices=["cpu"] * count))


def _models(config: dict, seed: int, **changes):
    """(JAX config, JAX params, port config, numpy params)."""
    jax_config = jax_lm.TransformerConfig(**config, **changes)
    params = jax_lm.init_params(jax_config, jax.random.PRNGKey(seed))
    return (jax_config, params, torch_lm.TransformerConfig(
        **config, **changes), jax.tree_util.tree_map(np.asarray, params))


def _port(numpy_params):
    return params_from_numpy(numpy_params, device="cpu")


def _sharded(numpy_params, mesh, specs):
    return torch_mesh.shard_pytree(_port(numpy_params), mesh,
                                   torch_mesh.filter_specs(specs, mesh))


def _tokens(shape, seed, low=0, high=128):
    return np.random.default_rng(seed).integers(low, high, shape).astype(
        np.int32)


def _unsharded_tree(tree):
    if isinstance(tree, dict):
        return {key: _unsharded_tree(value) for key, value in tree.items()}
    return torch_mesh.unshard(tree)


# -- the mesh and the placement -----------------------------------------------

@pytest.mark.parametrize("axes", [
    {"data": 2, "fsdp": 2, "seq": 1, "model": 2},
    {"data": 2, "expert": 2, "model": 2},
    {"data": 1, "fsdp": 2, "seq": 1, "model": 4}])
def test_create_mesh_builds_the_jax_meshes(axes):
    jax_mesh, mesh = _meshes(axes)
    assert tuple(mesh.axis_names) == tuple(jax_mesh.axis_names)
    assert dict(mesh.shape) == dict(jax_mesh.shape)


def _shard_shapes(family: str):
    """(JAX tree, port tree) placed by `family`'s specs on the same
    mesh."""
    axes = {"data": 2, "fsdp": 2, "model": 2}
    jax_mesh, mesh = _meshes(axes)
    if family == "asr_param_specs":
        config = dict(n_mels=16, d_model=32, enc_layers=2, dec_layers=2,
                      n_heads=4, vocab_size=64, max_frames=32,
                      max_text_len=16, dtype="float32")
        tree = jax_asr.init_asr_params(jax_asr.AsrConfig(**config),
                                       jax.random.PRNGKey(0))
        specs = jax_asr.asr_param_specs(jax_asr.AsrConfig(**config))
        torch_specs = torch_asr.asr_param_specs(torch_asr.AsrConfig(**config))
    else:
        jax_config, tree, config, _ = _models(SMALL, 0)
        if family == "param_specs":
            specs = jax_lm.param_specs(jax_config)
            torch_specs = torch_lm.param_specs(config)
        elif family == "quantized_param_specs":
            tree = jax_lm.quantize_weights_int8(tree, jax_config)
            specs = jax_lm.quantized_param_specs(jax_config)
            torch_specs = torch_lm.quantized_param_specs(config)
        else:
            tree = jax_lm.init_cache(dataclasses.replace(
                jax_config, kv_dtype="int8"), 4, max_len=16)
            specs = jax_lm.cache_specs(quantized=True)
            torch_specs = torch_lm.cache_specs(quantized=True)
    numpy_tree = jax.tree_util.tree_map(np.asarray, tree)
    placed = jax_shard_pytree(tree, jax_mesh,
                              jax_filter_specs(specs, jax_mesh))
    ours = torch_mesh.shard_pytree(_port(numpy_tree), mesh,
                                   torch_mesh.filter_specs(torch_specs,
                                                           mesh))
    return placed, ours, numpy_tree


@pytest.mark.parametrize("family", ["param_specs", "quantized_param_specs",
                                    "asr_param_specs", "cache_specs"])
def test_shard_shapes_match_jax(family):
    """Every leaf's block shape is the shape of JAX's addressable shards;
    each block lies on its position's device, blocks replicated on one
    device are one tensor, and unshard gives the leaf back."""
    placed, ours, numpy_tree = _shard_shapes(family)
    jax_leaves = jax.tree_util.tree_leaves(placed)
    port_leaves, numpy_leaves = [], jax.tree_util.tree_leaves(numpy_tree)

    def walk(node):
        if isinstance(node, dict):
            for value in node.values():
                walk(value)
        else:
            port_leaves.append(node)
    walk(ours)
    assert len(port_leaves) == len(jax_leaves)
    cut = 0
    for jax_leaf, leaf, expected in zip(jax_leaves, port_leaves,
                                        numpy_leaves):
        shapes = {tuple(shard.data.shape)
                  for shard in jax_leaf.addressable_shards}
        if isinstance(leaf, torch_mesh.Sharded):
            cut += 1
            assert {tuple(block.shape) for block in leaf.unique()} == shapes
            for position, block in np.ndenumerate(leaf.shards):
                assert block.device == leaf.mesh.devices[position]
            assert len(leaf.unique()) == len(
                {leaf.block(position) for position in np.ndindex(
                    leaf.shards.shape)})
        else:
            assert shapes == {tuple(leaf.shape)}
        whole = torch_mesh.unshard(leaf)
        np.testing.assert_array_equal(
            whole.numpy() if whole.dtype != torch.bfloat16
            else whole.float().numpy(), np.asarray(expected))
    assert cut > 0


def test_indivisible_dimension_raises_as_jax():
    _, mesh = _meshes({"data": 2, "model": 4})
    with pytest.raises(ValueError, match="not divisible"):
        torch_mesh.shard_pytree(torch.zeros(4, 6), mesh,
                                torch_mesh.PartitionSpec(None, "model"))


# -- the transformer: training ------------------------------------------------

def _train(step, params, optimizer, tokens, steps):
    state = optimizer.init(params)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    return params, losses


def _jax_train(jax_config, jax_params, mesh, tokens, steps, sharded=True,
               specs=None, lr=1e-2):
    optimizer = optax.adam(lr)
    with jax.set_mesh(mesh):
        params = jax_shard_pytree(jax_params, mesh, jax_filter_specs(
            specs or jax_lm.param_specs(jax_config), mesh))
        step = jax_lm.make_train_step(jax_config, optimizer,
                                      sharded=sharded)
        placed = jax.device_put(jnp.asarray(tokens),
                                NamedSharding(mesh, JP("data", None)))
        state = optimizer.init(params)
        losses = []
        for _ in range(steps):
            params, state, loss = step(params, state, placed)
            losses.append(float(loss))
    return jax.tree_util.tree_map(np.asarray, params), losses


@pytest.mark.parametrize("sequence_parallel, length", [(False, 16),
                                                       (True, 17)])
def test_sharded_train_step_matches_jax(sequence_parallel, length):
    """JAX test_sharded_train_step_on_mesh and
    test_sequence_parallel_train_step: TP + DP (+ SP) over the 8-device
    mesh, two adam(1e-2) steps.  The port's sharded step matches JAX's
    step on the sharded parameters and its own unsharded step; the
    weights stay cut, and the data replicas of every block are one
    tensor.

    Without sequence parallelism JAX is run with sharded=False: its
    sharded=True constrains the activations' sequence onto "seq", and
    GSPMD then runs the flash attention on each sequence block alone (no
    ring), so its second loss is 4.68450 against 4.68711 for its own
    unsharded step and for sharded=False.  The port keeps the global
    view (activation_specs never cuts the sequence)."""
    axes = {"data": 2, "fsdp": 1, "seq": 2, "model": 2}
    jax_mesh, mesh = _meshes(axes)
    jax_config, jax_params, config, numpy_params = _models(
        SMALL, 0, sequence_parallel=sequence_parallel)
    tokens = _tokens((4, length), 3)
    expected, jax_losses = _jax_train(jax_config, jax_params, jax_mesh,
                                      tokens, 2, sharded=sequence_parallel)
    optimizer = optim.adam(1e-2)
    with torch_mesh.use_mesh(mesh):
        sharded, losses = _train(
            torch_lm.make_train_step(config, optimizer, sharded=True),
            _sharded(numpy_params, mesh, torch_lm.param_specs(config)),
            optimizer, torch.from_numpy(tokens), 2)
    whole, whole_losses = _train(
        torch_lm.make_train_step(dataclasses.replace(
            config, sequence_parallel=False), optimizer),
        _port(numpy_params), optimizer, torch.from_numpy(tokens), 2)
    np.testing.assert_allclose(losses, jax_losses, atol=1e-5)
    np.testing.assert_allclose(losses, whole_losses, atol=1e-5)
    wq = sharded["layers"]["wq"]["w"]
    assert isinstance(wq, torch_mesh.Sharded)
    assert not wq.sharding.is_fully_replicated
    data = mesh.axis_names.index("data")
    assert all(first is second for first, second in zip(
        wq.shards.take(0, axis=data).flat,
        wq.shards.take(1, axis=data).flat))
    got = _unsharded_tree(sharded)
    for path in (("layers", "wq", "w"), ("layers", "w_down", "w"),
                 ("embed", "w"), ("norm_out", "scale")):
        leaf, reference, other = got, expected, whole
        for key in path:
            leaf, reference, other = leaf[key], reference[key], other[key]
        np.testing.assert_allclose(leaf.detach().numpy(), reference,
                                   **PARAM_TOL)
        np.testing.assert_allclose(leaf.detach().numpy(),
                                   other.detach().numpy(), **PARAM_TOL)


def test_fsdp_train_step_with_remat_matches_unsharded():
    """The ZeRO layout: fsdp 2 x model 2 x data 2, remat nothing_saveable
    (the forward runs again in the backward), two adamw steps against the
    port's unsharded step and JAX's sharded one."""
    axes = {"data": 2, "fsdp": 2, "model": 2}
    jax_mesh, mesh = _meshes(axes)
    jax_config, jax_params, config, numpy_params = _models(SMALL, 1)
    tokens = _tokens((4, 16), 4)
    expected, jax_losses = _jax_train(jax_config, jax_params, jax_mesh,
                                      tokens, 2, lr=1e-3)
    optimizer = optim.adam(1e-3)
    sharded, losses = _train(
        torch_lm.make_train_step(config, optimizer, sharded=True,
                                 remat_policy="nothing_saveable"),
        _sharded(numpy_params, mesh, torch_lm.param_specs(config)),
        optimizer, torch.from_numpy(tokens), 2)
    whole, whole_losses = _train(torch_lm.make_train_step(config,
                                                          optimizer),
                                 _port(numpy_params), optimizer,
                                 torch.from_numpy(tokens), 2)
    np.testing.assert_allclose(losses, jax_losses, atol=1e-5)
    np.testing.assert_allclose(losses, whole_losses, atol=1e-5)
    np.testing.assert_allclose(
        torch_mesh.unshard(sharded["layers"]["wo"]["w"]).detach().numpy(),
        expected["layers"]["wo"]["w"], **PARAM_TOL)
    np.testing.assert_allclose(
        torch_mesh.unshard(sharded["embed"]["w"]).detach().numpy(),
        whole["embed"]["w"].detach().numpy(), **PARAM_TOL)


def _assert_trees_close(got, expected, **tolerance):
    """Every leaf of a port tree (Sharded leaves unsharded) against the
    same leaf of a numpy or port tree."""
    leaves = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf.detach() if isinstance(
            leaf, torch.Tensor) else leaf), expected))[0]
    ours = _unsharded_tree(got)
    for path, want in leaves:
        node = ours
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.detach().numpy(), want, **tolerance,
                                   err_msg=jax.tree_util.keystr(path))
    return len(leaves)


def test_moe_expert_parallel_matches_jax():
    """JAX test_moe_expert_parallel_on_mesh: experts on "expert" (data 2
    x expert 2 x model 2), two adam train steps whose losses and updated
    parameters -- every leaf, the expert blocks included -- match JAX's
    steps and the port's unsharded steps, and f32 generate tokens
    identical to JAX's sharded and the port's unsharded generate."""
    axes = {"data": 2, "expert": 2, "model": 2}
    jax_mesh, mesh = _meshes(axes)
    jax_config, jax_params, config, numpy_params = _models(
        SMALL, 0, n_experts=4)
    tokens = _tokens((4, 16), 3)
    expected, jax_losses = _jax_train(jax_config, jax_params, jax_mesh,
                                      tokens, 2, sharded=False)
    sharded_params = _sharded(numpy_params, mesh,
                              torch_lm.param_specs(config))
    gate = sharded_params["layers"]["w_gate"]["w"]
    assert not gate.sharding.is_fully_replicated
    optimizer = optim.adam(1e-2)
    trained, losses = _train(torch_lm.make_train_step(config, optimizer),
                             sharded_params, optimizer,
                             torch.from_numpy(tokens), 2)
    whole, whole_losses = _train(torch_lm.make_train_step(config,
                                                          optimizer),
                                 _port(numpy_params), optimizer,
                                 torch.from_numpy(tokens), 2)
    np.testing.assert_allclose(losses, jax_losses, atol=1e-5)
    np.testing.assert_allclose(losses, whole_losses, atol=1e-5)
    assert _assert_trees_close(trained, expected, **PARAM_TOL) == 12
    _assert_trees_close(trained, whole, **PARAM_TOL)
    prompt = _tokens((4, 8), 9)
    with jax.set_mesh(jax_mesh):
        jax_tokens, _ = jax_lm.generate(jax_shard_pytree(
            jax_params, jax_mesh, jax_filter_specs(
                jax_lm.param_specs(jax_config), jax_mesh)),
            jax_config, prompt, 6)
    ours, _ = torch_lm.generate(
        _sharded(numpy_params, mesh, torch_lm.param_specs(config)), config,
        torch.from_numpy(prompt), 6)
    whole, _ = torch_lm.generate(_port(numpy_params), config,
                                 torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_tokens))
    np.testing.assert_array_equal(ours.numpy(), whole.numpy())


@pytest.mark.parametrize("case", [
    "dense_data_fsdp_model", "moe_data_expert_model", "moe_oracle",
    "moe_fsdp_expert"])
def test_sharded_gradients_match_jax(case):
    """The sharded train step's gradient, leaf by leaf, against
    jax.value_and_grad of the JAX package's train-step loss (next-token
    cross-entropy plus moe_aux_weight x aux) on the same weights and
    tokens: the per-shard backward, the collectives' backward and the
    sum over data blocks.  Adam divides each gradient by its own
    magnitude, so the parameter checks of the train-step tests cannot see
    a gradient off by a factor; this test can.  f32: loss atol 1e-6, each
    gradient leaf atol 1e-6 (the same products, their partial sums added
    in another order)."""
    axes, changes = {
        "dense_data_fsdp_model": ({"data": 2, "fsdp": 2, "model": 2}, {}),
        "moe_data_expert_model": ({"data": 2, "expert": 2, "model": 2},
                                  {"n_experts": 4}),
        "moe_oracle": ({"data": 2, "expert": 2, "model": 2},
                       {"n_experts": 4, "moe_capacity_factor": 0.0}),
        "moe_fsdp_expert": ({"fsdp": 2, "expert": 2, "model": 2},
                            {"n_experts": 4}),
    }[case]
    _, mesh = _meshes(axes)
    jax_config, jax_params, config, numpy_params = _models(SMALL, 5,
                                                           **changes)
    tokens = _tokens((4, 17), 6)

    def jax_loss(params, tokens):
        logits, aux = jax_lm.forward(params, jax_config, tokens[:, :-1],
                                     return_aux=True)
        log_probs = jax.nn.log_softmax(logits, axis=-1)
        return (-jnp.mean(jnp.take_along_axis(
            log_probs, tokens[:, 1:, None], axis=-1)[..., 0])
            + jax_config.moe_aux_weight * aux)

    def torch_loss(params, tokens):
        logits, aux = torch_lm.forward(params, config, tokens[:, :-1],
                                       return_aux=True)
        return (optim.next_token_loss(logits, tokens[:, 1:])
                + config.moe_aux_weight * aux)

    expected_loss, expected = jax.value_and_grad(jax_loss)(jax_params,
                                                           tokens)
    sharded = _sharded(numpy_params, mesh, torch_lm.param_specs(config))
    loss, grads = optim.value_and_grad(torch_loss, sharded,
                                       torch.from_numpy(tokens))
    assert any(not leaf.sharding.is_fully_replicated
               for leaf in torch_mesh.sharded_leaves(grads))
    np.testing.assert_allclose(float(loss), float(expected_loss), atol=1e-6,
                               rtol=0)
    _assert_trees_close(grads, expected, atol=1e-6, rtol=0)


# -- the transformer: decode --------------------------------------------------

def _generate_three(config_dict, seed, axes, prompt, new, changes=None,
                    cache_len=None, quantize=False, sp=False):
    """Greedy tokens of (JAX sharded, port sharded, port unsharded)."""
    jax_config, jax_params, config, numpy_params = _models(
        config_dict, seed, **(changes or {}))
    if quantize:
        jax_params = jax_lm.quantize_weights_int8(jax_params, jax_config)
        numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    dense_config = dataclasses.replace(config, sequence_parallel=False)
    whole, _ = torch_lm.generate(_port(numpy_params), dense_config,
                                 torch.from_numpy(prompt), new)
    jax_mesh, mesh = _meshes(axes)
    specs = ((jax_lm.quantized_param_specs, torch_lm.quantized_param_specs)
             if quantize else (jax_lm.param_specs, torch_lm.param_specs))
    lm_head = "lm_head" in numpy_params
    quantized_cache = jax_config.kv_dtype == "int8"
    with jax.set_mesh(jax_mesh):
        jax_cache = None
        if cache_len:
            jax_cache = jax_shard_pytree(
                jax_lm.init_cache(jax_config, prompt.shape[0],
                                  max_len=cache_len), jax_mesh,
                jax_filter_specs(jax_lm.cache_specs(
                    sequence_parallel=sp, quantized=quantized_cache),
                    jax_mesh))
        expected, _ = jax_lm.generate(
            jax_shard_pytree(jax_params, jax_mesh, jax_filter_specs(
                specs[0](jax_config, lm_head=lm_head), jax_mesh)),
            jax_config, prompt, new, cache=jax_cache)
    sharded = _sharded(numpy_params, mesh, specs[1](config,
                                                    lm_head=lm_head))
    with torch_mesh.use_mesh(mesh):
        cache = None
        if cache_len:
            cache = torch_mesh.shard_pytree(
                torch_lm.init_cache(config, prompt.shape[0],
                                    max_len=cache_len, device="cpu"), mesh,
                torch_mesh.filter_specs(torch_lm.cache_specs(
                    sequence_parallel=sp, quantized=quantized_cache), mesh))
        ours, _ = torch_lm.generate(sharded, config,
                                    torch.from_numpy(prompt), new,
                                    cache=cache)
    return np.asarray(expected), ours.numpy(), whole.numpy()


def _assert_three(three):
    expected, ours, whole = three
    np.testing.assert_array_equal(ours, expected)
    np.testing.assert_array_equal(ours, whole)


def test_sharded_decode_on_mesh():
    """JAX test_sharded_decode_on_mesh: a cache laid out by cache_specs
    on data 2 x seq 2 x model 2."""
    _assert_three(_generate_three(
        SMALL, 0, {"data": 2, "fsdp": 1, "seq": 2, "model": 2},
        _tokens((2, 4), 1, low=1, high=2), 4, cache_len=16))


@pytest.mark.parametrize("mechanism", ["ring", "ulysses"])
def test_sequence_parallel_generate_with_model_axis(mechanism):
    """JAX test_sequence_parallel_generate and
    test_ulysses_sp_generate_matches_dense: the ring or Ulysses prefill
    and sp decode over each model shard's heads, the cache's length on
    "seq" and its KV heads on "model"."""
    _assert_three(_generate_three(
        SMALL, 0, {"data": 2, "fsdp": 1, "seq": 2, "model": 2},
        _tokens((2, 16), 4), 8,
        changes=dict(sequence_parallel=True, sp_mechanism=mechanism),
        cache_len=24, sp=True))


def test_decode_parity_with_param_specs_sharding():
    """JAX TestShardedServing.test_decode_parity_with_param_specs_sharding
    at its llama32_1b architecture widths (GQA 4:1) on data 2 x fsdp 2 x
    model 2."""
    _assert_three(_generate_three(
        ARCH_1B, 7, {"data": 2, "fsdp": 2, "seq": 1, "model": 2},
        _tokens((4, 12), 0, low=3, high=250), 8, cache_len=32))


def test_int8_sharded_decode_matches_unsharded():
    """JAX test_int8_sharded_decode_matches_unsharded: the int8 KV cache
    (codes and scale planes by cache_specs(quantized=True))."""
    _assert_three(_generate_three(
        ARCH_1B, 7, {"data": 2, "fsdp": 2, "seq": 1, "model": 2},
        _tokens((4, 12), 4, low=3, high=250), 8,
        changes=dict(kv_dtype="int8"), cache_len=32))


def test_int8_weights_sharded_decode_matches_unsharded():
    """JAX test_int8_weights_sharded_decode_matches_unsharded: int8 codes
    and their w_scale blocks by quantized_param_specs."""
    _assert_three(_generate_three(
        ARCH_1B, 4, {"data": 2, "fsdp": 2, "seq": 1, "model": 2},
        _tokens((4, 12), 6, low=3, high=250), 8, quantize=True))


def test_8b_architecture_sharded_decode():
    """JAX TestLlama38BArchitecture: the llama3_8b structure at tiny
    width -- 32 layers, GQA 4:1, rope 500k -- with an untied head, on
    data 2 x fsdp 2 x model 2."""
    config = dict(vocab_size=128, d_model=64, n_layers=JAX_8B.n_layers,
                  n_heads=8, n_kv_heads=2, d_ff=96, max_seq_len=64,
                  dtype="float32", rope_theta=JAX_8B.rope_theta)
    jax_config, jax_params, port_config, numpy_params = _models(config, 1)
    head = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (
        128, 64), jnp.float32) * 0.02)
    jax_params = dict(jax_params, lm_head={"w": jnp.asarray(head)})
    numpy_params = dict(numpy_params, lm_head={"w": head})
    prompt = _tokens((2, 8), 2, low=3, high=120)
    whole, _ = torch_lm.generate(_port(numpy_params), port_config,
                                 torch.from_numpy(prompt), 6)
    jax_mesh, mesh = _meshes({"data": 2, "fsdp": 2, "seq": 1, "model": 2})
    with jax.set_mesh(jax_mesh):
        expected, _ = jax_lm.generate(jax_shard_pytree(
            jax_params, jax_mesh, jax_filter_specs(jax_lm.param_specs(
                jax_config, lm_head=True), jax_mesh)), jax_config, prompt, 6)
    ours, _ = torch_lm.generate(
        _sharded(numpy_params, mesh,
                 torch_lm.param_specs(port_config, lm_head=True)),
        port_config, torch.from_numpy(prompt), 6)
    _assert_three((np.asarray(expected), ours.numpy(), whole.numpy()))


# -- the collectives of one decode step ---------------------------------------

def _decode_step_counts(d_ff: int, axes: dict) -> tuple:
    """(calls, bytes) of the collectives one sharded decode step issues
    (llama32_1b architecture, batch 4, cache 32)."""
    config = torch_lm.TransformerConfig(**dict(ARCH_1B, d_ff=d_ff))
    params = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                  device="cpu")
    _, mesh = _meshes(axes)
    sharded = torch_mesh.shard_pytree(params, mesh, torch_mesh.filter_specs(
        torch_lm.param_specs(config), mesh))
    cache = torch_lm._sharded_cache(mesh, sharded, config, 4, 32)
    token = torch.ones((4, 1), dtype=torch.int32)
    collectives.reset_collective_counts()
    torch_lm.decode_step(sharded, config, cache, token, 5)
    return collectives.collective_totals(), collectives.collective_counts()


def test_decode_step_collective_count_is_bounded():
    """JAX test_decode_step_collective_count_is_bounded, counted by the
    port's collective counter instead of the HLO.  Per layer (see the
    sharded path's header in models/transformer.py): q/k/v one psum over
    fsdp, wo one psum over model + one all_gather over fsdp, gate/up one
    psum over fsdp, w_down one psum over model + one all_gather over fsdp
    -- 6 on a mesh with fsdp, 2 (the megatron pair, JAX's bound) on a
    model-only one; plus the embedding's all_gather over fsdp and the
    logits' psum over fsdp."""
    layers = ARCH_1B["n_layers"]
    (calls, _), counts = _decode_step_counts(
        128, {"data": 2, "fsdp": 2, "seq": 1, "model": 2})
    assert calls == 6 * layers + 2, counts
    assert counts["model"]["calls"] == 2 * layers
    (calls, _), counts = _decode_step_counts(128, {"data": 2, "model": 2})
    assert calls == 2 * layers, counts
    assert set(counts) == {"model"}


def test_decode_step_bytes_do_not_grow_with_d_ff():
    """Weights stay put at decode: on a tensor-parallel mesh the bytes
    one decode step's collectives carry are the activations' (batch x
    d_model per psum), so doubling d_ff -- doubling the MLP weights --
    leaves them unchanged."""
    axes = {"data": 2, "model": 2}
    (calls, size), _ = _decode_step_counts(128, axes)
    (calls_wide, size_wide), _ = _decode_step_counts(256, axes)
    assert (calls_wide, size_wide) == (calls, size)
    # each psum: 4 positions x (2 rows x 1 token x 64) f32
    assert size == calls * 4 * 2 * 64 * 4


# -- forward(activation_specs=True), the placement loader ---------------------

def test_activation_specs_shard_the_batch_on_the_ambient_mesh():
    """JAX forward(activation_specs=True): a no-op without an ambient
    mesh; on one, the batch splits over "data" (whole parameters
    replicate) and the logits equal JAX's and the unsharded ones."""
    jax_config, jax_params, config, numpy_params = _models(SMALL, 0)
    tokens = _tokens((4, 16), 5)
    params = _port(numpy_params)
    whole = torch_lm.forward(params, config, torch.from_numpy(tokens))
    np.testing.assert_array_equal(
        torch_lm.forward(params, config, torch.from_numpy(tokens),
                         activation_specs=True).numpy(), whole.numpy())
    jax_mesh, mesh = _meshes({"data": 2, "model": 2})
    with jax.set_mesh(jax_mesh):
        expected = np.asarray(jax_lm.forward(jax_params, jax_config, tokens,
                                             activation_specs=True))
    collectives.reset_collective_counts()
    with torch_mesh.use_mesh(mesh):
        ours = torch_lm.forward(params, config, torch.from_numpy(tokens),
                                activation_specs=True)
    np.testing.assert_allclose(ours.numpy(), expected, **TOL)
    np.testing.assert_allclose(ours.numpy(), whole.numpy(), **TOL)
    assert collectives.collective_totals() == (0, 0)  # nothing to reduce


def test_load_pytree_places_each_tensor_into_its_shards(tmp_path):
    """load_pytree(mesh=, specs=) reads a checkpoint straight into its
    blocks; save_pytree gathers them back."""
    _, _, config, numpy_params = _models(SMALL, 2)
    path = tmp_path / "lm.safetensors"
    save_pytree(str(path), _port(numpy_params))
    _, mesh = _meshes({"fsdp": 2, "model": 4})
    specs = torch_lm.param_specs(config)
    loaded = load_pytree(str(path), mesh=mesh, specs=specs)
    placed = _sharded(numpy_params, mesh, specs)
    wq = loaded["layers"]["wq"]["w"]
    assert wq.sharding.spec == placed["layers"]["wq"]["w"].sharding.spec
    tokens = torch.from_numpy(_tokens((2, 8), 1))
    np.testing.assert_array_equal(
        torch_lm.forward(loaded, config, tokens).numpy(),
        torch_lm.forward(placed, config, tokens).numpy())
    again = tmp_path / "again.safetensors"
    save_pytree(str(again), loaded)
    np.testing.assert_array_equal(
        load_pytree(str(again), device="cpu")["layers"]["wq"]["w"].numpy(),
        numpy_params["layers"]["wq"]["w"])


# -- heads that straddle model shards; a layout other than the specs' -------

WHISPER_SMALLER = dict(n_mels=8, d_model=48, enc_layers=2, dec_layers=2,
                       n_heads=6, vocab_size=64, max_frames=16,
                       max_text_len=12, dtype="float32")
STRADDLE_CASES = [
    # the old refusal's own config: 4 query heads (one KV head) over 8
    # shards, each shard's columns half a head
    ("lm", dict(SMALL, n_heads=4, n_kv_heads=1), {"model": 8}),
    # 6 heads in 3 KV groups over 2 shards: each shard's 3 query heads
    # span two KV groups
    ("lm", dict(SMALL, d_model=48, n_heads=6, n_kv_heads=3), {"model": 2}),
    # the same over fsdp 2 x model 4: 1.5 heads a shard
    ("lm", dict(SMALL, d_model=48, n_heads=6, n_kv_heads=3),
     {"fsdp": 2, "model": 4}),
    # whisper's 6 heads over 4 shards
    ("whisper", WHISPER_SMALLER, {"model": 4}),
]


@pytest.mark.parametrize("family, config, axes", STRADDLE_CASES,
                         ids=["lm-4h-1kv-model8", "lm-6h-3kv-model2",
                              "lm-6h-3kv-fsdp2-model4", "whisper-6h-model4"])
def test_heads_that_do_not_divide_the_model_axis_match_jax(family, config,
                                                           axes):
    """GSPMD splits a head the model axis cuts; the port gives each shard
    the whole heads its columns touch (one counted all_gather over model
    a layer) and keeps its own columns of O: logits within TOL of the
    JAX package's sharded forward and of the port's unsharded one, greedy
    tokens identical to both."""
    jax_mesh, mesh = _meshes(axes)
    if family == "lm":
        jax_config, jax_params, torch_config, numpy_params = _models(
            config, 0)
        tokens = _tokens((2, 8), 1)
        with jax.set_mesh(jax_mesh):
            expected = np.asarray(jax_lm.forward(jax_shard_pytree(
                jax_params, jax_mesh, jax_filter_specs(
                    jax_lm.param_specs(jax_config), jax_mesh)),
                jax_config, tokens))
        sharded = _sharded(numpy_params, mesh,
                           torch_lm.param_specs(torch_config))
        collectives.reset_collective_counts()
        ours = torch_lm.forward(sharded, torch_config,
                                torch.from_numpy(tokens)).numpy()
        gathers = collectives.collective_counts()["model"]["calls"]
        whole = torch_lm.forward(_port(numpy_params), torch_config,
                                 torch.from_numpy(tokens)).numpy()
        np.testing.assert_allclose(ours, expected, **TOL)
        np.testing.assert_allclose(ours, whole, **TOL)
        # per layer: the q/k/v gather, wo's psum and w_down's psum
        assert gathers == 3 * config["n_layers"]
        _assert_three(_generate_three(config, 0, axes,
                                      _tokens((2, 4), 1), 4))
        return
    jax_config = jax_asr.AsrConfig(**config)
    torch_config = torch_asr.AsrConfig(**config)
    jax_params = jax_asr.init_asr_params(jax_config, jax.random.PRNGKey(3))
    numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    mel = np.random.default_rng(2).standard_normal((2, 8, 24)).astype(
        np.float32)
    with jax.set_mesh(jax_mesh):
        jax_sharded = jax_shard_pytree(jax_params, jax_mesh, jax_filter_specs(
            jax_asr.asr_param_specs(jax_config), jax_mesh))
        expected_memory = np.asarray(jax_asr.encode_audio(
            jax_sharded, jax_config, mel))
        expected = np.asarray(jax_asr.transcribe(jax_sharded, jax_config,
                                                 mel, max_tokens=6))
    sharded = _sharded(numpy_params, mesh,
                       torch_asr.asr_param_specs(torch_config))
    whole = _port(numpy_params)
    memory = torch_asr.encode_audio(sharded, torch_config,
                                    torch.from_numpy(mel))
    np.testing.assert_allclose(memory.numpy(), expected_memory, **TOL)
    np.testing.assert_allclose(
        memory.numpy(), torch_asr.encode_audio(
            whole, torch_config, torch.from_numpy(mel)).numpy(), **TOL)
    tokens = torch_asr.transcribe(sharded, torch_config,
                                  torch.from_numpy(mel), max_tokens=6)
    np.testing.assert_array_equal(tokens.numpy(), expected)
    np.testing.assert_array_equal(tokens.numpy(), torch_asr.transcribe(
        whole, torch_config, torch.from_numpy(mel), max_tokens=6).numpy())


def _swapped_specs(config):
    """param_specs with wq/wk/wv cut the other way (columns over fsdp,
    rows over model) and the embedding's rows over fsdp: a layout the
    sharded path does not compute on."""
    specs = torch_lm.param_specs(config)
    layers = dict(specs["layers"])
    for name in ("wq", "wk", "wv"):
        layers[name] = {"w": torch_mesh.PartitionSpec(None, "model",
                                                      "fsdp")}
    return dict(specs, layers=layers,
                embed={"w": torch_mesh.PartitionSpec("fsdp", None)})


def test_a_layout_other_than_the_specs_is_resharded_once_and_counted():
    """A tree cut otherwise than param_specs' layout (GSPMD would
    re-partition it) gives the default layout's logits and JAX's, and
    the greedy tokens of both; the reshard shows in the collective
    counter: one call per resharded leaf, with the bytes of every source
    position's block, once per forward and once per generate.  A tree in
    the spec layout moves nothing."""
    axes = {"fsdp": 2, "model": 2}
    jax_config, jax_params, config, numpy_params = _models(SMALL, 4)
    jax_mesh, mesh = _meshes(axes)
    tokens = _tokens((2, 8), 3)
    default = _sharded(numpy_params, mesh, torch_lm.param_specs(config))
    swapped = _sharded(numpy_params, mesh, _swapped_specs(config))
    collectives.reset_collective_counts()
    assert collectives.conform(
        default, torch_mesh.filter_specs(torch_lm.param_specs(config), mesh),
        mesh, mesh.shape) is not None
    assert collectives.collective_totals() == (0, 0)
    def block_bytes(leaf):
        return sum(block.numel() * block.element_size()
                   for block in leaf.shards.flat)
    embed_bytes = block_bytes(swapped["embed"]["w"])
    qkv_bytes = sum(block_bytes(swapped["layers"][name]["w"])
                    for name in ("wq", "wk", "wv"))
    collectives.reset_collective_counts()
    want = torch_lm.forward(default, config, torch.from_numpy(tokens))
    plain = collectives.collective_counts()
    collectives.reset_collective_counts()
    got = torch_lm.forward(swapped, config, torch.from_numpy(tokens))
    counted = collectives.collective_counts()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with jax.set_mesh(jax_mesh):
        expected = np.asarray(jax_lm.forward(jax_shard_pytree(
            jax_params, jax_mesh, jax_filter_specs(
                jax_lm.param_specs(jax_config), jax_mesh)),
            jax_config, tokens))
    np.testing.assert_allclose(got.numpy(), expected, **TOL)
    # wq/wk/wv move over fsdp+model, the embedding within fsdp
    assert counted.pop("fsdp+model") == {"calls": 3, "bytes": qkv_bytes}
    fsdp, plain_fsdp = counted.pop("fsdp"), plain.pop("fsdp")
    assert fsdp == {"calls": plain_fsdp["calls"] + 1,
                    "bytes": plain_fsdp["bytes"] + embed_bytes}
    assert counted == plain
    prompt = torch.from_numpy(_tokens((2, 4), 5))
    collectives.reset_collective_counts()
    ours, _ = torch_lm.generate(swapped, config, prompt, 5)
    assert collectives.collective_counts()["fsdp+model"]["calls"] == 3
    whole, _ = torch_lm.generate(_port(numpy_params), config, prompt, 5)
    np.testing.assert_array_equal(ours.numpy(), whole.numpy())
