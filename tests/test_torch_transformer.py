# The port's LM (models/transformer.py) against the JAX package's on the
# CPU, on the same weights: the JAX package's random parameters go through
# numpy into the port (models/bridge.py), the same numpy tokens go into
# both.  f32 throughout, at the JAX package's own test config.
#
# Tolerances: logits atol 1e-5 (two f32 transformer layers summed in
# another order); the loss atol 1e-6 and every gradient leaf atol 1e-6 on
# values of order 1e-2 (f32 rounding of the same sums); parameters after
# three adamw(1e-3) steps atol 5e-5: Adam divides each gradient by its own
# running magnitude, so an f32 rounding difference in a gradient near its
# noise floor moves that entry by up to a fraction of the learning rate.

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu_torch.models import (
    optim, params_from_numpy, params_to_numpy)
from aiko_services_tpu_torch.models import transformer as torch_lm

CONFIG = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=64, dtype="float32")


@pytest.fixture(scope="module")
def lm():
    """(jax config, jax params, port config, numpy params, tokens)."""
    jax_config = jax_lm.TransformerConfig(**CONFIG)
    jax_params = jax_lm.init_params(jax_config, jax.random.PRNGKey(0))
    numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 17)).astype(
        np.int32)
    return (jax_config, jax_params, torch_lm.TransformerConfig(**CONFIG),
            numpy_params, tokens)


def _port_params(numpy_params):
    return params_from_numpy(numpy_params, device="cpu")


def _pairs(jax_tree, torch_tree):
    """(path, jax leaf, port leaf) for every leaf of the JAX tree."""
    torch_numpy = params_to_numpy(torch_tree)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        node = torch_numpy
        for key in path:
            node = node[key.key]
        yield jax.tree_util.keystr(path), np.asarray(leaf), node


def test_forward_logits_match_jax(lm):
    jax_config, jax_params, torch_config, numpy_params, tokens = lm
    expected = np.asarray(jax_lm.forward(jax_params, jax_config, tokens))
    actual = torch_lm.forward(_port_params(numpy_params), torch_config,
                              torch.from_numpy(tokens))
    assert actual.shape == (2, 17, 256) and actual.dtype == torch.float32
    np.testing.assert_allclose(actual.detach().numpy(), expected, atol=1e-5,
                               rtol=0)


def test_loss_and_every_gradient_leaf_match_jax(lm):
    jax_config, jax_params, torch_config, numpy_params, tokens = lm

    def jax_loss(params, tokens):
        logits = jax_lm.forward(params, jax_config, tokens[:, :-1])
        log_probs = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            log_probs, tokens[:, 1:, None], axis=-1)[..., 0])

    def torch_loss(params, tokens):
        logits = torch_lm.forward(params, torch_config, tokens[:, :-1])
        return optim.next_token_loss(logits, tokens[:, 1:])

    expected_loss, expected_grads = jax.value_and_grad(jax_loss)(
        jax_params, tokens)
    loss, grads = optim.value_and_grad(torch_loss,
                                       _port_params(numpy_params),
                                       torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(expected_loss), atol=1e-6,
                               rtol=0)
    leaves = list(_pairs(expected_grads, grads))
    assert len(leaves) == 11
    for name, expected, actual in leaves:
        np.testing.assert_allclose(actual, expected, atol=1e-6, rtol=0,
                                   err_msg=name)


def test_three_adamw_steps_match_optax(lm):
    jax_config, jax_params, torch_config, numpy_params, tokens = lm
    jax_optimizer = optax.adamw(1e-3)
    jax_step = jax_lm.make_train_step(jax_config, jax_optimizer)
    expected, jax_state = jax_params, jax_optimizer.init(jax_params)
    optimizer = optim.adamw(1e-3)
    params = _port_params(numpy_params)
    state = optimizer.init(params)
    step = torch_lm.make_train_step(torch_config, optimizer)
    for _ in range(3):
        expected, jax_state, expected_loss = jax_step(expected, jax_state,
                                                      tokens)
        params, state, loss = step(params, state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(expected_loss),
                                   atol=1e-5, rtol=0)
    for name, want, got in _pairs(expected, params):
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0,
                                   err_msg=name)


def test_train_step_reduces_loss(lm):
    _, _, torch_config, numpy_params, _ = lm
    params = torch_lm.init_params(torch_config,
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    optimizer = optim.adam(1e-2)
    state = optimizer.init(params)
    step = torch_lm.make_train_step(torch_config, optimizer)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 16)).astype(np.int32))
    losses = []
    for _ in range(5):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_remat_policies_give_bit_identical_losses(lm):
    _, _, torch_config, numpy_params, _ = lm
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 17)).astype(np.int32))
    losses = {}
    for policy in torch_lm.REMAT_POLICIES:
        params = _port_params(numpy_params)
        optimizer = optim.adamw(1e-3)
        state = optimizer.init(params)
        step = torch_lm.make_train_step(torch_config, optimizer,
                                        remat_policy=policy)
        trail = []
        for _ in range(3):
            params, state, loss = step(params, state, tokens)
            trail.append(loss.item())
        losses[policy] = trail
    assert len(losses) == 5
    for policy, trail in losses.items():
        assert trail == losses["none"], policy


def test_unknown_remat_policy_fails_fast(lm):
    torch_config = lm[2]
    with pytest.raises(ValueError, match="remat_policy"):
        torch_lm.make_train_step(torch_config, optim.adam(1e-3),
                                 remat_policy="dots_savable")
    assert "nothing_saveable" in torch_lm.REMAT_POLICIES


def test_init_params_tree_matches_jax_and_is_seeded(lm):
    _, jax_params, torch_config, _, _ = lm
    first = torch_lm.init_params(torch_config,
                                 torch.Generator().manual_seed(3),
                                 device="cpu")
    again = torch_lm.init_params(torch_config,
                                 torch.Generator().manual_seed(3),
                                 device="cpu")
    for name, want, got in _pairs(jax_params, first):
        assert got.shape == want.shape and got.dtype == want.dtype, name
    assert torch.equal(first["layers"]["wq"]["w"], again["layers"]["wq"]["w"])
    assert torch_lm.count_params(first) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(jax_params))


def test_constructors_default_to_cuda():
    from aiko_services_tpu_torch.models import asr, layers, load_pytree
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    asset = (pathlib.Path(__file__).parent / "assets"
             / "asr_tones.safetensors")
    constructors = {
        "init_params": lambda: torch_lm.init_params(
            torch_lm.TransformerConfig(**CONFIG), torch.Generator()),
        "init_asr_params": lambda: asr.init_asr_params(
            asr.AsrConfig(d_model=32, n_heads=2, vocab_size=64,
                          dtype="float32"), torch.Generator()),
        "params_from_numpy": lambda: params_from_numpy(
            {"w": np.zeros(3, np.float32)}),
        "load_pytree": lambda: load_pytree(asset),
    }
    for name, construct in constructors.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            construct()
    with pytest.raises(TypeError, match="device"):
        layers.init_dense(torch.Generator(), 2, 3)
    with pytest.raises(TypeError, match="device"):
        layers.init_norm(3)


def _int8_params(numpy_params):
    params = _port_params(numpy_params)
    params["layers"]["wq"] = {
        "w": params["layers"]["wq"]["w"].to(torch.int8),
        "w_scale": torch.ones((2, 1, 64))}
    return params


# what this slice does not port raises, never runs something else
UNPORTED = {
    "cache": lambda c, p, t: torch_lm.forward(p, c, t, cache={}),
    "pos": lambda c, p, t: torch_lm.forward(p, c, t, pos=3),
    "activation_specs": lambda c, p, t: torch_lm.forward(
        p, c, t, activation_specs=True),
    "sharded_train_step": lambda c, p, t: torch_lm.make_train_step(
        c, optim.adam(1e-3), sharded=True),
    "kv_dtype_int8": lambda c, p, t: torch_lm.forward(
        p, torch_lm.TransformerConfig(**CONFIG, kv_dtype="int8"), t),
    "n_experts": lambda c, p, t: torch_lm.init_params(
        torch_lm.TransformerConfig(**CONFIG, n_experts=4),
        torch.Generator(), device="cpu"),
    "sequence_parallel": lambda c, p, t: torch_lm.make_train_step(
        torch_lm.TransformerConfig(**CONFIG, sequence_parallel=True),
        optim.adam(1e-3)),
}


@pytest.mark.parametrize("option", sorted(UNPORTED) + ["int8_weights"])
def test_unported_options_raise(lm, option):
    _, _, torch_config, numpy_params, tokens = lm
    tokens = torch.from_numpy(tokens)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        if option == "int8_weights":
            torch_lm.forward(_int8_params(numpy_params), torch_config,
                             tokens)
        else:
            UNPORTED[option](torch_config, _port_params(numpy_params),
                             tokens)
