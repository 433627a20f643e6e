# The port's optimizers (models/optim.py) against optax on the CPU: the
# same numpy parameter tree and the same five numpy gradient trees go
# through optax's adam/adamw and the port's, and every update and every
# moment must agree.  f32 throughout, the same f32 formula rounded in
# another order at most: atol 1e-7 on the updates (order 1e-3) and the
# moments; the parameters (order 1-2, where one f32 ulp is up to 2.4e-7)
# within a couple of ulps of their value, rtol 2**-22 beside atol 1e-7.

import jax
import numpy as np
import optax
import pytest
import torch

from aiko_services_tpu_torch.models import optim


def _tree(rng, scale=1.0):
    return {"dense": {"w": (rng.standard_normal((6, 5)) * scale).astype(
                np.float32)},
            "norm": {"scale": (rng.standard_normal((5,)) * scale).astype(
                np.float32)},
            "stacked": {"w": (rng.standard_normal((2, 3, 4)) * scale
                              ).astype(np.float32)}}


def _torch(tree):
    return jax.tree_util.tree_map(lambda leaf: torch.from_numpy(leaf.copy()),
                                  tree)


def _numpy(tree):
    return jax.tree_util.tree_map(lambda leaf: np.asarray(leaf), tree)


def _assert_trees_close(actual, expected, atol, rtol=0.0):
    flat_expected = jax.tree_util.tree_flatten_with_path(expected)[0]
    for path, leaf in flat_expected:
        node = actual
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), atol=atol,
                                   rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


CASES = {
    "adam_defaults": (lambda: optax.adam(1e-3),
                      lambda: optim.adam(1e-3)),
    "adamw_defaults": (lambda: optax.adamw(1e-3),
                       lambda: optim.adamw(1e-3)),
    "adam_custom": (lambda: optax.adam(3e-2, b1=0.8, b2=0.99, eps=1e-6),
                    lambda: optim.adam(3e-2, b1=0.8, b2=0.99, eps=1e-6)),
    "adamw_custom": (
        lambda: optax.adamw(3e-2, b1=0.8, b2=0.99, eps=1e-6,
                            weight_decay=0.1),
        lambda: optim.adamw(3e-2, b1=0.8, b2=0.99, eps=1e-6,
                            weight_decay=0.1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_optax(case):
    make_optax, make_port = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    params = _tree(rng)
    grads = [_tree(rng, scale=10.0 ** -step) for step in range(5)]
    reference, port = make_optax(), make_port()
    reference_params, port_params = params, _torch(params)
    reference_state = reference.init(reference_params)
    port_state = port.init(port_params)
    for grad in grads:
        updates, reference_state = reference.update(
            grad, reference_state, reference_params)
        reference_params = optax.apply_updates(reference_params, updates)
        port_updates, port_state = port.update(_torch(grad), port_state,
                                               port_params)
        optim.apply_updates(port_params, port_updates)
        _assert_trees_close(port_updates, updates, atol=1e-7)
    _assert_trees_close(port_params, _numpy(reference_params), atol=1e-7,
                        rtol=2.0 ** -22)
    adam_state = reference_state[0]
    assert port_state["count"] == int(adam_state.count) == 5
    _assert_trees_close(port_state["mu"], adam_state.mu, atol=1e-7)
    _assert_trees_close(port_state["nu"], adam_state.nu, atol=1e-9)


def test_adamw_default_weight_decay_is_optax_not_torch():
    # a zero gradient leaves only the decay: -lr * 1e-4 * p
    params = {"w": torch.ones(3)}
    optimizer = optim.adamw(0.5)
    updates, _ = optimizer.update({"w": torch.zeros(3)},
                                  optimizer.init(params), params)
    np.testing.assert_allclose(updates["w"].numpy(), -0.5 * 1e-4, rtol=1e-6)


def test_moments_take_the_parameter_dtype_and_update_in_place():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    optimizer = optim.adamw(1e-3)
    state = optimizer.init(params)
    mu = state["mu"]["w"]
    assert mu.dtype == torch.bfloat16 and state["nu"]["w"].dtype == (
        torch.bfloat16)
    updates, state = optimizer.update(
        {"w": torch.full((4,), 2.0, dtype=torch.bfloat16)}, state, params)
    assert state["mu"]["w"] is mu and float(mu[0]) == pytest.approx(0.2,
                                                                    rel=1e-2)
    assert updates["w"].dtype == torch.bfloat16


def test_value_and_grad_gives_zeros_for_unused_leaves():
    params = {"used": torch.tensor([2.0]), "unused": torch.tensor([5.0])}
    loss, grads = optim.value_and_grad(
        lambda p: (p["used"] ** 2).sum(), params)
    assert float(loss) == 4.0
    assert float(grads["used"]) == 4.0 and float(grads["unused"]) == 0.0
    assert params["used"].grad is None
