# Optimizers and the train-step plumbing shared by the port's models.
#
# No counterpart file in the JAX package: it trains with optax, which the
# port does not import.  This is the port's own copy of what the JAX
# package uses from optax -- adam and adamw with optax's defaults and
# update rule -- plus the small pieces every train step shares:
#
#   adam, adamw      -- optax.adam / optax.adamw: init(params) and
#                       update(grads, state, params) -> (updates, state)
#   value_and_grad   -- jax.value_and_grad over a parameter tree, through
#                       loss.backward()
#   apply_updates    -- p + u.astype(p.dtype), IN PLACE: the counterpart
#                       of the JAX train steps' donate_argnums=(0, 1)
#   next_token_loss  -- the f32 next-token cross-entropy of the LM and ASR
#                       train steps
#
# Departures from optax: learning rates are floats (no schedules), and
# update() writes the new moments into the state's tensors in place (the
# optimizer state is donated in the JAX train steps, so no caller holds the
# old one).  Moments take each parameter's dtype (optax's mu_dtype=None).

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_map

__all__ = ["GradientTransformation", "adam", "adamw", "value_and_grad",
           "apply_updates", "next_token_loss"]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _unflatten(tree, leaves: list):
    iterator = iter(leaves)
    return tree_map(lambda _: next(iterator), tree)


def _scale_by_adam(learning_rate: float, b1: float, b2: float, eps: float,
                   weight_decay: float | None) -> GradientTransformation:
    """optax.chain(scale_by_adam(b1, b2, eps), [add_decayed_weights(
    weight_decay)], scale_by_learning_rate(learning_rate)), leaf by leaf
    in the parameters' dtype."""

    def init(params) -> dict:
        return {"count": 0,
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state: dict, params=None):
        if weight_decay is not None and params is None:
            raise ValueError("adamw needs params to decay")
        count = state["count"] + 1
        # optax computes 1 - decay**count in float32 and casts it to each
        # moment's dtype before dividing
        correction1 = float(np.float32(1) - np.float32(b1) ** count)
        correction2 = float(np.float32(1) - np.float32(b2) ** count)
        updates = []
        param_leaves = (tree_leaves(params) if params is not None
                        else [None] * len(tree_leaves(grads)))
        for grad, mu, nu, param in zip(tree_leaves(grads),
                                       tree_leaves(state["mu"]),
                                       tree_leaves(state["nu"]),
                                       param_leaves):
            mu.copy_((1 - b1) * grad + b1 * mu)
            nu.copy_((1 - b2) * (grad * grad) + b2 * nu)
            mu_hat = mu / torch.tensor(correction1, dtype=mu.dtype)
            nu_hat = nu / torch.tensor(correction2, dtype=nu.dtype)
            step = mu_hat / (torch.sqrt(nu_hat) + eps)
            if weight_decay is not None:
                step = step + weight_decay * param
            updates.append(-learning_rate * step)
        state = {"count": count, "mu": state["mu"], "nu": state["nu"]}
        return _unflatten(grads, updates), state

    return GradientTransformation(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: bias-corrected moments, eps outside the square root."""
    return _scale_by_adam(float(learning_rate), b1, b2, eps, None)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: adam plus weight decay decoupled from the moments,
    taken on the pre-update parameter of every leaf.  The default decay
    is optax's 1e-4, not torch.optim.AdamW's 1e-2."""
    return _scale_by_adam(float(learning_rate), b1, b2, eps,
                          float(weight_decay))


def value_and_grad(loss_fn: Callable, params, *arguments):
    """(loss, grads): loss_fn(params, *arguments) and its gradient with
    respect to every leaf of the parameter tree (zeros where a leaf does
    not reach the loss, as jax.grad gives).  The leaves are made to
    require grad; their .grad is left empty."""
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = loss_fn(params, *arguments)
    loss.backward()
    grads = []
    for leaf in leaves:
        grads.append(leaf.grad if leaf.grad is not None
                     else torch.zeros_like(leaf))
        leaf.grad = None
    return loss.detach(), _unflatten(params, grads)


@torch.no_grad()
def apply_updates(params, updates):
    """p + u.astype(p.dtype) for every leaf, written into p."""
    for param, update in zip(tree_leaves(params), tree_leaves(updates)):
        param.add_(update.to(param.dtype))
    return params


def next_token_loss(logits, targets):
    """Mean next-token cross-entropy in f32; targets clamp into the
    vocabulary (jnp.take_along_axis mode="clip")."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    index = targets.long().clamp(0, logits.shape[-1] - 1)[..., None]
    return -torch.mean(torch.gather(log_probs, -1, index)[..., 0])
