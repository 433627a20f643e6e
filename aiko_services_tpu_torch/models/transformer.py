# Decoder-only transformer LM (Llama-family architecture): the training
# and scoring part.
#
# Counterpart of aiko_services_tpu/models/transformer.py, cacheless path
# only: init_params, forward (a causal prefill over the whole sequence),
# the remat policies and make_train_step.  Same model, same parameter tree
# (layers stacked on a leading (L, ...) axis), same casts; PyTorch run
# eagerly on the device its tensors lie on.  jax.lax.scan over the stacked
# layers is a Python loop over layer slices, jax.checkpoint is
# torch.utils.checkpoint, and every attention goes through flash_attention
# (the hand-written Hopper kernels on CUDA, forward and backward).
#
# Not ported yet, and raising NotImplementedError when asked for: the KV
# cache (cache/pos, generate, decode_step, the paged and int8 KV paths),
# mixture of experts (n_experts > 0), sequence parallelism, sharding
# (activation_specs, sharded=True, param_specs) and int8 weights.

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from ..ops.device import resolve_device
from ..parallel.attention import flash_attention
from ..utils.tree import tree_map
from .asr import _layer_count, _stack, count_params
from .layers import (
    apply_rotary, dense, init_dense, init_norm, repeat_kv, rms_norm,
    rotary_embedding, swiglu)
from .optim import apply_updates, next_token_loss, value_and_grad

__all__ = ["TransformerConfig", "init_params", "forward", "make_train_step",
           "count_params", "REMAT_POLICIES", "resolve_remat_policy"]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1536
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # the JAX package's long-context path (ring / Ulysses attention over a
    # "seq" mesh axis): not yet ported
    sequence_parallel: bool = False
    sp_mechanism: str = "ring"
    # > 0: a switch mixture-of-experts FFN: not yet ported
    n_experts: int = 0
    moe_capacity_factor: float = 1.25
    # weight of the MoE load-balancing aux loss in make_train_step
    moe_aux_weight: float = 0.01
    moe_decode_gather: bool = True
    # "int8": an 8-bit KV cache: not yet ported ("" keeps the compute dtype)
    kv_dtype: str = ""

    def __post_init__(self):
        if self.sp_mechanism not in ("ring", "ulysses"):
            raise ValueError(
                f"sp_mechanism must be 'ring' or 'ulysses', got "
                f"{self.sp_mechanism!r}")
        if self.kv_dtype not in ("", "int8"):
            raise ValueError(
                f"kv_dtype must be '' (compute dtype) or 'int8', got "
                f"{self.kv_dtype!r}")
        if self.kv_dtype == "int8" and self.sequence_parallel:
            raise ValueError(
                "kv_dtype='int8' is not supported on the "
                "sequence-parallel decode path (sp_decode_attention "
                "reads the raw cache shards)")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to the torch port")


def _require_ported(config: TransformerConfig) -> None:
    if config.n_experts > 0:
        raise _not_ported("the mixture-of-experts FFN (n_experts > 0)")
    if config.sequence_parallel:
        raise _not_ported("sequence-parallel attention")
    if config.kv_dtype == "int8":
        raise _not_ported("the int8 KV cache (kv_dtype='int8')")


# -- parameters -------------------------------------------------------------

def _init_layer(generator: torch.Generator, config: TransformerConfig,
                device) -> dict:
    d, hd, ff = config.d_model, config.head_dim, config.d_ff
    dtype = config.torch_dtype
    return {
        "attn_norm": init_norm(d, dtype, device=device),
        "wq": init_dense(generator, d, config.n_heads * hd, dtype,
                         device=device),
        "wk": init_dense(generator, d, config.n_kv_heads * hd, dtype,
                         device=device),
        "wv": init_dense(generator, d, config.n_kv_heads * hd, dtype,
                         device=device),
        "wo": init_dense(generator, config.n_heads * hd, d, dtype,
                         device=device),
        "mlp_norm": init_norm(d, dtype, device=device),
        "w_gate": init_dense(generator, d, ff, dtype, device=device),
        "w_up": init_dense(generator, d, ff, dtype, device=device),
        "w_down": init_dense(generator, ff, d, dtype, device=device),
    }


def init_params(config: TransformerConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters drawn on the CPU from `generator` (seeded by the
    caller), cast to config.dtype and placed on `device`.  The draws
    follow the JAX package's distributions, not its numbers: embedding
    N(0, 0.02^2), dense weights N(0, 1/in_features), norm scales 1."""
    _require_ported(config)
    device = resolve_device(device)
    embed = (torch.randn((config.vocab_size, config.d_model),
                         generator=generator, dtype=torch.float32)
             * 0.02).to(device=device, dtype=config.torch_dtype)
    # each layer is drawn and stacked on the CPU, then moved once
    layers = _stack([_init_layer(generator, config, "cpu")
                     for _ in range(config.n_layers)])
    return {
        "embed": {"w": embed},
        "layers": tree_map(lambda leaf: leaf.to(device), layers),
        "norm_out": init_norm(config.d_model, config.torch_dtype,
                              device=device),
    }


def _unstack(stacked: dict) -> list:
    """The per-layer trees of a stacked (L, ...) layer tree, as views.
    One unbind per leaf, so the backward stacks the layers' gradients in
    one pass instead of scattering each into a zero (L, ...) tensor."""
    per_leaf = tree_map(torch.unbind, stacked)
    return [tree_map(lambda slices: slices[index], per_leaf)
            for index in range(_layer_count(stacked))]


# -- forward ----------------------------------------------------------------

def _attention(config: TransformerConfig, layer, h, cos, sin):
    """Causal self-attention over the whole sequence (the cacheless
    path): project, rotate, expand the KV heads, flash attention."""
    batch, length, _ = h.shape
    hd = config.head_dim
    q = dense(layer["wq"], h).reshape(
        batch, length, config.n_heads, hd).transpose(1, 2)
    k = dense(layer["wk"], h).reshape(
        batch, length, config.n_kv_heads, hd).transpose(1, 2)
    v = dense(layer["wv"], h).reshape(
        batch, length, config.n_kv_heads, hd).transpose(1, 2)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    repeats = config.n_heads // config.n_kv_heads
    # the kernels take contiguous (B, H, L, D) tensors only
    out = flash_attention(q.contiguous(),
                          repeat_kv(k, repeats).contiguous(),
                          repeat_kv(v, repeats).contiguous(), causal=True)
    out = out.transpose(1, 2).reshape(batch, length, -1)
    return dense(layer["wo"], out)


def _embed(params: dict, config: TransformerConfig, tokens):
    """Token embedding gather; out-of-vocab ids clamp to the table
    (jnp.take mode="clip")."""
    table = params["embed"]["w"]
    if table.dtype == torch.int8:
        raise _not_ported("int8 weights (quantize_weights_int8)")
    return table[tokens.clamp(0, table.shape[0] - 1)]


def _mlp_block(config: TransformerConfig, layer, mlp_in):
    """One layer's dense SwiGLU FFN.  Returns (output, aux = 0)."""
    out = swiglu(layer["w_gate"], layer["w_up"], layer["w_down"], mlp_in)
    return out, torch.zeros((), dtype=torch.float32, device=mlp_in.device)


def _lm_head(params: dict, config: TransformerConfig, h):
    """Output norm + f32 logits; an untied head when the tree carries
    one, the tied embedding otherwise."""
    h = rms_norm(params["norm_out"], h, config.norm_eps)
    head = params.get("lm_head", params["embed"])
    if head["w"].dtype == torch.int8:
        raise _not_ported("int8 weights (quantize_weights_int8)")
    return torch.einsum("bld,vd->blv", h.float(), head["w"].float())


def _layer_step(config: TransformerConfig, layer, h, cos, sin):
    h = h + _attention(config, layer,
                       rms_norm(layer["attn_norm"], h, config.norm_eps),
                       cos, sin)
    mlp_out, aux = _mlp_block(
        config, layer, rms_norm(layer["mlp_norm"], h, config.norm_eps))
    return h + mlp_out, aux


def forward(params: dict, config: TransformerConfig, tokens,
            cache: dict | None = None, pos: int = 0,
            activation_specs: bool = False, return_aux: bool = False,
            remat_policy: str | None = None):
    """tokens (B, L) int -> logits (B, L, V) f32: a causal prefill over
    the whole sequence (training / scoring).  return_aux=True also
    returns the mean MoE load-balancing loss across layers (0 for the
    dense FFN).  remat_policy names a REMAT_POLICIES entry wrapping each
    layer in torch.utils.checkpoint."""
    if cache is not None or pos != 0:
        raise _not_ported("forward with a KV cache (cache / pos)")
    if activation_specs:
        raise _not_ported("activation sharding (activation_specs)")
    _require_ported(config)
    context_fn = resolve_remat_policy(remat_policy)
    h = _embed(params, config, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = rotary_embedding(positions, config.head_dim,
                                config.rope_theta)
    cos, sin = cos[None, None], sin[None, None]  # (1, 1, L, hd/2)
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in _unstack(params["layers"]):
        if context_fn is None:
            h, aux = _layer_step(config, layer, h, cos, sin)
        else:
            h, aux = checkpoint(_layer_step, config, layer, h, cos, sin,
                                use_reentrant=False, context_fn=context_fn)
        aux_sum = aux_sum + aux
    logits = _lm_head(params, config, h)
    if return_aux:
        return logits, aux_sum / max(config.n_layers, 1)
    return logits


# -- training ---------------------------------------------------------------

# The JAX package's named jax.checkpoint_policies entries.  "none" keeps
# no checkpoint wrapper at all; the others recompute each layer's
# activations during the backward, saving what the policy names: nothing,
# everything, the outputs of every matmul (mm, addmm, bmm), or of the
# matmuls without a batch dimension (mm, addmm).  Remat changes when
# activations are computed, never what: losses are bit-identical across
# policies (tested).  Under a policy other than "none" the flash
# attention forward runs again in the backward, so its launches double.
REMAT_POLICIES = ("none", "everything_saveable", "nothing_saveable",
                  "dots_saveable", "dots_with_no_batch_dims_saveable")

_SAVED_OPS = {
    "dots_saveable": (torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default),
    "dots_with_no_batch_dims_saveable": (torch.ops.aten.mm.default,
                                         torch.ops.aten.addmm.default),
}


def _save_policy(name: str):
    saved = _SAVED_OPS.get(name)

    def policy(ctx, op, *args, **kwargs):
        if saved is None or op in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def resolve_remat_policy(name: str | None):
    """Remat-policy name -> the checkpoint's context_fn (None: don't wrap
    the layer at all)."""
    if name is None or name == "none":
        return None
    if name not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {name!r}; choose from "
            f"{REMAT_POLICIES}")
    if name == "nothing_saveable":
        return torch.utils.checkpoint.noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts,
                             _save_policy(name))


def make_train_step(config: TransformerConfig, optimizer,
                    sharded: bool = False,
                    remat_policy: str | None = None):
    """Returns train_step(params, opt_state, tokens) -> (params, opt_state,
    loss): next-token cross-entropy in f32 over tokens[:, :-1] ->
    tokens[:, 1:], plus moe_aux_weight * aux.  The update is written into
    params and opt_state in place (the JAX step donates both)."""
    if sharded:
        raise _not_ported("the sharded train step (sharded=True)")
    _require_ported(config)
    resolve_remat_policy(remat_policy)  # fail fast on typos

    def loss_fn(params, tokens):
        logits, aux = forward(params, config, tokens[:, :-1],
                              return_aux=True, remat_policy=remat_policy)
        return (next_token_loss(logits, tokens[:, 1:])
                + config.moe_aux_weight * aux)

    def train_step(params, opt_state, tokens):
        loss, grads = value_and_grad(loss_fn, params, tokens)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads
        apply_updates(params, updates)
        return params, opt_state, loss

    return train_step
