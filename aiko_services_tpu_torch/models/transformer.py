# Decoder-only transformer LM (Llama-family architecture): training,
# scoring, closed-batch greedy generation and the paged-KV steps of the
# continuous decode engine.
#
# Counterpart of aiko_services_tpu/models/transformer.py: init_params,
# forward (the causal prefill over the whole sequence, and the cached
# forward at `pos`), the remat policies, make_train_step, weight-only int8
# (quantize_weights_int8), the KV cache (init_cache, fp or int8), greedy
# generation (decode_step, generate, generate_stream) and the paged KV
# pool with its steps (init_paged_pool, paged_prefill, paged_decode_step,
# paged_verify_step, paged_prefill_chunk; decode/engine.py drives them).
# Same model, same parameter tree (layers stacked on a leading (L, ...)
# axis), same casts; PyTorch run eagerly on the device its tensors lie on.
# jax.lax.scan over the stacked layers is a Python loop over layer slices,
# jax.checkpoint is torch.utils.checkpoint, and every cacheless attention
# goes through flash_attention (the hand-written Hopper kernels on CUDA,
# forward and backward).  The cached and paged attentions are the JAX
# package's masked einsum (no Pallas kernel there either), here plain
# matmuls, one function for both; on the card the paged steps' windows of
# up to 16 rows over a bf16 pool take K4 instead (paged_decode_attention,
# below), which reads each slot's live blocks in place.
#
# The cache and the pool are written IN PLACE (the JAX package donates
# them to its jitted steps, so no caller keeps the old buffer); forward
# and the paged steps return them all the same, as the JAX package
# returns its updated cache and pool.  A paged step takes its positions
# as a device tensor and never reads one back, so the engine can capture
# it as a CUDA graph.
#
# The switch mixture-of-experts FFN (n_experts > 0: the router, the
# capacity dispatch, its dense oracle and the per-token weight gather of
# short windows) runs on every path through _mlp_block, as there: the
# train step with the load-balancing aux loss, the cached forward and
# generation, and the paged steps the decode engine drives.  Its products
# are plain matmuls, as the JAX package's are einsums outside any Pallas
# kernel.
#
# The long-context path (sequence_parallel=True) runs on the ambient mesh
# (parallel.use_mesh) with a "seq" axis: the cacheless prefill -- scoring
# and the train step, whose backward is the ring's -- through
# ring_attention or ulysses_attention (sp_mechanism), the cached prefill
# at pos 0 the same way over the fresh K/V, and cached decode through
# sp_decode_attention over the cache, its length sharded over "seq"
# (cache_specs(sequence_parallel=True)).  On the sharded path (below) a
# prefill's positions are cut over "seq" too, as the JAX package's
# activation spec cuts them: each position computes its block of the
# sequence and the ring's hops, Ulysses' all_to_alls and the sp decode's
# merge run on the position grids (parallel.attention's *_grid forms),
# so a "seq" axis may span processes; an SP call on an ambient mesh
# whose "seq" axis spans processes takes that path with whole
# parameters too.
#
# The parameter-sharding axes: param_specs / quantized_param_specs lay
# the tree out megatron-style (TP on "model", FSDP on "fsdp", experts on
# "expert"), cache_specs the cache (batch on "data", KV heads on "model",
# length on "seq"), and parallel.shard_pytree cuts them into Sharded
# leaves.  forward, generate, generate_stream, decode_step and the train
# step take such a tree as they take a whole one: with any Sharded leaf
# among the parameters, tokens or cache, they run the SHARDED path --
# explicit per-position code over the mesh's positions
# (parallel/collectives.py), each model shard running this module's own
# attention on its heads (the flash kernels, the ring or Ulysses over
# its "seq" line, the cached and sequence-parallel decode), the dense
# layers column- and row-parallel (models/layers.py) and the MoE FFN on
# its local experts, with the batch split over "data".  The logits come
# back whole on the mesh's home device.  Global-view semantics hold: the
# sharded call computes the unsharded one's function (in another
# summation order).

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass, replace

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from ..ops.device import resolve_device
from ..parallel.attention import (
    PAGED_HEAD_DIMS, PAGED_MAX_WINDOW, flash_attention,
    paged_decode_attention, ring_attention, ring_attention_grid,
    sp_decode_attention, sp_decode_grid, ulysses_attention,
    ulysses_attention_grid)
from ..parallel.collectives import (
    _link, all_gather, conform, join_backward, map_shards, psum)
from ..parallel.mesh import PartitionSpec as P
from ..parallel.mesh import (
    Sharded, ambient_mesh, assign, filter_specs, layout_matches,
    leaf_layout, shard_pytree, sharded_leaves, unshard)
from ..utils.tree import flatten_tensors, rebuild_tensors, tree_map
from .asr import _layer_count, _stack, count_params
from .layers import (
    ShardedCall, apply_rotary, column_parallel, dense, f32_reduction,
    init_dense, init_norm, repeat_kv, rms_norm, rotary_embedding,
    row_parallel, swiglu)
from .optim import apply_updates, next_token_loss, value_and_grad

__all__ = ["TransformerConfig", "init_params", "forward", "init_cache",
           "init_sp_cache", "cache_specs", "param_specs",
           "quantized_param_specs", "decode_step", "generate",
           "generate_stream", "make_train_step", "count_params",
           "quantize_weights_int8", "REMAT_POLICIES", "resolve_remat_policy",
           "init_paged_pool", "paged_prefill", "paged_decode_step",
           "paged_verify_step", "paged_prefill_chunk", "f32_head",
           "paged_gather_attention"]


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
    # True: the long-context path.  Prefill attention shards over the
    # ambient mesh's "seq" axis (mechanism below) and cached DECODE runs
    # sp_decode_attention with the cache length sharded over "seq" (lay
    # the cache out with cache_specs(sequence_parallel=True)).  Needs an
    # ambient mesh (parallel.use_mesh) whose "seq" axis divides the
    # sequence length (prefill) and the cache length (decode); cached
    # prefill needs pos=0.
    sequence_parallel: bool = False
    # "ring": K/V shards rotate around the ring (any head count; causal
    # hops skipped).  "ulysses": all-to-all swaps sequence sharding for
    # head sharding and runs flash attention on each head group --
    # fewer exchanges when n_heads divides by the seq axis.
    sp_mechanism: str = "ring"
    # > 0: a switch (top-1) mixture-of-experts FFN with n_experts experts
    n_experts: int = 0
    # expert capacity = ceil(moe_capacity_factor * L / E) tokens per batch
    # row and call; tokens past it are dropped (their FFN output is 0);
    # <= 0 runs the dense oracle (every expert computes every token)
    moe_capacity_factor: float = 1.25
    # weight of the MoE load-balancing aux loss in make_train_step
    moe_aux_weight: float = 0.01
    # windows shorter than n_experts (decode, verify) gather each token's
    # expert weights instead of dispatching by capacity
    moe_decode_gather: bool = True
    # "int8": the KV cache stores 8-bit codes + a per-(head, position) f32
    # scale, quantized once when a token is written ("" keeps the compute
    # dtype)
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


def param_specs(config: TransformerConfig, lm_head: bool = False) -> dict:
    """Megatron TP on "model" + FSDP on "fsdp" (+ EP on "expert" for the
    MoE weights); stacked-layer leaves carry a leading None for the layer
    axis.  wq, wk, wv, w_gate and w_up cut their output columns over
    "model", wo and w_down their input rows; "fsdp" takes the other
    dimension, and the model dimension of embed and lm_head.
    lm_head=True adds the untied head's spec."""
    layer = {
        "attn_norm": {"scale": P(None, None)},
        "wq": {"w": P(None, "fsdp", "model")},
        "wk": {"w": P(None, "fsdp", "model")},
        "wv": {"w": P(None, "fsdp", "model")},
        "wo": {"w": P(None, "model", "fsdp")},
        "mlp_norm": {"scale": P(None, None)},
    }
    if config.n_experts > 0:
        layer["router"] = {"w": P(None, None, None)}
        layer["w_gate"] = {"w": P(None, "expert", "fsdp", "model")}
        layer["w_up"] = {"w": P(None, "expert", "fsdp", "model")}
        layer["w_down"] = {"w": P(None, "expert", "model", "fsdp")}
    else:
        layer["w_gate"] = {"w": P(None, "fsdp", "model")}
        layer["w_up"] = {"w": P(None, "fsdp", "model")}
        layer["w_down"] = {"w": P(None, "model", "fsdp")}
    specs = {
        "embed": {"w": P(None, "fsdp")},
        "layers": layer,
        "norm_out": {"scale": P(None)},
    }
    if lm_head:
        specs["lm_head"] = {"w": P(None, "fsdp")}
    return specs


def quantized_param_specs(config: TransformerConfig,
                          lm_head: bool = False) -> dict:
    """param_specs + a spec per w_scale plane: its weight's layout with
    the quantization axis (kept as 1) unsharded -- -2 for the dense
    per-output-channel scales, -1 for the embed / lm_head per-row
    scales."""
    def scale_spec(spec: P, axis: int) -> P:
        entries = list(tuple(spec))
        entries[axis] = None
        return P(*entries)

    specs = param_specs(config, lm_head=lm_head)
    dense_keys = (_DENSE_QUANT_KEYS[:4] if config.n_experts > 0
                  else _DENSE_QUANT_KEYS)
    layer = dict(specs["layers"])
    for key in dense_keys:
        layer[key] = dict(layer[key])
        layer[key]["w_scale"] = scale_spec(layer[key]["w"], -2)
    specs["layers"] = layer
    for name in ("embed", "lm_head"):
        if name in specs:
            specs[name] = dict(specs[name])
            specs[name]["w_scale"] = scale_spec(specs[name]["w"], -1)
    return specs


# -- parameters -------------------------------------------------------------

def _init_layer(generator: torch.Generator, config: TransformerConfig,
                device) -> dict:
    d, hd, ff = config.d_model, config.head_dim, config.d_ff
    dtype = config.torch_dtype
    layer = {
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
    }
    if config.n_experts > 0:
        experts = config.n_experts

        def expert_weights(rows, cols):
            # N(0, 1/rows) per expert, stacked (E, rows, cols)
            weight = torch.randn((experts, rows, cols), generator=generator,
                                 dtype=torch.float32) / np.sqrt(rows)
            return {"w": weight.to(device=device, dtype=dtype)}

        layer["router"] = init_dense(generator, d, experts, dtype,
                                     device=device)
        layer["w_gate"] = expert_weights(d, ff)
        layer["w_up"] = expert_weights(d, ff)
        layer["w_down"] = expert_weights(ff, d)
    else:
        layer["w_gate"] = init_dense(generator, d, ff, dtype, device=device)
        layer["w_up"] = init_dense(generator, d, ff, dtype, device=device)
        layer["w_down"] = init_dense(generator, ff, d, dtype, device=device)
    return layer


def init_params(config: TransformerConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters drawn on the CPU from `generator` (seeded by the
    caller), cast to config.dtype and placed on `device`.  The draws
    follow the JAX package's distributions, not its numbers: embedding
    N(0, 0.02^2), dense weights N(0, 1/in_features), norm scales 1."""
    device = resolve_device(device)
    embed = (torch.randn((config.vocab_size, config.d_model),
                         generator=generator, dtype=torch.float32)
             * 0.02).to(device=device, dtype=config.torch_dtype)
    # each layer is drawn and stacked on the CPU, then moved once (on
    # the meta device, a shape trace, nothing is drawn)
    host = device if device.type == "meta" else torch.device("cpu")
    layers = _stack([_init_layer(generator, config, host)
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


# -- weight-only int8 (serving decode) ---------------------------------------

_DENSE_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_rows(entry: dict, axis: int) -> dict:
    """Symmetric absmax int8 over `axis`: codes round(w / scale), half to
    even (torch.round, as jnp.round), clipped to +-127, and an f32 scale
    kept at the weight's rank."""
    w = entry["w"].float()
    scale = torch.clamp_min(w.abs().amax(dim=axis, keepdim=True),
                            1e-12) / 127.0
    codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    out = {"w": codes, "w_scale": scale}
    if "b" in entry:
        out["b"] = entry["b"]
    return out


def quantize_weights_int8(params: dict, config: TransformerConfig) -> dict:
    """Weight-only int8 for serving: the dense weights become 8-bit codes
    and a per-output-channel f32 scale; embed / lm_head quantize per vocab
    row (one scale serves the gather and the logits product, where it
    factors out of the contraction).  Norms stay as they are; so do the
    MoE router and expert weights, whose products bypass dense(): with
    n_experts > 0 only wq, wk, wv and wo are quantized.  Not for
    training."""
    dense_keys = (_DENSE_QUANT_KEYS[:4] if config.n_experts > 0
                  else _DENSE_QUANT_KEYS)
    layers = dict(params["layers"])
    for key in dense_keys:
        layers[key] = _quantize_rows(layers[key], axis=-2)
    quantized = dict(params)
    quantized["layers"] = layers
    quantized["embed"] = _quantize_rows(params["embed"], axis=-1)
    if "lm_head" in params:
        quantized["lm_head"] = _quantize_rows(params["lm_head"], axis=-1)
    return quantized


# -- KV cache ---------------------------------------------------------------

def init_cache(config: TransformerConfig, batch: int,
               max_len: int | None = None, device="cuda") -> dict:
    """Zeroed cache (layers, batch, kv_heads, max_len, head_dim) on
    `device`: in the compute dtype, or int8 codes with f32 scale planes
    (..., max_len, 1) when config.kv_dtype is "int8"."""
    device = resolve_device(device)
    max_len = max_len or config.max_seq_len
    shape = (config.n_layers, batch, config.n_kv_heads, max_len,
             config.head_dim)
    if config.kv_dtype == "int8":
        scale_shape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale_shape, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(scale_shape, device=device)}
    return {"k": torch.zeros(shape, dtype=config.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=config.torch_dtype, device=device)}


def init_sp_cache(config: TransformerConfig, batch: int, max_len: int,
                  mesh=None, device="cuda") -> dict:
    """init_cache laid out for sequence-parallel decode: the length padded
    up to a multiple of the seq axis of `mesh` (default: the ambient
    mesh), which sp_decode_attention cuts it along
    (cache_specs(sequence_parallel=True))."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None or "seq" not in mesh.axis_names:
        raise ValueError("the sequence-parallel cache needs a mesh with a "
                         f"'seq' axis, got {mesh!r}")
    size = mesh.shape["seq"]
    return init_cache(config, batch, max_len=-(-max_len // size) * size,
                      device=device)


def cache_specs(sequence_parallel: bool = False,
                quantized: bool = False) -> dict:
    """Cache layout (layers, batch, kv_heads, len, head_dim): batch on
    "data", heads on "model"; with sequence_parallel the cache LENGTH
    also shards over "seq", so long-context decode spreads the cache over
    the mesh (sp_decode_attention).  quantized=True adds the int8 cache's
    per-position scale planes (same layout, head_dim collapsed)."""
    seq = "seq" if sequence_parallel else None
    spec = P(None, "data", "model", seq, None)
    if quantized:
        return {"k": spec, "k_scale": spec, "v": spec, "v_scale": spec}
    return {"k": spec, "v": spec}


def _quantize_kv(x):
    """(B, H, L, D) float -> (int8 codes, f32 scale (B, H, L, 1)):
    symmetric absmax per (batch, head, position) over head_dim; one
    rounding per written token, dequantized as codes * scale."""
    as_f32 = x.float()
    scale = torch.clamp_min(as_f32.abs().amax(dim=-1, keepdim=True),
                            1e-8) / 127.0
    codes = torch.clamp(torch.round(as_f32 / scale), -127, 127)
    return codes.to(torch.int8), scale


def _write_at(buffer, update, pos: int) -> None:
    """buffer[:, :, pos:pos + L] = update, in place, with the start
    clamped so that the update fits, as lax.dynamic_update_slice clamps
    it (a write past the end lands on the last L positions)."""
    length = update.shape[2]
    start = max(0, min(pos, buffer.shape[2] - length))
    buffer[:, :, start:start + length] = update


# -- forward ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _attention_scale(head_dim: int) -> float:
    """1 / sqrt(head_dim) taken in f32, as the JAX package takes it."""
    return (1.0 / torch.tensor(float(head_dim), device="cpu").sqrt()).item()


def _masked_attention(config: TransformerConfig, q, k_eff, v_eff, q_pos,
                      k_pos):
    """Attention of q over a whole K/V buffer, the JAX package's masked
    einsum: K/V heads expanded, q·kᵀ kept in f32 from bf16 operands,
    keys past each query's position (k_pos > q_pos, broadcast against
    the (B, H, Lq, Lk) logits) masked with -1e30, softmax in f32, the
    weights cast to V's dtype for the second product.  The cached and
    the paged paths both attend through here, so they cannot drift."""
    repeats = config.n_heads // config.n_kv_heads
    k_full = repeat_kv(k_eff, repeats)
    v_full = repeat_kv(v_eff, repeats)
    logits = torch.matmul(q.float(), k_full.float().transpose(-1, -2)) \
        * _attention_scale(config.head_dim)
    logits = logits.masked_fill(k_pos > q_pos, -1e30)
    weights = torch.softmax(logits, dim=-1)
    with f32_reduction():
        return torch.matmul(weights.to(v_full.dtype), v_full)


def _dequantized(codes, scale, dtype):
    """int8 KV codes x their f32 scale planes, cast to the compute dtype:
    the dequantization folded into the einsum operand load."""
    return (codes.float() * scale).to(dtype)


def _sp_prefill(config: TransformerConfig, q, k, v):
    """Causal sequence-parallel attention on the ambient mesh, K/V heads
    expanded: the ring or Ulysses (config.sp_mechanism)."""
    repeats = config.n_heads // config.n_kv_heads
    k, v = repeat_kv(k, repeats), repeat_kv(v, repeats)
    if config.sp_mechanism == "ulysses":
        return ulysses_attention(q, k, v, causal=True)
    return ring_attention(q, k, v, causal=True)


def _cached_attention(config: TransformerConfig, q, k, v, layer_cache,
                      pos: int, kv_index=None):
    """Write the new K/V at `pos` (quantized when the cache is int8),
    then masked attention of q over the whole cache buffer.  With
    sequence_parallel: a multi-token window (the cached PREFILL, pos 0
    only) attends over its fresh K/V through ring or Ulysses, and one
    token (decode) through sp_decode_attention over the cache.
    kv_index (a sharded call's straddling shard): the cache's KV head of
    each query head, in place of the grouped expansion."""
    if config.sequence_parallel and q.shape[2] > 1 and pos != 0:
        raise ValueError(
            "sequence-parallel cached prefill requires pos == 0 "
            f"(got pos={pos}); multi-token cached decode at "
            "pos > 0 is not supported on this path")
    cache_k, cache_v = layer_cache["k"], layer_cache["v"]
    quantized = cache_k.dtype == torch.int8
    if quantized:
        k, k_scale = _quantize_kv(k)
        v, v_scale = _quantize_kv(v)
        _write_at(layer_cache["k_scale"], k_scale, pos)
        _write_at(layer_cache["v_scale"], v_scale, pos)
    _write_at(cache_k, k, pos)
    _write_at(cache_v, v, pos)
    if config.sequence_parallel:
        if q.shape[2] > 1:
            return _sp_prefill(config, q, k, v)
        return sp_decode_attention(q, cache_k, cache_v, pos)
    if quantized:
        k_eff = _dequantized(cache_k, layer_cache["k_scale"], q.dtype)
        v_eff = _dequantized(cache_v, layer_cache["v_scale"], q.dtype)
    else:
        k_eff, v_eff = cache_k, cache_v
    if kv_index is not None:
        k_eff = k_eff.index_select(1, kv_index)
        v_eff = v_eff.index_select(1, kv_index)
        config = replace(config, n_kv_heads=config.n_heads)
    length, max_len = q.shape[2], cache_k.shape[2]
    q_pos = pos + torch.arange(length, device=q.device)[:, None]
    k_pos = torch.arange(max_len, device=q.device)[None, :]
    return _masked_attention(config, q, k_eff, v_eff, q_pos, k_pos)


def _heads(config: TransformerConfig, q, k, v, cos, sin):
    """Projections (B, L, H * hd) -> rotated q (B, H, L, hd) and k,
    unrotated v (B, Hkv, L, hd)."""
    batch, length, _ = q.shape
    hd = config.head_dim
    q = q.reshape(batch, length, config.n_heads, hd).transpose(1, 2)
    k = k.reshape(batch, length, config.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(batch, length, config.n_kv_heads, hd).transpose(1, 2)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v


def _project_qkv(config: TransformerConfig, layer, h, cos, sin):
    """h (B, L, d_model) -> rotated q (B, H, L, hd) and k, unrotated v
    (B, Hkv, L, hd)."""
    return _heads(config, dense(layer["wq"], h), dense(layer["wk"], h),
                  dense(layer["wv"], h), cos, sin)


def _flash(config: TransformerConfig, q, k, v):
    """Causal flash attention, K/V heads expanded; the kernels take
    contiguous (B, H, L, D) tensors only."""
    repeats = config.n_heads // config.n_kv_heads
    return flash_attention(q.contiguous(),
                           repeat_kv(k, repeats).contiguous(),
                           repeat_kv(v, repeats).contiguous(), causal=True)


def _merge_heads(out):
    """(B, H, L, hd) -> (B, L, H * hd)."""
    batch, _, length, _ = out.shape
    return out.transpose(1, 2).reshape(batch, length, -1)


def _attention(config: TransformerConfig, layer, h, cos, sin,
               layer_cache=None, pos: int = 0):
    """Self-attention: project, rotate, then either the causal prefill
    over the whole sequence (no cache: flash attention, K/V heads
    expanded; ring or Ulysses with sequence_parallel) or the cached path
    at `pos`."""
    q, k, v = _project_qkv(config, layer, h, cos, sin)
    if layer_cache is not None:
        out = _cached_attention(config, q, k, v, layer_cache, pos)
    elif config.sequence_parallel:
        out = _sp_prefill(config, q, k, v)
    else:
        out = _flash(config, q, k, v)
    return dense(layer["wo"], _merge_heads(out))


def _embed(params: dict, config: TransformerConfig, tokens):
    """Token embedding gather; out-of-vocab ids clamp to the table
    (jnp.take mode="clip").  An int8 table gathers its rows' scales
    alongside and dequantizes only the gathered tokens."""
    table = params["embed"]["w"]
    index = tokens.clamp(0, table.shape[0] - 1)
    h = table[index]
    if table.dtype == torch.int8:
        h = (h.float() * params["embed"]["w_scale"][index]).to(
            config.torch_dtype)
    return h


# -- switch mixture of experts ----------------------------------------------
#
# The JAX package's einsums take bf16 operands with
# preferred_element_type=float32: exact products summed in f32, the
# result never rounded to bf16.  A bf16 torch.matmul returns bf16, one
# rounding too many, so every expert product here takes its operands in
# f32 (exact for bf16 values) and keeps the f32 result; TF32 stays off
# (torch's default for matmuls).  One-hots are comparisons with an
# arange, never F.one_hot (it checks its range on the host) and nothing
# reads a value back, so the paged steps stay capturable as CUDA graphs.

def _f32_matmul(a, b):
    """a @ b with f32 operands and an f32 result."""
    return torch.matmul(a.float(), b.float())


def _one_hot(index, classes: int):
    """index (...) int -> (..., classes) f32, without a host check."""
    return (index[..., None] == torch.arange(
        classes, device=index.device)).float()


def _router(config: TransformerConfig, layer, x, with_probs: bool = False):
    """Top-1 router: (best (B, L) the chosen experts, mask1 (B, L, E) its
    one-hot, weight (B, L, 1) its router probability, aux the Switch
    load-balancing loss E * sum_e mean(mask1_e) * mean(prob_e)).  Logits
    in f32; argmax takes the first maximum, as jnp.argmax; mask1 carries
    no gradient, so aux's flows through the probabilities alone."""
    router_probs = torch.softmax(_f32_matmul(x, layer["router"]["w"]),
                                 dim=-1)                     # (B, L, E)
    best = torch.argmax(router_probs, dim=-1)                # (B, L)
    mask1 = _one_hot(best, config.n_experts)
    weight = torch.sum(router_probs * mask1, dim=-1, keepdim=True)
    fraction = mask1.mean(dim=(0, 1))
    prob_mass = router_probs.mean(dim=(0, 1))
    aux = config.n_experts * torch.sum(fraction * prob_mass)
    if with_probs:
        return best, mask1, weight, aux, router_probs
    return best, mask1, weight, aux


def _gated(gate, up):
    """SwiGLU's hidden activation, in the operands' dtype."""
    return torch.nn.functional.silu(gate) * up


def _oracle_mix(expert_out, mask1, shape):
    """The oracle's mix: expert_out (E, BL, D) f32 of every expert on
    every token, mask1 (B, L, E) the router's one-hots over the same
    experts -> each token's own expert's output, (B, L, D) f32."""
    mask = mask1.reshape(-1, mask1.shape[-1]).transpose(0, 1)[..., None]
    return torch.sum(expert_out * mask, dim=0).reshape(shape)


def _capacity(config: TransformerConfig, length: int) -> int:
    """C = min(L, max(1, ceil(cf * L / E))) tokens per expert and row."""
    return min(length, max(1, math.ceil(
        config.moe_capacity_factor * length / config.n_experts)))


def _dispatch(mask1, weight, capacity: int) -> tuple:
    """The capacity dispatch of the router's one-hots mask1 (B, L, E)
    and probabilities weight (B, L, 1): (disp, combine), both (B, L, E,
    C) f32 -- disp the 0/1 place of each kept token in its expert's
    queue, combine the same weighted by the router probability."""
    # each token's 1-based place in its expert's queue, per batch row
    # (an f32 cumsum of 0/1 values: exact below 2^24)
    position = torch.cumsum(mask1, dim=1) * mask1
    keep = mask1 * (position <= capacity)                    # (B, L, E)
    # a dropped token's index is 0, and keep zeroes its row
    disp = keep[..., None] * _one_hot(
        ((position - 1.0) * keep).to(torch.int64), capacity)  # (B, L, E, C)
    return disp, disp * weight[..., None]


def _expert_inputs(x, disp):
    """x (B, L, D) gathered into its experts' queues, (E, B, C, D): one
    nonzero term per sum, so exact in x's dtype."""
    return torch.einsum("bld,blec->ebcd", x, disp.to(x.dtype))


def _combined(expert_out, combine):
    """The experts' outputs (E, B, C, D) f32 scattered back to their
    tokens, weighted: (B, L, D) f32."""
    return torch.einsum("ebcd,blec->bld", expert_out, combine)


def _switch_moe_dense(config: TransformerConfig, layer, x):
    """The oracle: every expert computes every token, the router's one-hot
    picks the winner.  Exact (no capacity drops), E x the dense FFN."""
    _, mask1, weight, aux = _router(config, layer, x)
    rows = x.reshape(-1, x.shape[-1])
    gate = _f32_matmul(rows, layer["w_gate"]["w"])           # (E, BL, F)
    up = _f32_matmul(rows, layer["w_up"]["w"])
    expert_out = _f32_matmul(_gated(gate, up),
                             layer["w_down"]["w"])           # (E, BL, D)
    return (_oracle_mix(expert_out, mask1, x.shape) * weight).to(
        x.dtype), aux


def _switch_moe(config: TransformerConfig, layer, x):
    """Switch (top-1) FFN with capacity dispatch: each expert takes at
    most C = min(L, max(1, ceil(cf * L / E))) tokens of each batch row, in
    order; tokens past it are dropped (their output is exactly 0, the
    residual carries them).  A one-hot dispatch product gathers the kept
    tokens into (E, B, C, D), the FFN runs batched over experts, and a
    combine product weighted by the router probability scatters the
    results back.  Windows shorter than E gather each token's expert
    weights instead (moe_decode_gather); cf <= 0 runs the oracle.
    Returns (output (B, L, D), aux)."""
    if config.moe_capacity_factor <= 0:
        return _switch_moe_dense(config, layer, x)
    batch, length, d_model = x.shape
    experts = config.n_experts
    if length < experts and config.moe_decode_gather:
        return _switch_moe_gather(config, layer, x)
    capacity = _capacity(config, length)
    _, mask1, weight, aux = _router(config, layer, x)
    disp, combine = _dispatch(mask1, weight, capacity)
    expert_in = _expert_inputs(x, disp).reshape(
        experts, batch * capacity, d_model)
    gate = _f32_matmul(expert_in, layer["w_gate"]["w"])      # (E, BC, F)
    up = _f32_matmul(expert_in, layer["w_up"]["w"])
    hidden = _gated(gate, up).to(x.dtype)
    expert_out = _f32_matmul(hidden, layer["w_down"]["w"]).reshape(
        experts, batch, capacity, d_model)                   # f32
    return _combined(expert_out, combine).to(x.dtype), aux


def _switch_moe_gather(config: TransformerConfig, layer, x):
    """Per-token expert-weight gather for windows shorter than E (decode,
    verification): each token reads only its own expert's weights, one
    dense FFN of work and bytes a token, with no capacity limit."""
    best, _, weight, aux = _router(config, layer, x)
    w_gate = layer["w_gate"]["w"][best]                      # (B, L, D, F)
    w_up = layer["w_up"]["w"][best]
    w_down = layer["w_down"]["w"][best]                      # (B, L, F, D)
    rows = x[..., None, :]                                   # (B, L, 1, D)
    hidden = _gated(_f32_matmul(rows, w_gate),
                    _f32_matmul(rows, w_up)).to(x.dtype)
    out = _f32_matmul(hidden, w_down)[..., 0, :]             # (B, L, D)
    return (out * weight).to(x.dtype), aux


def _mlp_block(config: TransformerConfig, layer, mlp_in):
    """One layer's FFN, dense SwiGLU or switch MoE, shared by forward()
    and the paged steps.  Returns (output, aux; 0 for the dense FFN)."""
    if config.n_experts > 0:
        return _switch_moe(config, layer, mlp_in)
    out = swiglu(layer["w_gate"], layer["w_up"], layer["w_down"], mlp_in)
    return out, torch.zeros((), dtype=torch.float32, device=mlp_in.device)


def _head_logits(head: dict, h):
    """f32 logits of normed h against a head (or its block of the model
    dimension): an int8 head's per-row scales apply to the result (they
    factor out of the contraction)."""
    logits = torch.einsum("bld,vd->blv", h.float(), head["w"].float())
    if head["w"].dtype == torch.int8:
        logits = logits * head["w_scale"][:, 0]
    return logits


def _lm_head(params: dict, config: TransformerConfig, h):
    """Output norm + f32 logits; an untied head when the tree carries
    one, the tied embedding otherwise."""
    return _head_logits(params.get("lm_head", params["embed"]),
                        rms_norm(params["norm_out"], h, config.norm_eps))


def _layer_step(config: TransformerConfig, layer, h, cos, sin,
                layer_cache=None, pos: int = 0):
    h = h + _attention(config, layer,
                       rms_norm(layer["attn_norm"], h, config.norm_eps),
                       cos, sin, layer_cache, pos)
    mlp_out, aux = _mlp_block(
        config, layer, rms_norm(layer["mlp_norm"], h, config.norm_eps))
    return h + mlp_out, aux


def forward(params: dict, config: TransformerConfig, tokens,
            cache: dict | None = None, pos: int = 0,
            activation_specs: bool = False, return_aux: bool = False,
            remat_policy: str | None = None):
    """tokens (B, L) int -> logits (B, L, V) f32 [+ the cache].

    With cache=None: a causal prefill over the whole sequence (training /
    scoring); return_aux=True also returns the mean MoE load-balancing
    loss across layers (0 for the dense FFN), and remat_policy names a
    REMAT_POLICIES entry wrapping each layer in torch.utils.checkpoint
    (everything_saveable recomputes nothing, so it wraps nothing and
    runs as without remat).  On a mesh over several processes each
    layer is one node of the backward's chain of exchanges
    (_RematLayer): it keeps the layer's inputs and what the policy saves
    (the products, under the dots policies), and recomputes the rest,
    exchanges included, inside its backward.
    With a cache (init_cache): K/V are written at `pos` (an int or a 0-d
    tensor), in place, and (logits, cache) is returned -- the
    incremental-decode path."""
    if return_aux and cache is not None:
        raise ValueError(
            "return_aux is only meaningful on the cache-less (training/"
            "scoring) path; with a cache forward returns (logits, cache)")
    if remat_policy not in (None, "none") and cache is not None:
        raise ValueError(
            "remat_policy is only meaningful on the cache-less "
            "(training/scoring) path; incremental decode saves nothing "
            "by rematerializing")
    pos = int(pos)
    context_fn = resolve_remat_policy(remat_policy)
    mesh = _call_mesh(params, tokens, cache, activation_specs, config)
    if mesh is not None:
        # one scope for the whole call: the dense blocks' own scopes
        # then only count
        with f32_reduction():
            return _sharded_forward(mesh, params, config, tokens, cache,
                                    pos, return_aux, context_fn)
    h = _embed(params, config, tokens)
    positions = pos + torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = rotary_embedding(positions, config.head_dim,
                                config.rope_theta)
    cos, sin = cos[None, None], sin[None, None]  # (1, 1, L, hd/2)
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for index, layer in enumerate(_unstack(params["layers"])):
        if cache is not None:
            layer_cache = {name: buffer[index]
                           for name, buffer in cache.items()}
            h, aux = _layer_step(config, layer, h, cos, sin, layer_cache,
                                 pos)
        elif context_fn is None:
            h, aux = _layer_step(config, layer, h, cos, sin)
        else:
            h, aux = checkpoint(_layer_step, config, layer, h, cos, sin,
                                use_reentrant=False, context_fn=context_fn)
        aux_sum = aux_sum + aux
    logits = _lm_head(params, config, h)
    if cache is not None:
        return logits, cache
    if return_aux:
        return logits, aux_sum / max(config.n_layers, 1)
    return logits


# -- the sharded path --------------------------------------------------------
#
# Explicit per-position code over the mesh (parallel/collectives.py): each
# position holds its blocks of the parameters (param_specs' layout), its
# data block of the batch and its block of the cache (cache_specs), and
# runs this module's own functions on them with the shard's config (its
# heads: n_heads / model, n_kv_heads / model, head_dim kept).  Between
# the steps, the collectives of a megatron layer -- per layer, counted in
# tests/test_torch_sharding.py:
#   q/k/v   one psum over fsdp (the three partials fused)
#   wo      one psum over model, one all_gather over fsdp
#   gate/up one psum over fsdp (fused)
#   w_down  one psum over model, one all_gather over fsdp
# so a decode step issues 2 per layer on a model-only mesh (6 with fsdp),
# plus one all_gather over fsdp after the embedding gather and one psum
# over fsdp for the logits.  The MoE FFN adds one psum over expert (its
# local experts' outputs), the sequence-parallel attention the ring's
# ppermutes (one a hop), Ulysses' two all_to_alls or the sp decode's
# pmax and psum over "seq", and a cached prefill one all_gather over
# "seq" of its K/V blocks for the cache's windows.


def _call_mesh(params, tokens, cache, activation_specs: bool,
               config: TransformerConfig | None = None):
    """The mesh a call runs sharded on: that of its Sharded leaves
    (parameters, tokens, cache), else -- activation_specs=True, the JAX
    package's batch-on-"data" constraint -- the ambient mesh when it has
    an axis above 1, or the ambient mesh of a sequence-parallel call
    whose "seq" axis spans processes (each process computes its block of
    the sequence, as GSPMD spreads the JAX package's); None for the
    whole-tensor path."""
    for tree in (params, tokens, cache):
        for leaf in sharded_leaves(tree):
            return leaf.mesh
    mesh = ambient_mesh()
    if mesh is None:
        return None
    if activation_specs and any(size > 1 for size in mesh.shape.values()):
        return mesh
    if (config is not None and config.sequence_parallel
            and "seq" in mesh.process_axes):
        return mesh
    return None


def _call_layout(mesh, params, config: TransformerConfig) -> tuple:
    """(the call's view of the mesh, the parameters in the layout it
    computes on).  `cut` holds the sizes the parameter tree is cut by
    over model, fsdp and expert (1 for whole leaves), read off wq (and
    the MoE's w_gate); a tree with any leaf cut otherwise than
    param_specs' layout at those sizes is resharded once, counted, into
    param_specs' layout over the whole mesh (parallel.conform)."""
    call = ShardedCall(mesh)
    wq = leaf_layout(params["layers"]["wq"]["w"], mesh)
    call.cut = {"model": call.size["model"] if "model" in wq[2] else 1,
                "fsdp": call.size["fsdp"] if "fsdp" in wq[1] else 1,
                "expert": 1}
    if config.n_experts > 0:
        gate = leaf_layout(params["layers"]["w_gate"]["w"], mesh)
        if "expert" in gate[1]:
            call.cut["expert"] = call.size["expert"]
    quantized = "w_scale" in params["layers"]["wq"]
    specs = (quantized_param_specs if quantized else param_specs)(
        config, lm_head="lm_head" in params)
    if not layout_matches(params, specs, mesh, call.cut):
        call.cut = {"model": call.size["model"], "fsdp": call.size["fsdp"],
                    "expert": call.size["expert"] if config.n_experts > 0
                    else 1}
        params = conform(params, specs, mesh, call.cut)
    model = call.cut["model"]
    heads, kv_heads = config.n_heads, config.n_kv_heads
    group = heads // kv_heads
    local_heads = heads // model if heads % model == 0 else 0
    # each model shard takes whole query heads; the KV heads split with
    # them when they divide by the axis, else (fewer KV heads than
    # shards) every shard's query heads share one KV head, which it takes
    # from the gathered K/V projections and a cache whole over "model"
    call.kv_whole = kv_heads % model != 0
    call.group = group
    # Ulysses splits a "seq" line's heads over the line's positions
    ulysses = (call.size["seq"] if config.sequence_parallel
               and config.sp_mechanism == "ulysses" else 1)
    call.straddle = bool(not local_heads
                         or (call.kv_whole and group % local_heads)
                         or local_heads % ulysses)
    if call.straddle:
        # a shard's columns of wq cut a head, its heads span two KV
        # groups, or (Ulysses) they do not divide over the seq line: it
        # takes the whole heads its columns touch (and their KV heads)
        # from the gathered projections (_straddle_attend) -- every head
        # when even those do not divide over the line
        call.kv_whole = True
        call.config = config
        call.spans = _head_spans(config, model)
        if any((h1 - h0) % ulysses for h0, h1, _, _ in call.spans):
            call.spans = [(0, heads, 0, kv_heads)] * model
        call.local = config
        return call, params
    call.local = replace(config, d_model=config.head_dim * local_heads,
                         n_heads=local_heads,
                         n_kv_heads=1 if call.kv_whole
                         else kv_heads // model)
    return call, params


def _head_spans(config: TransformerConfig, model: int) -> list:
    """Per model index: (h0, h1, kv0, kv1), the query heads [h0, h1) that
    the shard's columns of wq touch, whole, and the KV heads [kv0, kv1)
    they use."""
    hd, group = config.head_dim, config.n_heads // config.n_kv_heads
    width = config.n_heads * hd // model
    spans = []
    for index in range(model):
        h0 = index * width // hd
        h1 = -(-(index + 1) * width // hd)
        spans.append((h0, h1, h0 // group, (h1 - 1) // group + 1))
    return spans


def _cache_spec(call: ShardedCall, config: TransformerConfig,
                split: bool) -> P:
    return filter_specs(P(None, "data" if split else None,
                          "model" if call.cut["model"] > 1
                          and not call.kv_whole else None,
                          "seq" if config.sequence_parallel else None,
                          None), call.mesh)


def _token_grid(call: ShardedCall, tokens):
    """The tokens' data blocks (ShardedCall.split_batch); tokens already
    cut over "data" keep their blocks."""
    if isinstance(tokens, Sharded):
        if (call.splits(tokens.shape[0])
                and leaf_layout(tokens, call.mesh)[:2] == (("data",), ())):
            call.split = True
            return call.grid(tokens)
        tokens = unshard(tokens)
    return call.split_batch(tokens)


def _placed_cache(call: ShardedCall, cache: dict,
                  config: TransformerConfig):
    """(the cache laid out as the call computes on it, the caller's cache
    to copy the writes back into -- None when it is that layout
    already).  A whole cache is placed; a Sharded one of another layout
    is resharded, counted (parallel.conform)."""
    specs = {name: _cache_spec(call, config, call.split) for name in cache}
    if not any(True for _ in sharded_leaves(cache)):
        return shard_pytree(cache, call.mesh, specs), cache
    if layout_matches(cache, specs, call.mesh, call.size):
        return cache, None
    return conform(cache, specs, call.mesh, call.size), cache


def _write_back(original: dict, placed: dict) -> None:
    """The writes of a call into `placed` copied into the caller's
    `original` cache (a whole or Sharded tree of another layout)."""
    for name, leaf in original.items():
        assign(leaf, unshard(placed[name]))


def _sharded_cache(mesh, params, config: TransformerConfig, batch: int,
                   max_len: int) -> dict:
    """A zeroed cache laid out by cache_specs for a sharded call (its
    length padded to divide the seq axis on the sequence-parallel
    path)."""
    call, _ = _call_layout(mesh, params, config)
    if config.sequence_parallel:
        size = call.size["seq"]
        max_len = -(-max_len // size) * size
    return shard_pytree(init_cache(config, batch, max_len=max_len,
                                   device=mesh.home),
                        mesh, {name: _cache_spec(call, config,
                                                 call.splits(batch))
                               for name in ("k", "k_scale", "v",
                                            "v_scale")})


def _write_window(layer_cache: dict, k, v, pos: int, offset: int,
                  total: int) -> None:
    """The part of K/V written at `pos` (its start clamped into the whole
    cache of length `total`, as _write_at clamps it) that falls into this
    block, [offset, offset + local length)."""
    length, local = k.shape[2], layer_cache["k"].shape[2]
    start = max(0, min(pos, total - length))
    low, high = max(start, offset), min(start + length, offset + local)
    if low < high:
        layer_cache["k"][:, :, low - offset:high - offset] = \
            k[:, :, low - start:high - start]
        layer_cache["v"][:, :, low - offset:high - offset] = \
            v[:, :, low - start:high - start]


def _check_seq(call: ShardedCall, pos: int) -> None:
    mesh = call.mesh
    if "seq" not in mesh.axis_names:
        raise ValueError(f"the sequence-parallel path needs a mesh with a "
                         f"'seq' axis, got axes {mesh.axis_names}")
    if call.length > 1 and pos != 0:
        raise ValueError(
            "sequence-parallel cached prefill requires pos == 0 "
            f"(got pos={pos}); multi-token cached decode at "
            "pos > 0 is not supported on this path")


def _sp_prefill_grid(call: ShardedCall, config: TransformerConfig, q, k,
                     v):
    """The causal ring or Ulysses (config.sp_mechanism) over the call's
    "seq" axis on grids of each position's block of the sequence, K/V
    heads expanded; the kernels take contiguous blocks."""
    repeats = config.n_heads // config.n_kv_heads
    q = map_shards(lambda x: x.contiguous(), q)
    k, v = (map_shards(lambda x: repeat_kv(x, repeats).contiguous(), grid)
            for grid in (k, v))
    attend = (ulysses_attention_grid if config.sp_mechanism == "ulysses"
              else ring_attention_grid)
    return attend(q, k, v, call.mesh, "seq", causal=True)


def _written(call: ShardedCall, k, v, caches, pos: int):
    """Each position's cache window with the fresh K/V written at `pos`
    (the part that falls into it); a prefill's K/V blocks, cut over
    "seq" like its positions but not like the cache's windows, meet
    first in one all_gather over "seq".  Returns the windows' k and v
    grids."""
    if call.seq_split:
        both = all_gather(map_shards(lambda k, v: torch.stack([k, v]), k, v),
                          call.mesh, "seq", dim=3)
        k = map_shards(lambda kv: kv[0], both)
        v = map_shards(lambda kv: kv[1], both)
    parts = call.size["seq"]

    def write(k, v, cache, index):
        local_len = cache["k"].shape[2]
        _write_window(cache, k, v, pos, index * local_len,
                      local_len * parts)
        return cache
    written = map_shards(write, k, v, caches, call.index["seq"])
    return (map_shards(lambda cache: cache["k"], written),
            map_shards(lambda cache: cache["v"], written))


def _sharded_attend(call: ShardedCall, qkv, layer_cache, pos: int):
    """Each model shard's attention over its heads -> (B, L, H/M * hd)
    per position: flash attention, the cached path, or -- on the
    sequence-parallel path -- the ring / Ulysses over the position's
    "seq" line on its block of the sequence, and the sp decode over the
    line's cache windows."""
    local = call.local
    if not local.sequence_parallel:
        if layer_cache is None:
            out = map_shards(lambda t: _flash(local, *t), qkv)
        else:
            out = map_shards(lambda t, c: _cached_attention(
                local, *t, c, pos), qkv, layer_cache)
        return map_shards(_merge_heads, out)
    _check_seq(call, pos)
    q, k, v = (map_shards(lambda t, part=part: t[part], qkv)
               for part in range(3))
    if layer_cache is not None:
        cache_k, cache_v = _written(call, k, v, layer_cache, pos)
    if layer_cache is None or call.length > 1:
        return map_shards(_merge_heads, _sp_prefill_grid(call, local, q, k,
                                                         v))
    return map_shards(_merge_heads, sp_decode_grid(q, cache_k, cache_v, pos,
                                                   call.mesh, "seq"))


def _sharded_moe(call: ShardedCall, layer, x):
    """The switch FFN on each position's local experts (E / expert) with
    their fsdp / model blocks: the router and the dispatch (the helpers
    of the unsharded FFN) are computed per data block, each position runs
    its experts' share, and the experts' outputs meet in one psum over
    "expert"."""
    config = call.local
    experts = config.n_experts
    local_experts = experts // call.cut["expert"]
    expert_index = (call.index["expert"] if call.cut["expert"] > 1
                    else map_shards(lambda device: 0,
                                   call.mesh.local_devices))
    routed = map_shards(lambda p, x: _router(config, {"router": p}, x,
                                             with_probs=True),
                        layer["router"], x)
    # each expert block widened to f32 once, shared by every data block
    # (the unsharded products widen the whole weight per call)
    w_gate, w_up, w_down = (map_shards(lambda p: p["w"].float(), layer[name])
                            for name in ("w_gate", "w_up", "w_down"))

    def own(tensor, index, dim=0):
        return tensor.narrow(dim, index * local_experts, local_experts)

    def gate_up(rows, wg, wu):
        return torch.cat([torch.matmul(rows, wg), torch.matmul(rows, wu)],
                         -1)

    def hidden(parts, cast: bool = True):
        """The gate/up partials summed over fsdp -> SwiGLU's hidden (in
        the activation's dtype, or f32 for the oracle)."""
        def gated(both, x):
            out = _gated(*torch.chunk(both, 2, dim=-1))
            return out.to(x.dtype) if cast else out
        return map_shards(gated, call.psum(parts, "fsdp"), x)

    def down(hid, wd, pick=None):
        """The w_down products, psummed over model, gathered over fsdp."""
        if pick is None:
            partial = map_shards(lambda h, w: torch.matmul(h.float(), w),
                                 hid, wd)
        else:
            partial = map_shards(lambda h, w, p: torch.matmul(
                h.float(), w[p[0]])[..., 0, :], hid, wd, pick)
        return call.all_gather(call.psum(partial, "model"), "fsdp")

    x_part = call.slice_axis(x, "fsdp")
    length = next(t for t in x.flat if t is not None).shape[1]
    if config.moe_capacity_factor <= 0:
        hid = hidden(map_shards(lambda x_part, wg, wu: gate_up(
            x_part.reshape(-1, x_part.shape[-1]).float(), wg, wu),
            x_part, w_gate, w_up), cast=False)
        mixed = call.psum(map_shards(
            lambda out, r, x, index: _oracle_mix(out, own(r[1], index, 2),
                                                 x.shape),
            down(hid, w_down), routed, x, expert_index), "expert")
        out = map_shards(lambda m, r, x: (m * r[2]).to(x.dtype), mixed,
                         routed, x)
    elif length < experts and config.moe_decode_gather:
        def chosen(r, index):
            local = r[0] - index * local_experts
            valid = (local >= 0) & (local < local_experts)
            return local.clamp(0, local_experts - 1), valid
        picks = map_shards(chosen, routed, expert_index)
        hid = hidden(map_shards(
            lambda x_part, wg, wu, pick: gate_up(
                x_part[..., None, :].float(), wg[pick[0]], wu[pick[0]]),
            x_part, w_gate, w_up, picks))
        mine = call.psum(map_shards(lambda d, pick: d * pick[1][..., None],
                                    down(hid, w_down, picks), picks),
                         "expert")
        out = map_shards(lambda o, r, x: (o * r[2]).to(x.dtype), mine,
                         routed, x)
    else:
        capacity = _capacity(config, length)

        def dispatch(r, x):
            disp, combine = _dispatch(r[1], r[2], capacity)
            return combine, _expert_inputs(x, disp)
        dispatched = map_shards(dispatch, routed, x)
        expert_in = call.slice_axis(map_shards(
            lambda d, index: own(d[1], index), dispatched, expert_index),
            "fsdp")
        hid = hidden(map_shards(lambda ein, wg, wu: gate_up(
            ein.reshape(ein.shape[0], -1, ein.shape[-1]).float(), wg, wu),
            expert_in, w_gate, w_up))

        def combine(expert_out, d, x, index):
            return _combined(expert_out.reshape(
                local_experts, x.shape[0], capacity, x.shape[-1]),
                own(d[0], index, dim=2))
        mine = call.psum(map_shards(combine, down(hid, w_down), dispatched,
                                    x, expert_index), "expert")
        out = map_shards(lambda o, x: o.to(x.dtype), mine, x)
    return out, _sharded_aux(call, routed)


def _sharded_aux(call: ShardedCall, routed):
    """The load-balancing loss over the WHOLE batch: each data block's
    sums of the router's one-hots and probabilities, psummed over
    "data" when the batch is split there; the first position's sums
    (ShardedCall.first: one live copy across processes)."""
    sums = map_shards(lambda r: torch.stack([r[1].sum(dim=(0, 1)),
                                            r[4].sum(dim=(0, 1))]), routed)
    if call.split:
        sums = psum(sums, call.mesh, "data")
    total = call.first(sums).to(call.home)
    rows = next(r for r in routed.flat if r is not None)[1]
    count = rows.shape[0] * rows.shape[1] * (call.size["data"]
                                             if call.split else 1)
    fraction, prob_mass = total / count
    return call.local.n_experts * torch.sum(fraction * prob_mass)


def _whole_kv(call: ShardedCall, q, k, v, layer_cache):
    """Fewer KV heads than model shards: the K/V projections' model
    blocks gather (one all_gather over model), and each position keeps
    the one KV head its query heads use -- of the projections and of the
    cache, which is whole over "model"."""
    config = call.local
    both = call.all_gather(map_shards(lambda k, v: torch.cat([k, v], -1),
                                      k, v), "model")
    hd = config.head_dim

    def head(index):
        return (index * config.n_heads) // call.group

    def pick(kv, m, which):
        # the gather interleaves the shards' [k | v] blocks
        whole = kv.unflatten(-1, (call.cut["model"], 2, -1))[..., which, :]
        return whole.flatten(-2).narrow(-1, head(m) * hd, hd)

    k = map_shards(lambda kv, m: pick(kv, m, 0), both, call.index["model"])
    v = map_shards(lambda kv, m: pick(kv, m, 1), both, call.index["model"])
    if layer_cache is not None:
        layer_cache = map_shards(lambda c, m: {
            name: tensor.narrow(1, head(m), 1)
            for name, tensor in c.items()}, layer_cache,
            call.index["model"])
    return q, k, v, layer_cache


def _straddle_attend(call: ShardedCall, q, k, v, rope, layer_cache,
                     pos: int):
    """Attention on a model axis whose shards' columns of wq cut heads
    (or whose heads span two KV groups) -> each position's own columns
    of O, (B, L, H * hd / M).  K1 takes whole heads only, so the shards'
    q/k/v blocks meet in one all_gather over model, each position runs
    the whole heads its columns touch (_head_spans; at most two of them
    partly its own) with their KV heads, on the cache whole over "model"
    when there is one, and keeps its own columns for the row-parallel
    wo.  On the sequence-parallel path those heads go through the ring,
    Ulysses or the sp decode over the position's "seq" line
    (_straddle_sp)."""
    config = call.config
    hd, model = config.head_dim, call.cut["model"]
    width = config.n_heads * hd // model
    widths = [next(t for t in grid.flat if t is not None).shape[-1]
              for grid in (q, k, v)]
    gathered = call.all_gather(map_shards(
        lambda q, k, v: torch.cat([q, k, v], -1), q, k, v), "model")

    def heads(both, r, index):
        """(config of the heads, q, k, v, each head's KV head) of the
        whole heads [h0, h1) the position's columns touch."""
        h0, h1, kv0, kv1 = call.spans[index]
        blocks = both.unflatten(-1, (model, -1))
        q_all, k_all, v_all = (
            part.flatten(-2) for part in torch.split(blocks, widths, -1))
        local = replace(config, d_model=hd * (h1 - h0), n_heads=h1 - h0,
                        n_kv_heads=kv1 - kv0)
        qh, kh, vh = _heads(local, q_all[..., h0 * hd:h1 * hd],
                            k_all[..., kv0 * hd:kv1 * hd],
                            v_all[..., kv0 * hd:kv1 * hd], *r)
        kv_index = torch.tensor([head // call.group - kv0
                                 for head in range(h0, h1)],
                                device=qh.device)
        return local, qh, kh, vh, kv_index

    def own(out, index):
        h0 = call.spans[index][0]
        return _merge_heads(out).narrow(-1, index * width - h0 * hd, width)

    parts = map_shards(heads, gathered, rope, call.index["model"])
    if config.sequence_parallel:
        return map_shards(own, _straddle_sp(call, parts, layer_cache, pos),
                          call.index["model"])
    caches = (layer_cache if layer_cache is not None
              else np.full(call.mesh.devices.shape, None, dtype=object))

    def attend(part, cache, index):
        local, qh, kh, vh, kv_index = part
        kv0, kv1 = call.spans[index][2:]
        if cache is None:
            out = flash_attention(
                qh.contiguous(), kh.index_select(1, kv_index).contiguous(),
                vh.index_select(1, kv_index).contiguous(), causal=True)
        else:
            out = _cached_attention(
                local, qh, kh, vh, {name: tensor.narrow(1, kv0, kv1 - kv0)
                                    for name, tensor in cache.items()},
                pos, kv_index=kv_index)
        return own(out, index)

    return map_shards(attend, parts, caches, call.index["model"])


def _straddle_sp(call: ShardedCall, parts, layer_cache, pos: int):
    """_straddle_attend's heads on the sequence-parallel path -> each
    position's (B, h1 - h0, L, hd): every position of a "seq" line has
    one model index, so one set of whole heads, which runs through the
    ring or Ulysses (a prefill, on the position's block of the sequence)
    or the sp decode over the line's cache windows of its KV heads (one
    token), each query head against its own KV head (K/V expanded by
    kv_index, as the dense path expands them)."""
    _check_seq(call, pos)
    config = next(part for part in parts.flat if part is not None)[0]
    config = replace(config, n_kv_heads=config.n_heads)
    q = map_shards(lambda part: part[1], parts)
    if layer_cache is not None:
        def own(part, cache, model_index):
            kv0, kv1 = call.spans[model_index][2:]
            return {name: cache[name].narrow(1, kv0, kv1 - kv0)
                    for name in ("k", "v")}
        cache_k, cache_v = _written(
            call, map_shards(lambda part: part[2], parts),
            map_shards(lambda part: part[3], parts),
            map_shards(own, parts, layer_cache, call.index["model"]), pos)
    if layer_cache is None or call.length > 1:
        k, v = (map_shards(lambda part, which=which: part[which]
                           .index_select(1, part[4]), parts)
                for which in (2, 3))
        return _sp_prefill_grid(call, config, q, k, v)
    k, v = (map_shards(lambda part, cache: cache.index_select(1, part[4]),
                       parts, grid) for grid in (cache_k, cache_v))
    return sp_decode_grid(q, k, v, pos, call.mesh, "seq")


def _sharded_layer(call: ShardedCall, layer, h, rope, layer_cache,
                   pos: int):
    """One transformer layer on the shards: (h grid, aux)."""
    local = call.local
    eps = local.norm_eps
    normed = map_shards(lambda p, x: rms_norm(p, x, eps),
                        layer["attn_norm"], h)
    q, k, v = column_parallel(call, [layer["wq"], layer["wk"], layer["wv"]],
                              normed)
    if call.straddle:
        out = _straddle_attend(call, q, k, v, rope, layer_cache, pos)
    else:
        if call.kv_whole:
            q, k, v, layer_cache = _whole_kv(call, q, k, v, layer_cache)
        qkv = map_shards(lambda q, k, v, r: _heads(local, q, k, v, *r),
                         q, k, v, rope)
        out = _sharded_attend(call, qkv, layer_cache, pos)
    h = map_shards(torch.add, h, row_parallel(call, layer["wo"], out))
    normed = map_shards(lambda p, x: rms_norm(p, x, eps),
                        layer["mlp_norm"], h)
    if local.n_experts > 0 and call.seq_split:
        # the capacity dispatch counts each expert's tokens along the
        # whole row: the FFN runs on the whole sequence, gathered over
        # "seq", and each position keeps its block
        mlp, aux = _sharded_moe(call, layer, all_gather(
            normed, call.mesh, "seq", dim=1))
        block = call.length // call.size["seq"]
        mlp = map_shards(lambda out, index: out.narrow(
            1, index * block, block), mlp, call.index["seq"])
    elif local.n_experts > 0:
        mlp, aux = _sharded_moe(call, layer, normed)
    else:
        gate, up = column_parallel(call, [layer["w_gate"], layer["w_up"]],
                                   normed)
        mlp = row_parallel(call, layer["w_down"], map_shards(
            _gated, gate, up))
        aux = torch.zeros((), dtype=torch.float32, device=call.home)
    return map_shards(torch.add, h, mlp), aux.to(call.home)


def _sharded_forward(mesh, params, config: TransformerConfig, tokens,
                     cache, pos: int, return_aux: bool, context_fn):
    """forward() on the mesh: the same results, computed on the shards.
    On the sequence-parallel path a prefill's positions are cut over
    "seq" (the JAX package's activation spec): each position embeds,
    projects and runs the FFN on its block of the sequence, and its
    attention is the ring's or Ulysses' over the "seq" line."""
    call, params = _call_layout(mesh, params, config)
    grids = call.dicts(params)
    token_grid = _token_grid(call, tokens)
    call.length = length = tokens.shape[1]
    seq = call.size["seq"]
    call.seq_split = bool(config.sequence_parallel and seq > 1
                          and length > 1)
    block = length
    if call.seq_split:
        if length % seq:
            raise ValueError(f"sequence-parallel prefill: sequence length "
                             f"({length}) must be divisible by mesh axis "
                             f"'seq' size ({seq})")
        block = length // seq
        token_grid = map_shards(lambda t, index: t.narrow(
            1, index * block, block), token_grid, call.index["seq"])
    whole_cache = None
    if cache is not None:
        cache, whole_cache = _placed_cache(call, cache, config)
        cache_grid = call.dicts(cache)
    h = call.all_gather(map_shards(
        lambda table, t: _embed({"embed": table}, config, t),
        grids["embed"], token_grid), "fsdp")

    def rope(device, index):
        start = pos + (index * block if call.seq_split else 0)
        cos, sin = rotary_embedding(
            start + torch.arange(block, device=device), config.head_dim,
            config.rope_theta)
        return cos[None, None], sin[None, None]
    # positions that share a block share its rope (and what is computed
    # from it)
    rotary = map_shards(rope, mesh.local_devices, call.index["seq"]
                        if call.seq_split else np.full(mesh.devices.shape,
                                                       0, dtype=object))
    aux_sum = torch.zeros((), dtype=torch.float32, device=call.home)
    for index in range(config.n_layers):
        layer = call.layer(grids["layers"], index)
        layer_cache = (None if cache is None
                       else call.layer(cache_grid, index))
        if context_fn is None or cache is not None:
            h, aux = _sharded_layer(call, layer, h, rotary, layer_cache,
                                    pos)
        elif mesh.processes is not None:
            h, aux = _remat_across(call, layer, h, rotary, pos, context_fn)
        else:
            h, aux = checkpoint(_sharded_layer, call, layer, h, rotary,
                                None, pos, use_reentrant=False,
                                context_fn=context_fn)
        aux_sum = aux_sum + aux
    normed = map_shards(lambda p, x: rms_norm(p, x, config.norm_eps),
                        grids["norm_out"], h)
    # the head's model dimension is cut over fsdp: each block's logits
    # (an int8 block's row scales applied) are partial sums
    logits = call.psum(map_shards(
        _head_logits, grids.get("lm_head", grids["embed"]),
        call.slice_axis(normed, "fsdp")), "fsdp")
    logits = call.gather_home(logits)
    if whole_cache is not None:
        _write_back(whole_cache, cache)
        cache = whole_cache
    if cache is not None:
        return logits, cache
    if return_aux:
        return logits, aux_sum / max(config.n_layers, 1)
    return logits


# -- remat on a mesh over several processes ----------------------------------
#
# torch.utils.checkpoint recomputes a layer when the backward first
# unpacks one of its saved tensors, at a point the autograd engine
# chooses; on a mesh over several processes the recomputed forward's
# exchanges must run at one point on every process.  So there the layer
# is a node of the mesh's chain of cross-process backward collectives
# (_RematLayer): its forward runs the layer under the policy's forward
# context.  A selective-checkpoint context (the dots policies) keeps the
# outputs of the operations the policy saves; it pairs them with the
# recompute's by order, so that forward runs with autograd on detached
# inputs as the recompute does, and its graph is dropped at once.
# nothing_saveable's no-op context pairs nothing, so its forward runs
# without autograd and holds no graph.  The backward -- at the layer's
# place in the chain -- runs the
# layer again with autograd under the recompute context, which hands
# those outputs back in place of recomputing them while every other
# operation runs again (every exchange counted and checked as in the
# forward), then that graph's backward, its own collectives ordered by a
# chain of their own joined into the layer's outputs; the mesh's chain
# is restored after.  The gradients are the same under every policy
# (remat changes when activations are computed, never what); the memory
# kept is the inputs and the saved set (nothing_saveable: the inputs
# alone).  everything_saveable wraps nothing (resolve_remat_policy).


class _RematLayer(torch.autograd.Function):

    @staticmethod
    def run(call, template, pos, context, tensors, fresh: bool = True):
        """The layer under `context` on `tensors`, with autograd unless
        this is a forward (fresh) under a no-op context (fresh: detached
        here, and run on a chain of its own that nothing joins, the
        mesh's restored after)."""
        mesh = call.mesh
        grad = not (fresh and isinstance(context, contextlib.nullcontext))
        if fresh:
            tensors = [tensor.detach().requires_grad_(tensor.requires_grad)
                       for tensor in tensors]
            outer, mesh.chain = mesh.chain, None
        try:
            with torch.set_grad_enabled(grad), context:
                return _sharded_layer(
                    call, *rebuild_tensors(template, tensors), None, pos)
        finally:
            if fresh:
                mesh.chain = outer

    @staticmethod
    def forward(ctx, call, template, pos, holder, context_fn, chain, token,
                *tensors):
        saving, ctx.recompute = context_fn()
        h, aux = _RematLayer.run(call, template, pos, saving, tensors)
        outputs: list = []
        holder["h"] = flatten_tensors(h, outputs)
        outputs = [tensor.detach() for tensor in outputs]
        aux = aux.detach()
        ctx.call, ctx.template, ctx.pos = call, template, pos
        ctx.state = chain.state
        ctx.save_for_backward(*tensors)
        return torch.zeros(()), aux, *outputs

    @staticmethod
    def backward(ctx, _, grad_aux, *grads):
        ctx.state.spent = True
        mesh = ctx.call.mesh
        inputs = [tensor.detach().requires_grad_(tensor.requires_grad)
                  for tensor in ctx.saved_tensors]
        outer = mesh.chain
        mesh.chain = None
        try:
            with torch.enable_grad():
                h, aux = _RematLayer.run(ctx.call, ctx.template, ctx.pos,
                                         ctx.recompute, inputs, fresh=False)
                outputs: list = []
                flatten_tensors(h, outputs)
                roots = [join_backward(aux, mesh), *outputs]
                pairs = [(root, grad) for root, grad in zip(
                    roots, (grad_aux, *grads)) if root.requires_grad]
                torch.autograd.backward([root for root, _ in pairs],
                                        [grad for _, grad in pairs])
        finally:
            mesh.chain = outer
        return (None,) * 6 + (torch.zeros(()),) + tuple(
            tensor.grad if tensor.requires_grad else None
            for tensor in inputs)


def _remat_across(call: ShardedCall, layer, h, rotary, pos: int,
                  context_fn):
    """One layer under remat on a mesh over several processes: a
    _RematLayer node in the mesh's chain, saving what `context_fn` (the
    policy's, resolve_remat_policy) saves.  Returns (h grid, aux)."""
    tensors: list = []
    template = flatten_tensors((layer, h, rotary), tensors)
    holder: dict = {}
    chain, token = _link(call.mesh)
    token, aux, *outputs = _RematLayer.apply(call, template, pos, holder,
                                             context_fn, chain, token,
                                             *tensors)
    chain.token = token
    return rebuild_tensors(holder["h"], outputs), aux


# -- generation -------------------------------------------------------------
#
# The JAX package jits these (generate as prefill + lax.fori_loop); here
# they run eagerly: one forward per token, the loop in Python.  Token ids
# leave as int32, as there.

def _greedy(logits):
    """(B, L, V) -> the argmax of the last position, (B, 1) int32 (the
    first maximum on ties, as jnp.argmax)."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


@torch.no_grad()
def decode_step(params, config: TransformerConfig, cache, token, pos):
    """One incremental decode step: token (B, 1) at absolute position pos.
    Returns (next_token greedy (B, 1) int32, logits, cache)."""
    logits, cache = forward(params, config, token, cache=cache, pos=pos)
    return _greedy(logits), logits, cache


def _conformed(params, config: TransformerConfig, prompt, cache) -> tuple:
    """(params, cache, the caller's cache to write back into or None):
    on a sharded call, a parameter tree or a Sharded cache laid out
    otherwise than the call computes on is resharded once, here at the
    entry of a generation, not at every step."""
    mesh = _call_mesh(params, prompt, cache, False, config)
    if mesh is None:
        return params, cache, None
    call, params = _call_layout(mesh, params, config)
    if cache is None or not any(True for _ in sharded_leaves(cache)):
        return params, cache, None
    call.split = call.splits(prompt.shape[0])
    cache, caller_cache = _placed_cache(call, cache, config)
    return params, cache, caller_cache


def _prompt_cache(params, config, prompt, max_new_tokens: int, cache):
    """The caller's cache, else a new one: laid out by cache_specs over
    the parameters' mesh when they are sharded."""
    if cache is not None:
        return cache
    mesh = _call_mesh(params, prompt, None, False, config)
    if mesh is not None:
        return _sharded_cache(mesh, params, config, prompt.shape[0],
                              prompt.shape[1] + max_new_tokens)
    return init_cache(config, prompt.shape[0],
                      max_len=prompt.shape[1] + max_new_tokens,
                      device=prompt.device)


@torch.no_grad()
def generate(params, config: TransformerConfig, prompt,
             max_new_tokens: int, cache=None):
    """Greedy generation: prefill the prompt, then one cached step per
    new token.  Returns (tokens (B, max_new_tokens) int32, cache).  A
    caller-supplied cache is written in place."""
    batch, prompt_len = prompt.shape
    params, cache, caller_cache = _conformed(params, config, prompt, cache)
    cache = _prompt_cache(params, config, prompt, max_new_tokens, cache)
    logits, cache = forward(params, config, prompt, cache=cache, pos=0)
    out = torch.zeros((batch, max_new_tokens), dtype=torch.int32,
                      device=logits.device)
    out[:, :1] = _greedy(logits)
    del logits
    for step in range(1, max_new_tokens):
        step_logits, cache = forward(params, config, out[:, step - 1:step],
                                     cache=cache, pos=prompt_len + step - 1)
        out[:, step:step + 1] = _greedy(step_logits)
    if caller_cache is not None:
        _write_back(caller_cache, cache)
        cache = caller_cache
    return out, cache


@torch.no_grad()
def _prefill_step(params, config: TransformerConfig, prompt, cache):
    logits, cache = forward(params, config, prompt, cache=cache, pos=0)
    return _greedy(logits), cache


@torch.no_grad()
def _decode_chunk(params, config: TransformerConfig, token, cache, pos: int,
                  chunk: int):
    """`chunk` greedy steps from `token` at `pos`: returns (the chunk's
    tokens (B, chunk) int32, the last token, cache)."""
    out = torch.zeros((token.shape[0], chunk), dtype=torch.int32,
                      device=token.device)
    for step in range(chunk):
        logits, cache = forward(params, config, token, cache=cache,
                                pos=pos + step)
        token = _greedy(logits)
        out[:, step:step + 1] = token
    return out, token, cache


def generate_stream(params, config: TransformerConfig, prompt,
                    max_new_tokens: int, cache=None, chunk: int = 8):
    """Streaming greedy generation: yields (offset, tokens (B, n)) numpy
    chunks as they decode -- the prefill's token first, then chunks of
    up to `chunk` steps.  The chunks concatenate to generate()'s tokens."""
    prompt_len = prompt.shape[1]
    params, cache, caller_cache = _conformed(params, config, prompt, cache)
    cache = _prompt_cache(params, config, prompt, max_new_tokens, cache)
    token, cache = _prefill_step(params, config, prompt, cache)
    yield 0, token.cpu().numpy()
    produced = 1
    while produced < max_new_tokens:
        size = min(chunk, max_new_tokens - produced)
        block, token, cache = _decode_chunk(
            params, config, token, cache, prompt_len + produced - 1, size)
        yield produced, block.cpu().numpy()
        produced += size
    if caller_cache is not None:
        _write_back(caller_cache, cache)


# -- paged KV: the continuous-batching decode substrate ----------------------
#
# One fixed-size POOL of KV blocks plus per-slot block tables, so that
# the decode engine (decode/engine.py) admits and evicts requests
# mid-decode without ever changing a tensor's shape.  The JAX package's
# three invariants hold here too:
#
#   - block contents are written by the same forward()/_quantize_kv math
#     as the contiguous cache (paged_prefill reshapes a forward() cache
#     into blocks);
#   - the paged attention is _masked_attention, the cached path's, over
#     the block-table gather: positions beyond a slot's cursor hold stale
#     or trash values but are masked to exactly zero weight
#     (paged_gather_attention).  On the card a bf16 pool's windows of up
#     to PAGED_MAX_WINDOW rows -- the decode, verify and draft steps, and
#     a chunk that short -- go to K4 instead (paged_decode_attention): the
#     same function read from the pool in place, up to each slot's
#     position and no further; a head size K4 does not take raises there.
#     The route follows only the device, the pool's dtype and the window:
#     the CPU, an f32 or int8 pool and a longer chunk keep the gather;
#   - inactive slots compute on the reserved TRASH block (index 0, never
#     allocated), so a step's shapes -- (slots, max_blocks) -- stay the
#     same across any admission/eviction sequence.  On the card that is
#     what lets the engine capture each step once as a CUDA graph and
#     replay it.

def init_paged_pool(config: TransformerConfig, num_blocks: int,
                    block_size: int, device="cuda") -> dict:
    """Zeroed paged KV pool (layers, num_blocks, kv_heads, block_size,
    head_dim) on `device`: in the compute dtype, or int8 codes with f32
    scale planes (..., block_size, 1) when config.kv_dtype is "int8" --
    init_cache's leaves, blocked.  Block 0 is the engine's trash block."""
    device = resolve_device(device)
    shape = (config.n_layers, num_blocks, config.n_kv_heads, block_size,
             config.head_dim)
    if config.kv_dtype == "int8":
        scale_shape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale_shape, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(scale_shape, device=device)}
    return {"k": torch.zeros(shape, dtype=config.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=config.torch_dtype, device=device)}


def f32_head(params: dict) -> dict:
    """The parameter tree with its LM head (the tied embedding when there
    is no lm_head) kept once in f32 as `lm_head`, so _lm_head's f32
    product stops copying the whole table on every call.  The same
    logits: the JAX package converts the same weights inside its jit.  An
    int8 or f32 head is left as it is."""
    head = params.get("lm_head", params["embed"])
    if head["w"].dtype in (torch.int8, torch.float32):
        return params
    return {**params, "lm_head": {**head, "w": head["w"].float()}}


@torch.no_grad()
def paged_prefill(params, config: TransformerConfig, pool, prompt,
                  table_row, true_len):
    """Prefill one request into its pool blocks.  prompt (1, Lb) with Lb a
    multiple of the block size (right-padded to a bucket); table_row
    (max_blocks,) names the slot's blocks, of which the first
    Lb // block_size receive the prompt's K/V, written in place.  Returns
    (pool, first_token): the greedy token after the TRUE prompt length
    (causal masking makes it independent of the padding), a 0-d int32
    tensor."""
    block_size = pool["k"].shape[3]
    local = init_cache(config, 1, max_len=prompt.shape[1],
                       device=prompt.device)
    logits, local = forward(params, config, prompt, cache=local, pos=0)
    first = torch.argmax(logits[0, int(true_len) - 1]).to(torch.int32)
    blocks = prompt.shape[1] // block_size
    rows = torch.as_tensor(table_row, device=prompt.device)[:blocks].long()
    for name, written in local.items():
        # (nl, 1, H, Lb, d) -> (nl, blocks, H, block_size, d), scattered
        # into the slot's first `blocks` pool entries
        entry = written[:, 0]
        layers, heads, _, depth = entry.shape
        pool[name][:, rows] = entry.reshape(
            layers, heads, blocks, block_size, depth).transpose(1, 2)
    return pool, first


def _paged_gather(pool_layer, tables):
    """(num_blocks, H, bs, d)[tables (S, MB)] -> each slot's contiguous
    view (S, H, MB * bs, d)."""
    view = pool_layer[tables]
    slots, max_blocks, heads, block_size, depth = view.shape
    return view.transpose(1, 2).reshape(slots, heads,
                                        max_blocks * block_size, depth)


def paged_gather_attention(config: TransformerConfig, q, k_pool, v_pool,
                           tables, positions, k_scale=None, v_scale=None):
    """The paged steps' attention by gathering: q (S, H, W, d) over one
    layer's pools (num_blocks, H_kv, bs, d) -- int8 codes dequantized
    with their scale planes when given -- through tables (S, MB), every
    slot's whole table gathered and row w of slot s attending to the
    positions up to positions[s] + w (_masked_attention).  Returns
    (S, H, W, d) in q's dtype.  The route of the CPU, of f32 and int8
    pools and of windows longer than K4 takes; over a bf16 pool it is
    K4's plain version, which the tests hold K4 to."""
    block_size = k_pool.shape[2]
    tables = tables.long()
    k_eff = _paged_gather(k_pool, tables)
    v_eff = _paged_gather(v_pool, tables)
    if k_scale is not None:
        k_eff = _dequantized(k_eff, _paged_gather(k_scale, tables), q.dtype)
        v_eff = _dequantized(v_eff, _paged_gather(v_scale, tables), q.dtype)
    q_pos = positions.long()[:, None] + torch.arange(
        q.shape[2], device=q.device)[None, :]
    k_pos = torch.arange(tables.shape[1] * block_size, device=q.device)
    return _masked_attention(config, q, k_eff, v_eff,
                             q_pos[:, None, :, None], k_pos)


def _takes_paged_kernel(pool, window: int) -> bool:
    """K4's route: a bf16 pool (not f32, not int8) on a CUDA device and a
    window of at most PAGED_MAX_WINDOW rows."""
    return (pool["k"].device.type == "cuda"
            and pool["k"].dtype == torch.bfloat16
            and window <= PAGED_MAX_WINDOW)


@torch.no_grad()
def _paged_window(params, config: TransformerConfig, pool, tables,
                  positions, tokens, write_blocks, write_offsets):
    """The paged step over a per-slot TOKEN WINDOW -- the one
    implementation behind paged_decode_step (window 1), paged_verify_step
    (window k + 1) and paged_prefill_chunk (window = chunk bucket).

    tokens (S, W) are consumed left to right per slot: window position i
    sits at absolute position positions[s] + i and its K/V lands at
    (write_blocks[s, i], write_offsets[s, i]).  Every write of the window
    happens before the attention, so later window positions attend to
    earlier ones causally; rows meant to be inert write to the trash
    block (duplicate trash writes leave only the trash's contents
    depending on which one wins).  Returns greedy (S, W) int32:
    greedy[s, i] is the greedy token after window positions 0..i."""
    quantized = config.kv_dtype == "int8"
    device = tokens.device
    slots, window = tokens.shape
    kernel = _takes_paged_kernel(pool, window)
    if kernel:
        if config.head_dim not in PAGED_HEAD_DIMS:
            raise ValueError(
                f"a paged step over a CUDA bf16 pool runs K4, which takes "
                f"head_dim in {PAGED_HEAD_DIMS}, not {config.head_dim}")
        # K4 reads int32 tables and positions, converted once a window
        tables = tables.to(torch.int32)
        positions = positions.to(torch.int32)
    write_blocks = write_blocks.long()
    write_offsets = write_offsets.long()
    h = _embed(params, config, tokens)
    q_pos = positions.long()[:, None] + torch.arange(
        window, device=device)[None, :]                     # (S, W)
    cos, sin = rotary_embedding(q_pos, config.head_dim, config.rope_theta)
    cos, sin = cos[:, None], sin[:, None]                   # (S, 1, W, hd/2)
    for index, layer in enumerate(_unstack(params["layers"])):
        layer_pool = {name: buffer[index] for name, buffer in pool.items()}
        q, k, v = _project_qkv(
            config, layer, rms_norm(layer["attn_norm"], h, config.norm_eps),
            cos, sin)
        if quantized:
            k, k_scale = _quantize_kv(k)
            v, v_scale = _quantize_kv(v)
            layer_pool["k_scale"][write_blocks, :, write_offsets] = \
                k_scale.transpose(1, 2)
            layer_pool["v_scale"][write_blocks, :, write_offsets] = \
                v_scale.transpose(1, 2)
        # (S, H, W, d) -> (S, W, H, d): the (S, W) block/offset index
        # pairs on axes 0 and 2 put their own dimensions first, as in
        # numpy and JAX, so one put writes every window position of
        # every slot
        layer_pool["k"][write_blocks, :, write_offsets] = k.transpose(1, 2)
        layer_pool["v"][write_blocks, :, write_offsets] = v.transpose(1, 2)
        if kernel:
            out = paged_decode_attention(
                q, layer_pool["k"], layer_pool["v"], tables, positions,
                _attention_scale(config.head_dim))
        else:
            out = paged_gather_attention(
                config, q, layer_pool["k"], layer_pool["v"], tables,
                positions, layer_pool.get("k_scale"),
                layer_pool.get("v_scale"))
        out = out.transpose(1, 2).reshape(slots, window, -1)
        h = h + dense(layer["wo"], out)
        mlp_out, _ = _mlp_block(
            config, layer, rms_norm(layer["mlp_norm"], h, config.norm_eps))
        h = h + mlp_out
    logits = _lm_head(params, config, h)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def paged_decode_step(params, config: TransformerConfig, pool, tables,
                      positions, tokens, write_blocks, write_offsets):
    """ONE greedy decode step over all slots of a continuous-batching
    engine: tables (S, max_blocks), positions (S,) each slot's next write
    position, tokens (S, 1) the previous greedy tokens, write_blocks /
    write_offsets (S,) where this step's K/V land (inactive slots point at
    the trash block).  Returns (pool, next_tokens (S, 1) int32); inactive
    rows are garbage the engine ignores.  The window-1 _paged_window."""
    return pool, _paged_window(params, config, pool, tables, positions,
                               tokens, write_blocks[:, None],
                               write_offsets[:, None])


def paged_verify_step(params, config: TransformerConfig, pool, tables,
                      positions, tokens, write_blocks, write_offsets):
    """Speculative verification: a decode step with a TOKEN WINDOW per
    slot.  tokens (S, W) = [last emitted token, draft_1..draft_{W-1}];
    write_blocks / write_offsets (S, W).  Returns (pool, greedy (S, W)),
    greedy[s, i] the target's greedy token after window position i."""
    return pool, _paged_window(params, config, pool, tables, positions,
                               tokens, write_blocks, write_offsets)


def paged_prefill_chunk(params, config: TransformerConfig, pool, tokens,
                        table_row, start, write_blocks, write_offsets):
    """Prefill ONE request's next C prompt tokens into its pool blocks,
    attending to the blocks earlier chunks wrote through the table:
    tokens (1, C) right-padded to the chunk's bucket, table_row
    (max_blocks,), start the chunk's first absolute position,
    write_blocks / write_offsets (C,) (padding -> trash block).  Returns
    (pool, greedy (C,)): greedy[i] is the greedy token after prompt
    position start + i."""
    start = torch.as_tensor(start, device=tokens.device).reshape(1)
    greedy = _paged_window(params, config, pool, table_row[None], start,
                           tokens, write_blocks[None], write_offsets[None])
    return pool, greedy[0]


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
    saved = _SAVED_OPS[name]

    def policy(ctx, op, *args, **kwargs):
        if op in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def resolve_remat_policy(name: str | None):
    """Remat-policy name -> the checkpoint's context_fn (None: don't wrap
    the layer at all -- no policy, or everything_saveable, which saves
    every activation and so recomputes nothing, on every mesh)."""
    if name is None or name in ("none", "everything_saveable"):
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
    params and opt_state in place (the JAX step donates both).

    Sharded parameters (shard_pytree with param_specs) train where they
    lie: the forward runs the sharded path, autograd carries each
    block's gradient back through the collectives, the optimizer state
    takes its parameter's blocks and the update is elementwise, so no
    weight is ever gathered.  sharded=True adds activation_specs: with an
    ambient mesh and whole parameters, the step runs data-parallel on
    it.  On a mesh from global_mesh every process runs this step on the
    same tokens and weights: each computes its own positions, the
    gradients cross the processes through the collectives' backward
    (parallel/collectives.py), and each process's blocks take exactly
    the gradients of the same step on a one-process mesh."""
    resolve_remat_policy(remat_policy)  # fail fast on typos

    def loss_fn(params, tokens):
        logits, aux = forward(params, config, tokens[:, :-1],
                              activation_specs=sharded, return_aux=True,
                              remat_policy=remat_policy)
        return (next_token_loss(logits, tokens[:, 1:])
                + config.moe_aux_weight * aux)

    def train_step(params, opt_state, tokens):
        loss, grads = value_and_grad(loss_fn, params, tokens)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads
        apply_updates(params, updates)
        return params, opt_state, loss

    return train_step
