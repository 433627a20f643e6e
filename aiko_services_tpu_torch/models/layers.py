# Shared neural-net layers as plain functions over parameter dicts.
#
# Counterpart of aiko_services_tpu/models/layers.py: the layers the ASR
# model and the LM use (dense, rms_norm, layer_norm, rotary, swiglu,
# repeat_kv and the initialisers).  conv2d comes with the detector.
#
# Conventions, as in the JAX package: weights stored (in_features,
# out_features) so forward is x @ w; attention heads live in the
# last-but-one axis (B, H, L, D); everything computes in the dtype of the
# incoming activations with f32 accumulation.

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["dense", "rms_norm", "layer_norm", "rotary_embedding",
           "apply_rotary", "swiglu", "repeat_kv", "init_dense", "init_norm"]


def init_dense(generator: torch.Generator, in_features: int,
               out_features: int, dtype=torch.float32, *, device) -> dict:
    """Normal(0, 1/in_features) weights, drawn on the CPU from
    `generator` (so a seed gives the same weights on every device)."""
    scale = 1.0 / np.sqrt(in_features)
    weight = torch.randn((in_features, out_features), generator=generator,
                         dtype=torch.float32) * scale
    return {"w": weight.to(device=device, dtype=dtype)}


def dense(params: dict, x):
    """x @ w (+ b), accumulated in f32 and cast once to x's dtype.  A
    bf16 product on the card accumulates in f32 inside the matmul and
    rounds once; a bias is added in f32 before that single rounding, as
    the JAX package does."""
    w = params["w"]
    if w.dtype == torch.int8:
        raise NotImplementedError("int8 weights (quantize_weights_int8) "
                                  "are not yet ported to the torch port")
    if "b" in params:
        out = torch.matmul(x.float(), w.float()) + params["b"].float()
        return out.to(x.dtype)
    if w.dtype == x.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def init_norm(features: int, dtype=torch.float32, *, device) -> dict:
    return {"scale": torch.ones((features,), dtype=dtype, device=device)}


def rms_norm(params: dict, x, eps: float = 1e-6):
    """Normalise in f32, cast to x's dtype, THEN scale: the JAX package's
    cast order."""
    x_f32 = x.float()
    rms = torch.rsqrt(torch.mean(x_f32 * x_f32, dim=-1, keepdim=True) + eps)
    return (x_f32 * rms).to(x.dtype) * params["scale"]


def layer_norm(params: dict, x, eps: float = 1e-5):
    """Normalise in f32, cast to x's dtype, THEN scale (and shift): the
    JAX package's cast order."""
    x_f32 = x.float()
    mean = x_f32.mean(dim=-1, keepdim=True)
    var = x_f32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x_f32 - mean) * torch.rsqrt(var + eps)
    out = out.to(x.dtype) * params["scale"]
    if "bias" in params:
        out = out + params["bias"]
    return out


def rotary_embedding(positions, head_dim: int, theta: float = 10000.0):
    """positions (..., L) int -> cos/sin tables (..., L, head_dim//2)."""
    frequencies = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    angles = positions[..., None].float() * frequencies
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x, cos, sin):
    """x (B, H, L, D); cos/sin (L, D//2) or broadcastable (B, 1, L, D//2).
    Rotates in f32 and casts once."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def swiglu(gate_params: dict, up_params: dict, down_params: dict, x):
    return dense(down_params,
                 F.silu(dense(gate_params, x)) * dense(up_params, x))


def repeat_kv(x, repeats: int):
    """Expand grouped KV heads to full head count: (B, Hkv, L, D) ->
    (B, Hkv*repeats, L, D).  Expand, then reshape (a copy); the gradient
    sums over the repeats."""
    if repeats == 1:
        return x
    batch, kv_heads, length, dim = x.shape
    x = x[:, :, None].expand(batch, kv_heads, repeats, length, dim)
    return x.reshape(batch, kv_heads * repeats, length, dim)
