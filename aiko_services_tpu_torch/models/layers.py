# Shared neural-net layers as plain functions over parameter dicts.
#
# Counterpart of aiko_services_tpu/models/layers.py: the layers the ASR
# model and the LM use (dense, rms_norm, layer_norm, rotary, swiglu,
# repeat_kv, conv2d and the initialisers).
#
# Conventions, as in the JAX package: weights stored (in_features,
# out_features) so forward is x @ w; attention heads live in the
# last-but-one axis (B, H, L, D); everything computes in the dtype of the
# incoming activations with f32 accumulation.

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.audio import full_f32_convolution
from ..ops.device import counted_flags

__all__ = ["dense", "rms_norm", "layer_norm", "rotary_embedding",
           "apply_rotary", "swiglu", "repeat_kv", "init_dense", "init_norm",
           "conv2d", "init_conv", "f32_reduction"]


def _reduction_flags() -> tuple:
    matmul = torch.backends.cuda.matmul
    return (matmul.allow_bf16_reduced_precision_reduction,
            matmul.allow_fp16_reduced_precision_reduction)


def _set_reduction_flags(flags) -> None:
    matmul = torch.backends.cuda.matmul
    (matmul.allow_bf16_reduced_precision_reduction,
     matmul.allow_fp16_reduced_precision_reduction) = flags


# bf16 and fp16 matmuls on the card reduce in f32 for the duration of a
# scope (cuBLAS may otherwise sum split-K partials in the narrow type,
# where XLA's dot accumulates in f32 and rounds once); the flags are
# process-wide, so the scopes of all threads share one count
# (device.counted_flags)
f32_reduction = counted_flags(_reduction_flags, _set_reduction_flags,
                              (False, False))


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
    bf16 product on the card accumulates in f32 inside the matmul, its
    split-K partials too (f32_reduction), and rounds once; a bias is
    added in f32 before that single rounding, as the JAX package does.

    Weight-only int8 (transformer.quantize_weights_int8): the 8-bit codes
    cast to x's dtype (exact), the product is kept in f32 and the
    per-output-channel f32 scale applies after it, before the one
    rounding to x's dtype."""
    w = params["w"]
    if w.dtype == torch.int8:
        out = torch.matmul(x.float(), w.float()) * params["w_scale"].float()
        if "b" in params:
            out = out + params["b"].float()
        return out.to(x.dtype)
    if "b" in params:
        out = torch.matmul(x.float(), w.float()) + params["b"].float()
        return out.to(x.dtype)
    if w.dtype == x.dtype:
        with f32_reduction():
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


def init_conv(generator: torch.Generator, in_channels: int,
              out_channels: int, kernel: int, dtype=torch.float32,
              bias: bool = True, *, device) -> dict:
    """HWIO weights (kernel, kernel, in, out) drawn N(0, 1/fan_in) on the
    CPU from `generator`; a zero bias."""
    fan_in = in_channels * kernel * kernel
    weight = torch.randn((kernel, kernel, in_channels, out_channels),
                         generator=generator,
                         dtype=torch.float32) / np.sqrt(fan_in)
    params = {"w": weight.to(device=device, dtype=dtype)}
    if bias:
        params["b"] = torch.zeros((out_channels,), dtype=dtype,
                                  device=device)
    return params


def _same_padding(size: int, kernel: int, stride: int) -> tuple:
    """XLA's "SAME": total = max((ceil(n/s) - 1) * s + k - n, 0), the
    lower half (rounded down) before, the rest after.  PyTorch's
    padding=k//2 pads both sides alike, which at stride 2 on an even size
    shifts every window by one pixel."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(params: dict, x, stride: int = 1, padding="SAME"):
    """x (B, H, W, C), w (kh, kw, I, O) -> (B, H', W', O): NHWC/HWIO, as
    the JAX package's lax.conv_general_dilated call.

    The NHWC tensor is padded as it lies and handed to F.conv2d as a
    channels-last NCHW view (no copy).  The bias goes into the
    convolution call, so a bf16 convolution rounds its f32 sums plus bias
    once, as the JAX package does; f32 convolutions run with TF32 off
    (cuDNN's default would keep about three decimal digits).  Only the
    "SAME" padding the detector uses is ported."""
    if padding != "SAME":
        raise ValueError(f"conv2d ports padding='SAME' only, got "
                         f"{padding!r}")
    weight = params["w"].to(x.dtype).permute(3, 2, 0, 1)     # -> OIHW
    bias = params["b"].to(x.dtype) if "b" in params else None
    top, bottom = _same_padding(x.shape[1], weight.shape[2], stride)
    left, right = _same_padding(x.shape[2], weight.shape[3], stride)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
    nchw = x.permute(0, 3, 1, 2)
    if x.dtype == torch.float32:
        with full_f32_convolution():
            out = F.conv2d(nchw, weight, bias, stride=stride)
    else:
        out = F.conv2d(nchw, weight, bias, stride=stride)
    return out.permute(0, 2, 3, 1)
