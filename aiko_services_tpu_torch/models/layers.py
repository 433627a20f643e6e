# Shared neural-net layers as plain functions over parameter dicts.
#
# Counterpart of aiko_services_tpu/models/layers.py: the layers the ASR
# model uses (dense, layer_norm and their initialisers).  rms_norm,
# rotary, swiglu, repeat_kv and conv2d come with the LM and detector.
#
# Conventions, as in the JAX package: weights stored (in_features,
# out_features) so forward is x @ w; attention heads live in the
# last-but-one axis (B, H, L, D); everything computes in the dtype of the
# incoming activations with f32 accumulation.

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dense", "layer_norm", "init_dense", "init_norm"]


def init_dense(generator: torch.Generator, in_features: int,
               out_features: int, dtype=torch.float32,
               device="cpu") -> dict:
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
    if "b" in params:
        out = torch.matmul(x.float(), w.float()) + params["b"].float()
        return out.to(x.dtype)
    if w.dtype == x.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def init_norm(features: int, dtype=torch.float32, device="cpu") -> dict:
    return {"scale": torch.ones((features,), dtype=dtype, device=device)}


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
