"""Plain Mistral-style decoder-only language model in float32.

Mistral-7B as published (huggingface.co/mistralai/Mistral-7B-v0.3):
RMSNorm (eps from the config) before attention and before the FFN,
rotary positions on q and k (theta from the config; the two halves of
each head rotated as a pair), grouped-query attention with causal
masking and no sliding window, a SwiGLU FFN, a final RMSNorm and the
untied lm_head.  Weights arrive as the benchmark's tree (the program's
layout: stacked layers, (in, out) matrices, lm_head (vocab, d)); each
layer is cast to f32 when it is used, so the whole model never lives in
f32 at once."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import matmul

_QUERY_BLOCK = 1024


def _rms(scale, x, eps: float):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) \
        * scale.float()


def _rotate(x, positions, theta: float):
    """x (H, L, hd): each head's first and second halves rotated as
    pairs by position * theta^(-2i / hd)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float64,
                                  device=x.device) * 2.0 / x.shape[-1])
    angles = positions.double()[:, None] * inv[None, :]
    cos, sin = torch.cos(angles).float(), torch.sin(angles).float()
    first, second = x[..., :half], x[..., half:]
    return torch.cat([first * cos - second * sin,
                      second * cos + first * sin], dim=-1)


def _attend(q, k, v):
    """Causal attention of q (H, L, hd) over k, v (H, L, hd), in blocks
    of queries so that the (H, block, L) scores stay small."""
    length = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.empty_like(q)
    keys = torch.arange(length, device=q.device)
    for start in range(0, length, _QUERY_BLOCK):
        stop = min(start + _QUERY_BLOCK, length)
        scores = q[:, start:stop] @ k.transpose(-1, -2) * scale
        rows = torch.arange(start, stop, device=q.device)
        scores = scores.masked_fill(keys[None, :] > rows[:, None],
                                    float("-inf"))
        out[:, start:stop] = torch.softmax(scores, dim=-1) @ v
    return out


def logits(params: dict, config: dict, tokens: torch.Tensor,
           first: int):
    """tokens (L,) -> f32 logits (L - first, vocab) of positions first ..
    L - 1, each position attending to itself and those before it."""
    d = config["hidden_size"]
    heads = config["num_attention_heads"]
    kv_heads = config["num_key_value_heads"]
    head_dim = config.get("head_dim") or d // heads
    eps = config["rms_norm_eps"]
    theta = float(config["rope_theta"])
    length = tokens.shape[0]
    positions = torch.arange(length, device=tokens.device)
    h = params["embed"]["w"][tokens.long()].float()
    layers = params["layers"]
    for index in range(config["num_hidden_layers"]):
        def weight(name):
            return layers[name]["w"][index]

        x = _rms(layers["attn_norm"]["scale"][index], h, eps)
        q = matmul(x, weight("wq")).view(
            length, heads, head_dim).transpose(0, 1)
        k = matmul(x, weight("wk")).view(
            length, kv_heads, head_dim).transpose(0, 1)
        v = matmul(x, weight("wv")).view(
            length, kv_heads, head_dim).transpose(0, 1)
        q, k = _rotate(q, positions, theta), _rotate(k, positions, theta)
        group = heads // kv_heads
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
        out = _attend(q, k, v).transpose(0, 1).reshape(length, -1)
        h = h + matmul(out, weight("wo"))
        x = _rms(layers["mlp_norm"]["scale"][index], h, eps)
        hidden = F.silu(matmul(x, weight("w_gate"))) \
            * matmul(x, weight("w_up"))
        h = h + matmul(hidden, weight("w_down"))
    h = _rms(params["norm_out"]["scale"], h[first:], eps)
    return matmul(h, params["lm_head"]["w"].t())
