"""Plain references of the benchmark's models: straightforward PyTorch in
float32 (TF32 off), written from the models' published descriptions and
the port's documented departures, importing nothing of the program.
They take the weights and inputs the benchmark made and work out again
whatever the program derived from them."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """float32 matmuls and convolutions without TF32 for the scope."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fake_quant(x: torch.Tensor, precision: str | None, axis: int):
    """x rounded through `precision` with one symmetric scale per slice
    along every axis but `axis` (the reduced one), returned in f32:
    None keeps x; "fp8" rounds to float8 e4m3 (largest 448)."""
    if precision is None:
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = x.abs().amax(dim=axis, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str | None = None):
    """x (..., in) @ w (in, out) in f32; with a precision both operands
    are rounded through it first (per token, per output channel)."""
    x = fake_quant(x.float(), precision, -1)
    w = fake_quant(w.float(), precision, 0)
    return x @ w


def gaps(reference_logits: torch.Tensor, tokens: torch.Tensor):
    """(T,) how far below the reference's best logit each token's logit
    lies, for reference logits (T, V) in f32 and tokens (T,)."""
    best = reference_logits.max(dim=-1).values
    chosen = reference_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return best - chosen
