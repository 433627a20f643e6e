# Attention forward: a hand-written Hopper kernel and its plain version.
#
# Counterpart of aiko_services_tpu/parallel/attention.py (the attention
# functions only; ring and Ulysses sequence parallelism are not ported
# yet).  All take q/k/v shaped (batch, heads, seq, head_dim).
#
#   attention_reference      -- plain softmax attention, the oracle
#   flash_attention          -- the model's attention call; returns O
#   flash_attention_forward  -- O and the per-row logsumexp, as the TPU
#                               kernel's _flash_impl returns them
#
# flash_attention_forward takes the plain PyTorch version ONLY for tensors
# on the CPU.  For CUDA tensors it launches the kernel in
# csrc/flash_attention.cu (the port of the Pallas `_flash_kernel`) or
# raises: there is no fallback.

from __future__ import annotations

import ctypes
import math

import torch

from ..ops import kernels

__all__ = ["attention_reference", "flash_attention",
           "flash_attention_forward", "flash_attention_plain"]

_NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _causal_mask(q_len: int, k_len: int, q_offset: int, device):
    """(q_len, k_len) bool: key j is visible to query i iff
    j <= i + q_offset + (k_len - q_len)."""
    q_pos = (torch.arange(q_len, device=device)[:, None]
             + (k_len - q_len) + q_offset)
    k_pos = torch.arange(k_len, device=device)[None, :]
    return k_pos <= q_pos


def attention_reference(q, k, v, causal: bool = False, sm_scale=None,
                        q_offset: int = 0):
    """Plain softmax attention (the JAX package's oracle, same casts:
    f32 logits and softmax, weights cast to v's type for the value
    product)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = _causal_mask(logits.shape[-2], logits.shape[-1], q_offset,
                            q.device)
        logits = torch.where(mask, logits, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def flash_attention_plain(q, k, v, causal: bool = False, sm_scale=None,
                          q_offset: int = 0):
    """The plain PyTorch version of the kernel's function: f32 scores,
    masked to -1e30, softmax, f32 value product cast to q's type, and the
    per-row logsumexp (f32, (B, H, Lq))."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float() * sm_scale,
                          k.float())
    if causal:
        mask = _causal_mask(q.shape[2], k.shape[2], q_offset, q.device)
        logits = torch.where(mask, logits, _NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, v.float())
    return out.to(q.dtype), lse


def _check_kernel_inputs(q, k, v) -> None:
    tensors = {"q": q, "k": k, "v": v}
    for name, tensor in tensors.items():
        if tensor.device.type != "cuda":
            raise ValueError(f"flash attention kernel: {name} is on "
                             f"{tensor.device}, not a CUDA device")
        if tensor.device != q.device:
            raise ValueError("flash attention kernel: q, k, v must lie on "
                             "one device")
        if tensor.dtype != q.dtype:
            raise TypeError("flash attention kernel: q, k, v must share a "
                            f"dtype, got {q.dtype} and {tensor.dtype}")
        if tensor.dim() != 4:
            raise ValueError(f"flash attention kernel: {name} must be "
                             f"(B, H, L, D), got shape {tuple(tensor.shape)}")
        if not tensor.is_contiguous():
            raise ValueError(f"flash attention kernel: {name} must be "
                             f"contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    batch, heads, _, head_dim = q.shape
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {head_dim}")
    if k.shape != v.shape or k.shape[:2] != (batch, heads) or (
            k.shape[3] != head_dim):
        raise ValueError(f"flash attention kernel: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash attention kernel: empty sequence")
    if batch * heads > 65535:
        raise ValueError(f"flash attention kernel: batch*heads "
                         f"{batch * heads} exceeds the grid limit 65535")


def _flash_kernel_forward(q, k, v, causal: bool, sm_scale: float,
                          q_offset: int):
    _check_kernel_inputs(q, k, v)
    library = kernels.load_kernel("flash_attention")
    function = library.aiko_flash_attention_forward
    if function.argtypes is None:
        function.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        function.restype = ctypes.c_int
    batch, heads, q_len, head_dim = q.shape
    k_len = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, q_len), dtype=torch.float32,
                      device=q.device)
    diag_offset = int(q_offset) + (k_len - q_len) if causal else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        error = function(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), batch * heads, q_len, k_len, head_dim,
            _DTYPE_CODES[q.dtype], int(bool(causal)), float(sm_scale),
            diag_offset, stream)
    if error != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {error}")
    kernels.launch_counts["flash_attention"] += 1
    return out, lse


def flash_attention_forward(q, k, v, causal: bool = False, sm_scale=None,
                            q_offset: int = 0):
    """(O, LSE): O (B, H, Lq, D) in q's dtype, LSE f32 (B, H, Lq).

    The causal diagonal is k_pos <= q_pos + q_offset + (Lk - Lq); keys
    past Lk do not exist.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, and anything else raises."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale, q_offset=q_offset)
    if q.device.type == "cuda":
        return _flash_kernel_forward(q, k, v, bool(causal), float(sm_scale),
                                     int(q_offset))
    raise ValueError(f"flash attention has no kernel for device "
                     f"{q.device}")


def flash_attention(q, k, v, causal: bool = False, sm_scale=None,
                    block_q: int = 128, block_k: int = 128,
                    q_offset: int = 0):
    """Blockwise attention, (B, H, L, D) in and out.  block_q/block_k are
    accepted for parity with the JAX signature; the kernel picks its own
    tiles and they do not change the result."""
    del block_q, block_k
    out, _ = flash_attention_forward(q, k, v, causal=causal,
                                     sm_scale=sm_scale, q_offset=q_offset)
    return out
