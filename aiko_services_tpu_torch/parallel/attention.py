# Flash attention: hand-written Hopper kernels and their plain versions.
#
# Counterpart of aiko_services_tpu/parallel/attention.py (the attention
# functions only; ring and Ulysses sequence parallelism are not ported
# yet).  All take q/k/v shaped (batch, heads, seq, head_dim).
#
#   attention_reference       -- plain softmax attention, the oracle
#   flash_attention           -- the model's attention call; returns O and
#                                is differentiable (the JAX custom_vjp is
#                                the autograd Function _FlashAttention)
#   flash_attention_forward   -- O and the per-row logsumexp, as the TPU
#                                kernel's _flash_impl returns them
#   flash_attention_backward  -- dQ, dK, dV from the forward's residuals,
#                                as _flash_bwd_impl returns them
#
# The forward and backward take their plain PyTorch versions ONLY for
# tensors on the CPU.  For CUDA tensors they launch the kernels in
# csrc/flash_attention.cu (the port of the Pallas `_flash_kernel`) and
# csrc/flash_attention_backward.cu (`_flash_dq_kernel`,
# `_flash_dkv_kernel`) or raise: there is no fallback.

from __future__ import annotations

import ctypes
import math

import torch

from ..ops import kernels

__all__ = ["attention_reference", "flash_attention",
           "flash_attention_forward", "flash_attention_plain",
           "flash_attention_backward", "flash_attention_backward_plain",
           "flash_attention_dq_plain", "flash_attention_dkv_plain"]

_NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C symbol -> (library, argument types); every function returns its
# launch's cudaError_t and takes the stream last
_SIGNATURES = {
    "aiko_flash_attention_forward": (
        "flash_attention",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
         _P]),
    "aiko_flash_attention_dq": (
        "flash_attention_backward",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _I, _P]),
    "aiko_flash_attention_dkv": (
        "flash_attention_backward",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _I, _P]),
}


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
    """The plain PyTorch version of the forward kernel's function: f32
    scores, masked to -1e30, softmax, f32 value product cast to q's type,
    and the per-row logsumexp (f32, (B, H, Lq))."""
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


def _probabilities(q, k, v, dout, lse, delta, causal: bool,
                   sm_scale: float, q_offset: int):
    """(p, ds) as the backward kernels recompute them: p = exp(s - lse)
    where the mask keeps (i, j) and exactly 0 elsewhere, ds = p * (dO.v -
    delta), all f32."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() * sm_scale,
                          k.float())
    p = torch.exp(scores - lse[..., None])
    if causal:
        mask = _causal_mask(q.shape[2], k.shape[2], q_offset, q.device)
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_dq_plain(q, k, v, dout, lse, delta, causal: bool,
                             sm_scale: float, q_offset: int = 0):
    """The plain version of the dQ kernel: f32, cast to q's type."""
    _, ds = _probabilities(q, k, v, dout, lse, delta, causal, sm_scale,
                           q_offset)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * sm_scale
    return dq.to(q.dtype)


def flash_attention_dkv_plain(q, k, v, dout, lse, delta, causal: bool,
                              sm_scale: float, q_offset: int = 0):
    """The plain version of the dK/dV kernel: f32, cast to k's and v's
    types."""
    p, ds = _probabilities(q, k, v, dout, lse, delta, causal, sm_scale,
                           q_offset)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, dout):
    """rowsum(dO * O) in f32, (B, H, Lq): computed outside the kernels, as
    the JAX package computes it outside its Pallas kernels."""
    return torch.sum(dout.float() * out.float(), dim=-1)


def flash_attention_backward_plain(q, k, v, out, lse, dout,
                                   causal: bool = False, sm_scale=None,
                                   q_offset: int = 0):
    """The plain PyTorch version of the two backward kernels: (dQ, dK,
    dV) from the forward's residuals and the output's cotangent."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    delta = _delta(out, dout)
    dq = flash_attention_dq_plain(q, k, v, dout, lse, delta, causal,
                                  sm_scale, q_offset)
    dk, dv = flash_attention_dkv_plain(q, k, v, dout, lse, delta, causal,
                                       sm_scale, q_offset)
    return dq, dk, dv


# -- the kernels' wrappers -----------------------------------------------------

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


def _check_backward_inputs(q, k, v, dout, lse, delta) -> None:
    _check_kernel_inputs(q, k, v)
    if dout.device != q.device or dout.dtype != q.dtype or (
            dout.shape != q.shape):
        raise ValueError(f"flash attention backward kernel: dout "
                         f"{tuple(dout.shape)} {dout.dtype} on "
                         f"{dout.device} does not match q "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if not dout.is_contiguous():
        raise ValueError("flash attention backward kernel: dout must be "
                         "contiguous")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernels copy 16-byte chunks with cp.async
        for name, tensor in (("q", q), ("k", k), ("v", v), ("dout", dout)):
            if tensor.data_ptr() % 16:
                raise ValueError(f"flash attention backward kernel: bf16 "
                                 f"{name} must start on a 16-byte boundary")
    for name, stat in (("lse", lse), ("delta", delta)):
        if stat.device != q.device or stat.dtype != torch.float32 or (
                stat.shape != q.shape[:3]) or not stat.is_contiguous():
            raise ValueError(f"flash attention backward kernel: {name} "
                             f"must be contiguous float32 "
                             f"{tuple(q.shape[:3])} on {q.device}, got "
                             f"{tuple(stat.shape)} {stat.dtype} on "
                             f"{stat.device}")


def _launch(kernel: str, symbol: str, device, *arguments) -> None:
    """Call a kernel's C entry point on the current stream of `device`,
    raise on its CUDA error, and count the launch."""
    library_name, argtypes = _SIGNATURES[symbol]
    function = getattr(kernels.load_kernel(library_name), symbol)
    if function.argtypes is None:
        function.argtypes = argtypes
        function.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        error = function(*arguments, stream)
    if error != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{error}")
    kernels.launch_counts[kernel] += 1


def _diagonal(causal: bool, q_offset: int, q_len: int, k_len: int) -> int:
    return int(q_offset) + (k_len - q_len) if causal else 0


def _flash_kernel_forward(q, k, v, causal: bool, sm_scale: float,
                          q_offset: int):
    _check_kernel_inputs(q, k, v)
    batch, heads, q_len, head_dim = q.shape
    k_len = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, q_len), dtype=torch.float32,
                      device=q.device)
    _launch("flash_attention", "aiko_flash_attention_forward", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), batch * heads, q_len, k_len, head_dim,
            _DTYPE_CODES[q.dtype], int(causal), float(sm_scale),
            _diagonal(causal, q_offset, q_len, k_len))
    return out, lse


def _flash_kernel_dq(q, k, v, dout, lse, delta, causal: bool,
                     sm_scale: float, q_offset: int):
    _check_backward_inputs(q, k, v, dout, lse, delta)
    batch, heads, q_len, head_dim = q.shape
    k_len = k.shape[2]
    dq = torch.empty_like(q)
    _launch("flash_attention_dq", "aiko_flash_attention_dq", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), batch * heads,
            q_len, k_len, head_dim, _DTYPE_CODES[q.dtype], int(causal),
            float(sm_scale), _diagonal(causal, q_offset, q_len, k_len))
    return dq


def _flash_kernel_dkv(q, k, v, dout, lse, delta, causal: bool,
                      sm_scale: float, q_offset: int):
    _check_backward_inputs(q, k, v, dout, lse, delta)
    batch, heads, q_len, head_dim = q.shape
    k_len = k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_attention_dkv", "aiko_flash_attention_dkv", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            batch * heads, q_len, k_len, head_dim, _DTYPE_CODES[q.dtype],
            int(causal), float(sm_scale),
            _diagonal(causal, q_offset, q_len, k_len))
    return dk, dv


# -- dispatch ------------------------------------------------------------------

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


def flash_attention_backward(q, k, v, out, lse, dout, causal: bool = False,
                             sm_scale=None, q_offset: int = 0):
    """(dQ, dK, dV) in q's, k's and v's dtypes, from the forward's
    residuals (q, k, v, O, LSE) and O's cotangent dout.  CPU tensors take
    the plain version; CUDA tensors compute delta = rowsum(dO * O) and
    launch the dQ and dK/dV kernels, and anything else raises."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, out, lse, dout, causal=causal, sm_scale=sm_scale,
            q_offset=q_offset)
    if q.device.type == "cuda":
        delta = _delta(out, dout)
        arguments = (q, k, v, dout, lse, delta, bool(causal),
                     float(sm_scale), int(q_offset))
        dq = _flash_kernel_dq(*arguments)
        dk, dv = _flash_kernel_dkv(*arguments)
        return dq, dk, dv
    raise ValueError(f"flash attention has no kernel for device "
                     f"{q.device}")


class _FlashAttention(torch.autograd.Function):
    """The JAX package's custom_vjp around _flash: the forward saves q,
    k, v, O and LSE, the backward runs the two backward kernels.  causal,
    sm_scale and q_offset get no gradient (nondiff_argnums)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float,
                q_offset: int):
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           sm_scale=sm_scale,
                                           q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.q_offset = causal, sm_scale, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # the cotangent usually arrives transposed from the head merge;
        # the kernels take contiguous tensors only
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
            sm_scale=ctx.sm_scale, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False, sm_scale=None,
                    block_q: int = 128, block_k: int = 128,
                    q_offset: int = 0):
    """Blockwise attention, (B, H, L, D) in and out, differentiable in q,
    k and v.  block_q/block_k are accepted for parity with the JAX
    signature; the kernels pick their own tiles and they do not change
    the result."""
    del block_q, block_k
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale),
                                 int(q_offset))
