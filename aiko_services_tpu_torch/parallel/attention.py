# Flash attention: hand-written Hopper kernels and their plain versions,
# and the sequence-parallel attentions built on them.
#
# Counterpart of aiko_services_tpu/parallel/attention.py.  All take q/k/v
# shaped (batch, heads, seq, head_dim).
#
#   attention_reference       -- plain softmax attention, the oracle
#   flash_attention           -- the model's attention call; returns O and
#                                is differentiable (the JAX custom_vjp is
#                                the autograd Function _FlashAttention)
#   flash_attention_forward   -- O and the per-row logsumexp, as the TPU
#                                kernel's _flash_impl returns them
#   flash_attention_backward  -- dQ, dK, dV from the forward's residuals,
#                                as _flash_bwd_impl returns them
#   ring_attention            -- sequence parallel over a mesh's "seq"
#                                axis: K/V shards rotate around the ring,
#                                each executed hop one forward kernel (and
#                                one dQ + one dK/dV in the backward)
#   ulysses_attention         -- sequence parallel by all-to-all: each
#                                device attends its head group over the
#                                whole sequence through flash_attention
#   sp_decode_attention       -- cached decode with the cache length
#                                sharded over "seq" (plain torch, as the
#                                JAX package's einsums are)
#   paged_decode_attention    -- the decode engine's attention over a
#                                paged KV pool: K4 (csrc/paged_attention.cu),
#                                CUDA only; its plain version is
#                                models/transformer.py's gather path,
#                                paged_gather_attention
#
# The sequence-parallel functions run on a Mesh (parallel/mesh.py; the
# ambient one when mesh=None).  One process drives every device of the
# axis: a function cuts its global (B, H, L, D) inputs into one
# contiguous shard per device of the axis, moves each there, runs the
# shard's work there and gathers the result on the inputs' device.  A
# "ppermute" between two devices is a copy; between two shards on one
# device (a mesh that names a device more than once) it moves nothing.
#
# The forward and backward take their plain PyTorch versions ONLY for
# tensors on the CPU.  For CUDA tensors they launch the kernels in
# csrc/flash_attention.cu (the port of the Pallas `_flash_kernel`) and
# csrc/flash_attention_backward.cu (`_flash_dq_kernel`,
# `_flash_dkv_kernel`) or raise: there is no fallback.  Each C entry point
# chooses its kernel by dtype: bf16 runs on the tensor cores (and must
# start on a 16-byte boundary), f32 on the f32 CUDA cores.
#
# Tensors on the meta device (the analyzer's eval pass traces element
# programs there: analyze/shape_eval.py) get the forward's output
# contract -- an empty O in q's dtype and shape and an empty f32 LSE
# (B, H, Lq) -- and nothing is computed; the forward's operation count,
# which an aten FLOP counter cannot see, goes to every open
# count_meta_flops() scope.  Only meta tensors take that branch: it is
# a shape rule, not a fallback.

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import math

import numpy as np
import torch

from ..ops import kernels
from ..utils.tree import flatten_tensors, rebuild_tensors, tensor_place
from .collectives import (
    _link, all_to_all, axis_index, map_shards, pmax, ppermute, psum)
from .mesh import Mesh, PartitionSpec, ambient_mesh, named_sharding

__all__ = ["attention_reference", "flash_attention", "count_meta_flops",
           "flash_attention_forward", "flash_attention_plain",
           "flash_attention_backward", "flash_attention_backward_plain",
           "flash_attention_dq_plain", "flash_attention_dkv_plain",
           "ring_attention", "ulysses_attention", "sp_decode_attention",
           "ring_attention_grid", "ulysses_attention_grid",
           "sp_decode_grid", "paged_decode_attention", "PAGED_HEAD_DIMS",
           "PAGED_MAX_WINDOW"]

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
    "aiko_paged_decode_attention": (
        "paged_attention",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _P]),
    "aiko_paged_decode_attention_merge": (
        "paged_attention",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
}

# what K4 takes (csrc/paged_attention.cu): K1's head sizes, window rows,
# and the positions of a split, which sizes its scratch
PAGED_HEAD_DIMS = _HEAD_DIMS
PAGED_MAX_WINDOW = 16
_PAGED_SPLIT_KEYS = 512


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


def _check_aligned(**tensors) -> None:
    """The bf16 tensor-core kernels copy 16-byte chunks with cp.async."""
    for name, tensor in tensors.items():
        if tensor.dtype == torch.bfloat16 and tensor.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: bf16 {name} must "
                             f"start on a 16-byte boundary")


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
    _check_aligned(q=q, k=k, v=v, dout=dout)
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
    kernels.count_launch(kernel)


def _diagonal(causal: bool, q_offset: int, q_len: int, k_len: int) -> int:
    return int(q_offset) + (k_len - q_len) if causal else 0


_META_FLOPS: contextvars.ContextVar = contextvars.ContextVar(
    "aiko_meta_flops", default=())


@contextlib.contextmanager
def count_meta_flops():
    """A scope that counts the flash-attention forward's operations on
    meta tensors (4 B H D per visible (query, key) pair: the two
    products): yields a one-entry list holding the running total."""
    total = [0]
    token = _META_FLOPS.set(_META_FLOPS.get() + (total,))
    try:
        yield total
    finally:
        _META_FLOPS.reset(token)


def _visible_pairs(q_len: int, k_len: int, causal: bool,
                   diagonal: int) -> int:
    """(query, key) pairs the forward computes: all, or under the causal
    diagonal k_pos <= q_pos + diagonal."""
    if not causal:
        return q_len * k_len
    return sum(min(max(row + diagonal + 1, 0), k_len)
               for row in range(q_len))


def _meta_forward(q, causal: bool, q_offset: int, k_len: int):
    batch, heads, q_len, head_dim = q.shape
    pairs = _visible_pairs(q_len, k_len, causal,
                           _diagonal(causal, q_offset, q_len, k_len))
    for total in _META_FLOPS.get():
        total[0] += 4 * batch * heads * head_dim * pairs
    return (torch.empty_like(q),
            torch.empty((batch, heads, q_len), dtype=torch.float32,
                        device=q.device))


def _flash_kernel_forward(q, k, v, causal: bool, sm_scale: float,
                          q_offset: int):
    _check_kernel_inputs(q, k, v)
    _check_aligned(q=q, k=k, v=v)
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


def _check_paged_inputs(q, k_pool, v_pool, tables, positions) -> None:
    where = "paged decode attention kernel"
    for name, tensor in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                         ("tables", tables), ("positions", positions)):
        if tensor.device.type != "cuda" or tensor.device != q.device:
            raise ValueError(f"{where}: {name} is on {tensor.device}, not "
                             f"q's CUDA device")
        if not tensor.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous")
    for name, tensor in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if tensor.dtype != torch.bfloat16 or tensor.dim() != 4:
            raise TypeError(f"{where}: {name} must be 4-D bfloat16, got "
                            f"{tensor.dtype} {tuple(tensor.shape)}")
    for name, tensor in (("tables", tables), ("positions", positions)):
        if tensor.dtype != torch.int32:
            raise TypeError(f"{where}: {name} must be int32, got "
                            f"{tensor.dtype}")
    slots, heads, window, head_dim = q.shape
    kv_heads = k_pool.shape[1]
    if head_dim not in PAGED_HEAD_DIMS:
        raise ValueError(f"{where} takes head_dim in {PAGED_HEAD_DIMS}, "
                         f"got {head_dim}")
    if not 1 <= window <= PAGED_MAX_WINDOW:
        raise ValueError(f"{where} takes 1 to {PAGED_MAX_WINDOW} window "
                         f"rows, got {window}")
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != head_dim or (
            heads % kv_heads):
        raise ValueError(f"{where}: pools {tuple(k_pool.shape)} and "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)} (num_blocks, H_kv, bs, D) with "
                         f"H a multiple of H_kv")
    if tables.dim() != 2 or tables.shape[0] != slots or (
            positions.shape != (slots,)):
        raise ValueError(f"{where}: tables {tuple(tables.shape)} and "
                         f"positions {tuple(positions.shape)} do not match "
                         f"{slots} slots")
    _check_aligned(q=q, k_pool=k_pool, v_pool=v_pool)


def paged_decode_attention(q, k_pool, v_pool, tables, positions,
                           sm_scale: float):
    """K4: attention of q (S, H, W, D) bf16 over one layer's paged K and
    V pools (num_blocks, H_kv, bs, D) bf16, read in place through the
    block tables (S, MB) int32: row w of slot s sees the keys
    0 .. positions[s] + w (int32 (S,), on the device), as many as the
    table holds.  Returns (S, H, W, D) bf16.  Two launches, each counted:
    every split of 512 positions a slot's rows see, then the merge of a
    row's splits; the scratch between them is allocated here.  CUDA
    tensors only; raises on anything the kernel does not take."""
    _check_paged_inputs(q, k_pool, v_pool, tables, positions)
    slots, heads, window, head_dim = q.shape
    kv_heads, block_size = k_pool.shape[1], k_pool.shape[2]
    max_blocks = tables.shape[1]
    splits = -(-max_blocks * block_size // _PAGED_SPLIT_KEYS)
    rows = slots * heads * window
    part_ml = torch.empty((rows, splits, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((rows, splits, head_dim), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    shape = (slots, heads, kv_heads, window, head_dim, max_blocks,
             block_size, splits)
    _launch("paged_decode_attention", "aiko_paged_decode_attention",
            q.device, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), positions.data_ptr(), part_ml.data_ptr(),
            part_acc.data_ptr(), *shape, float(sm_scale))
    _launch("paged_decode_attention", "aiko_paged_decode_attention_merge",
            q.device, part_ml.data_ptr(), part_acc.data_ptr(),
            positions.data_ptr(), out.data_ptr(), *shape)
    return out


# -- dispatch ------------------------------------------------------------------

def flash_attention_forward(q, k, v, causal: bool = False, sm_scale=None,
                            q_offset: int = 0):
    """(O, LSE): O (B, H, Lq, D) in q's dtype, LSE f32 (B, H, Lq).

    The causal diagonal is k_pos <= q_pos + q_offset + (Lk - Lq); keys
    past Lk do not exist.  CPU tensors take the plain version; CUDA
    tensors launch the kernel; meta tensors get the output contract
    (and the operation count, count_meta_flops); anything else
    raises."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "meta":
        return _meta_forward(q, bool(causal), int(q_offset), k.shape[2])
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


# -- sequence parallelism ----------------------------------------------------
#
# The grid forms -- ring_attention_grid, ulysses_attention_grid and
# sp_decode_grid -- are the JAX package's *_sharded functions inside
# shard_map: each takes position grids (parallel/collectives.py) whose
# position i along the axis holds block i of the sequence ((B, H, L/n, D)
# for the ring and Ulysses, window i of the cache for the sp decode) and
# moves data between the positions only through the collectives: a ring
# hop is one ppermute over the axis (a device copy on a mesh one process
# drives, a point-to-point transfer between processes on a global
# mesh), Ulysses' swaps are all_to_alls, the sp decode's merge one pmax
# and one psum.  So one code path serves a mesh of one process and a
# "seq" axis that spans processes.  The whole-tensor entry points
# (ring_attention, ulysses_attention, sp_decode_attention) cut their
# inputs into a grid over the axis's devices (a line this process
# drives), call the grid form and gather its result.

def _resolve_mesh(mesh, what: str):
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        raise ValueError(f"{what} needs a mesh: pass mesh= or call it "
                         f"inside parallel.use_mesh(mesh)")
    return mesh


def _line(mesh, axis_name: str, length: int, what: str) -> Mesh:
    """The 1-D mesh of the devices along `axis_name` (Mesh.axis_devices),
    driven by this process; ValueError unless `length` (the sharded
    sequence) divides by their number."""
    devices = mesh.axis_devices(axis_name)
    if length % len(devices):
        raise ValueError(f"{what}: sequence length ({length}) must be "
                         f"divisible by mesh axis '{axis_name}' size "
                         f"({len(devices)})")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid, (axis_name,))


class _Split(torch.autograd.Function):
    """x cut along `dim` into one block per device (each made contiguous
    when `contiguous`); the backward concatenates the blocks' gradients
    once, where autograd through n narrowed blocks would fill n whole
    tensors with zeros and add them."""

    @staticmethod
    def forward(ctx, x, devices, dim: int, contiguous: bool):
        local = x.shape[dim] // len(devices)
        ctx.home, ctx.dim = x.device, dim
        ctx.like = (tuple(x.narrow(dim, 0, local).shape), x.dtype)
        blocks = (x.narrow(dim, index * local, local).to(device)
                  for index, device in enumerate(devices))
        return tuple(block.contiguous() if contiguous else block
                     for block in blocks)

    @staticmethod
    def backward(ctx, *grads):
        shape, dtype = ctx.like
        return torch.cat([
            torch.zeros(shape, dtype=dtype, device=ctx.home) if grad is None
            else grad.to(ctx.home) for grad in grads], dim=ctx.dim), \
            None, None, None


def _split_grid(x, line: Mesh, dim: int = 2,
                contiguous: bool = True) -> np.ndarray:
    """x cut along `dim` into one block per position of the line, each on
    its position's device."""
    grid = np.empty(line.devices.size, dtype=object)
    for index, block in enumerate(_Split.apply(
            x, list(line.devices.flat), dim, contiguous)):
        grid[index] = block
    return grid


def _gather_grid(grid: np.ndarray, device, dim: int = 2):
    return torch.cat([block.to(device) for block in grid.flat], dim=dim)


def _pack(*tensors):
    """The tensors' bytes in one flat uint8 tensor: a ring hop moves its
    blocks in one exchange."""
    return torch.cat([tensor.contiguous().reshape(-1).view(torch.uint8)
                      for tensor in tensors])


def _unpack(packed, likes) -> tuple:
    """_pack's tensors back from its bytes: likes is [(shape, dtype)]
    (wider types first, so each view starts on its type's boundary)."""
    out, start = [], 0
    for shape, dtype in likes:
        size = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        out.append(packed[start:start + size].view(dtype).view(shape))
        start += size
    return tuple(out)


def _hop(grid: np.ndarray, mesh, axis_name: str, label) -> np.ndarray:
    """One ring hop of a grid of tensor tuples: position i receives what
    position i - 1 held, in one ppermute.  Across processes the tuples
    travel as their bytes in one block; within one process they move as
    they are (a device copy, or none at all on one card)."""
    size = mesh.size(axis_name)
    perm = [(i, (i + 1) % size) for i in range(size)]
    if axis_name not in mesh.process_axes:
        return ppermute(grid, mesh, axis_name, perm, label=label)
    likes = [(tensor.shape, tensor.dtype)
             for tensor in next(entry for entry in grid.flat
                                if entry is not None)]
    moved = ppermute(map_shards(lambda entry: _pack(*entry), grid), mesh,
                     axis_name, perm, label=label)
    return map_shards(lambda packed: _unpack(packed, likes), moved)


# -- ring attention ----------------------------------------------------------

# Test hook: when set to a callable, it is called with the hop's step once
# per EXECUTED forward hop -- hops skipped under causal masking never
# call it.  Tests use it to show that the masked-hop skip is real.
_RING_HOP_CALLBACK = None


def _merge_softmax_partials(out, lse, out_blk, lse_blk):
    """Associative merge of two normalized attention partials via their
    per-row logsumexp, in f32: the exact online-softmax combination."""
    lse_new = torch.logaddexp(lse, lse_blk)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_blk = torch.exp(lse_blk - lse_new)[..., None]
    return out.float() * w_old + out_blk.float() * w_blk, lse_new


def _skipped(causal: bool, step: int, index: int) -> bool:
    """Position `index` holds the K/V of block (index - step) mod n at
    hop `step`: entirely in the future of its queries, so fully masked,
    when the index wrapped (index < step)."""
    return causal and index < step


def _ring_forward(q, k, v, mesh, axis_name: str, causal: bool,
                  sm_scale: float, call: int) -> tuple:
    """(O grid in q's dtype, merged LSE grid f32).  Q stays put, K/V
    rotate n - 1 hops; step 0 (the diagonal block) is causal, every
    executed later hop holds strictly-past keys and runs dense, all with
    q_offset 0.  Partials accumulate in f32 and are cast once."""
    size = mesh.size(axis_name)
    index = axis_index(mesh, axis_name)

    def attend(step):
        def compute(q, kv, position, previous):
            if _skipped(causal, step, position):
                # the JAX package merges a zero partial with LSE -1e30:
                # weights exactly 1 and 0, the same result as no merge
                return previous
            out_blk, lse_blk = flash_attention_forward(
                q, kv[0], kv[1], causal=causal and step == 0,
                sm_scale=sm_scale)
            if _RING_HOP_CALLBACK is not None:
                _RING_HOP_CALLBACK(step)
            if previous is None:
                return out_blk.float(), lse_blk
            return _merge_softmax_partials(*previous, out_blk, lse_blk)
        return compute

    kv = map_shards(lambda k, v: (k, v), k, v)
    state = map_shards(attend(0), q, kv, index,
                       np.full(q.shape, None, dtype=object))
    for step in range(1, size):
        kv = _hop(kv, mesh, axis_name, ("ring", call, step))
        state = map_shards(attend(step), q, kv, index, state)
    return (map_shards(lambda s, q: s[0].to(q.dtype), state, q),
            map_shards(lambda s: s[1], state))


def _ring_backward(q, k, v, out, lse, dout, mesh, axis_name: str,
                   causal: bool, sm_scale: float, call: int) -> tuple:
    """The second ring: each K/V block travels with f32 dK/dV
    accumulators, every executed hop runs the backward kernels against
    the forward's GLOBAL O and merged LSE (so a hop's partial gradients
    are the global attention's restricted to that block), and one last
    hop returns each accumulator to its home position.  Returns the dQ,
    dK and dV grids in q's, k's and v's dtypes."""
    size = mesh.size(axis_name)
    index = axis_index(mesh, axis_name)

    def attend(step):
        def compute(q, carried, o, l, d, position, dq):
            if _skipped(causal, step, position):
                return carried, dq
            dk, dv, k_blk, v_blk = carried
            dq_h, dk_h, dv_h = flash_attention_backward(
                q, k_blk, v_blk, o, l, d, causal=causal and step == 0,
                sm_scale=sm_scale)
            return ((dk + dk_h.float(), dv + dv_h.float(), k_blk, v_blk),
                    dq + dq_h.float())
        return compute

    # f32 accumulators first: _pack's views start on their boundaries
    carried = map_shards(lambda k, v: (
        torch.zeros(k.shape, dtype=torch.float32, device=k.device),
        torch.zeros(v.shape, dtype=torch.float32, device=v.device), k, v),
        k, v)
    dq = map_shards(lambda q: torch.zeros(q.shape, dtype=torch.float32,
                                          device=q.device), q)
    for step in range(size):
        if step:
            carried = _hop(carried, mesh, axis_name,
                           ("ring backward", call, step))
        both = map_shards(attend(step), q, carried, out, lse, dout, index,
                          dq)
        carried = map_shards(lambda pair: pair[0], both)
        dq = map_shards(lambda pair: pair[1], both)
    # block s sits at position (s + n - 1) mod n after the loop
    home = _hop(map_shards(lambda entry: entry[:2], carried), mesh,
                axis_name, ("ring home", call))
    return (map_shards(lambda grad, q: grad.to(q.dtype), dq, q),
            map_shards(lambda grads, k: grads[0].to(k.dtype), home, k),
            map_shards(lambda grads, v: grads[1].to(v.dtype), home, v))


class _RingGrid(torch.autograd.Function):
    """The JAX package's custom_vjp around _ring, on position grids: the
    forward (its hops run without autograd, as every Function's forward
    does) keeps the distinct local q, k, v, O and merged LSE; the
    backward is the second ring, never autograd through the hops.
    Across processes it takes the mesh's chain token and returns the next
    (collectives._link), so that its backward's exchanges run in one
    order on every process."""

    @staticmethod
    def forward(ctx, template, how, holder, chain, token, *tensors):
        out, lse = _ring_forward(*rebuild_tensors(template, tensors), *how)
        outs, lses = [], []
        holder["out"] = ctx.out = flatten_tensors(out, outs)
        ctx.lse = flatten_tensors(lse, lses)
        ctx.template, ctx.how, ctx.counts = template, how, (len(tensors),
                                                            len(outs))
        ctx.state = None if chain is None else chain.state
        ctx.save_for_backward(*tensors, *outs, *lses)
        return (None if token is None else torch.zeros(()), *outs)

    @staticmethod
    def backward(ctx, _, *douts):
        if ctx.state is not None:
            ctx.state.spent = True
        count, slots = ctx.counts
        saved = ctx.saved_tensors
        tensors, outs = saved[:count], saved[count:count + slots]
        q, k, v = rebuild_tensors(ctx.template, tensors)
        dout = rebuild_tensors(ctx.out, [
            torch.zeros_like(out) if grad is None else grad.contiguous()
            for grad, out in zip(douts, outs)])
        grids = _ring_backward(q, k, v, rebuild_tensors(ctx.out, outs),
                               rebuild_tensors(ctx.lse,
                                               saved[count + slots:]),
                               dout, *ctx.how)
        # positions holding the same q, k and v share their gradients:
        # each distinct triple adds its gradients once
        grads: list = [None] * count
        done = set()
        templates = [grid.reshape(-1) for grid in ctx.template]
        results = [grid.reshape(-1) for grid in grids]
        for index in range(q.size):
            places = tuple(tensor_place(grid, index) for grid in templates)
            if places[0] is None or places in done:
                continue
            done.add(places)
            for place, grid in zip(places, results):
                grad = grid[index]
                grads[place] = (grad if grads[place] is None
                                else grads[place] + grad)
        return (None, None, None, None,
                None if ctx.state is None else torch.zeros(()), *grads)


def ring_attention_grid(q, k, v, mesh, axis_name: str = "seq",
                        causal: bool = True, sm_scale=None) -> np.ndarray:
    """ring_attention_sharded on position grids: q, k, v hold at position
    i of `axis_name` block i of the sequence, (B, H, L/n, D) each; the
    result holds each position's block of O, differentiable in every
    local q, k and v.

    Each position keeps its query block; K/V rotate n - 1 hops (each one
    ppermute over the axis), and each executed hop is one
    flash_attention_forward (K1 on CUDA) whose (O, LSE) merges into the
    position's running partial.  Under causal masking the hop that
    brings position i the K/V of a later block is skipped -- no launch
    -- so position i runs i + 1 hops, n(n + 1)/2 along the axis.  The
    backward's second ring runs the dQ and dK/dV kernels (K2, K3) once an
    executed hop and returns the dK/dV accumulators home with one last
    ppermute."""
    tensors: list = []
    template = flatten_tensors((q, k, v), tensors)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(tensors[0].shape[-1])
    chain = token = None
    if (axis_name in mesh.process_axes and torch.is_grad_enabled()
            and any(tensor.requires_grad for tensor in tensors)):
        # the backward's exchanges cross processes: they take their
        # place in the mesh's chain
        chain, token = _link(mesh)
    mesh.calls["ring"] = call = mesh.calls.get("ring", 0) + 1
    holder: dict = {}
    token, *outs = _RingGrid.apply(
        template, (mesh, axis_name, bool(causal), float(sm_scale), call),
        holder, chain, token, *tensors)
    if chain is not None:
        chain.token = token
    return rebuild_tensors(holder["out"], outs)


def ring_attention(q, k, v, mesh=None, axis_name: str = "seq",
                   causal: bool = True, sm_scale=None):
    """Sequence-parallel attention over mesh axis `axis_name` (the
    ambient mesh when mesh=None): (B, H, L, D) in and out,
    differentiable in q, k and v.  The sequence is cut into one block
    per device of the axis and runs through ring_attention_grid: device
    i runs i + 1 hops under causal masking, n(n + 1)/2 in all."""
    line = _line(_resolve_mesh(mesh, "ring_attention"), axis_name,
                 q.shape[2], "ring_attention")
    out = ring_attention_grid(*(_split_grid(x, line) for x in (q, k, v)),
                              line, axis_name, causal, sm_scale)
    return _gather_grid(out, q.device)


# -- Ulysses (all-to-all) sequence parallelism -------------------------------

def ulysses_attention_grid(q, k, v, mesh, axis_name: str = "seq",
                           causal: bool = False,
                           sm_scale=None) -> np.ndarray:
    """ulysses_attention_sharded on position grids of (B, H, L/n, D)
    blocks: one all_to_all over the axis swaps sequence sharding for
    head sharding (q, k and v stacked: position i receives head group i
    over the whole sequence), flash_attention (K1, and K2/K3 in the
    backward) runs on each (B, H/n, L, D) group, and a second all_to_all
    swaps back.  Differentiable through the all_to_alls.  The head count
    must divide by the axis size."""
    _check_heads(next(entry for entry in q.flat
                      if entry is not None).shape[1], mesh, axis_name)
    groups = all_to_all(map_shards(lambda q, k, v: torch.stack([q, k, v]),
                                   q, k, v), mesh, axis_name, split_dim=2,
                        concat_dim=3)
    return all_to_all(_ulysses_groups(groups, causal, sm_scale), mesh,
                      axis_name, split_dim=2, concat_dim=1)


def _check_heads(heads: int, mesh, axis_name: str) -> None:
    size = mesh.size(axis_name)
    if heads % size != 0:
        raise ValueError(
            f"ulysses_attention: heads ({heads}) must be divisible by "
            f"mesh axis '{axis_name}' size ({size}); use "
            f"ring_attention for head counts smaller than the axis")


def _ulysses_groups(groups: np.ndarray, causal: bool, sm_scale):
    """flash_attention (K1, and K2/K3 in the backward) on each position's
    (q, k, v) head group over the whole sequence."""
    return map_shards(lambda qkv: flash_attention(
        qkv[0], qkv[1], qkv[2], causal=causal, sm_scale=sm_scale), groups)


def ulysses_attention(q, k, v, mesh=None, axis_name: str = "seq",
                      causal: bool = False, sm_scale=None):
    """DeepSpeed-Ulysses style over mesh axis `axis_name` (the ambient
    mesh when mesh=None): (B, H, L, D) in and out.  The whole tensor is
    what ulysses_attention_grid's first all_to_all gathers, so each
    device of the axis takes its head group over the whole sequence
    directly, runs the grid form's per-group attention, and the groups
    are gathered back on the heads."""
    line = _line(_resolve_mesh(mesh, "ulysses_attention"), axis_name,
                 q.shape[2], "ulysses_attention")
    _check_heads(q.shape[1], line, axis_name)
    groups = map_shards(lambda *qkv: qkv, *(_split_grid(x, line, dim=1)
                                            for x in (q, k, v)))
    return _gather_grid(_ulysses_groups(groups, causal, sm_scale),
                        q.device, dim=1)


# -- sequence-parallel decode attention --------------------------------------

def sp_decode_grid(q, cache_k, cache_v, pos, mesh, axis_name: str = "seq",
                   sm_scale=None) -> np.ndarray:
    """sp_decode_attention_sharded on position grids: q (B, H, Lq, D) the
    same at every position of a line, position i's cache window i (B,
    Hkv, Lc/n, D), Hkv dividing H.  Each position attends q over its
    window (positions past pos + i masked; GQA contracting the grouped q
    heads against the un-expanded window); the partials merge exactly
    with one max over the axis (pmax) and ONE sum of the fused [num,
    den] (psum), so every position gets the output.  Plain torch: the
    JAX package computes it as einsums outside any Pallas kernel."""
    index = axis_index(mesh, axis_name)

    def scores(q, k_local, position):
        batch, kv_heads, local_len, head_dim = k_local.shape
        q_len = q.shape[2]
        scale = (1.0 / math.sqrt(head_dim) if sm_scale is None
                 else sm_scale)
        device = k_local.device
        grouped = q.reshape(batch, kv_heads, q.shape[1] // kv_heads, q_len,
                            head_dim)
        k_pos = position * local_len + torch.arange(local_len,
                                                    device=device)
        q_pos = torch.as_tensor(pos, device=device) + torch.arange(
            q_len, device=device)
        s = torch.matmul(grouped.float(),
                         k_local.float()[:, :, None].transpose(-1, -2)) \
            * scale                                    # (B, Hkv, G, Lq, Lk)
        return s.masked_fill(k_pos[None, :] > q_pos[:, None], _NEG_INF)

    s = map_shards(scores, q, cache_k, index)
    m_global = pmax(map_shards(lambda s: s.amax(dim=-1), s), mesh,
                    axis_name)                        # (B, Hkv, G, Lq)

    def partial(s, m, v_local):
        p = torch.exp(s - m[..., None])
        return torch.cat([torch.matmul(p, v_local.float()[:, :, None]),
                          p.sum(dim=-1, keepdim=True)], dim=-1)
    fused = psum(map_shards(partial, s, m_global, cache_v), mesh, axis_name)

    def finish(fused, q):
        head_dim = q.shape[-1]
        num, den = fused[..., :head_dim], fused[..., head_dim:]
        out = (num / torch.clamp_min(den, 1e-30)).to(q.dtype)
        return out.reshape(q.shape)
    return map_shards(finish, fused, q)


def sp_decode_attention(q, cache_k, cache_v, pos, mesh=None,
                        axis_name: str = "seq", sm_scale=None,
                        batch_axis: str = "data", head_axis: str = "model"):
    """KV-cached decode with the cache length sharded over `axis_name`:
    q (B, H, Lq, D) replicated, cache (B, Hkv, Lc, D) with Hkv dividing
    H -- sp_decode_grid over the axis's devices, each holding its
    contiguous window of the cache; the output lands on q's device.
    q's and the cache's specs shard batch on `batch_axis` and heads on
    `head_axis` where the mesh has them."""
    mesh = _resolve_mesh(mesh, "sp_decode_attention")
    names = mesh.axis_names
    b_ax = batch_axis if batch_axis in names else None
    h_ax = head_axis if head_axis in names else None
    named_sharding(mesh, PartitionSpec(b_ax, h_ax, None, None)).shard_shape(
        tuple(q.shape))
    named_sharding(mesh, PartitionSpec(b_ax, h_ax, axis_name, None)) \
        .shard_shape(tuple(cache_k.shape))
    line = _line(mesh, axis_name, cache_k.shape[2], "sp_decode_attention")
    queries = np.empty(line.devices.size, dtype=object)
    for index, device in enumerate(line.devices.flat):
        queries[index] = q.to(device)
    out = sp_decode_grid(queries, _split_grid(cache_k, line,
                                              contiguous=False),
                         _split_grid(cache_v, line, contiguous=False), pos,
                         line, axis_name,
                         sm_scale)
    return out.flat[0].to(q.device)
