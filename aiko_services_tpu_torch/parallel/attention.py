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

import torch

from ..ops import kernels
from .mesh import PartitionSpec, ambient_mesh, named_sharding

__all__ = ["attention_reference", "flash_attention", "count_meta_flops",
           "flash_attention_forward", "flash_attention_plain",
           "flash_attention_backward", "flash_attention_backward_plain",
           "flash_attention_dq_plain", "flash_attention_dkv_plain",
           "ring_attention", "ulysses_attention", "sp_decode_attention",
           "sp_decode_shards"]

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
    kernels.launch_counts[kernel] += 1


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


# -- sequence parallelism: the shards --------------------------------------

def _resolve_mesh(mesh, what: str):
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        raise ValueError(f"{what} needs a mesh: pass mesh= or call it "
                         f"inside parallel.use_mesh(mesh)")
    return mesh


def _axis(mesh, axis_name: str, length: int, what: str) -> list:
    """The devices of `axis_name`; ValueError unless `length` (the
    sharded sequence) divides by their number."""
    devices = mesh.axis_devices(axis_name)
    if length % len(devices):
        raise ValueError(f"{what}: sequence length ({length}) must be "
                         f"divisible by mesh axis '{axis_name}' size "
                         f"({len(devices)})")
    return devices


def _split(x, devices: list) -> list:
    """(B, H, L, D) -> one contiguous (B, H, L/n, D) shard per device."""
    local = x.shape[2] // len(devices)
    return [x[:, :, index * local:(index + 1) * local].to(device)
            .contiguous() for index, device in enumerate(devices)]


def _gather(shards: list, device, dim: int = 2):
    return torch.cat([shard.to(device) for shard in shards], dim=dim)


def _rotate(shards: list, devices: list) -> list:
    """The ring's ppermute: device i receives what device i - 1 held."""
    return [tuple(x.to(device) for x in shards[index - 1])
            for index, device in enumerate(devices)]


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
    """Device `index` holds the K/V of shard (index - step) mod n at hop
    `step`: entirely in the future of its queries, so fully masked, when
    the index wrapped (index < step)."""
    return causal and index < step


def _ring_forward(q_shards, k_shards, v_shards, devices, causal: bool,
                  sm_scale: float):
    """Per-shard (O in q's dtype, merged LSE f32).  Q stays put, K/V
    rotate n - 1 hops; step 0 (the diagonal block) is causal, every
    executed later hop holds strictly-past keys and runs dense, all with
    q_offset 0.  Partials accumulate in f32 and are cast once."""
    outs, lses = [None] * len(devices), [None] * len(devices)
    kv = list(zip(k_shards, v_shards))
    for step in range(len(devices)):
        if step:
            kv = _rotate(kv, devices)
        for index, (k_blk, v_blk) in enumerate(kv):
            if _skipped(causal, step, index):
                # the JAX package merges a zero partial with LSE -1e30:
                # weights exactly 1 and 0, the same result as no merge
                continue
            out_blk, lse_blk = flash_attention_forward(
                q_shards[index], k_blk, v_blk, causal=causal and step == 0,
                sm_scale=sm_scale)
            if _RING_HOP_CALLBACK is not None:
                _RING_HOP_CALLBACK(step)
            if step == 0:
                outs[index], lses[index] = out_blk.float(), lse_blk
            else:
                outs[index], lses[index] = _merge_softmax_partials(
                    outs[index], lses[index], out_blk, lse_blk)
    dtype = q_shards[0].dtype
    return [out.to(dtype) for out in outs], lses


def _ring_backward(q_shards, k_shards, v_shards, out_shards, lse_shards,
                   dout_shards, devices, causal: bool, sm_scale: float):
    """The second ring: each K/V shard travels with f32 dK/dV
    accumulators, every executed hop runs the backward kernels against
    the forward's GLOBAL O and merged LSE (so a hop's partial gradients
    are the global attention's restricted to that shard), and one last
    rotation returns each accumulator to its home device."""
    count = len(devices)
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in q_shards]
    kv = [(k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
           torch.zeros(v.shape, dtype=torch.float32, device=v.device))
          for k, v in zip(k_shards, v_shards)]
    for step in range(count):
        if step:
            kv = _rotate(kv, devices)
        for index in range(count):
            if _skipped(causal, step, index):
                continue
            k_blk, v_blk, dk_blk, dv_blk = kv[index]
            dq_h, dk_h, dv_h = flash_attention_backward(
                q_shards[index], k_blk, v_blk, out_shards[index],
                lse_shards[index], dout_shards[index],
                causal=causal and step == 0, sm_scale=sm_scale)
            dq[index] = dq[index] + dq_h.float()
            kv[index] = (k_blk, v_blk, dk_blk + dk_h.float(),
                         dv_blk + dv_h.float())
    # shard s sits on device (s + n - 1) mod n after the loop
    kv = _rotate(kv, devices)
    return ([grad.to(q.dtype) for grad, q in zip(dq, q_shards)],
            [entry[2].to(k.dtype) for entry, k in zip(kv, k_shards)],
            [entry[3].to(v.dtype) for entry, v in zip(kv, v_shards)])


class _RingAttention(torch.autograd.Function):
    """The JAX package's custom_vjp around _ring: the forward keeps each
    shard's q, k, v, O and merged LSE, the backward runs the second
    ring.  devices, causal and sm_scale get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, devices, causal: bool, sm_scale: float):
        shards = [_split(x, devices) for x in (q, k, v)]
        outs, lses = _ring_forward(*shards, devices, causal, sm_scale)
        ctx.save_for_backward(*shards[0], *shards[1], *shards[2], *outs,
                              *lses)
        ctx.devices, ctx.causal, ctx.sm_scale = devices, causal, sm_scale
        ctx.home = q.device
        return _gather(outs, q.device)

    @staticmethod
    def backward(ctx, dout):
        count = len(ctx.devices)
        saved = ctx.saved_tensors
        q_shards, k_shards, v_shards, outs, lses = (
            list(saved[part * count:(part + 1) * count])
            for part in range(5))
        dq, dk, dv = _ring_backward(
            q_shards, k_shards, v_shards, outs, lses,
            _split(dout, ctx.devices), ctx.devices, ctx.causal,
            ctx.sm_scale)
        return (_gather(dq, ctx.home), _gather(dk, ctx.home),
                _gather(dv, ctx.home), None, None, None)


def ring_attention(q, k, v, mesh=None, axis_name: str = "seq",
                   causal: bool = True, sm_scale=None):
    """Sequence-parallel attention over mesh axis `axis_name` (the
    ambient mesh when mesh=None): (B, H, L, D) in and out,
    differentiable in q, k and v.

    Each device of the axis keeps its query shard; K/V shards rotate
    n - 1 hops around the ring, and each executed hop is one
    flash_attention_forward (the forward kernel on CUDA) whose (O, LSE)
    merges into the shard's running partial.  Under causal masking the
    hop that brings device i the K/V of a later shard is skipped -- no
    launch -- so device i runs i + 1 hops, n(n + 1)/2 in all."""
    devices = _axis(_resolve_mesh(mesh, "ring_attention"), axis_name,
                    q.shape[2], "ring_attention")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q, k, v, devices, bool(causal),
                                float(sm_scale))


# -- Ulysses (all-to-all) sequence parallelism -------------------------------

def ulysses_attention(q, k, v, mesh=None, axis_name: str = "seq",
                      causal: bool = False, sm_scale=None):
    """DeepSpeed-Ulysses style: the all-to-all swaps sequence sharding
    for head sharding -- device i receives head group i over the whole
    sequence -- flash_attention (differentiable: the backward kernels in
    training) runs on each (B, H/n, L, D) group, and the second
    all-to-all swaps back.  The head count must divide by the axis
    size."""
    mesh = _resolve_mesh(mesh, "ulysses_attention")
    devices = _axis(mesh, axis_name, q.shape[2], "ulysses_attention")
    axis_size, heads = len(devices), q.shape[1]
    if heads % axis_size != 0:
        raise ValueError(
            f"ulysses_attention: heads ({heads}) must be divisible by "
            f"mesh axis '{axis_name}' size ({axis_size}); use "
            f"ring_attention for head counts smaller than the axis")
    group = heads // axis_size
    outs = []
    for index, device in enumerate(devices):
        heads_slice = slice(index * group, (index + 1) * group)
        q_i, k_i, v_i = (x[:, heads_slice].to(device).contiguous()
                         for x in (q, k, v))
        outs.append(flash_attention(q_i, k_i, v_i, causal=causal,
                                    sm_scale=sm_scale))
    return _gather(outs, q.device, dim=1)


# -- sequence-parallel decode attention --------------------------------------

def sp_decode_attention(q, cache_k, cache_v, pos, mesh=None,
                        axis_name: str = "seq", sm_scale=None,
                        batch_axis: str = "data", head_axis: str = "model"):
    """KV-cached decode with the cache length sharded over `axis_name`:
    q (B, H, Lq, D) replicated, cache (B, Hkv, Lc, D) with Hkv dividing
    H.  Each device attends q over its local cache shard (positions past
    pos + i masked), GQA contracting the grouped q heads against the
    un-expanded shard; the partials merge exactly with one max over the
    shards (the pmax) and ONE sum of the fused [num, den] (the psum).
    Plain torch: the JAX package computes it as einsums outside any
    Pallas kernel.  q's and the cache's specs shard batch on
    `batch_axis` and heads on `head_axis` where the mesh has them."""
    mesh = _resolve_mesh(mesh, "sp_decode_attention")
    names = mesh.axis_names
    b_ax = batch_axis if batch_axis in names else None
    h_ax = head_axis if head_axis in names else None
    named_sharding(mesh, PartitionSpec(b_ax, h_ax, None, None)).shard_shape(
        tuple(q.shape))
    named_sharding(mesh, PartitionSpec(b_ax, h_ax, axis_name, None)) \
        .shard_shape(tuple(cache_k.shape))
    devices = mesh.axis_devices(axis_name)
    local_len = cache_k.shape[2] // len(devices)
    windows = [slice(index * local_len, (index + 1) * local_len)
               for index in range(len(devices))]
    return sp_decode_shards(
        [q.to(device) for device in devices],
        [cache_k[:, :, window].to(device)
         for window, device in zip(windows, devices)],
        [cache_v[:, :, window].to(device)
         for window, device in zip(windows, devices)],
        pos, q.device, sm_scale)


def sp_decode_shards(q_shards: list, k_shards: list, v_shards: list, pos,
                     home, sm_scale=None):
    """sp_decode_attention on shards that already lie on their devices:
    q (B, H, Lq, D) once per device, device i's contiguous window i of
    the cache (B, Hkv, Lc/n, D).  Each device attends over its window
    (positions past pos + i masked), the partials merge with one max and
    one sum of the fused [num, den] on `home`, where the output lands."""
    batch, kv_heads, local_len, head_dim = k_shards[0].shape
    q_len, heads = q_shards[0].shape[2], q_shards[0].shape[1]
    groups = heads // kv_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    scores = []
    for index, (q, k_local) in enumerate(zip(q_shards, k_shards)):
        device = k_local.device
        q_grouped = q.reshape(batch, kv_heads, groups, q_len, head_dim)
        k_pos = index * local_len + torch.arange(local_len, device=device)
        q_pos = torch.as_tensor(pos, device=device) + torch.arange(
            q_len, device=device)
        s = torch.matmul(q_grouped.float(),
                         k_local.float()[:, :, None].transpose(-1, -2)) \
            * sm_scale                                 # (B, Hkv, G, Lq, Lk)
        scores.append(s.masked_fill(k_pos[None, :] > q_pos[:, None],
                                    _NEG_INF))
    m_global = torch.stack([s.amax(dim=-1).to(home) for s in scores]) \
        .amax(dim=0)                                   # (B, Hkv, G, Lq)
    fused = None
    for s, v_local in zip(scores, v_shards):
        p = torch.exp(s - m_global.to(s.device)[..., None])
        num = torch.matmul(p, v_local.float()[:, :, None])
        den = p.sum(dim=-1, keepdim=True)
        part = torch.cat([num, den], dim=-1).to(home)
        fused = part if fused is None else fused + part
    num, den = fused[..., :head_dim], fused[..., head_dim:]
    out = (num / torch.clamp_min(den, 1e-30)).to(q_shards[0].dtype)
    return out.reshape(batch, heads, q_len, head_dim)
