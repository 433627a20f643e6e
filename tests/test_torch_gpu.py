# The port's CUDA kernels against their plain PyTorch versions, on the
# card.  Every test here needs an NVIDIA GPU and nvcc: it is marked `gpu`
# and skips, with its reason, where there is none.  This file imports no
# JAX, so it also runs where only PyTorch is installed:
#
#   python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
#
# Tolerances: bf16 outputs are compared with atol/rtol 2e-2 (one bf16
# rounding of values of order 1, plus f32 sums taken in another order);
# f32 outputs with atol 1e-5; the f32 logsumexp with atol 1e-4 (a log of
# a sum of up to 300 terms, summed in another order).  Gradients: bf16
# per-tensor relative error ||g - g_ref|| / ||g_ref|| <= 2e-2 (the
# tensor-core kernels round P and dS to bf16 before the second product
# and each gradient once more, 2^-9 relative each, and sum up to 1024 f32
# terms in another order); f32 atol 1e-4 (sums of up to 251 f32 products
# of order 1 in another order).

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.ops import kernels
from aiko_services_tpu_torch.parallel.attention import (
    flash_attention, flash_attention_backward,
    flash_attention_backward_plain, flash_attention_forward,
    flash_attention_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _qkv(shape_q, shape_k, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q, dtype=np.float32)
    k = rng.standard_normal(shape_k, dtype=np.float32)
    v = rng.standard_normal(shape_k, dtype=np.float32)
    return [torch.from_numpy(x).to(device=device, dtype=dtype)
            for x in (q, k, v)]


CASES = {
    # name: (B, H, Lq, Lk, D, dtype, causal, q_offset)
    "encoder_bf16": (4, 12, 251, 251, 64, torch.bfloat16, False, 0),
    "causal_300": (2, 4, 300, 300, 64, torch.bfloat16, True, 0),
    "causal_decode_offset": (2, 4, 37, 251, 64, torch.bfloat16, True, 0),
    "cross_37x251": (2, 4, 37, 251, 64, torch.bfloat16, False, 0),
    "asr_tones_f32": (4, 4, 12, 12, 16, torch.float32, False, 0),
    "f32_causal_q_offset": (2, 3, 50, 130, 32, torch.float32, True, -7),
    "f32_d128_ragged": (1, 2, 65, 129, 128, torch.float32, False, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case):
    batch, heads, q_len, k_len, dim, dtype, causal, q_offset = CASES[case]
    q, k, v = _qkv((batch, heads, q_len, dim), (batch, heads, k_len, dim),
                   dtype, cuda)
    before = kernels.launch_counts["flash_attention"]
    out, lse = flash_attention_forward(q, k, v, causal=causal,
                                       q_offset=q_offset)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention"] == before + 1
    ref_out, ref_lse = flash_attention_plain(
        q.float(), k.float(), v.float(), causal=causal, q_offset=q_offset)
    assert out.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref_out, atol=2e-2,
                                   rtol=2e-2)
    else:
        torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 8, 48), (1, 2, 8, 48), torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_forward(q, k, v)
    q, k, v = _qkv((1, 2, 8, 16), (1, 2, 8, 16), torch.float16, cuda)
    with pytest.raises(TypeError, match="float32 or"):
        flash_attention_forward(q, k, v)
    q, k, v = _qkv((1, 8, 2, 16), (1, 8, 2, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_forward(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2))


BACKWARD_CASES = {
    # name: (B, H, Lq, Lk, D, dtype, causal, q_offset)
    "lm_training_bf16": (1, 4, 1024, 1024, 64, torch.bfloat16, True, 0),
    "encoder_bf16": (2, 4, 251, 251, 64, torch.bfloat16, False, 0),
    "cross_16x251_bf16": (2, 4, 16, 251, 64, torch.bfloat16, False, 0),
    "causal_37x251_bf16": (2, 4, 37, 251, 64, torch.bfloat16, True, 0),
    "d16_causal_bf16": (2, 4, 200, 200, 16, torch.bfloat16, True, 0),
    "d32_causal_bf16": (2, 4, 300, 300, 32, torch.bfloat16, True, 0),
    "d128_causal_bf16": (1, 4, 520, 520, 128, torch.bfloat16, True, 0),
    "ragged_65x129_d128_bf16": (1, 2, 65, 129, 128, torch.bfloat16, False,
                                0),
    "causal_q_offset_bf16": (2, 3, 50, 130, 32, torch.bfloat16, True, -7),
    "f32_causal_q_offset": (2, 3, 50, 130, 32, torch.float32, True, -7),
    "f32_d128_ragged": (1, 2, 65, 129, 128, torch.float32, False, 0),
    "asr_tones_f32": (4, 4, 12, 12, 16, torch.float32, False, 0),
}


def _relative_error(actual, expected):
    return ((actual.float() - expected).norm() / expected.norm()).item()


@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_backward_kernels_match_plain(cuda, case):
    batch, heads, q_len, k_len, dim, dtype, causal, q_offset = (
        BACKWARD_CASES[case])
    q, k, v = _qkv((batch, heads, q_len, dim), (batch, heads, k_len, dim),
                   dtype, cuda, seed=1)
    dout = _qkv((batch, heads, q_len, dim), (batch, heads, 1, dim), dtype,
                cuda, seed=2)[0]
    out, lse = flash_attention_forward(q, k, v, causal=causal,
                                       q_offset=q_offset)
    before = dict(kernels.launch_counts)
    grads = flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                     q_offset=q_offset)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention_dq"] == (
        before["flash_attention_dq"] + 1)
    assert kernels.launch_counts["flash_attention_dkv"] == (
        before["flash_attention_dkv"] + 1)
    expected = flash_attention_backward_plain(
        q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
        causal=causal, q_offset=q_offset)
    for got, want, name in zip(grads, expected, ("dq", "dk", "dv")):
        assert got.dtype == dtype and got.shape == want.shape, name
        if dtype == torch.bfloat16:
            assert _relative_error(got, want) <= 2e-2, name
        else:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0,
                                       msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernels_are_bitwise_repeatable(cuda, dtype):
    """Each output tile has one owner block and no atomics: two launches
    on the same inputs give the same bits."""
    q, k, v = _qkv((2, 4, 300, 64), (2, 4, 300, 64), dtype, cuda, seed=3)
    dout = _qkv((2, 4, 300, 64), (2, 4, 1, 64), dtype, cuda, seed=4)[0]
    out, lse = flash_attention_forward(q, k, v, causal=True)
    first = flash_attention_backward(q, k, v, out, lse, dout, causal=True)
    second = flash_attention_backward(q, k, v, out, lse, dout, causal=True)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


def test_flash_attention_carries_a_gradient_on_cuda(cuda):
    q, k, v = [tensor.requires_grad_(True) for tensor in _qkv(
        (1, 2, 40, 64), (1, 2, 40, 64), torch.bfloat16, cuda)]
    before = dict(kernels.launch_counts)
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    # the cotangent arrives transposed, as from the model's head merge
    out.transpose(1, 2).sum().backward()
    torch.cuda.synchronize()
    for name in ("flash_attention", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    assert all(tensor.grad is not None and torch.isfinite(tensor.grad).all()
               for tensor in (q, k, v))


def test_backward_wrappers_reject_what_they_do_not_take(cuda):
    q, k, v = _qkv((1, 2, 8, 16), (1, 2, 8, 16), torch.float32, cuda)
    out, lse = flash_attention_forward(q, k, v)
    dout = torch.ones_like(q)
    with pytest.raises(ValueError, match="dout must be contiguous"):
        flash_attention_backward(q, k, v, out, lse,
                                 dout.transpose(2, 3).contiguous()
                                 .transpose(2, 3))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward(q, k, v, out, lse.double(), dout)
    with pytest.raises(ValueError, match="does not match q"):
        flash_attention_backward(q, k, v, out, lse, dout.bfloat16())
    q48, k48, v48 = _qkv((1, 2, 8, 48), (1, 2, 8, 48), torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_backward(q48, k48, v48, q48, lse, q48)
    # the bf16 kernels copy 16-byte chunks: a tensor starting 2 bytes in
    # is refused
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    shifted = torch.empty(qb.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(qb.shape)
    shifted.copy_(qb)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention_backward(shifted, kb, vb, out.bfloat16(), lse,
                                 qb)
