# The port's attention (parallel/attention.py) against the JAX package's
# on the CPU: the same numpy inputs through JAX's Pallas flash kernel (in
# interpret mode, as the JAX package's own tests run it) and through the
# port's flash_attention, which takes its plain PyTorch version for CPU
# tensors.  f32 throughout; tolerance atol 1e-5 (the two sum the same
# f32 terms in another order).

import numpy as np
import pytest
import torch

from aiko_services_tpu.parallel import attention as jax_attention
from aiko_services_tpu_torch.parallel import attention as torch_attention

ATOL = 1e-5


def _qkv(q_len, k_len, batch=1, heads=4, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, heads, q_len, dim), dtype=np.float32)
    k = rng.standard_normal((batch, heads, k_len, dim), dtype=np.float32)
    v = rng.standard_normal((batch, heads, k_len, dim), dtype=np.float32)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(array) for array in arrays]


# (q_len, k_len, causal, block, q_offset): the cases of the JAX package's
# TestFlashAttention, plus q_offset and a decode-style short query
CASES = {
    "square_noncausal": (96, 96, False, 32, 0),
    "square_causal": (96, 96, True, 32, 0),
    "ragged_causal": (50, 50, True, 16, 0),
    "cross_kv_longer": (32, 80, False, 16, 0),
    "causal_q_offset": (40, 72, True, 16, 5),
    "causal_short_query": (9, 64, True, 16, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_jax(case):
    q_len, k_len, causal, block, q_offset = CASES[case]
    q, k, v = _qkv(q_len, k_len)
    expected = np.asarray(jax_attention.flash_attention(
        q, k, v, causal=causal, block_q=block, block_k=block,
        q_offset=q_offset))
    actual = torch_attention.flash_attention(
        *_torch(q, k, v), causal=causal, block_q=block, block_k=block,
        q_offset=q_offset)
    np.testing.assert_allclose(actual.numpy(), expected, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_lse_matches_flash_impl(case):
    q_len, k_len, causal, block, q_offset = CASES[case]
    q, k, v = _qkv(q_len, k_len, seed=1)
    sm_scale = 1.0 / np.sqrt(q.shape[-1])
    expected_out, expected_lse = jax_attention._flash_impl(
        q, k, v, causal, sm_scale, min(block, q_len), min(block, k_len),
        q_offset)
    out, lse = torch_attention.flash_attention_forward(
        *_torch(q, k, v), causal=causal, sm_scale=sm_scale,
        q_offset=q_offset)
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, q_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected_out),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(expected_lse),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    q, k, v = _qkv(24, 24, seed=2)
    expected = np.asarray(jax_attention.attention_reference(
        q, k, v, causal=causal))
    actual = torch_attention.attention_reference(*_torch(q, k, v),
                                                 causal=causal)
    np.testing.assert_allclose(actual.numpy(), expected, atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    from aiko_services_tpu_torch.ops import kernels
    before = dict(kernels.launch_counts)
    q, k, v = _torch(*_qkv(8, 8))
    torch_attention.flash_attention(q, k, v)
    assert kernels.launch_counts == before


def test_other_devices_raise():
    q, k, v = (torch.zeros((1, 1, 4, 16), device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="no kernel for device"):
        torch_attention.flash_attention_forward(q, k, v)
