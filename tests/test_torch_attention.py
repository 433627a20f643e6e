# The port's attention (parallel/attention.py) against the JAX package's
# on the CPU: the same numpy inputs through JAX's Pallas flash kernels (in
# interpret mode, as the JAX package's own tests run them) and through the
# port's flash_attention, which takes its plain PyTorch versions for CPU
# tensors, forward and backward.  f32 throughout; tolerance atol 1e-5 (the
# two sum the same f32 terms in another order).

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


# gradient cases: the JAX package's TestFlashBackward (96 causal and not,
# block 32; ragged q 50 x k 70 causal, block 16) plus q_offset
GRAD_CASES = {
    "square_noncausal": (96, 96, False, 32, 0),
    "square_causal": (96, 96, True, 32, 0),
    "ragged_cross_causal": (50, 70, True, 16, 0),
    "causal_q_offset": (40, 72, True, 16, 5),
    "causal_negative_offset": (50, 130, True, 16, -7),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_flash_attention_gradients_match_jax_grad(case):
    import jax
    import jax.numpy as jnp
    q_len, k_len, causal, block, q_offset = GRAD_CASES[case]
    q, k, v = _qkv(q_len, k_len, seed=3)

    def jax_loss(q, k, v):
        out = jax_attention.flash_attention(
            q, k, v, causal=causal, block_q=block, block_k=block,
            q_offset=q_offset)
        return jnp.sum(out * jnp.cos(out))

    expected = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    tensors = [tensor.requires_grad_(True) for tensor in _torch(q, k, v)]
    out = torch_attention.flash_attention(*tensors, causal=causal,
                                          q_offset=q_offset)
    torch.sum(out * torch.cos(out)).backward()
    for tensor, want, name in zip(tensors, expected, ("dq", "dk", "dv")):
        np.testing.assert_allclose(tensor.grad.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_backward_plain_matches_flash_bwd_impl(case):
    q_len, k_len, causal, block, q_offset = GRAD_CASES[case]
    q, k, v = _qkv(q_len, k_len, seed=4)
    dout = np.random.default_rng(5).standard_normal(q.shape,
                                                    dtype=np.float32)
    sm_scale = 1.0 / np.sqrt(q.shape[-1])
    out, lse = jax_attention._flash_impl(q, k, v, causal, sm_scale, block,
                                         block, q_offset)
    expected = jax_attention._flash_bwd_impl(
        q, k, v, out, lse, dout, causal, sm_scale, block, block, q_offset)
    actual = torch_attention.flash_attention_backward(
        *_torch(q, k, v, np.array(out), np.array(lse), dout),
        causal=causal, sm_scale=sm_scale, q_offset=q_offset)
    for got, want, name in zip(actual, expected, ("dq", "dk", "dv")):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_output_grad_fn_is_the_ports_function():
    q, k, v = [tensor.requires_grad_(True)
               for tensor in _torch(*_qkv(8, 8))]
    out = torch_attention.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    assert out.grad_fn._forward_cls is torch_attention._FlashAttention
    # sm_scale, causal and q_offset get no gradient
    out.sum().backward()
    assert all(tensor.grad is not None for tensor in (q, k, v))


def test_backward_on_other_devices_raises():
    q, k, v, out, dout = (torch.zeros((1, 1, 4, 16), device="meta")
                          for _ in range(5))
    lse = torch.zeros((1, 1, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        torch_attention.flash_attention_backward(q, k, v, out, lse, dout)
