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
# a sum of up to 300 terms, summed in another order).

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.ops import kernels
from aiko_services_tpu_torch.parallel.attention import (
    flash_attention_forward, flash_attention_plain)

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
