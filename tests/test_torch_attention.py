# The port's attention (parallel/attention.py) against the JAX package's
# on the CPU: the same numpy inputs through JAX's Pallas flash kernels (in
# interpret mode, as the JAX package's own tests run them) and through the
# port's flash_attention, which takes its plain PyTorch versions for CPU
# tensors, forward and backward.  f32 throughout; tolerance atol 1e-5 (the
# two sum the same f32 terms in another order).

import types

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
    """CPU tensors take the plain versions, CUDA tensors the kernels and
    -- the forward only -- meta tensors its output contract (the eval
    pass, tests/test_torch_analyze_eval.py); anything else raises."""
    q, k, v = (torch.zeros((1, 1, 4, 16), device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="no kernel for device"):
        torch_attention.flash_attention_backward(q, k, v, q, q[..., 0], q)
    other = types.SimpleNamespace(device=torch.device("xla"), shape=q.shape)
    with pytest.raises(ValueError, match="no kernel for device"):
        torch_attention.flash_attention_forward(other, other, other)


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


# -- the bf16 tensor-core kernels' tile walk, emulated -------------------------
#
# csrc/flash_attention_backward.cu's bf16 kernels cannot run here, so this
# test-only emulation walks their schedule in torch: the owner tiles (128
# keys per dK/dV block, 128 q rows per dQ block, 64 per warpgroup, 16 per
# warp), the streamed tiles (64 rows or keys a step, 32 at D = 128), the
# causal skip rules per block and per warpgroup, the unmasked path for
# tiles full per warp, the
# heavy-first block order, and P and dS rounded to bf16 where the kernels
# round them (before the second product) with f32 sums.  It asserts that
# every skipped tile is wholly masked and every "full" tile wholly kept,
# and holds the result against the plain f32 backward and the JAX
# package's _flash_bwd_impl (interpret mode) on bf16-rounded inputs, with
# the card check's tolerance: per-tensor relative error
# ||g - g_ref|| / ||g_ref|| <= 2e-2 (P and dS each rounded once to bf16,
# 2^-9 relative, and the outputs rounded once more).

TC_REL_TOL = 2e-2
GROUP_ROWS = 64   # a warpgroup's rows of the output tile
WARP_ROWS = 16
_LOG2E = 1.4426950408889634


def _tc_tiles(dim):
    """(keys a dK/dV block owns, q rows it streams a step, q rows a dQ
    block owns, keys it streams a step): TcTiles<D> in the CUDA source."""
    step = 64 if dim <= 64 else 32
    return 128, step, 128, step


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _rows(x, start, count):
    """rows [start, start + count) of (BH, L, ...), zero past L, as the
    kernels' zero-filled copies."""
    out = torch.zeros((x.shape[0], count) + tuple(x.shape[2:]))
    stop = min(start + count, x.shape[1])
    if stop > start:
        out[:, :stop - start] = x[:, start:stop]
    return out


def _keep(rows, keys, q_len, k_len, causal, diag):
    """(len(rows), len(keys)) bool: the kernels' element mask."""
    keep = (rows[:, None] < q_len) & (keys[None, :] < k_len)
    if causal:
        keep &= keys[None, :] <= rows[:, None] + diag
    return keep


def _probabilities_tc(s, dp, lse, delta, keep, full, sm_scale):
    """(p, ds) as a warp forms them: exp2 with log2(e) folded into the
    score scale and LSE, the mask only off the full path."""
    p = torch.exp2(s * (sm_scale * _LOG2E) - lse * _LOG2E)
    if not full:
        p = torch.where(keep, p, 0.0)
    return p, p * (dp - delta)


def _emulate_dkv_tc(q, k, v, dout, lse, delta, causal, sm_scale, diag):
    """dK, dV (BH, Lk, D) as flash_dkv_kernel_tc computes them."""
    _, q_len, dim = q.shape
    k_len = k.shape[1]
    block_keys, step, _, _ = _tc_tiles(dim)
    n_tiles = -(-q_len // step)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for block in range(-(-k_len // block_keys)):     # key tile 0 first
        k0 = block * block_keys
        t_begin = (k0 - diag) // step if causal and k0 - diag > 0 else 0
        block_keys_pos = torch.arange(k0, k0 + block_keys)
        for t in range(min(t_begin, n_tiles)):       # the skipped tiles
            rows = torch.arange(t * step, (t + 1) * step)
            assert not _keep(rows, block_keys_pos, q_len, k_len, causal,
                             diag).any()
        for warp in range(block_keys // WARP_ROWS):
            group_key = k0 + warp * WARP_ROWS // GROUP_ROWS * GROUP_ROWS
            warp_key = k0 + warp * WARP_ROWS
            keys = torch.arange(warp_key, warp_key + WARP_ROWS)
            k_w, v_w = (_rows(x, warp_key, WARP_ROWS) for x in (k, v))
            acc_dk = torch.zeros((k.shape[0], WARP_ROWS, dim))
            acc_dv = torch.zeros_like(acc_dk)
            for t in range(t_begin, n_tiles):
                q0 = t * step
                keep = _keep(torch.arange(q0, q0 + step), keys, q_len,
                             k_len, causal, diag).T  # (keys, rows)
                visible = group_key < k_len and (
                    not causal or group_key <= q0 + step - 1 + diag)
                if not visible:
                    assert not keep.any()
                    continue
                full = (q0 + step <= q_len and warp_key + 16 <= k_len and (
                    not causal or warp_key + 15 <= q0 + diag))
                assert not full or keep.all()
                q_t, do_t = _rows(q, q0, step), _rows(dout, q0, step)
                s = k_w @ q_t.transpose(1, 2)
                dp = v_w @ do_t.transpose(1, 2)
                p, ds = _probabilities_tc(
                    s, dp, _rows(lse, q0, step)[:, None, :],
                    _rows(delta, q0, step)[:, None, :], keep, full,
                    sm_scale)
                acc_dv += _bf16(p) @ do_t
                acc_dk += _bf16(ds) @ q_t
            stop = min(warp_key + WARP_ROWS, k_len) - warp_key
            if stop > 0:
                dk[:, warp_key:warp_key + stop] = _bf16(
                    acc_dk * sm_scale)[:, :stop]
                dv[:, warp_key:warp_key + stop] = _bf16(acc_dv)[:, :stop]
    return dk, dv


def _q_tile_order(q_len):
    """q tile of each dQ (and forward) block in launch order: the last
    tile first."""
    n_tiles = -(-q_len // _tc_tiles(64)[2])
    return [n_tiles - 1 - y for y in range(n_tiles)]


def _emulate_dq_tc(q, k, v, dout, lse, delta, causal, sm_scale, diag):
    """dQ (BH, Lq, D) as flash_dq_kernel_tc computes it."""
    _, q_len, dim = q.shape
    k_len = k.shape[1]
    _, _, block_rows, step = _tc_tiles(dim)
    dq = torch.zeros_like(q)
    for tile in _q_tile_order(q_len):
        q0 = tile * block_rows
        last_row = min(q0 + block_rows, q_len) - 1
        k_end = min(k_len, last_row + diag + 1) if causal else k_len
        n_tiles = -(-k_end // step) if k_end > 0 else 0
        block_rows_pos = torch.arange(q0, q0 + block_rows)
        if n_tiles * step < k_len:                   # the skipped keys
            assert not _keep(block_rows_pos, torch.arange(
                n_tiles * step, k_len), q_len, k_len, causal, diag).any()
        for warp in range(block_rows // WARP_ROWS):
            group_row = q0 + warp * WARP_ROWS // GROUP_ROWS * GROUP_ROWS
            warp_row = q0 + warp * WARP_ROWS
            rows = torch.arange(warp_row, warp_row + WARP_ROWS)
            q_w, do_w = (_rows(x, warp_row, WARP_ROWS) for x in (q, dout))
            lse_w = _rows(lse, warp_row, WARP_ROWS)[:, :, None]
            delta_w = _rows(delta, warp_row, WARP_ROWS)[:, :, None]
            acc = torch.zeros((q.shape[0], WARP_ROWS, dim))
            for t in range(n_tiles):
                k0 = t * step
                keep = _keep(rows, torch.arange(k0, k0 + step), q_len,
                             k_len, causal, diag)
                visible = group_row < q_len and (
                    not causal or k0 <= group_row + GROUP_ROWS - 1 + diag)
                if not visible:
                    assert not keep.any()
                    continue
                full = (warp_row + 16 <= q_len and k0 + step <= k_len and (
                    not causal or k0 + step - 1 <= warp_row + diag))
                assert not full or keep.all()
                k_t, v_t = _rows(k, k0, step), _rows(v, k0, step)
                _, ds = _probabilities_tc(
                    q_w @ k_t.transpose(1, 2), do_w @ v_t.transpose(1, 2),
                    lse_w, delta_w, keep, full, sm_scale)
                acc += _bf16(ds) @ k_t
            stop = min(warp_row + WARP_ROWS, q_len) - warp_row
            if stop > 0:
                dq[:, warp_row:warp_row + stop] = _bf16(
                    acc * sm_scale)[:, :stop]
    return dq


# the TPU's masked score, -1e30, in the log2 domain the forward keeps m in
_NEG_INF_LOG2 = float(np.float32(-1e30) * np.float32(_LOG2E))


def _emulate_forward_tc(q, k, v, causal, sm_scale, diag, visits=None):
    """O (BH, Lq, D) and LSE (BH, Lq) as flash_forward_kernel_tc computes
    them: 128 q rows a block (the last tile first), K/V streamed 64 keys a
    step (32 at D = 128), the online softmax in the log2 domain with alpha
    rescales, P rounded to bf16 before P.V and l summed from the f32 p.
    `visits`, if given, gets each block's count of key tiles in launch
    order."""
    _, q_len, dim = q.shape
    k_len = k.shape[1]
    _, _, block_rows, step = _tc_tiles(dim)
    scale_log2 = sm_scale * _LOG2E
    out = torch.zeros_like(q)
    lse = torch.zeros(q.shape[:2])
    for tile in _q_tile_order(q_len):
        q0 = tile * block_rows
        last_row = min(q0 + block_rows, q_len) - 1
        k_end = min(k_len, last_row + diag + 1) if causal else k_len
        n_tiles = -(-k_end // step) if k_end > 0 else 0
        if visits is not None:
            visits.append(n_tiles)
        block_rows_pos = torch.arange(q0, q0 + block_rows)
        if n_tiles * step < k_len:                   # the skipped keys
            assert not _keep(block_rows_pos, torch.arange(
                n_tiles * step, k_len), q_len, k_len, causal, diag).any()
        for warp in range(block_rows // WARP_ROWS):
            group_row = q0 + warp * WARP_ROWS // GROUP_ROWS * GROUP_ROWS
            warp_row = q0 + warp * WARP_ROWS
            rows = torch.arange(warp_row, warp_row + WARP_ROWS)
            q_w = _rows(q, warp_row, WARP_ROWS)
            m = torch.full((q.shape[0], WARP_ROWS), _NEG_INF_LOG2)
            l = torch.zeros((q.shape[0], WARP_ROWS))
            acc = torch.zeros((q.shape[0], WARP_ROWS, dim))
            for t in range(n_tiles):
                k0 = t * step
                keys = torch.arange(k0, k0 + step)
                # the kernel masks keys only: rows past Lq are not stored
                keep = _keep(rows, keys, torch.inf, k_len, causal, diag)
                visible = group_row < q_len and (
                    not causal or k0 <= group_row + GROUP_ROWS - 1 + diag)
                if not visible:
                    assert not (keep & (rows[:, None] < q_len)).any()
                    continue
                full = k0 + step <= k_len and (
                    not causal or k0 + step - 1 <= warp_row + diag)
                assert not full or keep.all()
                k_t, v_t = _rows(k, k0, step), _rows(v, k0, step)
                s = q_w @ k_t.transpose(1, 2)
                if not full:
                    s = torch.where(keep, s, -torch.inf)
                m_new = torch.maximum(m, s.amax(-1) * scale_log2)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s * scale_log2 - m_new[..., None])
                if not full:
                    p_masked = torch.exp2(_NEG_INF_LOG2 - m_new)
                    p = torch.where(keep, p, p_masked[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + _bf16(p) @ v_t
                m = m_new
            stop = min(warp_row + WARP_ROWS, q_len) - warp_row
            if stop > 0:
                denom = torch.clamp(l, min=1e-30)
                out[:, warp_row:warp_row + stop] = _bf16(
                    acc / denom[..., None])[:, :stop]
                lse[:, warp_row:warp_row + stop] = (
                    m * np.log(2.0) + torch.log(denom))[:, :stop]
    return out, lse


# (q_len, k_len, causal, q_offset, head_dim): GRAD_CASES at D = 16, and
# the shapes the bf16 kernels' edges meet
TC_CASES = {
    **{name: (q_len, k_len, causal, q_offset, 16)
       for name, (q_len, k_len, causal, _, q_offset) in GRAD_CASES.items()},
    "query_shorter_than_a_step_d64": (37, 251, True, 0, 64),
    "whisper_cross_16x251_d64": (16, 251, False, 0, 64),
    "whisper_encoder_251x251_d64": (251, 251, False, 0, 64),
    "ragged_65x129_d128": (65, 129, False, 0, 128),
    "causal_negative_offset_d32": (50, 130, True, -7, 32),
    "causal_two_blocks_d64": (256, 256, True, 0, 64),
    "causal_d128": (130, 130, True, 0, 128),
}


def _relative_error(actual, expected):
    actual, expected = (torch.as_tensor(np.asarray(x)).float()
                        for x in (actual, expected))
    return ((actual - expected).norm() / expected.norm()).item()


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tensor_core_tile_walk_matches_plain_and_jax(case):
    q_len, k_len, causal, q_offset, dim = TC_CASES[case]
    q, k, v = (_bf16(torch.from_numpy(x)).numpy()
               for x in _qkv(q_len, k_len, heads=2, dim=dim, seed=6))
    dout = _bf16(torch.from_numpy(np.random.default_rng(7).standard_normal(
        q.shape, dtype=np.float32))).numpy()
    sm_scale = 1.0 / np.sqrt(dim)
    block_q, block_k = min(32, q_len), min(32, k_len)
    out, lse = (np.array(x) for x in jax_attention._flash_impl(
        q, k, v, causal, sm_scale, block_q, block_k, q_offset))
    jax_grads = jax_attention._flash_bwd_impl(
        q, k, v, out, lse, dout, causal, sm_scale, block_q, block_k,
        q_offset)
    tq, tk, tv, tout, tlse, tdout = _torch(q, k, v, out, lse, dout)
    plain = torch_attention.flash_attention_backward_plain(
        tq, tk, tv, tout, tlse, tdout, causal=causal, sm_scale=sm_scale,
        q_offset=q_offset)

    def flat(x):  # (1, H, L, ...) -> (H, L, ...)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    diag = torch_attention._diagonal(causal, q_offset, q_len, k_len)
    arguments = (flat(tq), flat(tk), flat(tv), flat(tdout), flat(tlse),
                 flat(torch_attention._delta(tout, tdout)), causal,
                 sm_scale, diag)
    dq = _emulate_dq_tc(*arguments)
    dk, dv = _emulate_dkv_tc(*arguments)
    for name, got, want_plain, want_jax in zip(
            ("dq", "dk", "dv"), (dq, dk, dv), plain, jax_grads):
        shape = tuple(want_plain.shape)
        got = got.reshape(shape)
        assert _relative_error(got, want_plain) <= TC_REL_TOL, name
        assert _relative_error(got, want_jax) <= TC_REL_TOL, name
        # the bf16 rounding of P and dS is visible, not zero
        assert _relative_error(got, want_plain) > 0, name


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_forward_tensor_core_tile_walk_matches_plain_and_jax(case):
    """The forward kernel's tile walk against the plain forward and the
    JAX package's _flash_impl (interpret mode) on bf16-rounded inputs: O
    within relative error 2e-2 (P rounded once to bf16 before P.V, 2^-9
    relative, and O once more), LSE within atol 1e-4 (it is formed from
    the f32 p, in the log2 domain)."""
    q_len, k_len, causal, q_offset, dim = TC_CASES[case]
    q, k, v = (_bf16(torch.from_numpy(x)).numpy()
               for x in _qkv(q_len, k_len, heads=2, dim=dim, seed=8))
    sm_scale = 1.0 / np.sqrt(dim)
    jax_out, jax_lse = (np.array(x) for x in jax_attention._flash_impl(
        q, k, v, causal, sm_scale, min(32, q_len), min(32, k_len),
        q_offset))
    plain_out, plain_lse = torch_attention.flash_attention_plain(
        *_torch(q, k, v), causal=causal, sm_scale=sm_scale,
        q_offset=q_offset)
    diag = torch_attention._diagonal(causal, q_offset, q_len, k_len)
    out, lse = _emulate_forward_tc(
        *(torch.from_numpy(x).reshape((-1,) + x.shape[2:])
          for x in (q, k, v)), causal, sm_scale, diag)
    out, lse = out.reshape(plain_out.shape), lse.reshape(plain_lse.shape)
    for want_out, want_lse in ((plain_out, plain_lse), (jax_out, jax_lse)):
        assert _relative_error(out, want_out) <= TC_REL_TOL
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   atol=1e-4, rtol=0)
    # the bf16 rounding of P and O is visible, not zero
    assert _relative_error(out, plain_out) > 0


def test_tensor_core_blocks_run_heavy_first():
    """Causal, Lq = Lk = 1024 (the llama32_1b shape): in launch order the
    blocks' visible tiles never increase, and every tile has one block."""
    q_len = k_len = 1024
    block_keys, step, block_rows, k_step = _tc_tiles(64)
    dkv_work = []
    for block in range(k_len // block_keys):          # blockIdx.y order
        t_begin = block * block_keys // step
        dkv_work.append(q_len // step - t_begin)
    order = _q_tile_order(q_len)
    assert sorted(order) == list(range(q_len // block_rows))
    dq_work = [-(-min(k_len, (tile + 1) * block_rows) // k_step)
               for tile in order]
    # the forward walks the same blocks in the same order: its emulation
    # records the key tiles each block streams
    forward_work = []
    q, k, v = (torch.zeros((1, length, 64)) for length in (q_len, k_len,
                                                           k_len))
    _emulate_forward_tc(q, k, v, True, 0.125, 0, visits=forward_work)
    assert forward_work == dq_work
    for work in (dkv_work, dq_work, forward_work):
        assert work == sorted(work, reverse=True) and work[0] > work[-1]


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
