# The port's KV-cache path and greedy generation (models/transformer.py)
# against the JAX package's on the CPU, on the same weights: the JAX
# package's random parameters go through numpy into the port
# (models/bridge.py), the same numpy prompts go into both.  f32
# throughout, at a small config (2 layers, d_model 64, GQA 4/2 heads).
#
# Tolerances: logits atol 1e-5 (two f32 layers, the same products summed
# in another order); the f32 cache a forward writes atol 1e-5 (the second
# layer's K/V come out of the first layer, values of order 1); int8 codes
# and scales,
# greedy tokens and the int8 cache codes must be identical (the same f32
# division and round-half-to-even in both packages).

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu_torch.models import (
    params_from_numpy, params_to_numpy)
from aiko_services_tpu_torch.models import transformer as torch_lm

CONFIG = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=64, dtype="float32")
KV_DTYPES = ["", "int8"]
MAX_NEW = 9


@pytest.fixture(scope="module")
def lm():
    """(jax params, numpy params, prompt (3, 7) int32)."""
    jax_params = jax_lm.init_params(jax_lm.TransformerConfig(**CONFIG),
                                    jax.random.PRNGKey(0))
    numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    prompt = np.random.default_rng(3).integers(3, 256, (3, 7)).astype(
        np.int32)
    return jax_params, numpy_params, prompt


def _configs(kv_dtype: str = ""):
    return (jax_lm.TransformerConfig(**CONFIG, kv_dtype=kv_dtype),
            torch_lm.TransformerConfig(**CONFIG, kv_dtype=kv_dtype))


def _port(numpy_params):
    return params_from_numpy(numpy_params, device="cpu")


def _numpy_cache(cache) -> dict:
    return {name: np.asarray(value.detach().cpu() if isinstance(
        value, torch.Tensor) else value) for name, value in cache.items()}


def test_init_cache_matches_jax_layout():
    for kv_dtype in KV_DTYPES:
        jax_config, torch_config = _configs(kv_dtype)
        expected = jax_lm.init_cache(jax_config, 3, max_len=20)
        actual = torch_lm.init_cache(torch_config, 3, max_len=20,
                                     device="cpu")
        assert sorted(actual) == sorted(expected)
        for name, value in expected.items():
            assert tuple(actual[name].shape) == value.shape
            assert str(actual[name].dtype).replace("torch.", "") == str(
                value.dtype)
            assert not actual[name].any()


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_cached_forward_matches_jax_at_pos_0_and_after(lm, kv_dtype):
    """A 7-token prefill at pos 0, then a 3-token chunk at pos 7: logits
    atol 1e-5 and the written cache (codes identical when int8)."""
    jax_params, numpy_params, prompt = lm
    jax_config, torch_config = _configs(kv_dtype)
    params = _port(numpy_params)
    jax_cache = jax_lm.init_cache(jax_config, 3, max_len=16)
    torch_cache = torch_lm.init_cache(torch_config, 3, max_len=16,
                                      device="cpu")
    chunk = np.random.default_rng(4).integers(3, 256, (3, 3)).astype(
        np.int32)
    for tokens, pos in ((prompt, 0), (chunk, 7)):
        expected, jax_cache = jax_lm.forward(
            jax_params, jax_config, jnp.asarray(tokens), cache=jax_cache,
            pos=pos)
        actual, torch_cache = torch_lm.forward(
            params, torch_config, torch.from_numpy(tokens),
            cache=torch_cache, pos=pos)
        assert actual.shape == (3, tokens.shape[1], 256)
        assert actual.dtype == torch.float32
        np.testing.assert_allclose(actual.numpy(), np.asarray(expected),
                                   atol=1e-5, rtol=0)
        want, got = _numpy_cache(jax_cache), _numpy_cache(torch_cache)
        for name in want:
            if want[name].dtype == np.int8:
                np.testing.assert_array_equal(got[name], want[name])
            else:
                np.testing.assert_allclose(got[name], want[name],
                                           atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_generate_tokens_identical_to_jax(lm, kv_dtype):
    jax_params, numpy_params, prompt = lm
    jax_config, torch_config = _configs(kv_dtype)
    expected, _ = jax_lm.generate(jax_params, jax_config,
                                  jnp.asarray(prompt), MAX_NEW)
    actual, cache = torch_lm.generate(_port(numpy_params), torch_config,
                                      torch.from_numpy(prompt), MAX_NEW)
    assert actual.dtype == torch.int32 and actual.shape == (3, MAX_NEW)
    np.testing.assert_array_equal(actual.numpy(), np.asarray(expected))
    assert cache["k"].shape[3] == prompt.shape[1] + MAX_NEW


def test_quantize_weights_int8_bit_identical(lm):
    jax_params, numpy_params, _ = lm
    jax_config, torch_config = _configs()
    expected = jax.tree_util.tree_map(
        np.asarray, jax_lm.quantize_weights_int8(jax_params, jax_config))
    actual = params_to_numpy(torch_lm.quantize_weights_int8(
        _port(numpy_params), torch_config))
    flat = jax.tree_util.tree_flatten_with_path(expected)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(actual))
    for path, want in flat:
        got = actual
        for key in path:
            got = got[key.key]
        assert got.dtype == want.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(got, want,
                                      err_msg=jax.tree_util.keystr(path))
    assert actual["layers"]["wq"]["w"].dtype == np.int8
    assert actual["embed"]["w_scale"].shape == (256, 1)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_int8_weight_generation_identical_to_jax(lm, kv_dtype):
    jax_params, numpy_params, prompt = lm
    jax_config, torch_config = _configs(kv_dtype)
    jax_q = jax_lm.quantize_weights_int8(jax_params, jax_config)
    port_q = torch_lm.quantize_weights_int8(_port(numpy_params),
                                            torch_config)
    expected_logits = jax_lm.forward(jax_q, jax_config, jnp.asarray(prompt))
    actual_logits = torch_lm.forward(port_q, torch_config,
                                     torch.from_numpy(prompt))
    np.testing.assert_allclose(actual_logits.numpy(),
                               np.asarray(expected_logits), atol=1e-5,
                               rtol=0)
    expected, _ = jax_lm.generate(jax_q, jax_config, jnp.asarray(prompt),
                                  MAX_NEW)
    actual, _ = torch_lm.generate(port_q, torch_config,
                                  torch.from_numpy(prompt), MAX_NEW)
    np.testing.assert_array_equal(actual.numpy(), np.asarray(expected))


def test_int8_scales_stay_f32_when_the_tree_is_cast(lm):
    jax_params, _, _ = lm
    jax_config, _ = _configs()
    quantized = jax.tree_util.tree_map(
        np.asarray, jax_lm.quantize_weights_int8(jax_params, jax_config))
    params = params_from_numpy(quantized, device="cpu", dtype="bfloat16")
    assert params["layers"]["wq"]["w"].dtype == torch.int8
    assert params["layers"]["wq"]["w_scale"].dtype == torch.float32
    assert params["embed"]["w_scale"].dtype == torch.float32
    assert params["norm_out"]["scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_generate_stream_chunks_concatenate_to_generate(lm, chunk):
    jax_params, numpy_params, prompt = lm
    jax_config, torch_config = _configs()
    params = _port(numpy_params)
    expected, _ = torch_lm.generate(params, torch_config,
                                    torch.from_numpy(prompt), MAX_NEW)
    pieces = list(torch_lm.generate_stream(
        params, torch_config, torch.from_numpy(prompt), MAX_NEW,
        chunk=chunk))
    offsets = [offset for offset, _ in pieces]
    jax_offsets = [offset for offset, _ in jax_lm.generate_stream(
        jax_params, jax_config, jnp.asarray(prompt), MAX_NEW, chunk=chunk)]
    assert offsets == jax_offsets
    blocks = [block for _, block in pieces]
    assert all(isinstance(block, np.ndarray) for block in blocks)
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1),
                                  expected.numpy())


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_decode_step_matches_jax(lm, kv_dtype):
    """Prefill 7 tokens, then one decode_step at pos 7: the greedy token,
    the logits (atol 1e-5) and the written cache position."""
    jax_params, numpy_params, prompt = lm
    jax_config, torch_config = _configs(kv_dtype)
    params = _port(numpy_params)
    jax_cache = jax_lm.init_cache(jax_config, 3, max_len=12)
    _, jax_cache = jax_lm.forward(jax_params, jax_config,
                                  jnp.asarray(prompt), cache=jax_cache,
                                  pos=0)
    torch_cache = torch_lm.init_cache(torch_config, 3, max_len=12,
                                      device="cpu")
    _, torch_cache = torch_lm.forward(params, torch_config,
                                      torch.from_numpy(prompt),
                                      cache=torch_cache, pos=0)
    token = np.full((3, 1), 7, np.int32)
    expected_next, expected_logits, jax_cache = jax_lm.decode_step(
        jax_params, jax_config, jax_cache, jnp.asarray(token), jnp.int32(7))
    actual_next, actual_logits, torch_cache = torch_lm.decode_step(
        params, torch_config, torch_cache, torch.from_numpy(token),
        torch.tensor(7, dtype=torch.int32))
    assert actual_next.dtype == torch.int32 and actual_next.shape == (3, 1)
    np.testing.assert_array_equal(actual_next.numpy(),
                                  np.asarray(expected_next))
    np.testing.assert_allclose(actual_logits.numpy(),
                               np.asarray(expected_logits), atol=1e-5,
                               rtol=0)
    want, got = _numpy_cache(jax_cache), _numpy_cache(torch_cache)
    for name in want:
        np.testing.assert_allclose(got[name][:, :, :, 7],
                                   want[name][:, :, :, 7], atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("pos", [6, 11])
def test_cache_write_clamps_like_dynamic_update_slice(lm, pos):
    """A 4-token write at pos 6 or 11 into an 8-position cache: the JAX
    package's dynamic_update_slice clamps the start to 4 (the update must
    fit) while the rotary positions and the mask keep pos; the port
    writes and attends the same."""
    jax_params, numpy_params, prompt = lm
    jax_config, torch_config = _configs()
    tokens = prompt[:, :4]
    jax_cache = jax_lm.init_cache(jax_config, 3, max_len=8)
    expected, jax_cache = jax_lm.forward(jax_params, jax_config,
                                         jnp.asarray(tokens),
                                         cache=jax_cache, pos=pos)
    torch_cache = torch_lm.init_cache(torch_config, 3, max_len=8,
                                      device="cpu")
    actual, torch_cache = torch_lm.forward(
        _port(numpy_params), torch_config, torch.from_numpy(tokens),
        cache=torch_cache, pos=pos)
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected),
                               atol=1e-5, rtol=0)
    want, got = _numpy_cache(jax_cache), _numpy_cache(torch_cache)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                   rtol=0)
    assert not got["k"][:, :, :, :4].any() and got["k"][:, :, :, 4:].any()


@pytest.mark.parametrize("option", ["return_aux", "remat_policy"])
def test_cacheless_only_options_are_refused_with_a_cache(lm, option):
    _, numpy_params, prompt = lm
    _, torch_config = _configs()
    cache = torch_lm.init_cache(torch_config, 3, max_len=16, device="cpu")
    arguments = ({"return_aux": True} if option == "return_aux"
                 else {"remat_policy": "nothing_saveable"})
    with pytest.raises(ValueError, match="cache-less"):
        torch_lm.forward(_port(numpy_params), torch_config,
                         torch.from_numpy(prompt), cache=cache, **arguments)


def test_generate_bf16_runs_and_stays_in_vocab(lm):
    """bf16 weights (the serving dtype) on the CPU: the cache takes the
    compute dtype and every token lies in the vocabulary."""
    _, numpy_params, prompt = lm
    config = replace(_configs()[1], dtype="bfloat16")
    params = params_from_numpy(numpy_params, device="cpu", dtype="bfloat16")
    out, cache = torch_lm.generate(params, config, torch.from_numpy(prompt),
                                   4)
    assert cache["k"].dtype == torch.bfloat16
    assert out.dtype == torch.int32
    assert ((0 <= out) & (out < 256)).all()
