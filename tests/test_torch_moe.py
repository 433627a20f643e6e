# The port's switch mixture-of-experts LM (models/transformer.py,
# n_experts > 0) against the JAX package's on the CPU, on the same weights
# (the JAX package's random parameters through numpy into the port,
# models/bridge.py) and the same numpy inputs, f32 throughout: the
# forward, the train step with its aux loss, int8 serving weights, remat,
# generation, the four paged steps and the decode engine, with and
# without capacity drops.
#
# Tolerances (those of test_torch_transformer.py, for the same reasons):
# logits atol 1e-5 (two f32 layers, the same products summed in another
# order); the aux loss, the loss and every gradient leaf atol 1e-6; the
# parameters after three adamw(1e-3) steps atol 5e-5.  Routes (each
# token's expert) must be identical, and the inputs of the route test
# keep every token's top-2 router probabilities at least 1e-4 apart, so
# that no flip can come from the order of a sum (f32 rounding moves them
# by ~1e-7).  Within the port: capacity dispatch against the dense oracle
# and the gather against the oracle atol 1e-6 (one nonzero term in each
# dispatch and combine sum: the same products, the FFN summed in another
# order); a dropped token's FFN output exactly 0; losses across remat
# policies bit-identical.  Generated tokens, paged-step tokens and engine
# completions identical; pools within test_torch_decode.py's tolerances.
#
# Capacity is computed per call, so with drops a chunked prefill is not a
# monolithic one (in the JAX package too): the engine's own contracts
# (chunked == monolithic, speculative == plain, engine == closed batch)
# run at moe_capacity_factor = n_experts, where nothing drops; the runs
# with drops are held against the JAX package's, token for token.

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aiko_services_tpu import decode as jax_decode
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu_torch.decode import TRASH_BLOCK, DecodeEngine
from aiko_services_tpu_torch.models import (
    optim, params_from_numpy, params_to_numpy)
from aiko_services_tpu_torch.models import transformer as torch_lm

CONFIG = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=64, dtype="float32",
              n_experts=4)
# capacity factors: the JAX default 1.25 (tokens drop), n_experts (C = L:
# nothing drops), 0 (the dense oracle)
DROPS, NO_DROPS, ORACLE = 1.25, 4.0, 0.0
ROUTES = {"drops": dict(moe_capacity_factor=DROPS),
          "no_drops": dict(moe_capacity_factor=NO_DROPS),
          "oracle": dict(moe_capacity_factor=ORACLE),
          # 32 experts > 17 tokens: every call takes the weight gather
          "gather": dict(n_experts=32)}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(config: dict, seed: int = 0, **options):
    """(jax params, jax config, port params, port config) on the CPU."""
    config = dict(config, **options)
    jax_config = jax_lm.TransformerConfig(**config)
    jax_params = jax_lm.init_params(jax_config, jax.random.PRNGKey(seed))
    numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    return (jax_params, jax_config,
            params_from_numpy(numpy_params, device="cpu"),
            torch_lm.TransformerConfig(**config))


def _tokens(shape=(2, 17), seed=5):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _t(array):
    return torch.from_numpy(np.asarray(array))


def _layer0(tree):
    return {name: (_layer0(leaf) if isinstance(leaf, dict) else leaf[0])
            for name, leaf in tree.items()}


def _pairs(jax_tree, torch_tree):
    """(path, jax leaf, port leaf) for every leaf of the JAX tree."""
    torch_numpy = params_to_numpy(torch_tree)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        node = torch_numpy
        for key in path:
            node = node[key.key]
        yield jax.tree_util.keystr(path), np.asarray(leaf), node


# -- parameters and the bridge ----------------------------------------------

def test_init_params_tree_matches_jax_and_bridges_exactly():
    jax_params, _, bridged, config = _models(CONFIG)
    ours = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                device="cpu")
    for path, expected, actual in _pairs(jax_params, ours):
        assert actual.shape == expected.shape, path
        assert actual.dtype == expected.dtype, path
    assert tuple(ours["layers"]["router"]["w"].shape) == (2, 64, 4)
    assert tuple(ours["layers"]["w_down"]["w"].shape) == (2, 4, 128, 64)
    # the expert leaves carry across from the JAX package's numpy params
    for path, expected, actual in _pairs(jax_params, bridged):
        np.testing.assert_array_equal(actual, expected, err_msg=path)
    # seeded: the same generator seed draws the same experts
    again = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                 device="cpu")
    assert torch.equal(again["layers"]["w_gate"]["w"],
                       ours["layers"]["w_gate"]["w"])
    # N(0, 1/rows) per expert
    std = float(ours["layers"]["w_down"]["w"].std())
    assert abs(std - 1 / np.sqrt(128)) < 0.01


# -- forward, routes, dispatch ----------------------------------------------

@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forward_logits_and_aux_match_jax(route):
    jax_params, jax_config, params, config = _models(CONFIG, **ROUTES[route])
    tokens = _tokens()
    expected, expected_aux = jax_lm.forward(jax_params, jax_config, tokens,
                                            return_aux=True)
    actual, aux = torch_lm.forward(params, config, _t(tokens),
                                   return_aux=True)
    assert actual.shape == (2, 17, 256) and actual.dtype == torch.float32
    np.testing.assert_allclose(actual.detach().numpy(),
                               np.asarray(expected), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(expected_aux), atol=1e-6,
                               rtol=0)
    # top-1 Switch aux is >= 1, equal to 1 at perfectly balanced routing
    assert float(aux) >= 1.0 - 1e-5
    if route == "drops":     # some token overflowed its expert's capacity
        oracle = torch_lm.forward(
            params, replace(config, moe_capacity_factor=ORACLE), _t(tokens))
        assert not torch.allclose(actual, oracle, atol=1e-3)


def test_routes_identical_with_a_top2_gap():
    jax_params, jax_config, params, config = _models(CONFIG)
    layer_jax = jax.tree_util.tree_map(lambda leaf: leaf[0],
                                       jax_params["layers"])
    layer = _layer0(params["layers"])
    x = np.random.default_rng(11).standard_normal((4, 16, 64)).astype(
        np.float32)
    best_jax, mask_jax, weight_jax, aux_jax = jax_lm._router(
        jax_config, layer_jax, jnp.asarray(x))
    best, mask1, weight, aux = torch_lm._router(config, layer, _t(x))
    # no route can flip from summation order on these inputs
    logits = x.astype(np.float64) @ np.asarray(
        layer_jax["router"]["w"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() >= 1e-4
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_jax))
    assert len(np.unique(best.numpy())) == 4     # every expert is chosen
    np.testing.assert_array_equal(mask1.numpy(), np.asarray(mask_jax))
    np.testing.assert_allclose(weight.detach().numpy(),
                               np.asarray(weight_jax), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(aux), float(aux_jax), atol=1e-6,
                               rtol=0)


def _layer_input(params, seed=3, shape=(2, 16, 64)):
    generator = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=generator)


def test_capacity_dispatch_equals_the_oracle_when_nothing_drops():
    _, _, params, config = _models(CONFIG, moe_capacity_factor=NO_DROPS)
    layer = _layer0(params["layers"])
    x = _layer_input(params)
    got, got_aux = torch_lm._switch_moe(config, layer, x)
    want, want_aux = torch_lm._switch_moe_dense(config, layer, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert float(got_aux) == float(want_aux)


def test_dropped_tokens_give_exactly_zero():
    """Identical tokens all route to one expert; with capacity 1 only the
    first is processed, every later row is exactly 0 (the JAX package's
    test_overflow_tokens_are_dropped_from_moe_output), and the whole
    output matches the JAX package's."""
    jax_params, jax_config, params, config = _models(
        CONFIG, moe_capacity_factor=1e-9)          # C floors at 1
    row = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    x = np.broadcast_to(row, (1, 8, 64)).copy()
    out, _ = torch_lm._switch_moe(config, _layer0(params["layers"]), _t(x))
    assert float(out[0, 0].abs().max()) > 0
    assert torch.equal(out[0, 1:], torch.zeros((7, 64)))
    expected, _ = jax_lm._switch_moe(
        jax_config, jax.tree_util.tree_map(lambda leaf: leaf[0],
                                           jax_params["layers"]),
        jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(expected),
                               atol=1e-6, rtol=0)


def test_gather_equals_the_oracle():
    _, _, params, config = _models(CONFIG, n_experts=8)
    layer = _layer0(params["layers"])
    x = _layer_input(params, shape=(3, 2, 64))           # L = 2 < E = 8
    got, _ = torch_lm._switch_moe(config, layer, x)
    want, _ = torch_lm._switch_moe_dense(config, layer, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


# -- training ---------------------------------------------------------------

def _jax_loss(jax_config):
    def loss(params, tokens):
        logits, aux = jax_lm.forward(params, jax_config, tokens[:, :-1],
                                     return_aux=True)
        log_probs = jax.nn.log_softmax(logits, axis=-1)
        taken = jnp.take_along_axis(log_probs, tokens[:, 1:, None],
                                    axis=-1)[..., 0]
        return -jnp.mean(taken) + jax_config.moe_aux_weight * aux
    return loss


def _torch_loss(config, remat_policy=None):
    def loss(params, tokens):
        logits, aux = torch_lm.forward(params, config, tokens[:, :-1],
                                       return_aux=True,
                                       remat_policy=remat_policy)
        return (optim.next_token_loss(logits, tokens[:, 1:])
                + config.moe_aux_weight * aux)
    return loss


@pytest.mark.parametrize("route", ["drops", "no_drops", "gather"])
def test_loss_and_every_gradient_leaf_match_jax(route):
    jax_params, jax_config, params, config = _models(CONFIG, **ROUTES[route])
    tokens = _tokens()
    expected_loss, expected_grads = jax.value_and_grad(
        _jax_loss(jax_config))(jax_params, tokens)
    loss, grads = optim.value_and_grad(_torch_loss(config), params,
                                       _t(tokens).long())
    np.testing.assert_allclose(float(loss), float(expected_loss), atol=1e-6,
                               rtol=0)
    router_grad = grads["layers"]["router"]["w"]
    assert float(router_grad.abs().max()) > 0   # the aux loss reaches it
    for path, expected, actual in _pairs(expected_grads, grads):
        np.testing.assert_allclose(actual, expected, atol=1e-6, rtol=0,
                                   err_msg=path)


def test_aux_gradient_flows_through_the_probabilities_only():
    """With the next-token loss switched off, the router still learns
    from the aux loss alone (through prob_mass; mask1 is an argmax)."""
    jax_params, jax_config, params, config = _models(CONFIG)
    tokens = _tokens()

    def jax_aux(params):
        return jax_lm.forward(params, jax_config, tokens[:, :-1],
                              return_aux=True)[1]

    def torch_aux(params, tokens):
        return torch_lm.forward(params, config, tokens[:, :-1],
                                return_aux=True)[1]

    expected = jax.grad(jax_aux)(jax_params)["layers"]["router"]["w"]
    _, grads = optim.value_and_grad(torch_aux, params, _t(tokens))
    np.testing.assert_allclose(grads["layers"]["router"]["w"].numpy(),
                               np.asarray(expected), atol=1e-6, rtol=0)


def test_three_adamw_steps_match_optax():
    jax_params, jax_config, params, config = _models(CONFIG)
    tokens = _tokens()
    jax_optimizer = optax.adamw(1e-3)
    jax_state = jax_optimizer.init(jax_params)
    jax_step = jax_lm.make_train_step(jax_config, jax_optimizer)
    optimizer = optim.adamw(1e-3)
    state = optimizer.init(params)
    step = torch_lm.make_train_step(config, optimizer)
    for _ in range(3):
        jax_params, jax_state, expected_loss = jax_step(
            jax_params, jax_state, jnp.asarray(tokens))
        params, state, loss = step(params, state, _t(tokens).long())
        np.testing.assert_allclose(float(loss), float(expected_loss),
                                   atol=1e-5, rtol=0)
    for path, expected, actual in _pairs(jax_params, params):
        np.testing.assert_allclose(actual, expected, atol=5e-5, rtol=0,
                                   err_msg=path)


def test_remat_policies_give_bit_identical_losses():
    _, _, params, config = _models(CONFIG)
    tokens = _t(_tokens()).long()
    losses = {}
    for policy in torch_lm.REMAT_POLICIES:
        loss, _ = optim.value_and_grad(_torch_loss(config, policy), params,
                                       tokens)
        losses[policy] = float(loss)
    assert len(set(losses.values())) == 1, losses
    # the expert products are batched matmuls: the no-batch-dims policy
    # recomputes them, as jax's dots_with_no_batch_dims_saveable does
    policy = torch_lm._save_policy("dots_with_no_batch_dims_saveable")
    assert (policy(None, torch.ops.aten.bmm.default)
            == torch_lm.CheckpointPolicy.PREFER_RECOMPUTE)
    assert (policy(None, torch.ops.aten.mm.default)
            == torch_lm.CheckpointPolicy.MUST_SAVE)


# -- serving ----------------------------------------------------------------

def test_int8_weights_quantize_the_attention_only_and_match_jax():
    jax_params, jax_config, params, config = _models(CONFIG)
    expected = jax_lm.quantize_weights_int8(jax_params, jax_config)
    actual = torch_lm.quantize_weights_int8(params, config)
    for key in ("wq", "wk", "wv", "wo"):
        assert sorted(actual["layers"][key]) == ["w", "w_scale"]
        assert actual["layers"][key]["w"].dtype == torch.int8
    for key in ("router", "w_gate", "w_up", "w_down"):
        assert sorted(actual["layers"][key]) == ["w"]
        assert actual["layers"][key]["w"] is params["layers"][key]["w"]
    for path, want, got in _pairs(expected, actual):
        np.testing.assert_array_equal(got, want, err_msg=path)
    prompt = _tokens((3, 7), seed=3)
    want_tokens, _ = jax_lm.generate(expected, jax_config,
                                     jnp.asarray(prompt), 6)
    got_tokens, _ = torch_lm.generate(actual, config, _t(prompt), 6)
    np.testing.assert_array_equal(got_tokens.numpy(),
                                  np.asarray(want_tokens))


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
@pytest.mark.parametrize("factor", [DROPS, NO_DROPS])
def test_generate_and_generate_stream_tokens_identical_to_jax(factor,
                                                              kv_dtype):
    jax_params, jax_config, params, config = _models(
        CONFIG, moe_capacity_factor=factor, kv_dtype=kv_dtype)
    prompt = _tokens((3, 9), seed=3)
    expected, _ = jax_lm.generate(jax_params, jax_config,
                                  jnp.asarray(prompt), 9)
    actual, _ = torch_lm.generate(params, config, _t(prompt), 9)
    assert actual.dtype == torch.int32
    np.testing.assert_array_equal(actual.numpy(), np.asarray(expected))
    chunks = list(torch_lm.generate_stream(params, config, _t(prompt), 9,
                                           chunk=4))
    assert [offset for offset, _ in chunks] == [0, 1, 5]
    np.testing.assert_array_equal(
        np.concatenate([block for _, block in chunks], axis=1),
        np.asarray(expected))


# -- the paged steps against the JAX package --------------------------------

TINY = dict(vocab_size=64, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32,
            d_ff=64, max_seq_len=64, dtype="float32", n_experts=4)
BLOCK = 4
NUM_BLOCKS = 12
TABLES = np.array([[3, 5, 7, 0, 0, 0], [0] * 6, [2, 4, 9, 0, 0, 0]],
                  np.int32)
POSITIONS = np.array([7, 0, 3], np.int32)


def _assert_pools_agree(jax_pool, torch_pool):
    """Every block but the trash block (which duplicate write lands there
    is unspecified in both packages)."""
    for name, expected in jax_pool.items():
        expected = np.asarray(expected)[:, 1:]
        actual = torch_pool[name].numpy()[:, 1:]
        np.testing.assert_allclose(actual, expected, atol=1e-5, rtol=0,
                                   err_msg=name)


def _prefilled(factor):
    jax_params, jax_config, params, config = _models(
        TINY, moe_capacity_factor=factor)
    jax_pool = jax_lm.init_paged_pool(jax_config, NUM_BLOCKS, BLOCK)
    pool = torch_lm.init_paged_pool(config, NUM_BLOCKS, BLOCK, device="cpu")
    rng = np.random.default_rng(5)
    for slot, length in ((0, 8), (2, 4)):
        prompt = rng.integers(1, 64, (1, length)).astype(np.int32)
        true_len = int(POSITIONS[slot])
        jax_pool, jax_first = jax_lm.paged_prefill(
            jax_params, jax_config, jax_pool, prompt, TABLES[slot],
            np.int32(true_len))
        pool, first = torch_lm.paged_prefill(
            params, config, pool, _t(prompt), _t(TABLES[slot]), true_len)
        assert int(first) == int(jax_first)
    return jax_params, jax_config, jax_pool, params, config, pool


@pytest.mark.parametrize("factor", [DROPS, NO_DROPS])
def test_paged_steps_match_jax(factor):
    """paged_prefill (capacity dispatch over 8- and 4-token prompts), then
    three decode steps (the weight gather, 1 < E), a 4-token verify
    window (capacity, W = E) and an 8-token prefill chunk: identical
    tokens, pools within tolerance."""
    (jax_params, jax_config, jax_pool, params, config,
     pool) = _prefilled(factor)
    _assert_pools_agree(jax_pool, pool)
    # decode
    tables, positions = TABLES.copy(), POSITIONS.copy()
    tokens = np.array([[11], [0], [23]], np.int32)
    for _ in range(3):
        write_blocks = np.array(
            [tables[slot, positions[slot] // BLOCK] if slot != 1
             else TRASH_BLOCK for slot in range(3)], np.int32)
        write_offsets = (positions % BLOCK).astype(np.int32)
        jax_pool, expected = jax_lm.paged_decode_step(
            jax_params, jax_config, jax_pool, tables, positions, tokens,
            write_blocks, write_offsets)
        pool, actual = torch_lm.paged_decode_step(
            params, config, pool, _t(tables), _t(positions), _t(tokens),
            _t(write_blocks), _t(write_offsets))
        np.testing.assert_array_equal(actual.numpy()[[0, 2]],
                                      np.asarray(expected)[[0, 2]])
        tokens = actual.numpy()
        positions = positions + np.array([1, 0, 1], np.int32)
    _assert_pools_agree(jax_pool, pool)
    # verify: a 4-token window from the new positions
    window = np.array([[11, 5, 9, 2], [0, 0, 0, 0], [23, 8, 1, 40]],
                      np.int32)
    write_blocks = np.full((3, 4), TRASH_BLOCK, np.int32)
    write_offsets = np.zeros((3, 4), np.int32)
    for slot in (0, 2):
        for j in range(4):
            position = int(positions[slot]) + j
            write_blocks[slot, j] = tables[slot, position // BLOCK]
            write_offsets[slot, j] = position % BLOCK
    jax_pool, expected = jax_lm.paged_verify_step(
        jax_params, jax_config, jax_pool, tables, positions, window,
        write_blocks, write_offsets)
    pool, actual = torch_lm.paged_verify_step(
        params, config, pool, _t(tables), _t(positions), _t(window),
        _t(write_blocks), _t(write_offsets))
    np.testing.assert_array_equal(actual.numpy()[[0, 2]],
                                  np.asarray(expected)[[0, 2]])
    _assert_pools_agree(jax_pool, pool)
    # prefill chunk: 5 real tokens of slot 2 from position 10, 3 padding
    start = int(positions[2]) + 4
    chunk = np.zeros((1, 8), np.int32)
    chunk[0, :5] = [3, 14, 15, 9, 26]
    write_blocks = np.full((8,), TRASH_BLOCK, np.int32)
    write_offsets = np.zeros((8,), np.int32)
    for offset in range(8):
        position = start + offset
        if offset < 5:
            write_blocks[offset] = TABLES[2, position // BLOCK]
        write_offsets[offset] = position % BLOCK
    jax_pool, expected = jax_lm.paged_prefill_chunk(
        jax_params, jax_config, jax_pool, chunk, TABLES[2], np.int32(start),
        write_blocks, write_offsets)
    pool, actual = torch_lm.paged_prefill_chunk(
        params, config, pool, _t(chunk), _t(TABLES[2]), start,
        _t(write_blocks), _t(write_offsets))
    np.testing.assert_array_equal(actual.numpy()[:5],
                                  np.asarray(expected)[:5])
    _assert_pools_agree(jax_pool, pool)


# -- the decode engine ------------------------------------------------------

STORM_COUNTERS = ("admitted", "preempted", "deferred_admissions",
                  "prefill_chunks", "spec_accepted", "prefix_hits")
STORMS = {
    "preempting": dict(kv_block_size=4, kv_blocks=17),
    "chunked": dict(kv_block_size=8, prefill_chunk_size=8),
    "speculative": dict(kv_block_size=8, spec_k=3),
    "prefix": dict(kv_block_size=4, prefix_policy="prefix_cache=on"),
}


def drain(engine, limit=2000):
    done = {}
    steps = 0
    while engine.has_work():
        for completion in engine.step().completions:
            done[completion.request_id] = completion
        steps += 1
        assert steps < limit, "engine failed to drain"
    return done


def _storm_requests():
    """12 ragged requests; every third shares a 12-token preamble."""
    rng = np.random.default_rng(17)
    preamble = rng.integers(1, 64, size=12).astype(np.int32)
    requests = []
    for index in range(12):
        tail = rng.integers(1, 64, size=int(rng.integers(1, 18)))
        prompt = (np.concatenate([preamble, tail]) if index % 3 == 0
                  else tail).astype(np.int32)
        requests.append((prompt, int(rng.integers(2, 12))))
    return requests


def _run_storm(engine_class, params, config, draft, options):
    if "spec_k" in options:
        options = dict(options, draft_params=draft[0],
                       draft_config=draft[1])
    engine = engine_class(params, config, decode_slots=3, **options)
    done = {}
    for index, (prompt, max_new) in enumerate(_storm_requests()):
        engine.submit(index, prompt, max_new)
        if index % 4 == 3:    # arrivals in waves, mid-decode
            for _ in range(3):
                for completion in engine.step().completions:
                    done[completion.request_id] = completion
    done.update(drain(engine))
    return ({index: completion.tokens for index, completion in done.items()},
            {name: engine.counters[name] for name in STORM_COUNTERS})


@pytest.mark.parametrize("factor", [DROPS, NO_DROPS])
@pytest.mark.parametrize("storm", sorted(STORMS))
def test_engine_storm_matches_jax_engine(storm, factor):
    jax_params, jax_config, params, config = _models(
        TINY, moe_capacity_factor=factor)
    jax_draft, jax_draft_config, draft, draft_config = _models(
        TINY, seed=3, n_layers=1, moe_capacity_factor=factor)
    expected, expected_counters = _run_storm(
        jax_decode.DecodeEngine, jax_params, jax_config,
        (jax_draft, jax_draft_config), STORMS[storm])
    actual, counters = _run_storm(DecodeEngine, params, config,
                                  (draft, draft_config), STORMS[storm])
    assert sorted(actual) == sorted(expected) == list(range(12))
    for index in expected:
        np.testing.assert_array_equal(actual[index], expected[index])
    assert counters == expected_counters
    fired = {"preempting": "preempted", "chunked": "prefill_chunks",
             "speculative": "spec_accepted", "prefix": "prefix_hits"}
    assert counters[fired[storm]] > 0


def _closed_batch(params, config, prompt, max_new):
    out, _ = torch_lm.generate(params, config, _t(prompt)[None], max_new)
    return out[0].numpy()


def test_engine_contracts_hold_where_nothing_drops():
    """At moe_capacity_factor = n_experts: the engine's completions equal
    closed-batch generate()'s, and chunked prefill and speculative decode
    change no token."""
    _, _, params, config = _models(TINY, moe_capacity_factor=NO_DROPS)
    _, _, draft, draft_config = _models(TINY, seed=3, n_layers=1,
                                        moe_capacity_factor=NO_DROPS)
    requests = _storm_requests()
    expected = {index: _closed_batch(params, config, prompt, max_new)
                for index, (prompt, max_new) in enumerate(requests)}
    for options in (dict(kv_block_size=8),
                    dict(kv_block_size=8, prefill_chunk_size=8),
                    dict(kv_block_size=8, spec_k=3,
                         draft_params=draft, draft_config=draft_config)):
        engine = DecodeEngine(params, config, decode_slots=3, **options)
        for index, (prompt, max_new) in enumerate(requests):
            engine.submit(index, prompt, max_new)
        done = drain(engine)
        for index, tokens in expected.items():
            np.testing.assert_array_equal(done[index].tokens, tokens,
                                          err_msg=str(options))


def test_engine_runs_the_moe_step_signatures_once():
    """An admission/eviction storm after warm-up adds no step signature:
    the MoE paths take their capacities from static shapes."""
    _, _, params, config = _models(TINY, moe_capacity_factor=DROPS)
    engine = DecodeEngine(params, config, decode_slots=3, kv_block_size=8)
    for index, length in enumerate((3, 12, 20, 30)):   # every bucket
        engine.submit(("warm", index),
                      np.arange(1, length + 1, dtype=np.int32), 3)
    drain(engine)
    warm = engine.compile_count
    for index, (prompt, max_new) in enumerate(_storm_requests()):
        engine.submit(100 + index, prompt, max_new)
    drain(engine)
    assert engine.compile_count == warm
