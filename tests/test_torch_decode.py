# The port's continuous decode engine (aiko_services_tpu_torch/decode/)
# and its paged KV steps (models/transformer.py) on the CPU.
#
# Against the JAX package, on the same weights (the JAX package's random
# parameters through numpy into the port, models/bridge.py) and the same
# numpy inputs: the paged steps' greedy tokens identical and the pool
# blocks they write within atol 1e-5 (f32 K/V of order 1 out of two
# layers, the same products summed in another order), int8 codes off by
# at most one code and scales within rtol 1e-6 or atol 1e-5 / 127 (the
# absmax of K/V that agree within 1e-5, over 127); a storm of 12 ragged
# requests over 3 slots -- plain with preemption, chunked, speculative,
# prefix-cached, on the GQA variant -- with every request's tokens and
# the engine's counters identical.  Then the port's own contracts, pinned
# bitwise as the JAX package's tests pin them (tests/test_decode.py): the
# engine's tokens equal the closed-batch generate()'s, chunked equals
# monolithic, speculative equals plain, preemption is deterministic and
# re-emits nothing, and an admission/eviction storm after warm-up adds no
# step signature.  The JAX tests' TINY config (f32, 2 heads) and a GQA variant
# (4 heads over 2 KV heads, as LLAMA32_1B groups its heads).

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu import decode as jax_decode
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu_torch.decode import (
    TRASH_BLOCK, BlockManager, DecodeEngine)
from aiko_services_tpu_torch.models import params_from_numpy
from aiko_services_tpu_torch.models import transformer as torch_lm

TINY = dict(vocab_size=64, n_layers=2, n_heads=2, n_kv_heads=2,
            d_model=32, d_ff=64, max_seq_len=64, dtype="float32")
GQA = dict(TINY, n_heads=4, n_kv_heads=2)
CONFIGS = {"tiny": TINY, "gqa": GQA}
KV_DTYPES = ["", "int8"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These models are tiny: one intra-op thread computes them as fast as
    many, and several test workers sharing the cores do not then spin
    each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(config: dict, kv_dtype: str = "", seed: int = 0):
    """(jax params, jax config, port params, port config) on the CPU."""
    jax_config = jax_lm.TransformerConfig(**config, kv_dtype=kv_dtype)
    jax_params = jax_lm.init_params(jax_config, jax.random.PRNGKey(seed))
    numpy_params = jax.tree_util.tree_map(np.asarray, jax_params)
    return (jax_params, jax_config,
            params_from_numpy(numpy_params, device="cpu"),
            torch_lm.TransformerConfig(**config, kv_dtype=kv_dtype))


@pytest.fixture(scope="module")
def tiny():
    _, _, params, config = _models(TINY)
    return params, config


def reference(params, config, prompt, max_new):
    """The port's closed-batch greedy completion for ONE exact-length
    prompt -- the oracle of every engine test."""
    out, _ = torch_lm.generate(params, config,
                               torch.from_numpy(np.asarray(prompt))[None],
                               max_new)
    return out[0].numpy()


def drain(engine, limit=2000):
    """Step the engine until idle; returns {request_id: Completion}."""
    done = {}
    steps = 0
    while engine.has_work():
        for completion in engine.step().completions:
            done[completion.request_id] = completion
        steps += 1
        assert steps < limit, "engine failed to drain (deadlock?)"
    return done


def _t(array):
    return torch.from_numpy(np.asarray(array))


def _assert_pools_agree(jax_pool, torch_pool, skip_trash=True):
    for name, expected in jax_pool.items():
        expected = np.asarray(expected)
        actual = torch_pool[name].numpy()
        if skip_trash:
            # which duplicate write lands in the trash block is
            # unspecified in both packages
            expected, actual = expected[:, 1:], actual[:, 1:]
        if actual.dtype == np.int8:
            assert np.abs(actual.astype(np.int32)
                          - expected.astype(np.int32)).max() <= 1, name
        elif name.endswith("_scale"):
            # absmax / 127 of K/V that agree within 1e-5
            np.testing.assert_allclose(actual, expected, rtol=1e-6,
                                       atol=1e-5 / 127, err_msg=name)
        else:
            np.testing.assert_allclose(actual, expected, atol=1e-5,
                                       rtol=0, err_msg=name)


# -- the paged steps against the JAX package --------------------------------

BLOCK = 4
NUM_BLOCKS = 12
# a mixed slot state over 3 slots of 6-block tables: slot 0 seven tokens
# in (its next write crosses into its second block), slot 1 inactive on
# the trash block, slot 2 three tokens in
TABLES = np.array([[3, 5, 7, 0, 0, 0], [0] * 6, [2, 4, 9, 0, 0, 0]],
                  np.int32)
POSITIONS = np.array([7, 0, 3], np.int32)


def _prefilled(config: dict, kv_dtype: str):
    """Both packages' models with slots 0 and 2 prefilled (8- and
    4-token prompts) into identical pools."""
    jax_params, jax_config, params, port_config = _models(config, kv_dtype)
    jax_pool = jax_lm.init_paged_pool(jax_config, NUM_BLOCKS, BLOCK)
    pool = torch_lm.init_paged_pool(port_config, NUM_BLOCKS, BLOCK,
                                    device="cpu")
    rng = np.random.default_rng(5)
    firsts = []
    for slot, length in ((0, 8), (2, 4)):
        prompt = rng.integers(1, 64, (1, length)).astype(np.int32)
        true_len = int(POSITIONS[slot])
        jax_pool, jax_first = jax_lm.paged_prefill(
            jax_params, jax_config, jax_pool, prompt, TABLES[slot],
            np.int32(true_len))
        pool, first = torch_lm.paged_prefill(
            params, port_config, pool, _t(prompt), _t(TABLES[slot]),
            true_len)
        firsts.append((int(jax_first), int(first)))
    return (jax_params, jax_config, jax_pool, params, port_config, pool,
            firsts)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_prefill_matches_jax(name, kv_dtype):
    *_, jax_pool, _, _, pool, firsts = _prefilled(CONFIGS[name], kv_dtype)
    for jax_first, first in firsts:
        assert first == jax_first
    assert pool["k"].dtype == (torch.int8 if kv_dtype else torch.float32)
    _assert_pools_agree(jax_pool, pool, skip_trash=False)


def test_init_paged_pool_matches_jax_layout():
    for kv_dtype in KV_DTYPES:
        jax_config = jax_lm.TransformerConfig(**GQA, kv_dtype=kv_dtype)
        port_config = torch_lm.TransformerConfig(**GQA, kv_dtype=kv_dtype)
        expected = jax_lm.init_paged_pool(jax_config, 5, 4)
        actual = torch_lm.init_paged_pool(port_config, 5, 4, device="cpu")
        assert sorted(actual) == sorted(expected)
        for name, leaf in expected.items():
            assert tuple(actual[name].shape) == leaf.shape
            assert str(actual[name].dtype).replace("torch.", "") == str(
                leaf.dtype)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_decode_step_matches_jax(name, kv_dtype):
    """Ragged positions, an inactive slot on the trash block and a block
    crossing: three decode steps, identical tokens, pools within
    tolerance."""
    (jax_params, jax_config, jax_pool, params, port_config, pool,
     _) = _prefilled(CONFIGS[name], kv_dtype)
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
            params, port_config, pool, _t(tables), _t(positions),
            _t(tokens), _t(write_blocks), _t(write_offsets))
        assert actual.dtype == torch.int32 and actual.shape == (3, 1)
        np.testing.assert_array_equal(actual.numpy()[[0, 2]],
                                      np.asarray(expected)[[0, 2]])
        tokens = actual.numpy()
        positions = positions + np.array([1, 0, 1], np.int32)
    _assert_pools_agree(jax_pool, pool)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_verify_step_matches_jax(name, kv_dtype):
    """A 4-token window per slot (slot 0's crosses a block boundary);
    the inactive slot's window writes to the trash block."""
    (jax_params, jax_config, jax_pool, params, port_config, pool,
     _) = _prefilled(CONFIGS[name], kv_dtype)
    window = np.array([[11, 5, 9, 2], [0, 0, 0, 0], [23, 8, 1, 40]],
                      np.int32)
    write_blocks = np.full((3, 4), TRASH_BLOCK, np.int32)
    write_offsets = np.zeros((3, 4), np.int32)
    for slot in (0, 2):
        for j in range(4):
            position = int(POSITIONS[slot]) + j
            write_blocks[slot, j] = TABLES[slot, position // BLOCK]
            write_offsets[slot, j] = position % BLOCK
    jax_pool, expected = jax_lm.paged_verify_step(
        jax_params, jax_config, jax_pool, TABLES, POSITIONS, window,
        write_blocks, write_offsets)
    pool, actual = torch_lm.paged_verify_step(
        params, port_config, pool, _t(TABLES), _t(POSITIONS), _t(window),
        _t(write_blocks), _t(write_offsets))
    np.testing.assert_array_equal(actual.numpy()[[0, 2]],
                                  np.asarray(expected)[[0, 2]])
    _assert_pools_agree(jax_pool, pool)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_prefill_chunk_matches_jax(name, kv_dtype):
    """An 8-token chunk of slot 2's prompt from position 3 (5 real
    tokens, 3 padding positions on the trash block), attending to the
    blocks its prefill wrote."""
    (jax_params, jax_config, jax_pool, params, port_config, pool,
     _) = _prefilled(CONFIGS[name], kv_dtype)
    chunk = np.zeros((1, 8), np.int32)
    chunk[0, :5] = [3, 14, 15, 9, 26]
    write_blocks = np.full((8,), TRASH_BLOCK, np.int32)
    write_offsets = np.zeros((8,), np.int32)
    for offset in range(8):
        position = 3 + offset
        if offset < 5:
            write_blocks[offset] = TABLES[2, position // BLOCK]
        write_offsets[offset] = position % BLOCK
    jax_pool, expected = jax_lm.paged_prefill_chunk(
        jax_params, jax_config, jax_pool, chunk, TABLES[2], np.int32(3),
        write_blocks, write_offsets)
    pool, actual = torch_lm.paged_prefill_chunk(
        params, port_config, pool, _t(chunk), _t(TABLES[2]), 3,
        _t(write_blocks), _t(write_offsets))
    assert actual.shape == (8,)
    np.testing.assert_array_equal(actual.numpy()[:5],
                                  np.asarray(expected)[:5])
    _assert_pools_agree(jax_pool, pool)


def test_f32_head_keeps_the_logits():
    """The engine's params carry the head once in f32: the same logits
    as the bf16 tree's per-call cast, and an f32 or int8 head is left as
    it is."""
    config = torch_lm.TransformerConfig(**{**GQA, "dtype": "bfloat16"})
    params = torch_lm.init_params(config, torch.Generator().manual_seed(0),
                                  device="cpu")
    served = torch_lm.f32_head(params)
    assert served["lm_head"]["w"].dtype == torch.float32
    assert "lm_head" not in params
    h = torch.randn((2, 3, config.d_model),
                    generator=torch.Generator().manual_seed(1)).to(
                        torch.bfloat16)
    assert torch.equal(torch_lm._lm_head(served, config, h),
                       torch_lm._lm_head(params, config, h))
    f32 = torch_lm.init_params(torch_lm.TransformerConfig(**GQA),
                               torch.Generator(), device="cpu")
    assert torch_lm.f32_head(f32) is f32
    quantized = torch_lm.quantize_weights_int8(params, config)
    assert torch_lm.f32_head(quantized) is quantized


# -- the engine against the JAX package's -----------------------------------

STORM_COUNTERS = ("admitted", "preempted", "deferred_admissions",
                  "prefill_chunks", "spec_accepted", "prefix_hits")

STORMS = {
    # oversubscribed: 3 slots over 16 blocks of 4 fire preemption
    "preempting": dict(kv_block_size=4, kv_blocks=17),
    "chunked": dict(kv_block_size=8, prefill_chunk_size=8),
    "speculative": dict(kv_block_size=8, spec_k=3),
    "prefix": dict(kv_block_size=4, prefix_policy="prefix_cache=on"),
}


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


@pytest.mark.parametrize("storm", sorted(STORMS))
def test_engine_storm_matches_jax_engine(storm):
    jax_params, jax_config, params, config = _models(GQA)
    draft_dims = dict(GQA, n_layers=1)
    jax_draft, jax_draft_config, draft, draft_config = _models(
        draft_dims, seed=3)
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


def test_int8_engine_storm_matches_jax_engine():
    jax_params, jax_config, params, config = _models(GQA, "int8")
    expected, expected_counters = _run_storm(
        jax_decode.DecodeEngine, jax_params, jax_config, None,
        STORMS["preempting"])
    actual, counters = _run_storm(DecodeEngine, params, config, None,
                                  STORMS["preempting"])
    for index in expected:
        np.testing.assert_array_equal(actual[index], expected[index])
    assert counters == expected_counters


# -- BlockManager -----------------------------------------------------------

class TestBlockManager:
    def test_capacity_excludes_trash_block(self):
        manager = BlockManager(8, 4)
        assert manager.capacity == 7
        assert manager.free_count == 7

    def test_allocate_is_all_or_nothing(self):
        manager = BlockManager(4, 4)  # capacity 3
        assert manager.allocate(4) is None
        assert manager.free_count == 3  # nothing partially taken
        granted = manager.allocate(3)
        assert len(granted) == 3
        assert TRASH_BLOCK not in granted
        assert manager.allocate(1) is None

    def test_free_returns_blocks_and_rejects_double_free(self):
        manager = BlockManager(4, 4)
        granted = manager.allocate(2)
        manager.free(granted)
        assert manager.free_count == 3
        with pytest.raises(ValueError, match="double free"):
            manager.free([granted[0], granted[0]])
        with pytest.raises(ValueError, match="trash"):
            manager.free([TRASH_BLOCK])

    def test_blocks_for_rounds_up(self):
        manager = BlockManager(8, 4)
        assert manager.blocks_for(1) == 1
        assert manager.blocks_for(4) == 1
        assert manager.blocks_for(5) == 2

    def test_rejects_degenerate_pools(self):
        with pytest.raises(ValueError):
            BlockManager(1, 4)  # no room for trash + one real block
        with pytest.raises(ValueError):
            BlockManager(4, 0)

    def test_allocation_order_matches_jax(self):
        """The same LIFO free list as the JAX package's manager, so both
        engines place every request in the same blocks."""
        ours, theirs = BlockManager(9, 4), jax_decode.BlockManager(9, 4)
        for count in (3, 2, 1):
            assert ours.allocate(count) == theirs.allocate(count)
        ours.free([2, 4])
        theirs.free([2, 4])
        assert ours.allocate(3) == theirs.allocate(3)


# -- the engine against the port's closed batch: bitwise --------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_generate_bitwise(name):
    """Continuous-mode completions equal the closed-batch generate() for
    the same prompts, across ragged lengths decoded interleaved in shared
    slots."""
    _, _, params, config = _models(CONFIGS[name])
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 64, size=n).astype(np.int32)
               for n in (5, 9, 3, 12, 7, 4)]
    engine = DecodeEngine(params, config, decode_slots=3, kv_block_size=8)
    for index, prompt in enumerate(prompts):
        engine.submit(index, prompt, 8)
    done = drain(engine)
    assert len(done) == len(prompts)
    for index, prompt in enumerate(prompts):
        np.testing.assert_array_equal(done[index].tokens,
                                      reference(params, config, prompt, 8))
    stats = engine.stats()
    assert stats["completed"] == len(prompts)
    assert stats["active_slots"] == 0
    assert stats["free_blocks"] == engine.blocks.capacity  # all returned


def test_engine_eos_frees_slot_early(tiny):
    """A sequence hitting eos_id completes before max_new; its tokens are
    EOS-padded to the fixed width and its slot frees immediately."""
    params, config = tiny
    prompt = np.arange(1, 6, dtype=np.int32)
    tokens = reference(params, config, prompt, 12)
    cut = next(k for k in range(1, 12) if tokens[k] not in tokens[:k])
    eos = int(tokens[cut])
    engine = DecodeEngine(params, config, decode_slots=1, kv_block_size=8,
                          eos_id=eos)
    engine.submit(0, prompt, 12)
    completion = drain(engine)[0]
    assert completion.stats["tokens"] == cut + 1
    np.testing.assert_array_equal(completion.tokens[:cut + 1],
                                  tokens[:cut + 1])
    assert (completion.tokens[cut + 1:] == eos).all()


def test_engine_rejects_oversized_request(tiny):
    params, config = tiny
    engine = DecodeEngine(params, config, decode_slots=1, kv_block_size=8,
                          max_context=32)
    with pytest.raises(ValueError, match="max_context"):
        engine.submit(0, np.arange(1, 30, dtype=np.int32), 16)
    with pytest.raises(ValueError, match="empty"):
        engine.submit(1, np.zeros((0,), np.int32), 4)


def test_engine_admits_prompt_whose_pow2_bucket_overshoots(tiny):
    """A non-power-of-two (block-multiple) max_context admits any request
    with prompt + max_new <= max_context, even when the power-of-two
    prefill bucket rounds past it: the bucket is clamped."""
    params, config = tiny
    engine = DecodeEngine(params, config, decode_slots=1, kv_block_size=8,
                          max_context=24)
    prompt = np.arange(1, 21, dtype=np.int32)    # bucket(20) pow2 = 32 > 24
    engine.submit(0, prompt, 4)                  # 20 + 4 == 24: fits
    np.testing.assert_array_equal(drain(engine)[0].tokens,
                                  reference(params, config, prompt, 4))
    with pytest.raises(ValueError, match="max_context"):
        engine.submit(1, prompt, 5)              # 20 + 5 > 24: real reject


def test_no_new_step_signature_across_admission_eviction_storm(tiny):
    """After warm-up, a seeded sequence of >= 20 admissions and evictions
    at varying prompt lengths adds no step signature: the trash block
    keeps every step's shape, so the decode step's captured graph (on the
    card) serves the whole storm."""
    params, config = tiny
    engine = DecodeEngine(params, config, decode_slots=3, kv_block_size=8)
    for index, length in enumerate((3, 9, 17)):  # buckets 8, 16, 24
        engine.submit(("warmup", index),
                      np.arange(1, length + 1, dtype=np.int32), 3)
    drain(engine)
    warm = engine.compile_count
    assert warm == 4    # three prefill buckets and the decode step
    rng = np.random.default_rng(42)
    submitted = completed = 0
    while submitted < 24:
        for _ in range(int(rng.integers(1, 4))):
            length = int(rng.integers(1, 21))
            engine.submit(("storm", submitted),
                          rng.integers(1, 64, size=length).astype(np.int32),
                          int(rng.integers(1, 8)))
            submitted += 1
        for _ in range(int(rng.integers(1, 5))):
            completed += len(engine.step().completions)
    completed += len(drain(engine))
    assert completed == submitted >= 20
    assert engine.compile_count == warm


# -- pool exhaustion: deferral and preemption -------------------------------

def test_exhausted_pool_defers_admission_without_deadlock(tiny):
    params, config = tiny
    # capacity 3 blocks of 8; each request needs 2 prompt blocks
    engine = DecodeEngine(params, config, decode_slots=2, kv_block_size=8,
                          kv_blocks=4)
    prompts = {index: np.arange(1, 10, dtype=np.int32) + index
               for index in range(3)}
    for index, prompt in prompts.items():
        engine.submit(index, prompt, 3)
    done = drain(engine)
    assert len(done) == 3
    assert 1 <= engine.counters["deferred_admissions"] <= 2
    assert engine.counters["preempted"] == 0
    for index, prompt in prompts.items():
        np.testing.assert_array_equal(
            done[index].tokens, reference(params, config, prompt, 3))


def test_preemption_evicts_youngest_and_stays_deterministic(tiny):
    params, config = tiny
    engine = DecodeEngine(params, config, decode_slots=2, kv_block_size=4,
                          kv_blocks=6)
    prompts = {0: np.arange(1, 5, dtype=np.int32),
               1: np.arange(11, 15, dtype=np.int32)}
    for index, prompt in prompts.items():
        engine.submit(index, prompt, 12)
    done = drain(engine)
    assert engine.counters["preempted"] >= 1
    assert done[1].stats["preemptions"] >= 1  # youngest was the victim
    for index, prompt in prompts.items():
        np.testing.assert_array_equal(
            done[index].tokens, reference(params, config, prompt, 12))


def test_preempted_request_does_not_reemit_streamed_tokens(tiny):
    params, config = tiny
    engine = DecodeEngine(params, config, decode_slots=2, kv_block_size=4,
                          kv_blocks=6)
    for index in range(2):
        engine.submit(index, np.arange(1, 5, dtype=np.int32) + index, 12)
    emitted = {}
    steps = 0
    while engine.has_work():
        for request_id, offset, token in engine.step().emitted:
            emitted.setdefault(request_id, []).append((offset, token))
        steps += 1
        assert steps < 2000
    assert engine.counters["preempted"] >= 1
    for request_id, pairs in emitted.items():
        offsets = [offset for offset, _ in pairs]
        assert offsets == list(range(12)), (request_id, offsets)


def test_preemption_mid_chunked_prefill_frees_partial_blocks(tiny):
    """A slot preempted between prefill chunks returns its partially
    written blocks (no leak) and still completes bit-identically."""
    params, config = tiny
    engine = DecodeEngine(params, config, decode_slots=2, kv_block_size=2,
                          kv_blocks=12, prefill_chunk_size=2)
    prompts = {0: np.arange(1, 3, dtype=np.int32),
               1: np.arange(11, 27, dtype=np.int32)}
    engine.submit(0, prompts[0], 18)
    engine.step()
    engine.submit(1, prompts[1], 4)
    mid_prefill_preempted = False
    done = {}
    steps = 0
    while engine.has_work():
        slot1 = next((slot for slot in engine.slots
                      if slot is not None
                      and slot.request.request_id == 1), None)
        before = engine.counters["preempted"]
        report = engine.step()
        if (slot1 is not None and slot1.prefilling
                and engine.counters["preempted"] > before):
            mid_prefill_preempted = True
        for completion in report.completions:
            done[completion.request_id] = completion
        steps += 1
        assert steps < 4000
    assert mid_prefill_preempted
    assert engine.stats()["free_blocks"] == engine.blocks.capacity
    for index, prompt in prompts.items():
        np.testing.assert_array_equal(
            done[index].tokens,
            reference(params, config, prompt, done[index].tokens.size))


def test_cancel_frees_slots_and_waiting(tiny):
    params, config = tiny
    engine = DecodeEngine(params, config, decode_slots=1, kv_block_size=8)
    for index in range(3):
        engine.submit(("s", index), np.arange(1, 6, dtype=np.int32), 8)
    engine.step()  # admit request 0 into the single slot
    assert engine.cancel(lambda rid: rid[1] != 1) == 2
    assert engine.counters["cancelled"] == 2
    assert list(drain(engine)) == [("s", 1)]
    assert engine.stats()["free_blocks"] == engine.blocks.capacity


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_int8_kv_matches_quantized_generate(name):
    _, _, params, config = _models(CONFIGS[name], "int8")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 64, size=n).astype(np.int32)
               for n in (6, 11)]
    engine = DecodeEngine(params, config, decode_slots=2, kv_block_size=8)
    for index, prompt in enumerate(prompts):
        engine.submit(index, prompt, 6)
    done = drain(engine)
    for index, prompt in enumerate(prompts):
        np.testing.assert_array_equal(
            done[index].tokens, reference(params, config, prompt, 6))


# -- chunked prefill ----------------------------------------------------------

PROMPT_LENGTHS = (5, 21, 3, 33, 7, 12)


def _chunked_run(params, config, chunk, max_new=8, **kwargs):
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 64, size=n).astype(np.int32)
               for n in PROMPT_LENGTHS]
    engine = DecodeEngine(params, config, decode_slots=3, kv_block_size=8,
                          prefill_chunk_size=chunk, **kwargs)
    for index, prompt in enumerate(prompts):
        engine.submit(index, prompt, max_new)
    return prompts, engine, drain(engine)


@pytest.mark.parametrize("kv_dtype,chunk", [("", 8), ("", 16), ("", 64),
                                            ("int8", 8)])
def test_chunked_matches_monolithic_bitwise(kv_dtype, chunk):
    """Chunk sizes {1 block, 1 bucket, full prompt}, f32 and int8 KV:
    completions equal the closed batch's."""
    _, _, params, config = _models(TINY, kv_dtype)
    prompts, engine, done = _chunked_run(params, config, chunk)
    for index, prompt in enumerate(prompts):
        np.testing.assert_array_equal(
            done[index].tokens, reference(params, config, prompt, 8))
    if chunk < 64:
        assert engine.counters["prefill_chunks"] > 0


def test_prefill_interleaves_with_decode(tiny):
    params, config = tiny
    engine = DecodeEngine(params, config, decode_slots=2, kv_block_size=8,
                          prefill_chunk_size=8)
    engine.submit("short", np.arange(1, 4, dtype=np.int32), 24)
    engine.step()
    engine.submit("long", np.arange(1, 34, dtype=np.int32), 4)
    interleaved_tokens = 0
    steps = 0
    while engine.has_work():
        long_slot = next((slot for slot in engine.slots if slot is not None
                          and slot.request.request_id == "long"), None)
        mid_prefill = long_slot is not None and long_slot.prefilling
        report = engine.step()
        if mid_prefill:
            interleaved_tokens += sum(
                1 for rid, _, _ in report.emitted if rid == "short")
        steps += 1
        assert steps < 2000
    assert interleaved_tokens > 0
    assert engine.counters["chunk_interleaves"] > 0


def test_chunk_size_coerced_to_block_multiple(tiny):
    params, config = tiny
    engine = DecodeEngine(params, config, decode_slots=1, kv_block_size=8,
                          prefill_chunk_size=3)
    assert engine.prefill_chunk == 8  # pow2 floored at block size


# -- speculative decoding -----------------------------------------------------

def _draft(config, seed=3, **overrides):
    draft_config = replace(config, n_layers=1, **overrides)
    return (torch_lm.init_params(draft_config,
                                 torch.Generator().manual_seed(seed),
                                 device="cpu"), draft_config)


def test_spec_decode_storm_bit_identical(tiny):
    """A seeded 20-request storm under speculation matches plain greedy
    bit for bit, with no new step signature after warm-up."""
    params, config = tiny
    draft_params, draft_config = _draft(config)
    engine = DecodeEngine(params, config, decode_slots=3, kv_block_size=8,
                          draft_params=draft_params,
                          draft_config=draft_config, spec_k=3)
    rng = np.random.default_rng(42)
    for index, length in enumerate((3, 9, 17)):
        engine.submit(("warm", index),
                      np.arange(1, length + 1, dtype=np.int32), 5)
    drain(engine)
    warm = engine.compile_count
    workload, done = {}, {}
    submitted = 0
    while submitted < 20:
        for _ in range(int(rng.integers(1, 4))):
            prompt = rng.integers(1, 64, size=int(rng.integers(1, 21))
                                  ).astype(np.int32)
            workload[submitted] = (prompt, int(rng.integers(1, 10)))
            engine.submit(submitted, *workload[submitted])
            submitted += 1
        for _ in range(int(rng.integers(1, 5))):
            for completion in engine.step().completions:
                done[completion.request_id] = completion
    done.update(drain(engine))
    for index, (prompt, max_new) in workload.items():
        np.testing.assert_array_equal(
            done[index].tokens, reference(params, config, prompt, max_new))
    assert engine.compile_count == warm
    assert engine.counters["spec_windows"] > 0


def test_self_draft_accepts_full_window(tiny):
    params, config = tiny
    engine = DecodeEngine(params, config, decode_slots=1, kv_block_size=8,
                          draft_params=params, draft_config=config,
                          spec_k=3)
    engine.submit(0, np.arange(1, 6, dtype=np.int32), 16)
    np.testing.assert_array_equal(
        drain(engine)[0].tokens,
        reference(params, config, np.arange(1, 6, dtype=np.int32), 16))
    stats = engine.stats()
    assert stats["accepted_len_mean"] > 3.0  # ceiling k+1 = 4
    assert 0.0 < stats["draft_overhead_frac"] < 1.0


def test_spec_int8_kv_matches_plain():
    _, _, params, config = _models(TINY, "int8")
    draft_params, draft_config = _draft(config)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 64, size=n).astype(np.int32)
               for n in (6, 11)]
    engine = DecodeEngine(params, config, decode_slots=2, kv_block_size=8,
                          draft_params=draft_params,
                          draft_config=draft_config, spec_k=2)
    for index, prompt in enumerate(prompts):
        engine.submit(index, prompt, 6)
    done = drain(engine)
    for index, prompt in enumerate(prompts):
        np.testing.assert_array_equal(
            done[index].tokens, reference(params, config, prompt, 6))


def test_spec_eos_truncates_accepted_run(tiny):
    params, config = tiny
    prompt = np.arange(1, 6, dtype=np.int32)
    plain = reference(params, config, prompt, 12)
    cut = next(k for k in range(1, 12) if plain[k] not in plain[:k])
    eos = int(plain[cut])
    engine = DecodeEngine(params, config, decode_slots=1, kv_block_size=8,
                          eos_id=eos, draft_params=params,
                          draft_config=config, spec_k=4)
    engine.submit(0, prompt, 12)
    completion = drain(engine)[0]
    assert completion.stats["tokens"] == cut + 1
    np.testing.assert_array_equal(completion.tokens[:cut + 1],
                                  plain[:cut + 1])
    assert (completion.tokens[cut + 1:] == eos).all()


def test_spec_with_chunked_prefill_storm(tiny):
    params, config = tiny
    draft_params, draft_config = _draft(config)
    engine = DecodeEngine(params, config, decode_slots=3, kv_block_size=8,
                          prefill_chunk_size=8, draft_params=draft_params,
                          draft_config=draft_config, spec_k=3)
    rng = np.random.default_rng(7)
    for index, length in enumerate((3, 9, 17, 33)):
        engine.submit(("warm", index),
                      np.arange(1, length + 1, dtype=np.int32), 3)
    drain(engine)
    warm = engine.compile_count
    workload, done = {}, {}
    submitted = 0
    while submitted < 20:
        for _ in range(int(rng.integers(1, 4))):
            prompt = rng.integers(1, 64, size=int(rng.integers(1, 40))
                                  ).astype(np.int32)
            workload[submitted] = (prompt, int(rng.integers(1, 8)))
            engine.submit(submitted, *workload[submitted])
            submitted += 1
        for _ in range(int(rng.integers(1, 5))):
            for completion in engine.step().completions:
                done[completion.request_id] = completion
    done.update(drain(engine))
    for index, (prompt, max_new) in workload.items():
        np.testing.assert_array_equal(
            done[index].tokens, reference(params, config, prompt, max_new))
    assert engine.compile_count == warm
    assert engine.counters["prefill_chunks"] > 0
    assert engine.counters["spec_windows"] > 0


def test_spec_rejects_mismatched_vocab_and_partial_config(tiny):
    params, config = tiny
    draft_params, draft_config = _draft(config)
    with pytest.raises(ValueError, match="vocab"):
        DecodeEngine(params, config, draft_params=draft_params,
                     draft_config=replace(draft_config, vocab_size=32))
    with pytest.raises(ValueError, match="BOTH"):
        DecodeEngine(params, config, draft_params=draft_params)
    with pytest.raises(ValueError, match="draft model"):
        DecodeEngine(params, config, spec_k=3)


# -- what the engine does not have yet raises --------------------------------

UNPORTED_METHODS = {
    "_ingest_kv_blocks": lambda engine: engine._ingest_kv_blocks(
        {}, 1, None, lambda reason: None, "handoff"),
    "adopt_request": lambda engine: engine.adopt_request(0, {}),
    "restore_request": lambda engine: engine.restore_request(0, None),
    "export_prefix_snapshot": lambda engine: engine.export_prefix_snapshot(
        np.arange(1, 9, dtype=np.int32)),
    "adopt_prefix": lambda engine: engine.adopt_prefix({}),
}


@pytest.mark.parametrize("method", sorted(UNPORTED_METHODS))
def test_unported_engine_methods_raise(tiny, method):
    params, config = tiny
    engine = DecodeEngine(params, config, decode_slots=1, kv_block_size=8,
                          prefix_policy="prefix_cache=on")
    with pytest.raises(NotImplementedError, match="Queue A item 2"):
        UNPORTED_METHODS[method](engine)
