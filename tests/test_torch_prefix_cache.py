# The port's cross-request prefix KV reuse (aiko_services_tpu_torch/
# decode/prefix.py) on the CPU: the hash chain (digests identical to the
# JAX package's, so a digest means the same prefix in both), the AIKO411
# policy grammar (the same verdicts as the JAX package's), the
# refcounted PrefixCache, and the engine's warm admissions -- a prompt
# that borrows cached blocks and prefills only its tail gives exactly the
# cold run's tokens, f32 and int8 KV, as tests/test_prefix_cache.py pins
# for the JAX package.  The gateway's affinity routing is not ported.

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu import decode as jax_decode
from aiko_services_tpu.models import transformer as jax_lm
from aiko_services_tpu_torch.decode import (
    BlockManager, DecodeEngine, PrefixCache, PrefixPolicy, chain_hashes,
    prefix_head)
from aiko_services_tpu_torch.models import params_from_numpy
from aiko_services_tpu_torch.models import transformer as torch_lm

TINY = dict(vocab_size=64, n_layers=2, n_heads=2, n_kv_heads=2,
            d_model=32, d_ff=64, max_seq_len=64, dtype="float32")

ARMED = "prefix_cache=on"


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These models are tiny: one intra-op thread computes them as fast as
    many, and several test workers sharing the cores do not then spin
    each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_model(kv_dtype: str = ""):
    """The JAX package's TINY parameters (key 0), through numpy."""
    jax_config = jax_lm.TransformerConfig(**TINY, kv_dtype=kv_dtype)
    params = jax_lm.init_params(jax_config, jax.random.PRNGKey(0))
    return (params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu"),
            torch_lm.TransformerConfig(**TINY, kv_dtype=kv_dtype))


@pytest.fixture(scope="module")
def tiny_model():
    return _port_model()


def reference(params, config, prompt, max_new):
    """The port's closed-batch greedy completion -- the oracle."""
    out, _ = torch_lm.generate(params, config,
                               torch.from_numpy(np.asarray(prompt))[None],
                               max_new)
    return out[0].numpy()


def drain(engine, limit=2000):
    done = {}
    steps = 0
    while engine.has_work():
        for completion in engine.step().completions:
            done[completion.request_id] = completion
        steps += 1
        assert steps < limit, "engine failed to drain (deadlock?)"
    return done


# -- hash chain --------------------------------------------------------------

class TestChainHashes:
    def test_deterministic_and_prefix_stable(self):
        tokens = np.arange(1, 25, dtype=np.int32)
        first = chain_hashes(tokens, 8)
        assert first == chain_hashes(tokens, 8)
        assert len(first) == 3                    # full blocks only
        assert len(chain_hashes(tokens[:23], 8)) == 2
        assert chain_hashes(tokens[:16], 8) == first[:2]
        assert prefix_head(tokens, 8) == first[0]
        assert prefix_head(tokens[:7], 8) is None

    def test_block_size_seeds_distinct_namespaces(self):
        tokens = np.arange(1, 9, dtype=np.int32)
        assert chain_hashes(tokens, 8)[0] != chain_hashes(tokens, 4)[0]
        assert len(set(chain_hashes(tokens, 4))) == 2

    def test_divergence_changes_suffix_digests(self):
        base = np.arange(1, 25, dtype=np.int32)
        fork = base.copy()
        fork[8] += 1                              # mutate block 1
        left, right = chain_hashes(base, 8), chain_hashes(fork, 8)
        assert left[0] == right[0]
        assert left[1] != right[1]
        assert left[2] != right[2]                # chained: all later differ

    @pytest.mark.parametrize("block_size", (1, 4, 16))
    def test_digests_equal_the_jax_packages(self, block_size):
        tokens = np.random.default_rng(block_size).integers(
            0, 2**31 - 1, size=50).astype(np.int32)
        assert chain_hashes(tokens, block_size) == jax_decode.chain_hashes(
            tokens, block_size)
        assert prefix_head(tokens, block_size) == jax_decode.prefix_head(
            tokens, block_size)


# -- policy grammar ----------------------------------------------------------

class TestPrefixPolicy:
    def test_parse_defaults_and_off(self):
        policy = PrefixPolicy.parse(ARMED)
        assert policy.enabled and policy.min_prefix_blocks == 1
        assert not PrefixPolicy.parse("prefix_cache=off").enabled

    def test_scope_validation(self):
        gateway_only = PrefixPolicy.parse(
            "prefix_cache=on;affinity_weight=2")
        gateway_only.validate_gateway()
        with pytest.raises(ValueError, match="affinity_weight"):
            gateway_only.validate_engine()
        engine_only = PrefixPolicy.parse(
            "prefix_cache=on;min_prefix_blocks=2;cache_blocks=8")
        engine_only.validate_engine()
        with pytest.raises(ValueError, match="min_prefix_blocks"):
            engine_only.validate_gateway()

    def test_bad_values_rejected(self):
        with pytest.raises(ValueError):
            PrefixPolicy.parse("prefix_cache=maybe")
        with pytest.raises(ValueError):
            PrefixPolicy.parse("prefix_cache=on;min_prefix_blocks=0")
        with pytest.raises(ValueError):
            PrefixPolicy.parse("prefix_cache=on;warmth=high")

    @pytest.mark.parametrize("spec", [
        ARMED, "prefix_cache=off", "prefix_cache=on;cache_blocks=4",
        "prefix_cache=on;min_prefix_blocks=2;cache_blocks=8",
        {"prefix_cache": "on", "min_prefix_blocks": 3}])
    def test_parses_as_the_jax_package_does(self, spec):
        ours = PrefixPolicy.parse(spec)
        theirs = jax_decode.PrefixPolicy.parse(spec)
        assert repr(ours) == repr(theirs)
        assert ours.present == theirs.present and ours.spec == theirs.spec


# -- BlockManager free-set ---------------------------------------------------

class TestBlockManagerFreeSet:
    def test_free_set_mirrors_list_through_storm(self):
        manager = BlockManager(64, 4)
        rng = np.random.default_rng(11)
        held = []
        for _ in range(200):
            if held and rng.integers(0, 2):
                manager.free(held.pop())
            else:
                granted = manager.allocate(int(rng.integers(1, 6)))
                if granted is not None:
                    held.append(granted)
            assert manager._free_set == set(manager._free)
            assert manager.free_count == len(manager._free)
        for batch in held:
            manager.free(batch)
        assert manager.free_count == manager.capacity

    def test_double_free_still_rejected(self):
        manager = BlockManager(8, 4)
        granted = manager.allocate(2)
        manager.free(granted)
        with pytest.raises(ValueError, match="double free"):
            manager.free([granted[0]])


# -- PrefixCache unit --------------------------------------------------------

class TestPrefixCacheUnit:
    def test_register_acquire_release_refcounts(self):
        manager = BlockManager(10, 4)
        cache = PrefixCache(manager)
        hashes = chain_hashes(np.arange(1, 13, dtype=np.int32), 4)
        blocks = manager.allocate(3)
        assert len(cache.register(hashes, blocks)) == 3
        assert cache.shared_count == 3 and cache.cached_count == 0
        cache.release(blocks)
        assert cache.shared_count == 0 and cache.cached_count == 3
        matched = cache.acquire(hashes[:2])
        assert matched == blocks[:2]              # chain order
        assert cache.shared_count == 2 and cache.cached_count == 1
        assert cache.hits == 1
        cache.release(matched)
        with pytest.raises(ValueError, match="released more times"):
            cache.release([blocks[0]])            # below zero

    def test_resident_blocks_peeks_without_acquiring(self):
        manager = BlockManager(10, 4)
        cache = PrefixCache(manager)
        hashes = chain_hashes(np.arange(1, 9, dtype=np.int32), 4)
        blocks = manager.allocate(2)
        cache.register(hashes, blocks)
        assert cache.resident_blocks(hashes) == blocks
        assert cache.resident_blocks(hashes + ["missing"]) == blocks
        assert cache.shared_count == 2            # unchanged: no acquire
        assert cache.lookup(hashes) == 2

    def test_allocate_evicts_lru_before_failing(self):
        manager = BlockManager(8, 4)              # capacity 7
        cache = PrefixCache(manager)
        hashes = chain_hashes(np.arange(1, 13, dtype=np.int32), 4)
        blocks = manager.allocate(3)
        cache.register(hashes, blocks)
        cache.release(blocks)                     # all 3 now rc0/LRU
        private = cache.allocate(4)               # uses the plain free 4
        assert len(private) == 4
        assert manager.free_count == 0
        granted = cache.allocate(2)               # must reclaim cached
        assert len(granted) == 2
        assert cache.evictions == 2
        assert cache.cached_count == 1
        assert cache.lookup(hashes) == 0          # the chain head went first
        cache.allocate(2)                         # cannot be satisfied
        assert cache.evictions == 3 and cache.cached_count == 0
        manager.free(private + granted)

    def test_cache_blocks_cap_trims_idle_tier(self):
        manager = BlockManager(10, 4)
        cache = PrefixCache(manager, cache_blocks=2)
        hashes = chain_hashes(np.arange(1, 17, dtype=np.int32), 4)
        blocks = manager.allocate(4)
        cache.register(hashes, blocks)
        assert cache.shared_count == 4            # referenced: cap ignores
        cache.release(blocks)
        assert cache.cached_count == 2            # trimmed to the cap
        assert cache.evictions == 2
        assert manager.free_count == manager.capacity - 2

    def test_unregistered_release_goes_back_to_manager(self):
        manager = BlockManager(8, 4)
        cache = PrefixCache(manager)
        cache.release(cache.allocate(3))          # never registered
        assert manager.free_count == manager.capacity
        assert cache.cached_count == 0


# -- engine: warm == cold, bitwise ------------------------------------------

@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunked"])
def test_warm_prefill_bit_identical_f32(tiny_model, chunk):
    """A repeat prompt borrows its cached prompt blocks and prefills only
    the tail; the completion equals the cold run's."""
    params, config = tiny_model
    prompt = np.arange(1, 21, dtype=np.int32)     # 2 full blocks of 8
    expected = reference(params, config, prompt, 6)
    engine = DecodeEngine(params, config, decode_slots=2, kv_block_size=8,
                          prefill_chunk_size=chunk, prefix_policy=ARMED)
    engine.submit(0, prompt, 6)
    np.testing.assert_array_equal(drain(engine)[0].tokens, expected)
    assert engine.counters["prefix_hits"] == 0    # cold: nothing cached
    engine.submit(1, prompt, 6)
    done = drain(engine)
    np.testing.assert_array_equal(done[1].tokens, expected)
    assert engine.counters["prefix_hits"] == 1
    assert engine.counters["prefix_blocks_shared"] == 2
    assert done[1].stats["prefix_blocks"] == 2
    assert engine.prefix.shared_count == 0        # all refs released
    assert (engine.blocks.free_count + engine.prefix.cached_count
            == engine.blocks.capacity)


def test_warm_prefill_bit_identical_int8():
    """Shared int8 KV blocks carry their per-block scales: a warm
    admission equals the cold int8 run too."""
    params, config = _port_model("int8")
    prompt = np.arange(1, 21, dtype=np.int32)
    cold = DecodeEngine(params, config, decode_slots=1, kv_block_size=8)
    cold.submit(0, prompt, 6)
    expected = drain(cold)[0].tokens
    engine = DecodeEngine(params, config, decode_slots=1, kv_block_size=8,
                          prefix_policy=ARMED)
    engine.submit(0, prompt, 6)
    np.testing.assert_array_equal(drain(engine)[0].tokens, expected)
    engine.submit(1, prompt, 6)
    done = drain(engine)
    np.testing.assert_array_equal(done[1].tokens, expected)
    assert engine.counters["prefix_hits"] == 1
    assert done[1].stats["prefix_blocks"] == 2


def test_partial_hit_prefills_only_the_uncached_tail(tiny_model):
    params, config = tiny_model
    base = np.arange(1, 25, dtype=np.int32)       # 3 full blocks of 8
    engine = DecodeEngine(params, config, decode_slots=2, kv_block_size=8,
                          prefix_policy=ARMED)
    engine.submit(0, base, 4)
    drain(engine)
    fork = base.copy()
    fork[8:] = (fork[8:] + 7) % 63 + 1            # diverge from block 1 on
    engine.submit(1, fork, 4)
    done = drain(engine)
    np.testing.assert_array_equal(
        done[1].tokens, reference(params, config, fork, 4))
    assert engine.counters["prefix_hits"] == 1
    assert engine.counters["prefix_partial_hits"] == 1
    assert done[1].stats["prefix_blocks"] == 1    # only the common head


def test_cow_fork_on_divergence_decodes_concurrently(tiny_model):
    """Two live requests share cached prefix blocks and fork into private
    tails: neither corrupts the other."""
    params, config = tiny_model
    base = np.arange(1, 17, dtype=np.int32)
    left = np.concatenate([base, np.arange(20, 26, dtype=np.int32)])
    right = np.concatenate([base, np.arange(40, 48, dtype=np.int32)])
    engine = DecodeEngine(params, config, decode_slots=2, kv_block_size=8,
                          prefix_policy=ARMED)
    engine.submit(0, base, 2)                     # seed the cache
    drain(engine)
    engine.submit(1, left, 6)
    engine.submit(2, right, 6)
    done = drain(engine)
    np.testing.assert_array_equal(
        done[1].tokens, reference(params, config, left, 6))
    np.testing.assert_array_equal(
        done[2].tokens, reference(params, config, right, 6))
    assert engine.counters["prefix_hits"] >= 2
    assert engine.prefix.shared_count == 0


def test_min_prefix_blocks_skips_tiny_matches(tiny_model):
    params, config = tiny_model
    prompt = np.arange(1, 13, dtype=np.int32)     # 1 usable block only
    engine = DecodeEngine(
        params, config, decode_slots=1, kv_block_size=8,
        prefix_policy="prefix_cache=on;min_prefix_blocks=2")
    engine.submit(0, prompt, 4)
    drain(engine)
    engine.submit(1, prompt, 4)
    done = drain(engine)
    np.testing.assert_array_equal(
        done[1].tokens, reference(params, config, prompt, 4))
    assert engine.counters["prefix_hits"] == 0    # below the floor
    assert engine.prefix.shared_count == 0


# -- eviction / accounting under pressure ------------------------------------

def test_accounting_reconciles_through_storm(tiny_model):
    """Seeded admission waves over shared prefixes with an oversubscribed
    pool: after every wave the pool partitions exactly into free + cached,
    and dropping the idle tier returns it to its cold state."""
    params, config = tiny_model
    rng = np.random.default_rng(3)
    bases = [rng.integers(1, 64, size=16).astype(np.int32)
             for _ in range(3)]
    engine = DecodeEngine(params, config, decode_slots=3, kv_block_size=8,
                          kv_blocks=12, prefix_policy=ARMED)
    capacity = engine.blocks.capacity
    request = 0
    for _ in range(4):
        for base in bases:
            tail = rng.integers(
                1, 64, size=int(rng.integers(0, 9))).astype(np.int32)
            engine.submit(request, np.concatenate([base, tail]), 4)
            request += 1
        assert len(drain(engine)) == 3
        assert engine.prefix.shared_count == 0
        assert (engine.blocks.free_count + engine.prefix.cached_count
                == capacity)
    assert engine.counters["prefix_hits"] > 0
    assert engine.counters["prefix_evictions"] == engine.prefix.evictions
    engine.prefix.drop()
    assert engine.prefix.cached_count == 0
    assert engine.blocks.free_count == capacity


def test_preempting_shared_holder_never_frees_siblings_blocks(tiny_model):
    params, config = tiny_model
    engine = DecodeEngine(params, config, decode_slots=2, kv_block_size=4,
                          kv_blocks=8, prefix_policy=ARMED)
    prompt = np.arange(1, 9, dtype=np.int32)      # 2 full blocks of 4
    expected = reference(params, config, prompt, 12)
    engine.submit(0, prompt, 12)
    engine.step()                                 # prefill registers blocks
    assert engine.prefix.shared_count == 2
    engine.submit(1, prompt, 12)
    done = drain(engine)
    assert engine.counters["preempted"] >= 1
    assert engine.counters["prefix_hits"] >= 1
    np.testing.assert_array_equal(done[0].tokens, expected)
    np.testing.assert_array_equal(done[1].tokens, expected)
    assert engine.prefix.shared_count == 0
    assert (engine.blocks.free_count + engine.prefix.cached_count
            == engine.blocks.capacity)


def test_feature_off_is_the_cold_path(tiny_model):
    params, config = tiny_model
    for spec in (None, "prefix_cache=off"):
        engine = DecodeEngine(params, config, decode_slots=2,
                              kv_block_size=8, prefix_policy=spec)
        assert engine.prefix is None
        prompt = np.arange(1, 21, dtype=np.int32)
        engine.submit(0, prompt, 4)
        engine.submit(1, prompt, 4)
        done = drain(engine)
        assert engine.counters["prefix_hits"] == 0
        assert "prefix_blocks" not in done[1].stats
        assert engine.blocks.free_count == engine.blocks.capacity
