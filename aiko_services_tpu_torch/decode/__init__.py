# Continuous batching with paged KV: the slot-based decode engine under
# LMGenerate's `continuous: true` mode and the serving gateway.
# Counterpart of aiko_services_tpu/decode/:
#
#   blocks.py   BlockManager -- fixed-size KV block pool bookkeeping
#   engine.py   DecodeEngine -- slot scheduler: mid-decode admission /
#               eviction / preemption with a fixed step shape (one
#               captured CUDA graph per step signature on the card),
#               chunked prefill (prefill_chunk_size) interleaved with
#               decode, greedy-exact speculative decoding (draft model +
#               spec_k verify windows), and KV migration into the pool
#               (adopt_request, restore_request, adopt_prefix)
#   disagg.py   PrefillEngine -- the prefill half of a disaggregated
#               fleet: prompt prefills into a private paged pool, KV
#               blocks exported as transfer-plane descriptors that
#               DecodeEngine.adopt_request fetches into a free slot (no
#               re-prefill)
#   checkpoint.py  warm KV failover -- DecodeCheckpointer ships
#               incremental decode-state snapshots to a CheckpointKeeper
#               so a crashed replica's streams restore on a survivor
#               (DecodeEngine.restore_request) instead of re-prefilling;
#               AIKO409 policy grammar
#   prefix.py   cross-request prefix KV reuse -- PrefixCache indexes
#               fully-written prompt blocks by token hash chain so later
#               admissions borrow the shared prefix (refcounted, LRU
#               second-chance eviction); AIKO411 policy grammar
#
# The device steps live in models/transformer.py (init_paged_pool,
# paged_prefill, paged_prefill_chunk, paged_decode_step,
# paged_verify_step) next to the closed-batch generate() they must agree
# with.

from .blocks import BlockManager, TRASH_BLOCK      # noqa: F401
from .engine import Completion, DecodeEngine, StepReport  # noqa: F401
from .disagg import (                              # noqa: F401
    HANDOFF_SCHEMA, PrefillEngine, fetch_kv_blocks,
    offer_pool_blocks)
from .checkpoint import (                          # noqa: F401
    CHECKPOINT_SCHEMA, CheckpointKeeper, CheckpointPolicy,
    DecodeCheckpointer, get_keeper, register_keeper, reset_keepers)
from .prefix import (                              # noqa: F401
    PREFIX_GRAMMAR, PrefixCache, PrefixPolicy, chain_hashes,
    prefix_head)

__all__ = ["BlockManager", "TRASH_BLOCK", "CHECKPOINT_SCHEMA",
           "CheckpointKeeper", "CheckpointPolicy", "Completion",
           "DecodeCheckpointer", "DecodeEngine", "HANDOFF_SCHEMA",
           "PREFIX_GRAMMAR", "PrefillEngine", "PrefixCache",
           "PrefixPolicy", "StepReport", "chain_hashes",
           "fetch_kv_blocks", "get_keeper", "offer_pool_blocks",
           "prefix_head", "register_keeper", "reset_keepers"]
