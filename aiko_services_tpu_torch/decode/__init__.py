# Continuous batching with paged KV: the slot-based decode engine under
# LMGenerate's `continuous: true` mode.  Counterpart of
# aiko_services_tpu/decode/, as far as it is ported:
#
#   blocks.py   BlockManager -- fixed-size KV block pool bookkeeping
#   engine.py   DecodeEngine -- slot scheduler: mid-decode admission /
#               eviction / preemption with a fixed step shape (one
#               captured CUDA graph per step signature on the card),
#               chunked prefill (prefill_chunk_size) interleaved with
#               decode, and greedy-exact speculative decoding (draft
#               model + spec_k verify windows)
#   prefix.py   cross-request prefix KV reuse -- PrefixCache indexes
#               fully-written prompt blocks by token hash chain so later
#               admissions borrow the shared prefix (refcounted, LRU
#               second-chance eviction); AIKO411 policy grammar
#
# The device steps live in models/transformer.py (init_paged_pool,
# paged_prefill, paged_prefill_chunk, paged_decode_step,
# paged_verify_step) next to the closed-batch generate() they must agree
# with.  Not ported yet (ROADMAP Queue A item 2): disagg.py (the
# PrefillEngine and the KV handoff over the transfer plane) and
# checkpoint.py (warm KV failover).

from .blocks import BlockManager, TRASH_BLOCK      # noqa: F401
from .engine import Completion, DecodeEngine, StepReport  # noqa: F401
from .prefix import (                              # noqa: F401
    PREFIX_GRAMMAR, PrefixCache, PrefixPolicy, chain_hashes,
    prefix_head)

__all__ = ["BlockManager", "TRASH_BLOCK", "Completion", "DecodeEngine",
           "PREFIX_GRAMMAR", "PrefixCache", "PrefixPolicy", "StepReport",
           "chain_hashes", "prefix_head"]
