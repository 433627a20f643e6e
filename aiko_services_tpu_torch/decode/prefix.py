# Cross-request prefix KV reuse: radix-style hash-chained block cache.
#
# The port's own copy of aiko_services_tpu/decode/prefix.py (host only,
# jax-free there too).  The chain digests must stay the JAX package's:
# the gateway routes on them across replicas of either package.
#
# Million-user chat traffic is dominated by shared prefixes (system
# prompts, few-shot templates, multi-turn history).  The paged pool
# already makes block ORDER irrelevant -- the block-table indirection
# (paged_decode_step's gather) means any request can point at any
# block -- so the only missing piece is an index from token content to
# block id.  This module provides it, SGLang-RadixAttention style but
# flattened to a hash CHAIN instead of a tree:
#
#   digest[0] = H(block_size | tokens[0:B])
#   digest[i] = H(digest[i-1] | tokens[i*B:(i+1)*B])
#
# A chain digest therefore commits to the ENTIRE prefix up to and
# including its block, so a single dict lookup per block walks the
# radix path: the longest cached prefix of a new prompt is the longest
# run of consecutive digest hits.  Hashing is process-stable blake2b
# (like federation.py's rendezvous md5 -- NEVER Python's salted
# hash()), so digests can cross process boundaries as gateway affinity
# hints and keeper snapshot keys.
#
# Sharing is copy-on-write by construction: cached blocks are only
# ever FULL blocks (every position written), a borrowing request's
# block table points at them read-only, and its own writes land in the
# freshly-allocated tail blocks.  Refcounts make eviction safe:
#
#   refcount > 0   block is referenced by a live slot: unevictable
#   refcount == 0  block sits in an LRU second-chance tier -- still
#                  indexed, reclaimed ONLY when the pool runs dry,
#                  BEFORE admission defers or the preemption ladder
#                  fires (a cache must never cause a preemption)

from __future__ import annotations

import hashlib
from collections import OrderedDict

from ..analyze.grammar import DirectiveGrammar, Field, GrammarError
from .blocks import BlockManager

__all__ = ["PREFIX_GRAMMAR", "PrefixCache", "PrefixPolicy",
           "chain_hashes", "prefix_head"]

# gateway EC shares mirror at most this many chain-head digests: the
# affinity summary is a compact routing hint, not the cache index
PREFIX_HEADS_CAP = 32

PREFIX_GRAMMAR = DirectiveGrammar(
    "prefix-cache policy",
    options={
        "prefix_cache": Field("str", choices=("on", "off")),
        "min_prefix_blocks": Field("int", minimum=1),
        "cache_blocks": Field("int", minimum=1),
        "affinity_weight": Field("float", minimum=0.0),
    })


class PrefixPolicy:
    """Parsed prefix-cache spec (rule code AIKO411).  Two scopes share
    one grammar, mirroring the checkpoint policy's split:

      engine (LMGenerate `prefix_policy` parameter):
        min_prefix_blocks=  smallest cached run worth borrowing (tiny
                            hits pay table-rewrite cost for nothing)
        cache_blocks=       cap on the refcount-0 cached tier (0 /
                            absent = bounded only by the pool)

      gateway (`prefix_policy` parameter):
        affinity_weight=    load-score discount for a replica already
                            holding the stream's prefix

    `prefix_cache=on|off` is legal on both: one switch arms/disarms
    the whole vertical (off = behavior identical to pre-prefix
    deployments, the A/B control arm)."""

    __slots__ = ("enabled", "min_prefix_blocks", "cache_blocks",
                 "affinity_weight", "present", "spec")

    def __init__(self):
        self.enabled = True
        self.min_prefix_blocks = 1
        self.cache_blocks = 0             # 0 = pool-bounded tier
        self.affinity_weight = 1.0
        self.present: set = set()
        self.spec = ""

    @classmethod
    def parse(cls, spec) -> "PrefixPolicy":
        """Parse a spec (directive string, dict of the same keys, or
        None/"" for all defaults)."""
        policy = cls()
        if spec is None or spec == "" or spec is True:
            return policy
        if isinstance(spec, PrefixPolicy):
            return spec
        parsed = PREFIX_GRAMMAR.parse(spec)
        if not isinstance(spec, dict):
            policy.spec = str(spec)
        for key, value in parsed.options.items():
            if key == "prefix_cache":
                policy.enabled = value == "on"
            else:
                setattr(policy, key, value)
            policy.present.add(key)
        return policy

    def validate_gateway(self) -> None:
        """A gateway spec weights routing; the cache-shape knobs
        belong to the replica that owns the pool."""
        engine_side = self.present & {"min_prefix_blocks",
                                      "cache_blocks"}
        if engine_side:
            raise GrammarError(
                f"prefix-cache policy: {sorted(engine_side)} are "
                f"engine-side directives; a gateway spec carries "
                f"prefix_cache/affinity_weight only")

    def validate_engine(self) -> None:
        if "affinity_weight" in self.present:
            raise GrammarError(
                "prefix-cache policy: affinity_weight is a "
                "gateway-side directive (routing score); an engine "
                "spec carries prefix_cache/min_prefix_blocks/"
                "cache_blocks")

    def __repr__(self):
        return (f"PrefixPolicy(enabled={self.enabled}, "
                f"min_prefix_blocks={self.min_prefix_blocks}, "
                f"cache_blocks={self.cache_blocks}, "
                f"affinity_weight={self.affinity_weight})")


def chain_hashes(tokens, block_size: int) -> list:
    """Hex chain digests for every FULL block of `tokens`, in chain
    order.  Deterministic across processes and runs: blake2b over the
    parent digest plus the block's int32 token bytes, seeded with the
    block size (a 16-token block must never collide with two 8-token
    blocks holding the same ids)."""
    import numpy as np

    tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
    block_size = int(block_size)
    digests = []
    parent = b"aiko-prefix:%d" % block_size
    for start in range(0, tokens.size - block_size + 1, block_size):
        digest = hashlib.blake2b(
            parent + tokens[start:start + block_size].tobytes(),
            digest_size=16)
        parent = digest.digest()
        digests.append(digest.hexdigest())
    return digests


def prefix_head(tokens, block_size: int) -> str | None:
    """The CHAIN HEAD digest (first full block) of a prompt, or None
    when the prompt cannot fill one block.  This is the compact
    affinity hint clients / gateways exchange: two prompts sharing a
    system preamble of >= block_size tokens share a head."""
    import numpy as np

    first = np.asarray(tokens, dtype=np.int32).reshape(-1)[:block_size]
    hashes = chain_hashes(first, block_size)
    return hashes[0] if hashes else None


class PrefixCache:
    """Refcounted content index over a BlockManager's pool.

    The manager keeps owning allocation; this class tracks which
    allocated blocks are REGISTERED (content-addressed by chain
    digest) and how many live slots reference each.  All bookkeeping
    is O(1) per block on the event loop.

    Invariant (tested): `manager.free_count + cached + active`
    reconciles to `manager.capacity`, where cached = refcount-0
    registered blocks and active = every block a slot references
    (shared or private)."""

    def __init__(self, manager: BlockManager, cache_blocks: int = 0):
        self.manager = manager
        self.cache_blocks = int(cache_blocks)
        self._entries: dict = {}          # digest -> block id
        self._digest_of: dict = {}        # block id -> digest
        self._refs: dict = {}             # block id -> live references
        self._depth: dict = {}            # block id -> chain index
        self._lru: OrderedDict = OrderedDict()  # refcount-0 blocks
        self.hits = 0                     # acquisitions with >= 1 block
        self.partial_hits = 0             # hit shorter than the chain
        self.blocks_shared = 0            # total blocks borrowed
        self.evictions = 0                # cached blocks reclaimed

    # -- inventory -----------------------------------------------------

    @property
    def cached_count(self) -> int:
        """Refcount-0 registered blocks (the reclaimable tier)."""
        return len(self._lru)

    @property
    def shared_count(self) -> int:
        """Registered blocks currently referenced by >= 1 slot."""
        return len(self._refs) - len(self._lru)

    def heads(self, cap: int = PREFIX_HEADS_CAP) -> list:
        """Chain-HEAD digests (depth 0) currently resident, newest
        registrations last, capped -- the gateway affinity summary."""
        found = [self._digest_of[block] for block, depth
                 in self._depth.items() if depth == 0]
        return found[-cap:]

    def lookup(self, hashes) -> int:
        """Longest resident prefix of a digest chain, in blocks --
        WITHOUT acquiring (the gateway-side / probe view)."""
        return len(self.resident_blocks(hashes))

    def resident_blocks(self, hashes) -> list:
        """Block ids of the longest resident prefix of a digest chain,
        in chain order, WITHOUT acquiring.  The snapshot-export path:
        the caller must copy the KV out (offer_pool_blocks gathers at
        call time) before yielding back to the event loop, since an
        unreferenced block can be evicted by any later allocation."""
        blocks = []
        for digest in hashes:
            block = self._entries.get(digest)
            if block is None:
                break
            blocks.append(block)
        return blocks

    # -- borrow / return -----------------------------------------------

    def acquire(self, hashes) -> list:
        """Borrow the longest resident prefix of `hashes`: increments
        each matched block's refcount (pulling refcount-0 blocks out
        of the LRU tier) and returns the block ids in chain order.
        The caller owns releasing exactly these blocks."""
        taken = []
        for digest in hashes:
            block = self._entries.get(digest)
            if block is None:
                break
            if self._refs[block] == 0:
                self._lru.pop(block, None)
            self._refs[block] += 1
            taken.append(block)
        if taken:
            self.hits += 1
            self.blocks_shared += len(taken)
            if len(taken) < len(hashes):
                self.partial_hits += 1
        return taken

    def release(self, blocks) -> None:
        """Return a slot's blocks: registered blocks decref (hitting
        zero parks them at the LRU tail -- still indexed, reclaimable);
        unregistered (private tail) blocks go straight back to the
        manager's free list."""
        private = []
        for block in blocks:
            block = int(block)
            if block in self._refs:
                self._refs[block] -= 1
                if self._refs[block] < 0:
                    raise ValueError(
                        f"prefix block {block} released more times "
                        f"than acquired")
                if self._refs[block] == 0:
                    self._lru[block] = True
                    self._lru.move_to_end(block)
            else:
                private.append(block)
        if private:
            self.manager.free(private)
        self._trim()

    # -- registration ---------------------------------------------------

    def register(self, hashes, blocks, depth: int = 0,
                 refcount: int = 1) -> list:
        """Index freshly-written FULL blocks under their chain digests
        with the given starting refcount (1 = the writing slot still
        references them; 0 = parked straight into the cached tier, the
        keeper-import path).  `depth` is the chain index of the FIRST
        digest (a slot that borrowed `n` cached blocks registers its
        own blocks from depth n).  A digest that is ALREADY indexed
        keeps its existing block -- the duplicate block stays private
        to the caller (refcount 1) or is freed (refcount 0), never
        aliased.  Returns the blocks actually indexed."""
        indexed = []
        freed = []
        for offset, (digest, block) in enumerate(zip(hashes, blocks)):
            block = int(block)
            if digest in self._entries or block in self._refs:
                # lost the registration race (or re-registering after
                # preemption): keep the first writer's copy
                if refcount == 0 and block not in self._refs:
                    freed.append(block)
                continue
            self._entries[digest] = block
            self._digest_of[block] = digest
            self._refs[block] = refcount
            self._depth[block] = depth + offset
            if refcount == 0:
                self._lru[block] = True
                self._lru.move_to_end(block)
            indexed.append(block)
        if freed:
            self.manager.free(freed)
        self._trim()
        return indexed

    # -- allocation with second-chance reclaim --------------------------

    def allocate(self, count: int) -> list | None:
        """All-or-nothing allocation that reclaims the LRU cached tier
        before giving up: cache pressure must never cause a deferral
        or preemption the cold system would not have had."""
        granted = self.manager.allocate(count)
        while granted is None and self._lru:
            self._evict_one()
            granted = self.manager.allocate(count)
        return granted

    def _evict_one(self) -> None:
        block, _ = self._lru.popitem(last=False)   # LRU head
        self._forget(block)
        self.manager.free([block])
        self.evictions += 1

    def _forget(self, block: int) -> None:
        digest = self._digest_of.pop(block)
        del self._entries[digest]
        del self._refs[block]
        del self._depth[block]

    def _trim(self) -> None:
        """Enforce the policy's cached-tier cap (cache_blocks > 0)."""
        if self.cache_blocks > 0:
            while len(self._lru) > self.cache_blocks:
                self._evict_one()

    def drop(self) -> int:
        """Reclaim the whole refcount-0 tier (tests / drain); returns
        the number of blocks returned to the manager."""
        dropped = 0
        while self._lru:
            self._evict_one()
            dropped += 1
        return dropped
