# Paged-KV block manager: host-side bookkeeping for the preallocated
# block pool (models/transformer.py init_paged_pool).
#
# The port's own copy of aiko_services_tpu/decode/blocks.py (jax-free
# there too): the same class, line for line.
#
# The pool's device arrays never change shape; this class only decides
# WHICH fixed-size block each slot's next token lands in.  Allocation
# and free are O(1) list operations on the event loop -- the device
# never sees fragmentation because the block table indirection
# (paged_decode_step's gather) makes any block order equivalent.
#
# Block 0 is reserved as the TRASH block: inactive decode slots write
# their masked garbage there, which is what keeps the engine step
# shape-stable (zero recompiles) across admissions and evictions.

from __future__ import annotations

__all__ = ["BlockManager", "TRASH_BLOCK"]

TRASH_BLOCK = 0


class BlockManager:
    """Fixed pool of `num_blocks` KV blocks of `block_size` positions.

    `num_blocks` INCLUDES the reserved trash block, so the allocatable
    capacity is num_blocks - 1.  Allocation is all-or-nothing: a
    request that cannot get every block it asked for gets none (the
    scheduler defers or preempts instead of holding partial grants
    that could deadlock two half-admitted requests)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved "
                f"trash block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO free list: recently-freed blocks are re-used first (their
        # pool pages are the warmest).  The parallel set exists only for
        # O(1) double-free detection -- under prefix-cache churn a
        # release wave frees hundreds of blocks, and the old
        # `block in self._free` linear scan made each wave O(n^2)
        self._free = list(range(self.num_blocks - 1, TRASH_BLOCK, -1))
        self._free_set = set(self._free)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    def blocks_for(self, positions: int) -> int:
        """Blocks needed to hold `positions` token positions."""
        return -(-int(positions) // self.block_size)

    def allocate(self, count: int) -> list | None:
        """`count` blocks, all-or-nothing; None when the pool cannot
        satisfy the request (caller defers admission or preempts)."""
        count = int(count)
        if count < 0:
            raise ValueError(f"cannot allocate {count} blocks")
        if count > len(self._free):
            return None
        taken = self._free[-count:] if count else []
        del self._free[len(self._free) - count:]
        self._free_set.difference_update(taken)
        return taken

    def free(self, blocks) -> None:
        for block in blocks:
            block = int(block)
            if block == TRASH_BLOCK:
                raise ValueError("the trash block is never allocated")
            if block in self._free_set \
                    or not (0 < block < self.num_blocks):
                raise ValueError(f"double free / bad block {block}")
            self._free.append(block)
            self._free_set.add(block)
