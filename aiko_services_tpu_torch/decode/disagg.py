# Prefill/decode disaggregation: the prefill half of the split fleet.
#
# Counterpart of aiko_services_tpu/decode/disagg.py.  Production serving
# splits prefill and decode into separate replica pools (DistServe
# OSDI'24, Splitwise ISCA'24) because a long prompt's compute-bound
# prefill convoys every co-scheduled decode slot.  Chunked prefill bounds
# the stall but still spends decode-replica cycles on prompt compute;
# disaggregation moves the prompt compute onto a PREFILL pool entirely
# and streams the finished prompt's paged KV blocks to a decode replica
# over the transfer plane (pipeline/transfer.py).
#
#   PrefillEngine     runs paged_prefill / paged_prefill_chunk (eager)
#                     into its own paged pool, one request at a time, on
#                     its own CUDA stream, and EXPORTS the finished
#                     prompt's KV blocks as raw transfer descriptors --
#                     one per (block, pool leaf), so int8 KV (codes +
#                     scales) carries through unchanged
#   offer_pool_blocks the producer half shared with the checkpointer:
#                     one block-major index_select per pool leaf on the
#                     device, one copy into pinned host memory per leaf,
#                     ONE wait for the copies, then per-block host views
#                     (contiguous, never copied again) offered together
#   fetch_kv_blocks   the decode-side half: pulls a handoff's whole
#                     descriptor tree through fetch_many (ONE connection
#                     per producing peer) and restacks it into per-leaf
#                     host tensors shaped for the pool scatter (pinned
#                     when the pool is on the card; bf16 restacked from
#                     its raw bits, never through a float type)
#
# The wire layout per block is the JAX package's: (n_layers, kv_heads,
# block, head_dim) per leaf, with (..., 1) k_scale / v_scale leaves
# under int8 KV, so the two packages' replicas can hand KV to each
# other.  DecodeEngine.adopt_request (engine.py) consumes the handoff
# and writes the blocks into its pool IN PLACE: the decode step's
# captured CUDA graphs read the pool tensors they were captured with.

from __future__ import annotations

import time

from collections import deque

import numpy as np
import torch

from ..models import (
    f32_head, init_paged_pool, paged_prefill, paged_prefill_chunk)
from ..ops.device import resolve_device
from ..pipeline.transfer import fetch_many, get_transfer_server, host_bits
from ..utils import get_logger
from ..utils.padding import bucket_length
from .blocks import TRASH_BLOCK, BlockManager
from .engine import on_stream, work_stream

__all__ = ["HANDOFF_SCHEMA", "PrefillEngine", "fetch_kv_blocks",
           "gather_pool_blocks", "offer_pool_blocks"]

_LOGGER = get_logger("prefill_engine")

HANDOFF_SCHEMA = "aiko.kv_handoff/1"


def gather_pool_blocks(pool: dict, block_ids) -> dict:
    """{leaf_name: host tensor (len(block_ids), n_layers, ...)}: one
    index_select per pool leaf on the pool's device, laid out block-major
    so that every block is one contiguous host slice, one copy into pinned
    host memory, then ONE wait covering every leaf's copy.  Runs on the
    caller's current stream, so the gather is ordered after every write
    the caller issued there.  The pinned buffers are fresh per call: the
    transfer server keeps views of them (no further host copy) until a
    descriptor's linger expires, so the pinned memory in use is bounded
    by the offer rate times the linger."""
    names = sorted(pool)
    if not names:
        return {}
    device = pool[names[0]].device
    index = torch.as_tensor(np.asarray(block_ids, np.int64),
                            device=device)
    gathered = {name: pool[name].index_select(1, index)
                .transpose(0, 1).contiguous() for name in names}
    if device.type != "cuda":
        return gathered
    host = {}
    for name, blocks in gathered.items():
        host[name] = torch.empty(blocks.shape, dtype=blocks.dtype,
                                 pin_memory=True)
        host[name].copy_(blocks, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host


def offer_blocks(host: dict) -> tuple:
    """Offer every block of a gather_pool_blocks result on this
    process's transfer server as RAW descriptors (never
    `{__tensorref__: ...}` marker nodes -- see fetch_kv_blocks); returns
    (kv_blocks, bytes) where kv_blocks is one {leaf_name: descriptor}
    dict per block, each descriptor a contiguous (n_layers, ...) slice
    -- the JAX package's wire layout per block.  Each leaf's host tensor
    is viewed as numpy once (no copy) and its slices are offered in one
    offer_many."""
    server = get_transfer_server()
    names = sorted(host)
    count = host[names[0]].shape[0] if names else 0
    descriptors = {}
    total_bytes = 0
    for name in names:
        array, dtype_name = host_bits(host[name])
        views = [array[index] for index in range(count)]
        total_bytes += sum(view.nbytes for view in views)
        descriptors[name] = server.offer_many(views, dtype_name)
    kv_blocks = [{name: descriptors[name][index] for name in names}
                 for index in range(count)]
    return kv_blocks, total_bytes


def offer_pool_blocks(pool: dict, block_ids) -> tuple:
    """Offer `block_ids`' slices of every pool leaf on the transfer
    server: (kv_blocks, bytes), one {leaf_name: descriptor} dict per
    block.  Shared by PrefillEngine's handoff export and the prefix
    snapshot export; the checkpointer gathers and offers all its due
    slots' blocks at once through the same two calls."""
    return offer_blocks(gather_pool_blocks(pool, block_ids))


def fetch_kv_blocks(handoff: dict, timeout: float | None = None,
                    pin: bool = False) -> dict:
    """Fetch a handoff's KV blocks in ONE batched round trip per peer
    and restack them for the pool scatter: returns {leaf_name: host
    tensor of shape (n_layers, n_blocks, ...)} matching init_paged_pool's
    leaf layout, in pinned memory when `pin` (the adopting pool is on
    the card).  bf16 leaves arrive as bf16 tensors restacked from their
    raw bits.  Raises KeyError/TransferError exactly like fetch_many --
    the adopting engine turns either into a local re-prefill.

    The handoff carries RAW transfer descriptors (the {host, port, key,
    dtype, shape} dicts fetch() consumes), deliberately NOT
    `{__tensorref__: ...}` marker nodes: the frame codec eagerly
    materializes marker nodes one fetch at a time on the consumer's
    event loop, which would both serialize the migration and strip the
    descriptors before adopt_request ever saw them."""
    blocks = handoff["kv_blocks"]
    if not blocks:
        raise ValueError("handoff carries no KV blocks")
    names = sorted(blocks[0])
    descriptors = [block[name] for block in blocks for name in names]
    arrays = fetch_many(descriptors, timeout=timeout)
    leaves = {}
    for offset, name in enumerate(names):
        per_block = arrays[offset::len(names)]
        first = per_block[0]
        dtype = (first.dtype if isinstance(first, torch.Tensor)
                 else torch.from_numpy(np.empty(0, first.dtype)).dtype)
        # (n_blocks) x (n_layers, heads, block, depth) -> pool layout
        # (n_layers, n_blocks, heads, block, depth)
        stacked = torch.empty(
            (first.shape[0], len(per_block)) + tuple(first.shape[1:]),
            dtype=dtype, pin_memory=pin)
        for index, block in enumerate(per_block):
            if isinstance(block, torch.Tensor):
                stacked[:, index] = block       # bf16, from its bits
            else:
                stacked.numpy()[:, index] = block
        leaves[name] = stacked
    return leaves


class _PrefillJob:
    __slots__ = ("request_id", "prompt", "max_new", "true_len",
                 "bucket", "padded", "blocks", "prefill_pos",
                 "submitted_at", "started_at")

    def __init__(self, request_id, prompt, max_new):
        self.request_id = request_id
        self.prompt = prompt
        self.max_new = int(max_new)
        self.true_len = int(prompt.size)
        self.bucket = 0
        self.padded = None
        self.blocks: list = []
        self.prefill_pos = 0
        self.submitted_at = time.perf_counter()
        self.started_at: float | None = None


class PrefillEngine:
    """Single-flight prompt prefill over a private paged pool.

    Shapes fixed at construction like DecodeEngine's (one block table
    row wide enough for max_context).  step() advances the active job by
    one chunk (or the whole prompt when chunking is off) and returns the
    list of handoff records that finished this tick -- each with the
    prompt's KV blocks ALREADY offered on the transfer plane and the
    job's blocks returned to the free list (the transfer server holds
    host copies for the offer ttl; a handoff nobody adopts costs linger
    memory, never pool capacity).

    The params must lie on `device` (CUDA unless the caller asks for the
    CPU).  On the card every prefill and the export's gather run on the
    engine's own stream, so a prefill thread and a decode engine's
    captured graphs never serialize through one stream, and the gather
    is ordered after the prefill that wrote the blocks by stream order
    alone."""

    def __init__(self, params, config, *, kv_block_size: int = 16,
                 kv_blocks: int | None = None,
                 max_context: int | None = None,
                 prefill_chunk_size: int | None = None, registry=None,
                 device="cuda"):
        requested = resolve_device(device)
        self.device = params["embed"]["w"].device
        if self.device.type != requested.type or (
                requested.index is not None
                and self.device != requested):
            raise ValueError(f"PrefillEngine on {requested}: the params "
                             f"lie on {self.device}")
        self.stream = work_stream(self.device)
        self.config = config
        max_context = int(max_context or config.max_seq_len)
        self.max_blocks = -(-max_context // int(kv_block_size))
        self.max_context = self.max_blocks * int(kv_block_size)
        if kv_blocks is None:
            kv_blocks = self.max_blocks + 1
        self.blocks = BlockManager(int(kv_blocks), int(kv_block_size))
        with on_stream(self.stream):
            # the same f32 LM head the decode engine keeps, so the first
            # token equals a co-located prefill's
            self.params = f32_head(params)
            self.pool = init_paged_pool(config, self.blocks.num_blocks,
                                        self.blocks.block_size,
                                        device=self.device)
        self.table = np.full((self.max_blocks,), TRASH_BLOCK, np.int32)
        self.waiting: deque[_PrefillJob] = deque()
        self._active: _PrefillJob | None = None
        self._registry = registry
        self._signatures = set()
        if prefill_chunk_size is not None:
            chunk = bucket_length(int(prefill_chunk_size),
                                  minimum=self.blocks.block_size)
            self.prefill_chunk = int(min(chunk, self.max_context))
        else:
            self.prefill_chunk = None
        self.counters = {"submitted": 0, "exported": 0, "chunks": 0,
                         "compiles": 0, "exported_bytes": 0}

    @property
    def compile_count(self) -> int:
        """Distinct prefill signatures run (bucket or chunk size): the
        counterpart of the jit cache entries its JAX twin compiles."""
        return self.counters["compiles"]

    def _note_signature(self, key: tuple) -> None:
        if key not in self._signatures:
            self._signatures.add(key)
            self.counters["compiles"] += 1
            self._bump("prefill.compiles", 1)

    def _bump(self, name: str, amount) -> None:
        if self._registry is not None:
            self._registry.counter(name).inc(amount)

    def _tensor(self, array) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    # -- submission --------------------------------------------------------

    def _bucket(self, true_len: int) -> int:
        block = self.blocks.block_size
        padded = bucket_length(true_len, minimum=block)
        return min(-(-padded // block) * block, self.max_context)

    def submit(self, request_id, prompt_tokens, max_new_tokens: int):
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError(f"{request_id}: empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError(
                f"{request_id}: max_new_tokens must be >= 1")
        if prompt.size + int(max_new_tokens) > self.max_context:
            raise ValueError(
                f"{request_id}: prompt {prompt.size} + max_new "
                f"{int(max_new_tokens)} exceeds max_context "
                f"{self.max_context} (the ADOPTING pool's contract)")
        self.waiting.append(
            _PrefillJob(request_id, prompt, max_new_tokens))
        self.counters["submitted"] += 1

    def cancel(self, predicate) -> int:
        """Drop every job whose request_id satisfies `predicate`; a
        cancelled ACTIVE job's blocks return to the free list.
        Returns the number cancelled."""
        cancelled = 0
        kept = deque()
        for job in self.waiting:
            if predicate(job.request_id):
                cancelled += 1
            else:
                kept.append(job)
        self.waiting = kept
        if (self._active is not None
                and predicate(self._active.request_id)):
            self.blocks.free(self._active.blocks)
            self._active = None
            cancelled += 1
        return cancelled

    def has_work(self) -> bool:
        return self._active is not None or bool(self.waiting)

    @property
    def queue_depth(self) -> int:
        """Jobs not yet finished -- the signal the prefill pool's
        autoscaler watches (queue wait, not slot occupancy)."""
        return len(self.waiting) + (1 if self._active else 0)

    # -- the engine step ---------------------------------------------------

    def step(self) -> list:
        """Advance the active prefill by one chunk (or run it whole);
        returns the handoff records that finished this tick."""
        with on_stream(self.stream):
            return self._step()

    def _step(self) -> list:
        if self._active is None:
            if not self.waiting:
                return []
            job = self.waiting.popleft()
            job.started_at = time.perf_counter()
            job.bucket = self._bucket(job.true_len)
            granted = self.blocks.allocate(
                self.blocks.blocks_for(job.bucket))
            # the pool is sized for max_context and jobs run one at a
            # time, so a grant can never fail here
            job.blocks = granted
            job.padded = np.zeros((job.bucket,), np.int32)
            job.padded[:job.true_len] = job.prompt
            self.table[:] = TRASH_BLOCK
            self.table[:len(granted)] = granted
            self._active = job
        job = self._active
        if (self.prefill_chunk is None
                or self.prefill_chunk >= job.bucket):
            self._note_signature(("prefill", job.bucket))
            _, first = paged_prefill(
                self.params, self.config, self.pool,
                self._tensor(job.padded[None]), self._tensor(self.table),
                job.true_len)
            job.prefill_pos = job.bucket
            return [self._finish(job, int(first))]
        return self._step_chunk(job)

    def _step_chunk(self, job: _PrefillJob) -> list:
        block_size = self.blocks.block_size
        start = job.prefill_pos
        remaining = job.true_len - start
        size = min(self.prefill_chunk,
                   bucket_length(remaining, minimum=block_size))
        take = min(size, remaining)
        chunk = np.zeros((1, size), np.int32)
        chunk[0, :take] = job.padded[start:start + take]
        write_blocks = np.full((size,), TRASH_BLOCK, np.int32)
        write_offsets = np.zeros((size,), np.int32)
        for offset in range(size):
            position = start + offset
            if position < job.true_len:
                write_blocks[offset] = job.blocks[position // block_size]
            write_offsets[offset] = position % block_size
        self._note_signature(("chunk", size))
        _, greedy = paged_prefill_chunk(
            self.params, self.config, self.pool, self._tensor(chunk),
            self._tensor(self.table), int(start),
            self._tensor(write_blocks), self._tensor(write_offsets))
        self.counters["chunks"] += 1
        self._bump("prefill.chunks", 1)
        job.prefill_pos = start + take
        if job.prefill_pos < job.true_len:
            return []
        first = int(greedy[job.true_len - 1 - start])
        return [self._finish(job, first)]

    # -- export ------------------------------------------------------------

    def _finish(self, job: _PrefillJob, first: int) -> dict:
        """Offer the prompt's KV blocks on the transfer plane and build
        the handoff record.  Only blocks holding TRUE prompt positions
        travel: the bucket-padding tail past true_len is garbage the
        adopting engine overwrites before its gather reaches it, and
        whole blocks past the prompt hold nothing at all."""
        used = self.blocks.blocks_for(job.true_len)
        # RAW descriptors, not {TENSOR_REF_KEY: ...} markers: see
        # fetch_kv_blocks -- the frame codec must carry these inert so
        # the ADOPTING engine batch-fetches
        kv_blocks, total_bytes = offer_pool_blocks(
            self.pool, job.blocks[:used])
        self.blocks.free(job.blocks)
        job.blocks = []
        self._active = None
        now = time.perf_counter()
        self.counters["exported"] += 1
        self.counters["exported_bytes"] += total_bytes
        self._bump("prefill.exports", 1)
        self._bump("prefill.exported_bytes", total_bytes)
        if self._registry is not None:
            self._registry.histogram("prefill.queue_wait_s").record(
                (job.started_at or now) - job.submitted_at)
            self._registry.histogram("prefill.prefill_s").record(
                now - (job.started_at or now))
        return {
            "schema": HANDOFF_SCHEMA,
            "request_id": job.request_id,
            "prompt": [int(token) for token in job.prompt],
            "max_new": job.max_new,
            "true_len": job.true_len,
            "first_token": int(first),
            "block_size": self.blocks.block_size,
            "kv_dtype": self.config.kv_dtype or "",
            "kv_bytes": int(total_bytes),
            "queue_wait_s": round(
                (job.started_at or now) - job.submitted_at, 6),
            "prefill_s": round(now - (job.started_at or now), 6),
            "kv_blocks": kv_blocks,
        }

    def stats(self) -> dict:
        stats = {
            "waiting": len(self.waiting),
            "active": 1 if self._active else 0,
            "block_size": self.blocks.block_size,
            "free_blocks": self.blocks.free_count,
            **self.counters,
        }
        if self.prefill_chunk is not None:
            stats["prefill_chunk_size"] = self.prefill_chunk
        return stats
