# DecodeEngine: slot-based continuous batching over paged KV.
#
# Counterpart of aiko_services_tpu/decode/engine.py, with the same
# scheduling, the same host bookkeeping (numpy, a few writes per step)
# and the same counters: a fixed-arity array of decode SLOTS shares one
# paged KV pool; requests are admitted at prefill boundaries into free
# slots, finished sequences free their slot and blocks at once, and
# every engine tick runs ONE decode (or speculative verify) step over
# all slots (models/transformer.py paged_decode_step) with inactive
# slots on the trash block.
#
# Scheduling policy (deliberately boring and deterministic):
#   - admission is FIFO; a request that cannot get its prompt blocks
#     defers (decode.deferred_admissions counts it) -- no head-of-line
#     skipping, so caller-observed ordering is reproducible;
#   - KV blocks are allocated LAZILY one block at a time as a slot's
#     cursor crosses a block boundary;
#   - on pool exhaustion the YOUNGEST active slot is preempted (blocks
#     freed, request requeued at the FRONT for a full re-prefill) so the
#     oldest slot always progresses; greedy decode regenerates the same
#     tokens and `emitted_upto` dedupes the token stream.  A slot
#     preempted mid-chunked-prefill frees its partial blocks the same way.
#   - CHUNKED PREFILL (prefill_chunk_size): a prefilling slot consumes
#     its prompt one chunk per tick (paged_prefill_chunk attends to the
#     blocks earlier chunks wrote), interleaved with decode steps;
#   - GREEDY-EXACT SPECULATIVE DECODING (draft_params/draft_config/
#     spec_k): a draft proposes k tokens per slot, the target verifies the
#     k + 1 window positions in one batched step (paged_verify_step) and
#     accepts the longest greedy-matching prefix, so emitted tokens stay
#     identical to plain greedy decode.  The draft keeps its own fully
#     reserved pool with static per-slot block rows.
#   - PREFIX CACHE (prefix_policy, decode/prefix.py): fully written
#     prompt blocks are indexed by their token hash chain, and a later
#     admission borrows the longest cached run and prefills only the tail.
#
# One program per step signature.  Where the JAX package jits each paged
# step once per shape, the engine captures each fixed-shape step once as
# a CUDA graph on the card -- paged_decode_step once per model (target,
# draft), paged_verify_step once per window -- and replays it after
# copying the tables, positions, tokens and write locations into the
# graph's static inputs.  A capture that fails raises; the engine never
# runs a step eagerly on the card.  On the CPU the steps run eagerly.
# The prefills (paged_prefill, paged_prefill_chunk) run once per
# admission or chunk and stay eager.  compile_count counts the distinct
# step signatures this engine has run or captured, the counterpart of
# the jit cache entries its JAX twin compiles.
#
# KV migration (adopt_request: a prefill pool's handoff; restore_request:
# a checkpoint keeper's snapshot; adopt_prefix: the cross-replica prefix
# store) fetches blocks over the transfer plane and writes them into the
# pool IN PLACE (index_copy_ on the block axis): the captured graphs read
# the pool tensors they were captured with, so a reassigned pool leaf
# would leave them decoding from stale KV.
#
# On the card each engine issues all its work on its own CUDA stream and
# captures with capture_error_mode="thread_local", so two engines on one
# card (two replicas, or a replica beside a prefill engine, each driven
# by its own thread) neither serialize through one stream nor trip each
# other's captures.

from __future__ import annotations

import contextlib
import threading
import time

from collections import deque
from dataclasses import dataclass, field

import numpy as np

import torch

from ..models import (
    f32_head, init_paged_pool, paged_decode_step, paged_prefill,
    paged_prefill_chunk, paged_verify_step)
from ..runtime.compile_cache import record_capture
from ..utils import get_logger
from ..utils.padding import bucket_length
from .blocks import TRASH_BLOCK, BlockManager
from .prefix import PrefixCache, PrefixPolicy, chain_hashes

__all__ = ["DecodeEngine", "Completion", "StepReport"]

_LOGGER = get_logger("decode_engine")


@dataclass
class _Request:
    request_id: object
    prompt: np.ndarray            # (true_len,) int32, exact tokens
    max_new: int
    submitted_at: float
    generated: list = field(default_factory=list)
    emitted_upto: int = 0         # token offsets already surfaced
    admitted_at: float | None = None
    first_token_at: float | None = None
    decode_steps: int = 0
    preemptions: int = 0
    deferred: bool = False        # counted at most once per request


@dataclass
class Completion:
    request_id: object
    tokens: np.ndarray            # (max_new,) int32 (EOS-padded)
    stats: dict


@dataclass
class StepReport:
    completions: list = field(default_factory=list)
    # (request_id, offset, token_id) newly surfaced this step, in
    # decode order -- the element's token-streaming feed
    emitted: list = field(default_factory=list)
    admitted: int = 0
    active: int = 0


class _Slot:
    __slots__ = ("request", "blocks", "seq", "true_len", "bucket",
                 "padded", "prefill_pos", "draft_pending", "shared",
                 "hashes")

    def __init__(self, request: _Request, blocks: list, seq: int,
                 true_len: int, bucket: int, padded: np.ndarray):
        self.request = request
        self.blocks = blocks
        self.seq = seq            # admission order; preemption victims
        self.true_len = true_len  # are chosen youngest (max seq) first
        self.bucket = bucket
        self.padded = padded      # (bucket,) right-padded prompt
        self.prefill_pos = 0      # prompt tokens already written
        self.draft_pending = []   # emitted tokens the draft hasn't seen
        self.shared = 0           # leading blocks borrowed from the
        self.hashes = None        # prefix cache, + their digest chain

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.true_len


# One capture at a time in this process: torch.cuda.graph synchronizes the
# device and empties the allocator's cache before it begins, which must
# not run while another engine's capture is underway.  Launches, copies
# and allocations of other threads stay free during a capture (thread-
# local capture mode).
_CAPTURE_LOCK = threading.Lock()


def work_stream(device: torch.device):
    """The CUDA stream an engine issues all its work on (ordered after
    everything already queued on the current stream, e.g. the params'
    creation); None on the CPU."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def on_stream(stream):
    """Context running the enclosed device work on `stream` (a no-op for
    None, the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


class _CapturedStep:
    """One fixed-shape paged step (paged_decode_step or paged_verify_step
    on one model) captured as a CUDA graph.  Its static inputs start as
    all-trash tables and writes, so the warm-up runs before the capture
    write only the trash block; each replay copies the host arrays into
    them and reads the greedy tokens back."""

    def __init__(self, step, params, config, pool, shapes):
        device = pool["k"].device
        self.inputs = [torch.full(shape, TRASH_BLOCK, dtype=torch.int32,
                                  device=device) for shape in shapes]

        def run():
            return step(params, config, pool, *self.inputs)[1]

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):    # cuBLAS handles and workspaces
                run()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another engine's thread may launch, allocate or
        # copy while this one captures
        with _CAPTURE_LOCK, torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            self.output = run()
        # counted beside the kernel build cache's hits and misses: a
        # warm replica captures its own graphs (runtime/compile_cache.py)
        record_capture()

    def replay(self, arrays) -> np.ndarray:
        for static, array in zip(self.inputs, arrays):
            static.copy_(torch.from_numpy(array))
        self.graph.replay()
        return self.output.cpu().numpy()


class DecodeEngine:
    """Continuous-batching greedy decode over one transformer.

    Shapes fixed at construction: `decode_slots` slots, a pool of
    `kv_blocks` blocks of `kv_block_size` positions, and block tables
    wide enough for `max_context` positions per slot.  The pool lives on
    the device of `params`.  Tokens equal the closed-batch generate()
    path's for the same prompt tokens (tests/test_torch_decode.py).
    """

    def __init__(self, params, config, *, decode_slots: int = 4,
                 kv_block_size: int = 16, kv_blocks: int | None = None,
                 max_context: int | None = None, eos_id: int | None = None,
                 prefill_chunk_size: int | None = None,
                 draft_params=None, draft_config=None, spec_k: int = 0,
                 prefix_policy=None, registry=None):
        if decode_slots < 1:
            raise ValueError(f"decode_slots must be >= 1, "
                             f"got {decode_slots}")
        self.config = config
        self.device = params["embed"]["w"].device
        self.stream = work_stream(self.device)
        with on_stream(self.stream):
            # the f32 LM head kept once beside the params (f32_head): the
            # steps' logits product reads it instead of copying the table
            self.params = f32_head(params)
        # one captured CUDA graph per step signature on the card; eager
        # steps on the CPU
        self._graphs = self.device.type == "cuda"
        self._captured = {}
        self._signatures = set()
        self.slots_n = int(decode_slots)
        self.eos_id = None if eos_id is None else int(eos_id)
        max_context = int(max_context or config.max_seq_len)
        self.max_blocks = -(-max_context // int(kv_block_size))
        self.max_context = self.max_blocks * int(kv_block_size)
        if kv_blocks is None:
            # full reservation: every slot can grow to max_context, so
            # preemption never fires; shrink kv_blocks to oversubscribe
            kv_blocks = self.slots_n * self.max_blocks + 1
        self.blocks = BlockManager(int(kv_blocks), int(kv_block_size))
        # cross-request prefix KV reuse (decode/prefix.py): with a
        # prefix policy armed, fully-written prompt blocks are indexed
        # by their token hash chain and later admissions borrow the
        # longest cached prefix instead of re-prefilling it.  None =
        # cold path, behavior identical to pre-prefix deployments
        policy = (PrefixPolicy.parse(prefix_policy)
                  if prefix_policy is not None else None)
        if policy is not None and not policy.enabled:
            policy = None
        self.prefix_policy = policy
        self.prefix = (PrefixCache(self.blocks, policy.cache_blocks)
                       if policy is not None else None)
        with on_stream(self.stream):
            self.pool = init_paged_pool(config, self.blocks.num_blocks,
                                        self.blocks.block_size,
                                        device=self.device)
        self.tables = np.full((self.slots_n, self.max_blocks),
                              TRASH_BLOCK, np.int32)
        self.positions = np.zeros((self.slots_n,), np.int32)
        self.last_tokens = np.zeros((self.slots_n, 1), np.int32)
        self.slots: list[_Slot | None] = [None] * self.slots_n
        self.waiting: deque[_Request] = deque()
        self._admission_seq = 0
        self._registry = registry
        # chunked prefill: coerced to a power-of-two block multiple so
        # the per-chunk executables stay logarithmic; a chunk covering
        # max_context degenerates to the monolithic path
        if prefill_chunk_size is not None:
            chunk = bucket_length(int(prefill_chunk_size),
                                  minimum=self.blocks.block_size)
            self.prefill_chunk = int(min(chunk, self.max_context))
        else:
            self.prefill_chunk = None
        # greedy-exact speculative decoding: draft model + window size
        if (draft_params is None) != (draft_config is None):
            raise ValueError("speculative decoding needs BOTH "
                             "draft_params and draft_config")
        self.spec_k = int(spec_k or 0)
        if self.spec_k and draft_params is None:
            raise ValueError(f"spec_k={self.spec_k} needs a draft model "
                             f"(draft_params/draft_config)")
        if draft_params is not None and self.spec_k < 1:
            self.spec_k = 4
        with on_stream(self.stream):
            self.draft_params = (f32_head(draft_params)
                                 if draft_params is not None else None)
        self.draft_config = draft_config
        if draft_config is not None:
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    f"draft vocab_size {draft_config.vocab_size} != "
                    f"target vocab_size {config.vocab_size}: proposals "
                    f"would index a different token space")
            # the draft pool is FULLY reserved with a static block row
            # per slot: the draft is small, so the reservation is cheap
            # and speculation stays out of the target pool's
            # allocation/preemption logic entirely
            with on_stream(self.stream):
                self.draft_pool = init_paged_pool(
                    draft_config, self.slots_n * self.max_blocks + 1,
                    self.blocks.block_size, device=self.device)
            self.draft_tables = np.zeros(
                (self.slots_n, self.max_blocks), np.int32)
            for index in range(self.slots_n):
                self.draft_tables[index] = (
                    1 + index * self.max_blocks
                    + np.arange(self.max_blocks))
            self.draft_positions = np.zeros((self.slots_n,), np.int32)
        self.spec_draft_s = 0.0
        self.spec_verify_s = 0.0
        self.counters = {"admitted": 0, "completed": 0, "preempted": 0,
                         "deferred_admissions": 0, "cancelled": 0,
                         "compiles": 0, "prefill_chunks": 0,
                         "chunk_interleaves": 0, "spec_windows": 0,
                         "spec_drafted": 0, "spec_accepted": 0,
                         "adopted": 0, "adopt_fallbacks": 0,
                         "kv_migrated_bytes": 0, "restores": 0,
                         "restore_fallbacks": 0,
                         "restore_replayed_tokens": 0,
                         "prefix_hits": 0, "prefix_partial_hits": 0,
                         "prefix_blocks_shared": 0,
                         "prefix_evictions": 0}
        self._update_gauges()

    # -- submission --------------------------------------------------------

    def _bucket(self, true_len: int) -> int:
        """Prompt prefill bucket: power-of-two padding rounded up to a
        block multiple, so the per-bucket prefill executable count stays
        logarithmic and block scatter is exact.  Clamped to max_context
        (itself a block multiple): a prompt whose pow2 round-up
        overshoots a non-pow2 max_context still fits — prefill works at
        any block-multiple length — and must not be rejected."""
        block = self.blocks.block_size
        padded = bucket_length(true_len, minimum=block)
        return min(-(-padded // block) * block, self.max_context)

    def submit(self, request_id, prompt_tokens, max_new_tokens: int):
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        max_new = int(max_new_tokens)
        if prompt.size < 1:
            raise ValueError(f"{request_id}: empty prompt")
        if max_new < 1:
            raise ValueError(f"{request_id}: max_new_tokens must be >= 1")
        worst = max(self._bucket(prompt.size), prompt.size + max_new)
        if worst > self.max_context:
            raise ValueError(
                f"{request_id}: prompt {prompt.size} + max_new "
                f"{max_new} exceeds max_context {self.max_context}")
        if self.blocks.blocks_for(worst) > self.blocks.capacity:
            raise ValueError(
                f"{request_id}: needs {self.blocks.blocks_for(worst)} "
                f"KV blocks but the pool only has "
                f"{self.blocks.capacity}; raise kv_blocks")
        self.waiting.append(_Request(
            request_id=request_id, prompt=prompt, max_new=max_new,
            submitted_at=time.perf_counter()))
        self._update_gauges()

    def _ingest_kv_blocks(self, record: dict, needed: int,
                          timeout, fallback, what: str):
        """The shared CONSUMER half of both KV migrations -- prefill
        handoff adoption and checkpoint restore: allocate `needed`
        blocks, batch-fetch `record`'s raw block descriptors (ONE
        connection per producing peer), and scatter them into the
        pool.  Returns (granted_blocks, migrated_bytes); on ANY
        failure the grant is returned to the free list, `fallback`
        runs with the reason, and (None, 0) comes back."""
        from .disagg import fetch_kv_blocks

        granted = self._allocate(needed)
        if granted is None:
            fallback("pool exhausted")
            return None, 0
        try:
            leaves = fetch_kv_blocks(record, timeout=timeout,
                                     pin=self.device.type == "cuda")
        except (KeyError, ValueError) as error:
            # TransferError subclasses ValueError; expired keys raise
            # KeyError -- either way the prompt re-prefills locally
            self.blocks.free(granted)
            fallback(f"KV fetch failed: {error}")
            return None, 0
        if set(leaves) != set(self.pool):
            self.blocks.free(granted)
            fallback(f"{what} leaves {sorted(leaves)} != pool leaves "
                     f"{sorted(self.pool)} (kv_dtype mismatch?)")
            return None, 0
        for name, stacked in leaves.items():
            # same leaf names + block size but a different model
            # geometry or dtype (mixed fleet / rolling reconfig) must
            # degrade like every other path -- checked BEFORE any write,
            # never leaking the grant
            leaf = self.pool[name]
            fits = (leaf.shape[0], len(granted)) + tuple(leaf.shape[2:])
            if tuple(stacked.shape) != fits or stacked.dtype != leaf.dtype:
                self.blocks.free(granted)
                fallback(f"{what} leaf {name!r} {tuple(stacked.shape)} "
                         f"{stacked.dtype} does not fit this pool's "
                         f"{fits} {leaf.dtype}")
                return None, 0
        # IN PLACE into the pool's own storage: the captured decode and
        # verify graphs read these tensors
        index = torch.as_tensor(granted, dtype=torch.long,
                                device=self.device)
        migrated = 0
        for name, stacked in leaves.items():
            migrated += stacked.numel() * stacked.element_size()
            self.pool[name].index_copy_(
                1, index, stacked.to(self.device, non_blocking=True))
        return granted, migrated

    def adopt_request(self, request_id, handoff: dict,
                      timeout: float | None = None) -> StepReport:
        """Adopt a remotely prefilled request MID-FLIGHT: fetch the
        handoff's KV blocks over the transfer plane (one batched
        connection per peer), rewrite a free slot's block table to the
        granted blocks, and continue greedy decode from the prompt end
        -- no re-prefill, int8 KV carried through unchanged, tokens
        bit-identical to a co-located prefill+decode (the transferred
        K/V are exact copies, and the writes-before-gather invariant
        covers the last block's padding tail exactly as it covers
        local prefill's).

        NEVER loses the request: a fetch failure/timeout, a block-size
        mismatch, a full slot array, or an exhausted pool all FALL
        BACK to a plain submit() -- a local re-prefill through the
        ordinary admission path (decode.adopt_fallbacks counts it).
        Returns a StepReport carrying the first token's emission (and
        the completion, when max_new == 1)."""
        with on_stream(self.stream):
            return self._adopt_request(request_id, handoff, timeout)

    def _adopt_request(self, request_id, handoff: dict,
                       timeout: float | None) -> StepReport:
        report = StepReport()
        prompt = np.asarray(handoff["prompt"], np.int32).reshape(-1)
        max_new = int(handoff["max_new"])
        true_len = int(handoff.get("true_len", prompt.size))

        def fallback(reason: str) -> StepReport:
            _LOGGER.info("adopt %r fell back to local re-prefill: %s",
                         request_id, reason)
            self.counters["adopt_fallbacks"] += 1
            self._bump("decode.adopt_fallbacks", 1)
            self.submit(request_id, prompt, max_new)
            return report

        if int(handoff.get("block_size", 0)) != self.blocks.block_size:
            return fallback(
                f"block_size {handoff.get('block_size')} != pool's "
                f"{self.blocks.block_size}")
        free = [index for index, slot in enumerate(self.slots)
                if slot is None]
        if not free:
            return fallback("no free slot")
        worst = max(self._bucket(true_len), true_len + max_new)
        if worst > self.max_context:
            raise ValueError(
                f"{request_id}: prompt {true_len} + max_new {max_new} "
                f"exceeds max_context {self.max_context}")
        needed = self.blocks.blocks_for(true_len)
        if len(handoff.get("kv_blocks") or []) != needed:
            return fallback(
                f"handoff carries {len(handoff.get('kv_blocks') or [])}"
                f" blocks, prompt needs {needed}")
        adopt_start = time.perf_counter()
        granted, migrated = self._ingest_kv_blocks(
            handoff, needed, timeout, fallback, "handoff")
        if granted is None:
            return report
        # slot bookkeeping identical to a local prefill's end state
        request = _Request(
            request_id=request_id, prompt=prompt, max_new=max_new,
            submitted_at=(adopt_start
                          - float(handoff.get("queue_wait_s", 0.0))
                          - float(handoff.get("prefill_s", 0.0))))
        request.admitted_at = adopt_start
        bucket = self._bucket(true_len)
        padded = np.zeros((bucket,), np.int32)
        padded[:true_len] = prompt
        index = free[0]
        slot = _Slot(request, granted, self._admission_seq, true_len,
                     bucket, padded)
        self._admission_seq += 1
        slot.prefill_pos = true_len
        self.slots[index] = slot
        self.tables[index, :] = TRASH_BLOCK
        self.tables[index, :needed] = granted
        self._finish_prefill(index, report,
                             int(handoff["first_token"]))
        adopt_ms = (time.perf_counter() - adopt_start) * 1000.0
        self.counters["adopted"] += 1
        self.counters["kv_migrated_bytes"] += migrated
        self.counters["admitted"] += 1
        report.admitted += 1
        self._bump("decode.adopted", 1)
        self._bump("decode.admitted", 1)
        self._bump("decode.kv_migrated_bytes", migrated)
        if self._registry is not None:
            self._registry.histogram("decode.adopt_ms").record(adopt_ms)
        self._update_gauges()
        return report

    def restore_request(self, request_id, record,
                        prompt_tokens=None, max_new_tokens=None,
                        timeout: float | None = None,
                        resume_from: int = 0) -> StepReport:
        """Resume a request from a CHECKPOINT after its decode replica
        died (decode/checkpoint.py): fetch the keeper's merged KV
        blocks over the transfer plane, scatter them into a free slot,
        restore the cursor + generated-token list, and continue greedy
        decode from the snapshot position -- re-decoding only the (at
        most max_checkpoint_lag) tokens generated after the snapshot,
        which greedy determinism regenerates bit-identically, instead
        of re-prefilling the whole prompt.

        `resume_from` is the highest token offset already DELIVERED
        downstream (a replaying client's hint): tokens below it
        re-decode silently -- counted as
        decode.restore_replayed_tokens -- and emission resumes
        gaplessly at that offset.  Without a hint every restored token
        DELIBERATELY re-emits with its original offset -- the
        snapshot's own emitted floor is NOT trusted, because the dead
        element may have buffered (never published) chunks the engine
        already counted as surfaced -- so an offset-keyed consumer
        assembles an exactly-once, gapless stream either way.

        NEVER loses the request: a missing/stale/mismatched record, a
        failed fetch, a full slot array, or an exhausted pool all FALL
        BACK to a plain submit() -- the existing replay re-prefill --
        with decode.restore_fallbacks counting the degradation."""
        with on_stream(self.stream):
            return self._restore_request(request_id, record,
                                         prompt_tokens, max_new_tokens,
                                         timeout, resume_from)

    def _restore_request(self, request_id, record, prompt_tokens,
                         max_new_tokens, timeout,
                         resume_from) -> StepReport:
        report = StepReport()
        if record is not None:
            prompt = np.asarray(record.get("prompt", ()),
                                np.int32).reshape(-1)
            max_new = int(record.get("max_new", max_new_tokens or 0))
        else:
            prompt = np.asarray(
                () if prompt_tokens is None else prompt_tokens,
                np.int32).reshape(-1)
            max_new = int(max_new_tokens or 0)
        if prompt.size < 1 or max_new < 1:
            raise ValueError(
                f"{request_id}: restore needs a prompt and "
                f"max_new_tokens (from the record or the caller)")

        def fallback(reason: str) -> StepReport:
            _LOGGER.info("restore %r fell back to local re-prefill: "
                         "%s", request_id, reason)
            self.counters["restore_fallbacks"] += 1
            self._bump("decode.restore_fallbacks", 1)
            self.submit(request_id, prompt, max_new)
            return report

        if record is None:
            return fallback("no checkpoint record")
        generated = [int(token) for token in
                     (record.get("generated") or ())]
        if not generated:
            return fallback("snapshot precedes the first token")
        if int(record.get("block_size", 0)) != self.blocks.block_size:
            return fallback(
                f"block_size {record.get('block_size')} != pool's "
                f"{self.blocks.block_size}")
        true_len = int(record.get("true_len", prompt.size))
        position = int(record.get("position", 0))
        if position != true_len + len(generated) - 1:
            return fallback(
                f"inconsistent snapshot: position {position} != "
                f"true_len {true_len} + {len(generated)} - 1")
        free = [index for index, slot in enumerate(self.slots)
                if slot is None]
        if not free:
            return fallback("no free slot")
        worst = max(self._bucket(true_len), true_len + max_new)
        if worst > self.max_context:
            raise ValueError(
                f"{request_id}: prompt {true_len} + max_new {max_new} "
                f"exceeds max_context {self.max_context}")
        needed = self.blocks.blocks_for(position)
        if len(record.get("kv_blocks") or []) != needed:
            return fallback(
                f"snapshot carries "
                f"{len(record.get('kv_blocks') or [])} blocks, "
                f"position {position} needs {needed}")
        restore_start = time.perf_counter()
        granted, migrated = self._ingest_kv_blocks(
            record, needed, timeout, fallback, "snapshot")
        if granted is None:
            return report
        now = time.perf_counter()
        request = _Request(
            request_id=request_id, prompt=prompt, max_new=max_new,
            submitted_at=now)
        request.admitted_at = now
        request.first_token_at = now
        request.generated = generated
        # the emission floor: tokens the downstream already holds are
        # re-decoded (their K/V feeds later positions) but re-emission
        # resumes at the floor, so streamed offsets stay gapless.  With
        # a floor PAST the snapshot the gap is exactly the post-snapshot
        # tokens the dead replica emitted -- the re-decode burden
        # max_checkpoint_lag bounds
        resume = max(int(resume_from or 0), 0)
        replayed = max(resume - len(generated), 0)
        request.emitted_upto = min(resume, max_new)
        bucket = self._bucket(true_len)
        padded = np.zeros((bucket,), np.int32)
        padded[:true_len] = prompt
        index = free[0]
        slot = _Slot(request, granted, self._admission_seq, true_len,
                     bucket, padded)
        self._admission_seq += 1
        slot.prefill_pos = true_len
        self.slots[index] = slot
        self.tables[index, :] = TRASH_BLOCK
        self.tables[index, :needed] = granted
        self.positions[index] = position
        self.last_tokens[index, 0] = generated[-1]
        if self.draft_params is not None:
            # the draft's cache cannot restore from the target's
            # snapshot: rebuild it from the prompt and let the pending
            # window re-ingest the restored tail lazily -- proposals
            # are only ever proposals, so correctness is unaffected
            self._draft_prefill(index)
            catchup = generated[max(len(generated) - 2, 0):]
            slot.draft_pending = list(catchup)
            self.draft_positions[index] = (
                position + 1 - len(slot.draft_pending))
        restore_ms = (time.perf_counter() - restore_start) * 1000.0
        self.counters["restores"] += 1
        self.counters["kv_migrated_bytes"] += migrated
        self.counters["admitted"] += 1
        self.counters["restore_replayed_tokens"] += replayed
        report.admitted += 1
        self._bump("decode.restores", 1)
        self._bump("decode.admitted", 1)
        self._bump("decode.kv_migrated_bytes", migrated)
        if replayed:
            self._bump("decode.restore_replayed_tokens", replayed)
        if self._registry is not None:
            self._registry.histogram("decode.restore_ms").record(
                restore_ms)
        self._surface(report, request)
        if self._finished(request):
            report.completions.append(self._complete(index))
        self._update_gauges()
        return report

    def cancel(self, predicate) -> int:
        """Drop every request whose request_id satisfies `predicate`
        (waiting or mid-decode; a cancelled slot frees immediately).
        Returns the number cancelled."""
        cancelled = 0
        kept = deque()
        for request in self.waiting:
            if predicate(request.request_id):
                cancelled += 1
            else:
                kept.append(request)
        self.waiting = kept
        for index, slot in enumerate(self.slots):
            if slot is not None and predicate(slot.request.request_id):
                self._release_slot(index)
                cancelled += 1
        if cancelled:
            self.counters["cancelled"] += cancelled
            self._bump("decode.cancelled", cancelled)
            self._update_gauges()
        return cancelled

    def has_work(self) -> bool:
        return bool(self.waiting) or any(
            slot is not None for slot in self.slots)

    # -- the engine step ---------------------------------------------------

    def step(self) -> StepReport:
        """One engine tick: admit waiting requests into free slots,
        advance every mid-prefill slot by one chunk, grow/preempt block
        allocations, then run ONE fused decode (or speculative verify)
        step over the decoding slots.  Chunked prefill progress and
        decode progress share the tick -- that interleaving is what
        stops a long prompt from convoying every co-scheduled slot."""
        with on_stream(self.stream):
            return self._step()

    def _step(self) -> StepReport:
        report = StepReport()
        self._admit(report)
        ran_chunk = self._advance_prefills(report)
        active = [index for index, slot in enumerate(self.slots)
                  if slot is not None]
        if not active:
            self._update_gauges()
            report.active = 0
            return report
        self._grow_or_preempt()
        active = [index for index, slot in enumerate(self.slots)
                  if slot is not None]
        report.active = len(active)
        decoding = [index for index in active
                    if not self.slots[index].prefilling]
        if not decoding:
            self._update_gauges()
            return report
        if self.draft_params is not None:
            self._spec_round(decoding, report)
        else:
            self._plain_step(decoding, report)
        if ran_chunk:
            # a prefill chunk and decode progress shared this tick:
            # the convoy the chunking exists to break
            self.counters["chunk_interleaves"] += 1
            self._bump("decode.chunk_interleaves", 1)
        self._update_gauges()
        return report

    def _plain_step(self, decoding: list, report: StepReport) -> None:
        """One paged_decode_step over all slots; mid-prefill and free
        slots write to the trash block and their rows are ignored."""
        write_blocks = np.zeros((self.slots_n,), np.int32)
        write_offsets = np.zeros((self.slots_n,), np.int32)
        for index in decoding:
            position = int(self.positions[index])
            block_index = position // self.blocks.block_size
            write_blocks[index] = self.slots[index].blocks[block_index]
            write_offsets[index] = position % self.blocks.block_size
        next_tokens = self._fixed_step(
            False, paged_decode_step, self.tables, self.positions,
            self.last_tokens, write_blocks, write_offsets)
        for index in decoding:
            slot = self.slots[index]
            request = slot.request
            token = int(next_tokens[index, 0])
            self.positions[index] += 1
            self.last_tokens[index, 0] = token
            request.generated.append(token)
            request.decode_steps += 1
            self._surface(report, request)
            if self._finished(request):
                report.completions.append(self._complete(index))

    # -- admission / prefill ----------------------------------------------

    def _admit(self, report: StepReport) -> None:
        while self.waiting:
            free = [index for index, slot in enumerate(self.slots)
                    if slot is None]
            if not free:
                return
            request = self.waiting[0]
            true_len = int(request.prompt.size)
            bucket = self._bucket(true_len)
            needed = self.blocks.blocks_for(bucket)
            # prefix-cache hit path: borrow the longest cached run of
            # this prompt's hash chain, capped so the LAST prompt token
            # always tail-prefills (its logits produce the first
            # generated token), and only allocate the uncached rest
            matched, hashes = [], None
            if self.prefix is not None:
                hashes = chain_hashes(request.prompt,
                                      self.blocks.block_size)
                usable = (true_len - 1) // self.blocks.block_size
                matched = self.prefix.acquire(hashes[:usable])
                if matched and (len(matched)
                                < self.prefix_policy.min_prefix_blocks):
                    # a tiny hit pays table-rewrite cost for nothing
                    self.prefix.release(matched)
                    matched = []
            granted = self._allocate(needed - len(matched))
            if granted is None:
                # pool exhausted (cached tier already reclaimed):
                # admission DEFERS (FIFO order kept); completions free
                # blocks, so the queue always drains.  Counted once
                # per REQUEST, not per blocked tick.
                if matched:
                    self.prefix.release(matched)
                if not request.deferred:
                    request.deferred = True
                    self.counters["deferred_admissions"] += 1
                    self._bump("decode.deferred_admissions", 1)
                return
            blocks = list(matched) + granted
            self.waiting.popleft()
            index = free[0]
            padded = np.zeros((bucket,), np.int32)
            padded[:true_len] = request.prompt
            slot = _Slot(request, blocks, self._admission_seq, true_len,
                         bucket, padded)
            slot.shared = len(matched)
            slot.hashes = hashes
            slot.prefill_pos = len(matched) * self.blocks.block_size
            self._admission_seq += 1
            self.slots[index] = slot
            self.tables[index, :] = TRASH_BLOCK
            self.tables[index, :needed] = blocks
            if matched:
                self.counters["prefix_hits"] += 1
                self.counters["prefix_blocks_shared"] += len(matched)
                self._bump("decode.prefix_hits", 1)
                self._bump("decode.prefix_blocks_shared", len(matched))
                if len(matched) < usable:
                    self.counters["prefix_partial_hits"] += 1
                    self._bump("decode.prefix_partial_hits", 1)
            # a preempted request's RE-admission keeps first-attempt
            # timestamps: the caller saw its first token back then, so
            # ttft/queue_wait/prefill stats must not absorb the retry
            if request.admitted_at is None:
                request.admitted_at = time.perf_counter()
            self.counters["admitted"] += 1
            report.admitted += 1
            self._bump("decode.admitted", 1)
            if (self.prefill_chunk is not None
                    and self.prefill_chunk < bucket):
                # chunked: no device work at admission -- the slot's
                # prompt is consumed one chunk per tick by
                # _advance_prefills, interleaved with decode steps
                # (a prefix hit just starts the chunk cursor past the
                # borrowed blocks)
                continue
            if slot.shared:
                # prefix hit on the monolithic path: ONE chunk call
                # covers the uncached tail -- the whole point of the
                # cache is skipping the quadratic prefix compute
                self._tail_prefill(index, report)
                continue
            self._note_signature(("prefill", "target", bucket))
            _, first = paged_prefill(
                self.params, self.config, self.pool,
                self._tensor(padded[None]), self._tensor(self.tables[index]),
                true_len)
            slot.prefill_pos = bucket
            self._finish_prefill(index, report, int(first))

    def _tail_prefill(self, index: int, report: StepReport) -> None:
        """Prefill ONLY the uncached tail of a prefix-cache hit in one
        chunk call: paged_prefill_chunk attends to the borrowed
        blocks' resident KV exactly as it attends to earlier chunks'
        writes, so the produced logits -- and the first generated
        token -- are bit-identical to a cold prefill over the whole
        prompt (f32 and int8 KV alike; int8 per-block scales travel
        with the shared blocks)."""
        slot = self.slots[index]
        block_size = self.blocks.block_size
        start = slot.prefill_pos
        remaining = slot.true_len - start
        size = bucket_length(remaining, minimum=block_size)
        chunk = np.zeros((1, size), np.int32)
        chunk[0, :remaining] = slot.padded[start:start + remaining]
        write_blocks = np.full((size,), TRASH_BLOCK, np.int32)
        write_offsets = np.zeros((size,), np.int32)
        for offset in range(size):
            position = start + offset
            if position < slot.true_len:
                write_blocks[offset] = slot.blocks[
                    position // block_size]
            write_offsets[offset] = position % block_size
        greedy = self._prefill_chunk(False, chunk, self.tables[index],
                                     start, write_blocks, write_offsets)
        first = int(greedy[slot.true_len - 1 - start])
        self._finish_prefill(index, report, first)

    def _finish_prefill(self, index: int, report: StepReport,
                        first: int, draft_ready: bool = False) -> None:
        """Shared tail of monolithic and chunked prefill: record the
        first generated token, arm the decode cursor, register the
        slot's freshly written prompt blocks with the prefix cache,
        and bring the speculative draft up to date with the prompt
        (chunked prefill already fed the draft chunk-by-chunk:
        draft_ready=True)."""
        slot = self.slots[index]
        request = slot.request
        slot.prefill_pos = max(slot.prefill_pos, slot.true_len)
        if self.prefix is not None:
            self._register_slot_prefix(slot)
        if request.first_token_at is None:
            request.first_token_at = time.perf_counter()
        request.generated.append(first)
        self.positions[index] = slot.true_len
        self.last_tokens[index, 0] = first
        if self.draft_params is not None:
            if not draft_ready:
                self._draft_prefill(index)
            slot.draft_pending = [first]
        self._surface(report, request)
        if self._finished(request):
            report.completions.append(self._complete(index))

    def _draft_prefill(self, index: int) -> None:
        """Bring the draft's cache up to date with a freshly prefilled
        prompt.  The draft's own first-token opinion is DISCARDED --
        the target's prefill output is the authoritative greedy token;
        the draft only ever proposes."""
        slot = self.slots[index]
        self._note_signature(("prefill", "draft", slot.bucket))
        paged_prefill(self.draft_params, self.draft_config,
                      self.draft_pool, self._tensor(slot.padded[None]),
                      self._tensor(self.draft_tables[index]),
                      slot.true_len)
        self.draft_positions[index] = slot.true_len

    def _advance_prefills(self, report: StepReport) -> bool:
        """Advance the OLDEST mid-prefill slot by ONE chunk.  One chunk
        per tick is the SARATHI-style budget: the decode-stall bound
        stays one chunk regardless of how many prefills were admitted
        together (advancing every prefilling slot would multiply the
        stall by the admission burst).  The chunk attends to the
        already-written KV blocks of earlier chunks via the slot's
        block table; the final chunk yields the request's first
        generated token, bit-identical to monolithic prefill's.  With
        a draft model, the SAME chunk range is fed through the draft's
        pool too (a quarter-depth draft adds ~25% to the chunk cost),
        so finishing a prompt never degenerates into one monolithic
        draft prefill.  Returns True when a chunk ran."""
        if self.prefill_chunk is None:
            return False
        block_size = self.blocks.block_size
        order = sorted(
            (index for index, slot in enumerate(self.slots)
             if slot is not None and slot.prefilling),
            key=lambda index: self.slots[index].seq)
        if not order:
            return False
        index = order[0]
        slot = self.slots[index]
        start = slot.prefill_pos
        remaining = slot.true_len - start
        # the last chunk shrinks to its power-of-two bucket, so the
        # executable count stays logarithmic in prefill_chunk
        size = min(self.prefill_chunk,
                   bucket_length(remaining, minimum=block_size))
        take = min(size, remaining)
        chunk = np.zeros((1, size), np.int32)
        chunk[0, :take] = slot.padded[start:start + take]
        write_blocks = np.full((size,), TRASH_BLOCK, np.int32)
        draft_blocks = np.full((size,), TRASH_BLOCK, np.int32)
        write_offsets = np.zeros((size,), np.int32)
        # a prefix-hit slot's draft cache is missing the borrowed
        # blocks' positions entirely, so chunk-feeding the draft would
        # build on garbage: skip it and let _finish_prefill rebuild
        # the draft monolithically (proposals are only proposals, but
        # they should not be noise)
        feed_draft = self.draft_params is not None and not slot.shared
        for offset in range(size):
            position = start + offset
            if position < slot.true_len:
                block_index = position // block_size
                write_blocks[offset] = slot.blocks[block_index]
                if feed_draft:
                    draft_blocks[offset] = self.draft_tables[
                        index, block_index]
            write_offsets[offset] = position % block_size
        greedy = self._prefill_chunk(False, chunk, self.tables[index],
                                     start, write_blocks, write_offsets)
        if feed_draft:
            self._prefill_chunk(True, chunk, self.draft_tables[index],
                                start, draft_blocks, write_offsets)
        self.counters["prefill_chunks"] += 1
        self._bump("decode.prefill_chunks", 1)
        slot.prefill_pos = start + take
        if not slot.prefilling:
            first = int(greedy[slot.true_len - 1 - start])
            if feed_draft:
                self.draft_positions[index] = slot.true_len
            self._finish_prefill(index, report, first,
                                 draft_ready=not slot.shared)
        return True

    # -- speculative decoding ----------------------------------------------

    def _spec_round(self, decoding: list, report: StepReport) -> None:
        """One speculative round over all decoding slots: the draft
        ingests the <= 2 emitted tokens it hasn't consumed and proposes
        its first token in the same window call, extends the proposal
        run with k-1 single steps, then the target verifies the whole
        [last_token, p_1..p_k] window in ONE batched forward and the
        longest greedy-matching prefix is accepted.  Greedy-exact:
        emitted tokens are bit-identical to plain greedy decode."""
        k = self.spec_k
        block_size = self.blocks.block_size
        # 1) draft ingest + first proposal.  Pending is [new last
        # token] after a partial acceptance (the draft's own accepted
        # proposals already live in its cache) or [p_k, bonus] after a
        # full acceptance (p_k's K/V was never written) -- never more.
        ingest = np.zeros((self.slots_n, 2), np.int32)
        ingest_blocks = np.full((self.slots_n, 2), TRASH_BLOCK, np.int32)
        ingest_offsets = np.zeros((self.slots_n, 2), np.int32)
        pending_len = {}
        for index in decoding:
            pending = self.slots[index].draft_pending
            pending_len[index] = len(pending)
            for j, token in enumerate(pending):
                position = int(self.draft_positions[index]) + j
                ingest[index, j] = token
                if position < self.max_context:
                    ingest_blocks[index, j] = self.draft_tables[
                        index, position // block_size]
                    ingest_offsets[index, j] = position % block_size
        draft_start = time.perf_counter()
        draft_greedy = self._fixed_step(
            True, paged_verify_step, self.draft_tables,
            self.draft_positions, ingest, ingest_blocks, ingest_offsets)
        proposals = np.zeros((self.slots_n, k), np.int32)
        for index in decoding:
            proposals[index, 0] = draft_greedy[
                index, pending_len[index] - 1]
            self.draft_positions[index] += pending_len[index]
        # 2) k-1 single draft steps extend the proposal run, writing
        # each proposal's K/V at its own position
        current = proposals[:, 0:1].copy()
        for run in range(1, k):
            step_blocks = np.full((self.slots_n,), TRASH_BLOCK, np.int32)
            step_offsets = np.zeros((self.slots_n,), np.int32)
            for index in decoding:
                position = int(self.draft_positions[index])
                if position < self.max_context:
                    step_blocks[index] = self.draft_tables[
                        index, position // block_size]
                    step_offsets[index] = position % block_size
            current = self._fixed_step(
                True, paged_decode_step, self.draft_tables,
                self.draft_positions, current, step_blocks, step_offsets)
            for index in decoding:
                proposals[index, run] = current[index, 0]
                self.draft_positions[index] += 1
        self.spec_draft_s += time.perf_counter() - draft_start
        # 3) target verification: [last_token, p_1..p_k] in one window
        window = np.zeros((self.slots_n, k + 1), np.int32)
        verify_blocks = np.full((self.slots_n, k + 1), TRASH_BLOCK,
                                np.int32)
        verify_offsets = np.zeros((self.slots_n, k + 1), np.int32)
        for index in decoding:
            slot = self.slots[index]
            window[index, 0] = self.last_tokens[index, 0]
            window[index, 1:] = proposals[index]
            for j in range(k + 1):
                position = int(self.positions[index]) + j
                if position // block_size < len(slot.blocks):
                    verify_blocks[index, j] = slot.blocks[
                        position // block_size]
                    verify_offsets[index, j] = position % block_size
        verify_start = time.perf_counter()
        verified = self._fixed_step(
            False, paged_verify_step, self.tables, self.positions, window,
            verify_blocks, verify_offsets)
        self.spec_verify_s += time.perf_counter() - verify_start
        # 4) greedy-exact acceptance: verified[j] is the target's
        # greedy token after window position j, so draft_j is accepted
        # iff it EQUALS verified[j-1]; the first mismatch wins a bonus
        # token (the target's own correction) and stops the run
        for index in decoding:
            slot = self.slots[index]
            request = slot.request
            accepted = [int(verified[index, 0])]
            for j in range(1, k + 1):
                if int(window[index, j]) != int(verified[index, j - 1]):
                    break
                accepted.append(int(verified[index, j]))
            remaining = request.max_new - len(request.generated)
            accepted = accepted[:remaining]
            if self.eos_id is not None:
                for j, token in enumerate(accepted):
                    if token == self.eos_id:
                        accepted = accepted[:j + 1]
                        break
            self.counters["spec_windows"] += 1
            self.counters["spec_drafted"] += k
            self.counters["spec_accepted"] += len(accepted)
            self._bump("decode.spec_drafted", k)
            self._bump("decode.spec_accepted", len(accepted))
            if self._registry is not None:
                self._registry.histogram("decode.accepted_len").record(
                    len(accepted))
            # rejected window positions hold stale K/V past the new
            # cursor: masked until the cursor reaches them, then
            # overwritten before the gather -- the same invariant that
            # covers prompt-bucket padding
            previous = int(self.positions[index])
            request.generated.extend(accepted)
            request.decode_steps += 1
            self.positions[index] = previous + len(accepted)
            self.last_tokens[index, 0] = accepted[-1]
            # draft bookkeeping: after a FULL acceptance the draft is
            # missing p_k's K/V as well as the bonus token, so pending
            # is two tokens and its cursor stays put; otherwise it
            # rewinds over its rejected run to the new last token
            if len(accepted) == k + 1:
                slot.draft_pending = accepted[-2:]
            else:
                slot.draft_pending = accepted[-1:]
            self.draft_positions[index] = (
                previous + len(accepted) + 1 - len(slot.draft_pending))
            self._surface(report, request)
            if self._finished(request):
                report.completions.append(self._complete(index))

    # -- block growth / preemption ----------------------------------------

    def _grow_or_preempt(self) -> None:
        """Ensure every active slot owns the block its next write
        position lands in; on exhaustion preempt the youngest slot so
        the oldest always progresses (no livelock)."""
        order = sorted(
            (index for index, slot in enumerate(self.slots)
             if slot is not None),
            key=lambda index: self.slots[index].seq)
        horizon = self.spec_k if self.draft_params is not None else 0
        for index in order:
            slot = self.slots[index]
            if slot is None:
                continue  # preempted below while growing an older slot
            if slot.prefilling:
                continue  # prompt blocks were fully granted at admission
            # speculative rounds write a k+1 window per step, so growth
            # covers the whole window -- but never past what the
            # request can still EMIT (a near-complete slot must not
            # preempt a victim for lookahead blocks no accepted token
            # can land in) nor past max_context; overflow window
            # positions write to the trash block instead
            remaining = (slot.request.max_new
                         - len(slot.request.generated))
            slot_horizon = min(horizon, max(remaining - 1, 0))
            target = min(int(self.positions[index]) + slot_horizon,
                         self.max_context - 1)
            needed = (target // self.blocks.block_size) + 1
            while len(slot.blocks) < needed:
                # cache-aware: the refcount-0 cached tier is reclaimed
                # (LRU-first) BEFORE any preemption fires -- the cache
                # must never cost a live request its slot
                granted = self._allocate(1)
                if granted is not None:
                    slot.blocks.extend(granted)
                    self.tables[index, len(slot.blocks) - 1] = granted[0]
                    continue
                victim = max(
                    (other for other in range(self.slots_n)
                     if self.slots[other] is not None),
                    key=lambda other: self.slots[other].seq)
                self._preempt(victim)
                if victim == index:
                    break  # this slot itself was the youngest

    def _preempt(self, index: int) -> None:
        slot = self.slots[index]
        request = slot.request
        _LOGGER.info("preempting slot %d (%r) after %d tokens%s: pool "
                     "exhausted", index, request.request_id,
                     len(request.generated),
                     (f" (mid-prefill at {slot.prefill_pos}/"
                      f"{slot.true_len})" if slot.prefilling else ""))
        request.preemptions += 1
        # full recompute on re-admission: greedy decode regenerates the
        # SAME tokens, and emitted_upto keeps the stream from repeating.
        # A slot caught MID-CHUNKED-PREFILL takes the same path: its
        # partially written KV blocks go back to the free list via
        # _release_slot and re-admission restarts the prompt at chunk 0
        request.generated = []
        request.decode_steps = 0
        self._release_slot(index)
        self.waiting.appendleft(request)
        self.counters["preempted"] += 1
        self._bump("decode.preempted", 1)

    def _release_slot(self, index: int) -> None:
        slot = self.slots[index]
        if self.prefix is not None:
            # registered blocks decref (a block another slot still
            # shares is NEVER freed here -- preempting one holder must
            # not corrupt its sibling); refcount-0 blocks park in the
            # cached tier, private tail blocks free immediately
            self.prefix.release(slot.blocks)
        else:
            self.blocks.free(slot.blocks)
        self.slots[index] = None
        self.tables[index, :] = TRASH_BLOCK
        self.positions[index] = 0
        self.last_tokens[index, 0] = 0

    # -- prefix cache ------------------------------------------------------

    def _allocate(self, count: int):
        """Pool allocation through the prefix cache's second-chance
        reclaim when the cache is armed: refcount-0 cached blocks are
        evicted LRU-first BEFORE an allocation fails, so admission
        deferral and the preemption ladder only ever fire for demand
        the cold system could not have satisfied either."""
        if self.prefix is not None:
            return self.prefix.allocate(count)
        return self.blocks.allocate(count)

    def _register_slot_prefix(self, slot: _Slot) -> None:
        """Index a slot's fully-written PROMPT blocks by their chain
        digests.  Only blocks entirely below true_len are prompt-pure
        (decode writes start AT true_len, so the block holding it is
        mutable); blocks the slot itself borrowed are already
        registered and are skipped via the depth offset."""
        if slot.hashes is None:
            slot.hashes = chain_hashes(slot.request.prompt,
                                       self.blocks.block_size)
        full = slot.true_len // self.blocks.block_size
        if full > slot.shared:
            self.prefix.register(slot.hashes[slot.shared:full],
                                 slot.blocks[slot.shared:full],
                                 depth=slot.shared)

    def prefix_heads(self) -> list:
        """Resident chain-head digests -- the compact summary a
        replica mirrors into its EC share for gateway prefix-affinity
        routing.  Empty when the cache is disarmed."""
        if self.prefix is None:
            return []
        return self.prefix.heads()

    def export_prefix_snapshot(self, tokens) -> dict | None:
        """Package the resident cached prefix of `tokens` as a
        checkpoint-keeper snapshot (decode/checkpoint.py schema), so
        the keeper doubles as a second-chance CROSS-REPLICA prefix
        store: another replica's adopt_prefix() pulls the blocks over
        the transfer plane instead of re-prefilling.  Returns None
        when the cache is disarmed or holds no block of this chain.

        Keyed ("prefix", head-digest) -- digests are process-stable,
        so any replica that computes the same chain finds it.  seq=0
        every time: a prefix snapshot is always a full (non-delta)
        incarnation."""
        if self.prefix is None:
            return None
        from .checkpoint import CHECKPOINT_SCHEMA
        from .disagg import offer_pool_blocks

        hashes = chain_hashes(tokens, self.blocks.block_size)
        blocks = self.prefix.resident_blocks(hashes)
        if not blocks:
            return None
        with on_stream(self.stream):
            kv_blocks, _total = offer_pool_blocks(self.pool, blocks)
        count = len(blocks)
        size = self.blocks.block_size
        prefix_tokens = np.asarray(tokens, np.int32).reshape(-1)
        return {
            "schema": CHECKPOINT_SCHEMA,
            "request_id": ["prefix", hashes[0]],
            "prompt": [int(token) for token
                       in prefix_tokens[:count * size]],
            "generated": [],
            "emitted_upto": 0,
            "max_new": 0,
            "true_len": count * size,
            "position": count * size,
            "block_size": size,
            "kv_dtype": self.config.kv_dtype or "",
            "blocks_total": count,
            "delta_from": 0,
            "seq": 0,
            "kv_blocks": kv_blocks,
        }

    def adopt_prefix(self, record: dict,
                     timeout: float | None = None) -> int:
        """Ingest a keeper prefix record into the LOCAL cache: fetch
        the KV blocks over the transfer plane (the same consumer half
        prefill handoff and checkpoint restore use) and register them
        at refcount 0 -- straight into the reclaimable cached tier, so
        an imported prefix can never pin pool capacity a live request
        needs.  Returns the number of blocks registered (0 on any
        failure or when the chain is already resident: pre-warming is
        best-effort by design)."""
        if self.prefix is None:
            return 0
        if int(record.get("block_size", 0)) != self.blocks.block_size:
            return 0
        prompt = np.asarray(record.get("prompt", ()),
                            np.int32).reshape(-1)
        hashes = chain_hashes(prompt, self.blocks.block_size)
        needed = len(record.get("kv_blocks") or [])
        if not hashes or needed != len(hashes):
            return 0
        if self.prefix.lookup(hashes) == len(hashes):
            return 0                  # already fully resident

        def fallback(reason: str) -> None:
            _LOGGER.info("prefix adopt skipped: %s", reason)

        with on_stream(self.stream):
            granted, migrated = self._ingest_kv_blocks(
                record, needed, timeout, fallback, "prefix")
        if granted is None:
            return 0
        indexed = self.prefix.register(hashes, granted, depth=0,
                                       refcount=0)
        self.counters["kv_migrated_bytes"] += migrated
        self._bump("decode.kv_migrated_bytes", migrated)
        self._update_gauges()
        return len(indexed)

    # -- the device steps --------------------------------------------------

    def _tensor(self, array) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _model(self, draft: bool):
        if draft:
            return self.draft_params, self.draft_config, self.draft_pool
        return self.params, self.config, self.pool

    def _prefill_chunk(self, draft: bool, chunk, table_row, start: int,
                       write_blocks, write_offsets) -> np.ndarray:
        """paged_prefill_chunk (eager: once per chunk) -> greedy (C,)."""
        params, config, pool = self._model(draft)
        self._note_signature(("chunk", "draft" if draft else "target",
                              chunk.shape[1]))
        _, greedy = paged_prefill_chunk(
            params, config, pool, self._tensor(chunk),
            self._tensor(table_row), int(start),
            self._tensor(write_blocks), self._tensor(write_offsets))
        return greedy.cpu().numpy()

    def _fixed_step(self, draft: bool, step, *arrays) -> np.ndarray:
        """A fixed-shape step over all slots (paged_decode_step or
        paged_verify_step): replayed from its captured graph on the card,
        run eagerly on the CPU.  Returns the greedy tokens on the host."""
        params, config, pool = self._model(draft)
        key = ("draft" if draft else "target", step.__name__,
               arrays[2].shape[1])
        self._note_signature(key)
        if not self._graphs:
            _, greedy = step(params, config, pool,
                             *(self._tensor(array) for array in arrays))
            return greedy.cpu().numpy()
        captured = self._captured.get(key)
        if captured is None:
            captured = self._captured[key] = _CapturedStep(
                step, params, config, pool,
                [array.shape for array in arrays])
        return captured.replay(arrays)

    # -- completion --------------------------------------------------------

    def _finished(self, request: _Request) -> bool:
        if len(request.generated) >= request.max_new:
            return True
        return (self.eos_id is not None
                and request.generated[-1] == self.eos_id)

    def _surface(self, report: StepReport, request: _Request) -> None:
        while request.emitted_upto < len(request.generated):
            offset = request.emitted_upto
            report.emitted.append(
                (request.request_id, offset, request.generated[offset]))
            request.emitted_upto = offset + 1

    def _complete(self, index: int) -> Completion:
        slot = self.slots[index]
        request = slot.request
        now = time.perf_counter()
        pad = self.eos_id if self.eos_id is not None else 0
        tokens = np.full((request.max_new,), pad, np.int32)
        tokens[:len(request.generated)] = request.generated
        self._release_slot(index)
        self.counters["completed"] += 1
        self._bump("decode.completed", 1)
        admitted_at = request.admitted_at or now
        first_at = request.first_token_at or now
        stats = {
            "queue_wait_s": admitted_at - request.submitted_at,
            "prefill_s": first_at - admitted_at,
            "ttft_s": first_at - request.submitted_at,
            "decode_steps": request.decode_steps,
            "preemptions": request.preemptions,
            "total_s": now - request.submitted_at,
            "tokens": len(request.generated),
        }
        if self.prefix is not None:
            # rides the completion row into the engine trace span
            # (observe/telemetry.py) so `aiko tune` can tell a
            # cache-bound prefill floor from a compute-bound one
            stats["prefix_blocks"] = slot.shared
        if self._registry is not None:
            self._registry.histogram("decode.queue_wait_s").record(
                stats["queue_wait_s"])
            self._registry.histogram("decode.prefill_s").record(
                stats["prefill_s"])
            self._registry.histogram("decode.ttft_s").record(
                stats["ttft_s"])
            self._registry.histogram("decode.total_s").record(
                stats["total_s"])
            self._registry.histogram("decode.steps").record(
                stats["decode_steps"])
        return Completion(request.request_id, tokens, stats)

    # -- observability -----------------------------------------------------

    @property
    def compile_count(self) -> int:
        """Distinct step signatures this engine has run or captured
        (prefill buckets, chunk sizes, the decode step, each verify
        window; target and draft apart).  The zero-recompile acceptance
        assertion reads deltas of this across an admit/evict storm."""
        return self.counters["compiles"]

    def _note_signature(self, key: tuple) -> None:
        if key not in self._signatures:
            self._signatures.add(key)
            self.counters["compiles"] += 1
            self._bump("decode.compiles", 1)

    def _bump(self, name: str, amount: int) -> None:
        if self._registry is not None:
            self._registry.counter(name).inc(amount)

    def _update_gauges(self) -> None:
        if self.prefix is not None:
            # the cache owns the eviction count (reclaims happen inside
            # PrefixCache.allocate/_trim); sync the engine counter here
            # so stats()/telemetry see one authoritative number
            delta = (self.prefix.evictions
                     - self.counters["prefix_evictions"])
            if delta > 0:
                self.counters["prefix_evictions"] += delta
                self._bump("decode.prefix_evictions", delta)
        if self._registry is None:
            return
        self._registry.gauge("decode.active_slots").set(
            sum(1 for slot in self.slots if slot is not None))
        self._registry.gauge("decode.free_blocks").set(
            self.blocks.free_count)
        self._registry.gauge("decode.waiting").set(len(self.waiting))
        if self.prefix is not None:
            self._registry.gauge("decode.prefix_cached_blocks").set(
                self.prefix.cached_count)

    def stats(self) -> dict:
        stats = {
            "active_slots": sum(1 for slot in self.slots
                                if slot is not None),
            "free_blocks": self.blocks.free_count,
            "waiting": len(self.waiting),
            "slots": self.slots_n,
            "blocks": self.blocks.capacity,
            "block_size": self.blocks.block_size,
            **self.counters,
        }
        if self.prefill_chunk is not None:
            stats["prefill_chunk_size"] = self.prefill_chunk
        if self.prefix is not None:
            stats["prefix_cached_blocks"] = self.prefix.cached_count
            stats["prefix_shared_blocks"] = self.prefix.shared_count
        if self.draft_params is not None:
            windows = max(self.counters["spec_windows"], 1)
            spec_total = self.spec_draft_s + self.spec_verify_s
            stats["spec_k"] = self.spec_k
            # mean emitted tokens per verify window (ceiling: k + 1)
            stats["accepted_len_mean"] = round(
                self.counters["spec_accepted"] / windows, 3)
            # share of speculative wall time spent in the draft
            # (ingest + proposal run) vs target verification
            stats["draft_overhead_frac"] = round(
                self.spec_draft_s / max(spec_total, 1e-9), 3)
        return stats
