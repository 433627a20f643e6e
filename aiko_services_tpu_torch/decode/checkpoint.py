# Warm KV failover: incremental decode-state checkpointing.
#
# Replica failover loses no frame, but recovery of a DECODE replica is
# cold without this module: the gateway replays every migrated stream's
# frames and the survivor re-prefills every in-flight prompt, and a long
# prompt's prefill is compute-bound, so a crash under a
# continuous-batching storm becomes a re-prefill convoy that stalls every
# co-scheduled decode slot.  adopt_request already ingests KV blocks
# shipped over the transfer plane bit-identically; this module turns it
# from a prefill->decode hop into a crash-recovery path:
#
#   DecodeCheckpointer  rides the engine pump: every `checkpoint_every`
#                       ticks (or sooner, when a slot has generated
#                       `max_checkpoint_lag` tokens since its last
#                       snapshot) it ships ONLY the KV blocks written
#                       since the previous snapshot -- KV is
#                       append-only, so the delta is the partial last
#                       block plus anything after it -- together with
#                       the slot's cursor, generated tokens,
#                       emitted_upto, and admission config, as the same
#                       JSON-safe raw-descriptor trees PrefillEngine
#                       exports
#   CheckpointKeeper    the standby holding the snapshots: ingests each
#                       delta OFF the engine's event loop (a worker
#                       thread pulls the bytes through fetch_many's
#                       one-connection-per-peer path) and serves
#                       restore() by re-offering the merged blocks on
#                       its own transfer server -- so the checkpoint
#                       survives the replica that wrote it
#   CheckpointPolicy    the AIKO409 grammar (checkpoint_every / keeper /
#                       recovery_rate / max_checkpoint_lag) through the
#                       shared directive core, so `aiko lint` and
#                       construction are the same check
#
# DecodeEngine.restore_request (engine.py) consumes a keeper's restore
# record: the snapshot's blocks scatter into a free slot, the cursor
# and token list resume, and greedy determinism re-decodes the (at
# most `max_checkpoint_lag`) tokens generated after the snapshot
# bit-identically -- no re-prefill.  EVERY degraded path -- dead
# keeper, expired snapshot, block-size mismatch, exhausted pool --
# falls back to the existing replay re-prefill, never losing a frame.
#
# Counterpart of aiko_services_tpu/decode/checkpoint.py: the same
# grammar, keeper, registry and snapshot schema.  Two differences in how
# the checkpointer ships.  A tick gathers EVERY due slot's delta blocks
# with one index_select per pool leaf and one copy into pinned host
# memory (decode/disagg.py gather_pool_blocks), then offers all their
# per-block host views at once: one device->host wait and one offer per
# leaf per tick instead of one of each per slot per leaf.  And only the
# transfer plane's failures (KeyError, ValueError -- TransferError among
# them -- and OSError) degrade the due slots to "previous snapshot
# kept": a device fault in the gather raises out of tick(), as a fault
# in the step does.  The snapshots and the keeper are the JAX
# package's.

from __future__ import annotations

import queue
import threading
import time

from ..analyze.grammar import DirectiveGrammar, Field, GrammarError
from ..pipeline.transfer import fetch_many, get_transfer_server
from ..utils import get_logger

__all__ = [
    "CHECKPOINT_GRAMMAR", "CHECKPOINT_SCHEMA", "CheckpointKeeper",
    "CheckpointPolicy", "DecodeCheckpointer", "get_keeper",
    "register_keeper", "reset_keepers",
]

_LOGGER = get_logger("decode_checkpoint")

CHECKPOINT_SCHEMA = "aiko.decode_ckpt/1"

DEFAULT_CHECKPOINT_EVERY = 8     # engine ticks between snapshots
DEFAULT_MAX_CHECKPOINT_LAG = 32  # tokens a crash may force re-decoding
DEFAULT_KEEPER_MAX_AGE_S = 120.0

CHECKPOINT_GRAMMAR = DirectiveGrammar(
    "checkpoint policy",
    options={
        "checkpoint_every": Field("int", minimum=1),
        "keeper": Field("str"),
        "recovery_rate": Field("float", minimum=0.0),
        "max_checkpoint_lag": Field("int", minimum=1),
    })


class CheckpointPolicy:
    """Parsed checkpoint spec (rule code AIKO409).  Two scopes share
    one grammar, mirroring the disagg policy's role= split:

      engine side   (LMGenerate parameter `checkpoint`)
                    checkpoint_every / max_checkpoint_lag / keeper --
                    the snapshot cadence and where deltas ship
      gateway side  (Gateway parameter `checkpoint`, definition
                    parameter `checkpoint_policy`)
                    recovery_rate / keeper -- failover pacing and the
                    keeper name the restore hints (and the journal)
                    carry

    `keeper` is legal on both: the fleet keeper address is one name.
    """

    __slots__ = ("checkpoint_every", "keeper", "recovery_rate",
                 "max_checkpoint_lag", "present", "spec")

    def __init__(self):
        self.checkpoint_every = DEFAULT_CHECKPOINT_EVERY
        self.keeper = ""
        self.recovery_rate = 0.0          # 0 = unpaced replay
        self.max_checkpoint_lag = DEFAULT_MAX_CHECKPOINT_LAG
        self.present: set = set()
        self.spec = ""

    @classmethod
    def parse(cls, spec) -> "CheckpointPolicy":
        """Parse a spec (directive string, dict of the same keys, or
        None/"" for all defaults)."""
        policy = cls()
        if spec is None or spec == "" or spec is True:
            return policy
        if isinstance(spec, CheckpointPolicy):
            return spec
        parsed = CHECKPOINT_GRAMMAR.parse(spec)
        if not isinstance(spec, dict):
            policy.spec = str(spec)
        for key, value in parsed.options.items():
            setattr(policy, key, value)
            policy.present.add(key)
        return policy

    def validate_gateway(self) -> None:
        """A gateway spec paces recovery and names the keeper; the
        snapshot cadence belongs to the replica that decodes."""
        engine_side = self.present & {"checkpoint_every",
                                      "max_checkpoint_lag"}
        if engine_side:
            raise GrammarError(
                f"checkpoint policy: {sorted(engine_side)} are "
                f"engine-side directives; a gateway spec carries "
                f"recovery_rate/keeper only")

    def validate_engine(self) -> None:
        if "recovery_rate" in self.present:
            raise GrammarError(
                "checkpoint policy: recovery_rate is a gateway-side "
                "directive (failover pacing); an engine spec carries "
                "checkpoint_every/max_checkpoint_lag/keeper")

    def __repr__(self):
        return (f"CheckpointPolicy(every={self.checkpoint_every}, "
                f"keeper={self.keeper!r}, "
                f"recovery_rate={self.recovery_rate}, "
                f"max_lag={self.max_checkpoint_lag})")


# -- keeper registry ---------------------------------------------------------
#
# Keepers are addressed by NAME: the engine-side `keeper=` directive,
# the gateway's restore hints, and the journal all carry the name, and
# the adopting element resolves it here.  The registry is per
# interpreter -- exactly the scope the loopback chaos harness and the
# in-process replica fleet share; a wire-addressable keeper actor can
# layer on top without changing the engine-side contract.

_KEEPERS: dict[str, "CheckpointKeeper"] = {}
_KEEPERS_LOCK = threading.Lock()


def register_keeper(name: str, keeper: "CheckpointKeeper") -> None:
    with _KEEPERS_LOCK:
        _KEEPERS[str(name)] = keeper


def get_keeper(name: str) -> "CheckpointKeeper | None":
    with _KEEPERS_LOCK:
        return _KEEPERS.get(str(name))


def reset_keepers() -> None:
    with _KEEPERS_LOCK:
        keepers = list(_KEEPERS.values())
        _KEEPERS.clear()
    for keeper in keepers:
        keeper.stop()


def _request_key(request_id):
    """Snapshot keys must survive a JSON hop: the element keys requests
    by (stream_id, frame_id, row) tuples, which the codec renders as
    lists."""
    if isinstance(request_id, (list, tuple)):
        return tuple(request_id)
    return request_id


class _Kept:
    """One request's merged checkpoint state on the keeper."""

    __slots__ = ("meta", "blocks", "seq", "stored_at")

    def __init__(self):
        self.meta: dict = {}
        self.blocks: list = []      # block index -> {leaf: ndarray}
        self.seq = -1
        self.stored_at = 0.0


class CheckpointKeeper:
    """Holds decode-state snapshots OFF the replica that wrote them.

    store() only enqueues: a worker thread pulls each delta's bytes
    through fetch_many (one connection per producing peer) and merges
    it into the per-request block list, so the engine's event loop
    never waits on the keeper's network.  restore() re-offers the
    merged blocks on THIS process's transfer server and returns a
    JSON-safe record shaped like a prefill handoff (plus the resume
    state), which DecodeEngine.restore_request consumes.  Snapshots
    older than `max_age_s` are stale -- restore raises KeyError and
    the caller falls back to a re-prefill."""

    def __init__(self, name: str = "", max_age_s: float | None = None,
                 register: bool = True):
        self.name = str(name)
        self.max_age_s = float(max_age_s if max_age_s is not None
                               else DEFAULT_KEEPER_MAX_AGE_S)
        self._kept: dict = {}
        self._lock = threading.Lock()
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        self.counters = {"stored": 0, "store_errors": 0, "dropped": 0,
                         "restored": 0, "bytes": 0, "expired": 0}
        self._stores_since_sweep = 0
        self._worker = threading.Thread(
            target=self._drain, name=f"ckpt_keeper:{self.name}",
            daemon=True)
        self._worker.start()
        if register and self.name:
            register_keeper(self.name, self)

    # -- ingest (async, off the engine loop) ---------------------------

    def store(self, snapshot: dict) -> None:
        """Enqueue one snapshot delta for ingestion.  Never blocks on
        the network: the caller is the engine pump."""
        if not self._closed:
            self._queue.put(("store", snapshot))

    def drop(self, request_id) -> None:
        if not self._closed:
            self._queue.put(("drop", _request_key(request_id)))

    def _drain(self) -> None:
        while True:
            kind, payload = self._queue.get()
            try:
                if kind == "stop":
                    return
                if kind == "drop":
                    with self._lock:
                        if self._kept.pop(payload, None) is not None:
                            self.counters["dropped"] += 1
                elif kind == "store":
                    self._ingest(payload)
                    # fenced/cancelled streams never send a clean drop:
                    # the periodic sweep bounds keeper memory to one
                    # max_age window of live traffic
                    self._stores_since_sweep += 1
                    if self._stores_since_sweep >= 64:
                        self._stores_since_sweep = 0
                        self.sweep()
            except Exception as error:
                # a failed delta (dead producer, expired keys) keeps
                # the PREVIOUS snapshot intact: restore degrades to a
                # longer re-decode, never to corruption
                self.counters["store_errors"] += 1
                _LOGGER.info("keeper %s: snapshot ingest failed "
                             "(previous snapshot kept): %s", self.name,
                             error)
            finally:
                self._queue.task_done()

    def _ingest(self, snapshot: dict) -> None:
        key = _request_key(snapshot["request_id"])
        blocks = snapshot.get("kv_blocks") or []
        delta_from = int(snapshot.get("delta_from", 0))
        blocks_total = int(snapshot.get("blocks_total",
                                        delta_from + len(blocks)))
        names = sorted(blocks[0]) if blocks else []
        descriptors = [block[name] for block in blocks
                       for name in names]
        arrays = fetch_many(descriptors) if descriptors else []
        fetched = []
        for index in range(len(blocks)):
            fetched.append({
                name: arrays[index * len(names) + offset]
                for offset, name in enumerate(names)})
        with self._lock:
            kept = self._kept.get(key)
            seq = int(snapshot.get("seq", 0))
            if kept is None or seq <= kept.seq and seq == 0:
                # seq 0 = a fresh request (or a preempted one restarting
                # from scratch): discard any previous incarnation
                kept = self._kept[key] = _Kept()
            elif seq <= kept.seq:
                return  # stale duplicate delivery
            elif seq != kept.seq + 1:
                # a delta between kept.seq and this one FAILED to
                # ingest: the block holding the last kept position was
                # due a re-ship that never landed, so everything from
                # it up to this delta's start is STALE.  Null the gap
                # -- restore's completeness check then degrades the
                # request to a re-prefill instead of silently serving
                # corrupt KV (the bit-identity guarantee)
                block_size = max(int(kept.meta.get("block_size", 1)), 1)
                stale_from = int(kept.meta.get("position", 0)) \
                    // block_size
                for index in range(stale_from,
                                   min(delta_from, len(kept.blocks))):
                    kept.blocks[index] = None
            kept.seq = seq
            kept.stored_at = time.monotonic()
            kept.meta = {k: v for k, v in snapshot.items()
                         if k != "kv_blocks"}
            if len(kept.blocks) < blocks_total:
                kept.blocks.extend(
                    [None] * (blocks_total - len(kept.blocks)))
            del kept.blocks[blocks_total:]
            for offset, block in enumerate(fetched):
                kept.blocks[delta_from + offset] = block
            self.counters["stored"] += 1
            self.counters["bytes"] += sum(
                array.nbytes for block in fetched
                for array in block.values())

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait (bounded) for every queued delta to be ingested --
        restore calls this so a just-shipped snapshot is visible, and
        deterministic tests pin ingestion down with it."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.unfinished_tasks == 0:
                return True
            time.sleep(0.002)
        return self._queue.unfinished_tasks == 0

    # -- restore (the failover path) -----------------------------------

    def restore(self, request_id) -> dict:
        """Build the restore record for one request: merged blocks
        re-offered on this process's transfer server + the resume
        state.  Raises KeyError when the keeper holds no (complete,
        fresh) snapshot -- the caller's re-prefill fallback."""
        self.flush(timeout=2.0)
        key = _request_key(request_id)
        with self._lock:
            kept = self._kept.get(key)
            if kept is None:
                raise KeyError(f"no checkpoint for {request_id!r}")
            if (self.max_age_s > 0
                    and time.monotonic() - kept.stored_at
                    > self.max_age_s):
                del self._kept[key]
                self.counters["expired"] += 1
                raise KeyError(f"checkpoint for {request_id!r} expired")
            if any(block is None for block in kept.blocks):
                raise KeyError(
                    f"checkpoint for {request_id!r} is incomplete "
                    f"(a delta ingest failed)")
            meta = dict(kept.meta)
            blocks = list(kept.blocks)
        server = get_transfer_server()
        kv_blocks = []
        total = 0
        for block in blocks:
            entry = {}
            for name in sorted(block):
                array = block[name]
                total += array.nbytes
                entry[name] = server.offer(array)
            kv_blocks.append(entry)
        self.counters["restored"] += 1
        record = {
            "schema": CHECKPOINT_SCHEMA,
            "request_id": meta.get("request_id"),
            "prompt": meta.get("prompt", []),
            "generated": meta.get("generated", []),
            "emitted_upto": meta.get("emitted_upto", 0),
            "max_new": meta.get("max_new", 0),
            "true_len": meta.get("true_len", 0),
            "position": meta.get("position", 0),
            "block_size": meta.get("block_size", 0),
            "kv_dtype": meta.get("kv_dtype", ""),
            "kv_bytes": int(total),
            "kv_blocks": kv_blocks,
        }
        return record

    # -- bookkeeping ---------------------------------------------------

    def sweep(self) -> int:
        """Drop snapshots older than max_age_s (fenced streams never
        send a clean drop; expiry bounds keeper memory)."""
        if self.max_age_s <= 0:
            return 0
        horizon = time.monotonic() - self.max_age_s
        with self._lock:
            stale = [key for key, kept in self._kept.items()
                     if kept.stored_at < horizon]
            for key in stale:
                del self._kept[key]
            self.counters["expired"] += len(stale)
        return len(stale)

    def kept_count(self) -> int:
        with self._lock:
            return len(self._kept)

    def kept_blocks(self, request_id) -> int:
        with self._lock:
            kept = self._kept.get(_request_key(request_id))
            return 0 if kept is None else len(kept.blocks)

    def stats(self) -> dict:
        with self._lock:
            kept = len(self._kept)
        return {"kept": kept, **self.counters}

    def stop(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(("stop", None))


class DecodeCheckpointer:
    """Ships incremental decode-state snapshots from one DecodeEngine
    to a CheckpointKeeper.

    tick() runs after each engine step, ON the engine's event loop, but
    does only host work: a device->host gather of the delta blocks plus
    transfer-plane offers (the keeper pulls the bytes on its own
    thread).  A slot is due when `checkpoint_every` ticks passed since
    its last snapshot OR it has generated `max_checkpoint_lag` tokens
    since -- the forced snapshot is what makes max_checkpoint_lag a
    hard bound on crash-time re-decode, speculation bursts included."""

    def __init__(self, engine, policy: CheckpointPolicy,
                 keeper: "CheckpointKeeper | str | None" = None,
                 registry=None, node: str = "",
                 on_checkpoint=None):
        self.engine = engine
        self.policy = policy
        self._keeper = keeper if keeper is not None else policy.keeper
        self._registry = registry
        self.node = node or "decode"
        # on_checkpoint(node, elapsed_s, bytes): the telemetry seam
        # (PipelineTelemetry.record_checkpoint -- histogram + a global
        # engine span the tune loader classifies checkpoint-bound from)
        self._on_checkpoint = on_checkpoint
        self.ticks = 0
        self._state: dict = {}
        # checkpoint_s: host seconds spent gathering and offering
        # snapshots (the checkpointer's share of the engine's pace)
        self.counters = {"checkpoints": 0, "checkpoint_bytes": 0,
                         "checkpoint_errors": 0, "checkpoint_s": 0.0}
        self._warned_keeper = False

    def keeper(self) -> CheckpointKeeper | None:
        if isinstance(self._keeper, CheckpointKeeper):
            return self._keeper
        keeper = get_keeper(str(self._keeper)) if self._keeper else None
        if keeper is None and not self._warned_keeper:
            self._warned_keeper = True
            _LOGGER.warning(
                "checkpoint keeper %r not registered: snapshots are "
                "skipped (failover degrades to re-prefill)",
                self._keeper)
        return keeper

    def _bump(self, name: str, amount) -> None:
        if self._registry is not None:
            self._registry.counter(name).inc(amount)

    def tick(self) -> int:
        """One cadence tick; returns the number of snapshots shipped.
        When the transfer plane refuses the tick's offers, every due
        slot keeps the keeper's previous snapshot, which only lengthens
        the re-decode on restore; a device fault in the gather raises."""
        self.ticks += 1
        engine = self.engine
        if self.ticks % 64 == 0:
            # prune state for requests no longer anywhere in the
            # engine (cancelled / fenced streams never call forget):
            # entries hold the full _Request, so a long-lived replica
            # must not leak one per dead stream.  Periodic, not
            # per-tick: the live-set rebuild is O(slots + waiting) and
            # the hot loop should not pay it every step.  The keeper
            # side is bounded by its own sweep
            live = {_request_key(slot.request.request_id)
                    for slot in engine.slots if slot is not None}
            live |= {_request_key(request.request_id)
                     for request in engine.waiting}
            for key in [key for key in self._state
                        if key not in live]:
                del self._state[key]
        due = []
        for index, slot in enumerate(engine.slots):
            if slot is None or slot.prefilling:
                continue
            request = slot.request
            key = _request_key(request.request_id)
            entry = self._state.get(key)
            if (entry is None or entry["request"] is not request
                    or len(request.generated) < entry["gen"]):
                # fresh slot, or a preempted request restarting from
                # scratch: the next snapshot re-ships from block 0
                entry = self._state[key] = {
                    "request": request, "gen": 0, "pos": 0,
                    "tick": self.ticks, "seq": -1}
            lag_tokens = len(request.generated) - entry["gen"]
            lag_ticks = self.ticks - entry["tick"]
            if lag_tokens <= 0:
                continue
            if (lag_ticks < self.policy.checkpoint_every
                    and lag_tokens < self.policy.max_checkpoint_lag):
                continue
            due.append((index, slot, entry, lag_ticks))
        if not due:
            return 0
        return self._snapshot(due)

    def _snapshot(self, due: list) -> int:
        """Ship one snapshot per due slot: ONE gather of every due
        slot's delta blocks (decode/disagg.py gather_pool_blocks), ONE
        offer of all their host views, then a snapshot per slot.  The
        gather is not guarded: an error on the device propagates."""
        keeper = self.keeper()
        if keeper is None:
            return 0
        from .disagg import gather_pool_blocks, offer_blocks
        from .engine import on_stream
        engine = self.engine
        started = time.perf_counter()
        plans = []
        block_ids = []
        for index, slot, entry, lag_ticks in due:
            position = int(engine.positions[index])
            coverage = engine.blocks.blocks_for(position)
            # KV is append-only: everything below the last snapshot's
            # position is immutable, so the delta is the (possibly
            # partial, hence re-shipped) block holding that position
            # plus every block after it
            delta_from = entry["pos"] // engine.blocks.block_size
            delta = slot.blocks[delta_from:coverage]
            plans.append((slot, entry, lag_ticks, position, coverage,
                          delta_from, len(block_ids), len(delta)))
            block_ids.extend(delta)
        with on_stream(engine.stream):
            host = gather_pool_blocks(engine.pool, block_ids)
        try:
            offered, offered_bytes = offer_blocks(host)
        except (KeyError, ValueError, OSError) as error:
            # the transfer plane refused the offers (TransferError is a
            # ValueError; OSError: no transfer server could bind)
            self.counters["checkpoint_errors"] += len(plans)
            self._bump("decode.checkpoint_errors", len(plans))
            _LOGGER.info("checkpoint of %d slot(s) failed (previous "
                         "snapshots kept): %s", len(plans), error)
            return 0
        block_bytes = offered_bytes // max(len(offered), 1)
        shipped_bytes = 0
        for (slot, entry, lag_ticks, position, coverage, delta_from,
             start, count) in plans:
            request = slot.request
            kv_blocks = offered[start:start + count]
            total = block_bytes * count
            snapshot = {
                "schema": CHECKPOINT_SCHEMA,
                "request_id": request.request_id,
                "prompt": [int(token) for token in request.prompt],
                "generated": [int(token) for token in request.generated],
                "emitted_upto": int(request.emitted_upto),
                "max_new": int(request.max_new),
                "true_len": int(slot.true_len),
                "position": position,
                "block_size": engine.blocks.block_size,
                "kv_dtype": engine.config.kv_dtype or "",
                "blocks_total": coverage,
                "delta_from": delta_from,
                "seq": entry["seq"] + 1,
            }
            snapshot["kv_blocks"] = kv_blocks
            keeper.store(snapshot)
            entry.update(gen=len(request.generated), pos=position,
                         tick=self.ticks, seq=entry["seq"] + 1)
            shipped_bytes += total
            self.counters["checkpoints"] += 1
            self.counters["checkpoint_bytes"] += total
            self._bump("decode.checkpoints", 1)
            self._bump("decode.checkpoint_bytes", total)
            if self._registry is not None:
                self._registry.histogram(
                    "decode.checkpoint_lag_ticks").record(lag_ticks)
        elapsed = time.perf_counter() - started
        self.counters["checkpoint_s"] += elapsed
        if self._on_checkpoint is not None:
            self._on_checkpoint(self.node, elapsed, shipped_bytes)
        return len(plans)

    def forget(self, request_id) -> None:
        """A request completed cleanly: drop its snapshots.  Fenced
        streams deliberately do NOT forget -- the keeper's snapshot is
        exactly what the survivor restores from; expiry sweeps the
        strays."""
        key = _request_key(request_id)
        self._state.pop(key, None)
        keeper = self.keeper()
        if keeper is not None:
            keeper.drop(key)

    def stats(self) -> dict:
        return {"ticks": self.ticks, "tracked": len(self._state),
                **self.counters}
