# Gateway crash journal: the write-ahead record that makes the serving
# tier's FRONT DOOR crash-consistent.
#
# Replica failover made replica death invisible (cursor replay + exactly-once
# dedupe), but the gateway itself held the entire routing truth --
# stream->replica pins, replay cursors, dedupe high-water marks,
# admission-bucket levels -- in process memory: one gateway crash
# stranded every active stream, which contradicts the north star of
# serving heavy traffic from millions of users.  This module journals
# that state so a RESTARTED gateway, or a hot STANDBY elected through
# the registrar's retained-topic election (runtime/registrar.py
# RetainedElection), rebuilds the table and resumes with the same
# exactly-once guarantee replica failover already provides:
#
#   what          stream pins, cursors, delivered floors (dedupe),
#                 bucket token levels -- METADATA only, never frame
#                 payloads (clients replay un-acked frame DATA; the
#                 journal guarantees the replay is deduped exactly-once).
#                 With warm KV failover (decode/checkpoint.py) a
#                 record also carries the stream's checkpoint KEEPER
#                 name, so a promoted standby's decode-replica
#                 failovers restore from the same keeper the dead
#                 primary's would have
#   when          stream admission / destruction is journaled at the
#                 NEXT tick boundary along with the hot per-frame state
#                 (cursor, floor), batched per `interval` tick -- one
#                 backend write per tick, not one per frame
#   where         the sqlite KV backend shared with runtime/storage.py
#                 (`backend=sqlite;path=...`), or a retained-topic
#                 mirror (`backend=retained`) when no disk is wanted:
#                 retained messages ARE the broker's journal, and a hot
#                 standby mirrors them continuously so takeover replay
#                 is a dict read, not an I/O wait
#   staleness     every record carries `expires_at` (the stream lease,
#                 refreshed on activity); replay DROPS expired entries
#                 instead of re-pinning dead streams to dead replicas,
#                 and a periodic compaction (`compact_every` ticks)
#                 purges them from the store
#
# Policy grammar (gateway parameter `journal`, rule code AIKO407,
# parsed through the shared directive core exactly like the admission /
# autoscale policies):
#
#   spec      := directive (";" directive)*
#   directive := "interval=" float        flush tick seconds (the crash
#                                         window: state younger than
#                                         one tick may replay from the
#                                         client instead of the journal)
#              | "backend=" sqlite|retained
#              | "path=" str              sqlite database file (required
#                                         for backend=sqlite)
#              | "compact_every=" int     ticks between expiry sweeps
#              | "search_timeout=" float  HA election search window
#              | "replay_timeout=" float  cold-start wait for retained
#                                         replay before adoption
#
# Example: "backend=sqlite;path=/var/aiko/gw.db;interval=0.05"

# The port's own copy of aiko_services_tpu/serve/journal.py (host only,
# jax-free there too): the same grammar, backends and journal.
#

from __future__ import annotations

import json

from ..analyze.grammar import DirectiveGrammar, Field
from ..utils import epoch_now, get_logger

__all__ = ["GatewayJournal", "JournalPolicy", "JOURNAL_GRAMMAR"]

_LOGGER = get_logger("journal")

DEFAULT_INTERVAL_S = 0.05
DEFAULT_COMPACT_EVERY = 50
DEFAULT_SEARCH_TIMEOUT_S = 2.0
DEFAULT_REPLAY_TIMEOUT_S = 0.5

JOURNAL_GRAMMAR = DirectiveGrammar(
    "gateway journal",
    options={
        "interval": Field("float", minimum=0.0),
        "backend": Field("str", choices=("sqlite", "retained")),
        "path": Field("str"),
        "compact_every": Field("int", minimum=1),
        "search_timeout": Field("float", minimum=0.0),
        "replay_timeout": Field("float", minimum=0.0),
    })


class JournalPolicy:
    __slots__ = ("interval_s", "backend", "path", "compact_every",
                 "search_timeout_s", "replay_timeout_s", "spec")

    def __init__(self):
        self.interval_s = DEFAULT_INTERVAL_S
        self.backend = ""          # "" = auto: sqlite when path given
        self.path = ""
        self.compact_every = DEFAULT_COMPACT_EVERY
        self.search_timeout_s = DEFAULT_SEARCH_TIMEOUT_S
        self.replay_timeout_s = DEFAULT_REPLAY_TIMEOUT_S
        self.spec = ""

    @classmethod
    def parse(cls, spec) -> "JournalPolicy":
        """Parse a journal spec (grammar string, dict of the same keys,
        or None/True for all defaults).  Cross-field constraint --
        backend=sqlite without a path -- fails HERE and in offline lint
        (analyze/policies.py check_journal_policy) identically."""
        policy = cls()
        if spec is None or spec == "" or spec is True:
            return policy
        if isinstance(spec, JournalPolicy):
            return spec
        parsed = JOURNAL_GRAMMAR.parse(spec)
        if not isinstance(spec, dict):
            policy.spec = str(spec)
        attributes = {
            "interval": "interval_s",
            "backend": "backend",
            "path": "path",
            "compact_every": "compact_every",
            "search_timeout": "search_timeout_s",
            "replay_timeout": "replay_timeout_s",
        }
        for key, value in parsed.options.items():
            setattr(policy, attributes[key], value)
        if not policy.backend:
            policy.backend = "sqlite" if policy.path else "retained"
        if policy.backend == "sqlite" and not policy.path:
            raise ValueError(
                "journal backend=sqlite requires path=<database file>")
        return policy

    def __repr__(self):
        return (f"JournalPolicy(backend={self.backend!r}, "
                f"path={self.path!r}, interval={self.interval_s})")


def _delta_key(delta: dict) -> str:
    """Zero-padded sequence key: lexical order IS apply order, so both
    backends replay deltas exactly as they were applied."""
    return f"autopilot/{int(delta.get('seq', 0)):010d}"


class _SqliteBackend:
    """Journal over the sqlite KV core shared with the Storage actor
    (runtime/storage.py KeyValueStore): stream records under
    `stream/<id>`, bucket levels under `buckets`, one transaction per
    tick."""

    kind = "sqlite"

    def __init__(self, path: str):
        from ..runtime.storage import KeyValueStore
        self.store = KeyValueStore(path)

    def write_batch(self, records: dict, forgotten, buckets) -> None:
        items = {f"stream/{stream_id}": record
                 for stream_id, record in records.items()}
        if buckets is not None:
            items["buckets"] = buckets
        self.store.write_batch(
            items, [f"stream/{stream_id}" for stream_id in forgotten])

    def write_deltas(self, deltas) -> None:
        self.store.write_batch(
            {_delta_key(delta): delta for delta in deltas}, [])

    def replay_deltas(self) -> list:
        return [record for _, record
                in sorted(self.store.items("autopilot/"))]

    def purge_deltas(self, seqs) -> None:
        self.store.write_batch(
            {}, [f"autopilot/{int(seq):010d}" for seq in seqs])

    def replay(self) -> tuple:
        records = [record for _, record in self.store.items("stream/")]
        return records, (self.store.load("buckets") or {})

    def purge(self, stream_ids) -> None:
        self.store.write_batch(
            {}, [f"stream/{stream_id}" for stream_id in stream_ids])

    def entry_count(self) -> int:
        return self.store.count("stream/")

    def close(self) -> None:
        self.store.close()


class _RetainedBackend:
    """Journal as retained broker messages under `{root}/stream/<id>`
    (+ `{root}/buckets`): the broker IS the store, and every gateway in
    the HA group mirrors the topics continuously, so a hot standby's
    takeover replay reads a warm in-memory dict.  An empty retained
    payload clears an entry (MQTT semantics), exactly as the sqlite
    backend deletes the row."""

    kind = "retained"

    def __init__(self, process, root_topic: str):
        self.process = process
        self.root_topic = root_topic
        self._pattern = f"{root_topic}/#"
        self.mirror: dict[str, dict] = {}     # stream_id -> record
        self.bucket_mirror: dict = {}
        self.delta_mirror: dict[int, dict] = {}   # seq -> delta record
        process.add_message_handler(self._on_message, self._pattern)

    def _on_message(self, topic: str, payload: str) -> None:
        tail = topic[len(self.root_topic) + 1:]
        if tail == "buckets":
            try:
                self.bucket_mirror = json.loads(payload) if payload else {}
            except ValueError:
                _LOGGER.warning("undecodable journal buckets payload")
            return
        if tail.startswith("autopilot/"):
            try:
                seq = int(tail[len("autopilot/"):])
            except ValueError:
                return
            if not payload:
                self.delta_mirror.pop(seq, None)
                return
            try:
                self.delta_mirror[seq] = json.loads(payload)
            except ValueError:
                _LOGGER.warning("undecodable journal delta on %s", topic)
            return
        if not tail.startswith("stream/"):
            return
        stream_id = tail[len("stream/"):]
        if not payload:
            self.mirror.pop(stream_id, None)
            return
        try:
            self.mirror[stream_id] = json.loads(payload)
        except ValueError:
            _LOGGER.warning("undecodable journal record on %s", topic)

    def write_batch(self, records: dict, forgotten, buckets) -> None:
        publish = self.process.publish
        for stream_id, record in records.items():
            publish(f"{self.root_topic}/stream/{stream_id}",
                    json.dumps(record, separators=(",", ":")),
                    retain=True)
        for stream_id in forgotten:
            publish(f"{self.root_topic}/stream/{stream_id}", "",
                    retain=True)
        if buckets is not None:
            publish(f"{self.root_topic}/buckets",
                    json.dumps(buckets, separators=(",", ":")),
                    retain=True)

    def write_deltas(self, deltas) -> None:
        for delta in deltas:
            seq = int(delta.get("seq", 0))
            self.delta_mirror[seq] = delta
            self.process.publish(
                f"{self.root_topic}/{_delta_key(delta)}",
                json.dumps(delta, separators=(",", ":")), retain=True)

    def replay_deltas(self) -> list:
        return [self.delta_mirror[seq]
                for seq in sorted(self.delta_mirror)]

    def purge_deltas(self, seqs) -> None:
        for seq in seqs:
            self.delta_mirror.pop(int(seq), None)
            self.process.publish(
                f"{self.root_topic}/autopilot/{int(seq):010d}", "",
                retain=True)

    def replay(self) -> tuple:
        return list(self.mirror.values()), dict(self.bucket_mirror)

    def purge(self, stream_ids) -> None:
        for stream_id in stream_ids:
            self.mirror.pop(stream_id, None)
            self.process.publish(
                f"{self.root_topic}/stream/{stream_id}", "", retain=True)

    def entry_count(self) -> int:
        return len(self.mirror)

    def close(self) -> None:
        self.process.remove_message_handler(self._on_message,
                                            self._pattern)


class GatewayJournal:
    """Batched write-ahead journal of gateway routing state.  The
    gateway owns dirty-tracking and serialization (it owns the
    streams); this class owns the backend, the per-tick batch, expiry
    on replay, and periodic compaction."""

    def __init__(self, policy: JournalPolicy, process=None,
                 root_topic: str = ""):
        self.policy = policy
        if policy.backend == "sqlite":
            self.backend = _SqliteBackend(policy.path)
        else:
            if process is None or not root_topic:
                raise ValueError(
                    "journal backend=retained needs a process and a "
                    "root topic")
            self.backend = _RetainedBackend(process, root_topic)
        self.appends = 0          # records written across all ticks
        self.ticks = 0            # write() calls that reached the backend
        self.compactions = 0
        self.compacted_entries = 0
        self.delta_appends = 0    # autopilot deltas write-ahead logged
        self._ticks_since_compact = 0

    def write(self, records: dict, forgotten=(), buckets=None) -> int:
        """One journal tick: upsert `records` (stream_id -> record
        dict), delete `forgotten`, refresh `buckets` (None = clean).
        Returns the number of records written.  Empty ticks cost one
        truthiness check -- the idle gateway never touches the
        backend."""
        if not records and not forgotten and buckets is None:
            return 0
        self.backend.write_batch(records, forgotten, buckets)
        self.appends += len(records)
        self.ticks += 1
        self._ticks_since_compact += 1
        if self._ticks_since_compact >= self.policy.compact_every:
            self._ticks_since_compact = 0
            self.compact()
        return len(records)

    def replay(self) -> tuple:
        """(live_records, buckets, dropped_stale): every journaled
        stream whose lease has NOT expired, stale entries purged from
        the store and counted -- a cold start with an old journal must
        not re-pin dead streams to dead replicas."""
        records, buckets = self.backend.replay()
        now = epoch_now()
        live, stale = [], []
        for record in records:
            if float(record.get("expires_at", 0)) > now:
                live.append(record)
            else:
                stale.append(str(record.get("stream_id", "")))
        if stale:
            self.backend.purge(stale)
            _LOGGER.info("journal replay dropped %d expired stream(s)",
                         len(stale))
        return live, buckets, len(stale)

    def write_deltas(self, deltas) -> int:
        """WRITE-AHEAD log autopilot config deltas, synchronously and
        BEFORE they are applied: a crash between the log and the apply
        replays the logged value, a crash before the log never applied
        anything -- either way replay reconstructs the exact applied
        configuration.  Records carry absolute `value`s (never
        increments), so replaying them twice is idempotent."""
        deltas = [dict(delta) for delta in deltas]
        if not deltas:
            return 0
        self.backend.write_deltas(deltas)
        self.delta_appends += len(deltas)
        return len(deltas)

    def replay_deltas(self) -> list:
        """Every journaled autopilot delta in apply (seq) order."""
        return self.backend.replay_deltas()

    def purge_deltas(self, seqs) -> None:
        self.backend.purge_deltas(seqs)

    def compact(self) -> int:
        """Drop expired entries from the store (destroyed streams are
        deleted inline at their tick; this sweep catches streams whose
        lease lapsed without a clean destroy -- a crashed client)."""
        records, _ = self.backend.replay()
        now = epoch_now()
        stale = [str(record.get("stream_id", "")) for record in records
                 if float(record.get("expires_at", 0)) <= now]
        if stale:
            self.backend.purge(stale)
        self.compactions += 1
        self.compacted_entries += len(stale)
        return len(stale)

    def entry_count(self) -> int:
        return self.backend.entry_count()

    def stop(self) -> None:
        self.backend.close()
