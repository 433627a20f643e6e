# Storage service: sqlite-backed key-value actor + the request/response
# idioms.
#
# Capability parity with the reference storage layer (reference:
# src/aiko_services/main/storage.py:49-103): a sqlite actor and the two
# generic invocation idioms -- do_command (discover a service by filter,
# proxy, invoke) and do_request (command + paged "(item_count N)" response
# collection on a dedicated response topic).
#
# The sqlite KV core is split out as KeyValueStore so non-actor layers
# (the serving gateway's crash journal, serve/journal.py) persist
# through the SAME backend without paying the wire: one schema, one
# durability story, whether keys arrive over `/in` or from the gateway
# tick.

from __future__ import annotations

import json
import sqlite3
import threading

from ..utils import generate, get_logger, parse, parse_number
from .actor import Actor
from .proxy import make_proxy
from .service import ServiceFilter
from .share import ServicesCache, services_cache_create_singleton

__all__ = ["KeyValueStore", "Storage", "do_command", "do_request"]

_LOGGER = get_logger("storage")
SERVICE_PROTOCOL_STORAGE = "storage:0"


class KeyValueStore:
    """The sqlite key-value core shared by the Storage actor and the
    gateway journal: JSON values under TEXT keys, with a batched
    write path (`write_batch`: one transaction per journal tick, not
    one commit per key) and prefix scans for replay."""

    def __init__(self, database_path: str = ":memory:"):
        self.database_path = database_path
        self._connection = sqlite3.connect(
            database_path, check_same_thread=False)
        self._lock = threading.Lock()
        self._connection.execute(
            "CREATE TABLE IF NOT EXISTS store "
            "(key TEXT PRIMARY KEY, value TEXT)")
        self._connection.commit()

    def save(self, key, value) -> None:
        with self._lock:
            self._connection.execute(
                "INSERT OR REPLACE INTO store (key, value) VALUES (?, ?)",
                (str(key), json.dumps(value)))
            self._connection.commit()

    def write_batch(self, items: dict, deletes=()) -> None:
        """Upserts + deletes in ONE transaction: a failure mid-batch
        rolls back, so the store never holds a half-applied tick (an
        unencodable value must not leave its batch-siblings pending on
        the shared connection for the NEXT commit to sweep in)."""
        with self._lock:
            try:
                for key, value in items.items():
                    self._connection.execute(
                        "INSERT OR REPLACE INTO store (key, value) "
                        "VALUES (?, ?)", (str(key), json.dumps(value)))
                for key in deletes:
                    self._connection.execute(
                        "DELETE FROM store WHERE key = ?", (str(key),))
                self._connection.commit()
            except Exception:
                self._connection.rollback()
                raise

    def count(self, prefix: str = "") -> int:
        with self._lock:
            if prefix:
                row = self._connection.execute(
                    "SELECT COUNT(*) FROM store WHERE key LIKE ?",
                    (prefix + "%",)).fetchone()
            else:
                row = self._connection.execute(
                    "SELECT COUNT(*) FROM store").fetchone()
        return int(row[0])

    def load(self, key):
        """Decoded value, or None when absent."""
        with self._lock:
            row = self._connection.execute(
                "SELECT value FROM store WHERE key = ?",
                (str(key),)).fetchone()
        return None if row is None else json.loads(row[0])

    def load_text(self, key) -> str | None:
        """Stored JSON text (the Storage actor's wire unit)."""
        with self._lock:
            row = self._connection.execute(
                "SELECT value FROM store WHERE key = ?",
                (str(key),)).fetchone()
        return None if row is None else row[0]

    def delete(self, key) -> None:
        with self._lock:
            self._connection.execute(
                "DELETE FROM store WHERE key = ?", (str(key),))
            self._connection.commit()

    def keys(self, prefix: str = "") -> list:
        with self._lock:
            if prefix:
                rows = self._connection.execute(
                    "SELECT key FROM store WHERE key LIKE ? ORDER BY key",
                    (prefix + "%",)).fetchall()
            else:
                rows = self._connection.execute(
                    "SELECT key FROM store ORDER BY key").fetchall()
        return [row[0] for row in rows]

    def items(self, prefix: str = "") -> list:
        """[(key, decoded value)] sorted by key."""
        with self._lock:
            if prefix:
                rows = self._connection.execute(
                    "SELECT key, value FROM store WHERE key LIKE ? "
                    "ORDER BY key", (prefix + "%",)).fetchall()
            else:
                rows = self._connection.execute(
                    "SELECT key, value FROM store ORDER BY key").fetchall()
        return [(key, json.loads(value)) for key, value in rows]

    def close(self) -> None:
        with self._lock:
            self._connection.close()


class Storage(Actor):
    """Key-value store over sqlite.  Commands on /in:
    (save key value) | (load key response_topic) | (delete key) |
    (keys response_topic)."""

    def __init__(self, process, name: str = "storage",
                 database_path: str = ":memory:"):
        super().__init__(process, name, protocol=SERVICE_PROTOCOL_STORAGE)
        self.store = KeyValueStore(database_path)

    def save(self, key, value) -> None:
        self.store.save(key, value)

    def load(self, key, response_topic) -> None:
        text = self.store.load_text(key)
        items = [] if text is None else [text]  # stored JSON text
        self._respond(response_topic, items)

    def delete(self, key) -> None:
        self.store.delete(key)

    def keys(self, response_topic) -> None:
        self._respond(response_topic, self.store.keys())

    def _respond(self, response_topic, items) -> None:
        """items are wire-ready strings (keys, or stored JSON text)."""
        publish = self.process.publish
        publish(response_topic, generate("item_count", [len(items)]))
        for item in items:
            publish(response_topic, generate("item", [item]))

    def stop(self) -> None:
        self.store.close()
        super().stop()


def do_command(process, service_filter: ServiceFilter, command_handler,
               services_cache: ServicesCache | None = None):
    """Discover the first service matching the filter, then invoke
    command_handler(proxy) (reference storage.py:67-81).  Returns the
    ServicesCache handler so callers may detach it."""
    cache = services_cache or services_cache_create_singleton(process)
    invoked = []

    def on_service(command, fields):
        if command == "add" and not invoked:
            invoked.append(fields)
            cache.remove_handler(on_service)  # one-shot
            command_handler(make_proxy(process, fields.topic_path))

    cache.add_handler(on_service, service_filter)
    return on_service


def do_request(process, service_filter: ServiceFilter, request_handler,
               response_handler, item_types=("item",),
               services_cache: ServicesCache | None = None) -> str:
    """do_command + paged response collection (reference storage.py:87-103):
    request_handler(proxy, response_topic) issues the command; responses
    arrive as "(item_count N)" then N item payloads; response_handler(items)
    fires once all pages arrive.  Returns the response topic."""
    import itertools
    sequence = getattr(do_request, "_sequence", None)
    if sequence is None:
        sequence = do_request._sequence = itertools.count()
    response_topic = (f"{process.topic_path_process}/0/request/"
                      f"{next(sequence)}")
    collected = []
    expected = [None]

    def on_response(topic, payload):
        command, parameters = parse(payload)
        if command == "item_count" and parameters:
            expected[0] = int(parse_number(parameters[0], 0))
        elif command in item_types:
            collected.append(parameters[0] if len(parameters) == 1
                             else list(parameters))
        if expected[0] is not None and len(collected) >= expected[0]:
            process.remove_message_handler(on_response, response_topic)
            response_handler(collected)

    process.add_message_handler(on_response, response_topic)
    do_command(process, service_filter,
               lambda proxy: request_handler(proxy, response_topic),
               services_cache=services_cache)
    return response_topic
