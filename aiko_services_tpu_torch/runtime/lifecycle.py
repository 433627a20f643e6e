# LifeCycleManager / LifeCycleClient: manage fleets of worker processes.
#
# Capability parity with the reference lifecycle layer (reference:
# src/aiko_services/main/lifecycle.py:98-456): a manager creates client
# processes (via ProcessManager), each client announces itself with
# "(add_client topic_path id)" on the manager's control topic when it
# reaches the registrar; the manager tracks clients by handshake lease
# (30 s default, lifecycle.py:74-75), watches each client's share via
# ECConsumer, reaps clients whose handshake or deletion lease lapses, and
# detects removals through registrar remove events.

from __future__ import annotations

from ..utils import generate, get_logger
from .actor import Actor
from .lease import Lease
from .process_manager import ProcessManager
from .proxy import make_proxy
from .service import ServiceFilter
from .share import ECConsumer, services_cache_create_singleton

__all__ = ["LifeCycleManager", "LifeCycleClient"]

_LOGGER = get_logger("lifecycle")
HANDSHAKE_LEASE_TIME = 30.0   # reference lifecycle.py:74-75
DELETION_LEASE_TIME = 5.0     # reference lifecycle.py:259-263


class LifeCycleManager(Actor):
    """Creates and tracks LifeCycleClient processes.

    create_client(command, arguments) spawns a process that must construct
    a LifeCycleClient pointing back at this manager; the client then has
    HANDSHAKE_LEASE_TIME to call add_client on our control topic or it is
    killed.
    """

    def __init__(self, process, name: str,
                 client_change_handler=None,
                 handshake_lease_time: float = HANDSHAKE_LEASE_TIME):
        super().__init__(process, name)
        self.clients: dict = {}          # client_id -> record
        self._client_change_handler = client_change_handler
        self._handshake_lease_time = handshake_lease_time
        self._client_sequence = 0
        self.process_manager = ProcessManager(self._process_exit_handler)
        self.share["client_count"] = 0
        # child exits arrive on the ProcessManager monitor THREAD; defer
        # all state mutation onto the event loop
        process.event.add_queue_handler(self._client_exit_queued,
                                        ["lifecycle_exit"])
        process.event.add_queue_handler(self._client_lost_queued,
                                        ["lifecycle_lost"])
        # a client that crashes WITH LWT (severed broker connection)
        # vanishes from the registrar before -- or instead of -- its OS
        # exit being reaped: watch removals so the record (and any
        # wedged zombie process) is reaped either way.  The bound
        # method is stored ONCE: ServicesCache.remove_handler matches
        # by identity, and a fresh `self._registrar_event` access would
        # never equal the registered object
        self._services_cache = services_cache_create_singleton(process)
        self._registrar_watch = self._registrar_event
        self._services_cache.add_handler(self._registrar_watch,
                                         ServiceFilter())

    # -- creating clients --------------------------------------------------

    def create_client(self, command: str, arguments=(),
                      use_interpreter: bool = True, env=None) -> int:
        """`env` is merged over the parent environment by
        ProcessManager.spawn: the elastic-fleet spawner pins
        JAX_PLATFORMS, the persistent compile-cache directory, and
        telemetry knobs on every replica child this way."""
        client_id = self._client_sequence
        self._client_sequence += 1
        self.clients[client_id] = {
            "state": "spawning", "topic_path": None, "share": {},
            "ec_consumer": None,
            "lease": Lease(self.process.event, self._handshake_lease_time,
                           client_id,
                           lease_expired_handler=self._handshake_expired),
        }
        self.process_manager.spawn(
            client_id, command,
            list(arguments) + [self.topic_path, str(client_id)],
            use_interpreter=use_interpreter, env=env)
        return client_id

    def _handshake_expired(self, client_id) -> None:
        record = self.clients.get(client_id)
        if record is not None and record["state"] == "spawning":
            _LOGGER.warning("Client %s missed handshake: killing",
                            client_id)
            self._remove_client(client_id, kill=True)

    # -- control-topic commands from clients -------------------------------

    def add_client(self, topic_path, client_id) -> None:
        """Client handshake (reference lifecycle.py:190-227; arrives on the
        control topic as "(add_client topic_path id)")."""
        client_id = int(client_id)
        record = self.clients.get(client_id)
        if record is None:
            _LOGGER.warning("add_client for unknown id %s", client_id)
            return
        if record["state"] != "spawning":
            # duplicate handshake (running) is idempotent; a handshake
            # during deletion must NOT cancel the pending deletion
            return
        record["state"] = "running"
        record["topic_path"] = topic_path
        record["lease"].terminate()
        record["lease"] = None
        record["ec_consumer"] = ECConsumer(
            self.process, record["share"], topic_path)
        self._update_share()
        if self._client_change_handler:
            self._client_change_handler("add", client_id)

    # -- removal -----------------------------------------------------------

    def delete_client(self, client_id: int) -> None:
        """Graceful stop: ask the client to terminate, force-kill if it
        lingers past the deletion lease (reference lifecycle.py:259-269)."""
        record = self.clients.get(client_id)
        if record is None:
            return
        if record["topic_path"]:
            make_proxy(self.process, record["topic_path"]).terminate()
        record["state"] = "deleting"
        record["lease"] = Lease(
            self.process.event, DELETION_LEASE_TIME, client_id,
            lease_expired_handler=self._deletion_expired)

    def _deletion_expired(self, client_id) -> None:
        if client_id in self.clients:
            _LOGGER.warning("Client %s ignored terminate: killing",
                            client_id)
            self._remove_client(client_id, kill=True)

    def _process_exit_handler(self, client_id, return_code) -> None:
        # monitor thread -> event loop (no direct mutation here)
        self.process.event.queue_put(client_id, "lifecycle_exit")

    def _client_exit_queued(self, client_id) -> None:
        self._remove_client(client_id, kill=False)

    def _registrar_event(self, command, fields) -> None:
        """ServicesCache callback (message-pump side): a RUNNING
        client's registrar entry vanished -- LWT fired on a severed
        connection, or the service terminated without telling us.
        Defer onto the event loop like the exit path."""
        if command != "remove":
            return
        for client_id, record in list(self.clients.items()):
            if (record["topic_path"] == fields.topic_path
                    and record["state"] == "running"):
                _LOGGER.warning("Client %s lost from registrar (LWT); "
                                "reaping", client_id)
                self.process.event.queue_put(client_id, "lifecycle_lost")

    def _client_lost_queued(self, client_id) -> None:
        # the broker connection died but the OS process may linger as a
        # zombie: kill=True covers both
        self._remove_client(client_id, kill=True)

    def _remove_client(self, client_id, kill: bool) -> None:
        record = self.clients.pop(client_id, None)
        if record is None:
            return
        if record["lease"] is not None:
            record["lease"].terminate()
        if record["ec_consumer"] is not None:
            record["ec_consumer"].terminate()
        self._update_share()
        if self._client_change_handler:
            self._client_change_handler("remove", client_id)
        if kill:
            # synchronous record removal + SIGTERM; the grace wait and
            # SIGKILL escalation run off-thread inside ProcessManager.kill
            self.process_manager.kill(client_id)

    def _update_share(self) -> None:
        if self.ec_producer is not None:
            self.ec_producer.update("client_count", len(self.clients))
        else:
            self.share["client_count"] = len(self.clients)

    def stop(self) -> None:
        self._services_cache.remove_handler(self._registrar_watch)
        for client_id in list(self.clients):
            self._remove_client(client_id, kill=True)
        self.process_manager.terminate()
        super().stop()


class LifeCycleClient(Actor):
    """Worker-side half: announces itself to the manager once the
    registrar connection is up (reference lifecycle.py:355-388)."""

    def __init__(self, process, name: str, manager_topic_path: str,
                 client_id):
        super().__init__(process, name)
        self.manager_topic_path = manager_topic_path
        self.client_id = int(client_id)
        self._announced = False
        # Actor auto-creates the ECProducer the manager watches
        # add_handler replays the current state immediately, so an
        # already-REGISTRAR connection announces exactly once through it
        process.connection.add_handler(self._connection_handler)

    def _connection_handler(self, connection, state) -> None:
        from .connection import ConnectionState
        if state == ConnectionState.REGISTRAR and not self._announced:
            self._announce()

    def _announce(self) -> None:
        self._announced = True
        self.process.publish(
            f"{self.manager_topic_path}/control",
            generate("add_client", [self.topic_path, self.client_id]))

    def terminate(self) -> None:
        """Manager asked us to stop: tear down the whole process."""
        self.process.terminate()
