# Connection-state ladder (capability parity with reference
# src/aiko_services/main/connection.py:12-46):
# NONE < NETWORK < TRANSPORT < REGISTRAR.  Handlers fire on every transition;
# is_connected(state) means "at least state".

from __future__ import annotations

from enum import IntEnum

__all__ = ["ConnectionState", "Connection"]


class ConnectionState(IntEnum):
    NONE = 0
    NETWORK = 1
    TRANSPORT = 2
    REGISTRAR = 3


class Connection:
    def __init__(self):
        self._state = ConnectionState.NONE
        self._handlers: list = []

    @property
    def state(self) -> ConnectionState:
        return self._state

    def add_handler(self, handler) -> None:
        self._handlers.append(handler)
        handler(self, self._state)  # immediately report current state

    def remove_handler(self, handler) -> None:
        if handler in self._handlers:
            self._handlers.remove(handler)

    def is_connected(self, state: ConnectionState) -> bool:
        return self._state >= state

    def update_state(self, state: ConnectionState) -> None:
        if state == self._state:
            return
        self._state = state
        for handler in list(self._handlers):
            handler(self, state)
