# Finite state machine.
#
# Capability parity with the reference StateMachine (reference:
# src/aiko_services/main/state.py:21-61, a thin wrapper over the
# third-party `transitions` library whose transition() failure raises
# SystemExit).  Self-contained here: declared states + named transitions
# with on-enter callbacks on a model object; invalid transitions raise
# StateMachineError (not SystemExit -- callers decide severity).

from __future__ import annotations

from ..utils import get_logger

__all__ = ["StateMachine", "StateMachineError"]

_LOGGER = get_logger("state")


class StateMachineError(Exception):
    pass


class StateMachine:
    """transitions: [{"name": ..., "source": str | list | "*",
    "dest": ...}]; on entering state S, model.on_enter_S() fires if
    defined (matching the `transitions` library convention the reference
    relies on, registrar.py:139-188)."""

    def __init__(self, model, states: list, transitions: list,
                 initial: str):
        self.model = model
        self.states = list(states)
        self.state = initial
        self._transitions: dict[str, list] = {}
        for record in transitions:
            self._transitions.setdefault(record["name"], []).append(record)
        if initial not in self.states:
            raise StateMachineError(f"Unknown initial state: {initial}")

    def transition(self, name: str, **kwargs) -> None:
        records = self._transitions.get(name)
        if not records:
            raise StateMachineError(f"Unknown transition: {name}")
        for record in records:
            source = record["source"]
            sources = ([source] if isinstance(source, str) else
                       list(source))
            if "*" in sources or self.state in sources:
                destination = record["dest"]
                if destination not in self.states:
                    raise StateMachineError(
                        f"Unknown destination state: {destination}")
                previous = self.state
                self.state = destination
                _LOGGER.debug("%s: %s: %s -> %s",
                              type(self.model).__name__, name, previous,
                              destination)
                handler = getattr(self.model,
                                  f"on_enter_{destination}", None)
                if handler is not None:
                    handler(**kwargs)
                return
        raise StateMachineError(
            f"Transition '{name}' invalid from state '{self.state}'")

    def get_state(self) -> str:
        return self.state
