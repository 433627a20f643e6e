# Actor layer: deferred method invocation over mailboxes.
#
# Capability parity with the reference actor layer (reference:
# src/aiko_services/main/actor.py:107-283): inbound S-expressions on
# "{topic_path}/in" parse into Message(command, parameters) records posted to
# per-actor mailboxes; the control mailbox is registered first so control
# traffic preempts data traffic (reference actor.py:208-213); messages invoke
# actual methods on the event-loop thread; invalid commands are logged, not
# fatal.  Local calls can be deferred through post_message, and timed
# delivery uses the event engine's timers.

from __future__ import annotations

from ..utils import parse, generate, get_logger
from .service import Service

__all__ = ["Actor", "ActorMessage", "ActorTopic"]

_LOGGER = get_logger("actor")


class ActorTopic:
    CONTROL = "control"
    IN = "in"
    OUT = "out"
    STATE = "state"


class ActorMessage:
    """One deferred method call (reference actor.py:122-159)."""

    __slots__ = ("target", "command", "parameters")

    def __init__(self, target, command: str, parameters):
        self.target = target
        self.command = command
        self.parameters = parameters

    def invoke(self) -> None:
        aliases = getattr(self.target, "command_aliases", None)
        command = (aliases.get(self.command, self.command)
                   if aliases else self.command)
        method = getattr(self.target, command, None)
        if method is None or not callable(method):
            _LOGGER.warning(
                "%s: unknown command: %s",
                getattr(self.target, "name", self.target), self.command)
            return
        try:
            method(*self.parameters)
        except TypeError as error:
            _LOGGER.error(
                "%s: bad arguments for %s%r: %s",
                getattr(self.target, "name", self.target),
                self.command, tuple(self.parameters), error)

    def __repr__(self):
        return f"ActorMessage({self.command}{tuple(self.parameters)!r})"


class Actor(Service):
    def __init__(self, process, name: str, protocol: str = None,
                 tags=None, owner: str = ""):
        super().__init__(process, name, protocol=protocol, tags=tags,
                         owner=owner)
        import logging
        self.share: dict = {
            "lifecycle": "ready",
            "name": name,
            "protocol": self.protocol,
            "tags": self.tags,
            "log_level": logging.getLevelName(
                self.logger.getEffectiveLevel()),
        }
        self.ec_producer = None
        # wire-command -> method-name aliases (lets a command like "share"
        # coexist with the share dict attribute)
        self.command_aliases: dict[str, str] = {}

        # control mailbox first: priority over in (reference actor.py:208)
        self._mailbox_control = f"{self.topic_path}/#control"
        self._mailbox_in = f"{self.topic_path}/#in"
        engine = process.event
        engine.add_mailbox_handler(self._mailbox_handler,
                                   self._mailbox_control)
        engine.add_mailbox_handler(self._mailbox_handler, self._mailbox_in)
        self.add_message_handler(self._topic_in_handler, self.topic_in)
        self.add_message_handler(self._topic_control_handler,
                                 self.topic_control)
        # every actor shares its state over EC (reference actor.py:199-205)
        from .share import ECProducer
        ECProducer(self)

    # -- inbound message routing ------------------------------------------

    def _topic_in_handler(self, topic: str, payload: str) -> None:
        try:
            command, parameters = parse(payload)
        except ValueError as error:
            _LOGGER.warning("%s: unparseable payload dropped: %s",
                            self.name, error)
            return
        if command:
            self._post_message(ActorTopic.IN, command, parameters)

    def _topic_control_handler(self, topic: str, payload: str) -> None:
        try:
            command, parameters = parse(payload)
        except ValueError as error:
            _LOGGER.warning("%s: unparseable control payload dropped: %s",
                            self.name, error)
            return
        if not command:
            return
        if self.ec_producer is not None and self.ec_producer.handles(command):
            self.ec_producer.handle(command, parameters)
            return
        self._post_message(ActorTopic.CONTROL, command, parameters)

    def _post_message(self, actor_topic: str, command: str,
                      parameters) -> None:
        # "control_" prefixed commands always ride the control mailbox
        # (reference actor.py:183-192)
        if command.startswith("control_"):
            actor_topic = ActorTopic.CONTROL
        mailbox = (self._mailbox_control
                   if actor_topic == ActorTopic.CONTROL
                   else self._mailbox_in)
        self.process.event.mailbox_put(
            mailbox, ActorMessage(self, command, parameters))

    def _mailbox_handler(self, mailbox_name: str, message) -> None:
        message.invoke()

    def _ec_flush_staged(self) -> None:
        """Mailbox continuation of ECProducer.stage(): the flush
        message queues behind the churn burst that staged the updates,
        so one delta publish covers the whole drained burst."""
        if self.ec_producer is not None:
            self.ec_producer.flush_staged()

    def _ec_change_hook(self, command: str, name: str, value) -> None:
        """Live log_level updates via the share dict, e.g. dashboard
        publishing "(update log_level DEBUG)" to /control (reference
        actor.py:259-265)."""
        if command == "update" and name == "log_level":
            try:
                self.logger.setLevel(str(value).upper())
            except ValueError:
                _LOGGER.warning("%s: bad log_level ignored: %r",
                                self.name, value)

    # -- local API ---------------------------------------------------------

    def post_message(self, command: str, parameters=(),
                     actor_topic: str = ActorTopic.IN) -> None:
        """Defer a local method call through the mailbox (preserves actor
        ordering semantics for self-sends)."""
        self._post_message(actor_topic, command, list(parameters))

    def post_message_later(self, command: str, parameters=(),
                           delay: float = 0.0) -> None:
        engine = self.process.event

        def fire():
            engine.remove_timer_handler(fire)
            self.post_message(command, parameters)

        engine.add_timer_handler(fire, delay)

    def publish_out(self, command: str, parameters=()) -> None:
        self.process.publish(self.topic_out, generate(command, parameters))

    def terminate(self) -> None:
        """Wire-invocable kill: "(terminate)" on /in tears down the whole
        process (reference dashboard kill, dashboard.py:368-377)."""
        self.process.terminate()

    def stop(self) -> None:
        engine = self.process.event
        engine.remove_mailbox_handler(self._mailbox_control)
        engine.remove_mailbox_handler(self._mailbox_in)
        self.remove_message_handler(self._topic_in_handler, self.topic_in)
        self.remove_message_handler(self._topic_control_handler,
                                    self.topic_control)
        super().stop()
