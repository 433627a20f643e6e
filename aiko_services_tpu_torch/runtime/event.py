# Event engine: the single-threaded cooperative scheduler every service,
# actor, and pipeline runs on.
#
# Capability parity with the reference event engine (reference:
# src/aiko_services/main/event.py:72-323): periodic timer handlers, named
# mailboxes with registration-order priority (first-added drains first),
# a shared typed queue, and "flat-out" handlers invoked whenever the loop is
# otherwise idle.
#
# Redesigned for latency: the reference loop polls on a fixed 10 ms sleep,
# capping dispatch at ~100 Hz and pipeline frame rates at ~50 Hz
# (reference event.py:281,311-313; SURVEY.md section 6).  This engine blocks
# on a condition variable and wakes exactly when work arrives or a timer is
# due, so dispatch latency is microseconds and throughput is bounded by the
# handlers, not the scheduler.

from __future__ import annotations

import heapq
import itertools
import threading
import traceback
from collections import OrderedDict, deque

from ..utils import get_logger, monotonic

__all__ = ["EventEngine", "Mailbox"]

_LOGGER = get_logger("event")
_FLATOUT_MIN_INTERVAL = 0.001  # ~1 kHz cap (reference event.py:58-59)


class Mailbox:
    __slots__ = ("name", "handler", "items", "high_water")

    def __init__(self, name: str, handler):
        self.name = name
        self.handler = handler
        self.items: deque = deque()
        self.high_water = 0

    def put(self, item) -> None:
        self.items.append(item)
        if len(self.items) > self.high_water:
            self.high_water = len(self.items)
            if self.high_water % 64 == 0:
                _LOGGER.warning(
                    "Mailbox %s backlog growing: %d items",
                    self.name, self.high_water)


class _Timer:
    __slots__ = ("handler", "period", "deadline", "cancelled")

    def __init__(self, handler, period: float, deadline: float):
        self.handler = handler
        self.period = period
        self.deadline = deadline
        self.cancelled = False


class EventEngine:
    """One engine per Process; loop() is the application thread."""

    def __init__(self, name: str = "event"):
        self.name = name
        self._condition = threading.Condition()
        self._timers: list[tuple[float, int, _Timer]] = []
        self._timer_sequence = itertools.count()
        self._timers_by_handler: dict = {}
        self._mailboxes: OrderedDict[str, Mailbox] = OrderedDict()
        self._queue: deque = deque()
        self._queue_handlers: dict[str, list] = {}
        self._flatout_handlers: list = []
        self._terminated = False
        self._loop_thread: threading.Thread | None = None

    # -- handler registration (thread-safe) --------------------------------

    def add_timer_handler(self, handler, period: float,
                          immediate: bool = False) -> None:
        deadline = monotonic() + (0.0 if immediate else period)
        timer = _Timer(handler, period, deadline)
        with self._condition:
            previous = self._timers_by_handler.get(handler)
            if previous is not None:  # re-add replaces: cancel the old timer
                previous.cancelled = True
            self._timers_by_handler[handler] = timer
            heapq.heappush(
                self._timers, (deadline, next(self._timer_sequence), timer))
            self._condition.notify()

    def remove_timer_handler(self, handler) -> None:
        with self._condition:
            timer = self._timers_by_handler.pop(handler, None)
            if timer is not None:
                timer.cancelled = True

    def add_mailbox_handler(self, handler, mailbox_name: str) -> None:
        with self._condition:
            if mailbox_name in self._mailboxes:
                self._mailboxes[mailbox_name].handler = handler
            else:
                self._mailboxes[mailbox_name] = Mailbox(mailbox_name, handler)
            self._condition.notify()

    def remove_mailbox_handler(self, mailbox_name: str) -> None:
        with self._condition:
            self._mailboxes.pop(mailbox_name, None)

    def mailbox_put(self, mailbox_name: str, item) -> None:
        with self._condition:
            mailbox = self._mailboxes.get(mailbox_name)
            if mailbox is None:  # create-on-demand; handler may attach later
                mailbox = self._mailboxes[mailbox_name] = Mailbox(
                    mailbox_name, None)
            mailbox.put(item)
            self._condition.notify()

    def add_queue_handler(self, handler, item_types=("default",)) -> None:
        with self._condition:
            for item_type in item_types:
                self._queue_handlers.setdefault(item_type, []).append(handler)

    def remove_queue_handler(self, handler, item_types=("default",)) -> None:
        with self._condition:
            for item_type in item_types:
                handlers = self._queue_handlers.get(item_type, [])
                if handler in handlers:
                    handlers.remove(handler)

    def queue_put(self, item, item_type: str = "default") -> None:
        with self._condition:
            self._queue.append((item, item_type))
            self._condition.notify()

    def add_flatout_handler(self, handler) -> None:
        with self._condition:
            self._flatout_handlers.append(handler)
            self._condition.notify()

    def remove_flatout_handler(self, handler) -> None:
        with self._condition:
            if handler in self._flatout_handlers:
                self._flatout_handlers.remove(handler)

    # -- loop --------------------------------------------------------------

    def loop(self) -> None:
        self._loop_thread = threading.current_thread()
        last_flatout = 0.0
        while True:
            with self._condition:
                if self._terminated:
                    return
                work = self._next_work_locked()
                if work is None:
                    timeout = self._wait_timeout_locked()
                    self._condition.wait(timeout)
                    continue
            kind, payload = work
            now = monotonic()
            if kind == "timer":
                timer = payload
                self._invoke(timer.handler)
                with self._condition:
                    if not timer.cancelled:
                        timer.deadline = now + timer.period
                        heapq.heappush(
                            self._timers,
                            (timer.deadline, next(self._timer_sequence),
                             timer))
            elif kind == "queue":
                item, item_type = payload
                for handler in self._queue_handlers.get(item_type, []):
                    self._invoke(handler, item)
            elif kind == "mailbox":
                mailbox, item = payload
                if mailbox.handler is not None:
                    self._invoke(mailbox.handler, mailbox.name, item)
            elif kind == "flatout":
                if now - last_flatout < _FLATOUT_MIN_INTERVAL:
                    threading.Event().wait(
                        _FLATOUT_MIN_INTERVAL - (now - last_flatout))
                last_flatout = monotonic()
                for handler in list(self._flatout_handlers):
                    self._invoke(handler)

    def _next_work_locked(self):
        """Pick the next unit of work.  Priority: due timers, queue items,
        mailboxes (registration order -- control before in, reference
        event.py:200,289-303), then flat-out handlers."""
        now = monotonic()
        while self._timers:
            deadline, _, timer = self._timers[0]
            if timer.cancelled:
                heapq.heappop(self._timers)
                continue
            if deadline <= now:
                heapq.heappop(self._timers)
                return ("timer", timer)
            break
        if self._queue:
            return ("queue", self._queue.popleft())
        for mailbox in self._mailboxes.values():
            if mailbox.items and mailbox.handler is not None:
                return ("mailbox", (mailbox, mailbox.items.popleft()))
        if self._flatout_handlers:
            return ("flatout", None)
        return None

    def _wait_timeout_locked(self):
        while self._timers and self._timers[0][2].cancelled:
            heapq.heappop(self._timers)
        if not self._timers:
            return None
        return max(0.0, self._timers[0][0] - monotonic())

    def _invoke(self, handler, *args) -> None:
        try:
            handler(*args)
        except SystemExit:
            raise
        except Exception:
            _LOGGER.error("Handler %r failed:\n%s",
                          handler, traceback.format_exc())

    def loop_in_thread(self) -> threading.Thread:
        thread = threading.Thread(
            target=self.loop, name=f"{self.name}-loop", daemon=True)
        thread.start()
        self._loop_thread = thread
        return thread

    def terminate(self) -> None:
        with self._condition:
            self._terminated = True
            self._condition.notify_all()

    @property
    def terminated(self) -> bool:
        return self._terminated

    def on_loop_thread(self) -> bool:
        return threading.current_thread() is self._loop_thread

    def mailbox_high_water(self) -> dict:
        with self._condition:
            return {name: mailbox.high_water
                    for name, mailbox in self._mailboxes.items()}
