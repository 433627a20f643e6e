# Stream model: streams of frames flowing through a pipeline graph.
#
# Capability parity with the reference stream model (reference:
# src/aiko_services/main/stream.py:25-98): StreamEvent return codes from
# element process_frame calls, StreamState for the stream lifecycle, Frame as
# the per-frame continuation (accumulated outputs in "swag", pause point for
# remote hops, per-element metrics), and Stream as the per-stream context
# (parameters, response routing, variables).
#
# TPU-first difference: swag values are arbitrary Python objects INCLUDING
# jax.Array -- in-process element hand-off is a dict insert, never a
# serialization (SURVEY.md section 2.4).  Stream context is always passed
# explicitly; there is no thread-local stream state (reference
# pipeline.py:584-610 is a design smell SURVEY.md section 7 says to drop).

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

__all__ = ["StreamEvent", "StreamState", "Frame", "Stream",
           "DEFAULT_STREAM_ID", "FIRST_FRAME_ID"]

DEFAULT_STREAM_ID = "*"   # reference stream.py:30
FIRST_FRAME_ID = 0        # reference stream.py:31


class StreamEvent(Enum):
    OKAY = "okay"
    STOP = "stop"
    ERROR = "error"
    DROP_FRAME = "drop_frame"
    # frame parks at this element (work continues off the event loop --
    # AsyncHostElement worker or remote hop); a process_frame_response
    # resumes it.  Other frames keep flowing meanwhile.
    PENDING = "pending"
    USER = "user"


class StreamState(Enum):
    RUN = "run"
    STOP = "stop"
    ERROR = "error"
    DROP_FRAME = "drop_frame"


@dataclass
class Frame:
    frame_id: int = FIRST_FRAME_ID
    swag: dict = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)
    # remote hops park the frame EXCLUSIVELY here (the reply cannot name
    # its node); local async/micro parks use pending_nodes instead so
    # sibling branches keep executing (fan-out concurrency -- the
    # reference executes branches sequentially, pipeline.py:1037-1092)
    paused_pe_name: str | None = None
    executed: set = field(default_factory=set)       # nodes completed
    pending_nodes: set = field(default_factory=set)  # nodes in flight
    # armed (a Lease) when an unroutable response leaves the frame's
    # attribution in doubt: releases the frame if nothing resumes it;
    # park_doubtful accumulates the parks in doubt (unions across
    # re-arms, pruned of resumed nodes at expiry)
    park_watchdog: object = None
    park_doubtful: set = field(default_factory=set)
    # True once a remote hop has parked this frame: un-named replies can
    # then be delayed duplicates of the remote's, so they are never
    # auto-routed to a local park
    had_remote_park: bool = False
    # per-frame trace (observe.FrameTrace) minted at stream ingress when
    # pipeline telemetry is enabled; None otherwise (every tracing hook
    # is then a single is-None check)
    trace: object = None
    # per-node retry attempts under the `on_error: retry` policy (lazily
    # built on first retry -- the no-fault hot path never allocates it)
    retries: dict | None = None
    # armed (a Lease) when the stream resolves a `frame_deadline`: the
    # frame is released as an error when the deadline passes with work
    # still in flight (a dead remote hop / lost reply must not leak the
    # frame's backpressure slot until the stream lease expires)
    deadline_lease: object = None


@dataclass
class Stream:
    stream_id: str = DEFAULT_STREAM_ID
    frame_id: int = FIRST_FRAME_ID          # next frame id to assign
    graph_path: str | None = None
    frames: dict = field(default_factory=dict)   # frame_id -> Frame
    parameters: dict = field(default_factory=dict)
    queue_response: object = None
    topic_response: str | None = None
    state: StreamState = StreamState.RUN
    variables: dict = field(default_factory=dict)  # per-element stream state
    pending: int = 0    # frames posted but not yet finished (backpressure)
    stop_requested: bool = False   # graceful stop: destroy when pending==0
    destroying: bool = False       # destroy_stream in progress (reentrancy)
    # the frame_id the engine is currently executing an element for --
    # explicit context (the reference used thread-locals, pipeline.py:
    # 584-610); AsyncHostElement uses it to address its resume message
    current_frame_id: int | None = None
    # error-budget window (lazily a deque of monotonic timestamps): when
    # `error_budget` errors land within `error_window` seconds the
    # stream is quarantined (destroyed with StreamState.ERROR) instead
    # of flapping forever under drop_frame/retry policies
    error_times: object = None

    def to_dict(self) -> dict:
        return {"stream_id": self.stream_id, "frame_id": self.frame_id}
