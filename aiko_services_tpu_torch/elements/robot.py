# Robot actor seat: a simulated robot driven by S-expression actions.
#
# Counterpart of aiko_services_tpu/elements/robot.py on the port's
# runtime (Actor, the registrar's services cache, proxies): the same
# actions, kinematics, camera codec and control bridge.  No device code.
#
# Capability parity with the reference's XGO robot-dog stack (reference:
# src/aiko_services/examples/xgo_robot/xgo_robot.py + robot_control.py,
# 807 LoC): an Actor that accepts "(action name args...)" commands --
# the contract the reference LLM element emits (elements_llm.py:137-179's
# S-expression-constrained system prompt) -- plus a pipeline element that
# parses LM output text into robot actions and forwards them to a
# discovered robot service.
#
# The reference drives real XGO hardware over serial; here the actuation
# backend is pluggable: SimulatedRobot integrates simple kinematics (the
# hermetic default, also the CI story the reference never had), and a
# hardware backend can subclass RobotActor and override _apply.

from __future__ import annotations

import math
import re
import time

from ..pipeline import PipelineElement, StreamEvent
from ..runtime.actor import Actor
from ..utils import get_logger

__all__ = ["RobotActor", "RobotControl", "RobotCameraSource",
           "parse_actions", "encode_camera_frame", "decode_camera_frame"]

_LOGGER = get_logger("robot")

# action name -> (parameter names, defaults); mirrors the reference robot
# vocabulary (xgo_robot.py action handlers: move/turn/stop/pose/speak)
ACTIONS = {
    "move": (("distance",), (0.1,)),       # meters, +forward
    "turn": (("degrees",), (15.0,)),       # +counter-clockwise
    "stop": ((), ()),
    "pose": (("name",), ("stand",)),
    "speak": (("text",), ("",)),
}


class RobotActor(Actor):
    """Discoverable robot service: "(action move 0.5)" etc. on its /in
    topic move the (simulated) robot; pose/odometry live in the EC share
    so dashboards and controllers mirror robot state like any service."""

    def __init__(self, process, name: str = "robot", protocol=None):
        super().__init__(process, name,
                         protocol=protocol or "robot:0")
        self.share.update({
            "x": 0.0, "y": 0.0, "heading": 0.0, "pose": "stand",
            "odometer": 0.0, "actions": 0, "last_action": "",
            "utterances": 0,
        })
        self.history: list[tuple] = []

    # -- the wire command ----------------------------------------------

    def action(self, name, *args):
        """(action <name> <args...>) -- validate name AND argument types
        against the action vocabulary before touching any state; invalid
        actions are logged, not fatal (the LM may hallucinate)."""
        name = str(name)
        if name not in ACTIONS:
            _LOGGER.warning("%s: unknown action: %s", self.name, name)
            return
        if name in ("move", "turn") and args:
            try:
                args = (float(args[0]),)
            except (TypeError, ValueError):
                _LOGGER.warning("%s: bad %s argument: %r", self.name,
                                name, args[0])
                return
        self.history.append((name, args, time.time()))
        self._apply(name, args)
        self._update_share("actions", int(self.share["actions"]) + 1)
        self._update_share(
            "last_action",
            f"{name} {' '.join(str(a) for a in args)}".strip())

    # -- simulated kinematics (override for hardware) ------------------

    def _apply(self, name: str, args: tuple):
        if name == "move":
            distance = float(args[0]) if args else ACTIONS["move"][1][0]
            heading = math.radians(float(self.share["heading"]))
            self._update_share(
                "x", round(float(self.share["x"])
                           + distance * math.cos(heading), 6))
            self._update_share(
                "y", round(float(self.share["y"])
                           + distance * math.sin(heading), 6))
            self._update_share(
                "odometer",
                round(float(self.share["odometer"]) + abs(distance), 6))
        elif name == "turn":
            degrees = float(args[0]) if args else ACTIONS["turn"][1][0]
            self._update_share(
                "heading",
                round((float(self.share["heading"]) + degrees) % 360.0,
                      6))
        elif name == "pose":
            self._update_share(
                "pose", str(args[0]) if args else "stand")
        elif name == "speak":
            self._update_share(
                "utterances", int(self.share["utterances"]) + 1)
        # "stop" only records history/last_action

    def _update_share(self, key, value):
        self.share[key] = value
        if self.ec_producer is not None:
            self.ec_producer.update(key, value)

    # -- camera over binary topics (reference xgo_robot.py ships camera
    # frames as zlib'd numpy on binary MQTT topics) --------------------

    def start_camera(self, period=1.0, height=64, width=64) -> None:
        """Wire-invocable "(start_camera 0.5)": publish camera frames to
        "{topic_path}/video" every `period` seconds as zlib-compressed
        .npy payloads (the reference's numpy+zlib binary-topic codec,
        audio_io.py PE_RemoteSend / xgo_robot.py camera loop).
        Consumers: RobotCameraSource feeds them into pipelines."""
        self.stop_camera()
        period = float(period)
        shape = (int(height), int(width))

        def tick():
            self.process.publish(f"{self.topic_path}/video",
                                 encode_camera_frame(self._capture(shape)))
            self._update_share("camera_frames",
                               int(self.share.get("camera_frames", 0)) + 1)

        self._camera_timer = tick
        self.process.event.add_timer_handler(tick, period, immediate=True)
        self._update_share("camera", f"on period={period}")

    def stop_camera(self) -> None:
        timer = getattr(self, "_camera_timer", None)
        if timer is not None:
            self.process.event.remove_timer_handler(timer)
            self._camera_timer = None
            self._update_share("camera", "off")

    def _capture(self, shape) -> "np.ndarray":
        """Simulated camera: a deterministic scene keyed by the robot's
        pose (hardware subclasses override with a real sensor read)."""
        import numpy as np
        height, width = shape
        seed = (int(float(self.share["x"]) * 100)
                ^ int(float(self.share["heading"]))
                ^ int(self.share.get("camera_frames", 0)))
        rng = np.random.default_rng(seed & 0x7FFFFFFF)
        return rng.random((3, height, width), dtype=np.float32)

    def stop(self) -> None:
        self.stop_camera()
        super().stop()


def encode_camera_frame(array) -> bytes:
    """ndarray -> zlib(.npy) bytes (binary-topic payload)."""
    import io
    import zlib

    import numpy as np
    buffer = io.BytesIO()
    np.save(buffer, np.asarray(array), allow_pickle=False)
    return zlib.compress(buffer.getvalue(), level=1)


def decode_camera_frame(payload) -> "np.ndarray":
    """Inverse of encode_camera_frame; accepts the broker's latin-1 text
    round-trip of the binary payload."""
    import io
    import zlib

    import numpy as np
    if isinstance(payload, str):
        payload = payload.encode("latin-1")
    return np.load(io.BytesIO(zlib.decompress(payload)),
                   allow_pickle=False)


def _discover_service_topic(process, name) -> str | None:
    """One-shot registrar lookup: the named service's topic_path (shared
    by RobotControl proxy resolution and camera discovery)."""
    from ..runtime import ServiceFilter
    from ..runtime.share import services_cache_create_singleton
    cache = services_cache_create_singleton(process)
    matches = list(cache.services.filter_services(
        ServiceFilter(name=str(name))))
    return matches[0].topic_path if matches else None


class RobotCameraSource(PipelineElement):
    """DataSource-style element subscribing to a robot's binary video
    topic: each received frame enters the stream as {"image": (3,H,W)}
    (reference capability: xgo_robot camera frames feeding the
    YOLO/overlay pipelines).  Parameters: "topic" (explicit) or
    "robot_service" (registrar discovery of the named robot's
    "{topic_path}/video").  Discovery is RACE-FREE: if the robot has
    not yet reached the services cache at stream start, the element
    watches the cache and subscribes the moment it appears (the
    asynchronous mirror means 'not discovered yet' is transient, not
    an error)."""

    def _subscribe(self, stream, topic: str) -> None:
        pipeline = self.pipeline
        window = int(self.get_parameter("frame_window", 16, stream))

        def handler(_topic, payload):
            if stream.pending >= window:
                # backpressure like every DataSource: a camera outrunning
                # the pipeline (e.g. during a downstream jit compile)
                # drops frames instead of queuing minutes-stale ones
                return
            try:
                image = decode_camera_frame(payload)
            except Exception as error:
                _LOGGER.warning("%s: undecodable camera frame: %s",
                                self.name, error)
                return
            if stream.stream_id in pipeline.streams:
                pipeline.create_frame(stream, {"image": image})

        stream.variables[f"{self.definition.name}.handler"] = (
            handler, topic)
        self.process.add_message_handler(handler, topic)

    def start_stream(self, stream, stream_id):
        topic = self.get_parameter("topic", None, stream)
        name = self.get_parameter("robot_service", None, stream)
        if topic:
            self._subscribe(stream, str(topic))
            return StreamEvent.OKAY, None
        if not name:
            return StreamEvent.ERROR, {
                "diagnostic": "RobotCameraSource needs a topic parameter "
                              "or a robot_service name"}
        from ..runtime import ServiceFilter
        from ..runtime.share import services_cache_create_singleton
        cache = services_cache_create_singleton(self.process)

        def on_service(command, fields):
            key = f"{self.definition.name}.handler"
            if (command == "add" and key not in stream.variables
                    and stream.stream_id in self.pipeline.streams):
                self._subscribe(stream, f"{fields.topic_path}/video")

        # add_handler replays already-known services as "add", so this
        # covers both orders: robot first or stream first
        cache.add_handler(on_service, ServiceFilter(name=str(name)))
        stream.variables[f"{self.definition.name}.watch"] = (
            cache, on_service)
        return StreamEvent.OKAY, None

    def stop_stream(self, stream, stream_id):
        watch = stream.variables.pop(
            f"{self.definition.name}.watch", None)
        if watch is not None:
            watch[0].remove_handler(watch[1])
        entry = stream.variables.pop(
            f"{self.definition.name}.handler", None)
        if entry is not None:
            self.process.remove_message_handler(*entry)
        return StreamEvent.OKAY, None

    def process_frame(self, stream, **inputs):
        return StreamEvent.OKAY, inputs


_ACTION_PATTERN = re.compile(r"\(\s*action\s+([^()]+?)\s*\)")


def parse_actions(text: str) -> list[tuple[str, list[str]]]:
    """Extract (action name args...) commands from free-form LM output
    (the reference constrains the LLM to this grammar,
    elements_llm.py:137-179)."""
    actions = []
    for match in _ACTION_PATTERN.finditer(text or ""):
        parts = match.group(1).split()
        if parts:
            actions.append((parts[0], parts[1:]))
    return actions


class RobotControl(PipelineElement):
    """Pipeline bridge LM -> robot: parses "(action ...)" commands out of
    generated text and forwards them to a robot service by proxy (the
    reference's robot_control loop).  The robot is addressed either
    directly ("robot_topic" parameter) or by registrar discovery
    ("robot_service" name).  Emits the parsed actions so graphs can also
    fan them into recorders/dashboards."""

    _proxy_cache: tuple | None = None  # (resolution key, proxy)

    def _robot_proxy(self, stream):
        from ..runtime.proxy import make_proxy
        target = self.get_parameter("robot_topic", None, stream)
        name = self.get_parameter("robot_service", None, stream)
        key = (target, name)
        if self._proxy_cache is not None and self._proxy_cache[0] == key:
            return self._proxy_cache[1]
        if target:
            proxy = make_proxy(self.process, str(target))
            self._proxy_cache = (key, proxy)
            return proxy
        if not name:
            return None
        topic_path = _discover_service_topic(self.process, name)
        if topic_path is None:
            # not cached: retry discovery on the next frame
            _LOGGER.warning("%s: robot service '%s' not discovered yet",
                            self.definition.name, name)
            return None
        proxy = make_proxy(self.process, topic_path)
        self._proxy_cache = (key, proxy)
        return proxy

    def process_frame(self, stream, text):
        prompts = [text] if isinstance(text, str) else list(text)
        parsed = []
        for item in prompts:
            parsed.extend(parse_actions(str(item)))
        sent = 0
        if parsed:
            proxy = self._robot_proxy(stream)
            if proxy is not None:
                for name, args in parsed:
                    proxy.action(name, *args)
                    sent += 1
        return StreamEvent.OKAY, {
            "actions": [[name] + list(args) for name, args in parsed],
            "dispatched": sent}
