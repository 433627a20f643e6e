# The shipped examples/*.json on the port (runtime "torch", device cpu),
# and the elements they name (elements/compute.py JaxScale / JaxMLP,
# image_io.py, video_io.py, robot.py), each run as its JAX test runs it
# (tests/test_examples.py, tests/test_tts_vision_robot.py TestRobot,
# tests/test_parity_items.py TestConverterPipelines).  Only `runtime`, the
# element modules and the device change, in memory.
#
# Tolerances: JaxMLP's output against the JAX element's on the same
# (exported) weights atol/rtol 1e-5 in f32 (two small products and a tanh
# GELU, summed in another order); overlays, canvases, tokens and robot
# state exactly.

import json
import queue
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from aiko_services_tpu import pipeline as jax_pipeline
from aiko_services_tpu import runtime as jax_runtime
from aiko_services_tpu import transport as jax_transport
from aiko_services_tpu.elements import image_io as jax_image_io
from aiko_services_tpu_torch import pipeline as torch_pipeline
from aiko_services_tpu_torch import runtime as torch_runtime
from aiko_services_tpu_torch import transport as torch_transport
from aiko_services_tpu_torch.elements import image_io, robot
from aiko_services_tpu_torch.parallel import mesh as torch_mesh
from aiko_services_tpu_torch.transport.loopback import get_broker

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
PORT_MODULE = "aiko_services_tpu_torch.elements"
RAN_BY_THE_PORT = ["pipeline_compute.json", "pipeline_multimodal.json",
                   "pipeline_images_to_video.json",
                   "pipeline_video_to_images.json",
                   "pipeline_robot_loop.json"]


@pytest.fixture(autouse=True)
def clean():
    # the port's counterpart of the JAX tests' 8 virtual CPU devices
    torch_mesh.set_default_devices(["cpu"] * 8)
    jax_transport.reset_brokers()
    torch_transport.reset_brokers()
    try:
        yield
    finally:
        torch_mesh.set_default_devices(None)
        jax_transport.reset_brokers()
        torch_transport.reset_brokers()


def _on_port(name: str, device: str = "cpu") -> dict:
    """The shipped example with runtime "torch", the port's elements and
    `device`."""
    definition = json.loads((EXAMPLES / name).read_text())
    definition["runtime"] = "torch"
    definition.setdefault("parameters", {})["device"] = device
    for element in definition["elements"]:
        element["deploy"]["local"]["module"] = PORT_MODULE
    return definition


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


@pytest.mark.parametrize("name", RAN_BY_THE_PORT)
def test_example_builds_on_the_port(name):
    """Each example the port could not build before names only ported
    classes now: create_pipeline instantiates every element."""
    process = torch_runtime.Process(transport_kind="loopback")
    try:
        pipeline = torch_pipeline.create_pipeline(process, _on_port(name))
        process.run(in_thread=True)
        assert set(pipeline.elements) == {
            element["name"] for element in _on_port(name)["elements"]}
    finally:
        process.terminate()


def _stream_outputs(package_pipeline, package_runtime, definition,
                    count: int, before=None) -> list:
    process = package_runtime.Process(transport_kind="loopback")
    try:
        pipeline = package_pipeline.create_pipeline(process, definition)
        if before is not None:
            before(pipeline)
        process.run(in_thread=True)
        responses = queue.Queue()
        pipeline.create_stream("s", queue_response=responses)
        outputs = []
        for _ in range(count):
            _, frame, out = responses.get(timeout=120)
            outputs.append((frame.frame_id, {key: _host(value)
                                             for key, value in out.items()}))
        return [out for _, out in sorted(outputs, key=lambda x: x[0])], \
            pipeline
    finally:
        process.terminate()


def test_pipeline_compute_example_runs_and_matches_jax():
    """tests/test_examples.py::test_pipeline_compute_example_runs, then
    the same frames through the JAX package with the port's JaxMLP on
    the JAX element's weights (exported through numpy): equal within
    1e-5.  The mlp's `sharding` block (data: -1) cuts each frame over
    the 8-position mesh."""
    ours, pipeline = _stream_outputs(torch_pipeline, torch_runtime,
                                     _on_port("pipeline_compute.json"), 3)
    assert pipeline.elements["mlp"].mesh.shape["data"] == 8
    for outputs in ours:
        assert outputs["tensor"].shape == (8, 16)
        assert np.isfinite(outputs["tensor"]).all()
    jax_definition = json.loads(
        (EXAMPLES / "pipeline_compute.json").read_text())
    theirs, jax_pipe = _stream_outputs(jax_pipeline, jax_runtime,
                                       jax_definition, 3)
    exported = {name: np.asarray(leaf) for name, leaf in
                jax_pipe.elements["mlp"].state.items()}
    held, _ = _stream_outputs(
        torch_pipeline, torch_runtime, _on_port("pipeline_compute.json"), 3,
        before=lambda pipe: pipe.elements["mlp"].restore_state(exported))
    for got, want in zip(held, theirs):
        np.testing.assert_allclose(got["tensor"], np.asarray(want["tensor"]),
                                   atol=1e-5, rtol=1e-5)


def test_pipeline_multimodal_example_runs():
    """examples/pipeline_multimodal.json as shipped: tokens, text, LM
    logits and NLL, detections and the overlay on every frame."""
    outputs, _ = _stream_outputs(torch_pipeline, torch_runtime,
                                 _on_port("pipeline_multimodal.json"), 2)
    for out in outputs:
        assert out["tokens"].shape == (1, 32)
        assert out["tokens"].dtype == np.int32
        assert isinstance(out["text"], list)
        assert out["logits"].shape == (1, 32, 1024)
        assert np.isfinite(out["logits"]).all()
        assert out["nll"].shape == (1,)
        assert out["image"].shape == (256, 256, 3)
        assert out["image"].dtype == np.uint8
        overlay = out["overlay"]
        assert len(overlay["objects"]) == len(overlay["rectangles"])


def test_image_overlay_matches_jax_on_the_same_detections():
    """ImageOverlay draws JAX's rectangles and labels: the same canvas
    and overlay dict, with the port's detections given as tensors."""
    rng = np.random.default_rng(0)
    image = rng.random((1, 3, 64, 64), dtype=np.float32)
    boxes = np.array([[[4, 6, 30, 40], [10, 10, 50, 60], [0, 0, 8, 8]]],
                     np.float32)
    detections = {"boxes": boxes,
                  "scores": np.array([[0.9, 0.4, 0.7]], np.float32),
                  "classes": np.array([[3, 1, 7]], np.int32),
                  "valid": np.array([[True, True, False]])}
    _, theirs = jax_image_io.ImageOverlay.process_frame(
        None, None, image, detections)
    _, ours = image_io.ImageOverlay.process_frame(
        None, None, torch.from_numpy(image),
        {name: torch.from_numpy(value)
         for name, value in detections.items()})
    assert ours["overlay"] == theirs["overlay"]
    assert len(ours["overlay"]["rectangles"]) == 2
    np.testing.assert_array_equal(ours["image"], theirs["image"])


def test_images_to_video_to_images_round_trip(tmp_path):
    """test_parity_items.py::test_images_to_video_roundtrip on the port,
    then the video back to images through pipeline_video_to_images."""
    cv2 = pytest.importorskip("cv2")
    from PIL import Image
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for index in range(3):
        Image.fromarray(np.full((32, 32, 3), index * 60, np.uint8)).save(
            frames_dir / f"frame_{index:02d}.png")
    video = tmp_path / "out.avi"
    definition = _on_port("pipeline_images_to_video.json")
    definition["elements"][0]["parameters"]["data_sources"] = [
        str(frames_dir / "*.png")]
    definition["elements"][1]["parameters"].update(
        {"data_targets": [str(video)], "frame_rate": 5, "fourcc": "MJPG"})
    process = torch_runtime.Process(transport_kind="loopback")
    pipeline = torch_pipeline.create_pipeline(process, definition)
    process.run(in_thread=True)
    responses = queue.Queue()
    pipeline.create_stream("s1", queue_response=responses)
    for _ in range(3):
        responses.get(timeout=20)
    deadline = time.monotonic() + 10
    while "s1" in pipeline.streams and time.monotonic() < deadline:
        time.sleep(0.05)  # generator exhaustion closes the writer
    process.terminate()
    capture = cv2.VideoCapture(str(video))
    count = 0
    while capture.read()[0]:
        count += 1
    capture.release()
    assert count == 3

    out_dir = tmp_path / "back"
    out_dir.mkdir()
    definition = _on_port("pipeline_video_to_images.json")
    # `count` sends a single data source down DataSource's generator
    # path (one item with no rate or count takes its one-frame read in
    # both packages, which VideoReadFile does not serve)
    definition["elements"][0]["parameters"].update(
        {"data_sources": [str(video)], "count": 3})
    definition["elements"][1]["parameters"]["data_targets"] = [
        str(out_dir / "frame_{:02d}.png")]
    outputs, _ = _stream_outputs(torch_pipeline, torch_runtime, definition,
                                 3)
    for index, out in enumerate(outputs):
        assert out["image"].shape == (3, 32, 32)
    written = sorted(out_dir.glob("*.png"))
    assert len(written) == 3
    for index, path in enumerate(written):
        pixels = np.asarray(Image.open(path), np.float32)
        # MJPG is lossy: each flat frame comes back near its gray level
        assert abs(pixels.mean() - index * 60) < 4


# -- the robot ---------------------------------------------------------------

def _robot(name: str = "xgo"):
    process = torch_runtime.Process(transport_kind="loopback")
    torch_runtime.Registrar(process, search_timeout=0.05)
    actor = robot.RobotActor(process, name=name)
    process.run(in_thread=True)
    return process, actor


def _wait_for(predicate, seconds: float = 5.0) -> bool:
    deadline = time.monotonic() + seconds
    while not predicate() and time.monotonic() < deadline:
        get_broker().drain()
        time.sleep(0.01)
    return predicate()


def test_robot_actions_update_kinematics_and_share():
    """TestRobot.test_actions_update_kinematics_and_share and
    test_unknown_action_is_ignored."""
    process, actor = _robot()
    try:
        actor.action("self_destruct")
        assert actor.share["actions"] == 0
        actor.action("move", 1.0)
        actor.action("turn", 90)
        actor.action("move", 2.0)
        actor.action("pose", "sit")
        assert actor.share["x"] == pytest.approx(1.0)
        assert actor.share["y"] == pytest.approx(2.0)
        assert actor.share["heading"] == 90.0
        assert actor.share["odometer"] == pytest.approx(3.0)
        assert actor.share["pose"] == "sit"
        assert actor.share["actions"] == 4
    finally:
        process.terminate()


def test_robot_bad_argument_is_rejected_without_state_change():
    """TestReviewHardening.test_robot_bad_argument_is_rejected_..."""
    process, actor = _robot("xgo2")
    try:
        actor.action("move", "forward")   # LM hallucinated arg
        assert actor.share["actions"] == 0
        assert actor.history == []
        actor.action("move", "1.25")      # numeric string is fine
        assert actor.share["x"] == pytest.approx(1.25)
    finally:
        process.terminate()


def test_robot_remote_action_via_proxy():
    """TestRobot.test_remote_action_via_proxy."""
    from aiko_services_tpu_torch.runtime.proxy import make_proxy
    process, actor = _robot()
    try:
        make_proxy(process, actor.topic_path).action("move", 0.5)
        assert _wait_for(lambda: actor.share["actions"] == 1)
        assert actor.share["x"] == pytest.approx(0.5)
    finally:
        process.terminate()


def test_parse_actions_grammar():
    """TestRobot.test_parse_actions_grammar."""
    text = ("Sure! I'll do that: (action move 0.5) then "
            "(action turn 45) and finally (action stop)")
    assert robot.parse_actions(text) == [
        ("move", ["0.5"]), ("turn", ["45"]), ("stop", [])]
    assert robot.parse_actions("no actions here") == []
    assert robot.parse_actions("") == []


def test_robot_control_dispatches_to_the_robot():
    """TestRobot.test_robot_control_dispatches_to_discovered_robot."""
    process, actor = _robot()
    definition = {
        "name": "robot_pipe", "runtime": "torch", "graph": ["(control)"],
        "elements": [
            {"name": "control", "input": [{"name": "text"}],
             "output": [{"name": "actions"}, {"name": "dispatched"}],
             "parameters": {"robot_topic": actor.topic_path},
             "deploy": {"local": {"module": PORT_MODULE,
                                  "class_name": "RobotControl"}}}],
    }
    pipeline = torch_pipeline.create_pipeline(process, definition)
    try:
        responses = queue.Queue()
        pipeline.create_stream("s1", queue_response=responses)
        pipeline.process_frame(
            {"stream_id": "s1", "frame_id": 0},
            {"text": "(action move 2.0) (action turn 180)"})
        _, _, outputs = responses.get(timeout=5)
        assert outputs["dispatched"] == 2
        assert outputs["actions"] == [["move", "2.0"], ["turn", "180"]]
        assert _wait_for(lambda: actor.share["actions"] >= 2)
        assert actor.share["x"] == pytest.approx(2.0)
        assert actor.share["heading"] == 180.0
    finally:
        process.terminate()


def test_robot_camera_frames_flow_into_pipeline():
    """test_robot_camera_frames_flow_into_pipeline: the camera codec
    through the broker's latin-1 text path, and frames into a stream."""
    frame = np.random.default_rng(0).random((3, 8, 8)).astype(np.float32)
    wire = robot.encode_camera_frame(frame).decode("latin-1")
    np.testing.assert_array_equal(robot.decode_camera_frame(wire), frame)
    process = torch_runtime.Process(transport_kind="loopback")
    actor = robot.RobotActor(process, name="dog")
    definition = {
        "name": "robot_vision", "runtime": "torch", "graph": ["(camera)"],
        "elements": [
            {"name": "camera", "output": [{"name": "image"}],
             "parameters": {"topic": f"{actor.topic_path}/video"},
             "deploy": {"local": {"module": PORT_MODULE,
                                  "class_name": "RobotCameraSource"}}}],
    }
    pipeline = torch_pipeline.create_pipeline(process, definition)
    process.run(in_thread=True)
    try:
        responses = queue.Queue()
        pipeline.create_stream("s", queue_response=responses)
        actor.start_camera(period=0.05, height=16, width=16)
        seen = [responses.get(timeout=20) for _ in range(3)]
        actor.stop_camera()
        for _, _, outputs in seen:
            assert np.asarray(outputs["image"]).shape == (3, 16, 16)
        assert int(actor.share["camera_frames"]) >= 3
        assert actor.share["camera"] == "off"
    finally:
        process.terminate()


def test_pipeline_robot_loop_example_end_to_end():
    """tests/test_examples.py::test_pipeline_robot_loop_example_end_to_end
    on the port: robot camera (found through the registrar) -> detector
    -> detections side-channel -> chat LM (vision context in its prompt)
    -> RobotControl driving the robot from (action ...) text."""
    definition = _on_port("pipeline_robot_loop.json")
    process = torch_runtime.Process(transport_kind="loopback")
    torch_runtime.Registrar(process, search_timeout=0.05)
    actor = robot.RobotActor(process, name="dog")
    pipeline = torch_pipeline.create_pipeline(process, definition)
    process.run(in_thread=True)
    try:
        published = threading.Event()
        process.add_message_handler(
            lambda _topic, _payload: published.set(),
            f"{process.namespace}/detections")
        pipeline.create_stream("vision", queue_response=queue.Queue(),
                               graph_path="camera", grace_time=300)
        actor.start_camera(period=0.1, height=64, width=64)
        assert published.wait(timeout=120), (
            "vision leg never published detections")
        responses = queue.Queue()
        pipeline.create_stream(
            "chat", queue_response=responses, graph_path="ask",
            parameters={"control.robot_topic": actor.topic_path,
                        "detections_window": 300.0})
        saw_context = False
        for _ in range(8):
            try:
                _, _, outputs = responses.get(timeout=60)
            except queue.Empty:
                break
            if "prompt" in outputs:
                prompt = outputs["prompt"][0]
                assert "You control a robot dog" in prompt
                saw_context = saw_context or "Visible objects:" in prompt
            if saw_context:
                break
        actor.stop_camera()
        assert saw_context, "LM prompt never received vision context"
        before = float(actor.share["odometer"])
        pipeline.create_stream(
            "drive", queue_response=queue.Queue(), graph_path="control",
            parameters={"control.robot_topic": actor.topic_path})
        pipeline.create_frame(
            pipeline.streams["drive"],
            {"text": ["(action move 0.5) (action speak hello)"]})
        assert _wait_for(lambda: float(actor.share["odometer"]) > before,
                         10.0), "robot never acted on (action move 0.5)"
        assert actor.share["utterances"] >= 1
    finally:
        process.terminate()
