# The port's detector (models/layers.conv2d, models/detector.py) against
# the JAX package's on the CPU, on the same weights and images, and the
# port's Detector element on the committed trained checkpoint
# (tests/assets/detector_shapes.safetensors), as the JAX package's
# tests/test_detector_correctness.py runs it.
#
# Tolerances: conv2d atol 1e-5 (one f32 convolution, the same products
# summed in another order); the raw head after eight convolutions atol
# 1e-4; decoded boxes atol 1e-3 on pixel coordinates of order 10-100
# (f32 exp and sigmoid of the same inputs, ~1e-7 relative), scores atol
# 1e-5; NMS on the same candidates must be identical; a bf16 convolution
# within one bf16 rounding (rtol 2^-7) of the JAX package's, which rounds
# its f32 sum plus bias once.  The train step: the loss atol 1e-5 (a
# mean of f32 BCE terms of order 1 over the raw head, which agrees within
# 1e-4 on values of order 10); every gradient leaf within 1e-4 of its
# largest entry (the same products back through eight f32 convolutions,
# summed in another order); the parameters after three adamw(1e-3) steps
# atol 5e-5 (test_torch_transformer.py's reason: Adam divides each
# gradient by its own running magnitude).

import ast
import pathlib
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import detector as jax_det
from aiko_services_tpu.models import layers as jax_layers
from aiko_services_tpu_torch.models import (
    SafetensorsFile, params_from_numpy)
from aiko_services_tpu_torch.models import detector as torch_det
from aiko_services_tpu_torch.models import layers as torch_layers
from aiko_services_tpu_torch.pipeline import create_pipeline
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.transport import reset_brokers

ASSET = (pathlib.Path(__file__).parent / "assets"
         / "detector_shapes.safetensors")
MODULE = "aiko_services_tpu_torch.elements"
TOY = dict(n_classes=16, base_channels=8, image_size=64, max_detections=8,
           dtype="float32")


def _asset_metadata() -> dict:
    container = SafetensorsFile(ASSET)
    metadata = {key: ast.literal_eval(value)
                for key, value in container.metadata.items()}
    container.close()
    return metadata


_METADATA = _asset_metadata()
COLORS = np.asarray(_METADATA["colors"], np.float32)
IMAGE_SIZE = int(_METADATA["config"]["image_size"])
DETECTOR_LOSS_ATOL = 1e-5
DETECTOR_GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def clean_brokers():
    reset_brokers()
    yield
    reset_brokers()


@pytest.fixture(scope="module")
def toy():
    """(jax config, jax params, port config, port params, images (3, 3,
    64, 64) in [0, 1])."""
    jax_config = jax_det.DetectorConfig(**TOY)
    jax_params = jax_det.init_detector_params(jax_config,
                                              jax.random.PRNGKey(1))
    # non-zero biases, so that the bias path is held too
    rng = np.random.default_rng(2)
    jax_params = {name: {**entry, "b": jnp.asarray(rng.normal(
        0, 0.1, entry["b"].shape).astype(np.float32))}
        for name, entry in jax_params.items()}
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")
    images = np.random.default_rng(3).random((3, 3, 64, 64),
                                             dtype=np.float32)
    return (jax_config, jax_params, torch_det.DetectorConfig(**TOY), params,
            images)


def _conv_case(size, c_in, c_out, kernel, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, size, size + 1, c_in)).astype(np.float32)
    w = (rng.standard_normal((kernel, kernel, c_in, c_out))
         / np.sqrt(kernel * kernel * c_in)).astype(np.float32)
    b = rng.normal(0, 0.5, (c_out,)).astype(np.float32)
    return x, {"w": w, "b": b}


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [16, 17])
@pytest.mark.parametrize("kernel", [3, 1])
def test_conv2d_matches_lax_conv(stride, size, kernel):
    """SAME padding at stride 1 and 2 on even and odd heights (the width
    is the other parity): XLA pads (0, 1) where the total is odd."""
    x, params = _conv_case(size, 5, 7, kernel)
    expected = np.asarray(jax_layers.conv2d(
        {key: jnp.asarray(value) for key, value in params.items()},
        jnp.asarray(x), stride=stride))
    actual = torch_layers.conv2d(
        {key: torch.from_numpy(value) for key, value in params.items()},
        torch.from_numpy(x), stride=stride)
    assert tuple(actual.shape) == expected.shape
    np.testing.assert_allclose(actual.numpy(), expected, atol=1e-5, rtol=0)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_bf16_rounds_once_like_jax(stride):
    x, params = _conv_case(20, 16, 32, 3, seed=4)
    to_jax = {key: jnp.asarray(value, jnp.bfloat16)
              for key, value in params.items()}
    expected = np.asarray(jax_layers.conv2d(
        to_jax, jnp.asarray(x, jnp.bfloat16), stride=stride)).astype(
            np.float32)
    actual = torch_layers.conv2d(
        {key: torch.from_numpy(value).to(torch.bfloat16)
         for key, value in params.items()},
        torch.from_numpy(x).to(torch.bfloat16), stride=stride)
    assert actual.dtype == torch.bfloat16
    np.testing.assert_allclose(actual.float().numpy(), expected,
                               rtol=2 ** -7, atol=1e-6)


def test_detector_forward_raw_head_matches_jax(toy):
    jax_config, jax_params, config, params, images = toy
    expected = np.asarray(jax_det.detector_forward(jax_params, jax_config,
                                                   jnp.asarray(images)))
    actual = torch_det.detector_forward(params, config,
                                        torch.from_numpy(images))
    assert tuple(actual.shape) == expected.shape == (3, 21, 4, 4)
    np.testing.assert_allclose(actual.numpy(), expected, atol=1e-4, rtol=0)


def test_decode_boxes_matches_jax(toy):
    jax_config, _, config, _, _ = toy
    raw = np.random.default_rng(5).normal(0, 2, (2, 21, 4, 4)).astype(
        np.float32)
    expected = jax_det.decode_boxes(jnp.asarray(raw), jax_config)
    actual = torch_det.decode_boxes(torch.from_numpy(raw), config)
    np.testing.assert_allclose(actual[0].numpy(), np.asarray(expected[0]),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(actual[1].numpy(), np.asarray(expected[1]),
                               atol=1e-5, rtol=0)
    assert actual[2].dtype == torch.int32
    np.testing.assert_array_equal(actual[2].numpy(), np.asarray(expected[2]))


def _candidates(case: str):
    """(boxes (N, 4), scores (N,), classes (N,)) for an NMS case."""
    rng = np.random.default_rng({"random": 6, "ties": 7, "few": 8,
                                 "chain": 9}[case])
    if case == "few":  # fewer candidates than output slots
        count = 5
    else:
        count = 64
    xy = rng.uniform(0, 40, (count, 2))
    wh = rng.uniform(4, 16, (count, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = rng.uniform(0, 1, count).astype(np.float32)
    classes = rng.integers(0, 3, count).astype(np.int32)
    if case == "ties":
        # equal scores everywhere (bf16 heads give many) and duplicate
        # boxes: only the index order can break the ties
        scores = np.round(scores * 4) / 4
        boxes[10:20] = boxes[0]
        classes[10:20] = classes[0]
        scores[10:20] = scores[0]
    elif case == "chain":
        # a suppression chain: each box overlaps the next one a little
        # more than the threshold, so greedy NMS keeps every other box
        boxes = np.stack([np.arange(count) * 3.0, np.zeros(count),
                          np.arange(count) * 3.0 + 10.0,
                          np.full(count, 10.0)], axis=1).astype(np.float32)
        scores = np.linspace(0.99, 0.3, count).astype(np.float32)
        classes = np.zeros(count, np.int32)
    return boxes, scores, classes


@pytest.mark.parametrize("case", ["random", "ties", "few", "chain"])
def test_non_max_suppression_identical_to_jax(toy, case):
    jax_config, _, config, _, _ = toy
    boxes, scores, classes = _candidates(case)
    expected = jax_det.non_max_suppression(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
        jax_config)
    actual = torch_det.non_max_suppression(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(classes), config)
    for got, want in zip(actual, expected):
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert actual[1].dtype == torch.float32
    assert actual[2].dtype == torch.int32 and actual[3].dtype == torch.bool


def test_detect_matches_jax(toy):
    jax_config, jax_params, config, params, images = toy
    # a low threshold so that the random head keeps detections to compare
    jax_config = jax_det.DetectorConfig(**{**TOY, "score_threshold": 0.05})
    config = torch_det.DetectorConfig(**{**TOY, "score_threshold": 0.05})
    expected = jax_det.detect(jax_params, jax_config, jnp.asarray(images))
    actual = torch_det.detect(params, config, torch.from_numpy(images))
    assert np.asarray(expected["valid"]).any()
    for key in ("classes", "valid"):
        np.testing.assert_array_equal(actual[key].numpy(),
                                      np.asarray(expected[key]))
    np.testing.assert_allclose(actual["scores"].numpy(),
                               np.asarray(expected["scores"]), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(actual["boxes"].numpy(),
                               np.asarray(expected["boxes"]), atol=1e-3,
                               rtol=0)


def _square_image(class_id: int, x0: int, y0: int, side: int):
    rng = np.random.default_rng(class_id * 1000 + x0 + y0)
    image = rng.uniform(0.0, 0.25,
                        (3, IMAGE_SIZE, IMAGE_SIZE)).astype(np.float32)
    image[:, y0:y0 + side, x0:x0 + side] = (
        COLORS[class_id][:, None, None] * 0.9)
    return image, (x0, y0, x0 + side, y0 + side)


def _iou(a, b) -> float:
    lt = np.maximum(np.asarray(a[:2]), np.asarray(b[:2]))
    rb = np.minimum(np.asarray(a[2:]), np.asarray(b[2:]))
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[0] * wh[1]
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return float(inter / max(union, 1e-9))


def test_detector_element_finds_the_checkpoints_squares():
    """Image in -> the RIGHT object out through the port's Detector
    element: one valid detection, the right class, IoU >= 0.7."""
    definition = {
        "name": "det_correct",
        "graph": ["(detector)"],
        "parameters": {"device": "cpu"},
        "elements": [
            {"name": "detector", "input": [{"name": "image"}],
             "output": [{"name": "detections"}],
             "parameters": {**_METADATA["config"], "weights": str(ASSET)},
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "Detector"}}},
        ],
    }
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        stream = pipeline.create_stream("s1", queue_response=responses)
        cases = [(0, 6, 8, 20), (1, 30, 12, 16), (2, 14, 34, 22),
                 (3, 36, 36, 18)]
        expected = []
        for class_id, x0, y0, side in cases:
            image, box = _square_image(class_id, x0, y0, side)
            expected.append((class_id, box))
            pipeline.create_frame(stream, {"image": image[None]})
        for _ in cases:
            _, frame, outputs = responses.get(timeout=120)
            class_id, box = expected[frame.frame_id]
            detections = {key: value[0].numpy()
                          for key, value in outputs["detections"].items()}
            valid = detections["valid"]
            assert valid.sum() == 1, (frame.frame_id, int(valid.sum()))
            slot = int(np.argmax(valid))
            assert int(detections["classes"][slot]) == class_id
            assert _iou(detections["boxes"][slot], box) >= 0.7
    finally:
        process.terminate()


# -- the train step ---------------------------------------------------------

def _targets(batch: int, seed: int = 4):
    """Seeded single-object targets: xyxy boxes in pixels (the last one's
    center lies outside the image, so the cell clips) and classes."""
    rng = np.random.default_rng(seed)
    corner = rng.uniform(0, 48, (batch, 2))
    size = rng.uniform(6, 30, (batch, 2))
    boxes = np.concatenate([corner, corner + size], axis=1)
    boxes[-1] = [60.0, -10.0, 90.0, 4.0]
    classes = rng.integers(0, TOY["n_classes"], batch)
    return boxes.astype(np.float32), classes.astype(np.int32)


def _capture_gradients_jax():
    """An optax transformation whose state after a step is the step's
    gradient tree (and whose updates are zero)."""
    import optax
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def _capture_gradients_torch():
    from aiko_services_tpu_torch.models import optim
    from aiko_services_tpu_torch.utils.tree import tree_map
    return optim.GradientTransformation(
        lambda params: None,
        lambda grads, state, params=None: (
            tree_map(torch.zeros_like, grads), grads))


def test_detector_train_step_loss_and_gradients_match_jax(toy):
    jax_config, jax_params, config, params, images = toy
    boxes, classes = _targets(images.shape[0])
    jax_step = jax_det.make_detector_train_step(jax_config,
                                                _capture_gradients_jax())
    step = torch_det.make_detector_train_step(config,
                                              _capture_gradients_torch())
    jax_copy = jax.tree_util.tree_map(jnp.array, jax_params)
    _, expected_grads, expected_loss = jax_step(
        jax_copy, jax.tree_util.tree_map(jnp.zeros_like, jax_copy),
        jnp.asarray(images),
        {"box": jnp.asarray(boxes), "class": jnp.asarray(classes)})
    copy = {name: {key: value.clone() for key, value in entry.items()}
            for name, entry in params.items()}
    _, grads, loss = step(copy, None, torch.from_numpy(images),
                          {"box": torch.from_numpy(boxes),
                           "class": torch.from_numpy(classes)})
    np.testing.assert_allclose(float(loss), float(expected_loss),
                               atol=DETECTOR_LOSS_ATOL, rtol=0)
    for name, entry in expected_grads.items():
        for key, expected in entry.items():
            actual = grads[name][key].numpy()
            scale = float(np.abs(expected).max())
            np.testing.assert_allclose(
                actual, np.asarray(expected), rtol=0,
                atol=DETECTOR_GRAD_REL * scale, err_msg=f"{name}.{key}")


def test_detector_train_step_adamw_matches_optax_and_learns(toy):
    import optax
    from aiko_services_tpu_torch.models import optim
    jax_config, jax_params, config, params, images = toy
    boxes, classes = _targets(images.shape[0])
    jax_optimizer = optax.adamw(1e-3)
    jax_copy = jax.tree_util.tree_map(jnp.array, jax_params)
    jax_state = jax_optimizer.init(jax_copy)
    jax_step = jax_det.make_detector_train_step(jax_config, jax_optimizer)
    optimizer = optim.adamw(1e-3)
    copy = {name: {key: value.clone() for key, value in entry.items()}
            for name, entry in params.items()}
    state = optimizer.init(copy)
    step = torch_det.make_detector_train_step(config, optimizer)
    jax_targets = {"box": jnp.asarray(boxes), "class": jnp.asarray(classes)}
    targets = {"box": torch.from_numpy(boxes),
               "class": torch.from_numpy(classes)}
    losses = []
    for _ in range(3):
        jax_copy, jax_state, expected = jax_step(
            jax_copy, jax_state, jnp.asarray(images), jax_targets)
        copy, state, loss = step(copy, state, torch.from_numpy(images),
                                 targets)
        np.testing.assert_allclose(float(loss), float(expected),
                                   atol=DETECTOR_LOSS_ATOL, rtol=0)
        losses.append(float(loss))
    for name, entry in jax_copy.items():
        for key, expected in entry.items():
            np.testing.assert_allclose(copy[name][key].detach().numpy(),
                                       np.asarray(expected), atol=5e-5,
                                       rtol=0, err_msg=f"{name}.{key}")
    assert losses[-1] < losses[0]
