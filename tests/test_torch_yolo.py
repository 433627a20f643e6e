# The port's YOLOv8 (models/yolo.py) and the Detector element's
# ultralytics branch against the JAX package's on the CPU: both packages
# load ONE ultralytics-named checkpoint, written here from a seeded numpy
# rng (the JAX package's tests/test_weights_tokenizer.py writes the same
# layout), and see the same numpy images.  Mirrors that file's five YOLO
# tests, each held against the JAX package.
#
# Tolerances: loaded parameters bit-identical (the same numpy f32 BN fold,
# then one cast); BN folding against conv-then-BN rtol 2e-4, atol 2e-5
# (the JAX test's: the fold reassociates w * scale); the raw heads atol
# 1e-4 (about 25 f32 convolutions deep, values of order 1-10, the same
# products summed in another order); decoded detections: boxes atol 1e-3
# pixels, scores atol 1e-5, classes and the valid mask identical; the
# SPPF pool exactly reduce_window's, in f32 and in bf16 (a max selects one
# of its inputs: no rounding).

import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import yolo as jax_yolo
from aiko_services_tpu_torch.models import params_to_numpy, write_safetensors
from aiko_services_tpu_torch.models import yolo as torch_yolo
from aiko_services_tpu_torch.pipeline import create_pipeline
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.transport import reset_brokers

MODULE = "aiko_services_tpu_torch.elements"
TINY = dict(n_classes=4, width=(4, 8, 16, 32, 64), repeats=(1, 2, 2, 1),
            image_size=64, max_detections=8, score_threshold=0.01,
            dtype="float32")


@pytest.fixture(autouse=True)
def clean_brokers():
    reset_brokers()
    yield
    reset_brokers()


def write_ultralytics_yolo(path, config, seed=0) -> dict:
    """An ultralytics YOLOv8 state_dict from a seeded rng: torch (O, I,
    kh, kw) conv weights with separate BatchNorm tensors; the head's last
    1x1 convs plain, with a bias."""
    rng = np.random.default_rng(seed)
    tensors = {}

    def conv_bn(stem, c_in, c_out, k):
        tensors[f"{stem}.conv.weight"] = (
            rng.standard_normal((c_out, c_in, k, k)).astype(np.float32)
            * 0.1)
        tensors[f"{stem}.bn.weight"] = rng.uniform(
            0.5, 1.5, c_out).astype(np.float32)
        tensors[f"{stem}.bn.bias"] = (
            rng.standard_normal(c_out).astype(np.float32) * 0.1)
        tensors[f"{stem}.bn.running_mean"] = (
            rng.standard_normal(c_out).astype(np.float32) * 0.1)
        tensors[f"{stem}.bn.running_var"] = rng.uniform(
            0.5, 2.0, c_out).astype(np.float32)

    def plain(stem, c_in, c_out):
        tensors[f"{stem}.weight"] = (
            rng.standard_normal((c_out, c_in, 1, 1)).astype(np.float32)
            * 0.1)
        tensors[f"{stem}.bias"] = (
            rng.standard_normal(c_out).astype(np.float32) * 0.1)

    def c2f(module, c_in, c_out, n):
        half = c_out // 2
        conv_bn(f"model.{module}.cv1", c_in, c_out, 1)
        conv_bn(f"model.{module}.cv2", (2 + n) * half, c_out, 1)
        for i in range(n):
            conv_bn(f"model.{module}.m.{i}.cv1", half, half, 3)
            conv_bn(f"model.{module}.m.{i}.cv2", half, half, 3)

    w, r = config.width, config.repeats
    conv_bn("model.0", 3, w[0], 3)
    conv_bn("model.1", w[0], w[1], 3)
    c2f(2, w[1], w[1], r[0])
    conv_bn("model.3", w[1], w[2], 3)
    c2f(4, w[2], w[2], r[1])
    conv_bn("model.5", w[2], w[3], 3)
    c2f(6, w[3], w[3], r[2])
    conv_bn("model.7", w[3], w[4], 3)
    c2f(8, w[4], w[4], r[3])
    conv_bn("model.9.cv1", w[4], w[4] // 2, 1)
    conv_bn("model.9.cv2", w[4] * 2, w[4], 1)
    c2f(12, w[4] + w[3], w[3], 1)
    c2f(15, w[3] + w[2], w[2], 1)
    conv_bn("model.16", w[2], w[2], 3)
    c2f(18, w[3] + w[2], w[3], 1)
    conv_bn("model.19", w[3], w[3], 3)
    c2f(21, w[4] + w[3], w[4], 1)
    box_c, cls_c = config.head_box_hidden, config.head_cls_hidden
    for scale, c_in in enumerate((w[2], w[3], w[4])):
        conv_bn(f"model.22.cv2.{scale}.0", c_in, box_c, 3)
        conv_bn(f"model.22.cv2.{scale}.1", box_c, box_c, 3)
        plain(f"model.22.cv2.{scale}.2", box_c, 4 * config.reg_max)
        conv_bn(f"model.22.cv3.{scale}.0", c_in, cls_c, 3)
        conv_bn(f"model.22.cv3.{scale}.1", cls_c, cls_c, 3)
        plain(f"model.22.cv3.{scale}.2", cls_c, config.n_classes)
    write_safetensors(path, tensors)
    return tensors


@pytest.fixture
def checkpoint(tmp_path):
    path = tmp_path / "yolo.safetensors"
    tensors = write_ultralytics_yolo(path, torch_yolo.YoloV8Config(**TINY))
    return path, tensors


def _flat(tree) -> list:
    """(path, numpy leaf) in tree order, lists walked like jax.tree_util."""
    return [(jax.tree_util.keystr(path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_matches_init_and_jax_bit_for_bit(checkpoint, dtype):
    path, _ = checkpoint
    config = torch_yolo.YoloV8Config(**{**TINY, "dtype": dtype})
    loaded = torch_yolo.load_yolov8_params(path, config, device="cpu")
    initialized = torch_yolo.init_yolo_params(
        config, torch.Generator().manual_seed(0), device="cpu")
    as_numpy = params_to_numpy(loaded)
    assert ([(name, leaf.shape) for name, leaf in _flat(as_numpy)]
            == [(name, leaf.shape)
                for name, leaf in _flat(params_to_numpy(initialized))])
    expected = jax_yolo.load_yolov8_params(
        path, jax_yolo.YoloV8Config(**{**TINY, "dtype": dtype}))
    for (name, actual), (_, want) in zip(_flat(as_numpy), _flat(expected)):
        np.testing.assert_array_equal(actual, want.astype(np.float32),
                                      err_msg=name)
    leaf = loaded["m22"]["cv3"][2][1]["w"]
    assert leaf.dtype == getattr(torch, dtype)


def test_bn_folding_is_numerically_exact(checkpoint):
    """conv2d of the folded parameters equals BatchNorm(conv(x)) computed
    the torch way (eps=1e-3)."""
    from aiko_services_tpu_torch.models.layers import conv2d
    path, tensors = checkpoint
    config = torch_yolo.YoloV8Config(**TINY)
    params = torch_yolo.load_yolov8_params(path, config, device="cpu")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 6, 6, 3)).astype(np.float32))
    folded = conv2d(params["m0"], x, stride=2).numpy()
    w = tensors["model.0.conv.weight"]
    raw_out = conv2d({"w": torch.from_numpy(np.ascontiguousarray(
        w.transpose(2, 3, 1, 0)))}, x, stride=2).numpy()
    expected = ((raw_out - tensors["model.0.bn.running_mean"])
                / np.sqrt(tensors["model.0.bn.running_var"] + 1e-3)
                * tensors["model.0.bn.weight"] + tensors["model.0.bn.bias"])
    np.testing.assert_allclose(folded, expected, rtol=2e-4, atol=2e-5)


def test_yolo_forward_and_detect_match_jax(checkpoint):
    path, _ = checkpoint
    config = torch_yolo.YoloV8Config(**TINY)
    jax_config = jax_yolo.YoloV8Config(**TINY)
    params = torch_yolo.load_yolov8_params(path, config, device="cpu")
    jax_params = jax_yolo.load_yolov8_params(path, jax_config)
    images = np.random.default_rng(1).random((2, 3, 64, 64), np.float32)
    heads = torch_yolo.yolo_forward(params, config, torch.from_numpy(images))
    jax_heads = jax_yolo.yolo_forward(jax_params, jax_config,
                                      jnp.asarray(images))
    for head, jax_head in zip(heads, jax_heads):
        assert tuple(head.shape) == jax_head.shape
        np.testing.assert_allclose(head.numpy(), np.asarray(jax_head),
                                   atol=1e-4, rtol=0)
    out = torch_yolo.yolo_detect(params, config, torch.from_numpy(images))
    expected = jax_yolo.yolo_detect(jax_params, jax_config,
                                    jnp.asarray(images))
    assert out["boxes"].shape == (2, config.max_detections, 4)
    assert out["scores"].shape == (2, config.max_detections)
    assert out["classes"].dtype == torch.int32
    assert bool(torch.isfinite(out["boxes"]).all())
    valid = out["valid"].numpy()
    assert valid.any()
    np.testing.assert_array_equal(valid, np.asarray(expected["valid"]))
    np.testing.assert_array_equal(out["classes"].numpy(),
                                  np.asarray(expected["classes"]))
    np.testing.assert_allclose(out["scores"].numpy(),
                               np.asarray(expected["scores"]), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(out["boxes"].numpy(),
                               np.asarray(expected["boxes"]), atol=1e-3,
                               rtol=0)
    picked = out["boxes"].numpy()[valid]
    assert (picked[:, 2] >= picked[:, 0]).all()
    assert (picked[:, 3] >= picked[:, 1]).all()


def test_detector_element_ingests_ultralytics_yolo(checkpoint):
    """The Detector probes the checkpoint's names, reads the architecture
    off its shapes (yolo_variant auto) and detects with yolo_detect: the
    same detections as the JAX package's element on the same image."""
    path, _ = checkpoint
    image = np.random.default_rng(9).random((1, 3, 64, 64), np.float32)
    parameters = {"weights": str(path), "n_classes": 4, "image_size": 64,
                  "max_detections": 8, "score_threshold": 0.01,
                  "dtype": "float32"}
    definition = {
        "name": "det_yolo",
        "graph": ["(detector)"],
        "parameters": {"device": "cpu"},
        "elements": [
            {"name": "detector", "input": [{"name": "image"}],
             "output": [{"name": "detections"}], "parameters": parameters,
             "deploy": {"local": {"module": MODULE,
                                  "class_name": "Detector"}}}],
    }
    process = Process(transport_kind="loopback")
    try:
        pipeline = create_pipeline(process, definition)
        process.run(in_thread=True)
        responses = queue.Queue()
        stream = pipeline.create_stream("s", queue_response=responses)
        pipeline.create_frame(stream, {"image": image})
        _, _, outputs = responses.get(timeout=60)
    finally:
        process.terminate()
    detections = {key: value.numpy()
                  for key, value in outputs["detections"].items()}
    assert detections["boxes"].shape == (1, 8, 4)
    jax_config = jax_yolo.infer_yolov8_config(
        path, image_size=64, max_detections=8, score_threshold=0.01,
        dtype="float32")
    expected = jax_yolo.yolo_detect(
        jax_yolo.load_yolov8_params(path, jax_config), jax_config,
        jnp.asarray(image))
    np.testing.assert_array_equal(detections["valid"],
                                  np.asarray(expected["valid"]))
    np.testing.assert_array_equal(detections["classes"],
                                  np.asarray(expected["classes"]))
    np.testing.assert_allclose(detections["boxes"],
                               np.asarray(expected["boxes"]), atol=1e-3,
                               rtol=0)


def test_infer_yolov8_config_reads_architecture_from_shapes(checkpoint):
    path, _ = checkpoint
    inferred = torch_yolo.infer_yolov8_config(path, image_size=64,
                                              dtype="float32")
    expected = jax_yolo.infer_yolov8_config(path, image_size=64,
                                            dtype="float32")
    config = torch_yolo.YoloV8Config(**TINY)
    assert inferred.width == expected.width == config.width
    assert inferred.repeats == expected.repeats == config.repeats
    assert inferred.neck_repeats == expected.neck_repeats == 1
    assert inferred.n_classes == expected.n_classes == 4
    assert inferred.reg_max == expected.reg_max == 16
    assert inferred.image_size == 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sppf_pool_is_reduce_window(dtype):
    """The SPPF's 5x5 stride-1 "SAME" max pool with a -inf init, at an
    odd and an even size, with negative values at the borders."""
    x = np.random.default_rng(3).standard_normal((2, 7, 10, 6)).astype(
        np.float32) - 1.0
    jax_x = jnp.asarray(x, getattr(jnp, dtype))
    expected = jax.lax.reduce_window(jax_x, -jnp.inf, jax.lax.max,
                                     (1, 5, 5, 1), (1, 1, 1, 1), "SAME")
    actual = torch_yolo._max_pool5(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert actual.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(actual.float().numpy(),
                                  np.asarray(expected, np.float32))


def test_input_not_divisible_by_32_raises(checkpoint):
    path, _ = checkpoint
    config = torch_yolo.YoloV8Config(**TINY)
    params = torch_yolo.load_yolov8_params(path, config, device="cpu")
    with pytest.raises(ValueError, match="divisible by 32"):
        torch_yolo.yolo_forward(params, config, torch.zeros((1, 3, 48, 64)))


def test_wrong_variant_names_the_checkpoints_variant(tmp_path):
    """A checkpoint whose stem has yolov8s's 32 channels (the rest kept
    small) loaded as yolov8n."""
    path = tmp_path / "yolo_s.safetensors"
    write_ultralytics_yolo(path, torch_yolo.YoloV8Config(
        **{**TINY, "width": (32, 8, 16, 32, 64)}))
    with pytest.raises(ValueError, match="yolov8s"):
        torch_yolo.load_yolov8_params(path, torch_yolo.YOLOV8N,
                                      device="cpu")
