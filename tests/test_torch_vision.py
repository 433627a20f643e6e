# The port's classical vision elements (elements/vision.py) against the
# JAX package's, case for case after tests/test_tts_vision_robot.py: the
# same image into both elements, and every output -- the detections
# dict, the markers, the overlay -- must be equal (both run the same
# numpy / scipy / cv2 code on the host).  The port also takes the image
# as a tensor (what ImageSource on_device and ImageResize emit), read
# back before the host code, with the same result.  This machine has cv2
# 5 with aruco and without CascadeClassifier; the card's has no cv2, so
# ArucoDetect and the cascade path are CPU tests only.

import numpy as np
import pytest
import torch

from aiko_services_tpu.elements import vision as jax_vision
from aiko_services_tpu_torch.elements import vision

SKIN = (224 / 255, 160 / 255, 130 / 255)


def _element(cls, params=None):
    params = dict(params or {})
    element = cls.__new__(cls)
    element.get_parameter = (lambda name, default=None, stream=None:
                             params.get(name, default))
    return element


def _both(name, image, params=None, as_tensor=False):
    """(port outputs, JAX outputs) of element class `name` on `image`."""
    port_class = getattr(vision, name)
    jax_class = getattr(jax_vision, name)
    port_input = torch.from_numpy(np.ascontiguousarray(image)) \
        if as_tensor else image
    _, got = port_class.process_frame(_element(port_class, params), None,
                                      port_input)
    _, want = jax_class.process_frame(_element(jax_class, params), None,
                                      image)
    return got, want


def _assert_same(got, want):
    assert set(got) == set(want)
    for key in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(got["detections"][key],
                                      want["detections"][key])
        assert got["detections"][key].dtype == want["detections"][key].dtype
    assert got["overlay"] == want["overlay"]
    if "markers" in want:
        assert got["markers"] == want["markers"]


def _face_image():
    """A skin-tone ellipse (a face-shaped blob) on a blue background,
    CHW float -- the Detector-side image convention."""
    height, width = 120, 160
    yy, xx = np.mgrid[0:height, 0:width]
    ellipse = (((yy - 60) / 35.0) ** 2 + ((xx - 80) / 25.0) ** 2) <= 1.0
    image = np.zeros((height, width, 3), np.float32)
    image[...] = (0.1, 0.2, 0.8)
    image[ellipse] = SKIN
    return image.transpose(2, 0, 1)


def _marker_canvas(dictionary_name, marker_id):
    cv2 = pytest.importorskip("cv2")
    dictionary = cv2.aruco.getPredefinedDictionary(
        getattr(cv2.aruco, dictionary_name))
    marker = cv2.aruco.generateImageMarker(dictionary, marker_id, 120)
    canvas = np.full((300, 300), 255, np.uint8)
    canvas[90:210, 90:210] = marker
    return canvas


@pytest.mark.parametrize("as_tensor", [False, True])
def test_aruco_detects_rendered_marker(as_tensor):
    got, want = _both("ArucoDetect", _marker_canvas("DICT_4X4_50", 7),
                      as_tensor=as_tensor)
    _assert_same(got, want)
    assert got["markers"]["ids"] == [7]
    detections = got["detections"]
    assert bool(detections["valid"][0])
    assert int(detections["classes"][0]) == 7
    x0, _, x1, _ = detections["boxes"][0]
    assert 80 <= x0 <= 100 and 200 <= x1 <= 220
    assert got["overlay"]["objects"][0]["name"] == "aruco_7"


def test_aruco_no_markers():
    pytest.importorskip("cv2")
    got, want = _both("ArucoDetect", np.zeros((64, 64), np.uint8))
    _assert_same(got, want)
    assert got["markers"]["ids"] == []
    assert not got["detections"]["valid"].any()


def test_aruco_dictionary_parameter_is_stream_scoped():
    got, want = _both("ArucoDetect", _marker_canvas("DICT_6X6_250", 11),
                      params={"dictionary": "DICT_6X6_250"})
    _assert_same(got, want)
    assert got["markers"]["ids"] == [11]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_face_detect_finds_skin_ellipse(as_tensor):
    got, want = _both("FaceDetect", _face_image(), as_tensor=as_tensor)
    _assert_same(got, want)
    objects = got["overlay"]["objects"]
    assert len(objects) == 1 and objects[0]["name"] == "face"
    rect = got["overlay"]["rectangles"][0]
    assert 50 <= rect["x"] <= 60 and 20 <= rect["y"] <= 30
    assert 44 <= rect["w"] <= 56 and 64 <= rect["h"] <= 76
    assert bool(got["detections"]["valid"][0])
    assert float(got["detections"]["scores"][0]) > 0.5


def test_face_detect_rejects_non_face_shapes():
    image = np.zeros((120, 160, 3), np.float32)
    image[...] = (0.1, 0.2, 0.8)
    image[58:62, 10:150] = SKIN   # a thin bar fails the aspect/fill gates
    got, want = _both("FaceDetect", image.transpose(2, 0, 1))
    _assert_same(got, want)
    assert got["overlay"]["objects"] == []
    assert not got["detections"]["valid"].any()


def test_overlapping_bbox_does_not_inflate_other_component():
    image = np.zeros((120, 160, 3), np.float32)
    image[...] = (0.1, 0.2, 0.8)
    yy, xx = np.mgrid[0:120, 0:160]
    image[(((yy - 60) / 30.0) ** 2 + ((xx - 60) / 22.0) ** 2) <= 1] = SKIN
    image[10:13, 30:150] = SKIN   # bar overlapping the face's columns
    got, want = _both("FaceDetect", image.transpose(2, 0, 1))
    _assert_same(got, want)
    assert [o["name"] for o in got["overlay"]["objects"]] == ["face"]


def test_face_detect_on_a_batched_uint8_image():
    """(1, H, W, 3) uint8, HWC: the other input layout _to_rgb_float
    takes, with max_detections cutting the dict."""
    image = (_face_image().transpose(1, 2, 0) * 255).astype(np.uint8)[None]
    got, want = _both("FaceDetect", image, params={"max_detections": 4},
                      as_tensor=True)
    _assert_same(got, want)
    assert got["detections"]["boxes"].shape == (4, 4)


def test_cascade_without_cascade_classifier_is_a_clear_error():
    cv2 = pytest.importorskip("cv2")
    if hasattr(cv2, "CascadeClassifier"):
        pytest.skip("this OpenCV still ships CascadeClassifier")
    for module in (vision, jax_vision):
        element = _element(module.FaceDetect, {"cascade": "face.xml"})
        with pytest.raises(RuntimeError, match="CascadeClassifier"):
            module.FaceDetect.process_frame(element, None, _face_image())
