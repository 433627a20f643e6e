# Classical vision elements: face detection + ArUco fiducial detection.
#
# Counterpart of aiko_services_tpu/elements/vision.py, with the same class
# names, parameters, detections dict ({boxes, scores, classes, valid},
# the Detector element's contract) and overlay fields.  These are
# host-side elements by nature (tiny integer workloads): an image that
# arrives as a tensor on the device (ImageSource on_device, ImageResize)
# is read back to the host first, and from there the code is the JAX
# package's numpy / scipy / cv2 code, so both packages give the same
# detections for the same image.
#
# cv2 and scipy are import-gated exactly as in the JAX package: a missing
# backend turns the element into a clear error, not an import crash.

from __future__ import annotations

import numpy as np

from ..pipeline import PipelineElement, StreamEvent
from ..utils import get_logger
from .common_io import host_array

__all__ = ["FaceDetect", "ArucoDetect"]

_LOGGER = get_logger("vision")


def _require_cv2():
    try:
        import cv2
        return cv2
    except ImportError as error:  # pragma: no cover - cv2 in test image
        raise RuntimeError(
            "OpenCV (cv2) is required for classical vision elements") \
            from error


def _to_gray_uint8(image) -> np.ndarray:
    """Accept CHW float [0,1], HWC float/uint8, or gray; return HxW u8."""
    array = host_array(image)
    if array.ndim == 4:
        array = array[0]
    if array.ndim == 3 and array.shape[0] in (1, 3):   # CHW -> HWC
        array = array.transpose(1, 2, 0)
    if array.dtype != np.uint8:
        array = (np.clip(array, 0.0, 1.0) * 255.0).astype(np.uint8)
    if array.ndim == 3:
        array = np.ascontiguousarray(array[..., :3].mean(axis=-1)
                                     .astype(np.uint8))
    return np.ascontiguousarray(array)


def _detections_dict(boxes_xyxy, scores, classes, max_detections: int):
    """Pack variable-count host detections into the Detector element's
    fixed-size contract (boxes (N,4) xyxy, scores, classes, valid)."""
    boxes = np.zeros((max_detections, 4), np.float32)
    out_scores = np.zeros((max_detections,), np.float32)
    out_classes = np.zeros((max_detections,), np.int32)
    valid = np.zeros((max_detections,), bool)
    count = min(len(boxes_xyxy), max_detections)
    for index in range(count):
        boxes[index] = boxes_xyxy[index]
        out_scores[index] = scores[index]
        out_classes[index] = classes[index]
        valid[index] = True
    return {"boxes": boxes, "scores": out_scores, "classes": out_classes,
            "valid": valid}


def _to_rgb_float(image) -> np.ndarray:
    """Accept CHW/HWC float [0,1] or uint8; return HxWx3 float [0,1]."""
    array = host_array(image)
    if array.ndim == 4:
        array = array[0]
    if array.ndim == 3 and array.shape[0] in (1, 3):   # CHW -> HWC
        array = array.transpose(1, 2, 0)
    if array.dtype == np.uint8:
        array = array.astype(np.float32) / 255.0
    if array.ndim == 2:
        array = np.stack([array] * 3, axis=-1)
    return np.clip(array[..., :3].astype(np.float32), 0.0, 1.0)


def _skin_mask(rgb: np.ndarray) -> np.ndarray:
    """Classical RGB skin-color rule (Kovac et al.): the segmentation
    stage of the built-in face detector."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    peak = rgb.max(axis=-1)
    spread = peak - rgb.min(axis=-1)
    return ((r > 95 / 255) & (g > 40 / 255) & (b > 20 / 255)
            & (spread > 15 / 255) & (np.abs(r - g) > 15 / 255)
            & (r > g) & (r > b))


class FaceDetect(PipelineElement):
    """Face detector filling the reference's cascade seat (reference
    face.py:82: cv2 Haar cascade -> overlay contract; the cascade API was
    removed in OpenCV 5, so the default backend here is a self-contained
    classical pipeline -- skin-color segmentation + connected-component
    shape analysis -- with cv2's cascade used only when a "cascade"
    parameter names a model on an OpenCV that still ships it).  Emits the
    Detector element's detections dict + overlay {objects, rectangles}."""

    _cascade = None

    def _detect_classical(self, image, stream):
        try:
            from scipy import ndimage
        except ImportError as error:
            raise RuntimeError(
                "scipy is required for the built-in face detector "
                "(pip install scipy); alternatively "
                "set the 'cascade' parameter on an OpenCV build that "
                "ships CascadeClassifier") from error
        rgb = _to_rgb_float(image)
        mask = _skin_mask(rgb)
        labels, count = ndimage.label(mask)
        height, width = mask.shape
        min_area = float(self.get_parameter(
            "min_area_fraction", 0.002, stream)) * height * width
        results = []
        for index, (slice_y, slice_x) in enumerate(
                ndimage.find_objects(labels)):
            h = slice_y.stop - slice_y.start
            w = slice_x.stop - slice_x.start
            # only THIS component's pixels (find_objects slices are
            # ordered by label id); a bbox may overlap other blobs
            region = labels[slice_y, slice_x] == index + 1
            area = int(region.sum())
            if area < min_area or h == 0 or w == 0:
                continue
            aspect = h / w
            fill = area / (h * w)
            # faces are roughly upright ellipses: aspect ~ 0.8-2.2,
            # solid fill (an ellipse fills pi/4 ~ 0.785 of its bbox)
            if not (0.6 <= aspect <= 2.5 and fill >= 0.5):
                continue
            results.append((slice_x.start, slice_y.start, w, h,
                            min(1.0, fill)))
        results.sort(key=lambda item: -(item[2] * item[3]))
        return results

    def _detect_cascade(self, image, stream, cascade_path):
        cv2 = _require_cv2()
        if self._cascade is None:
            if not hasattr(cv2, "CascadeClassifier"):
                raise RuntimeError(
                    "this OpenCV build has no CascadeClassifier "
                    "(removed in OpenCV 5); drop the 'cascade' "
                    "parameter to use the built-in detector")
            self._cascade = cv2.CascadeClassifier(str(cascade_path))
            if self._cascade.empty():
                raise RuntimeError(
                    f"cascade failed to load: {cascade_path}")
        scale = float(self.get_parameter("scale_factor", 1.1, stream))
        neighbors = int(self.get_parameter("min_neighbors", 5, stream))
        faces = self._cascade.detectMultiScale(
            _to_gray_uint8(image), scaleFactor=scale,
            minNeighbors=neighbors)
        return [(int(x), int(y), int(w), int(h), 1.0)
                for (x, y, w, h) in (faces if len(faces) else [])]

    def process_frame(self, stream, image):
        max_detections = int(
            self.get_parameter("max_detections", 32, stream))
        cascade_path = self.get_parameter("cascade", None, stream)
        if cascade_path:
            found = self._detect_cascade(image, stream, cascade_path)
        else:
            found = self._detect_classical(image, stream)
        boxes, scores, objects, rectangles = [], [], [], []
        for (x, y, w, h, confidence) in found:
            boxes.append([x, y, x + w, y + h])
            scores.append(confidence)
            objects.append({"name": "face",
                            "confidence": round(float(confidence), 3)})
            rectangles.append({"x": int(x), "y": int(y),
                               "w": int(w), "h": int(h)})
        detections = _detections_dict(
            boxes, scores, [0] * len(boxes), max_detections)
        return StreamEvent.OKAY, {
            "detections": detections,
            "overlay": {"objects": objects, "rectangles": rectangles}}


class ArucoDetect(PipelineElement):
    """ArUco fiducial detector (reference aruco.py:187): image ->
    marker ids + corners + detections/overlay contract; optional pose
    when camera parameters are supplied."""

    _detectors: dict | None = None

    def _get_detector(self, stream):
        cv2 = _require_cv2()
        name = str(self.get_parameter("dictionary", "DICT_4X4_50",
                                      stream))
        if self._detectors is None:
            self._detectors = {}
        detector = self._detectors.get(name)
        if detector is None:
            dictionary = cv2.aruco.getPredefinedDictionary(
                getattr(cv2.aruco, name))
            detector = cv2.aruco.ArucoDetector(
                dictionary, cv2.aruco.DetectorParameters())
            self._detectors[name] = detector
        return detector

    def process_frame(self, stream, image):
        gray = _to_gray_uint8(image)
        max_detections = int(
            self.get_parameter("max_detections", 32, stream))
        corners, ids, _ = self._get_detector(stream).detectMarkers(gray)
        boxes, classes, objects, rectangles = [], [], [], []
        marker_corners = []
        if ids is not None:
            for marker_id, quad in zip(ids.reshape(-1), corners):
                points = quad.reshape(-1, 2)
                x0, y0 = points.min(axis=0)
                x1, y1 = points.max(axis=0)
                boxes.append([x0, y0, x1, y1])
                classes.append(int(marker_id))
                objects.append({"name": f"aruco_{int(marker_id)}",
                                "confidence": 1.0})
                rectangles.append({"x": int(x0), "y": int(y0),
                                   "w": int(x1 - x0), "h": int(y1 - y0)})
                marker_corners.append(points.tolist())
        detections = _detections_dict(
            boxes, [1.0] * len(boxes), classes, max_detections)
        outputs = {
            "detections": detections,
            "markers": {"ids": [int(i) for i in (
                ids.reshape(-1) if ids is not None else [])],
                "corners": marker_corners},
            "overlay": {"objects": objects, "rectangles": rectangles},
        }
        return StreamEvent.OKAY, outputs
