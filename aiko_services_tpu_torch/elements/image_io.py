# Image I/O elements and image synthesis helpers.
#
# Counterpart of aiko_services_tpu/elements/image_io.py: ImageReadFile
# (PIL), ImageOverlay (cv2 boxes and labels over the Detector's
# detections, the reference's overlay contract) and ImageWriteFile, and
# the synthesis helpers (the ImageSource, ImageResize and ImageOutput
# elements are not ported yet).  Images and detections that arrive as
# tensors on the device are read back with .cpu() before any numpy; cv2
# stays import-guarded, as in the JAX package (without it the overlay
# dict is built and nothing is drawn).  The host image is the JAX
# package's numpy code, bit for bit.  The on-device image cannot
# reproduce jax.random's bits: it draws from a torch.Generator seeded with
# the same seed on the device the caller names (deterministic per seed and
# device, different numbers from the JAX package's).

from __future__ import annotations

import numpy as np
import torch

from ..ops.device import resolve_device
from ..pipeline import PipelineElement, StreamEvent
from .common_io import DataSource, DataTarget

__all__ = ["ImageReadFile", "ImageOverlay", "ImageWriteFile",
           "synthesize_image", "synthesize_image_on_device", "host_array"]


def host_array(value) -> np.ndarray:
    """An element input as a numpy array on the host: a tensor (on any
    device) is read back first -- np.asarray on a CUDA tensor raises."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
    return np.asarray(value)


def synthesize_image(shape, seed: int) -> np.ndarray:
    """Deterministic random image (C, H, W) f32 in [0, 1]."""
    rng = np.random.default_rng(int(seed))
    return rng.random(tuple(int(size) for size in shape),
                      dtype=np.float32)


def synthesize_image_on_device(shape, seed: int,
                               device="cuda") -> torch.Tensor:
    """Deterministic random image (C, H, W) f32 in [0, 1) drawn on
    `device` from a generator seeded with `seed`."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(tuple(int(size) for size in shape),
                      generator=generator, device=device)


class ImageReadFile(DataSource):
    """data_sources of image paths -> {"image": (3, H, W) f32 [0,1]}."""

    def read_item(self, stream, item) -> dict:
        from PIL import Image
        with Image.open(item) as handle:
            array = np.asarray(handle.convert("RGB"), np.float32) / 255.0
        return {"image": array.transpose(2, 0, 1)}


class ImageOverlay(PipelineElement):
    """Draw detection rectangles/labels onto the image (host-side, like
    the reference's cv2 overlay consumer, image_io.py:97-163).  Expects the
    Detector element's detections dict; emits the annotated image plus the
    reference-shaped overlay dict."""

    def process_frame(self, stream, image, detections):
        image_np = host_array(image)
        if image_np.ndim == 4:
            image_np = image_np[0]
        canvas = np.ascontiguousarray(
            (image_np.transpose(1, 2, 0) * 255.0).clip(0, 255)
            .astype(np.uint8))
        boxes, scores, classes, valid = (
            host_array(detections[name])
            for name in ("boxes", "scores", "classes", "valid"))
        if boxes.ndim == 3:  # batched: first image
            boxes, scores, classes, valid = (
                boxes[0], scores[0], classes[0], valid[0])
        objects, rectangles = [], []
        try:
            import cv2
        except ImportError:  # pragma: no cover
            cv2 = None
        for box, score, class_id, ok in zip(boxes, scores, classes, valid):
            if not ok:
                continue
            x0, y0, x1, y1 = (int(v) for v in box)
            objects.append({"name": f"class_{int(class_id)}",
                            "confidence": float(score)})
            rectangles.append({"x": x0, "y": y0,
                               "w": x1 - x0, "h": y1 - y0})
            if cv2 is not None:
                cv2.rectangle(canvas, (x0, y0), (x1, y1), (0, 255, 0), 2)
                cv2.putText(canvas, f"{int(class_id)}:{score:.2f}",
                            (x0, max(y0 - 4, 10)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.4, (0, 255, 0), 1)
        overlay = {"objects": objects, "rectangles": rectangles}
        return StreamEvent.OKAY, {"image": canvas, "overlay": overlay}


class ImageWriteFile(DataTarget):
    """{"image"} -> image files at data_targets (templated paths)."""

    def process_frame(self, stream, image):
        from PIL import Image
        array = host_array(image)
        if array.ndim == 4:
            array = array[0]
        if array.ndim == 3 and array.shape[0] in (1, 3):  # CHW -> HWC
            array = array.transpose(1, 2, 0)
        if array.dtype != np.uint8:
            array = (array * 255.0).clip(0, 255).astype(np.uint8)
        path = self.next_target_path(stream)
        Image.fromarray(array.squeeze()).save(path)
        return StreamEvent.OKAY, {"image": image}
