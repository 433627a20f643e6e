# Video I/O elements.
#
# Counterpart of aiko_services_tpu/elements/video_io.py, with cv2 imported
# as the JAX package imports it (inside the elements: a stream that needs
# it and lacks it gets a diagnostic); frames that arrive as tensors on the
# device are read back with .cpu() before any numpy.
#
# Capability parity with the reference video elements (reference:
# src/aiko_services/elements/media/video_io.py:119-305: VideoReadFile
# (cv2.VideoCapture frame iterator chaining files), VideoSample, VideoShow
# (cv2 GUI), VideoWriteFile (fourcc writer), VideoOutput).  VideoShow is
# headless-gated; frames flow as (3, H, W) f32 [0,1] CHW arrays ready for
# on-device compute.

from __future__ import annotations

import numpy as np

from ..pipeline import PipelineElement, StreamEvent
from ..utils import get_logger
from .common_io import DataSource, DataTarget, Sample, host_array

__all__ = ["VideoReadFile", "VideoSample", "VideoWriteFile", "VideoOutput"]

_LOGGER = get_logger("video_io")


class VideoReadFile(DataSource):
    """data_sources of video paths -> one frame per pipeline frame,
    chaining files (reference video_io.py:119-166)."""

    def start_stream(self, stream, stream_id):
        try:
            import cv2  # noqa: F401
        except ImportError:
            return StreamEvent.ERROR, {
                "diagnostic": "VideoReadFile needs cv2 (opencv)"}
        return super().start_stream(stream, stream_id)

    def _frame_generator(self, stream, frame_id):
        import cv2
        items = stream.variables[f"{self.definition.name}.items"]
        capture_key = f"{self.definition.name}.capture"
        cursor_key = f"{self.definition.name}.cursor"
        while True:
            capture = stream.variables.get(capture_key)
            if capture is None:
                cursor = stream.variables.get(cursor_key, 0)
                if cursor >= len(items):
                    return StreamEvent.STOP, {
                        "diagnostic": "video files exhausted"}
                capture = cv2.VideoCapture(str(items[cursor]))
                if not capture.isOpened():
                    return StreamEvent.ERROR, {
                        "diagnostic": f"cannot open {items[cursor]}"}
                stream.variables[capture_key] = capture
                stream.variables[cursor_key] = cursor + 1
            ok, frame_bgr = capture.read()
            if ok:
                rgb = frame_bgr[:, :, ::-1].astype(np.float32) / 255.0
                return StreamEvent.OKAY, {"image": rgb.transpose(2, 0, 1)}
            capture.release()
            stream.variables[capture_key] = None  # next file

    def read_item(self, stream, item) -> dict:  # pragma: no cover
        raise NotImplementedError("VideoReadFile streams via generator")


class VideoSample(Sample):
    """Drop-frame sampler over video frames (shared Sample base;
    reference video_io.py VideoSample)."""


class VideoWriteFile(DataTarget):
    """{"image"} frames -> one video file (reference video_io.py:240-305).
    Writer opens lazily on the first frame (size known then)."""

    def process_frame(self, stream, image):
        import cv2
        writer_key = f"{self.definition.name}.writer"
        writer = stream.variables.get(writer_key)
        array = host_array(image)
        if array.ndim == 4:
            array = array[0]
        if array.shape[0] in (1, 3):  # CHW -> HWC
            array = array.transpose(1, 2, 0)
        if array.dtype != np.uint8:
            array = (array * 255.0).clip(0, 255).astype(np.uint8)
        bgr = np.ascontiguousarray(array[:, :, ::-1])
        if writer is None:
            path = self.next_target_path(stream)
            rate = float(self.get_parameter("frame_rate", 25.0, stream))
            fourcc = cv2.VideoWriter_fourcc(
                *str(self.get_parameter("fourcc", "mp4v", stream)))
            writer = cv2.VideoWriter(
                path, fourcc, rate, (bgr.shape[1], bgr.shape[0]))
            stream.variables[writer_key] = writer
        writer.write(bgr)
        return StreamEvent.OKAY, {"image": image}

    def stop_stream(self, stream, stream_id):
        writer = stream.variables.get(f"{self.definition.name}.writer")
        if writer is not None:
            writer.release()
        return StreamEvent.OKAY, None


class VideoOutput(PipelineElement):
    """Log frame shapes; VideoShow's headless stand-in (reference
    video_io.py:197-233 opens a cv2 GUI window)."""

    def process_frame(self, stream, image):
        array = host_array(image)
        count_key = f"{self.definition.name}.count"
        stream.variables[count_key] = stream.variables.get(count_key, 0) + 1
        _LOGGER.debug("%s: frame %d %s", self.definition.name,
                      stream.variables[count_key], array.shape)
        return StreamEvent.OKAY, {"image": image}
