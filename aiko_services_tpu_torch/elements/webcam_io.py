# Webcam capture element.
#
# Counterpart of aiko_services_tpu/elements/webcam_io.py (the reference's
# VideoReadWebcam on /dev/videoN), with the same contract: (3, H, W) f32
# RGB frames in [0, 1] on the host, gated on cv2 and an openable capture
# device with the same diagnostics.  The card's machine has neither a
# camera nor cv2; ImageSource / MultiModalSource are the hermetic
# stand-ins there.

from __future__ import annotations

import numpy as np

from ..pipeline import StreamEvent
from ..utils import get_logger
from .common_io import DataSource

__all__ = ["VideoReadWebcam"]

_LOGGER = get_logger("webcam_io")


class VideoReadWebcam(DataSource):
    """data_sources of device indices/paths (e.g. [0] or ["/dev/video0"])
    -> continuous {"image": (3, H, W) f32} frames."""

    def start_stream(self, stream, stream_id):
        try:
            import cv2
        except ImportError:
            return StreamEvent.ERROR, {
                "diagnostic": "VideoReadWebcam needs cv2 (opencv)"}
        sources = self.get_parameter("data_sources", [0], stream)
        device = sources[0]
        if isinstance(device, str) and device.isdigit():
            device = int(device)
        capture = cv2.VideoCapture(device)
        if not capture.isOpened():
            return StreamEvent.ERROR, {
                "diagnostic": f"cannot open webcam {device!r}"}
        stream.variables[f"{self.definition.name}.capture"] = capture
        rate = self.get_parameter("rate", None, stream)
        self.create_frames(stream, self._frame_generator,
                           rate=float(rate) if rate else None)
        return StreamEvent.OKAY, None

    def _frame_generator(self, stream, frame_id):
        capture = stream.variables[f"{self.definition.name}.capture"]
        ok, frame_bgr = capture.read()
        if not ok:
            return StreamEvent.STOP, {"diagnostic": "webcam stream ended"}
        rgb = frame_bgr[:, :, ::-1].astype(np.float32) / 255.0
        return StreamEvent.OKAY, {"image": rgb.transpose(2, 0, 1)}

    def stop_stream(self, stream, stream_id):
        capture = stream.variables.get(
            f"{self.definition.name}.capture")
        if capture is not None:
            capture.release()
        return StreamEvent.OKAY, None

    def read_item(self, stream, item) -> dict:  # pragma: no cover
        raise NotImplementedError("VideoReadWebcam streams via generator")
