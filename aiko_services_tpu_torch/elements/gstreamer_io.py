# GStreamer streaming elements (RTSP/RTMP video in/out).
#
# Counterpart of aiko_services_tpu/elements/gstreamer_io.py (the
# reference's gstreamer suite: network video streams in and out of
# pipelines), with the same launch descriptions, frame contract and
# diagnostics.  Hard-gated on PyGObject/Gst, which neither this port's
# card machine nor its CPU test machine ships; video_io and webcam_io are
# the gst-free paths.  An image that arrives as a tensor on the device is
# read back to the host before it is pushed.

from __future__ import annotations

import numpy as np

from ..pipeline import PipelineElement, StreamEvent
from ..utils import get_logger
from .common_io import DataSource, host_array

__all__ = ["gst_available", "VideoStreamReader", "VideoStreamWriter"]

_LOGGER = get_logger("gstreamer_io")


def gst_available() -> bool:
    try:
        import gi
        gi.require_version("Gst", "1.0")
        from gi.repository import Gst  # noqa: F401
        return True
    except (ImportError, ValueError):
        return False


class VideoStreamReader(DataSource):
    """data_sources of stream URLs (rtsp://, rtmp://) -> {"image"} frames
    via a Gst appsink (reference video_stream_reader.py)."""

    def start_stream(self, stream, stream_id):
        if not gst_available():
            return StreamEvent.ERROR, {
                "diagnostic": "VideoStreamReader needs PyGObject/GStreamer"}
        import gi
        gi.require_version("Gst", "1.0")
        from gi.repository import Gst
        Gst.init(None)
        url = self.get_parameter("data_sources", [None], stream)[0]
        description = (
            f"urisourcebin uri={url} ! decodebin ! videoconvert ! "
            f"video/x-raw,format=RGB ! appsink name=sink max-buffers=30 "
            f"drop=true")
        gst_pipeline = Gst.parse_launch(description)
        sink = gst_pipeline.get_by_name("sink")
        gst_pipeline.set_state(Gst.State.PLAYING)
        stream.variables[f"{self.definition.name}.gst"] = (
            gst_pipeline, sink)
        self.create_frames(stream, self._frame_generator)
        return StreamEvent.OKAY, None

    def _frame_generator(self, stream, frame_id):
        from gi.repository import Gst
        _, sink = stream.variables[f"{self.definition.name}.gst"]
        sample = sink.emit("pull-sample")
        if sample is None:
            return StreamEvent.STOP, {"diagnostic": "stream ended"}
        buffer = sample.get_buffer()
        caps = sample.get_caps().get_structure(0)
        height, width = caps.get_value("height"), caps.get_value("width")
        ok, mapped = buffer.map(Gst.MapFlags.READ)
        if not ok:
            return StreamEvent.ERROR, {"diagnostic": "buffer map failed"}
        try:
            array = np.frombuffer(mapped.data, np.uint8).reshape(
                height, width, 3)
            image = array.astype(np.float32).transpose(2, 0, 1) / 255.0
        finally:
            buffer.unmap(mapped)
        return StreamEvent.OKAY, {"image": image}

    def stop_stream(self, stream, stream_id):
        record = stream.variables.get(f"{self.definition.name}.gst")
        if record is not None:
            from gi.repository import Gst
            record[0].set_state(Gst.State.NULL)
        return StreamEvent.OKAY, None

    def read_item(self, stream, item) -> dict:  # pragma: no cover
        raise NotImplementedError("VideoStreamReader streams via generator")


class VideoStreamWriter(PipelineElement):
    """{"image"} frames -> an RTMP/TCP video stream via appsrc + x264
    (reference video_stream_writer.py); gated like the reader."""

    def start_stream(self, stream, stream_id):
        if not gst_available():
            return StreamEvent.ERROR, {
                "diagnostic": "VideoStreamWriter needs PyGObject/GStreamer"}
        return StreamEvent.OKAY, None

    def process_frame(self, stream, image):
        import gi
        gi.require_version("Gst", "1.0")
        from gi.repository import Gst
        key = f"{self.definition.name}.gst"
        record = stream.variables.get(key)
        array = host_array(image)
        if array.ndim == 4:
            array = array[0]
        if array.shape[0] in (1, 3):
            array = array.transpose(1, 2, 0)
        if array.dtype != np.uint8:
            array = (array * 255.0).clip(0, 255).astype(np.uint8)
        if record is None:
            Gst.init(None)
            url = self.get_parameter("stream_url", None, stream)
            height, width = array.shape[:2]
            rate = int(self.get_parameter("frame_rate", 25, stream))
            description = (
                f"appsrc name=src is-live=true format=time "
                f"caps=video/x-raw,format=RGB,width={width},"
                f"height={height},framerate={rate}/1 ! videoconvert ! "
                f"x264enc tune=zerolatency ! flvmux ! rtmpsink "
                f"location={url}")
            gst_pipeline = Gst.parse_launch(description)
            source = gst_pipeline.get_by_name("src")
            gst_pipeline.set_state(Gst.State.PLAYING)
            record = stream.variables[key] = (gst_pipeline, source, [0])
        gst_pipeline, source, counter = record
        buffer = Gst.Buffer.new_wrapped(array.tobytes())
        rate = int(self.get_parameter("frame_rate", 25, stream))
        buffer.pts = counter[0] * Gst.SECOND // rate
        buffer.duration = Gst.SECOND // rate
        counter[0] += 1
        source.emit("push-buffer", buffer)
        return StreamEvent.OKAY, {"image": image}

    def stop_stream(self, stream, stream_id):
        record = stream.variables.get(f"{self.definition.name}.gst")
        if record is not None:
            from gi.repository import Gst
            record[1].emit("end-of-stream")
            record[0].set_state(Gst.State.NULL)
        return StreamEvent.OKAY, None
