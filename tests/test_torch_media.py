# The port's media elements (elements/audio_io.py, elements/image_io.py,
# elements/webcam_io.py, elements/gstreamer_io.py) against the JAX
# package's, on the CPU ("device": "cpu"), on the same seeded numpy
# inputs.
#
# Tolerances: AudioResample 1e-6 absolute against jnp.interp (the same
# f32 arithmetic; XLA may fuse the multiply-add, a 1-ulp difference);
# AudioFFT's spectrum 1e-5 relative to its peak against jnp.fft.rfft (two
# FFT libraries); ImageResize 1e-6 against jax.image.resize at four
# shapes up and down (F.interpolate with antialias is the same bilinear
# filter); the host paths (ToneSource, ImageSource, AudioFraming, the wav
# files, the webcam and GStreamer frames) bit for bit.  The webcam and
# GStreamer cases reuse tests/test_media_contract.py's fake backends; the
# microphone and speaker cases tests/test_parity_items.py's fake
# sounddevice.

import queue
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.elements import audio_io as jax_audio
from aiko_services_tpu.elements import image_io as jax_image
from aiko_services_tpu.pipeline import create_pipeline as jax_create
from aiko_services_tpu.runtime import Process as JaxProcess
from aiko_services_tpu.transport import reset_brokers as jax_reset
from aiko_services_tpu_torch.elements import audio_io, image_io
from aiko_services_tpu_torch.elements.gstreamer_io import gst_available
from aiko_services_tpu_torch.pipeline import StreamEvent, create_pipeline
from aiko_services_tpu_torch.runtime import Process
from aiko_services_tpu_torch.transport import reset_brokers
from helpers import wait_for
from test_media_contract import FakeSample, make_fake_cv2, make_fake_gst
from test_parity_items import TestMicrophoneSpeaker

PORT = "aiko_services_tpu_torch.elements"
JAX = "aiko_services_tpu.elements"
RESIZE_SHAPES = [((32, 48), (64, 96)), ((64, 96), (32, 48)),
                 ((480, 640), (256, 256)), ((251, 173), (97, 311))]


@pytest.fixture(autouse=True)
def clean_brokers():
    jax_reset()
    reset_brokers()
    yield
    jax_reset()
    reset_brokers()


def _element(cls, params=None):
    params = dict(params or {})
    element = cls.__new__(cls)
    element.get_parameter = (lambda name, default=None, stream=None:
                             params.get(name, default))
    element.definition = types.SimpleNamespace(name="element")
    return element


def _pair(name, params=None):
    """(the port's element on the CPU, the JAX package's) of one class."""
    port_params = dict(params or {}, device="cpu")
    return (_element(getattr(audio_io, name, None)
                     or getattr(image_io, name), port_params),
            _element(getattr(jax_audio, name, None)
                     or getattr(jax_image, name), params))


def _definition(module, name, graph, elements, device=True):
    out = []
    for element in elements:
        element = dict(element)
        class_name = element.pop("class")
        parameters = dict(element.get("parameters", {}))
        if device and module == PORT:
            parameters["device"] = "cpu"
        element["parameters"] = parameters
        element["deploy"] = {"local": {"module": module,
                                       "class_name": class_name}}
        out.append(element)
    return {"name": name, "graph": [graph], "elements": out}


def _run(package, name, graph, elements, count=1, timeout=60):
    """The outputs of `count` frames of one stream through `package`."""
    module, process_class, create = (
        (PORT, Process, create_pipeline) if package == "torch"
        else (JAX, JaxProcess, jax_create))
    process = process_class(transport_kind="loopback")
    try:
        pipeline = create(process, _definition(module, name, graph,
                                               elements))
        process.run(in_thread=True)
        responses = queue.Queue()
        pipeline.create_stream("s", queue_response=responses,
                               grace_time=60)
        return [responses.get(timeout=timeout)[2] for _ in range(count)]
    finally:
        process.terminate()


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.numpy()
    return np.asarray(value)


# -- AudioResample ------------------------------------------------------------

def test_resample_halves_and_preserves_tone():
    port, reference = _pair("AudioResample", {"rate_in": 16000,
                                              "rate_out": 8000})
    audio = audio_io.synthesize_tone(440.0, 0.25)
    _, outputs = audio_io.AudioResample.process_frame(port, None, audio)
    _, expected = jax_audio.AudioResample.process_frame(reference, None,
                                                        audio)
    resampled = _host(outputs["audio"])
    assert outputs["sample_rate"] == expected["sample_rate"] == 8000
    assert abs(len(resampled) - len(audio) // 2) <= 1
    np.testing.assert_allclose(resampled, np.asarray(expected["audio"]),
                               atol=1e-6, rtol=0)
    spectrum = np.abs(np.fft.rfft(resampled))
    peak_hz = np.fft.rfftfreq(len(resampled), 1 / 8000)[
        int(np.argmax(spectrum))]
    assert abs(peak_hz - 440.0) < 8.0


def test_resample_preserves_batch_shape():
    port, reference = _pair("AudioResample", {"rate_in": 16000,
                                              "rate_out": 8000})
    audio = np.random.default_rng(0).standard_normal((2, 1000)).astype(
        np.float32)
    _, outputs = audio_io.AudioResample.process_frame(port, None, audio)
    _, expected = jax_audio.AudioResample.process_frame(reference, None,
                                                        audio)
    assert tuple(outputs["audio"].shape) == (2, 500)
    np.testing.assert_allclose(_host(outputs["audio"]),
                               np.asarray(expected["audio"]), atol=1e-6,
                               rtol=0)


def test_resample_identity():
    port, _ = _pair("AudioResample", {"rate_in": 16000, "rate_out": 16000})
    audio = np.arange(100, dtype=np.float32)
    _, outputs = audio_io.AudioResample.process_frame(port, None, audio)
    np.testing.assert_array_equal(_host(outputs["audio"]), audio)
    assert outputs["sample_rate"] == 16000


def test_resample_requires_rate_out():
    port, _ = _pair("AudioResample", {"rate_in": 16000})
    with pytest.raises(ValueError, match="rate_out"):
        audio_io.AudioResample.process_frame(port, None, np.zeros(8))


@pytest.mark.parametrize("samples, rate_in, rate_out, lead", [
    (1000, 16000, 11025, (3,)),         # downsampling, fractional steps
    (999, 8000, 16000, ()),             # upsampling
    (32000, 16000, 22050, (2, 2)),      # the last positions past the end
    (7, 3, 5, (2,)),                    # a short row: clamped tail
])
def test_resample_matches_jnp_interp(samples, rate_in, rate_out, lead):
    """resample_linear against jax.vmap(jnp.interp) on the JAX element's
    positions, the clamped tail and the leading axes included."""
    audio = np.random.default_rng(samples).standard_normal(
        lead + (samples,)).astype(np.float32)
    out_samples = int(round(samples * rate_out / rate_in))
    positions = jnp.arange(out_samples, dtype=jnp.float32) * (
        rate_in / rate_out)
    assert float(positions[-1]) > samples - 1 or rate_out < rate_in
    source = jnp.arange(samples, dtype=jnp.float32)
    rows = jnp.asarray(audio).reshape(-1, samples)
    expected = np.asarray(jax.vmap(
        lambda row: jnp.interp(positions, source, row))(rows)).reshape(
            lead + (out_samples,))
    got = audio_io.resample_linear(torch.from_numpy(audio), rate_in,
                                   rate_out)
    assert tuple(got.shape) == lead + (out_samples,)
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-6, rtol=0)


# -- AudioFFT -----------------------------------------------------------------

def test_fft_finds_tone_frequency():
    port, _ = _pair("AudioFFT")
    audio = audio_io.synthesize_tone(440.0, 0.5)
    _, outputs = audio_io.AudioFFT.process_frame(port, None, audio)
    spectrum = _host(outputs["spectrum"])
    peak_hz = outputs["frequencies"][int(np.argmax(spectrum))]
    assert abs(peak_hz - 440.0) < 4.0


@pytest.mark.parametrize("shape", [(8000,), (3, 4001)])
def test_fft_matches_jnp_fft(shape):
    port, reference = _pair("AudioFFT", {"sample_rate": 8000})
    audio = np.random.default_rng(3).standard_normal(shape).astype(
        np.float32)
    _, outputs = audio_io.AudioFFT.process_frame(port, None, audio)
    _, expected = jax_audio.AudioFFT.process_frame(reference, None, audio)
    want = np.asarray(expected["spectrum"])
    got = _host(outputs["spectrum"])
    assert isinstance(outputs["spectrum"], torch.Tensor)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    np.testing.assert_array_equal(outputs["frequencies"],
                                  expected["frequencies"])


# -- AudioFraming, the wav files, ToneSource ----------------------------------

def test_framing_windows_match():
    port, reference = _pair("AudioFraming", {"window_count": 3})
    port_stream = types.SimpleNamespace(variables={})
    jax_stream = types.SimpleNamespace(variables={})
    rng = np.random.default_rng(4)
    for index in range(5):
        chunk = rng.standard_normal(160 + index).astype(np.float32)
        _, outputs = audio_io.AudioFraming.process_frame(
            port, port_stream, torch.from_numpy(chunk))
        _, expected = jax_audio.AudioFraming.process_frame(
            reference, jax_stream, chunk)
        np.testing.assert_array_equal(outputs["audio"], expected["audio"])
    assert outputs["audio"].shape == (162 + 163 + 164,)


def test_wav_write_read_roundtrip(tmp_path):
    """ToneSource -> AudioWriteFile, then AudioReadFile -> AudioSample,
    through both packages: the same file bytes, the same samples."""
    wavs = {}
    for package in ("jax", "torch"):
        target = tmp_path / f"{package}.wav"
        _run(package, "audio_pipe", "(tone (write))", [
            {"name": "tone", "output": [{"name": "audio"}],
             "parameters": {"data_sources": [[440, 0.1]]},
             "class": "ToneSource"},
            {"name": "write", "input": [{"name": "audio"}],
             "output": [{"name": "audio"}],
             "parameters": {"data_targets": [str(target)]},
             "class": "AudioWriteFile"}])
        [outputs] = _run(package, "audio_read", "(read (sample))", [
            {"name": "read", "output": [{"name": "audio"}],
             "parameters": {"data_sources": [str(target)]},
             "class": "AudioReadFile"},
            {"name": "sample", "input": [{"name": "audio"}],
             "output": [{"name": "audio"}], "class": "AudioSample"}])
        wavs[package] = (target.read_bytes(), np.asarray(outputs["audio"]))
    assert wavs["torch"][0] == wavs["jax"][0]
    np.testing.assert_array_equal(wavs["torch"][1], wavs["jax"][1])
    assert wavs["torch"][1].shape == (1600,)
    assert 0.5 < np.abs(wavs["torch"][1]).max() <= 1.0


def test_tone_source_host_and_device_paths():
    elements = [{"name": "tone", "output": [{"name": "audio"}],
                 "parameters": {"data_sources": [[440, 0.1], [880, 0.05]]},
                 "class": "ToneSource"}]
    port = _run("torch", "tones", "(tone)", elements, count=2)
    reference = _run("jax", "tones", "(tone)", elements, count=2)
    for got, want in zip(port, reference):
        assert isinstance(got["audio"], np.ndarray)
        np.testing.assert_array_equal(got["audio"], want["audio"])
    on_device = [dict(elements[0], parameters=dict(
        elements[0]["parameters"], on_device=True))]
    for got, want in zip(_run("torch", "tones", "(tone)", on_device,
                              count=2), reference):
        assert isinstance(got["audio"], torch.Tensor)
        np.testing.assert_allclose(got["audio"].numpy(), want["audio"],
                                   atol=1e-4, rtol=0)


# -- the microphone and the speaker (fake sounddevice) ------------------------

def test_microphone_gated_without_sounddevice(monkeypatch):
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    element = _element(audio_io.MicrophoneSource)
    element.share = {}
    event, outputs = audio_io.MicrophoneSource.start_stream(element, None,
                                                            "s")
    assert event == StreamEvent.ERROR
    assert "sounddevice" in outputs["diagnostic"]


def test_microphone_chunks_and_mute_zeroing(monkeypatch):
    recorded, played = [], []
    monkeypatch.setitem(sys.modules, "sounddevice",
                        TestMicrophoneSpeaker._fake_sounddevice(recorded,
                                                                played))
    process = Process(transport_kind="loopback")
    pipeline = create_pipeline(process, _definition(
        PORT, "mic_pipe", "(mic)", [
            {"name": "mic", "output": [{"name": "audio"}],
             "parameters": {"chunk_seconds": 0.01, "frame_window": 1},
             "class": "MicrophoneSource"}]))
    process.run(in_thread=True)
    try:
        responses = queue.Queue()
        pipeline.create_stream("s1", queue_response=responses)
        _, _, outputs = responses.get(timeout=10)
        audio = np.asarray(outputs["audio"])
        assert audio.shape == (160,)           # 0.01 s at 16 kHz
        assert np.allclose(audio, 0.25)        # live chunk
        pipeline.elements["mic"].share["mute"] = "true"  # EC wire form
        for _ in range(3):
            _, _, outputs = responses.get(timeout=10)
            if np.allclose(np.asarray(outputs["audio"]), 0.0):
                break
        assert np.allclose(np.asarray(outputs["audio"]), 0.0)
        pipeline.destroy_stream("s1")
    finally:
        process.terminate()


def test_speaker_mutes_discovered_microphone(monkeypatch):
    from aiko_services_tpu_torch.elements.robot import RobotActor
    from aiko_services_tpu_torch.runtime import Registrar, ServiceFilter
    from aiko_services_tpu_torch.runtime.share import (
        services_cache_create_singleton)
    from aiko_services_tpu_torch.transport.loopback import get_broker
    recorded, played = [], []
    monkeypatch.setitem(sys.modules, "sounddevice",
                        TestMicrophoneSpeaker._fake_sounddevice(recorded,
                                                                played))
    process = Process(transport_kind="loopback")
    Registrar(process, search_timeout=0.05)
    mic = RobotActor(process, name="mic_service")  # any service will do
    mutes = []
    process.add_message_handler(
        lambda topic, payload: mutes.append(str(payload)),
        f"{mic.topic_path}/control")
    pipeline = create_pipeline(process, _definition(
        PORT, "playback", "(tone (speaker))", [
            {"name": "tone", "output": [{"name": "audio"}],
             "parameters": {"data_sources": [[440, 0.01]],
                            "on_device": True},
             "class": "ToneSource"},
            {"name": "speaker", "input": [{"name": "audio"}],
             "output": [{"name": "audio"}],
             "parameters": {"microphone_service": "mic_service"},
             "class": "SpeakerSink"}]))
    process.run(in_thread=True)
    try:
        cache = services_cache_create_singleton(process)
        deadline = time.monotonic() + 5
        while (not list(cache.services.filter_services(
                ServiceFilter(name="mic_service")))
               and time.monotonic() < deadline):
            get_broker().drain()
            time.sleep(0.01)
        responses = queue.Queue()
        pipeline.create_stream("s1", queue_response=responses)
        responses.get(timeout=10)
        # the on-device tone was read back for playback
        assert played and played[0][1] == 16000
        np.testing.assert_allclose(
            played[0][0], audio_io.synthesize_tone(440, 0.01), atol=1e-4)
        deadline = time.monotonic() + 5
        while len(mutes) < 2 and time.monotonic() < deadline:
            get_broker().drain()
            time.sleep(0.01)
        assert any("mute" in m and "true" in m for m in mutes), mutes
        assert any("mute" in m and "false" in m for m in mutes), mutes
    finally:
        process.terminate()


# -- ImageResize, ImageSource, ImageOutput ------------------------------------

@pytest.mark.parametrize("source, target", RESIZE_SHAPES)
def test_image_resize_matches_jax_image_resize(source, target):
    params = {"resize_height": target[0], "resize_width": target[1]}
    port, reference = _pair("ImageResize", params)
    rng = np.random.default_rng(source[0])
    for image in (rng.random((3,) + source, dtype=np.float32),
                  rng.random((2, 3) + source, dtype=np.float32)):
        _, outputs = image_io.ImageResize.process_frame(port, None, image)
        _, expected = jax_image.ImageResize.process_frame(reference, None,
                                                          image)
        want = np.asarray(expected["image"])
        assert tuple(outputs["image"].shape) == want.shape
        np.testing.assert_allclose(outputs["image"].numpy(), want,
                                   atol=1e-6, rtol=0)


def test_image_source_host_and_device_paths():
    elements = [{"name": "camera", "output": [{"name": "image"}],
                 "parameters": {"data_sources": [[3, 8, 12], [1, 4, 4]],
                                "seed": 5},
                 "class": "ImageSource"}]
    port = _run("torch", "camera", "(camera)", elements, count=2)
    reference = _run("jax", "camera", "(camera)", elements, count=2)
    for got, want in zip(port, reference):
        assert got["image"].dtype == np.float32
        np.testing.assert_array_equal(got["image"], want["image"])
    on_device = [dict(elements[0], parameters=dict(
        elements[0]["parameters"], on_device=True))]
    first = _run("torch", "camera", "(camera)", on_device, count=2)
    again = _run("torch", "camera", "(camera)", on_device, count=2)
    for got, repeat, want in zip(first, again, reference):
        image = got["image"]
        assert isinstance(image, torch.Tensor)
        assert tuple(image.shape) == want["image"].shape
        assert image.dtype == torch.float32
        assert float(image.min()) >= 0.0 and float(image.max()) < 1.0
        torch.testing.assert_close(image, repeat["image"], rtol=0, atol=0)
    assert not torch.equal(first[0]["image"][:1, :4, :4],
                           first[1]["image"])  # seed + emission index


def test_image_source_resize_output_graph():
    """ImageSource -> ImageResize -> ImageOutput in both packages: the
    output image passes through ImageOutput unchanged."""
    elements = [
        {"name": "camera", "output": [{"name": "image"}],
         "parameters": {"data_sources": [[3, 48, 64]]},
         "class": "ImageSource"},
        {"name": "resize", "input": [{"name": "image"}],
         "output": [{"name": "image"}],
         "parameters": {"resize_height": 24, "resize_width": 40},
         "class": "ImageResize"},
        {"name": "show", "input": [{"name": "image"}],
         "output": [{"name": "image"}], "class": "ImageOutput"},
    ]
    [got] = _run("torch", "resize", "(camera (resize (show)))", elements)
    [want] = _run("jax", "resize", "(camera (resize (show)))", elements)
    assert isinstance(got["image"], torch.Tensor)
    np.testing.assert_allclose(got["image"].numpy(),
                               np.asarray(want["image"]), atol=1e-6, rtol=0)


# -- the webcam (fake cv2) ----------------------------------------------------

def _webcam(parameters=None):
    return [{"name": "camera", "output": [{"name": "image"}],
             "parameters": {"data_sources": [0], **(parameters or {})},
             "class": "VideoReadWebcam"}]


def _run_source(elements, count, name="source"):
    process = Process(transport_kind="loopback")
    pipeline = create_pipeline(process, _definition(
        PORT, name, f"({elements[0]['name']})", elements))
    process.run(in_thread=True)
    responses = queue.Queue()
    pipeline.create_stream("s", queue_response=responses, grace_time=60)
    results = [responses.get(timeout=60)[2] for _ in range(count)]
    return results, pipeline, process


def _gated(elements):
    """A stream whose start_stream ERRORs is gone again at once."""
    process = Process(transport_kind="loopback")
    pipeline = create_pipeline(process, _definition(
        PORT, "gated", "(" + " (".join(e["name"] for e in elements)
        + ")" * len(elements), elements))
    process.run(in_thread=True)
    try:
        pipeline.create_stream("s", grace_time=30)
        wait_for(lambda: not pipeline.streams, timeout=30)
    finally:
        process.terminate()


def test_webcam_frame_schema_bgr_to_rgb(monkeypatch):
    bgr = np.zeros((2, 3, 3), np.uint8)
    bgr[:, :, 0] = 255  # blue plane (cv2 order)
    bgr[:, :, 1] = np.arange(6, dtype=np.uint8).reshape(2, 3) * 40
    images = {}
    for package in ("jax", "torch"):
        monkeypatch.setitem(sys.modules, "cv2",
                            make_fake_cv2([bgr.copy(), bgr.copy()]))
        images[package] = [outputs["image"] for outputs in _run(
            package, "webcam", "(camera)", _webcam(), count=2)]
    for got, want in zip(images["torch"], images["jax"]):
        assert got.shape == (3, 2, 3) and got.dtype == np.float32
        assert (got[2] == 1.0).all()  # blue landed in RGB slot 2
        np.testing.assert_array_equal(got, want)


def test_webcam_device_string_coerced_and_released_on_end(monkeypatch):
    cv2 = make_fake_cv2([np.ones((2, 2, 3), np.uint8)])
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    results, pipeline, process = _run_source(
        _webcam({"data_sources": ["7"]}), count=1)
    try:
        assert results[0]["image"].shape == (3, 2, 2)
        assert cv2.captures[0].device == 7  # "7" -> int index
        wait_for(lambda: cv2.captures[0].released, timeout=30)
        wait_for(lambda: not pipeline.streams, timeout=30)
    finally:
        process.terminate()


def test_webcam_unopenable_device_is_a_clear_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", make_fake_cv2([], opened=False))
    _gated(_webcam())


def test_webcam_missing_cv2_is_a_clear_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    _gated(_webcam())


# -- GStreamer (fake gi) ------------------------------------------------------

def _install_gst(monkeypatch, samples=None):
    gi, repository, gst = make_fake_gst(samples)
    monkeypatch.setitem(sys.modules, "gi", gi)
    monkeypatch.setitem(sys.modules, "gi.repository", repository)
    return gst


def _reader(parameters=None):
    return [{"name": "reader", "output": [{"name": "image"}],
             "parameters": {"data_sources": ["rtsp://fake/stream"],
                            **(parameters or {})},
             "class": "VideoStreamReader"}]


def test_gst_reader_frame_schema_and_url_wiring(monkeypatch):
    rgb = (np.arange(2 * 3 * 3) % 255).astype(np.uint8).reshape(2, 3, 3)
    images = {}
    for package in ("jax", "torch"):
        gst = _install_gst(monkeypatch, [FakeSample(rgb), FakeSample(rgb)])
        images[package] = [outputs["image"] for outputs in _run(
            package, "gst_read", "(reader)", _reader(), count=2)]
        assert "uri=rtsp://fake/stream" in gst.launched[0].description
        assert gst.launched[0].states[0] == "PLAYING"
        assert all(sample.buffer.unmapped
                   for sample in gst.element.samples or [])
    for got, want in zip(images["torch"], images["jax"]):
        assert got.shape == (3, 2, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_gst_reader_stream_end_stops_and_nulls_pipeline(monkeypatch):
    gst = _install_gst(monkeypatch, [FakeSample(np.zeros((2, 2, 3),
                                                         np.uint8))])
    results, pipeline, process = _run_source(_reader(), count=1)
    try:
        assert results[0]["image"].shape == (3, 2, 2)
        wait_for(lambda: "NULL" in gst.launched[0].states, timeout=30)
        wait_for(lambda: not pipeline.streams, timeout=30)
    finally:
        process.terminate()


def test_gst_reader_bad_tick_with_drop_frame_keeps_stream(monkeypatch):
    rgb = np.full((2, 2, 3), 7, np.uint8)
    _install_gst(monkeypatch, [FakeSample(rgb),
                               FakeSample(rgb, map_ok=False),
                               FakeSample(rgb)])
    results, _, process = _run_source(_reader({"on_error": "drop_frame"}),
                                      count=2)
    try:
        assert len(results) == 2  # 3 ticks, 1 dropped, stream alive
        for outputs in results:
            assert outputs["image"].shape == (3, 2, 2)
    finally:
        process.terminate()


def test_gst_reader_missing_backend_is_a_clear_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "gi", None)
    assert not gst_available()
    _gated(_reader())


def _writer_graph(on_device=False):
    return [
        {"name": "camera", "output": [{"name": "image"}],
         "parameters": {"data_sources": [[3, 4, 4], [3, 4, 4]],
                        "on_device": on_device},
         "class": "ImageSource"},
        {"name": "writer", "input": [{"name": "image"}],
         "output": [{"name": "image"}],
         "parameters": {"stream_url": "rtmp://fake/out", "frame_rate": 5},
         "class": "VideoStreamWriter"}]


@pytest.mark.parametrize("on_device", [False, True])
def test_gst_writer_pushes_uint8_buffers_with_timestamps(monkeypatch,
                                                         on_device):
    pushed = {}
    for package in ("jax", "torch") if not on_device else ("torch",):
        gst = _install_gst(monkeypatch)
        module, process_class, create = (
            (PORT, Process, create_pipeline) if package == "torch"
            else (JAX, JaxProcess, jax_create))
        process = process_class(transport_kind="loopback")
        pipeline = create(process, _definition(
            module, "gst_write", "(camera (writer))",
            _writer_graph(on_device)))
        process.run(in_thread=True)
        try:
            responses = queue.Queue()
            pipeline.create_stream("s", queue_response=responses,
                                   grace_time=60)
            results = [responses.get(timeout=60)[2] for _ in range(2)]
            launch = gst.launched[0]
            assert len(gst.launched) == 1
            assert "location=rtmp://fake/out" in launch.description
            assert "width=4,height=4" in launch.description
            assert len(gst.element.pushed) == 2
            for index, buffer in enumerate(gst.element.pushed):
                assert len(buffer._data) == 4 * 4 * 3  # HWC uint8 bytes
                assert buffer.pts == index * gst.SECOND // 5
                assert buffer.duration == gst.SECOND // 5
            for outputs in results:
                assert tuple(outputs["image"].shape)[-2:] == (4, 4)
            pipeline.destroy_stream("s")
            wait_for(lambda: gst.element.eos, timeout=30)
            assert "NULL" in launch.states
        finally:
            process.terminate()
        pushed[package] = [buffer._data for buffer in gst.element.pushed]
    if not on_device:
        assert pushed["torch"] == pushed["jax"]


def test_gst_writer_missing_backend_is_a_clear_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "gi", None)
    _gated(_writer_graph())
