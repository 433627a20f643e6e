# Audio I/O elements and tone synthesis.
#
# Counterpart of aiko_services_tpu/elements/audio_io.py, with the same
# class names, parameters, outputs and diagnostics: AudioReadFile /
# AudioWriteFile (stdlib wave), ToneSource, AudioFraming (the sliding
# window that feeds Whisper a longer context), AudioSample, AudioFFT,
# AudioResample, and the hardware-gated MicrophoneSource / SpeakerSink
# with the mute protocol over EC.
#
# Where the JAX element computes on the device (the FFT, the resampler,
# the on-device tone), the port computes on the element's `device`
# parameter (CUDA unless the definition asks for the CPU); where it works
# on the host (the file elements, framing, playback), a tensor from the
# device is read back first.  The host tone is the JAX package's numpy
# code, bit for bit; the on-device tone computes the same formula in f32.
# AudioResample reproduces jnp.interp's arithmetic (positions in f32,
# the right-sided bin, the weight, the clamp past the last sample).

from __future__ import annotations

import numpy as np
import torch

from ..ops.device import as_device_array, resolve_device
from ..pipeline import AsyncHostElement, PipelineElement, StreamEvent
from ..utils import get_logger, truthy as _truthy
from .common_io import DataSource, DataTarget, Sample, host_array

__all__ = ["AudioReadFile", "AudioWriteFile", "ToneSource", "AudioFraming",
           "AudioSample", "AudioFFT", "AudioResample", "MicrophoneSource",
           "SpeakerSink", "synthesize_tone", "synthesize_tone_on_device",
           "resample_linear", "SAMPLE_RATE"]

_LOGGER = get_logger("audio_io")
SAMPLE_RATE = 16000  # reference audio_io.py:455-460: 16 kHz


def synthesize_tone(frequency: float, seconds: float,
                    sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    return np.sin(2 * np.pi * frequency * t).astype(np.float32)


def synthesize_tone_on_device(frequency, seconds: float,
                              sample_rate: int = SAMPLE_RATE,
                              device="cuda") -> torch.Tensor:
    """sin(2 pi f t) synthesized on `device` in f32: (samples,) for one
    frequency, (B, samples) for a (B,) sequence of frequencies."""
    device = resolve_device(device)
    t = torch.arange(int(seconds * sample_rate), dtype=torch.float32,
                     device=device) / sample_rate
    frequency = torch.as_tensor(frequency, dtype=torch.float32,
                                device=device)
    return torch.sin(2 * np.pi * frequency[..., None] * t)


def resample_linear(waveform: torch.Tensor, rate_in: int,
                    rate_out: int) -> torch.Tensor:
    """Linear resampling along the last axis, jnp.interp's arithmetic:
    output position p = arange(out) * (rate_in / rate_out) in f32, the
    bin i = clamp(floor(p) + 1, 1, n - 1) (searchsorted, side right),
    fp[i-1] + (p - (i-1)) * (fp[i] - fp[i-1]), and fp[-1] past the last
    sample.  Leading axes are kept; rows never mix."""
    samples = waveform.shape[-1]
    lead_shape = waveform.shape[:-1]
    rows = waveform.reshape(-1, samples)
    out_samples = int(round(samples * rate_out / rate_in))
    positions = (torch.arange(out_samples, dtype=torch.float32,
                              device=waveform.device)
                 * (rate_in / rate_out))
    if samples < 2:
        resampled = rows[:, :1].expand(rows.shape[0], out_samples)
    else:
        upper = (torch.floor(positions).long() + 1).clamp(1, samples - 1)
        lower = upper - 1
        low, high = rows[:, lower], rows[:, upper]
        delta = positions - lower.to(torch.float32)
        resampled = low + delta * (high - low)
        resampled = torch.where(positions > samples - 1, rows[:, -1:],
                                resampled)
    return resampled.reshape(*lead_shape, out_samples)


class AudioReadFile(DataSource):
    """data_sources of .wav paths -> {"audio": (samples,) f32 [-1, 1]}.
    Stdlib wave + numpy; 16-bit PCM mono/stereo (stereo is averaged)."""

    def read_item(self, stream, item) -> dict:
        import wave
        with wave.open(str(item), "rb") as handle:
            n_channels = handle.getnchannels()
            width = handle.getsampwidth()
            raw = handle.readframes(handle.getnframes())
        if width != 2:
            raise ValueError(f"{item}: only 16-bit PCM supported")
        audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        if n_channels > 1:
            audio = audio.reshape(-1, n_channels).mean(axis=1)
        return {"audio": audio}


class AudioWriteFile(DataTarget):
    """{"audio"} -> 16-bit PCM mono .wav at data_targets."""

    def process_frame(self, stream, audio):
        import wave
        array = host_array(audio).astype(np.float32).reshape(-1)
        path = self.next_target_path(stream)
        with wave.open(path, "wb") as handle:
            handle.setnchannels(1)
            handle.setsampwidth(2)
            handle.setframerate(
                int(self.get_parameter("sample_rate", SAMPLE_RATE, stream)))
            handle.writeframes(
                (array.clip(-1, 1) * 32767).astype(np.int16).tobytes())
        return StreamEvent.OKAY, {"audio": audio}


class ToneSource(DataSource):
    """Synthetic audio source: items are [frequency_hz, seconds] pairs --
    the hermetic stand-in for a microphone.  on_device=true synthesizes
    the tone on the element's device (no host->device hop on the frame
    path)."""

    def read_item(self, stream, item) -> dict:
        if self.get_parameter("on_device", False, stream):
            return {"audio": synthesize_tone_on_device(
                float(item[0]), float(item[1]),
                device=self.get_parameter("device", "cuda"))}
        return {"audio": synthesize_tone(float(item[0]), float(item[1]))}


class AudioFraming(PipelineElement):
    """Sliding-window concatenation of audio chunks on the host (the
    reference PE_AudioFraming: an LRU of the last window_count chunks
    feeding Whisper a longer context)."""

    def process_frame(self, stream, audio):
        window_count = int(self.get_parameter("window_count", 4, stream))
        key = f"{self.definition.name}.window"
        window = stream.variables.setdefault(key, [])
        window.append(host_array(audio).astype(np.float32).reshape(-1))
        while len(window) > window_count:
            window.pop(0)
        return StreamEvent.OKAY, {"audio": np.concatenate(window)}


class AudioSample(Sample):
    """Drop-frame sampler over audio (shared Sample base)."""


class AudioFFT(PipelineElement):
    """Magnitude spectrum of an audio frame on the element's device:
    audio (samples,) or (B, samples) -> {"spectrum": |rfft|,
    "frequencies": bin centers (numpy)}."""

    def process_frame(self, stream, audio):
        sample_rate = int(self.get_parameter("sample_rate", SAMPLE_RATE,
                                             stream))
        device = resolve_device(self.get_parameter("device", "cuda"))
        waveform = as_device_array(audio, torch.float32, device)
        spectrum = torch.fft.rfft(waveform, dim=-1).abs()
        frequencies = np.fft.rfftfreq(waveform.shape[-1],
                                      1.0 / sample_rate)
        return StreamEvent.OKAY, {"spectrum": spectrum,
                                  "frequencies": frequencies}


class AudioResample(PipelineElement):
    """Sample-rate conversion by linear interpolation on the element's
    device (resample_linear).  Parameters: rate_in (default
    SAMPLE_RATE), rate_out (required)."""

    def process_frame(self, stream, audio):
        rate_in = int(self.get_parameter("rate_in", SAMPLE_RATE, stream))
        rate_out = self.get_parameter("rate_out", None, stream)
        if rate_out is None:
            raise ValueError(
                f"{self.definition.name}: rate_out parameter is required")
        rate_out = int(rate_out)
        device = resolve_device(self.get_parameter("device", "cuda"))
        waveform = as_device_array(audio, torch.float32, device)
        if rate_in == rate_out:
            return StreamEvent.OKAY, {"audio": waveform,
                                      "sample_rate": rate_out}
        return StreamEvent.OKAY, {
            "audio": resample_linear(waveform, rate_in, rate_out),
            "sample_rate": rate_out}


class MicrophoneSource(DataSource):
    """Live microphone chunks (the reference's PE_MicrophoneSD seat:
    sounddevice, 16 kHz, 5 s chunks, with a mute protocol so a speaker
    can silence it during playback).

    Hardware-gated: sounddevice missing or no capture device -> a clear
    start_stream error, not an import crash.  The "mute" share flag is
    live-updatable over EC; muted chunks emit zeros so downstream
    framing stays continuous.
    """

    def start_stream(self, stream, stream_id):
        try:
            import sounddevice
        except ImportError:
            return StreamEvent.ERROR, {
                "diagnostic": "sounddevice is not installed "
                              "(pip install sounddevice)"}
        try:  # promised diagnostic: a clear error when no capture device
            if hasattr(sounddevice, "query_devices"):
                devices = sounddevice.query_devices()
                if not any(d.get("max_input_channels", 0) > 0
                           for d in devices):
                    return StreamEvent.ERROR, {
                        "diagnostic": "no audio capture device available"}
        except Exception as error:
            return StreamEvent.ERROR, {
                "diagnostic": f"audio device probe failed: {error}"}
        self.share.setdefault("mute", False)
        chunk_seconds = float(
            self.get_parameter("chunk_seconds", 5.0, stream))
        sample_rate = int(
            self.get_parameter("sample_rate", SAMPLE_RATE, stream))

        def frames(stream, frame_id):
            import sounddevice
            recording = sounddevice.rec(
                int(chunk_seconds * sample_rate), samplerate=sample_rate,
                channels=1, dtype="float32")
            sounddevice.wait()
            audio = recording.reshape(-1)
            if _truthy(self.get_parameter("mute", False, stream)):
                audio = np.zeros_like(audio)
            return StreamEvent.OKAY, {"audio": audio}

        self.create_frames(stream, frames)
        return StreamEvent.OKAY, None


class SpeakerSink(AsyncHostElement):
    """Audio playback (the reference's PE_Speaker seat): plays {"audio"}
    frames and, while playing, MUTES a discovered microphone service so
    the pipeline does not hear itself ((update mute true/false) on the
    microphone's /control topic via its EC share).

    Playback blocks for the clip's duration, so it runs as an ASYNC host
    element: the frame parks during play and the pipeline keeps flowing
    other frames."""

    _microphone_topic = None
    _discovery_warned = False

    def start_stream(self, stream, stream_id):
        # begin microphone discovery now so the cache is synced before
        # the first frame plays
        if self.get_parameter("microphone_service", None, stream):
            self._resolve_microphone(stream)
        return StreamEvent.OKAY, None

    def _resolve_microphone(self, stream):
        if self._microphone_topic is not None:
            return self._microphone_topic
        name = self.get_parameter("microphone_service", None, stream)
        if not name:
            return None
        from ..runtime import ServiceFilter
        from ..runtime.share import services_cache_create_singleton
        cache = services_cache_create_singleton(self.process)
        matches = list(cache.services.filter_services(
            ServiceFilter(name=str(name))))
        if matches:
            self._microphone_topic = matches[0].topic_path
        elif not self._discovery_warned:  # once, not per chunk
            self._discovery_warned = True
            _LOGGER.warning(
                "%s: microphone service '%s' not discovered yet; "
                "playing unmuted until it registers",
                self.definition.name, name)
        return self._microphone_topic

    def _set_mute(self, topic_path, muted: bool):
        from ..utils import generate
        self.process.publish(
            f"{topic_path}/control",
            generate("update", ["mute", "true" if muted else "false"]))

    def process_async(self, stream, audio):
        try:
            import sounddevice
        except ImportError as error:
            raise RuntimeError(
                "sounddevice is not installed "
                "(pip install sounddevice)") from error
        sample_rate = int(self.get_parameter(
            "sample_rate", SAMPLE_RATE, stream))
        microphone = self._resolve_microphone(stream)
        if microphone:
            self._set_mute(microphone, True)
        try:
            array = host_array(audio).astype(np.float32).reshape(-1)
            sounddevice.play(array, samplerate=sample_rate)
            sounddevice.wait()
        finally:
            if microphone:
                self._set_mute(microphone, False)
        return {"audio": audio}
