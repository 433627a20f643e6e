# Source and boundary elements for compute pipelines: seeded tensor and
# token sources, the multi-modal (audio + image) source that drives the
# config-5 graph, and the device -> host boundary.
#
# Counterpart of aiko_services_tpu/elements/compute.py (ArraySource,
# TokenSource, MultiModalSource, ToHost; the JaxScale / JaxMLP toy
# compute elements are not ported yet).  The host paths are the JAX
# package's numpy code, so both packages emit the same frames.  With
# `on_device: true` MultiModalSource synthesizes its batch on the
# element's device (the `device` parameter, CUDA unless the definition
# asks for the CPU): the tones are the same f32 formula, the images come
# from a torch.Generator seeded per row with the row's seed -- the JAX
# package's jax.random bits cannot be reproduced, so on-device images
# differ from its images (and from the host path's).

from __future__ import annotations

import numpy as np
import torch

from ..ops.device import resolve_device
from ..pipeline import ComputeElement, StreamEvent
from .common_io import DataSource

__all__ = ["ArraySource", "TokenSource", "MultiModalSource", "ToHost"]


class ArraySource(DataSource):
    """Emits {"tensor": ndarray} frames; data_sources items give shapes,
    e.g. [[8, 16], [8, 16]] emits two 8x16 arrays (seeded, deterministic)."""

    def read_item(self, stream, item) -> dict:
        shape = tuple(int(size) for size in item)
        rng = np.random.default_rng(
            int(self.get_parameter("seed", 0, stream))
            + self.emission_index(stream))
        return {"tensor": rng.standard_normal(shape, dtype=np.float32)}


class TokenSource(DataSource):
    """Emits {"tokens": (B, L) int32} frames: data_sources [[batch, seq]],
    repeated `count` times (load-generator for LM pipelines/benchmarks)."""

    def start_stream(self, stream, stream_id):
        items = self.get_parameter("data_sources", [[8, 128]], stream)
        shapes = [tuple(int(size) for size in item) for item in items]
        count = int(self.get_parameter("count", 1, stream))
        name = self.definition.name
        stream.variables[f"{name}.shapes"] = shapes
        stream.variables[f"{name}.remaining"] = count
        rate = self.get_parameter("rate", None, stream)
        self.create_frames(stream, self._generate,
                           rate=float(rate) if rate else None)
        return StreamEvent.OKAY, None

    def _generate(self, stream, frame_id):
        import time
        name = self.definition.name
        remaining = stream.variables[f"{name}.remaining"]
        if remaining <= 0:
            return StreamEvent.STOP, {"diagnostic": "count exhausted"}
        stream.variables[f"{name}.remaining"] = remaining - 1
        shapes = stream.variables[f"{name}.shapes"]
        index = self.emission_index(stream)
        shape = shapes[index % len(shapes)]  # cycle all configured shapes
        vocab = int(self.get_parameter("vocab_size", 8192, stream))
        rng = np.random.default_rng(
            int(self.get_parameter("seed", 0, stream)) + index)
        # t0 rides the swag so consumers can measure true frame latency
        # (declare a "t0" output port to propagate it)
        return StreamEvent.OKAY, {
            "tokens": rng.integers(0, vocab, shape, dtype=np.int32),
            "t0": time.time()}


class MultiModalSource(DataSource):
    """Emits {"audio", "image"} frames: items are [frequency_hz, seconds]
    tone specs plus a synthetic image (parameter image_shape, default
    [3, 32, 32]) -- the hermetic source for multi-modal pipelines.

    `on_device: false` (the default): numpy on the host, bit-identical to
    the JAX package's frames.  `on_device: true`: the whole row batch is
    synthesized on the element's device (read_batch) -- tones in f32, and
    each row's image from a torch.Generator seeded with that row's seed
    (not the JAX package's jax.random bits)."""

    def _device(self) -> torch.device:
        return resolve_device(self.get_parameter("device", "cuda"))

    def read_item(self, stream, item) -> dict:
        from .audio_io import synthesize_tone, synthesize_tone_on_device
        from .image_io import synthesize_image, synthesize_image_on_device
        shape = self.get_parameter("image_shape", [3, 32, 32], stream)
        seed = (int(self.get_parameter("seed", 0, stream))
                + self.emission_index(stream))
        if self.get_parameter("on_device", False, stream):
            device = self._device()
            return {
                "audio": synthesize_tone_on_device(
                    float(item[0]), float(item[1]), device=device),
                "image": synthesize_image_on_device(shape, seed, device),
            }
        return {
            "audio": synthesize_tone(float(item[0]), float(item[1])),
            "image": synthesize_image(shape, seed),
        }

    def read_batch(self, stream, items) -> dict | None:
        """Whole-row-batch synthesis on the device: (B, samples) tones in
        one call and one generator-seeded image per row.  The host path
        and ragged tone lengths fall back to per-item reads."""
        from .audio_io import synthesize_tone_on_device
        from .image_io import synthesize_image_on_device
        if not self.get_parameter("on_device", False, stream):
            return None
        seconds = float(items[0][1])
        if any(float(item[1]) != seconds for item in items):
            return None  # ragged lengths cannot stack
        shape = tuple(int(size) for size in self.get_parameter(
            "image_shape", [3, 32, 32], stream))
        base_seed = int(self.get_parameter("seed", 0, stream))
        seeds = [base_seed + self.emission_index(stream) for _ in items]
        device = self._device()
        audio = synthesize_tone_on_device(
            [float(item[0]) for item in items], seconds, device=device)
        image = torch.stack([synthesize_image_on_device(shape, seed, device)
                             for seed in seeds])
        return {"audio": audio, "image": image}


class ToHost(ComputeElement):
    """Device -> host boundary: returns the tensor as numpy (the explicit
    sink-side transfer point; everything upstream stays on the device)."""

    def process_frame(self, stream, tensor):
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.detach().cpu()
        return StreamEvent.OKAY, {"tensor": np.asarray(tensor)}
